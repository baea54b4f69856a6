"""The port's core math and layouts against the JAX package, bit for bit.

Inputs come from numpy with a fixed seed and go through both packages;
the comparison is exact (the same f32 operations in the same order).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_dct_tpu.core import dct as J_dct
from simd_dct_tpu.core import quantize as J_q
from simd_dct_tpu.layout import blocks as J_blocks
from simd_dct_tpu.layout import reorder as J_reorder
from simd_dct_tpu_torch.core import dct as T_dct
from simd_dct_tpu_torch.core import quantize as T_q
from simd_dct_tpu_torch.layout import blocks as T_blocks
from simd_dct_tpu_torch.layout import reorder as T_reorder

CU_SOURCE = (Path(__file__).resolve().parents[1]
             / "simd_dct_tpu_torch" / "csrc" / "dct_common.cuh")


def _luts():
    rng = np.random.default_rng(7)
    return [T_q.default_quant_lut(50) * np.float32(255.0),
            T_q.default_quant_lut(100),
            T_q.default_quant_lut(),
            rng.uniform(0.01, 300.0, 64).astype(np.float32)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_dct_basis_bit_identical(dtype):
    a = T_dct.dct_basis_np(dtype)
    b = J_dct.dct_basis_np(dtype)
    assert a.dtype == b.dtype
    assert a.tobytes() == b.tobytes()


def test_butterfly_constants_identical():
    for name in ("C_A", "C_B", "C_C", "C_D", "C_E", "C_F", "C_NORM"):
        assert getattr(T_dct, name).tobytes() == getattr(J_dct, name).tobytes()


def test_cuda_source_basis_bit_identical():
    """The __constant__ basis of the CUDA kernels is the f32 basis."""
    text = CU_SOURCE.read_text()
    body = re.search(r"__constant__ float kD\[64\] = \{(.*?)\};", text,
                     re.S).group(1)
    vals = [float.fromhex(v) for v in
            re.findall(r"(-?0x[0-9a-f.]+p[-+]?\d+)f", body)]
    got = np.array(vals, np.float64).astype(np.float32)
    assert got.size == 64
    assert got.tobytes() == T_dct.dct_basis_np("float32").reshape(-1).tobytes()


def test_tile_basis_bit_identical():
    """The compile-time basis of the strip-tile kernels (tile_common.cuh
    ``basis``) is the same f32 basis, literal for literal."""
    text = CU_SOURCE.with_name("tile_common.cuh").read_text()
    body = re.search(r"float basis\(int i\) \{\s*constexpr float t\[64\] = "
                     r"\{(.*?)\};", text, re.S).group(1)
    vals = [float.fromhex(v) for v in
            re.findall(r"(-?0x[0-9a-f.]+p[-+]?\d+)f", body)]
    got = np.array(vals, np.float64).astype(np.float32)
    assert got.size == 64
    assert got.tobytes() == T_dct.dct_basis_np("float32").reshape(-1).tobytes()


def test_quant_tables_identical():
    assert T_q.BASE_QUANT_TABLE.tobytes() == J_q.BASE_QUANT_TABLE.tobytes()
    assert T_q.VR == J_q.VR and T_q.BIAS == J_q.BIAS
    assert T_q.ROUNDING_MODES == J_q.ROUNDING_MODES
    for q in (None, 50, 100, 3.7):
        assert (T_q.default_quant_lut(q).tobytes()
                == J_q.default_quant_lut(q).tobytes())


@pytest.mark.parametrize("which", ["quant", "dequant"])
def test_scales_bit_identical(which):
    t_fn = T_q.quant_scales if which == "quant" else T_q.dequant_scales
    j_fn = J_q.quant_scales if which == "quant" else J_q.dequant_scales
    for lut in _luts():
        got = t_fn(lut).numpy()
        want = np.asarray(j_fn(lut))
        assert got.dtype == np.float32
        assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_quantize_to_u8_exact(rounding):
    rng = np.random.default_rng(11)
    coeffs = np.concatenate([
        rng.normal(0, 60, 20000),
        rng.uniform(-3000, 3000, 20000),
        np.arange(-300, 300, 0.5),          # exact halves: ties
    ]).astype(np.float32)
    scales = np.resize(T_q.quant_scales(_luts()[1]).numpy(), coeffs.size)
    got = T_q.quantize_to_u8(torch.from_numpy(coeffs),
                             torch.from_numpy(scales), rounding).numpy()
    want = np.asarray(J_q.quantize_to_u8(jnp.asarray(coeffs),
                                         jnp.asarray(scales), rounding))
    np.testing.assert_array_equal(got, want)


def test_dequantize_from_u8_exact():
    data = np.arange(256, dtype=np.uint8).repeat(64)
    for lut in _luts():
        inv = np.tile(T_q.dequant_scales(lut).numpy(), 256)
        got = T_q.dequantize_from_u8(torch.from_numpy(data),
                                     torch.from_numpy(inv)).numpy()
        want = np.asarray(J_q.dequantize_from_u8(jnp.asarray(data),
                                                 jnp.asarray(inv)))
        assert got.tobytes() == want.tobytes()


def test_lossless_roundtrip_512():
    """512x512 DCT -> IDCT in the 1/255 domain returns the input bits
    (BASELINE config 1, simd_dct_tpu/bench/harness.py:69-84)."""
    img = np.random.default_rng(1).integers(0, 256, (512, 512), np.uint8)
    b = T_blocks.blockize(torch.from_numpy(img)).to(torch.float32) / 255.0
    back = T_dct.idct8x8(T_dct.dct8x8(b)) * 255.0
    out = T_blocks.unblockize(
        torch.clamp(torch.round(back), 0, 255).to(torch.uint8))
    np.testing.assert_array_equal(out.numpy(), img)


def test_dct8x8_close_to_jax():
    x = np.random.default_rng(3).uniform(0, 255, (40, 8, 8)).astype(np.float32)
    got = T_dct.dct8x8(torch.from_numpy(x)).numpy()
    want = np.asarray(J_dct.dct8x8(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    back = T_dct.idct8x8(torch.from_numpy(got)).numpy()
    np.testing.assert_allclose(back, x, rtol=0, atol=2e-4)


def test_blocks_and_group8_match_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (24, 128), np.uint8)
    got = T_blocks.blockize(torch.from_numpy(img)).numpy()
    want = np.asarray(J_blocks.blockize(jnp.asarray(img)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        T_blocks.unblockize(torch.from_numpy(got)).numpy(), img)
    bufs = rng.integers(0, 256, (3, 16, 64), np.uint8)
    flat = T_reorder.group8(torch.from_numpy(bufs)).numpy()
    np.testing.assert_array_equal(
        flat, np.asarray(J_reorder.group8(jnp.asarray(bufs))))
    np.testing.assert_array_equal(
        T_reorder.group8_inverse(torch.from_numpy(flat), 16).numpy(), bufs)
    # the record byte of coefficient p = u*8+v of group block b is p*8 + b
    assert flat[5 * 8 + 3] == bufs[0, 3, 5]
    c = rng.normal(size=(2, 8, 8)).astype(np.float32)
    buf = T_reorder.coeffs_to_buffer(torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(
        buf, np.asarray(J_reorder.coeffs_to_buffer(jnp.asarray(c), "fy")))
    np.testing.assert_array_equal(
        T_reorder.buffer_to_coeffs(torch.from_numpy(buf)).numpy(), c)


def test_batched_group8_is_per_frame():
    bufs = np.random.default_rng(9).integers(0, 256, (2, 3, 8, 64), np.uint8)
    flat = T_reorder.group8(torch.from_numpy(bufs)).numpy()
    assert flat.shape == (2, 3 * 8 * 64)
    for i in range(2):
        np.testing.assert_array_equal(
            flat[i], np.asarray(J_reorder.group8(jnp.asarray(bufs[i]))))
