"""The port's plain mode32 path against the JAX package.

References: the JAX ``xla`` tier, the Pallas kernels in interpret mode at
f32 (as tests/test_pallas_kernels.py runs them) and the NumPy golden model.
Tolerances:
  * encode records and decoded pixels (of the SAME records): at most +-1,
    on at most 0.2% of bytes -- the ``compare_backends`` contract;
  * round trip: the port's fused result equals its own decode(encode(x))
    exactly, and its PSNR on a smooth image is within 0.1 dB of the JAX
    round trip (the f32 tolerance of ``psnr_gate``).  Round-trip pixels of
    two implementations are not compared by absolute difference: one +-1
    record byte at a coarse quantizer moves pixels by far more than 2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu.core import golden as G
from simd_dct_tpu.kernels import pallas_dct as PK
from simd_dct_tpu.kernels import xla_path as XP
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch.kernels import torch_path as TP
from simd_dct_tpu_torch.utils.debug import compare_backends
from simd_dct_tpu_torch.utils.metrics import psnr

GEOMETRIES = [(256, 128), (256, 192), (272, 64)]   # (H, W); W%128 != 0, odd S


def _img(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


def _smooth(rng, h, w):
    """The smooth test image of simd_dct_tpu/bench/harness.py:62-66."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = (128 + 45 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
           + 30 * (xx / max(w - 1, 1)) + rng.normal(0, 3, (h, w)))
    return np.clip(img, 0, 255).astype(np.uint8)


def _lut(q=50):
    return T.default_quant_lut(q) * np.float32(255.0)


def _assert_contract(outs):
    report = compare_backends(outs)
    bad = {k: v for k, v in report.items() if not v["ok"]}
    assert not bad, bad


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_encode_matches_jax(h, w):
    img, lut = _img(h, w), _lut()
    port = TP.encode_quantize32(torch.from_numpy(img), lut)
    assert port.shape == (h // 2 * w,) and port.dtype == torch.uint8
    _assert_contract({
        "port": port,
        "xla": XP.encode_quantize32(jnp.asarray(img), jnp.asarray(lut)),
        "pallas": PK.encode_quantize32(jnp.asarray(img), lut, interpret=True,
                                       precision="f32"),
        "golden": G.encode_quantize32_golden(img, lut),
    })


@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_encode_rounding_modes_match_jax(rounding):
    img, lut = _img(256, 192, seed=1), _lut()
    _assert_contract({
        "port": TP.encode_quantize32(torch.from_numpy(img), lut,
                                     rounding=rounding),
        "xla": XP.encode_quantize32(jnp.asarray(img), jnp.asarray(lut),
                                    0, 1 << 30, rounding),
        "golden": G.encode_quantize32_golden(img, lut, rounding=rounding),
    })


def test_encode_strip_range_matches_jax():
    img, lut = _img(256, 128, seed=2), _lut()
    port = TP.encode_quantize32(torch.from_numpy(img), lut, 32, 63).numpy()
    _assert_contract({
        "port": port,
        "pallas": PK.encode_quantize32(jnp.asarray(img), lut, 32, 63,
                                       interpret=True, precision="f32"),
        "golden": G.encode_quantize32_golden(img, lut, 32, 63),
    })
    strips = port.reshape(256 // 16, -1)
    assert not strips[[0, 1, 4, 5]].any()      # strips 2 and 3 only
    assert strips[2:4].any()


@pytest.mark.parametrize("h,w", GEOMETRIES)
def test_decode_same_records_matches_jax(h, w):
    img, lut = _img(h, w, seed=3), _lut()
    rec = G.encode_quantize32_golden(img, lut)
    port = TP.decode_quantize32(torch.from_numpy(rec), lut, w, h)
    assert port.shape == (h // 2, w)
    _assert_contract({
        "port": port,
        "xla": XP.decode_quantize32(jnp.asarray(rec), jnp.asarray(lut), w, h),
        "pallas": PK.decode_quantize32(rec, lut, w, h, interpret=True,
                                       precision="f32"),
        "golden": G.decode_quantize32_golden(rec, lut, w, h),
    })


def test_batch_matches_per_frame_and_jax():
    frames = np.stack([_img(256, 128, seed=s) for s in range(3)])
    lut = _lut()
    port = T.encode_quantize32(frames, lut, device="cpu")
    assert port.shape == (3, 128 * 128)
    jax_rec = np.asarray(J.encode_quantize32(frames, lut, backend="xla"))
    _assert_contract({"port": port, "jax": jax_rec})
    for i in range(3):
        np.testing.assert_array_equal(
            port[i].numpy(),
            T.encode_quantize32(frames[i], lut, device="cpu").numpy())
    dec = T.decode_quantize32(jax_rec, lut, 128, 256, device="cpu")
    assert dec.shape == (3, 128, 128)
    _assert_contract({
        "port": dec,
        "jax": J.decode_quantize32(jax_rec, lut, 128, 256, backend="xla")})


def test_spill_matches_jax():
    img, lut = _img(264, 128, seed=4), _lut()
    port = T.encode_quantize32(img, lut, spill=True, device="cpu")
    want = np.asarray(J.encode_quantize32(img, lut, spill=True,
                                          backend="xla"))
    assert port.shape == want.shape == (136 * 128,)
    _assert_contract({"port": port, "jax": want})


def test_records_cross_between_packages():
    """A stream written by either package decodes in the other."""
    img, lut = _img(256, 192, seed=5), _lut()
    jax_rec = np.asarray(XP.encode_quantize32(jnp.asarray(img),
                                              jnp.asarray(lut)))
    port_rec = T.encode_quantize32(img, lut, device="cpu").numpy()
    _assert_contract({
        "port(jax records)": T.decode_quantize32(jax_rec, lut, 192, 256,
                                                 device="cpu"),
        "jax(jax records)": XP.decode_quantize32(jnp.asarray(jax_rec),
                                                 jnp.asarray(lut), 192, 256),
    })
    _assert_contract({
        "jax(port records)": XP.decode_quantize32(jnp.asarray(port_rec),
                                                  jnp.asarray(lut), 192, 256),
        "port(port records)": T.decode_quantize32(port_rec, lut, 192, 256,
                                                  device="cpu"),
    })


@pytest.mark.parametrize("quality", [50, 100])
def test_roundtrip_fused_equals_composed_and_psnr(quality):
    rng = np.random.default_rng(6)
    img, lut = _smooth(rng, 256, 192), _lut(quality)
    fused = T.roundtrip_quantize32(img, lut, device="cpu")
    composed = T.decode_quantize32(
        T.encode_quantize32(img, lut, device="cpu"), lut, 192, 256)
    np.testing.assert_array_equal(fused.numpy(), composed.numpy())
    top = img[:128]
    jax_rt = np.asarray(J.roundtrip_quantize32(img, lut, backend="xla"))
    pallas_rt = np.asarray(PK.roundtrip_quantize32(
        jnp.asarray(img[:, :128]), lut, interpret=True, precision="f32"))
    assert abs(psnr(top, fused.numpy()) - psnr(top, jax_rt)) < 0.1
    port_128 = T.roundtrip_quantize32(img[:, :128].copy(), lut,
                                     device="cpu").numpy()
    assert abs(psnr(top[:, :128], port_128)
               - psnr(top[:, :128], pallas_rt)) < 0.1
