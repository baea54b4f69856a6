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

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu.core import golden as G
from simd_dct_tpu.kernels import pallas_dct as PK
from simd_dct_tpu.kernels import xla_path as XP
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import api as A
from simd_dct_tpu_torch.kernels import cuda_dct as K
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


# -- the fused round trip's launch plan (roundtrip32_kernel), pure Python -----

# (H2, W) of chip_smoke.py's round-trip geometries: the 4K and 1080p top
# views, W % 128 == 64, and a strip of W = 1984
PLAN_VIEWS = [(2048, 3840), (544, 1920), (128, 192), (8, 1984)]


def _h100():
    """A card of 132 SMs holding 20 CTAs an SM."""
    return 20, 132


def _rt_plan(batch, h2, w, capacity=_h100, base=0, frame_stride=None):
    return K.roundtrip32_plan(batch, h2, w, base=base,
                              frame_stride=2 * h2 * w if frame_stride is None
                              else frame_stride, capacity=capacity)


@pytest.mark.parametrize("batch", [1, 8, 65535])
@pytest.mark.parametrize("h2,w", PLAN_VIEWS)
def test_roundtrip32_plan_covers_each_block_once(h2, w, batch):
    plan = _rt_plan(batch, h2, w)
    bw, sn = w // 8, h2 // 8
    c, r = K.ROUNDTRIP32_TILE_BLOCKS, K.ROUNDTRIP32_TILE_STRIPS
    assert (plan.tile_blocks, plan.tile_strips) == (c, r)
    rows = -(-sn // r)
    assert plan.tiles == batch * rows * plan.tiles_per_row < 1 << 31
    ctas = -(-plan.tiles // K.ROUNDTRIP32_WARPS)   # a warp a tile at once
    assert 1 <= plan.grid == min(ctas, 132 * 20) <= ctas
    per_frame = plan.tiles // batch
    for f in sorted({0, 1, batch - 2, batch - 1} & set(range(batch))):
        # tile t over (frame, row of tiles, tile of the row), as rt_at
        # numbers them: its box is 8c columns of 8r rows from (8c * x,
        # 8r * row)
        t = np.arange(f * per_frame, (f + 1) * per_frame)
        fr, x = np.divmod(t, plan.tiles_per_row)
        frame, row = np.divmod(fr, rows)
        assert (frame == f).all()
        strip = r * row[:, None, None] + np.arange(r)[None, :, None]
        bx = c * x[:, None, None] + np.arange(c)[None, None, :]
        # the copy fills zeros past W and H2; the store drops them
        inside = (bx < bw) & (strip < sn)
        blocks = (strip * bw + bx)[inside]
        np.testing.assert_array_equal(np.bincount(blocks, minlength=sn * bw),
                                      np.ones(sn * bw))
        assert (bx < bw)[-1, 0].sum() == plan.tail_blocks


@pytest.mark.parametrize("w", [64, 192, 1984, 3904])
def test_roundtrip32_plan_short_tiles_where_w_mod_128_is_64(w):
    plan = _rt_plan(1, 16, w)
    assert w % 128 == 64
    assert plan.tail_blocks == 8 < plan.tile_blocks
    assert plan.tail_blocks == w // 8 - (plan.tiles_per_row - 1) * 16
    whole = _rt_plan(1, 16, w + 64)
    assert whole.tail_blocks == whole.tile_blocks


def test_roundtrip32_plan_shared_bytes_and_refusals():
    # each warp's input tiles and pixel buffers, 16 rows x 8 * 16 pixels
    assert K.roundtrip32_smem() == (
        K.ROUNDTRIP32_WARPS * (K.ROUNDTRIP32_STAGES + K.ROUNDTRIP32_OUT_BUFFERS)
        * 8 * K.ROUNDTRIP32_TILE_STRIPS * 8 * K.ROUNDTRIP32_TILE_BLOCKS
    ) <= K.SMEM_LIMIT
    assert _rt_plan(1, 8, 64).smem == K.roundtrip32_smem()
    with pytest.raises(ValueError):     # no CTA fits an SM
        _rt_plan(1, 8, 64, capacity=lambda: (0, 132))
    with pytest.raises(ValueError):     # 2^31 tiles or more
        _rt_plan(65535, 1 << 14, 1 << 15)
    for base, stride in [(8, 1024), (0, 1032)]:    # off 16 bytes
        with pytest.raises(ValueError):
            _rt_plan(2, 8, 64, base=base, frame_stride=stride)
    with pytest.raises(ValueError):     # frames overlap
        _rt_plan(2, 8, 64, frame_stride=256)
    for h2, w in [(12, 64), (8, 96), (0, 64)]:
        with pytest.raises(ValueError):
            _rt_plan(1, h2, w)
    small = _rt_plan(1, 8, 64)     # one strip of 8 blocks: one short tile
    assert small.tiles == 1 and small.grid == 1 and small.tail_blocks == 8
    assert _rt_plan(65535, 16, 128).grid == 132 * 20


# -- the encode's and decode's launch plans (enc32_kernel, dec32_kernel) ------

M32NB = K.MODE32_TILE_BLOCKS


def _sm14(variant):
    """A card of 132 SMs holding 14 CTAs of any launch an SM."""
    return 14, 132


def _m32_plan(kind, batch, h2, w, pixels=0, records=0, stride=None):
    if kind == "enc32":
        return K.enc32_plan(batch, h2, w, pixels=pixels, records=records,
                            frame_stride=2 * h2 * w if stride is None
                            else stride, capacity=_sm14)
    return K.dec32_plan(batch, h2, w, records=records, pixels=pixels,
                        capacity=_sm14)


def _m32_tile_at(plan, s_n, t):
    """(frame, strip, first block, blocks) of tile ``t`` (an integer array),
    numbered over (frame, strip, tile of the strip) as m32_tile reads a
    TileWalk."""
    row, x = np.divmod(t, plan.tiles_per_strip)
    frame, s = np.divmod(row, s_n)
    last = x == plan.tiles_per_strip - 1
    return frame, s, x * plan.tile_blocks, np.where(last, plan.tail_blocks,
                                                    plan.tile_blocks)


@pytest.mark.parametrize("batch", [1, 8, 65535])
@pytest.mark.parametrize("w,tiles,tail", [(64, 1, 8), (192, 1, 24),
                                          (1920, 8, 16), (1984, 8, 24),
                                          (3840, 15, 32)])
def test_mode32_plan_covers_each_block_once(batch, w, tiles, tail):
    h2 = 16
    s_n, bw = h2 // 8, w // 8
    for kind in ("enc32", "dec32"):
        plan = _m32_plan(kind, batch, h2, w)
        assert (plan.tile_blocks, plan.tiles_per_strip,
                plan.tail_blocks) == (M32NB, tiles, tail)
        assert plan.tiles == batch * s_n * tiles < 1 << 31
        assert 1 <= plan.grid == min(plan.tiles, 14 * 132)
        per_frame = s_n * tiles
        for f in sorted({0, 1, batch - 2, batch - 1} & set(range(batch))):
            frame, s, bx0, n = _m32_tile_at(
                plan, s_n, np.arange(f * per_frame, (f + 1) * per_frame))
            assert (frame == f).all()
            # a tile never crosses a strip, holds whole 8-block groups,
            # and its records are the 64n bytes from 64 * (s*BW + bx0)
            assert ((bx0 + n <= bw) & (n > 0) & (n % 8 == 0)).all()
            cols = np.arange(M32NB)[None]
            blocks = ((s * bw + bx0)[:, None] + cols)[cols < n[:, None]]
            np.testing.assert_array_equal(np.bincount(blocks),
                                          np.ones(s_n * bw))


@pytest.mark.parametrize("pixels,stride,ok", [
    (0, None, True), (4096, None, True),
    (8, None, False),                         # a base 8 bytes off
    (0, 2 * 32 * 3840 + 8, False),            # a frame stride off 16
    (8, 2 * 32 * 3840 + 8, False)])
def test_mode32_plan_takes_tensor_copies_or_refuses(pixels, stride, ok):
    """The pixels move by tensor copies only: a base or a frame stride off
    a 16-byte boundary is refused (the wrappers take aligned tensors)."""
    kinds = ["enc32"] + (["dec32"] if stride is None else [])
    for kind in kinds:     # the decode writes frames H2*W apart
        if ok:
            assert _m32_plan(kind, 2, 32, 3840, pixels=pixels,
                             stride=stride).variant == "tensor"
        else:
            with pytest.raises(ValueError, match="16-byte"):
                _m32_plan(kind, 2, 32, 3840, pixels=pixels, stride=stride)


def _dct32_constants() -> dict:
    """dct32.cu's and dct_common.cuh's ``constexpr int`` values, evaluated
    as C ints."""
    env = {}
    for name in ("dct_common.cuh", "dct32.cu"):
        path = os.path.join(os.path.dirname(K.__file__), os.pardir, "csrc",
                            name)
        with open(path) as f:
            text = f.read()
        for key, expr in re.findall(r"constexpr int (k\w+)\s*=\s*([^;]+);",
                                    text):
            env[key] = eval(expr.replace("/", "//"), {}, dict(env))
    return env


def test_mode32_plan_shared_bytes_equal_the_kernels():
    c = _dct32_constants()
    assert c["kM32TileBlocks"] == K.MODE32_TILE_BLOCKS
    assert c["kGroupStride"] == K._GROUP_STRIDE
    assert c["kE32Smem"] == K.enc32_smem() == _m32_plan("enc32", 1, 8,
                                                        64).smem
    assert c["kD32Smem"] == K.dec32_smem() == _m32_plan("dec32", 1, 8,
                                                        64).smem
    # the scales; one pixel tile and two record buffers of four padded
    # groups (the decode: two pixel tiles and one record buffer); the f32
    # crossing buffer, at nb = 32
    assert (K.enc32_smem(), K.dec32_smem()) == (14720, 14656)
    assert max(K.enc32_smem(), K.dec32_smem()) <= 48 * 1024


# (H, W, start_y, end_y) of the strip ranges chip_smoke.py and the card
# tests run
M32_RANGES = [(512, 3840, 64, 191), (512, 256, 16, 16), (512, 1920, 32, 95),
              (512, 64, 48, 1 << 40), (512, 256, -(1 << 40), 0),
              (512, 3840, 0, 0), (512, 3840, 200, 1 << 40),
              (512, 3840, -(1 << 40), 100), (16, 1984, 0, 1 << 30)]


@pytest.mark.parametrize("h,w,sy,ey", M32_RANGES)
def test_mode32_plan_each_byte_has_one_writer(h, w, sy, ey):
    """The encode's writer rule on the plan's tiles: a kept tile's records
    leave by its group bulk stores, an excluded tile's zeros by its
    threads, each over its 64n bytes; together once each byte, and the
    kept bytes are where the plain version writes.  This checks the rule,
    not the kernel: tests/test_torch_cuda.py's
    test_enc32_strip_ranges_leave_one_writer_a_byte runs the kernel over
    outputs preset to 0xAB."""
    h2 = h // 2
    s_n, bw = h2 // 8, w // 8
    plan = _m32_plan("enc32", 2, h2, w)
    frame, s, bx0, n = _m32_tile_at(plan, s_n, np.arange(plan.tiles))
    kept = (16 * s >= sy) & (16 * s <= ey)
    stores, zeros = np.zeros(2 * h2 * w, np.int64), np.zeros(2 * h2 * w,
                                                            np.int64)
    for f, a, b0, nb, k in zip(frame, s, bx0, n, kept):
        base = f * h2 * w + 64 * (a * bw + b0)
        if k:
            for gi in range(nb // 8):     # a 512-byte bulk store a group
                stores[base + 512 * gi: base + 512 * (gi + 1)] += 1
        else:
            zeros[base: base + 64 * nb] += 1
    np.testing.assert_array_equal(stores + zeros, 1)
    mask = A._strip_byte_mask(h, w, sy, ey)
    want = np.ones(h2 * w, bool) if mask is None else mask
    np.testing.assert_array_equal(stores.reshape(2, -1) == 1, [want, want])


def test_mode32_plan_refusals():
    assert _m32_plan("enc32", 65535, 16, 64).tiles == 65535 * 2
    with pytest.raises(ValueError):          # a launch takes 65,535 frames
        _m32_plan("enc32", 65536, 8, 64)
    with pytest.raises(ValueError):
        _m32_plan("dec32", 0, 8, 64)
    with pytest.raises(ValueError):          # no CTA fits
        K.enc32_plan(1, 8, 64, pixels=0, records=0, frame_stride=1024,
                     capacity=lambda v: (0, 132))
    with pytest.raises(ValueError):          # 2^31 tiles or more
        _m32_plan("enc32", 65535, 1 << 14, 1 << 15)
    for h2, w in [(12, 64), (8, 96), (0, 64), (8, 0)]:   # geometry
        with pytest.raises(ValueError):
            _m32_plan("enc32", 1, h2, w)
    for kw in [dict(records=8), dict(pixels=4), dict(stride=1028),
               dict(stride=256)]:    # 16-byte records, 8-byte pixels and
        with pytest.raises(ValueError):   # stride, frames that overlap
            _m32_plan("enc32", 2, 8, 64, **kw)
    with pytest.raises(ValueError):
        K._m32_plan("tiles", 1, 8, 64, pixels=0, records=0, frame_stride=512,
                    capacity=_sm14, tile_blocks=32, smem=0)
