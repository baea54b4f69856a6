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
