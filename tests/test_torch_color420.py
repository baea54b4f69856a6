"""The port's plain YCbCr 4:2:0 colour path against the JAX package.

References: the JAX ``xla`` tier of ``kernels/color420.py``
(``encode_ycbcr420_xla`` / ``decode_ycbcr420_xla``, and the JAX api with
``backend="xla"``) and the Pallas kernels in interpret mode at f32
(``enc420_rgb`` / ``dec420_rgb`` at 64x384, ``_enc420_panels`` /
``_dec420_panels`` at 64x256; about 1 s a call here, so one module-scoped
fixture makes all four).  Inputs are made with numpy from a seed; the luma
LUT is the CLI's table at quality 100, the chroma LUT
``BASE_CHROMA_QUANT_TABLE`` at quality 100 or a seeded random table, both
255x hotter (mode32's raw domain).  Tolerances:
  * encode streams and decoded pixels: at most +-1, on at most 0.2% of
    bytes -- the ``compare_backends`` contract (the JAX xla tier pools with
    ``mean`` and the Pallas kernels fold the pool into the DCT bases, so
    neither sums in the port's order);
  * round-trip PSNR on smooth correlated planes: within 0.01 dB;
  * pack / unpack, replication, the Y segment, shapes, batch == frames and
    the streams carried by ``convert``: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu.kernels import color420 as JC
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import convert
from simd_dct_tpu_torch.kernels import cuda_dct as K
from simd_dct_tpu_torch.kernels import torch_path as TP
from simd_dct_tpu_torch.layout import color as T_color
from simd_dct_tpu_torch.layout import color420 as L420
from simd_dct_tpu_torch.utils.debug import compare_backends

ROUNDINGS = ("rne", "scalar", "clamp_first")
CPU = {"device": "cpu"}
LUMA = T.default_quant_lut(100) * np.float32(255.0)


def _chroma(kind="jpeg"):
    if kind == "jpeg":
        return T_color.BASE_CHROMA_QUANT_TABLE * np.float32(100 * 255)
    return np.random.default_rng(29).uniform(1000.0, 9000.0,
                                             64).astype(np.float32)


def _planes(h, w, seed=0, frames=None):
    shape = (3, h, w) if frames is None else (frames, 3, h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _assert_contract(outs):
    report = compare_backends(outs)
    bad = {k: v for k, v in report.items() if not v["ok"]}
    assert not bad, bad


def _flat(y_rec, c_rec):
    return np.array(JC.pack_records(y_rec, c_rec))


def _port_enc(planes, chroma, rounding="rne"):
    return TP.encode_ycbcr420(torch.from_numpy(planes), LUMA, chroma,
                              rounding).numpy()


def _xla_enc(planes, chroma, rounding="rne"):
    h = planes.shape[-2]
    return _flat(*JC.encode_ycbcr420_xla(jnp.asarray(planes[:, : h // 2]),
                                         LUMA, chroma, rounding=rounding))


def _xla_dec(stream, chroma, w, h):
    y_rec, c_rec = JC.unpack_records(jnp.asarray(stream), w, h // 2)
    return np.asarray(JC.decode_ycbcr420_xla(y_rec, c_rec, LUMA, chroma))


# -- the stream layout and the chroma resampling ------------------------------

@pytest.mark.parametrize("h2,w", [(32, 128), (16, 384)])
def test_pack_and_unpack_match_jax(h2, w):
    rng = np.random.default_rng(h2 + w)
    y = rng.integers(0, 256, (h2 // 8, 8 * w), np.uint8)
    c = rng.integers(0, 256, (2, h2 // 16, 4 * w), np.uint8)
    flat = L420.pack_records(torch.from_numpy(y), torch.from_numpy(c))
    assert flat.shape == (L420.record_bytes_420(h2, w),)
    np.testing.assert_array_equal(flat.numpy(), _flat(y, c))
    y_t, c_t = L420.unpack_records(flat, w, h2)
    y_j, c_j = JC.unpack_records(jnp.asarray(_flat(y, c)), w, h2)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    # a batch packs and unpacks frame by frame
    both = L420.pack_records(torch.from_numpy(np.stack([y, y])),
                             torch.from_numpy(np.stack([c, c])))
    assert both.shape == (2, flat.numel())
    np.testing.assert_array_equal(L420.unpack_records(both, w, h2)[1][1],
                                  c)


def test_pool_and_replicate():
    x = np.random.default_rng(3).uniform(-40, 300, (2, 8, 16)) \
        .astype(np.float32)
    got = L420.pool2x2(torch.from_numpy(x)).numpy()
    q = x.reshape(2, 4, 2, 8, 2)
    want = ((q[:, :, 0, :, 0] + q[:, :, 0, :, 1])
            + (q[:, :, 1, :, 0] + q[:, :, 1, :, 1])) * np.float32(0.25)
    assert got.tobytes() == want.astype(np.float32).tobytes()
    np.testing.assert_allclose(got, q.mean(axis=(2, 4)), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(
        L420.replicate2x2(torch.from_numpy(got)).numpy(),
        np.repeat(np.repeat(got, 2, axis=1), 2, axis=2))


# -- encode / decode against xla and Pallas interpret ------------------------

ENCODE_CASES = [(64, w, kind, r) for (w, kind) in
                [(128, "jpeg"), (384, "random")] for r in ROUNDINGS]


@pytest.mark.parametrize("h,w,kind,rounding", ENCODE_CASES)
def test_encode_matches_xla(h, w, kind, rounding):
    planes, chroma = _planes(h, w, seed=h + w), _chroma(kind)
    port = _port_enc(planes, chroma, rounding)
    assert port.shape == (3 * (h // 2) * w // 2,) and port.dtype == np.uint8
    _assert_contract({"port": port,
                      "xla": _xla_enc(planes, chroma, rounding)})


@pytest.mark.parametrize("h,w,kind", [(64, 128, "jpeg"), (64, 384, "random")])
def test_decode_same_records_matches_xla(h, w, kind):
    planes, chroma = _planes(h, w, seed=5 + w), _chroma(kind)
    rec = _xla_enc(planes, chroma)
    port = TP.decode_ycbcr420(torch.from_numpy(rec), LUMA, chroma, w, h)
    assert port.shape == (3, h // 2, w) and port.dtype == torch.uint8
    _assert_contract({"port": port, "xla": _xla_dec(rec, chroma, w, h)})


@pytest.fixture(scope="module")
def pallas_420():
    """The Pallas 4:2:0 kernels in interpret mode at f32: the encode and
    decode at 64x384 (``enc420_rgb`` / ``dec420_rgb``, which pad W to 512
    and slice) and at 64x256 (``_enc420_panels`` / ``_dec420_panels``
    directly)."""
    out = {}
    planes, chroma = _planes(64, 384, seed=384), _chroma("jpeg")
    out["enc", 384] = _flat(*JC.enc420_rgb(
        jnp.asarray(planes[:, :32]), LUMA, chroma, interpret=True,
        precision="f32"))
    y_rec, c_rec = JC.unpack_records(jnp.asarray(_xla_enc(planes, chroma)),
                                     384, 32)
    out["dec", 384] = np.asarray(JC.dec420_rgb(
        y_rec, c_rec, LUMA, chroma, interpret=True, precision="f32"))
    planes, chroma = _planes(64, 256, seed=256), _chroma("random")
    out["enc", 256] = _flat(*JC._enc420_panels(
        jnp.asarray(planes[:, :32]), jnp.asarray(LUMA), jnp.asarray(chroma),
        interpret=True, precision="f32"))
    y_rec, c_rec = JC.unpack_records(jnp.asarray(_xla_enc(planes, chroma)),
                                     256, 32)
    out["dec", 256] = np.asarray(JC._dec420_panels(
        y_rec, c_rec, jnp.asarray(LUMA), jnp.asarray(chroma), interpret=True,
        precision="f32"))
    return out


@pytest.mark.parametrize("w,kind", [(384, "jpeg"), (256, "random")])
def test_encode_matches_pallas_interpret(pallas_420, w, kind):
    planes, chroma = _planes(64, w, seed=w), _chroma(kind)
    port = _port_enc(planes, chroma)
    assert port.shape == pallas_420["enc", w].shape
    _assert_contract({"port": port, "pallas": pallas_420["enc", w],
                      "xla": _xla_enc(planes, chroma)})


@pytest.mark.parametrize("w,kind", [(384, "jpeg"), (256, "random")])
def test_decode_matches_pallas_interpret(pallas_420, w, kind):
    planes, chroma = _planes(64, w, seed=w), _chroma(kind)
    rec = _xla_enc(planes, chroma)
    port = TP.decode_ycbcr420(torch.from_numpy(rec), LUMA, chroma, w, 64)
    assert tuple(port.shape) == pallas_420["dec", w].shape
    _assert_contract({"port": port, "pallas": pallas_420["dec", w],
                      "xla": _xla_dec(rec, chroma, w, 64)})


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_y_segment_is_the_444_luma(rounding):
    """The 4:2:0 stream's Y records are channel 0 of the 4:4:4 records
    (tests/test_color420.py::test_y_segment_is_mode32_luma in the JAX
    package)."""
    planes = torch.from_numpy(_planes(64, 384, seed=12, frames=2))
    stream = TP.encode_ycbcr420(planes, LUMA, _chroma("random"), rounding)
    luma = TP.encode_ycbcr32(planes, LUMA, _chroma(), rounding)[:, 0]
    np.testing.assert_array_equal(stream[:, : 32 * 384].numpy(),
                                  luma.numpy())


# -- the api against the JAX api ---------------------------------------------

@pytest.mark.parametrize("frames", [None, 2])
def test_api_matches_jax_xla(frames):
    planes, chroma = _planes(64, 256, seed=7, frames=frames), _chroma()
    rec = T.encode_quantize32_ycbcr420(planes, LUMA, chroma, **CPU)
    want = np.asarray(J.api.encode_quantize32_ycbcr420(planes, LUMA, chroma,
                                                       backend="xla"))
    assert tuple(rec.shape) == want.shape
    _assert_contract({"port": rec, "jax": want})
    pix = T.decode_quantize32_ycbcr420(rec, LUMA, chroma, 256, 64)
    jpix = np.asarray(J.api.decode_quantize32_ycbcr420(
        rec.numpy(), LUMA, chroma, 256, 64, backend="xla"))
    assert tuple(pix.shape) == jpix.shape
    _assert_contract({"port": pix, "jax": jpix})


def test_smooth_roundtrip_psnr_equals_jax():
    """The config-3 gate's inputs (simd_dct_tpu/bench/harness.py:151-156):
    three correlated channels of one smooth field."""
    yy, xx = np.mgrid[0:64, 0:384]
    base = (128 + 45 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
            + 30 * (xx / 383.0)).astype(np.float32)
    top = np.clip(np.stack([base, base * 0.9 + 12, base * 0.8 + 25]), 0,
                  255).astype(np.uint8)
    planes = np.concatenate([top, np.zeros_like(top)], axis=1)
    chroma = _chroma()
    port = T.decode_quantize32_ycbcr420(
        T.encode_quantize32_ycbcr420(planes, LUMA, chroma, **CPU), LUMA,
        chroma, 384, 128).numpy()
    want = np.asarray(J.api.decode_quantize32_ycbcr420(
        J.api.encode_quantize32_ycbcr420(planes, LUMA, chroma,
                                         backend="xla"),
        LUMA, chroma, 384, 128, backend="xla"))

    def psnr(x):
        mse = ((x.astype(np.float64) - top) ** 2).mean()
        return 10 * np.log10(255.0 ** 2 / mse)

    assert psnr(port) > 30.0
    assert abs(psnr(port) - psnr(want)) < 0.01


# -- batches, the batch of one, streams across packages ----------------------

def test_batch_equals_frames():
    frames, chroma = _planes(32, 256, seed=9, frames=3), _chroma("random")
    rec = T.encode_quantize32_ycbcr420(frames, LUMA, chroma, **CPU)
    dec = T.decode_quantize32_ycbcr420(rec, LUMA, chroma, 256, 32, **CPU)
    assert rec.shape == (3, 3 * 16 * 256 // 2) and dec.shape == (3, 3, 16,
                                                                  256)
    for i in range(3):
        one = T.encode_quantize32_ycbcr420(frames[i], LUMA, chroma, **CPU)
        np.testing.assert_array_equal(rec[i].numpy(), one.numpy())
        np.testing.assert_array_equal(
            dec[i].numpy(),
            T.decode_quantize32_ycbcr420(one, LUMA, chroma, 256, 32).numpy())


def test_batch_of_one_keeps_its_axis_unlike_jax():
    """The JAX api's 4:2:0 decode drops the axis of a batch of one
    (simd_dct_tpu/api.py:853-856 vmaps only for batch > 1); the port keeps
    it for any input with ndim >= 2, so decode(encode(x)) has the shape of
    x's top view."""
    one, chroma = _planes(64, 128, seed=10, frames=1), _chroma()
    rec = T.encode_quantize32_ycbcr420(one, LUMA, chroma, **CPU)
    jrec = np.asarray(J.api.encode_quantize32_ycbcr420(one, LUMA, chroma,
                                                       backend="xla"))
    assert rec.shape == jrec.shape == (1, 6144)
    pix = T.decode_quantize32_ycbcr420(rec, LUMA, chroma, 128, 64)
    jpix = J.api.decode_quantize32_ycbcr420(jrec, LUMA, chroma, 128, 64,
                                            backend="xla")
    assert pix.shape == (1, 3, 32, 128)
    assert jpix.shape == (3, 32, 128)
    np.testing.assert_array_equal(pix[0].numpy(), np.asarray(jpix))
    # a flat stream of one frame decodes unbatched, two frames batched
    assert T.decode_quantize32_ycbcr420(rec.reshape(-1), LUMA, chroma, 128,
                                        64).shape == (3, 32, 128)
    two = torch.cat([rec.reshape(-1)] * 2)
    assert T.decode_quantize32_ycbcr420(two, LUMA, chroma, 128,
                                        64).shape == (2, 3, 32, 128)


@pytest.mark.parametrize("frames", [None, 2])
def test_streams_cross_between_packages(frames):
    """A 4:2:0 stream written by either package goes through ``convert``
    unchanged and decodes in the other."""
    planes, chroma = _planes(64, 384, seed=11, frames=frames), _chroma()
    jax_rec = np.asarray(J.api.encode_quantize32_ycbcr420(
        planes, LUMA, chroma, backend="xla"))
    t = convert.color420_records_from_numpy(jax_rec, 384, 64, **CPU)
    assert tuple(t.shape) == jax_rec.shape
    np.testing.assert_array_equal(convert.records_to_numpy(t), jax_rec)
    _assert_contract({
        "port(jax records)": T.decode_quantize32_ycbcr420(t, LUMA, chroma,
                                                          384, 64),
        "jax(jax records)": J.api.decode_quantize32_ycbcr420(
            jax_rec, LUMA, chroma, 384, 64, backend="xla")})
    port_rec = convert.records_to_numpy(
        T.encode_quantize32_ycbcr420(planes, LUMA, chroma, **CPU))
    _assert_contract({"port records": port_rec, "jax records": jax_rec})
    _assert_contract({
        "jax(port records)": J.api.decode_quantize32_ycbcr420(
            port_rec, LUMA, chroma, 384, 64, backend="xla"),
        "port(port records)": T.decode_quantize32_ycbcr420(
            port_rec, LUMA, chroma, 384, 64, **CPU)})


def test_color420_records_from_numpy_checks():
    flat = np.zeros(3 * 16 * 128 // 2, np.uint8)
    assert convert.color420_records_from_numpy(flat, 128, 32, **CPU).shape \
        == (flat.size,)
    assert convert.color420_records_from_numpy(flat[None], 128, 32,
                                               **CPU).shape == (1, flat.size)
    assert convert.color420_records_from_numpy(
        np.stack([flat, flat]), 128, 32, **CPU).shape == (2, flat.size)
    for bad in (flat[1:], flat.astype(np.int16), flat[:0]):
        with pytest.raises(ValueError):
            convert.color420_records_from_numpy(bad, 128, 32, **CPU)


# -- api contract: typed errors as the JAX api, device rule ------------------

LUT_NAN = np.where(np.arange(64) == 9, np.nan, LUMA).astype(np.float32)
STREAM = np.zeros(3 * 16 * 128 // 2, np.uint8)

BAD_CALLS = {
    "encode_w192": lambda m: m.encode_quantize32_ycbcr420(
        _planes(32, 192), LUMA, _chroma()),
    "encode_h48": lambda m: m.encode_quantize32_ycbcr420(
        _planes(48, 128), LUMA, _chroma()),
    "encode_w96": lambda m: m.encode_quantize32_ycbcr420(
        _planes(32, 96), LUMA, _chroma()),
    "encode_gray": lambda m: m.encode_quantize32_ycbcr420(
        _planes(32, 128)[0], LUMA, _chroma()),
    "encode_dtype": lambda m: m.encode_quantize32_ycbcr420(
        _planes(32, 128).astype(np.int16), LUMA, _chroma()),
    "encode_rounding": lambda m: m.encode_quantize32_ycbcr420(
        _planes(32, 128), LUMA, _chroma(), rounding="up"),
    "encode_luma_63": lambda m: m.encode_quantize32_ycbcr420(
        _planes(32, 128), LUMA[:63], _chroma()),
    "encode_chroma_nan": lambda m: m.encode_quantize32_ycbcr420(
        _planes(32, 128), LUMA, LUT_NAN),
    "decode_w192": lambda m: m.decode_quantize32_ycbcr420(
        STREAM, LUMA, _chroma(), 192, 32),
    "decode_h48": lambda m: m.decode_quantize32_ycbcr420(
        STREAM, LUMA, _chroma(), 128, 48),
    "decode_dtype": lambda m: m.decode_quantize32_ycbcr420(
        STREAM.astype(np.int16), LUMA, _chroma(), 128, 32),
    "decode_length": lambda m: m.decode_quantize32_ycbcr420(
        STREAM[1:], LUMA, _chroma(), 128, 32),
    "decode_empty": lambda m: m.decode_quantize32_ycbcr420(
        STREAM[:0], LUMA, _chroma(), 128, 32),
    "decode_x0": lambda m: m.decode_quantize32_ycbcr420(
        STREAM, LUMA, _chroma(), 0, 32),
    "decode_lut_5": lambda m: m.decode_quantize32_ycbcr420(
        STREAM, LUMA, _chroma()[:5], 128, 32),
}


class _PortOnCpu:
    """The port's api with device="cpu" on every call."""
    def __getattr__(self, name):
        fn = getattr(T, name)
        return lambda *a, **kw: fn(*a, device="cpu", **kw)


class _JaxXla:
    """The JAX api on its xla tier."""
    def __getattr__(self, name):
        fn = getattr(J.api, name)
        return lambda *a, **kw: fn(*a, backend="xla", **kw)


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_typed_errors_match_jax(case):
    with pytest.raises(J.SimdDctError) as jexc:
        BAD_CALLS[case](_JaxXla())
    with pytest.raises(getattr(T, type(jexc.value).__name__)):
        BAD_CALLS[case](_PortOnCpu())


def test_numpy_input_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "encode": lambda **kw: T.encode_quantize32_ycbcr420(
            _planes(32, 128), LUMA, _chroma(), **kw),
        "decode": lambda **kw: T.decode_quantize32_ycbcr420(
            STREAM, LUMA, _chroma(), 128, 32, **kw),
        "convert": lambda **kw: convert.color420_records_from_numpy(
            STREAM, 128, 32, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(T.NotSupportedError, match='device="cpu"'):
            call()
        assert call(device="cpu").device.type == "cpu", name
    with pytest.raises(T.NotSupportedError):
        T.encode_quantize32_ycbcr420(torch.from_numpy(_planes(32, 128)),
                                     LUMA, _chroma(), backend="cuda")


# -- the wrappers on CPU tensors ---------------------------------------------

def test_wrappers_on_cpu_take_the_plain_version():
    planes = torch.from_numpy(_planes(64, 384, seed=14, frames=2))
    before = dict(K.LAUNCHES)
    rec = K.encode_quantize32_ycbcr420(planes, LUMA, _chroma(), "scalar")
    np.testing.assert_array_equal(
        rec.numpy(),
        TP.encode_ycbcr420(planes, LUMA, _chroma(), "scalar").numpy())
    dec = K.decode_quantize32_ycbcr420(rec, LUMA, _chroma(), 384, 64)
    assert dec.shape == (2, 3, 32, 384)
    np.testing.assert_array_equal(
        dec.numpy(),
        TP.decode_ycbcr420(rec, LUMA, _chroma(), 384, 64).numpy())
    assert K.LAUNCHES == before
    assert K.supports_mode("enc_quant32_ycbcr420", 64, 384)
    assert not K.supports_mode("enc_quant32_ycbcr420", 48, 384)
    assert not K.supports_mode("dec_quant32_ycbcr420", 64, 192)


@pytest.mark.parametrize("fn", ["encode", "decode"])
def test_wrappers_reject_bad_tensors(fn):
    planes = torch.from_numpy(_planes(32, 128))
    rec = torch.zeros(3 * 16 * 128 // 2, dtype=torch.uint8)
    call = {
        "encode": lambda t: K.encode_quantize32_ycbcr420(t, LUMA, _chroma()),
        "decode": lambda t: K.decode_quantize32_ycbcr420(t, LUMA, _chroma(),
                                                         128, 32),
    }[fn]
    good = rec if fn == "decode" else planes
    with pytest.raises(TypeError):
        call(good.to(torch.int16))
    with pytest.raises(TypeError):
        call(good.numpy())
    with pytest.raises(ValueError):
        call(torch.empty(good.shape, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        call(good[1:] if fn == "decode" else good[:2])
    with pytest.raises(ValueError):
        call(good.view(2, -1).t() if fn == "decode"
             else good.transpose(-1, -2))
    if fn == "encode":
        with pytest.raises(ValueError):
            call(torch.from_numpy(_planes(48, 128)))
        with pytest.raises(ValueError):
            call(torch.from_numpy(_planes(32, 192)))


# -- the strip-tile encode's launch plan (enc420_rgb_kernel), pure Python ----

# the top views of chip_smoke.py's GEOMETRIES_420, and one macroblock row
PLAN_VIEWS_420 = [(2048, 3840), (544, 1920), (32, 384), (16, 128)]
TM = K.COLOR420_TILE_MACROBLOCKS


def _h100():
    """A card of 132 SMs holding 4 CTAs an SM."""
    return 4, 132


def _plan420(batch, h2, w, capacity=_h100, base=0, plane_stride=None):
    return K.color420_plan("enc420_rgb", batch, h2, w, base=base,
                           plane_stride=2 * h2 * w if plane_stride is None
                           else plane_stride, capacity=capacity)


@pytest.mark.parametrize("batch", [1, 64, 65535])
@pytest.mark.parametrize("h2,w", PLAN_VIEWS_420)
def test_color420_plan_covers_each_macroblock_once(h2, w, batch):
    mbw, rows, bw = w // 16, h2 // 16, w // 8
    plan = _plan420(batch, h2, w)
    assert plan.tile_macroblocks == TM == 8
    assert plan.tiles_per_row * TM == mbw and plan.tail_macroblocks == TM
    assert plan.tiles == batch * rows * plan.tiles_per_row
    assert 1 <= plan.grid == min(plan.tiles, 132 * plan.ctas_per_sm)
    assert plan.grid <= plan.tiles
    assert plan.smem == K.color420_smem() <= K.SMEM_LIMIT
    per_frame = rows * plan.tiles_per_row
    y_plane = h2 * w
    for f in sorted({0, 1, batch - 2, batch - 1} & set(range(batch))):
        # tile t as tile420_at in color420.cu numbers it
        t = np.arange(f * per_frame, (f + 1) * per_frame)
        fr, x = np.divmod(t, plan.tiles_per_row)
        frame, my = np.divmod(fr, rows)
        assert (frame == f).all()
        mbs = (my * mbw + TM * x)[:, None] + np.arange(TM)[None]
        np.testing.assert_array_equal(
            np.bincount(mbs.ravel(), minlength=rows * mbw),
            np.ones(rows * mbw))
        # the six 512-byte groups a tile stores: two of each Y block row,
        # one of Cb, one of Cr; none overlaps another, each lies in its
        # segment of the 1.5*h2*w-byte stream
        y = [((2 * my + r) * bw + 16 * x + 8 * g) * 64
             for r in (0, 1) for g in (0, 1)]
        c = [y_plane + k * (y_plane // 4) + (my * mbw + TM * x) * 64
             for k in (0, 1)]
        starts = np.sort(np.concatenate(y + c))
        assert (starts[1:] - starts[:-1] >= 512).all()
        assert all((s % 512 == 0).all() for s in y + c)
        assert all((s + 512 <= y_plane).all() for s in y)
        assert ((c[0] >= y_plane) & (c[0] + 512 <= 5 * y_plane // 4)).all()
        assert ((c[1] + 512 <= 3 * y_plane // 2)).all()
        assert len(starts) * 512 == 3 * y_plane // 2


@pytest.mark.parametrize("w", [128, 384, 1920, 3840])
def test_color420_plan_has_no_tails(w):
    plan = _plan420(1, 16, w)
    assert plan.tail_macroblocks == TM
    assert plan.tiles_per_row == w // 128


def test_color420_plan_shared_bytes_and_refusals():
    # scales, the input tiles, the record buffers (4 Y groups, Cb, Cr,
    # padded), the Y crossing, the pooled chroma, the chroma crossing
    assert K.color420_smem() == (
        2 * 256 + K.COLOR420_STAGES * 3 * 16 * 128
        + K.COLOR420_REC_BUFFERS * 6 * 528
        + 4 * (2 * 64 * 16 + 64 * 16 + 64 * 16)) <= K.SMEM_LIMIT
    with pytest.raises(ValueError):     # no CTA fits an SM
        _plan420(1, 16, 128, capacity=lambda: (0, 132))
    with pytest.raises(ValueError):     # 2^31 tiles or more
        _plan420(65535, 1 << 16, 1 << 14)
    for base, stride in [(8, 4096), (0, 4104)]:   # off 16 bytes
        with pytest.raises(ValueError):
            _plan420(1, 16, 128, base=base, plane_stride=stride)
    with pytest.raises(ValueError):
        _plan420(1, 24, 128)
    with pytest.raises(ValueError):
        K.color420_plan("dec420_rgb", 1, 16, 128, base=0, plane_stride=4096,
                        capacity=_h100)
    # a shard's rows: planes a whole image apart
    shard = _plan420(1, 64, 1920, plane_stride=4096 * 1920)
    assert shard.tiles == 4 * 15
    small = _plan420(1, 16, 128)
    assert small.tiles == small.grid == 1


# -- the strip-tile decode's launch plan (dec420_rgb_kernel), pure Python ----

def _dec_plan420(batch, h2, w, capacity=_h100, base=0, plane_stride=None):
    return K.color420_plan("dec420_rgb", batch, h2, w, base=base,
                           plane_stride=h2 * w if plane_stride is None
                           else plane_stride, capacity=capacity)


@pytest.mark.parametrize("batch", [1, 64, 65535])
@pytest.mark.parametrize("h2,w", PLAN_VIEWS_420)
def test_dec420_plan_covers_each_macroblock_once(h2, w, batch):
    mbw, rows, bw = w // 16, h2 // 16, w // 8
    plan = _dec_plan420(batch, h2, w)
    assert plan.tile_macroblocks == TM
    assert plan.tiles_per_row * TM == mbw and plan.tail_macroblocks == TM
    assert plan.tiles == batch * rows * plan.tiles_per_row < 1 << 31
    assert 1 <= plan.grid == min(plan.tiles, 132 * plan.ctas_per_sm)
    assert plan.grid <= plan.tiles
    assert plan.smem == K.color420_smem("dec420_rgb") <= K.SMEM_LIMIT
    per_frame = rows * plan.tiles_per_row
    y_plane = h2 * w
    for f in sorted({0, 1, batch - 2, batch - 1} & set(range(batch))):
        # tile t as tile420_at in color420.cu numbers it
        t = np.arange(f * per_frame, (f + 1) * per_frame)
        fr, x = np.divmod(t, plan.tiles_per_row)
        frame, my = np.divmod(fr, rows)
        assert (frame == f).all()
        # the six groups a tile loads (group420_at): the macroblocks of
        # their blocks, Y (two blocks across a macroblock) and chroma
        y_blocks = (16 * x[:, None, None] + 8 * np.arange(2)[None, :, None]
                    + np.arange(8)[None, None, :])
        mb_y = (my * mbw)[:, None] + (y_blocks // 2).reshape(len(t), -1)
        mb_c = (my * mbw + TM * x)[:, None] + np.arange(TM)[None]
        # the pixel box the tile stores: rows 16my .. +16, columns
        # 128x .. +128, of each plane
        mb_out = (my * mbw)[:, None] + (128 * x[:, None]
                                        + 16 * np.arange(TM)[None]) // 16
        for mb in (mb_y, mb_out):
            np.testing.assert_array_equal(np.unique(mb, axis=1)
                                          if mb.shape[1] > TM else mb, mb_c)
        np.testing.assert_array_equal(
            np.bincount(mb_c.ravel(), minlength=rows * mbw),
            np.ones(rows * mbw))
        # the groups' bytes: each group of the stream loaded once
        y = [((2 * my + r) * bw + 16 * x + 8 * g) * 64
             for r in (0, 1) for g in (0, 1)]
        c = [y_plane + k * (y_plane // 4) + (my * mbw + TM * x) * 64
             for k in (0, 1)]
        starts = np.concatenate(y + c)
        assert (starts % 512 == 0).all()
        np.testing.assert_array_equal(
            np.bincount(starts // 512, minlength=3 * y_plane // 1024),
            np.ones(3 * y_plane // 1024))


def test_dec420_plan_shared_bytes_and_refusals():
    # scales, the pixel tiles, the record buffers (4 Y groups, Cb, Cr,
    # padded), the Y and chroma crossings, the chroma values
    assert K.color420_smem("dec420_rgb") == (
        2 * 256 + K.COLOR420_DEC_OUT_BUFFERS * 3 * 16 * 128
        + K.COLOR420_DEC_STAGES * 6 * 528
        + 4 * (2 * 64 * 16 + 64 * 16 + 2 * 8 * 64)) <= K.SMEM_LIMIT
    with pytest.raises(ValueError):     # no CTA fits an SM
        _dec_plan420(1, 16, 128, capacity=lambda: (0, 132))
    with pytest.raises(ValueError):     # 2^31 tiles or more
        _dec_plan420(65535, 1 << 16, 1 << 14)
    with pytest.raises(ValueError):     # off 16 bytes
        _dec_plan420(1, 16, 128, base=8)
    with pytest.raises(ValueError):     # the output's planes are H2*W apart
        _dec_plan420(1, 16, 128, plane_stride=4096)
    for h2, w in [(24, 128), (16, 192)]:
        with pytest.raises(ValueError):
            _dec_plan420(1, h2, w)
    small = _dec_plan420(1, 16, 128)
    assert small.tiles == small.grid == 1
    assert _dec_plan420(64, 544, 1920).tiles == 64 * 34 * 15
