"""The port's plain YCbCr 4:4:4 colour path against the JAX package.

References: the JAX ``xla`` tier of ``kernels/color32.py``
(``encode_ycbcr_xla`` / ``decode_ycbcr_xla``, and the JAX api with
``backend="xla"``) and the Pallas kernels in interpret mode at f32 (at
64x128 and 64x192, about 0.3-1.3 s a call here, so one module-scoped
fixture makes them all).  Inputs are made with numpy from a seed; the luma
LUT is the CLI's table at quality 100, the chroma LUT
``BASE_CHROMA_QUANT_TABLE`` at quality 100 or a seeded random table, both
255x hotter (mode32's raw domain).  Tolerances:
  * encode records and decoded pixels: at most +-1, on at most 0.2% of
    bytes -- the ``compare_backends`` contract;
  * the constants, shapes, batch == frames and the streams carried by
    ``convert``: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu.kernels import color32 as JC
from simd_dct_tpu.layout import color as J_color
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import convert
from simd_dct_tpu_torch.kernels import cuda_dct as K
from simd_dct_tpu_torch.kernels import torch_path as TP
from simd_dct_tpu_torch.layout import color as T_color
from simd_dct_tpu_torch.utils.debug import compare_backends

ROUNDINGS = ("rne", "scalar", "clamp_first")
CPU = {"device": "cpu"}
LUMA = T.default_quant_lut(100) * np.float32(255.0)


def _chroma(kind="jpeg"):
    if kind == "jpeg":
        return T_color.BASE_CHROMA_QUANT_TABLE * np.float32(100 * 255)
    return np.random.default_rng(23).uniform(1000.0, 9000.0,
                                             64).astype(np.float32)


def _planes(h, w, seed=0, frames=None):
    shape = (3, h, w) if frames is None else (frames, 3, h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _assert_contract(outs):
    report = compare_backends(outs)
    bad = {k: v for k, v in report.items() if not v["ok"]}
    assert not bad, bad


def _port_enc(planes, chroma, rounding="rne"):
    return TP.encode_ycbcr32(torch.from_numpy(planes), LUMA, chroma,
                             rounding).numpy()


def _xla_enc(planes, chroma, rounding="rne"):
    h = planes.shape[-2]
    return np.array(JC.encode_ycbcr_xla(
        jnp.asarray(planes[:, : h // 2]), LUMA, chroma,
        rounding=rounding)).reshape(3, -1)


# -- constants and plane helpers ---------------------------------------------

def test_constants_bit_identical_to_jax():
    for port, jax_ in [(T_color.RGB2YCC, J_color._RGB2YCC),
                       (T_color.YCC2RGB, J_color._YCC2RGB),
                       (T_color.BASE_CHROMA_QUANT_TABLE,
                        J_color.BASE_CHROMA_QUANT_TABLE),
                       (T_color.YCC_BIAS,
                        np.asarray(JC._YCC_BIAS, np.float32))]:
        assert port.dtype == np.float32 and port.shape == jax_.shape
        assert port.tobytes() == np.asarray(jax_, np.float32).tobytes()
    # the inverse's "zero" entries are not zero
    assert T_color.YCC2RGB[0, 1] != 0 and T_color.YCC2RGB[2, 2] != 0
    assert K._COLOR_MIX.tobytes() == np.concatenate(
        [J_color._RGB2YCC.ravel(), J_color._YCC2RGB.ravel(),
         np.float32([0, 128, 128])]).astype(np.float32).tobytes()


def test_plane_helpers_match_jax():
    rgb = np.random.default_rng(1).integers(0, 256, (2, 16, 24, 3), np.uint8)
    t = torch.from_numpy(rgb)
    planes = T_color.rgb_to_planar(t)
    np.testing.assert_array_equal(
        planes.numpy(), np.asarray(J_color.rgb_to_planar(jnp.asarray(rgb))))
    np.testing.assert_array_equal(T_color.planar_to_rgb(planes).numpy(), rgb)
    ycc = T_color.rgb_to_ycbcr(t)
    want = np.asarray(J_color.rgb_to_ycbcr(jnp.asarray(rgb)))
    assert ycc.dtype == torch.float32 and ycc.shape == want.shape
    np.testing.assert_allclose(ycc.numpy(), want, rtol=0, atol=1e-4)
    _assert_contract({
        "port": T_color.ycbcr_to_rgb(ycc),
        "jax": np.asarray(J_color.ycbcr_to_rgb(jnp.asarray(want)))})


def test_mix_planes_sums_left_to_right_in_f32():
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        0, 255, (3, 8, 8)).astype(np.float32))
    got = T_color.mix_planes(x, T_color.RGB2YCC, T_color.YCC_BIAS)
    m, b = T_color.RGB2YCC, T_color.YCC_BIAS
    xs = x.numpy()
    for i in range(3):
        want = (((xs[0] * m[i, 0]) + (xs[1] * m[i, 1])) + (xs[2] * m[i, 2])
                + b[i])
        assert got[i].numpy().tobytes() == want.astype(np.float32).tobytes()


# -- encode / decode / round trip against xla and Pallas interpret ----------

ENCODE_CASES = [(h, w, kind, r) for (h, w, kind) in
                [(64, 128, "jpeg"), (64, 192, "random")] for r in ROUNDINGS]


@pytest.mark.parametrize("h,w,kind,rounding", ENCODE_CASES)
def test_encode_matches_xla(h, w, kind, rounding):
    planes, chroma = _planes(h, w, seed=h + w), _chroma(kind)
    port = _port_enc(planes, chroma, rounding)
    assert port.shape == (3, (h // 2) * w) and port.dtype == np.uint8
    _assert_contract({"port": port,
                      "xla": _xla_enc(planes, chroma, rounding)})


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_batched_encode_matches_xla(rounding):
    frames, chroma = _planes(64, 128, seed=3, frames=2), _chroma("random")
    port = TP.encode_ycbcr32(torch.from_numpy(frames), LUMA, chroma,
                             rounding).numpy()
    assert port.shape == (2, 3, 32 * 128)
    for i in range(2):
        _assert_contract({"port": port[i],
                          "xla": _xla_enc(frames[i], chroma, rounding)})


@pytest.fixture(scope="module")
def pallas_color():
    """The Pallas colour kernels in interpret mode at f32: encodes at 64x128
    and 64x192, and the decode and fused round trip at 64x128."""
    out = {}
    for w, kind in [(128, "jpeg"), (192, "random")]:
        planes, chroma = _planes(64, w, seed=w), _chroma(kind)
        out["enc", w] = np.asarray(JC.encode_quantize32_ycbcr(
            jnp.asarray(planes), LUMA, chroma, interpret=True,
            precision="f32"))
    planes, chroma = _planes(64, 128, seed=128), _chroma("jpeg")
    rec = _xla_enc(planes, chroma)
    out["dec"] = np.asarray(JC.decode_quantize32_ycbcr(
        jnp.asarray(rec), LUMA, chroma, 128, 64, interpret=True,
        precision="f32"))
    out["rt"] = np.asarray(JC.roundtrip_quantize32_ycbcr(
        jnp.asarray(planes), LUMA, chroma, interpret=True, precision="f32"))
    return out


@pytest.mark.parametrize("w,kind", [(128, "jpeg"), (192, "random")])
def test_encode_matches_pallas_interpret(pallas_color, w, kind):
    planes, chroma = _planes(64, w, seed=w), _chroma(kind)
    port = _port_enc(planes, chroma)
    assert port.shape == pallas_color["enc", w].shape
    _assert_contract({"port": port, "pallas": pallas_color["enc", w],
                      "xla": _xla_enc(planes, chroma)})


def test_decode_and_roundtrip_match_pallas_interpret(pallas_color):
    planes, chroma = _planes(64, 128, seed=128), _chroma("jpeg")
    rec = _xla_enc(planes, chroma)
    _assert_contract({
        "port": TP.decode_ycbcr32(torch.from_numpy(rec), LUMA, chroma, 128,
                                  64),
        "pallas": pallas_color["dec"]})
    _assert_contract({
        "port": TP.roundtrip_ycbcr32(torch.from_numpy(planes), LUMA, chroma),
        "pallas": pallas_color["rt"]})


@pytest.mark.parametrize("h,w,kind", [(64, 128, "jpeg"), (64, 192, "random"),
                                      (32, 256, "jpeg")])
def test_decode_same_records_matches_xla(h, w, kind):
    planes, chroma = _planes(h, w, seed=5 + w), _chroma(kind)
    rec = _xla_enc(planes, chroma)
    port = TP.decode_ycbcr32(torch.from_numpy(rec), LUMA, chroma, w, h)
    assert port.shape == (3, h // 2, w) and port.dtype == torch.uint8
    _assert_contract({
        "port": port,
        "xla": JC.decode_ycbcr_xla(jnp.asarray(rec.reshape(3, h // 16, 8 * w)),
                                   LUMA, chroma)})


@pytest.mark.parametrize("frames", [None, 2])
def test_api_roundtrip_matches_jax_xla(frames):
    planes, chroma = _planes(64, 128, seed=7, frames=frames), _chroma()
    port = T.roundtrip_quantize32_ycbcr(planes, LUMA, chroma, **CPU)
    want = np.asarray(J.api.roundtrip_quantize32_ycbcr(planes, LUMA, chroma,
                                                       backend="xla"))
    assert tuple(port.shape) == want.shape
    _assert_contract({"port": port, "jax": want})
    # the round trip is the composition of the port's encode and decode
    rec = T.encode_quantize32_ycbcr(planes, LUMA, chroma, **CPU)
    np.testing.assert_array_equal(
        T.decode_quantize32_ycbcr(rec, LUMA, chroma, 128, 64).numpy(),
        port.numpy())


def test_smooth_roundtrip_psnr_equals_jax():
    """The config-3 gate's inputs (simd_dct_tpu/bench/harness.py:151-156):
    three correlated channels of one smooth field."""
    yy, xx = np.mgrid[0:64, 0:256]
    base = (128 + 45 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
            + 30 * (xx / 255.0)).astype(np.float32)
    top = np.clip(np.stack([base, base * 0.9 + 12, base * 0.8 + 25]), 0,
                  255).astype(np.uint8)
    planes = np.concatenate([top, np.zeros_like(top)], axis=1)
    chroma = _chroma()
    port = T.roundtrip_quantize32_ycbcr(planes, LUMA, chroma, **CPU).numpy()
    want = np.asarray(J.api.roundtrip_quantize32_ycbcr(planes, LUMA, chroma,
                                                       backend="xla"))

    def psnr(x):
        mse = ((x.astype(np.float64) - top) ** 2).mean()
        return 10 * np.log10(255.0 ** 2 / mse)

    assert psnr(port) > 30.0
    assert abs(psnr(port) - psnr(want)) < 0.1


# -- batches, streams across packages --------------------------------------

def test_batch_equals_frames():
    frames, chroma = _planes(32, 128, seed=9, frames=3), _chroma("random")
    rec = T.encode_quantize32_ycbcr(frames, LUMA, chroma, **CPU)
    dec = T.decode_quantize32_ycbcr(rec, LUMA, chroma, 128, 32, **CPU)
    rt = T.roundtrip_quantize32_ycbcr(frames, LUMA, chroma, **CPU)
    assert rec.shape == (3, 3, 16 * 128) and dec.shape == rt.shape \
        == (3, 3, 16, 128)
    for i in range(3):
        one = T.encode_quantize32_ycbcr(frames[i], LUMA, chroma, **CPU)
        np.testing.assert_array_equal(rec[i].numpy(), one.numpy())
        np.testing.assert_array_equal(
            dec[i].numpy(),
            T.decode_quantize32_ycbcr(one, LUMA, chroma, 128, 32).numpy())
        np.testing.assert_array_equal(
            rt[i].numpy(),
            T.roundtrip_quantize32_ycbcr(frames[i], LUMA, chroma,
                                         **CPU).numpy())


def test_batch_of_one_keeps_its_axis():
    one = _planes(32, 128, seed=10, frames=1)
    chroma = _chroma()
    rec = T.encode_quantize32_ycbcr(one, LUMA, chroma, **CPU)
    assert rec.shape == (1, 3, 16 * 128)
    assert T.decode_quantize32_ycbcr(rec, LUMA, chroma, 128, 32).shape \
        == (1, 3, 16, 128)
    assert T.roundtrip_quantize32_ycbcr(one, LUMA, chroma, **CPU).shape \
        == (1, 3, 16, 128)
    # a flat stream of one frame, or (3, n), decodes unbatched
    for data in (rec.reshape(-1), rec[0]):
        assert T.decode_quantize32_ycbcr(data, LUMA, chroma, 128, 32).shape \
            == (3, 16, 128)
    # two frames in a flat stream decode batched, as in the JAX api
    two = torch.cat([rec.reshape(-1)] * 2)
    assert T.decode_quantize32_ycbcr(two, LUMA, chroma, 128, 32).shape \
        == (2, 3, 16, 128)


@pytest.mark.parametrize("frames", [None, 2])
def test_streams_cross_between_packages(frames):
    """A colour stream written by either package goes through ``convert``
    unchanged and decodes in the other."""
    planes, chroma = _planes(64, 192, seed=11, frames=frames), _chroma()
    jax_rec = np.asarray(J.api.encode_quantize32_ycbcr(planes, LUMA, chroma,
                                                       backend="xla"))
    t = convert.color_records_from_numpy(jax_rec, 192, 64, **CPU)
    assert tuple(t.shape) == jax_rec.shape
    np.testing.assert_array_equal(convert.records_to_numpy(t), jax_rec)
    _assert_contract({
        "port(jax records)": T.decode_quantize32_ycbcr(t, LUMA, chroma, 192,
                                                       64),
        "jax(jax records)": J.api.decode_quantize32_ycbcr(
            jax_rec, LUMA, chroma, 192, 64, backend="xla")})
    port_rec = convert.records_to_numpy(
        T.encode_quantize32_ycbcr(planes, LUMA, chroma, **CPU))
    _assert_contract({"port records": port_rec, "jax records": jax_rec})
    _assert_contract({
        "jax(port records)": J.api.decode_quantize32_ycbcr(
            port_rec, LUMA, chroma, 192, 64, backend="xla"),
        "port(port records)": T.decode_quantize32_ycbcr(
            port_rec, LUMA, chroma, 192, 64, **CPU)})


def test_color_records_from_numpy_checks():
    flat = np.zeros(3 * 16 * 128, np.uint8)
    assert convert.color_records_from_numpy(flat, 128, 32, **CPU).shape \
        == (3, 16 * 128)
    assert convert.color_records_from_numpy(flat[None, None], 128, 32,
                                            **CPU).shape == (1, 3, 16 * 128)
    assert convert.color_records_from_numpy(np.tile(flat, 2), 128, 32,
                                            **CPU).shape == (2, 3, 16 * 128)
    for bad in (flat[1:], flat.astype(np.int16), flat[:0]):
        with pytest.raises(ValueError):
            convert.color_records_from_numpy(bad, 128, 32, **CPU)


# -- api contract: typed errors as the JAX api, device rule ------------------

LUT_NAN = np.where(np.arange(64) == 9, np.nan, LUMA).astype(np.float32)
LUT_ZERO = np.where(np.arange(64) == 3, 0, LUMA).astype(np.float32)

BAD_CALLS = {
    "encode_gray": lambda m: m.encode_quantize32_ycbcr(
        _planes(32, 128)[0], LUMA, _chroma()),
    "encode_four_planes": lambda m: m.encode_quantize32_ycbcr(
        np.zeros((4, 32, 128), np.uint8), LUMA, _chroma()),
    "encode_w64": lambda m: m.encode_quantize32_ycbcr(
        _planes(32, 96), LUMA, _chroma()),
    "encode_h16": lambda m: m.encode_quantize32_ycbcr(
        _planes(40, 128), LUMA, _chroma()),
    "encode_h8": lambda m: m.encode_quantize32_ycbcr(
        _planes(36, 128), LUMA, _chroma()),
    "encode_dtype": lambda m: m.encode_quantize32_ycbcr(
        _planes(32, 128).astype(np.int16), LUMA, _chroma()),
    "encode_rounding": lambda m: m.encode_quantize32_ycbcr(
        _planes(32, 128), LUMA, _chroma(), rounding="up"),
    "encode_luma_63": lambda m: m.encode_quantize32_ycbcr(
        _planes(32, 128), LUMA[:63], _chroma()),
    "encode_chroma_nan": lambda m: m.encode_quantize32_ycbcr(
        _planes(32, 128), LUMA, LUT_NAN),
    "encode_luma_zero": lambda m: m.encode_quantize32_ycbcr(
        _planes(32, 128), LUT_ZERO, _chroma()),
    "roundtrip_w64": lambda m: m.roundtrip_quantize32_ycbcr(
        _planes(32, 96), LUMA, _chroma()),
    "roundtrip_chroma_zero": lambda m: m.roundtrip_quantize32_ycbcr(
        _planes(32, 128), LUMA, LUT_ZERO),
    "roundtrip_batch_gray": lambda m: m.roundtrip_quantize32_ycbcr(
        np.zeros((2, 32, 128), np.uint8), LUMA, _chroma()),
    "decode_length": lambda m: m.decode_quantize32_ycbcr(
        np.zeros(17, np.uint8), LUMA, _chroma(), 128, 32),
    "decode_empty": lambda m: m.decode_quantize32_ycbcr(
        np.zeros(0, np.uint8), LUMA, _chroma(), 128, 32),
    "decode_dtype": lambda m: m.decode_quantize32_ycbcr(
        np.zeros(3 * 16 * 128, np.int16), LUMA, _chroma(), 128, 32),
    "decode_x0": lambda m: m.decode_quantize32_ycbcr(
        np.zeros(10, np.uint8), LUMA, _chroma(), 0, 64),
    "decode_y0": lambda m: m.decode_quantize32_ycbcr(
        np.zeros(10, np.uint8), LUMA, _chroma(), 128, 0),
    "decode_h16": lambda m: m.decode_quantize32_ycbcr(
        np.zeros(10, np.uint8), LUMA, _chroma(), 128, 8),
    "decode_w64": lambda m: m.decode_quantize32_ycbcr(
        np.zeros(10, np.uint8), LUMA, _chroma(), 100, 64),
    "decode_lut_5": lambda m: m.decode_quantize32_ycbcr(
        np.zeros(3 * 16 * 128, np.uint8), LUMA, _chroma()[:5], 128, 32),
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
    rec = np.zeros(3 * 16 * 128, np.uint8)
    calls = {
        "encode": lambda **kw: T.encode_quantize32_ycbcr(
            _planes(32, 128), LUMA, _chroma(), **kw),
        "decode": lambda **kw: T.decode_quantize32_ycbcr(
            rec, LUMA, _chroma(), 128, 32, **kw),
        "roundtrip": lambda **kw: T.roundtrip_quantize32_ycbcr(
            _planes(32, 128), LUMA, _chroma(), **kw),
        "convert": lambda **kw: convert.color_records_from_numpy(
            rec, 128, 32, **kw),
    }
    for name, call in calls.items():
        with pytest.raises(T.NotSupportedError, match='device="cpu"'):
            call()
        assert call(device="cpu").device.type == "cpu", name
    with pytest.raises(T.NotSupportedError):
        T.roundtrip_quantize32_ycbcr(torch.from_numpy(_planes(32, 128)),
                                     LUMA, _chroma(), backend="cuda")


# -- the wrappers on CPU tensors ---------------------------------------------

def test_wrappers_on_cpu_take_the_plain_version():
    planes = torch.from_numpy(_planes(48, 192, seed=14, frames=2))
    before = dict(K.LAUNCHES)
    rec = K.encode_quantize32_ycbcr(planes, LUMA, _chroma(), "scalar")
    np.testing.assert_array_equal(
        rec.numpy(),
        TP.encode_ycbcr32(planes, LUMA, _chroma(), "scalar").numpy())
    dec = K.decode_quantize32_ycbcr(rec, LUMA, _chroma(), 192, 48)
    assert dec.shape == (2, 3, 24, 192)
    np.testing.assert_array_equal(
        K.roundtrip_quantize32_ycbcr(planes, LUMA, _chroma()).numpy(),
        TP.roundtrip_ycbcr32(planes, LUMA, _chroma()).numpy())
    assert K.LAUNCHES == before
    assert K.supports_mode("enc_quant32_ycbcr", 48, 192)
    assert not K.supports_mode("roundtrip32_ycbcr", 48, 200)
    assert not K.supports_mode("dec_quant32_ycbcr", 40, 192)


@pytest.mark.parametrize("fn", ["encode", "decode", "roundtrip"])
def test_wrappers_reject_bad_tensors(fn):
    planes = torch.from_numpy(_planes(32, 128))
    rec = torch.zeros(3, 16 * 128, dtype=torch.uint8)
    call = {
        "encode": lambda t: K.encode_quantize32_ycbcr(t, LUMA, _chroma()),
        "decode": lambda t: K.decode_quantize32_ycbcr(t, LUMA, _chroma(),
                                                      128, 32),
        "roundtrip": lambda t: K.roundtrip_quantize32_ycbcr(t, LUMA,
                                                            _chroma()),
    }[fn]
    good = rec if fn == "decode" else planes
    with pytest.raises(TypeError):
        call(good.to(torch.int16))
    with pytest.raises(TypeError):
        call(good.numpy())
    with pytest.raises(ValueError):
        call(torch.empty(good.shape, dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):
        call(good[:2] if fn != "decode" else good[..., 1:].contiguous())
    with pytest.raises(ValueError):
        call(good.transpose(-1, -2))
    with pytest.raises(ValueError):
        call(good[0])
    if fn != "decode":
        with pytest.raises(ValueError):
            call(torch.from_numpy(_planes(32, 96)))


# -- the tile kernels' launch plan (csrc/color32.cu), pure Python ------------

PLAN_VIEWS = [(2048, 3840), (544, 1920), (128, 192), (136, 64), (8, 1984)]
KINDS = ("enc32_rgb", "roundtrip32_rgb")
TB = K.COLOR_TILE_BLOCKS


def _h100(variant):
    """A card of 132 SMs holding 4 CTAs of any launch an SM."""
    return 4, 132


def _tile_at(plan, h2, t):
    """(frame, strip, first block, blocks) of tile ``t`` (an int or an
    integer array), numbered as ``tile_at`` in color32.cu numbers them."""
    fs, x = divmod(t, plan.tiles_per_strip)
    frame, strip = divmod(fs, h2 // 8)
    last = x == plan.tiles_per_strip - 1
    nb = np.where(last, plan.tail_blocks, plan.tile_blocks)
    return frame, strip, x * plan.tile_blocks, nb


def _frames_to_check(batch):
    return sorted({0, 1, batch - 2, batch - 1} & set(range(batch)))


@pytest.mark.parametrize("batch", [1, 64, 65535])
@pytest.mark.parametrize("h2,w", PLAN_VIEWS)
def test_color_plan_covers_each_block_once_in_strip_tiles(h2, w, batch):
    bw, strips = w // 8, h2 // 8
    for kind in KINDS:
        plan = K.color_plan(kind, batch, h2, w, base=0, plane_stride=2 * h2 * w,
                            capacity=_h100)
        assert plan.variant == "tensor" and plan.tile_blocks == TB
        assert plan.tiles == batch * strips * plan.tiles_per_strip
        assert 1 <= plan.grid == min(plan.tiles, 132 * plan.ctas_per_sm)
        assert plan.smem == K.color_smem(kind) <= K.SMEM_LIMIT
        # every tile goes to one CTA: CTA c takes c, c + grid, ...
        ctas = np.arange(plan.grid)
        assert ((plan.tiles - ctas + plan.grid - 1) // plan.grid).sum() \
            == plan.tiles
        per_frame = strips * plan.tiles_per_strip
        for f in _frames_to_check(batch):
            t = np.arange(f * per_frame, (f + 1) * per_frame)
            frame, strip, bx0, nb = _tile_at(plan, h2, t)
            assert (frame == f).all()
            # inside one strip, whole record groups
            assert ((nb > 0) & (nb <= TB) & (nb % 8 == 0)).all()
            assert (bx0 + nb <= bw).all()
            # each block of the frame in exactly one tile
            first = strip * bw + bx0
            blocks = (first[:, None] + np.arange(TB)[None])[
                np.arange(TB)[None] < nb[:, None]]
            np.testing.assert_array_equal(
                np.bincount(blocks, minlength=strips * bw),
                np.ones(strips * bw))
            # a channel's record spans, 64 bytes a block, never overlap
            order = np.argsort(first)
            start, end = first[order] * 64, (first + nb)[order] * 64
            assert (end[:-1] <= start[1:]).all()
        last = _tile_at(plan, h2, np.array([plan.tiles - 1]))
        assert [int(v[0]) for v in last] == [
            batch - 1, strips - 1, (plan.tiles_per_strip - 1) * TB,
            plan.tail_blocks]


def test_color_plan_tails():
    assert TB == 16
    for w, tps, tail in [(3840, 30, 16), (1920, 15, 16), (192, 2, 8),
                         (64, 1, 8), (1984, 16, 8)]:
        plan = K.color_plan("enc32_rgb", 1, 8, w, base=0, plane_stride=8 * w,
                            capacity=_h100)
        assert (plan.tiles_per_strip, plan.tail_blocks) == (tps, tail)


@pytest.mark.parametrize("kind", KINDS)
def test_color_plan_shared_bytes_and_refusals(kind):
    # scales, one input tile, two output tiles, the crossing buffer
    out = 24 * 8 * TB if kind == "roundtrip32_rgb" else 3 * (TB // 8) * 528
    assert K.color_smem(kind) == (
        (4 if kind == "roundtrip32_rgb" else 2) * 256 + 24 * 8 * TB + 2 * out
        + 3 * 64 * TB * 4) <= K.SMEM_LIMIT
    with pytest.raises(ValueError):
        K.color_plan(kind, 1, 8, 64, base=0, plane_stride=1024,
                     capacity=lambda v: (0, 132))
    with pytest.raises(ValueError):
        K.color_plan(kind, 65535, 65536, 1 << 14, base=0, plane_stride=0,
                     capacity=_h100)
    with pytest.raises(ValueError):
        K.color_plan("enc32", 1, 8, 64, base=0, plane_stride=1024,
                     capacity=_h100)


@pytest.mark.parametrize("base,stride", [(8, 1024), (0, 1032), (24, 4104),
                                         (16, 1040)])
def test_color_plan_misaligned_input_takes_plain_loads(base, stride):
    plan = K.color_plan("enc32_rgb", 2, 128, 192, base=base,
                        plane_stride=stride, capacity=_h100)
    want = "tensor" if (base | stride) % 16 == 0 else "plain"
    assert plan.variant == K.color_variant(base, stride) == want
    if want == "plain":
        # the round trip's wrapper takes only whole, aligned tensors
        with pytest.raises(ValueError):
            K.color_plan("roundtrip32_rgb", 2, 128, 192, base=base,
                         plane_stride=stride, capacity=_h100)


def test_color_plan_never_exceeds_the_tiles():
    small = K.color_plan("roundtrip32_rgb", 1, 8, 64, base=0, plane_stride=512,
                         capacity=_h100)
    assert small.tiles == small.grid == 1
    one_sm = K.color_plan("enc32_rgb", 64, 544, 1920, base=0,
                          plane_stride=1088 * 1920,
                          capacity=lambda v: (2, 1))
    assert (one_sm.ctas_per_sm, one_sm.grid) == (2, 2)


# -- the strip-tile decode's launch plan (dec32_rgb_kernel), pure Python -----

def _dec_plan(batch, h2, w, capacity=_h100, base=0):
    return K.color_plan("dec32_rgb", batch, h2, w, base=base,
                        plane_stride=h2 * w, capacity=capacity)


@pytest.mark.parametrize("batch", [1, 64, 65535])
@pytest.mark.parametrize("h2,w", PLAN_VIEWS)
def test_dec32_rgb_plan_covers_each_block_once_in_strip_tiles(h2, w, batch):
    bw, strips = w // 8, h2 // 8
    plan = _dec_plan(batch, h2, w)
    assert plan.variant == "tensor" and plan.tile_blocks == TB
    assert plan.tiles == batch * strips * plan.tiles_per_strip
    assert 1 <= plan.grid == min(plan.tiles, 132 * plan.ctas_per_sm)
    assert plan.grid <= plan.tiles
    assert plan.smem == K.color_smem("dec32_rgb") <= K.SMEM_LIMIT
    per_frame = strips * plan.tiles_per_strip
    for f in _frames_to_check(batch):
        t = np.arange(f * per_frame, (f + 1) * per_frame)
        frame, strip, bx0, nb = _tile_at(plan, h2, t)
        assert (frame == f).all()
        # a tile's records are whole 512-byte groups of one strip
        assert ((nb > 0) & (nb <= TB) & (nb % 8 == 0)).all()
        assert (bx0 + nb <= bw).all()
        first = strip * bw + bx0
        blocks = (first[:, None] + np.arange(TB)[None])[
            np.arange(TB)[None] < nb[:, None]]
        np.testing.assert_array_equal(
            np.bincount(blocks, minlength=strips * bw), np.ones(strips * bw))
        # a channel's record spans, read 512 bytes at a time, never overlap
        # and stay inside the channel's h2*w bytes
        order = np.argsort(first)
        start, end = first[order] * 64, (first + nb)[order] * 64
        assert (end[:-1] <= start[1:]).all() and end[-1] <= h2 * w
        assert ((end - start) % 512 == 0).all()


def test_dec32_rgb_plan_tails():
    for w, tps, tail in [(3840, 30, 16), (1920, 15, 16), (192, 2, 8),
                         (64, 1, 8), (1984, 16, 8)]:
        plan = _dec_plan(1, 8, w)
        assert (plan.tiles_per_strip, plan.tail_blocks) == (tps, tail)


def test_dec32_rgb_plan_shared_bytes_and_refusals():
    # scales, the pixel tiles, the record buffers, the crossing buffer
    assert K.color_smem("dec32_rgb") == (
        2 * 256 + K.COLOR_DEC_OUT_BUFFERS * 24 * 8 * TB
        + K.COLOR_DEC_STAGES * 3 * (TB // 8) * 528
        + 3 * 64 * TB * 4) <= K.SMEM_LIMIT
    with pytest.raises(ValueError):     # no CTA fits an SM
        _dec_plan(1, 8, 64, capacity=lambda v: (0, 132))
    with pytest.raises(ValueError):     # 2^31 tiles or more
        _dec_plan(65535, 65536, 1 << 14)
    with pytest.raises(ValueError):     # records 8 bytes off 16
        _dec_plan(1, 8, 64, base=8)
    small = _dec_plan(1, 8, 64)
    assert small.tiles == small.grid == 1
