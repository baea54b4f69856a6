"""The port's NumPy golden tier against the JAX package's, on the CPU.

``simd_dct_tpu_torch.core.golden`` and ``core.butterfly`` are the port's
own copies of ``simd_dct_tpu.core.golden`` / ``core.butterfly``: they must
give the same bytes for every function, rounding, layout, strip range,
``legacy_range`` and ``compat``.  The api's ``backend="numpy"`` routes
(and the cap ``set_max_backend("numpy")``, ``--max-simd none``) must give
the JAX api's ``backend="numpy"`` bytes, and the colour entry points must
refuse the tier as the JAX package's do.  Images are made with numpy from
a seed at 32x128 (the golden loops block by block; a 32x128 call takes
milliseconds).  Tolerance: exact everywhere -- the same NumPy code on the
same inputs.
"""

import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu import cli as JCLI
from simd_dct_tpu.core import butterfly as JB
from simd_dct_tpu.core import golden as JG
from simd_dct_tpu.dispatch import set_max_backend as j_set_max_backend
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import cli
from simd_dct_tpu_torch.core import butterfly as TB
from simd_dct_tpu_torch.core import golden as TG
from simd_dct_tpu_torch.dispatch import capability as C

H, W = 32, 128
LUT = T.default_quant_lut(50)
LUT32 = LUT * np.float32(255.0)
ROUNDINGS = ("rne", "scalar", "clamp_first")


def _img(h=H, w=W, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("legacy_range", [False, True, None])
@pytest.mark.parametrize("layout", ["scalar", "pair", "pair_as_written"])
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_encode_quantize_golden_is_the_jax_golden(rounding, layout,
                                                   legacy_range, compat):
    img = _img()
    kw = dict(rounding=rounding, layout=layout, legacy_range=legacy_range,
              compat=compat)
    for start, end in ((0, None), (8, 23)):
        np.testing.assert_array_equal(
            TG.encode_quantize_golden(img, LUT, start, end, **kw),
            JG.encode_quantize_golden(img, LUT, start, end, **kw))


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("mode", ["mode32", "stereo"])
def test_mode32_and_stereo_golden_are_the_jax_golden(mode, rounding, compat):
    img = _img(seed=1)
    name = ("encode_quantize32_golden" if mode == "mode32"
            else "encode_quantize_stereo_golden")
    lut = LUT32 if mode == "mode32" else LUT
    for start, end in ((0, None), (16, 16)):
        np.testing.assert_array_equal(
            getattr(TG, name)(img, lut, start, end, rounding=rounding,
                              compat=compat),
            getattr(JG, name)(img, lut, start, end, rounding=rounding,
                              compat=compat))


@pytest.mark.parametrize("name, lut, kw", [
    ("decode_quantize_golden", LUT, {"layout": "scalar"}),
    ("decode_quantize_golden", LUT, {"layout": "pair"}),
    ("decode_quantize32_golden", LUT32, {}),
    ("decode_quantize_stereo_golden", LUT, {}),
])
def test_decode_golden_is_the_jax_golden(name, lut, kw):
    n = H * W if "stereo" in name else H // 2 * W
    data = np.random.default_rng(2).integers(0, 256, n, np.uint8)
    np.testing.assert_array_equal(getattr(TG, name)(data, lut, W, H, **kw),
                                  getattr(JG, name)(data, lut, W, H, **kw))


def test_spill_geometry_and_pair_permutation_are_the_jax_golden():
    img = _img(40, W, seed=3)           # H % 16 == 8: the spill strip
    for name in ("encode_quantize_golden", "encode_quantize32_golden"):
        lut = LUT32 if "32" in name else LUT
        np.testing.assert_array_equal(getattr(TG, name)(img, lut),
                                      getattr(JG, name)(img, lut))
    for as_written in (False, True):
        np.testing.assert_array_equal(TG.pair_cell_permutation(as_written),
                                      JG.pair_cell_permutation(as_written))
    with pytest.raises(ValueError):
        TG.encode_quantize_stereo_golden(img, LUT)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_butterfly_is_the_jax_butterfly(rounding):
    rng = np.random.default_rng(4)
    blocks = (rng.integers(0, 256, (64, 8, 8)).astype(np.float32)
              * np.float32(1 / 255))
    for name in ("dct8_butterfly", "dct2d_fx_major", "dct2d_fy_major"):
        np.testing.assert_array_equal(getattr(TB, name)(blocks),
                                      getattr(JB, name)(blocks))
    buf = TB.dct2d_fy_major(blocks).reshape(-1, 64)
    np.testing.assert_array_equal(TB.quantize_exact(buf, LUT, rounding),
                                  JB.quantize_exact(buf, LUT, rounding))


# -- the api's numpy tier against the JAX api's ------------------------------

def _stereo_records(view_layout):
    return np.asarray(J.encode_quantize_stereo(_img(seed=5), LUT,
                                               backend="numpy",
                                               view_layout=view_layout))


API_CASES = {
    "encode_quantize": lambda m, **kw: m.encode_quantize(
        _img(), LUT, **kw),
    "encode_quantize pair range": lambda m, **kw: m.encode_quantize(
        _img(), LUT, 8, 23, layout="pair_as_written", rounding="scalar",
        **kw),
    "encode_quantize legacy_range compat": lambda m, **kw:
        m.encode_quantize(_img(), LUT, 8, 23, legacy_range=True,
                          compat=True, **kw),
    "encode_quantize batch": lambda m, **kw: m.encode_quantize(
        np.stack([_img(), _img(seed=9)]), LUT, **kw),
    "encode_quantize spill": lambda m, **kw: m.encode_quantize(
        _img(40, W), LUT, spill=True, **kw),
    "decode_quantize": lambda m, **kw: m.decode_quantize(
        np.asarray(J.encode_quantize(_img(), LUT, backend="numpy")), LUT, W,
        H, **kw),
    "decode_quantize pair compat": lambda m, **kw: m.decode_quantize(
        np.asarray(J.encode_quantize(_img(), LUT, layout="pair",
                                     backend="numpy")), LUT, W, H,
        layout="pair", compat=True, **kw),
    "encode_quantize32": lambda m, **kw: m.encode_quantize32(
        _img(), LUT32, **kw),
    "encode_quantize32 range compat": lambda m, **kw: m.encode_quantize32(
        _img(), LUT32, 16, None, rounding="clamp_first", compat=True, **kw),
    "decode_quantize32 batch": lambda m, **kw: m.decode_quantize32(
        np.stack([np.asarray(J.encode_quantize32(_img(seed=s), LUT32,
                                                 backend="numpy"))
                  for s in (0, 1)]), LUT32, W, H, **kw),
    "decode_quantize32 compat": lambda m, **kw: m.decode_quantize32(
        np.asarray(J.encode_quantize32(_img(), LUT32, backend="numpy")),
        LUT32, W, H, compat=True, **kw),
    "roundtrip_quantize32": lambda m, **kw: m.roundtrip_quantize32(
        np.stack([_img(), _img(seed=7)]), LUT32, **kw),
    "encode_quantize_stereo": lambda m, **kw: m.encode_quantize_stereo(
        _img(seed=5), LUT, **kw),
    "encode_quantize_stereo planar compat": lambda m, **kw:
        m.encode_quantize_stereo(_img(seed=5), LUT, compat=True,
                                 view_layout="planar", **kw),
    "encode_quantize_stereo native range": lambda m, **kw:
        m.encode_quantize_stereo(_img(seed=5), LUT, 16, None,
                                 view_layout="native", **kw),
    "decode_quantize_stereo": lambda m, **kw: m.decode_quantize_stereo(
        _stereo_records("interleaved"), LUT, W, H, **kw),
    "decode_quantize_stereo native": lambda m, **kw:
        m.decode_quantize_stereo(_stereo_records("native"), LUT, W, H,
                                 view_layout="native", **kw),
    "decode_quantize_stereo planar compat": lambda m, **kw:
        m.decode_quantize_stereo(_stereo_records("planar"), LUT, W, H,
                                 view_layout="planar", compat=True, **kw),
}


@pytest.mark.parametrize("case", sorted(API_CASES))
def test_api_numpy_tier_is_the_jax_numpy_tier(case):
    call = API_CASES[case]
    got = call(T, backend="numpy")
    want = np.asarray(call(J, backend="numpy"))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_numpy_cap_runs_the_golden_on_the_host():
    img = _img()
    try:
        C.set_max_backend("numpy", strict=True)
        assert C.select_backend(device="cpu") == "numpy"
        assert C.select_backend("torch", device="cpu") == "torch"
        got = T.encode_quantize32(img, LUT32)       # no device: the host
    finally:
        C.set_max_backend("cuda")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.encode_quantize32(img, LUT32,
                                                    backend="numpy")))
    assert C.select_backend(device="cpu") == "torch"


@pytest.mark.parametrize("device, backend, cap, want", [
    (None, "numpy", "cuda", "cpu"),
    (None, None, "numpy", "cpu"),
    ("cpu", "torch", "numpy", "cpu"),
    (None, "torch", "numpy", "cuda"),
    (None, None, "cuda", "cuda"),
])
def test_default_device_places_numpy_tier_data_on_the_host(device, backend,
                                                          cap, want):
    """Data that is not a tensor yet goes to the host where the call runs
    the numpy tier (asked for, or under the cap) and names no device, and
    to the card otherwise (here, with no card, that raises naming
    ``device="cpu"``): one rule, in ``default_device``."""
    C.set_max_backend(cap)
    try:
        if want == "cuda" and not torch.cuda.is_available():
            with pytest.raises(T.NotSupportedError, match='device="cpu"'):
                C.default_device(device, backend)
        else:
            assert C.default_device(device, backend).type == want
    finally:
        C.set_max_backend("cuda")


def test_numpy_tier_never_moves_a_cuda_tensor():
    with pytest.raises(T.NotSupportedError, match=r"\.cpu\(\)"):
        C.select_backend("numpy", device="cuda")
    with pytest.raises(T.NotSupportedError, match=r"\.cpu\(\)"):
        T.encode_quantize32(_img(), LUT32, backend="numpy", device="meta")


def test_try_encode_under_numpy_is_the_jax_try_encode():
    img = _img()
    got = np.full(H // 2 * W, 7, np.uint8)
    want = got.copy()
    assert T.api.try_encode_quantize32(img, got, LUT32, W, H, 16, 16,
                                       backend="numpy") == 0
    assert J.api.try_encode_quantize32(img, want, LUT32, W, H, 16, 16,
                                       backend="numpy") == 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", [
    "encode_quantize32_ycbcr", "roundtrip_quantize32_ycbcr",
    "encode_quantize32_ycbcr420"])
def test_colour_refuses_the_numpy_tier(name):
    planes = np.stack([_img(64, 128, seed=s) for s in range(3)])
    for api, error in ((T.api, T.NotSupportedError),
                       (J.api, J.NotSupportedError)):
        with pytest.raises(error):
            getattr(api, name)(planes, LUT32, LUT32, backend="numpy")
    with pytest.raises(T.NotSupportedError):
        T.decode_quantize32_ycbcr(np.zeros(3 * 32 * 128, np.uint8), LUT32,
                                  LUT32, 128, 64, backend="numpy")
    with pytest.raises(T.NotSupportedError):
        T.decode_quantize32_ycbcr420(np.zeros(32 * 128 * 3 // 2, np.uint8),
                                     LUT32, LUT32, 128, 64, backend="numpy")


def test_encoder_config_takes_the_numpy_tier():
    cfg = T.EncoderConfig(quality=50, backend="numpy")
    enc = T.Encoder(cfg)
    img = _img()
    rec = enc.encode_quantize32(img)
    np.testing.assert_array_equal(
        rec.numpy(), np.asarray(J.encode_quantize32(img, LUT32,
                                                    backend="numpy")))
    blob = enc.encode_container(img, "enc-quant32")
    assert enc.decode_container(blob).device.type == "cpu"


@pytest.mark.parametrize("mode", ["enc-quant", "enc-quant32",
                                  "enc-quant-stereo"])
def test_cli_max_simd_none_is_the_jax_cli(mode, tmp_path):
    raw = tmp_path / "img.raw"
    _img(64, 128, seed=6).tofile(raw)
    argv = [str(raw), "128", "64", "--runs", "1", "--quality", "50",
            "--mode", mode, "--max-simd", "none", "--accurate", "--to"]
    try:
        assert cli.main(argv + [str(tmp_path / "port")]) == 0
        assert C.get_max_backend() == "numpy"
        assert JCLI.main(argv + [str(tmp_path / "jax")]) == 0
    finally:
        C.set_max_backend("cuda")
        j_set_max_backend("pallas")
    np.testing.assert_array_equal(np.fromfile(tmp_path / "port", np.uint8),
                                  np.fromfile(tmp_path / "jax", np.uint8))


def test_cli_max_simd_none_refuses_a_card(tmp_path, capsys):
    raw = tmp_path / "img.raw"
    _img(64, 128).tofile(raw)
    try:
        assert cli.main([str(raw), "128", "64", "--runs", "1", "--max-simd",
                         "none", "--device", "cuda:0"]) == 1
        assert "on the host" in capsys.readouterr().out
        assert cli.main([str(raw), "128", "64", "--runs", "1", "--max-simd",
                         "none", "--mode", "enc-quant32-ycbcr"]) == 0
        assert "no numpy tier" in capsys.readouterr().out
    finally:
        C.set_max_backend("cuda")
