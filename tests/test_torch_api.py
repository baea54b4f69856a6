"""The port's api, dispatch, loader and wrapper contracts, on the CPU."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import simd_dct_tpu as J
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import api as A
from simd_dct_tpu_torch import convert
from simd_dct_tpu_torch.dispatch import capability as C
from simd_dct_tpu_torch.kernels import _build
from simd_dct_tpu_torch.kernels import cuda_dct as K
from simd_dct_tpu_torch.utils.debug import check_deterministic

REPO = Path(__file__).resolve().parents[1]
LUT = T.default_quant_lut(50) * np.float32(255.0)
CPU = {"device": "cpu"}    # numpy inputs run on the card unless asked


def _img(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w), np.uint8)


def _raises_same(call_port, call_jax):
    """Both packages raise, and the port raises the JAX error's type."""
    with pytest.raises(J.SimdDctError) as jexc:
        call_jax()
    port_type = getattr(T, type(jexc.value).__name__)
    with pytest.raises(port_type):
        call_port()


BAD_ENCODE_INPUTS = {
    "w_not_64": (lambda: _img(32, 96), LUT, {}),
    "h_not_16": (lambda: _img(40, 128), LUT, {}),
    "h_not_8": (lambda: _img(36, 128), LUT, {}),
    "dtype": (lambda: _img(32, 128).astype(np.int32), LUT, {}),
    "ndim": (lambda: _img(32, 128)[None, None], LUT, {}),
    "lut_63": (lambda: _img(32, 128), LUT[:63], {}),
    "lut_zero": (lambda: _img(32, 128), np.where(np.arange(64) == 3, 0, LUT),
                 {}),
    "lut_nan": (lambda: _img(32, 128),
                np.where(np.arange(64) == 9, np.nan, LUT), {}),
    "rounding": (lambda: _img(32, 128), LUT, {"rounding": "up"}),
}


@pytest.mark.parametrize("case", sorted(BAD_ENCODE_INPUTS))
def test_encode_validation_matches_jax(case):
    make, lut, kw = BAD_ENCODE_INPUTS[case]
    _raises_same(lambda: T.encode_quantize32(make(), lut, device="cpu", **kw),
                 lambda: J.encode_quantize32(make(), lut, **kw))
    if "rounding" not in kw:
        _raises_same(lambda: T.roundtrip_quantize32(make(), lut, device="cpu"),
                     lambda: J.roundtrip_quantize32(make(), lut))


BAD_DECODE_INPUTS = {
    "size_x_zero": (np.zeros(64, np.uint8), 0, 16),
    "size_y_negative": (np.zeros(64, np.uint8), 64, -16),
    "w_not_64": (np.zeros(8 * 96, np.uint8), 96, 16),
    "h_not_16": (np.zeros(64 * 20, np.uint8), 64, 40),
    "dtype": (np.zeros(64 * 8, np.int16), 64, 16),
    "length": (np.zeros(64 * 8 + 1, np.uint8), 64, 16),
}


@pytest.mark.parametrize("case", sorted(BAD_DECODE_INPUTS))
def test_decode_validation_matches_jax(case):
    data, sx, sy = BAD_DECODE_INPUTS[case]
    _raises_same(lambda: T.decode_quantize32(data, LUT, sx, sy, device="cpu"),
                 lambda: J.decode_quantize32(data, LUT, sx, sy))


def test_decode_lut_size_raises():
    with pytest.raises(T.InvalidParameterError):
        T.decode_quantize32(np.zeros(64 * 8, np.uint8), LUT[:10], 64, 16,
                            device="cpu")


def test_result_codes_mirror_jax():
    for name in ("SUCCESS", "INVALID_PARAMETER", "NOT_SUPPORTED"):
        assert int(getattr(T.SimdDctResult, name)) == int(
            getattr(J.SimdDctResult, name))
    assert T.NotSupportedError.result == T.SimdDctResult.NOT_SUPPORTED


def test_try_encode_quantize32_codes_and_partial_write():
    img = _img(64, 128)
    out = np.full(32 * 128, 7, np.uint8)
    assert A.try_encode_quantize32(img, out, LUT[:5], 128, 64, 0, None, **CPU) \
        == T.SimdDctResult.INVALID_PARAMETER
    assert A.try_encode_quantize32(_img(64, 96), out, LUT, 96, 64, 0, None,
                                   **CPU) \
        == T.SimdDctResult.NOT_SUPPORTED
    assert (out == 7).all()
    assert A.try_encode_quantize32(img, out, LUT, 128, 64, 16, 16, **CPU) \
        == T.SimdDctResult.SUCCESS
    full = T.encode_quantize32(img, LUT, **CPU).numpy()
    strips = out.reshape(4, -1)
    assert (strips[[0, 2, 3]] == 7).all()     # untouched, like the reference
    np.testing.assert_array_equal(strips[1], full.reshape(4, -1)[1])
    want = np.zeros_like(out)
    J.api.try_encode_quantize32(img, want, LUT, 128, 64, 16, 16)
    np.testing.assert_array_equal(strips[1], want.reshape(4, -1)[1])
    assert A.try_encode_quantize32(img, out, LUT, 128, 64, 0, None, **CPU) \
        == T.SimdDctResult.SUCCESS
    np.testing.assert_array_equal(out, full)


def test_compat_raises_not_supported():
    """compat=True no longer raises: mode32 encode and decode route to the
    strict-IEEE tier and equal it, and the C++ oracle, byte for byte."""
    from simd_dct_tpu import native
    from simd_dct_tpu_torch.kernels import compat as TC
    img = _img(32, 128)
    rec = T.encode_quantize32(img, LUT, compat=True, **CPU)
    assert rec.device.type == "cpu"
    np.testing.assert_array_equal(
        rec.numpy(), TC.encode_quantize32(torch.from_numpy(img), LUT).numpy())
    np.testing.assert_array_equal(rec.numpy(),
                                  native.encode_quantize32(img, LUT))
    dec = T.decode_quantize32(rec.numpy(), LUT, 128, 32, compat=True, **CPU)
    np.testing.assert_array_equal(dec.numpy(),
                                  TC.decode_quantize32(rec, LUT, 128, 32))
    np.testing.assert_array_equal(
        dec.numpy(), native.decode_quantize32(rec.numpy(), LUT, 128, 32))


def test_cuda_backend_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    with pytest.raises(T.NotSupportedError):
        C.select_backend("cuda")
    with pytest.raises(T.NotSupportedError):
        T.encode_quantize32(_img(32, 128), LUT, backend="cuda", **CPU)
    with pytest.raises(T.NotSupportedError):
        C.set_max_backend("cuda", strict=True)
    assert C.available_tiers() == ("torch",)
    assert C.probe().supports_cuda is False


def test_cuda_backend_on_cpu_tensor_raises():
    """An explicit cuda request never moves CPU data, GPU or not."""
    with pytest.raises(T.NotSupportedError):
        C.select_backend("cuda", device="cpu")
    with pytest.raises(ValueError):
        C.select_backend("pallas")


def test_tier_selection_follows_device_and_cap():
    assert C.select_backend(device="cpu") == "torch"
    assert C.select_backend("torch", device="cuda") == "torch"
    try:
        C.set_max_backend("torch")
        assert C.get_max_backend() == "torch"
        assert C.select_backend(device="cuda") == "torch"
    finally:
        C.set_max_backend("cuda")
    with pytest.raises(ValueError):
        C.set_max_backend("numpy")


def test_numpy_input_defaults_to_the_card(monkeypatch):
    """A non-tensor input with no ``device`` goes to the card; with no
    card that raises NotSupportedError naming device="cpu", for every
    entry point, and never runs on the host quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    img, rec = _img(32, 128), np.zeros(16 * 128, np.uint8)
    calls = {
        "encode_quantize": lambda **kw: T.encode_quantize(img, LUT, **kw),
        "decode_quantize": lambda **kw: T.decode_quantize(rec, LUT, 128, 32,
                                                          **kw),
        "encode_quantize32": lambda **kw: T.encode_quantize32(img, LUT, **kw),
        "decode_quantize32": lambda **kw: T.decode_quantize32(rec, LUT, 128,
                                                              32, **kw),
        "roundtrip_quantize32": lambda **kw: T.roundtrip_quantize32(img, LUT,
                                                                    **kw),
        "records_from_numpy": lambda **kw: convert.records_from_numpy(
            rec, 128, 32, **kw),
        "lut_from_numpy": lambda **kw: convert.lut_from_numpy(LUT, **kw)[0],
    }
    for name, call in calls.items():
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(T.NotSupportedError, match='device="cpu"'):
                call(**kw)
        assert call(device="cpu").device.type == "cpu", name
    out = np.full(16 * 128, 7, np.uint8)
    assert A.try_encode_quantize(img, out, LUT, 128, 32, 0, None) \
        == T.SimdDctResult.NOT_SUPPORTED
    assert (out == 7).all()
    # a CPU tensor stays on the host and takes the plain version
    assert T.encode_quantize(torch.from_numpy(img), LUT).device.type == "cpu"


def test_device_keyword_places_numpy_and_never_moves_tensors():
    img = _img(32, 128)
    out = T.encode_quantize32(img, LUT, device="cpu")
    assert out.device.type == "cpu"
    with pytest.raises(T.InvalidParameterError):
        T.encode_quantize32(torch.from_numpy(img), LUT, device="meta")


def _no_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_lib", None)


def test_loader_without_nvcc_raises(monkeypatch, tmp_path):
    _no_nvcc(monkeypatch, tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_probe_raises_instead_of_degrading(monkeypatch, tmp_path):
    """With a GPU reported but no way to build the kernels, the probe
    raises; it does not fall back to the plain tier."""
    _no_nvcc(monkeypatch, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    C.probe.cache_clear()
    try:
        with pytest.raises(RuntimeError):
            C.probe()
        with pytest.raises(RuntimeError):
            C.select_backend(device="cuda")
    finally:
        C.probe.cache_clear()


def test_build_falls_back_to_the_user_cache(monkeypatch, tmp_path):
    """An installed package whose directory cannot be written builds under
    $XDG_CACHE_HOME (else ~/.cache)/simd_dct_tpu_torch."""
    assert _build.build_root() == _build.BUILD_ROOT
    monkeypatch.setattr(_build, "_writable", lambda path: False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    assert _build.build_root() == str(tmp_path / "xdg" / "simd_dct_tpu_torch")
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert _build.build_root() == str(tmp_path / "home" / ".cache"
                                      / "simd_dct_tpu_torch")


def test_writable_checks_the_nearest_existing_directory(monkeypatch,
                                                        tmp_path):
    assert _build._writable(str(tmp_path / "not" / "yet"))
    monkeypatch.setattr(os, "access", lambda path, mode: False)
    assert not _build._writable(str(tmp_path / "not" / "yet"))


def test_package_data_ships_every_included_source():
    """Every file a CUDA source includes by quotes, and every source, matches
    a package-data glob of pyproject.toml, so a wheel can build them."""
    import fnmatch
    import re
    import tomllib
    cfg = tomllib.loads((REPO / "pyproject.toml").read_text())
    globs = cfg["tool"]["setuptools"]["package-data"]["simd_dct_tpu_torch"]
    assert "torch" in cfg["project"]["optional-dependencies"]["torch"]
    assert not any(d.startswith("torch")
                   for d in cfg["project"]["dependencies"])
    csrc = REPO / "simd_dct_tpu_torch" / "csrc"
    needed = {f"csrc/{p.name}" for p in csrc.iterdir()}
    for src in csrc.iterdir():
        needed |= {f"csrc/{name}" for name in re.findall(
            r'#include\s+"([^"]+)"', src.read_text())}
    assert "csrc/dct_common.cuh" in needed and "csrc/tiles.cu" in needed
    missing = {n for n in needed
               if not any(fnmatch.fnmatch(n, g) for g in globs)}
    assert not missing, missing


@pytest.mark.parametrize("batch", [0, 1, 4, 5, 9, 13])
def test_batch_slices_cover_the_batch_once(monkeypatch, batch):
    """With the per-launch limit patched to 4 frames, the launches of a
    batch hold at most 4 frames each and cover every frame exactly once,
    in order; at the real limit 65,536 frames take two launches."""
    monkeypatch.setattr(K, "_MAX_BATCH", 4)
    slices = K.batch_slices(batch)
    assert all(0 < n <= 4 for _, n in slices)
    covered = [f for lo, n in slices for f in range(lo, lo + n)]
    assert covered == list(range(batch))
    assert len(slices) == -(-batch // 4)
    monkeypatch.undo()
    assert K.batch_slices(65536) == [(0, 65535), (65535, 1)]
    assert K.batch_slices(65535) == [(0, 65535)]


def test_nvcc_flags():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags


@pytest.mark.parametrize("fn", ["encode", "decode", "roundtrip", "probe"])
def test_wrappers_reject_bad_tensors(fn):
    img = torch.from_numpy(_img(32, 128))
    rec = torch.zeros(16 * 128, dtype=torch.uint8)
    call = {
        "encode": lambda t: K.encode_quantize32(t, LUT),
        "decode": lambda t: K.decode_quantize32(t, LUT, 128, 32),
        "roundtrip": lambda t: K.roundtrip_quantize32(t, LUT),
        "probe": lambda t: K.probe_trial(t),
    }[fn]
    good = rec if fn == "decode" else img
    with pytest.raises(TypeError):
        call(good.to(torch.int16))
    with pytest.raises(TypeError):
        call(good.numpy())
    if fn == "decode":
        with pytest.raises(ValueError):
            call(torch.zeros(2, 32 * 128, dtype=torch.uint8)[:, ::2])
    else:
        with pytest.raises(ValueError):
            call(torch.from_numpy(_img(32, 256))[:, ::2])
    with pytest.raises(ValueError):
        call(torch.empty(good.shape, dtype=torch.uint8, device="meta"))
    if fn != "probe":
        bad = (torch.zeros(16 * 96, dtype=torch.uint8) if fn == "decode"
               else torch.from_numpy(_img(32, 96)))
        with pytest.raises(ValueError):
            call(bad)
    before = dict(K.LAUNCHES)
    call(good)                 # CPU tensor: the plain version, no launch
    assert K.LAUNCHES == before


def test_wrappers_on_cpu_equal_plain_version():
    img = torch.from_numpy(np.stack([_img(32, 128, s) for s in range(2)]))
    rec = K.encode_quantize32(img, LUT, 0, 1 << 40)   # end_y beyond int32
    np.testing.assert_array_equal(
        rec.numpy(), T.encode_quantize32(img.numpy(), LUT, **CPU).numpy())
    dec = K.decode_quantize32(rec, LUT, 128, 32)
    np.testing.assert_array_equal(K.roundtrip_quantize32(img, LUT).numpy(),
                                  dec.numpy())
    x = torch.arange(256, dtype=torch.uint8).reshape(2, 128)
    np.testing.assert_array_equal(
        K.probe_trial(x).numpy().reshape(-1),
        np.minimum(np.arange(256) + 1, 255).astype(np.uint8))
    assert K.supports_mode("roundtrip32", 32, 128)
    assert not K.supports_mode("roundtrip32", 32, 96)
    assert K.supports_mode("enc_quant", 32, 72)
    assert not K.supports_mode("enc_quant", 32, 72, "pair")
    assert K.supports_mode("dec_quant", 32, 80, "pair")
    assert K.supports_mode("enc_quant_stereo", 32, 200)
    assert not K.supports_mode("enc_quant_stereo", 32, 196)
    assert not K.supports_mode("tiles", 32, 128)


def test_convert_matches_jax():
    import jax.numpy as jnp
    from simd_dct_tpu.core import quantize as J_q
    q, qi = convert.lut_from_numpy(LUT, **CPU)
    assert q.numpy().tobytes() == np.asarray(J_q.quant_scales(LUT)).tobytes()
    assert qi.numpy().tobytes() == \
        np.asarray(J_q.dequant_scales(jnp.asarray(LUT))).tobytes()
    recs = np.stack([np.asarray(J.encode_quantize32(_img(32, 128, s), LUT,
                                                    backend="xla"))
                     for s in range(2)])
    t = convert.records_from_numpy(recs, 128, 32, **CPU)
    assert t.shape == (2, 16 * 128) and t.dtype == torch.uint8
    np.testing.assert_array_equal(convert.records_to_numpy(t), recs)
    with pytest.raises(ValueError):
        convert.records_from_numpy(recs[:, 1:], 128, 32, **CPU)
    with pytest.raises(ValueError):
        convert.records_from_numpy(recs.astype(np.int32), 128, 32, **CPU)


def test_check_deterministic():
    img = _img(32, 128)
    assert check_deterministic(lambda: T.roundtrip_quantize32(img, LUT, **CPU))
    it = iter(range(10))
    assert not check_deterministic(lambda: torch.tensor([next(it)]))


def test_import_pulls_in_no_jax():
    code = ("import sys, simd_dct_tpu_torch, simd_dct_tpu_torch.convert, "
            "simd_dct_tpu_torch.kernels.cuda_dct, "
            "simd_dct_tpu_torch.layout.stereo, "
            "simd_dct_tpu_torch.layout.color, "
            "simd_dct_tpu_torch.layout.color420, "
            "simd_dct_tpu_torch.kernels.torch_path, "
            "simd_dct_tpu_torch.kernels.panel, "
            "simd_dct_tpu_torch.kernels.compat, "
            "simd_dct_tpu_torch.utils.debug, simd_dct_tpu_torch.utils.metrics; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'simd_dct_tpu.')) or m == 'simd_dct_tpu']; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([os.environ["PYTHONPATH"]]
                       if os.environ.get("PYTHONPATH") else []))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
