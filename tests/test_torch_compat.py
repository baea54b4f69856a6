"""The port's strict-IEEE compat tier (``kernels/compat.py``) on the CPU.

References: the C++ oracle (``native/golden_dct.cpp`` through
``simd_dct_tpu.native``) and the JAX package's compat engine
(``simd_dct_tpu/kernels/compat.py``, reached directly and through its api
with ``compat=True``).  Tolerance: ZERO mismatched bytes, everywhere.
Inputs come from numpy with a seed: the 64x128 image and the JPEG table
at quality 50 of ``tests/test_compat.py``, and 2-frame batches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu import native
from simd_dct_tpu.kernels import compat as JC
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch.kernels import compat as TC

ROUNDINGS = ("rne", "scalar", "clamp_first")
MODES = ("enc_quant", "enc_quant32", "stereo")
CPU = {"device": "cpu"}
H, W = 64, 128


def _img(seed=0xE4AC, frames=None, h=H, w=W):
    shape = (h, w) if frames is None else (frames, h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _lut(mode="enc_quant"):
    lut = T.default_quant_lut(50)
    return lut * np.float32(255.0) if mode == "enc_quant32" else lut


def _mismatches(a, b) -> int:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return int((a != b).sum())


PORT_ENC = {"enc_quant": TC.encode_quantize,
            "enc_quant32": TC.encode_quantize32,
            "stereo": TC.encode_quantize_stereo}
JAX_ENC = {"enc_quant": JC.encode_quantize,
           "enc_quant32": JC.encode_quantize32,
           "stereo": JC.encode_quantize_stereo}
ORACLE_ENC = {"enc_quant": native.encode_quantize,
              "enc_quant32": native.encode_quantize32,
              "stereo": native.encode_quantize_stereo}
API_ENC = {"enc_quant": "encode_quantize", "enc_quant32": "encode_quantize32",
           "stereo": "encode_quantize_stereo"}


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("mode", MODES)
def test_encode_exact(mode, rounding):
    img, lut = _img(), _lut(mode)
    want = ORACLE_ENC[mode](img, lut, rounding=rounding)
    got = PORT_ENC[mode](torch.from_numpy(img), lut, rounding=rounding)
    jax = JAX_ENC[mode](jnp.asarray(img), lut, rounding=rounding)
    assert _mismatches(got, want) == 0
    assert _mismatches(got, jax) == 0
    api = getattr(T, API_ENC[mode])(img, lut, rounding=rounding, compat=True,
                                    **CPU)
    assert _mismatches(api, want) == 0


@pytest.mark.parametrize("mode", MODES)
def test_encode_batch_exact(mode):
    """A 2-frame batch in one call equals the oracle frame by frame."""
    imgs, lut = _img(seed=5, frames=2), _lut(mode)
    got = getattr(T, API_ENC[mode])(imgs, lut, compat=True, **CPU)
    want = np.stack([ORACLE_ENC[mode](f, lut) for f in imgs])
    assert got.shape[0] == 2 and _mismatches(got, want) == 0


@pytest.mark.parametrize("layout", ["pair", "pair_as_written"])
def test_pair_layouts_exact(layout):
    img, lut = _img(), _lut()
    want = native.encode_quantize(img, lut, layout=layout)
    got = T.encode_quantize(img, lut, layout=layout, compat=True, **CPU)
    assert _mismatches(got, want) == 0


def _records(kind, imgs, lut):
    """Oracle records of each frame of imgs (one frame or a batch)."""
    enc = {"scalar": lambda f: native.encode_quantize(f, lut),
           "pair": lambda f: native.encode_quantize(f, lut, layout="pair"),
           "mode32": lambda f: native.encode_quantize32(f, lut),
           "stereo": lambda f: native.encode_quantize_stereo(f, lut)}[kind]
    return enc(imgs) if imgs.ndim == 2 else np.stack([enc(f) for f in imgs])


DECODES = {
    "scalar": ("enc_quant", lambda d, lut: native.decode_quantize(
        d, lut, W, H), lambda d, lut, **kw: T.decode_quantize(
        d, lut, W, H, **kw), lambda d, lut: JC.decode_quantize(
        d, lut, W, H)),
    "pair": ("enc_quant", lambda d, lut: native.decode_quantize(
        d, lut, W, H, layout="pair"), lambda d, lut, **kw: T.decode_quantize(
        d, lut, W, H, layout="pair", **kw), lambda d, lut: JC.decode_quantize(
        d, lut, W, H, layout="pair")),
    "mode32": ("enc_quant32", lambda d, lut: native.decode_quantize32(
        d, lut, W, H), lambda d, lut, **kw: T.decode_quantize32(
        d, lut, W, H, **kw), lambda d, lut: JC.decode_quantize32(
        d, lut, W, H)),
    "stereo": ("stereo", lambda d, lut: native.decode_quantize_stereo(
        d, lut, W, H), lambda d, lut, **kw: T.decode_quantize_stereo(
        d, lut, W, H, **kw), lambda d, lut: JC.decode_quantize_stereo(
        d, lut, W, H)),
}


@pytest.mark.parametrize("kind", sorted(DECODES))
def test_decode_exact(kind):
    mode, oracle, port, jax = DECODES[kind]
    lut = _lut(mode)
    rec = _records(kind, _img(), lut)
    want = oracle(rec, lut)
    got = port(rec, lut, compat=True, **CPU)
    assert _mismatches(got, want) == 0
    assert _mismatches(got, jax(jnp.asarray(rec), lut)) == 0
    batch = _records(kind, _img(seed=9, frames=2), lut)
    got_b = port(batch, lut, compat=True, **CPU)
    assert _mismatches(got_b, np.stack([oracle(r, lut) for r in batch])) == 0


@pytest.mark.parametrize("vl", ["planar", "native"])
def test_stereo_view_layouts_exact(vl):
    """The planar and native forms under compat equal the JAX api's, whole
    and under a strip range, and decode to the oracle's pixels."""
    img, lut = _img(), _lut()
    for sy, ey in [(0, None), (16, 47)]:
        got = T.encode_quantize_stereo(img, lut, sy, ey, view_layout=vl,
                                       compat=True, **CPU)
        want = J.encode_quantize_stereo(img, lut, sy, ey, view_layout=vl,
                                        compat=True, backend="xla")
        assert _mismatches(got, want) == 0
    rec = T.encode_quantize_stereo(img, lut, view_layout=vl, compat=True,
                                   **CPU)
    dec = T.decode_quantize_stereo(rec, lut, W, H, view_layout=vl,
                                   compat=True)
    oracle = native.decode_quantize_stereo(
        native.encode_quantize_stereo(img, lut), lut, W, H)
    assert _mismatches(dec, oracle) == 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("rng", [(16, 31), (0, 15), (32, 1 << 20)])
def test_strip_range_exact(mode, rng):
    """Excluded strips are zero, as in the oracle's zeroed buffer."""
    img, lut = _img(), _lut(mode)
    want = ORACLE_ENC[mode](img, lut, *rng)
    got = getattr(T, API_ENC[mode])(img, lut, *rng, compat=True, **CPU)
    assert _mismatches(got, want) == 0


@pytest.mark.parametrize("layout", ["scalar", "pair_as_written"])
def test_legacy_range_exact(layout):
    img, lut = _img(), _lut()
    want = native.encode_quantize(img, lut, 0, 20, layout=layout,
                                  legacy_range=True)
    got = T.encode_quantize(img, lut, 0, 20, layout=layout,
                            legacy_range=True, compat=True, **CPU)
    assert _mismatches(got, want) == 0


def test_pair_as_written_partial_range_spill():
    """Strip 0 included, strips 1+ excluded: its last as-written cell
    spills 64 bytes into strip 1 (src/simd_dct.cpp:1662-1670), byte for
    byte as the oracle (tests/test_compat.py:118)."""
    img, lut = _img(), _lut()
    want = native.encode_quantize(img, lut, 0, 15, layout="pair_as_written")
    assert want[8 * W: 8 * W + 64].any()
    got = T.encode_quantize(img, lut, 0, 15, layout="pair_as_written",
                            compat=True, **CPU)
    assert _mismatches(got, want) == 0


def test_spill_exact():
    """H % 16 == 8 with spill=True: the oracle's spill strip."""
    img, lut = _img(h=72), _lut("enc_quant32")
    want = native.encode_quantize32(img, lut)
    got = T.encode_quantize32(img, lut, spill=True, compat=True, **CPU)
    assert _mismatches(got, want) == 0


def test_exact_roundf_edge():
    """v = the largest f32 below 0.5: roundf gives 0 where floor(v + 0.5)
    gives 1 (tests/test_compat.py:147)."""
    v = np.float32(np.nextafter(np.float32(0.5), np.float32(0.0)))
    assert np.floor(v + np.float32(0.5)) == 1.0
    got = TC._roundf(torch.tensor([v, 0.5, 1.5, 254.49998],
                                 dtype=torch.float32))
    assert got.tolist() == [0, 1, 2, 254]


def test_decode_pair_as_written_refused():
    rec = native.encode_quantize(_img(), _lut(), layout="pair_as_written")
    with pytest.raises(J.InvalidParameterError):
        J.decode_quantize(rec, _lut(), W, H, layout="pair_as_written",
                          compat=True)
    with pytest.raises(T.InvalidParameterError):
        T.decode_quantize(rec, _lut(), W, H, layout="pair_as_written",
                          compat=True, **CPU)
    with pytest.raises(ValueError):
        TC.decode_quantize(torch.from_numpy(rec), _lut(), W, H,
                           "pair_as_written")


@pytest.mark.parametrize("mode", MODES)
def test_try_encode_with_compat(mode):
    """try_encode_* with compat=True writes exactly the oracle's bytes of
    the strip range into the caller's buffer and leaves the rest."""
    img, lut = _img(), _lut(mode)
    name = "try_" + API_ENC[mode]
    n = H * W if mode == "stereo" else H // 2 * W
    out = np.full(n, 7, np.uint8)
    want = ORACLE_ENC[mode](img, lut, 16, 31, out=np.full(n, 7, np.uint8))
    rc = getattr(T.api, name)(img, out, lut, W, H, 16, 31, compat=True,
                              **CPU)
    assert rc == T.SimdDctResult.SUCCESS
    assert _mismatches(out, want) == 0
    jax_out = np.full(n, 7, np.uint8)
    getattr(J.api, name)(img, jax_out, lut, W, H, 16, 31, compat=True)
    assert _mismatches(out, jax_out) == 0


def test_compat_keeps_the_device_and_refuses_bad_calls():
    img = torch.from_numpy(_img())
    assert T.encode_quantize32(img, _lut("enc_quant32"),
                               compat=True).device.type == "cpu"
    with pytest.raises(T.InvalidParameterError):
        T.encode_quantize(img, _lut(), rounding="half_up", compat=True)
    with pytest.raises(ValueError):
        TC.quantize_exact(torch.zeros(64), _lut(), "half_up")
