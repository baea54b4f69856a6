"""The port's plain stereo path against the JAX package.

References: the JAX ``xla`` tier, the NumPy golden model (the JAX api's
``numpy`` tier, which also builds the planar and native forms) and the
Pallas kernels in interpret mode at f32 (at 64x256 only: about 4 s a call
here, so one module-scoped fixture makes three encodes and one native
decode).  Inputs are made with numpy from a seed; LUTs are the CLI's
JPEG-luma table or a seeded random table, never a symmetric one (a
transposed LUT index would pass with one).  Tolerances:
  * encode records and decoded pixels (of the SAME records): at most +-1,
    on at most 0.2% of bytes -- the ``compare_backends`` contract;
  * the plane layouts, ``native_stereo_bwp``, zeroed-strip and pad
    positions, the try_* write masks and batch == frames: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu import api as JA
from simd_dct_tpu.core import golden as G
from simd_dct_tpu.kernels import pallas_dct as PK
from simd_dct_tpu.layout import reorder as J_reorder
from simd_dct_tpu.layout import stereo as J_stereo
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import api as A
from simd_dct_tpu_torch import convert
from simd_dct_tpu_torch.kernels import cuda_dct as K
from simd_dct_tpu_torch.kernels import torch_path as TP
from simd_dct_tpu_torch.layout import reorder as T_reorder
from simd_dct_tpu_torch.layout import stereo as T_stereo
from simd_dct_tpu_torch.utils.debug import compare_backends

VIEW_LAYOUTS = ("interleaved", "planar", "native")
ROUNDINGS = ("rne", "scalar", "clamp_first")
CPU = {"device": "cpu"}
FULL = 1 << 30


def _img(h, w, seed=0, frames=None):
    shape = (h, w) if frames is None else (frames, h, w)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _lut(kind="jpeg"):
    if kind == "jpeg":
        return T.default_quant_lut(50)
    return np.random.default_rng(17).uniform(2.0, 30.0, 64).astype(np.float32)


def _assert_contract(outs):
    report = compare_backends(outs)
    bad = {k: v for k, v in report.items() if not v["ok"]}
    assert not bad, bad


def _port_enc(img, lut, sy=0, ey=FULL, rounding="rne", vl="interleaved"):
    return TP.encode_quantize_stereo(torch.from_numpy(img), lut, sy, ey,
                                     rounding, vl).numpy()


def _jax_enc(img, lut, sy=0, ey=None, rounding="rne", vl="interleaved",
             backend="xla"):
    return np.array(J.encode_quantize_stereo(img, lut, sy, ey,
                                               rounding=rounding,
                                               view_layout=vl,
                                               backend=backend))


# -- geometry and layouts ----------------------------------------------------

@pytest.mark.parametrize("w", [8, 120, 128, 200, 1920, 3840, 3848])
def test_native_stereo_bwp_matches_jax(w):
    assert T_stereo.native_stereo_bwp(w) == PK.native_stereo_bwp(w)
    assert T_stereo.native_stereo_bwp(w) % 128 == 0
    if w in (3840, 1920, 200):
        assert T_stereo.native_stereo_bwp(w) == {3840: 512, 1920: 256,
                                                 200: 128}[w]


def test_view_helpers_match_jax():
    img = _img(32, 24, seed=1, frames=2)
    views = T_stereo.split_views(torch.from_numpy(img))
    np.testing.assert_array_equal(
        views.numpy(), np.asarray(J_stereo.split_views(jnp.asarray(img))))
    np.testing.assert_array_equal(T_stereo.stack_views(views).numpy(), img)
    np.testing.assert_array_equal(
        T_stereo.top_view(torch.from_numpy(img)).numpy(), img[:, :16])
    with pytest.raises(ValueError):
        T_stereo.stack_views(views[:, :1])


def test_reorder_helpers_match_jax():
    rng = np.random.default_rng(3)
    bufs = rng.integers(0, 256, (2, 2, 3, 5, 64), np.uint8)  # (B, 2, S, BW, 64)
    flat = T_reorder.planar_stereo(torch.from_numpy(bufs))
    assert flat.shape == (2, 64 * 3 * 2 * 5)
    views = T_reorder.stereo_interleaved_to_views(flat, 3, 5)
    assert views.shape == (2, 2, 64, 3, 5)
    for b in range(2):
        want = J_reorder.planar_stereo(jnp.asarray(bufs[b]))
        np.testing.assert_array_equal(flat[b].numpy(), np.asarray(want))
        np.testing.assert_array_equal(
            views[b].numpy(),
            np.asarray(J_reorder.stereo_interleaved_to_views(want, 3, 5)))
        np.testing.assert_array_equal(
            T_reorder.stereo_views_to_interleaved(views[b]).numpy(),
            np.asarray(J_reorder.stereo_views_to_interleaved(
                jnp.asarray(views[b].numpy()))))
    np.testing.assert_array_equal(
        T_reorder.planar_stereo_inverse(flat, 3, 5).numpy(), bufs)
    np.testing.assert_array_equal(
        T_reorder.stereo_views_to_interleaved(views).numpy(), flat.numpy())
    # byte p of block (v, s, bx) sits at p*(S*2*BW) + s*2*BW + v*BW + bx
    p, v, s, bx = 37, 1, 2, 4
    assert flat[1, p * 30 + s * 10 + v * 5 + bx] == bufs[1, v, s, bx, p]
    nat = T_reorder.stereo_views_to_native(views, 128,
                                           np.array([True, False, True]))
    assert nat.shape == (2, 2, 64, 3, 128)
    np.testing.assert_array_equal(nat[..., [0, 2], :5].numpy(),
                                  views[..., [0, 2], :].numpy())
    assert (nat[..., [0, 2], 5:] == 127).all() and not nat[..., 1, :].any()


# -- encode / decode against xla, golden and Pallas interpret ---------------

ENCODE_CASES = [(h, w, lut, vl, r)
                for (h, w, lut) in [(64, 256, "jpeg"), (48, 200, "random")]
                for vl in VIEW_LAYOUTS for r in ROUNDINGS]


@pytest.mark.parametrize("h,w,lut_kind,vl,rounding", ENCODE_CASES)
def test_encode_matches_jax(h, w, lut_kind, vl, rounding):
    img, lut = _img(h, w, seed=h + w), _lut(lut_kind)
    port = _port_enc(img, lut, rounding=rounding, vl=vl)
    shape = {"interleaved": (h * w,), "planar": (2, 64, h // 16, w // 8),
             "native": (2, 64, h // 16, T_stereo.native_stereo_bwp(w))}[vl]
    assert port.shape == shape and port.dtype == np.uint8
    _assert_contract({
        "port": port,
        "xla": _jax_enc(img, lut, rounding=rounding, vl=vl),
        "golden": _jax_enc(img, lut, rounding=rounding, vl=vl,
                           backend="numpy"),
    })


@pytest.mark.parametrize("h,w,lut_kind,vl", [
    (64, 256, "jpeg", "interleaved"), (64, 256, "random", "planar"),
    (48, 200, "jpeg", "native"), (48, 200, "random", "interleaved")])
def test_decode_same_records_matches_jax(h, w, lut_kind, vl):
    img, lut = _img(h, w, seed=5), _lut(lut_kind)
    rec = _jax_enc(img, lut, vl=vl, backend="numpy")
    port = TP.decode_quantize_stereo(torch.from_numpy(rec), lut, w, h, vl)
    assert port.shape == (h, w) and port.dtype == torch.uint8
    flat = _jax_enc(img, lut, backend="numpy")
    _assert_contract({
        "port": port,
        "xla": J.decode_quantize_stereo(rec, lut, w, h, view_layout=vl,
                                        backend="xla"),
        "golden": G.decode_quantize_stereo_golden(flat, lut, w, h),
    })


@pytest.fixture(scope="module")
def pallas_64x256():
    """The Pallas kernels in interpret mode at f32 on one 64x256 image:
    three encodes (one view layout and rounding each) and the native
    decode of the golden records."""
    img, lut = _img(64, 256, seed=6), _lut("random")
    enc = {(vl, r): np.asarray(PK.encode_quantize_stereo(
        jnp.asarray(img), lut, 0, FULL, r, interpret=True, precision="f32",
        view_layout=vl))
        for vl, r in [("interleaved", "rne"), ("planar", "scalar"),
                      ("native", "clamp_first")]}
    rec = _jax_enc(img, lut, vl="native", backend="numpy")
    dec = np.asarray(PK.decode_quantize_stereo(
        jnp.asarray(rec), lut, 256, 64, interpret=True, precision="f32",
        view_layout="native"))
    return img, lut, enc, rec, dec


@pytest.mark.parametrize("vl,rounding", [("interleaved", "rne"),
                                         ("planar", "scalar"),
                                         ("native", "clamp_first")])
def test_encode_matches_pallas_interpret(pallas_64x256, vl, rounding):
    img, lut, enc, _, _ = pallas_64x256
    port = _port_enc(img, lut, rounding=rounding, vl=vl)
    assert port.shape == enc[vl, rounding].shape
    _assert_contract({"port": port, "pallas": enc[vl, rounding]})


def test_native_decode_matches_pallas_interpret(pallas_64x256):
    _, lut, _, rec, dec = pallas_64x256
    _assert_contract({
        "port": TP.decode_quantize_stereo(torch.from_numpy(rec), lut, 256, 64,
                                          "native"),
        "pallas": dec})


# -- strip ranges, exact identities, batches, spill -------------------------

@pytest.mark.parametrize("sy,ey", [(16, 16), (16, 47), (0, 40), (-5, 5)])
@pytest.mark.parametrize("vl", VIEW_LAYOUTS)
def test_strip_range_matches_jax(vl, sy, ey):
    """Zeroed bytes and native pad bytes sit where the JAX xla tier puts
    them, exactly; the values agree within the contract."""
    img, lut = _img(128, 200, seed=7), _lut("random")
    port = _port_enc(img, lut, sy, ey, vl=vl)
    want = _jax_enc(img, lut, sy, ey, vl=vl)
    np.testing.assert_array_equal(port == 0, want == 0)
    _assert_contract({"port": port, "xla": want})
    strips = TP._strip_mask(8, sy, ey)
    assert strips.any() and not strips.all()
    planes = port if vl != "interleaved" else \
        T_reorder.stereo_interleaved_to_views(torch.from_numpy(port), 8,
                                              25).numpy()
    assert not planes[:, :, ~strips].any()
    if vl == "native":
        assert (planes[:, :, strips, 25:] == 127).all()


@pytest.mark.parametrize("h,w", [(64, 256), (48, 200)])
def test_view_layout_identities(h, w):
    img, lut = _img(h, w, seed=8), _lut("jpeg")
    ilv, pla, nat = (_port_enc(img, lut, vl=vl) for vl in VIEW_LAYOUTS)
    s, bw = h // 16, w // 8
    np.testing.assert_array_equal(
        pla, T_reorder.stereo_interleaved_to_views(torch.from_numpy(ilv), s,
                                                   bw).numpy())
    np.testing.assert_array_equal(nat[..., :bw], pla)
    assert (nat[..., bw:] == 127).all()
    decs = [T.decode_quantize_stereo(r, lut, w, h, view_layout=vl, **CPU)
            for r, vl in zip((ilv, pla, nat), VIEW_LAYOUTS)]
    assert torch.equal(decs[0], decs[1]) and torch.equal(decs[0], decs[2])


def test_batch_equals_frames_and_jax():
    frames, lut = _img(32, 128, seed=10, frames=3), _lut("random")
    for vl in VIEW_LAYOUTS:
        port = T.encode_quantize_stereo(frames, lut, view_layout=vl, **CPU)
        assert port.shape[0] == 3
        for i in range(3):
            np.testing.assert_array_equal(
                port[i].numpy(),
                T.encode_quantize_stereo(frames[i], lut, view_layout=vl,
                                         **CPU).numpy())
        _assert_contract({"port": port, "jax": _jax_enc(frames, lut, vl=vl)})
        dec = T.decode_quantize_stereo(port, lut, 128, 32, view_layout=vl,
                                       **CPU)
        assert dec.shape == (3, 32, 128)
        for i in range(3):
            np.testing.assert_array_equal(
                dec[i].numpy(),
                T.decode_quantize_stereo(port[i], lut, 128, 32,
                                         view_layout=vl).numpy())


@pytest.mark.parametrize("vl", VIEW_LAYOUTS)
def test_spill_matches_jax(vl):
    img, lut = _img(40, 16, seed=9), _lut("jpeg")
    port = T.encode_quantize_stereo(img, lut, spill=True, view_layout=vl,
                                    **CPU)
    want = np.asarray(J.encode_quantize_stereo(img, lut, spill=True,
                                               view_layout=vl, backend="xla"))
    assert port.shape == want.shape
    assert port.numel() == (48 * 16 if vl != "native" else 2 * 64 * 3 * 128)
    _assert_contract({"port": port, "jax": want})


# -- try_*: the reference's partial writes, and the spill fault -------------

def test_try_encode_quantize_stereo_leaves_the_same_bytes_as_jax():
    img, lut = _img(128, 64, seed=11), _lut("jpeg")
    port_out = np.full(128 * 64, 7, np.uint8)
    jax_out = port_out.copy()
    for sy, ey in [(16, 31), (80, 200)]:
        assert A.try_encode_quantize_stereo(img, port_out, lut, 64, 128, sy,
                                            ey, **CPU) \
            == T.SimdDctResult.SUCCESS
        assert JA.try_encode_quantize_stereo(img, jax_out, lut, 64, 128, sy,
                                             ey, backend="xla") \
            == J.SimdDctResult.SUCCESS
        np.testing.assert_array_equal(
            A._strip_byte_mask(128, 64, sy, ey, view_layout="interleaved"),
            JA._strip_byte_mask("stereo", 128, 64, sy, ey))
    untouched = port_out == 7
    np.testing.assert_array_equal(untouched, jax_out == 7)
    assert untouched.any() and not untouched.all()
    _assert_contract({"port": port_out, "jax": jax_out})
    planar = np.full((2, 64, 8, 8), 7, np.uint8)
    assert A.try_encode_quantize_stereo(img, planar, lut, 64, 128, 16, 31,
                                        view_layout="planar", **CPU) \
        == T.SimdDctResult.SUCCESS
    np.testing.assert_array_equal(
        planar[:, :, 1], _port_enc(img, lut, vl="planar")[:, :, 1])
    assert (planar[:, :, [0, 2, 3, 4, 5, 6, 7]] == 7).all()
    bad = np.full(128 * 64, 7, np.uint8)
    assert A.try_encode_quantize_stereo(img, bad, lut[:5], 64, 128, 0, None,
                                        **CPU) \
        == T.SimdDctResult.INVALID_PARAMETER
    assert A.try_encode_quantize_stereo(_img(40, 64), bad, lut, 64, 40, 0,
                                        None, **CPU) \
        == T.SimdDctResult.NOT_SUPPORTED
    assert (bad == 7).all()


def test_try_stereo_spill_with_range_does_not_copy_the_jax_fault():
    """The JAX package builds the stereo try_* mask without ``spill``
    (simd_dct_tpu/api.py:945), so spill=True with H % 16 == 8 and a strip
    range raises an untyped ValueError there.  The port's mask follows
    ``spill``: SUCCESS, and exactly the included strips' bytes of the
    2*R*W-byte spill output."""
    img, lut = _img(40, 16, seed=12), _lut("jpeg")
    jax_out = np.full(48 * 16, 7, np.uint8)
    with pytest.raises(ValueError):
        JA.try_encode_quantize_stereo(img, jax_out, lut, 16, 40, 16, None,
                                      spill=True, backend="xla")
    out = np.full(48 * 16, 7, np.uint8)
    assert A.try_encode_quantize_stereo(img, out, lut, 16, 40, 16, None,
                                        spill=True, **CPU) \
        == T.SimdDctResult.SUCCESS
    full = T.encode_quantize_stereo(img, lut, spill=True, **CPU).numpy()
    mask = A._strip_byte_mask(40, 16, 16, None, spill=True,
                              view_layout="interleaved")
    assert mask.shape == (48 * 16,) and mask.any() and not mask.all()
    np.testing.assert_array_equal(out[mask], full[mask])
    assert (out[~mask] == 7).all()


# -- api: errors, device rule, streams across packages -----------------------

def _planar_zeros(h, w, vl="planar", dtype=np.uint8):
    bw = T_stereo.native_stereo_bwp(w) if vl == "native" else w // 8
    return np.zeros((2, 64, h // 16, bw), dtype)


BAD_CALLS = {
    "encode_view_layout": (lambda m: m.encode_quantize_stereo(
        _img(32, 64), _lut(), view_layout="stacked")),
    "encode_h": (lambda m: m.encode_quantize_stereo(_img(40, 64), _lut())),
    "encode_w8": (lambda m: m.encode_quantize_stereo(_img(32, 60), _lut())),
    "encode_rounding": (lambda m: m.encode_quantize_stereo(
        _img(32, 64), _lut(), rounding="up")),
    "encode_dtype": (lambda m: m.encode_quantize_stereo(
        _img(32, 64).astype(np.int16), _lut())),
    "decode_view_layout": (lambda m: m.decode_quantize_stereo(
        np.zeros(32 * 64, np.uint8), _lut(), 64, 32, view_layout="stacked")),
    "decode_planar_shape": (lambda m: m.decode_quantize_stereo(
        _planar_zeros(32, 72), _lut(), 64, 32, view_layout="planar")),
    "decode_native_shape": (lambda m: m.decode_quantize_stereo(
        _planar_zeros(32, 64), _lut(), 64, 32, view_layout="native")),
    "decode_planar_dtype": (lambda m: m.decode_quantize_stereo(
        _planar_zeros(32, 64, dtype=np.int16), _lut(), 64, 32,
        view_layout="planar")),
    "decode_dtype": (lambda m: m.decode_quantize_stereo(
        np.zeros(32 * 64, np.int16), _lut(), 64, 32)),
    "decode_length": (lambda m: m.decode_quantize_stereo(
        np.zeros(32 * 64 + 3, np.uint8), _lut(), 64, 32)),
    "decode_h": (lambda m: m.decode_quantize_stereo(
        np.zeros(40 * 64, np.uint8), _lut(), 64, 40)),
}


class _PortOnCpu:
    """The port's api with device="cpu" on every call."""
    def __getattr__(self, name):
        fn = getattr(T, name)
        return lambda *a, **kw: fn(*a, device="cpu", **kw)


@pytest.mark.parametrize("case", sorted(BAD_CALLS))
def test_typed_errors_match_jax(case):
    with pytest.raises(J.SimdDctError) as jexc:
        BAD_CALLS[case](J)
    with pytest.raises(getattr(T, type(jexc.value).__name__)):
        BAD_CALLS[case](_PortOnCpu())


def test_compat_and_device_rule(monkeypatch):
    """compat=True routes stereo encode and decode, planar form included,
    to the strict-IEEE tier and equals it and the JAX compat tier byte for
    byte; and numpy input with no device needs the card."""
    from simd_dct_tpu_torch.kernels import compat as TC
    img = _img(32, 64)
    rec = T.encode_quantize_stereo(img, _lut(), compat=True,
                                   view_layout="planar", **CPU)
    np.testing.assert_array_equal(rec.numpy(), TC.encode_quantize_stereo(
        torch.from_numpy(img), _lut(), view_layout="planar").numpy())
    np.testing.assert_array_equal(rec.numpy(), np.asarray(
        J.encode_quantize_stereo(img, _lut(), compat=True, backend="xla",
                                 view_layout="planar")))
    dec = T.decode_quantize_stereo(rec.numpy(), _lut(), 64, 32,
                                   view_layout="planar", compat=True, **CPU)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(
        J.decode_quantize_stereo(rec.numpy(), _lut(), 64, 32, compat=True,
                                 backend="xla", view_layout="planar")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "encode": lambda **kw: T.encode_quantize_stereo(_img(32, 64), _lut(),
                                                        **kw),
        "decode": lambda **kw: T.decode_quantize_stereo(
            np.zeros(32 * 64, np.uint8), _lut(), 64, 32, **kw),
        "decode_native": lambda **kw: T.decode_quantize_stereo(
            _planar_zeros(32, 64, "native"), _lut(), 64, 32,
            view_layout="native", **kw),
        "convert": lambda **kw: convert.stereo_records_from_numpy(
            _planar_zeros(32, 64), 64, 32, "planar", **kw),
    }
    for name, call in calls.items():
        with pytest.raises(T.NotSupportedError, match='device="cpu"'):
            call()
        assert call(device="cpu").device.type == "cpu", name


@pytest.mark.parametrize("vl", VIEW_LAYOUTS)
def test_streams_cross_between_packages(vl):
    """A stereo stream written by either package goes through ``convert``
    unchanged and decodes in the other."""
    img, lut = _img(64, 200, seed=13), _lut("jpeg")
    jax_rec = _jax_enc(img, lut, vl=vl)
    t = convert.stereo_records_from_numpy(jax_rec, 200, 64, vl, **CPU)
    np.testing.assert_array_equal(convert.records_to_numpy(t), jax_rec)
    _assert_contract({
        "port(jax records)": T.decode_quantize_stereo(t, lut, 200, 64,
                                                      view_layout=vl),
        "jax(jax records)": J.decode_quantize_stereo(jax_rec, lut, 200, 64,
                                                     view_layout=vl,
                                                     backend="xla")})
    port_rec = convert.records_to_numpy(
        T.encode_quantize_stereo(img, lut, view_layout=vl, **CPU))
    _assert_contract({
        "jax(port records)": J.decode_quantize_stereo(port_rec, lut, 200, 64,
                                                      view_layout=vl,
                                                      backend="xla"),
        "port(port records)": T.decode_quantize_stereo(
            port_rec, lut, 200, 64, view_layout=vl, **CPU)})
    with pytest.raises(ValueError):
        convert.stereo_records_from_numpy(jax_rec[..., 1:], 200, 64, vl,
                                          **CPU)


def test_stereo_records_from_numpy_checks():
    flat = np.zeros((2, 32 * 64), np.uint8)
    assert convert.stereo_records_from_numpy(flat, 64, 32, **CPU).shape \
        == (2, 32 * 64)
    assert convert.stereo_records_from_numpy(flat[0], 64, 32, **CPU).shape \
        == (32 * 64,)
    with pytest.raises(ValueError):
        convert.stereo_records_from_numpy(flat.astype(np.int16), 64, 32,
                                          **CPU)
    with pytest.raises(ValueError):
        convert.stereo_records_from_numpy(_planar_zeros(32, 64), 64, 32,
                                          "stacked", **CPU)
    nat = np.zeros((3, 2, 64, 2, 128), np.uint8)
    assert convert.stereo_records_from_numpy(nat, 64, 32, "native",
                                             **CPU).shape == nat.shape


def test_wrappers_on_cpu_take_the_plain_version():
    img = torch.from_numpy(_img(48, 200, seed=14, frames=2))
    before = dict(K.LAUNCHES)
    for vl in VIEW_LAYOUTS:
        rec = K.encode_quantize_stereo(img, _lut(), 16, 1 << 40, "scalar", vl)
        np.testing.assert_array_equal(rec.numpy(), TP.encode_quantize_stereo(
            img, _lut(), 16, 1 << 40, "scalar", vl).numpy())
        assert K.decode_quantize_stereo(rec, _lut(), 200, 48, vl).shape \
            == (2, 48, 200)
        with pytest.raises(ValueError):
            K.decode_quantize_stereo(rec[..., 1:].contiguous(), _lut(), 200,
                                     48, vl)
    assert K.LAUNCHES == before
    assert K.supports_mode("enc_quant_stereo", 48, 200)
    assert not K.supports_mode("dec_quant_stereo", 40, 200)
    with pytest.raises(ValueError):
        K.encode_quantize_stereo(torch.from_numpy(_img(40, 64)), _lut())
    with pytest.raises(ValueError):
        K.encode_quantize_stereo(img, _lut(), view_layout="stacked")
    with pytest.raises(TypeError):
        K.decode_quantize_stereo(rec.numpy(), _lut(), 200, 48, "native")
