"""The port's plain enc-quant path against the JAX package.

References: the JAX ``xla`` tier, the Pallas kernels in interpret mode at
f32 (at 256x512, the smallest width the pair pipeline takes) and the NumPy
golden model.  Inputs are made with numpy from a seed; LUTs are the CLI's
JPEG-luma table or a seeded random table, never a symmetric one (the
fx-major buffer transposes the LUT's index).  Tolerances:
  * encode records and decoded pixels (of the SAME records): at most +-1,
    on at most 0.2% of bytes -- the ``compare_backends`` contract;
  * layout permutations, zeroed-strip positions, as-written spill
    positions and the try_* write masks: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu import api as JA
from simd_dct_tpu.core import golden as G
from simd_dct_tpu.kernels import pallas_dct as PK
from simd_dct_tpu.kernels import xla_path as XP
from simd_dct_tpu.layout import reorder as J_reorder
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import api as A
from simd_dct_tpu_torch import convert
from simd_dct_tpu_torch.kernels import cuda_dct as K
from simd_dct_tpu_torch.kernels import torch_path as TP
from simd_dct_tpu_torch.layout import reorder as T_reorder
from simd_dct_tpu_torch.utils.debug import compare_backends

LAYOUTS = ("scalar", "pair", "pair_as_written")
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


def _port_enc(img, lut, sy=0, ey=FULL, rounding="rne", layout="scalar",
              legacy=False):
    return TP.encode_quantize(torch.from_numpy(img), lut, sy, ey, rounding,
                              layout, legacy).numpy()


def _xla_enc(img, lut, sy=0, ey=FULL, rounding="rne", layout="scalar",
             legacy=False):
    return np.asarray(XP.encode_quantize(jnp.asarray(img), jnp.asarray(lut),
                                         sy, ey, rounding, layout, legacy))


# -- layouts ---------------------------------------------------------------

@pytest.mark.parametrize("as_written", [False, True])
def test_pair_cell_permutation_equals_golden(as_written):
    got = T_reorder.pair_cell_permutation(as_written)
    np.testing.assert_array_equal(got, G.pair_cell_permutation(as_written))
    # the byte offset spelled out: p = i*8 + j, half = (j >> 1) & 1
    i, j = divmod(45, 8)
    base = 128 if as_written else 64
    assert got[1, 45] == ((j >> 1) & 1) * base + i * 8 + 4 + (j // 4) * 2 \
        + j % 2


def test_layout_transforms_match_jax():
    rng = np.random.default_rng(3)
    bufs = rng.integers(0, 256, (2, 3, 4, 64), np.uint8)    # (B, S, BW, 64)
    t = torch.from_numpy(bufs)
    pair = T_reorder.pair_cells(t).numpy()
    scal = T_reorder.block_contiguous(t).numpy()
    assert pair.shape == scal.shape == (2, 3 * 4 * 64)
    for b in range(2):
        np.testing.assert_array_equal(
            pair[b], np.asarray(J_reorder.pair_cells(jnp.asarray(bufs[b]))))
        np.testing.assert_array_equal(
            scal[b],
            np.asarray(J_reorder.block_contiguous(jnp.asarray(bufs[b]))))
    np.testing.assert_array_equal(
        T_reorder.pair_cells_inverse(torch.from_numpy(pair), 4).numpy(), bufs)
    np.testing.assert_array_equal(
        T_reorder.block_contiguous_inverse(torch.from_numpy(scal), 4).numpy(),
        bufs)
    c = rng.normal(size=(2, 5, 8, 8)).astype(np.float32)
    buf = T_reorder.coeffs_to_buffer(torch.from_numpy(c), "fx").numpy()
    np.testing.assert_array_equal(
        buf, np.asarray(J_reorder.coeffs_to_buffer(jnp.asarray(c), "fx")))
    assert buf[0, 0, 8 * 3 + 5] == c[0, 0, 5, 3]     # buffer[p] = C[p%8][p//8]
    np.testing.assert_array_equal(
        T_reorder.buffer_to_coeffs(torch.from_numpy(buf), "fx").numpy(), c)
    with pytest.raises(ValueError):
        T_reorder.coeffs_to_buffer(torch.from_numpy(c), "fz")


@pytest.mark.parametrize("mask", [[1, 1, 1, 1], [0, 1, 0, 0], [1, 0, 1, 0],
                                  [0, 0, 1, 1], [1, 1, 0, 0]])
def test_pair_as_written_masked_matches_jax(mask):
    mask = np.array(mask, bool)
    flat = np.random.default_rng(4).integers(1, 256, (2, 4 * 512), np.uint8)
    got = T_reorder.pair_as_written_masked(torch.from_numpy(flat), mask,
                                           512).numpy()
    for b in range(2):
        np.testing.assert_array_equal(
            got[b], np.asarray(J_reorder.pair_as_written_masked(
                jnp.asarray(flat[b]), mask, 512)))


# -- encode / decode against xla, golden and Pallas interpret ---------------

ENCODE_CASES = [(h, w, lut, layout, r)
                for (h, w, lut) in [(64, 128, "jpeg"), (48, 80, "random")]
                for layout in LAYOUTS for r in ROUNDINGS] + \
               [(32, 72, "jpeg", "scalar", r) for r in ROUNDINGS]


@pytest.mark.parametrize("h,w,lut_kind,layout,rounding", ENCODE_CASES)
def test_encode_matches_jax(h, w, lut_kind, layout, rounding):
    img, lut = _img(h, w, seed=h + w), _lut(lut_kind)
    port = _port_enc(img, lut, rounding=rounding, layout=layout)
    assert port.shape == (h // 2 * w,) and port.dtype == np.uint8
    _assert_contract({
        "port": port,
        "xla": _xla_enc(img, lut, rounding=rounding, layout=layout),
        "golden": G.encode_quantize_golden(img, lut, 0, FULL,
                                           rounding=rounding, layout=layout,
                                           legacy_range=False),
    })
    if layout == "pair_as_written":
        assert not port.reshape(-1, 2, 64)[:, 1].any()


@pytest.mark.parametrize("h,w,lut_kind,layout", [
    (64, 128, "jpeg", "scalar"), (64, 128, "random", "pair"),
    (48, 80, "jpeg", "pair"), (32, 72, "random", "scalar")])
def test_decode_same_records_matches_jax(h, w, lut_kind, layout):
    img, lut = _img(h, w, seed=5), _lut(lut_kind)
    rec = G.encode_quantize_golden(img, lut, layout=layout,
                                   legacy_range=False)
    port = TP.decode_quantize(torch.from_numpy(rec), lut, w, h, layout)
    assert port.shape == (h // 2, w) and port.dtype == torch.uint8
    _assert_contract({
        "port": port,
        "xla": XP.decode_quantize(jnp.asarray(rec), jnp.asarray(lut), w, h,
                                  layout),
        "golden": G.decode_quantize_golden(rec, lut, w, h, layout=layout),
    })


@pytest.mark.parametrize("layout,rounding", [
    ("scalar", "scalar"), ("pair", "rne"), ("pair_as_written", "clamp_first")])
def test_matches_pallas_interpret(layout, rounding):
    img, lut = _img(256, 512, seed=6), _lut("random")
    port = _port_enc(img, lut, rounding=rounding, layout=layout)
    _assert_contract({
        "port": port,
        "pallas": PK.encode_quantize(jnp.asarray(img), lut, 0, FULL,
                                     rounding, layout, interpret=True,
                                     precision="f32"),
    })
    if layout == "pair_as_written":
        return
    rec = G.encode_quantize_golden(img, lut, layout=layout,
                                   legacy_range=False)
    _assert_contract({
        "port": TP.decode_quantize(torch.from_numpy(rec), lut, 512, 256,
                                   layout),
        "pallas": PK.decode_quantize(rec, lut, 512, 256, layout,
                                     interpret=True, precision="f32"),
    })


# -- strip ranges, try_*, spill ---------------------------------------------

RANGES = [(16, 16, False), (16, 47, False), (0, 20, True), (24, 40, True),
          (-5, 5, False)]


@pytest.mark.parametrize("sy,ey,legacy", RANGES)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_strip_range_matches_jax(layout, sy, ey, legacy):
    """Zeroed bytes and as-written spill bytes sit where the JAX xla tier
    puts them, exactly; the values agree within the contract."""
    img, lut = _img(128, 64, seed=7), _lut("random")
    port = _port_enc(img, lut, sy, ey, layout=layout, legacy=legacy)
    want = _xla_enc(img, lut, sy, ey, layout=layout, legacy=legacy)
    np.testing.assert_array_equal(port == 0, want == 0)
    _assert_contract({"port": port, "xla": want})
    mask = TP._strip_mask(8, sy, ey, legacy)
    assert not mask.all() and mask.any()
    strips = port.reshape(8, -1)
    assert not strips[~mask][:, 64:].any()
    spill = np.zeros(8, bool)
    spill[1:] = mask[:-1] & ~mask[1:]
    if layout == "pair_as_written" and spill.any():
        full = _port_enc(img, lut, layout="pair")
        np.testing.assert_array_equal(
            strips[spill, :64], full.reshape(8, -1)[np.roll(spill, -1), -64:])
    else:
        assert not strips[~mask].any()


@pytest.mark.parametrize("layout,legacy", [("scalar", True),
                                           ("pair", False),
                                           ("pair_as_written", False),
                                           ("pair_as_written", True)])
def test_try_encode_quantize_leaves_the_same_bytes_as_jax(layout, legacy):
    img, lut = _img(128, 64, seed=8), _lut("jpeg")
    kw = {"layout": layout, "legacy_range": legacy}
    port_out = np.full(64 * 64, 7, np.uint8)
    jax_out = port_out.copy()
    for sy, ey in [(16, 31), (48, 200)]:
        assert A.try_encode_quantize(img, port_out, lut, 64, 128, sy, ey,
                                     **kw, **CPU) == T.SimdDctResult.SUCCESS
        assert JA.try_encode_quantize(img, jax_out, lut, 64, 128, sy, ey,
                                      backend="xla", **kw) \
            == J.SimdDctResult.SUCCESS
        m = A._strip_byte_mask(128, 64, sy, ey, legacy_range=legacy,
                               pair_spill=layout == "pair_as_written")
        np.testing.assert_array_equal(m, JA._strip_byte_mask(
            "quant", 128, 64, sy, ey, legacy,
            pair_spill=layout == "pair_as_written"))
    untouched = port_out == 7
    np.testing.assert_array_equal(untouched, jax_out == 7)
    assert untouched.any() and not untouched.all()
    _assert_contract({"port": port_out, "jax": jax_out})
    bad = np.full_like(port_out, 7)
    assert A.try_encode_quantize(img, bad, lut[:5], 64, 128, 0, None, **CPU) \
        == T.SimdDctResult.INVALID_PARAMETER
    assert A.try_encode_quantize(_img(128, 72), bad, lut, 72, 128, 0, None,
                                 layout="pair", **CPU) \
        == T.SimdDctResult.NOT_SUPPORTED
    assert (bad == 7).all()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spill_matches_jax(layout):
    img, lut = _img(72, 64, seed=9), _lut("jpeg")
    port = T.encode_quantize(img, lut, layout=layout, spill=True, **CPU)
    want = np.asarray(J.encode_quantize(img, lut, layout=layout, spill=True,
                                        backend="xla"))
    assert port.shape == want.shape == (40 * 64,)
    _assert_contract({"port": port, "jax": want})


# -- api: batches, streams across packages, errors ---------------------------

def test_batch_equals_frames_and_jax():
    frames, lut = _img(64, 128, seed=10, frames=3), _lut("random")
    for layout in ("scalar", "pair"):
        port = T.encode_quantize(frames, lut, layout=layout, **CPU)
        assert port.shape == (3, 32 * 128)
        for i in range(3):
            np.testing.assert_array_equal(
                port[i].numpy(),
                T.encode_quantize(frames[i], lut, layout=layout,
                                  **CPU).numpy())
        jax_rec = np.asarray(J.encode_quantize(frames, lut, layout=layout,
                                               backend="xla"))
        _assert_contract({"port": port, "jax": jax_rec})
        dec = T.decode_quantize(jax_rec, lut, 128, 64, layout=layout, **CPU)
        assert dec.shape == (3, 32, 128)
        for i in range(3):
            np.testing.assert_array_equal(
                dec[i].numpy(), T.decode_quantize(jax_rec[i], lut, 128, 64,
                                                  layout=layout,
                                                  **CPU).numpy())
        _assert_contract({"port": dec, "jax": J.decode_quantize(
            jax_rec, lut, 128, 64, layout=layout, backend="xla")})


@pytest.mark.parametrize("layout", ["scalar", "pair"])
def test_streams_cross_between_packages(layout):
    """An enc-quant stream written by either package goes through
    ``convert`` unchanged and decodes in the other."""
    img, lut = _img(64, 96, seed=11), _lut("jpeg")
    jax_rec = _xla_enc(img, lut, layout=layout)
    t = convert.records_from_numpy(jax_rec, 96, 64, **CPU)
    assert t.shape == (32 * 96,)
    np.testing.assert_array_equal(convert.records_to_numpy(t), jax_rec)
    _assert_contract({
        "port(jax records)": T.decode_quantize(t, lut, 96, 64,
                                               layout=layout),
        "jax(jax records)": XP.decode_quantize(jnp.asarray(jax_rec),
                                               jnp.asarray(lut), 96, 64,
                                               layout)})
    port_rec = convert.records_to_numpy(
        T.encode_quantize(img, lut, layout=layout, **CPU))
    _assert_contract({
        "jax(port records)": XP.decode_quantize(jnp.asarray(port_rec),
                                                jnp.asarray(lut), 96, 64,
                                                layout),
        "port(port records)": T.decode_quantize(port_rec, lut, 96, 64,
                                                layout=layout, **CPU)})


BAD_CALLS = {
    "encode_layout": (lambda m: m.encode_quantize(_img(32, 64), _lut(),
                                                  layout="planar")),
    "encode_pair_w": (lambda m: m.encode_quantize(_img(32, 72), _lut(),
                                                  layout="pair")),
    "encode_aw_w": (lambda m: m.encode_quantize(_img(32, 72), _lut(),
                                                layout="pair_as_written")),
    "encode_h": (lambda m: m.encode_quantize(_img(40, 64), _lut())),
    "encode_w8": (lambda m: m.encode_quantize(_img(32, 60), _lut())),
    "encode_rounding": (lambda m: m.encode_quantize(_img(32, 64), _lut(),
                                                    rounding="up")),
    "encode_lut": (lambda m: m.encode_quantize(_img(32, 64), _lut()[:9])),
    "decode_aw": (lambda m: m.decode_quantize(np.zeros(16 * 64, np.uint8),
                                              _lut(), 64, 32,
                                              layout="pair_as_written")),
    "decode_layout": (lambda m: m.decode_quantize(
        np.zeros(16 * 64, np.uint8), _lut(), 64, 32, layout="group8")),
    "decode_pair_w": (lambda m: m.decode_quantize(
        np.zeros(16 * 72, np.uint8), _lut(), 72, 32, layout="pair")),
    "decode_length": (lambda m: m.decode_quantize(
        np.zeros(16 * 64 + 3, np.uint8), _lut(), 64, 32)),
    "decode_dtype": (lambda m: m.decode_quantize(
        np.zeros(16 * 64, np.int16), _lut(), 64, 32)),
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


def test_compat_raises_until_ported():
    """compat is ported: enc-quant encode and decode with compat=True route
    to the strict-IEEE tier and equal it, the JAX compat tier and the C++
    oracle byte for byte."""
    from simd_dct_tpu import native
    from simd_dct_tpu_torch.kernels import compat as TC
    img = _img(32, 64)
    rec = T.encode_quantize(img, _lut(), layout="pair", compat=True, **CPU)
    np.testing.assert_array_equal(rec.numpy(), TC.encode_quantize(
        torch.from_numpy(img), _lut(), layout="pair").numpy())
    np.testing.assert_array_equal(rec.numpy(), np.asarray(J.encode_quantize(
        img, _lut(), layout="pair", compat=True, backend="xla")))
    np.testing.assert_array_equal(
        rec.numpy(), native.encode_quantize(img, _lut(), layout="pair"))
    dec = T.decode_quantize(rec.numpy(), _lut(), 64, 32, layout="pair",
                            compat=True, **CPU)
    np.testing.assert_array_equal(dec.numpy(), native.decode_quantize(
        rec.numpy(), _lut(), 64, 32, layout="pair"))


def test_wrappers_on_cpu_take_the_plain_version():
    img = torch.from_numpy(_img(64, 80, seed=12, frames=2))
    before = dict(K.LAUNCHES)
    rec = K.encode_quantize(img, _lut(), 16, 1 << 40, "scalar", "pair", True)
    np.testing.assert_array_equal(rec.numpy(), TP.encode_quantize(
        img, _lut(), 16, 1 << 40, "scalar", "pair", True).numpy())
    dec = K.decode_quantize(rec, _lut(), 80, 64, "pair")
    assert dec.shape == (2, 32, 80)
    assert K.LAUNCHES == before
    with pytest.raises(ValueError):
        K.encode_quantize(torch.from_numpy(_img(64, 72)), _lut(),
                          layout="pair")
    with pytest.raises(ValueError):
        K.encode_quantize(img, _lut(), layout="planar")
    with pytest.raises(ValueError):
        K.decode_quantize(rec, _lut(), 80, 64, "pair_as_written")
    with pytest.raises(TypeError):
        K.decode_quantize(rec.numpy(), _lut(), 80, 64)
