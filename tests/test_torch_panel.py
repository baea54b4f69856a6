"""The port's panel engine (``kernels/panel.py``) and tile wrappers on the
CPU, against the JAX package.

References: ``simd_dct_tpu/kernels/panel.py`` (the bases, ``q_tile``,
``forward_tiles`` / ``inverse_tiles`` and the ten converters) and the
Pallas tile kernels ``_tiles_panels`` / ``_detile_panels`` in interpret
mode at ``precision="f32"``, at 128x128 and 256x384 (P = 2, NJ = 3).
Inputs come from numpy with a seed; the LUT is the CLI's JPEG table
(asymmetric, so a transposed scale index shows).  Tolerances:
  * the bases and ``q_tile``: bit-identical;
  * tiles and pixels: at most +-1 on at most 0.2% of bytes
    (``compare_backends``), the sums being taken in another order;
  * converters and the byte layouts they produce: exact.
The kernel-against-plain cases need the card and live in
``tests/test_torch_cuda.py`` (run there without jax).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_dct_tpu.core import quantize as J_q
from simd_dct_tpu.kernels import pallas_dct as PK
from simd_dct_tpu.kernels import panel as JP
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import convert
from simd_dct_tpu_torch.core.quantize import dequant_scales, quant_scales
from simd_dct_tpu_torch.kernels import cuda_dct as K
from simd_dct_tpu_torch.kernels import panel as TPn
from simd_dct_tpu_torch.kernels import torch_path as TP
from simd_dct_tpu_torch.utils.debug import compare_backends

GEOMETRIES = [(128, 128), (256, 384)]
ROUNDINGS = ("rne", "scalar", "clamp_first")
# (normalize, orientation): mode32 is raw + fy, enc-quant normalized + fx,
# stereo normalized + fy; raw + fx completes the grid
CONFIGS = [(False, "fy"), (True, "fx"), (True, "fy"), (False, "fx")]


def _view(h2, w, seed=0, lead=()):
    return np.random.default_rng(seed).integers(0, 256, (*lead, h2, w),
                                                np.uint8)


def _lut(normalize):
    lut = T.default_quant_lut(50)
    return lut if normalize else lut * np.float32(255.0)


def _scales(normalize):
    """(q, qi): the port's scales as numpy f32 (bit-identical to JAX's)."""
    lut = _lut(normalize)
    return quant_scales(lut).numpy(), dequant_scales(lut).numpy()


def _contract(**outs):
    outs = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in outs.items()}
    shapes = {v.shape for v in outs.values()}
    assert len(shapes) == 1, shapes
    bad = {k: v for k, v in compare_backends(outs).items() if not v["ok"]}
    assert not bad, bad


def _port_tiles(view, normalize, orientation, rounding):
    q, _ = _scales(normalize)
    return TPn.forward_tiles(torch.from_numpy(view), q, normalize=normalize,
                             orientation=orientation, rounding=rounding)


def _jax_tiles(view, normalize, orientation, rounding):
    q, _ = _scales(normalize)
    return np.array(JP.forward_tiles(
        jnp.asarray(view), jnp.asarray(q), normalize=normalize,
        orientation=orientation, rounding=rounding))


# -- bases and scales --------------------------------------------------------

def test_bases_bit_identical():
    assert TPn.row_basis_np().tobytes() == JP.row_basis_np().tobytes()
    assert TPn.col_basis_np().tobytes() == JP.col_basis_np().tobytes()


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("orientation", ["fy", "fx"])
def test_q_tile_bit_identical(orientation, normalize):
    lut = _lut(normalize)
    q = quant_scales(lut).numpy()
    assert q.tobytes() == np.asarray(J_q.quant_scales(lut)).tobytes()
    assert TPn.q_tile(q, orientation).numpy().tobytes() == \
        np.asarray(JP.q_tile(q, orientation)).tobytes()
    assert torch.equal(TPn.q_tile(torch.from_numpy(q), orientation),
                       TPn.q_tile(q, orientation))


def test_supports_and_orientation_checks():
    assert TPn.supports(128, 128) and TPn.supports(256, 384)
    assert not TPn.supports(64, 128) and not TPn.supports(128, 192)
    assert not TPn.supports(0, 128)
    with pytest.raises(ValueError):
        TPn.q_tile(np.ones(64, np.float32), "fz")
    with pytest.raises(ValueError):
        TPn.forward_tiles(torch.zeros(64, 128, dtype=torch.uint8),
                          np.ones(64, np.float32), normalize=False,
                          orientation="fy", rounding="rne")


# -- forward / inverse against the JAX plain engine and Pallas interpret ---

@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("normalize,orientation", CONFIGS)
@pytest.mark.parametrize("h2,w", GEOMETRIES)
def test_forward_tiles_matches_jax(h2, w, normalize, orientation, rounding):
    view = _view(h2, w, seed=h2 + w)
    got = _port_tiles(view, normalize, orientation, rounding)
    assert got.shape == (h2 // 128, 128, w // 128, 128)
    _contract(port=got, jax=_jax_tiles(view, normalize, orientation,
                                       rounding))


@functools.lru_cache(maxsize=None)
def _pallas_tiles(normalize, orientation, rounding):
    """The Pallas tile kernel in interpret mode at f32 on the 256x384 view."""
    q, _ = _scales(normalize)
    return np.array(PK._tiles_panels(
        jnp.asarray(_view(256, 384, seed=7)), jnp.asarray(q),
        normalize=normalize, rounding=rounding, orientation=orientation,
        interpret=True, precision="f32"))


@pytest.mark.parametrize("rounding", ROUNDINGS)
@pytest.mark.parametrize("normalize,orientation", CONFIGS[:3])
def test_forward_tiles_matches_pallas_interpret(normalize, orientation,
                                                rounding):
    got = _port_tiles(_view(256, 384, seed=7), normalize, orientation,
                      rounding)
    _contract(port=got, pallas=_pallas_tiles(normalize, orientation,
                                             rounding))


@pytest.mark.parametrize("normalize,orientation", CONFIGS)
@pytest.mark.parametrize("h2,w", GEOMETRIES)
def test_inverse_tiles_matches_jax(h2, w, normalize, orientation):
    """The same tiles (the JAX engine's) back to pixels in both packages."""
    tiles = _jax_tiles(_view(h2, w, seed=3), normalize, orientation, "rne")
    _, qi = _scales(normalize)
    got = TPn.inverse_tiles(torch.from_numpy(tiles), qi, normalize=normalize,
                            orientation=orientation)
    assert got.shape == (h2, w)
    _contract(port=got, jax=JP.inverse_tiles(
        jnp.asarray(tiles), jnp.asarray(qi), normalize=normalize,
        orientation=orientation))


@pytest.mark.parametrize("normalize,orientation", CONFIGS[:3])
def test_inverse_tiles_matches_pallas_interpret(normalize, orientation):
    tiles = _pallas_tiles(normalize, orientation, "rne")
    _, qi = _scales(normalize)
    got = TPn.inverse_tiles(torch.from_numpy(tiles), qi, normalize=normalize,
                            orientation=orientation)
    _contract(port=got, pallas=PK._detile_panels(
        jnp.asarray(tiles), jnp.asarray(qi), normalize=normalize,
        orientation=orientation, interpret=True, precision="f32"))


def test_forward_tiles_takes_leading_axes():
    views = _view(128, 256, seed=4, lead=(2, 3))
    q, qi = _scales(True)
    got = TPn.forward_tiles(torch.from_numpy(views), q, normalize=True,
                            orientation="fy", rounding="rne")
    assert got.shape == (2, 3, 1, 128, 2, 128)
    for i in range(2):
        for j in range(3):
            assert torch.equal(got[i, j], _port_tiles(views[i, j], True,
                                                      "fy", "rne"))
    back = TPn.inverse_tiles(got, qi, normalize=True, orientation="fy")
    assert back.shape == views.shape


# -- the ten converters: byte-exact against the JAX ones --------------------

def _tiles_u8(h2, w, seed, lead=()):
    """Random bytes in the tile shape: the converters are permutations."""
    return np.random.default_rng(seed).integers(
        0, 256, (*lead, h2 // 128, 128, w // 128, 128), np.uint8)


CONVERTERS = {
    "group8": (TPn.tiles_to_group8, TPn.group8_to_tiles,
               JP.tiles_to_group8, JP.group8_to_tiles),
    "block_contiguous": (TPn.tiles_to_block_contiguous,
                         TPn.block_contiguous_to_tiles,
                         JP.tiles_to_block_contiguous,
                         JP.block_contiguous_to_tiles),
    "pair": (TPn.tiles_to_pair, TPn.pair_to_tiles, JP.tiles_to_pair,
             JP.pair_to_tiles),
}


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("name", sorted(CONVERTERS))
def test_converters_byte_exact(name, batched):
    to_rec, from_rec, j_to, j_from = CONVERTERS[name]
    h2, w = 256, 384
    lead = (2,) if batched else ()
    tiles = _tiles_u8(h2, w, seed=11, lead=lead)
    rec = to_rec(torch.from_numpy(tiles))
    assert rec.shape == (*lead, h2 * w)
    back = from_rec(rec, h2, w)
    assert back.shape == tiles.shape and np.array_equal(back.numpy(), tiles)
    for i, t in enumerate(tiles.reshape(-1, *tiles.shape[-4:])):
        want = np.asarray(j_to(jnp.asarray(t)))
        np.testing.assert_array_equal(rec.reshape(-1, h2 * w)[i].numpy(),
                                      want)
        np.testing.assert_array_equal(
            np.asarray(j_from(jnp.asarray(want), h2, w)), t)


@pytest.mark.parametrize("batched", [False, True])
def test_planar_converters_byte_exact(batched):
    h2, w = 256, 384
    lead = (2,) if batched else ()
    tiles_lr = _tiles_u8(h2, w, seed=12, lead=(*lead, 2))
    flat = TPn.tiles_to_planar(torch.from_numpy(tiles_lr))
    assert flat.shape == (*lead, 2 * h2 * w)
    back = TPn.planar_to_tiles(flat, h2, w)
    assert np.array_equal(back.numpy(), tiles_lr)
    for i, t in enumerate(tiles_lr.reshape(-1, 2, *tiles_lr.shape[-4:])):
        want = np.asarray(JP.tiles_to_planar(jnp.asarray(t)))
        np.testing.assert_array_equal(flat.reshape(-1, 2 * h2 * w)[i].numpy(),
                                      want)
        np.testing.assert_array_equal(
            np.asarray(JP.planar_to_tiles(jnp.asarray(want), h2, w)), t)
    with pytest.raises(ValueError):
        TPn.tiles_to_planar(torch.from_numpy(tiles_lr[..., :1, :, :, :, :]))


# -- the hybrid route on the CPU: tiles + converter == the mode's encode ----

def _dual(h2, w, seed, frames=None):
    lead = () if frames is None else (frames,)
    return _view(2 * h2, w, seed=seed, lead=lead)


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_group8_of_tiles_matches_encode32_view(rounding):
    view = torch.from_numpy(_view(256, 384, seed=21))
    got = TPn.tiles_to_group8(_port_tiles(view.numpy(), False, "fy",
                                          rounding))
    _contract(hybrid=got, encode32=TP.encode32_view(view, _lut(False),
                                                    rounding))


@pytest.mark.parametrize("layout", ["scalar", "pair"])
def test_hybrid_enc_quant_matches_encode_quantize(layout):
    img = _dual(256, 384, seed=22, frames=2)
    tiles = TPn.forward_tiles(torch.from_numpy(img[:, :256]).contiguous(),
                              _scales(True)[0], normalize=True,
                              orientation="fx", rounding="rne")
    conv = (TPn.tiles_to_block_contiguous if layout == "scalar"
            else TPn.tiles_to_pair)
    _contract(hybrid=conv(tiles), encq=TP.encode_quantize(
        torch.from_numpy(img), _lut(True), layout=layout))


def test_hybrid_stereo_matches_encode_quantize_stereo():
    img = _dual(128, 256, seed=23)
    views = torch.from_numpy(img).reshape(2, 128, 256)
    tiles = TPn.forward_tiles(views, _scales(True)[0], normalize=True,
                              orientation="fy", rounding="rne")
    _contract(hybrid=TPn.tiles_to_planar(tiles),
              stereo=TP.encode_quantize_stereo(torch.from_numpy(img),
                                               _lut(True)))


# -- tiles_from_numpy and the wrappers on the CPU ---------------------------

def test_tiles_from_numpy():
    jax_tiles = _jax_tiles(_view(256, 384, seed=5), False, "fy", "rne")
    t = convert.tiles_from_numpy(jax_tiles, 256, 384, device="cpu")
    assert t.shape == (2, 128, 3, 128) and t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), jax_tiles)
    batch = np.stack([jax_tiles, jax_tiles[::-1]])
    assert convert.tiles_from_numpy(batch, 256, 384, device="cpu").shape == \
        (2, 2, 128, 3, 128)
    _, qi = _scales(False)
    _contract(port=K.detile_panels(t, qi, normalize=False, orientation="fy"),
              jax=JP.inverse_tiles(jnp.asarray(jax_tiles), jnp.asarray(qi),
                                   normalize=False, orientation="fy"))
    for bad, h2, w in [(jax_tiles, 128, 384), (jax_tiles[..., :64], 256, 384),
                       (jax_tiles.astype(np.int16), 256, 384),
                       (jax_tiles, 200, 384)]:
        with pytest.raises(ValueError):
            convert.tiles_from_numpy(bad, h2, w, device="cpu")


def test_tile_wrappers_on_cpu_take_the_plain_version():
    view = torch.from_numpy(_view(256, 384, seed=6, lead=(2,)))
    q, qi = _scales(True)
    before = dict(K.LAUNCHES)
    tiles = K.tiles_panels(view, torch.from_numpy(q), normalize=True,
                           rounding="scalar", orientation="fx")
    assert torch.equal(tiles, TPn.forward_tiles(
        view, q, normalize=True, orientation="fx", rounding="scalar"))
    px = K.detile_panels(tiles, qi, normalize=True, orientation="fx")
    assert torch.equal(px, TPn.inverse_tiles(tiles, qi, normalize=True,
                                             orientation="fx"))
    assert K.LAUNCHES == before
    assert "tiles" in K.LAUNCHES and "detile" in K.LAUNCHES
    assert not K.supports_mode("tiles", 256, 384)


@pytest.mark.parametrize("case", ["geometry", "orientation", "rounding",
                                  "scales", "dtype", "tile_shape"])
def test_tile_wrappers_reject_bad_calls(case):
    view = torch.zeros(256, 384, dtype=torch.uint8)
    tiles = torch.zeros(2, 128, 3, 128, dtype=torch.uint8)
    q = np.ones(64, np.float32)
    calls = {
        "geometry": lambda: K.tiles_panels(
            view[:, :320].contiguous(), q, normalize=False, rounding="rne",
            orientation="fy"),
        "orientation": lambda: K.detile_panels(
            tiles, q, normalize=False, orientation="yx"),
        "rounding": lambda: K.tiles_panels(
            view, q, normalize=False, rounding="up", orientation="fy"),
        "scales": lambda: K.tiles_panels(
            view, q[:63], normalize=False, rounding="rne", orientation="fy"),
        "dtype": lambda: K.tiles_panels(
            view.to(torch.int16), q, normalize=False, rounding="rne",
            orientation="fy"),
        "tile_shape": lambda: K.detile_panels(
            tiles[..., :64].contiguous(), q, normalize=False,
            orientation="fy"),
    }
    with pytest.raises((ValueError, TypeError)):
        calls[case]()
