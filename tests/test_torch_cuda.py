"""The CUDA kernels against the plain version, and the compat tier, on the
card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false.  The test configuration of this directory imports jax, which the
machine with the card does not have, so run these there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports no jax.
"""

import numpy as np
import pytest
import torch

from simd_dct_tpu_torch import api as sd
from simd_dct_tpu_torch.core.quantize import default_quant_lut
from simd_dct_tpu_torch.kernels import cuda_dct as K
from simd_dct_tpu_torch.kernels import torch_path as TP
from simd_dct_tpu_torch.layout import BASE_CHROMA_QUANT_TABLE
from simd_dct_tpu_torch.utils.debug import compare_backends

pytestmark = pytest.mark.cuda

LUT = default_quant_lut(50) * np.float32(255.0)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _img(gen, *shape):
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device="cuda")


def _ok(a, b):
    rep = compare_backends({"kernel": a, "plain": b})["kernel-vs-plain"]
    assert rep["ok"], rep


@pytest.mark.parametrize("shape", [(256, 192), (272, 64), (3, 1088, 1920)])
@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_enc32_against_plain(gen, shape, rounding):
    img = _img(gen, *shape)
    _ok(K.encode_quantize32(img, LUT, rounding=rounding),
        TP.encode_quantize32(img, LUT, rounding=rounding))


def test_enc32_strip_range_and_int32_clamp(gen):
    img = _img(gen, 512, 128)
    _ok(K.encode_quantize32(img, LUT, 64, 1 << 40),
        TP.encode_quantize32(img, LUT, 64, 1 << 40))
    _ok(K.encode_quantize32(img, LUT, -(1 << 40), 63),
        TP.encode_quantize32(img, LUT, -(1 << 40), 63))


@pytest.mark.parametrize("shape", [(256, 192), (2, 1088, 1920)])
def test_dec32_and_roundtrip(gen, shape):
    img = _img(gen, *shape)
    h, w = shape[-2:]
    rec = TP.encode_quantize32(img, LUT)
    _ok(K.decode_quantize32(rec, LUT, w, h), TP.decode_quantize32(rec, LUT, w, h))
    fused = K.roundtrip_quantize32(img, LUT)
    composed = K.decode_quantize32(K.encode_quantize32(img, LUT), LUT, w, h)
    assert torch.equal(fused, composed)


def test_api_launches_kernels(gen):
    img = _img(gen, 2, 256, 128)
    K.reset_launch_counts()
    rec = sd.encode_quantize32(img, LUT)
    sd.decode_quantize32(rec, LUT, 128, 256)
    sd.roundtrip_quantize32(img, LUT)
    torch.cuda.synchronize()
    assert K.LAUNCHES["enc32"] == K.LAUNCHES["dec32"] == 1
    assert K.LAUNCHES["roundtrip32"] == 1


def test_wrappers_reject_misaligned(gen):
    flat = _img(gen, 256 * 128 + 1)
    with pytest.raises(ValueError):
        K.encode_quantize32(flat[1:].view(256, 128), LUT)
    rec = sd.encode_quantize32(flat[1:].view(256, 128), LUT)   # api realigns
    _ok(rec, TP.encode_quantize32(flat[1:].view(256, 128), LUT))


# -- enc-quant ---------------------------------------------------------------

LUT_Q = default_quant_lut(50)     # enc-quant works in the 1/255 domain
LAYOUTS = ("scalar", "pair", "pair_as_written")


@pytest.mark.parametrize("shape", [(256, 192), (272, 64), (3, 1088, 1920)])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_encq_against_plain(gen, shape, layout, rounding):
    img = _img(gen, *shape)
    _ok(K.encode_quantize(img, LUT_Q, rounding=rounding, layout=layout),
        TP.encode_quantize(img, LUT_Q, rounding=rounding, layout=layout))


def test_encq_scalar_takes_w_mod_16_eq_8(gen):
    img = _img(gen, 2, 64, 72)
    _ok(K.encode_quantize(img, LUT_Q), TP.encode_quantize(img, LUT_Q))
    rec = TP.encode_quantize(img, LUT_Q)
    _ok(K.decode_quantize(rec, LUT_Q, 72, 64),
        TP.decode_quantize(rec, LUT_Q, 72, 64))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("sy,ey,legacy", [(16, 16, False), (32, 95, False),
                                          (0, 20, True), (-(1 << 40), 40, True),
                                          (48, 1 << 40, False)])
def test_encq_strip_ranges(gen, layout, sy, ey, legacy):
    img = _img(gen, 2, 256, 128)
    got = K.encode_quantize(img, LUT_Q, sy, ey, layout=layout,
                            legacy_range=legacy)
    want = TP.encode_quantize(img, LUT_Q, sy, ey, layout=layout,
                              legacy_range=legacy)
    _ok(got, want)
    assert torch.equal(got == 0, want == 0)


def test_encq_layout_identities(gen):
    img = _img(gen, 2, 512, 256)
    scal = K.encode_quantize(img, LUT_Q)
    pair = K.encode_quantize(img, LUT_Q, layout="pair")
    aw = K.encode_quantize(img, LUT_Q, layout="pair_as_written")
    bufs = scal.view(2, 32, 32, 64)
    assert torch.equal(pair, TP.L_reorder.pair_cells(bufs))
    halves = pair.view(2, -1, 2, 64).clone()
    halves[:, :, 1] = 0
    assert torch.equal(aw, halves.view(2, -1))
    assert torch.equal(K.decode_quantize(scal, LUT_Q, 256, 512),
                       K.decode_quantize(pair, LUT_Q, 256, 512, "pair"))


@pytest.mark.parametrize("shape", [(256, 192), (2, 1088, 1920)])
@pytest.mark.parametrize("layout", ["scalar", "pair"])
def test_decq_against_plain(gen, shape, layout):
    img = _img(gen, *shape)
    h, w = shape[-2:]
    rec = TP.encode_quantize(img, LUT_Q, layout=layout)
    _ok(K.decode_quantize(rec, LUT_Q, w, h, layout),
        TP.decode_quantize(rec, LUT_Q, w, h, layout))


def test_api_numpy_input_runs_on_the_card(gen):
    img = _img(gen, 2, 256, 128).cpu().numpy()
    K.reset_launch_counts()
    rec = sd.encode_quantize(img, LUT_Q, layout="pair")
    top = sd.decode_quantize(rec.cpu().numpy(), LUT_Q, 128, 256,
                             layout="pair")
    torch.cuda.synchronize()
    assert rec.device.type == top.device.type == "cuda"
    assert K.LAUNCHES["encq"] == K.LAUNCHES["decq"] == 1
    assert sd.encode_quantize(img, LUT_Q, device="cpu").device.type == "cpu"
    assert K.LAUNCHES["encq"] == 1


# -- stereo ------------------------------------------------------------------

VIEW_LAYOUTS = ("interleaved", "planar", "native")


@pytest.mark.parametrize("shape", [(256, 192), (272, 200), (3, 1088, 1920)])
@pytest.mark.parametrize("view_layout", VIEW_LAYOUTS)
@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_enc_stereo_against_plain(gen, shape, view_layout, rounding):
    img = _img(gen, *shape)
    _ok(K.encode_quantize_stereo(img, LUT_Q, rounding=rounding,
                                 view_layout=view_layout),
        TP.encode_quantize_stereo(img, LUT_Q, rounding=rounding,
                                  view_layout=view_layout))


@pytest.mark.parametrize("shape", [(256, 192), (272, 200), (2, 1088, 1920)])
@pytest.mark.parametrize("view_layout", VIEW_LAYOUTS)
def test_dec_stereo_against_plain(gen, shape, view_layout):
    img = _img(gen, *shape)
    h, w = shape[-2:]
    rec = TP.encode_quantize_stereo(img, LUT_Q, view_layout=view_layout)
    _ok(K.decode_quantize_stereo(rec, LUT_Q, w, h, view_layout),
        TP.decode_quantize_stereo(rec, LUT_Q, w, h, view_layout))


@pytest.mark.parametrize("w", [200, 256])
@pytest.mark.parametrize("view_layout", VIEW_LAYOUTS)
@pytest.mark.parametrize("sy,ey", [(16, 16), (32, 95), (-(1 << 40), 40),
                                   (48, 1 << 40)])
def test_enc_stereo_strip_ranges(gen, w, view_layout, sy, ey):
    img = _img(gen, 2, 256, w)
    got = K.encode_quantize_stereo(img, LUT_Q, sy, ey, view_layout=view_layout)
    want = TP.encode_quantize_stereo(img, LUT_Q, sy, ey,
                                     view_layout=view_layout)
    _ok(got, want)
    # the unwritten bytes and the native pad, from the strip geometry
    written = sd._strip_byte_mask(256, w, sy, ey, view_layout=view_layout)
    skipped = torch.from_numpy(np.ascontiguousarray(
        ~np.broadcast_to(written, got.shape[1:]))).cuda()
    assert not got[:, skipped].any() and not want[:, skipped].any()
    if view_layout == "native":
        inc = torch.from_numpy(TP._strip_mask(16, sy, ey)).cuda()
        pad = got[..., w // 8:]
        assert bool((pad[:, :, :, inc] == 127).all())
        assert not pad[:, :, :, ~inc].any()


@pytest.mark.parametrize("w", [200, 1920])
def test_stereo_layout_identities(gen, w):
    img = _img(gen, 2, 512, w)
    s, bw = 512 // 16, w // 8
    ilv, pla, nat = (K.encode_quantize_stereo(img, LUT_Q, view_layout=vl)
                     for vl in VIEW_LAYOUTS)
    assert torch.equal(pla, TP.L_reorder.stereo_interleaved_to_views(ilv, s,
                                                                      bw))
    assert torch.equal(nat[..., :bw], pla)
    assert bool((nat[..., bw:] == 127).all())
    dec = [K.decode_quantize_stereo(r, LUT_Q, w, 512, vl)
           for r, vl in zip((ilv, pla, nat), VIEW_LAYOUTS)]
    assert torch.equal(dec[0], dec[1]) and torch.equal(dec[0], dec[2])


def test_stereo_api_launches_kernels(gen):
    img = _img(gen, 2, 256, 128).cpu().numpy()
    K.reset_launch_counts()
    rec = sd.encode_quantize_stereo(img, LUT_Q, view_layout="native")
    pix = sd.decode_quantize_stereo(rec, LUT_Q, 128, 256,
                                    view_layout="native")
    torch.cuda.synchronize()
    assert rec.device.type == pix.device.type == "cuda"
    assert rec.shape == (2, 2, 64, 16, 128) and pix.shape == (2, 256, 128)
    assert K.LAUNCHES["enc_stereo"] == K.LAUNCHES["dec_stereo"] == 1
    spill = sd.encode_quantize_stereo(img[0, :248], LUT_Q, spill=True)
    assert spill.shape == (256 * 128,)
    assert K.LAUNCHES["enc_stereo"] == 2


# -- YCbCr 4:4:4 colour ------------------------------------------------------

LUMA = default_quant_lut(100) * np.float32(255.0)   # mode32's raw domain
CHROMA = BASE_CHROMA_QUANT_TABLE * np.float32(100 * 255)


@pytest.mark.parametrize("shape", [(3, 256, 192), (3, 272, 64),
                                   (3, 3, 1088, 1920)])
@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_enc32_rgb_against_plain(gen, shape, rounding):
    planes = _img(gen, *shape)
    _ok(K.encode_quantize32_ycbcr(planes, LUMA, CHROMA, rounding),
        TP.encode_ycbcr32(planes, LUMA, CHROMA, rounding))


@pytest.mark.parametrize("shape", [(3, 256, 192), (2, 3, 1088, 1920)])
def test_dec32_rgb_and_roundtrip_rgb(gen, shape):
    planes = _img(gen, *shape)
    h, w = shape[-2:]
    rec = TP.encode_ycbcr32(planes, LUMA, CHROMA)
    _ok(K.decode_quantize32_ycbcr(rec, LUMA, CHROMA, w, h),
        TP.decode_ycbcr32(rec, LUMA, CHROMA, w, h))
    fused = K.roundtrip_quantize32_ycbcr(planes, LUMA, CHROMA)
    composed = K.decode_quantize32_ycbcr(
        K.encode_quantize32_ycbcr(planes, LUMA, CHROMA), LUMA, CHROMA, w, h)
    assert torch.equal(fused, composed)
    _ok(fused, TP.roundtrip_ycbcr32(planes, LUMA, CHROMA))


def test_color_api_launches_kernels(gen):
    planes = _img(gen, 2, 3, 256, 128).cpu().numpy()
    K.reset_launch_counts()
    rec = sd.encode_quantize32_ycbcr(planes, LUMA, CHROMA)
    pix = sd.decode_quantize32_ycbcr(rec, LUMA, CHROMA, 128, 256)
    rt = sd.roundtrip_quantize32_ycbcr(planes, LUMA, CHROMA)
    torch.cuda.synchronize()
    assert rec.device.type == pix.device.type == rt.device.type == "cuda"
    assert rec.shape == (2, 3, 128 * 128) and pix.shape == (2, 3, 128, 128)
    assert torch.equal(pix, rt)
    assert K.LAUNCHES["enc32_rgb"] == K.LAUNCHES["dec32_rgb"] == 1
    assert K.LAUNCHES["roundtrip32_rgb"] == 1


# -- YCbCr 4:2:0 colour ------------------------------------------------------

@pytest.mark.parametrize("shape", [(3, 64, 384), (3, 128, 256),
                                   (3, 3, 1088, 1920)])
@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_enc420_rgb_against_plain(gen, shape, rounding):
    planes = _img(gen, *shape)
    _ok(K.encode_quantize32_ycbcr420(planes, LUMA, CHROMA, rounding),
        TP.encode_ycbcr420(planes, LUMA, CHROMA, rounding))


@pytest.mark.parametrize("shape", [(3, 64, 384), (2, 3, 1088, 1920)])
def test_dec420_rgb_against_plain(gen, shape):
    planes = _img(gen, *shape)
    h, w = shape[-2:]
    rec = TP.encode_ycbcr420(planes, LUMA, CHROMA)
    _ok(K.decode_quantize32_ycbcr420(rec, LUMA, CHROMA, w, h),
        TP.decode_ycbcr420(rec, LUMA, CHROMA, w, h))


@pytest.mark.parametrize("shape", [(3, 64, 384), (2, 3, 1088, 1920)])
def test_420_y_segment_is_enc32_rgb_luma(gen, shape):
    planes = _img(gen, *shape)
    h, w = shape[-2:]
    stream = K.encode_quantize32_ycbcr420(planes, LUMA, CHROMA)
    luma = K.encode_quantize32_ycbcr(planes, LUMA, CHROMA)[..., 0, :]
    assert torch.equal(stream[..., : (h // 2) * w], luma)


def test_color420_api_launches_kernels(gen):
    planes = _img(gen, 2, 3, 256, 384).cpu().numpy()
    K.reset_launch_counts()
    rec = sd.encode_quantize32_ycbcr420(planes, LUMA, CHROMA)
    pix = sd.decode_quantize32_ycbcr420(rec, LUMA, CHROMA, 384, 256)
    one = sd.decode_quantize32_ycbcr420(rec[:1], LUMA, CHROMA, 384, 256)
    torch.cuda.synchronize()
    assert rec.device.type == pix.device.type == "cuda"
    assert rec.shape == (2, 3 * 128 * 384 // 2)
    assert pix.shape == (2, 3, 128, 384) and one.shape == (1, 3, 128, 384)
    assert torch.equal(one[0], pix[0])
    assert K.LAUNCHES["enc420_rgb"] == 1 and K.LAUNCHES["dec420_rgb"] == 2


# -- the panel engine's tiles ------------------------------------------------

LUT_Q = default_quant_lut(50)          # the 1/255 domain of enc-quant, stereo
TILE_CONFIGS = [(False, "fy", LUT), (True, "fx", LUT_Q), (True, "fy", LUT_Q)]


def _tile_scales(lut):
    from simd_dct_tpu_torch.core.quantize import dequant_scales, quant_scales
    return quant_scales(lut), dequant_scales(lut)


@pytest.mark.parametrize("shape", [(256, 384), (2, 128, 128)])
@pytest.mark.parametrize("cfg", range(len(TILE_CONFIGS)))
@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_tiles_and_detile_against_plain(gen, shape, cfg, rounding):
    from simd_dct_tpu_torch.kernels import panel
    normalize, orientation, lut = TILE_CONFIGS[cfg]
    q, qi = _tile_scales(lut)
    view = _img(gen, *shape)
    tiles = K.tiles_panels(view, q, normalize=normalize, rounding=rounding,
                           orientation=orientation)
    _ok(tiles, panel.forward_tiles(view, q, normalize=normalize,
                                   orientation=orientation,
                                   rounding=rounding))
    _ok(K.detile_panels(tiles, qi, normalize=normalize,
                        orientation=orientation),
        panel.inverse_tiles(tiles, qi, normalize=normalize,
                            orientation=orientation))


@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_tile_records_equal_the_mode_kernels(gen, rounding):
    """tiles + converter == the mode's own kernel, byte for byte, and the
    detile of the converted records == the mode's decode."""
    from simd_dct_tpu_torch.kernels import panel
    img = _img(gen, 2, 512, 384)
    top = img[:, :256].contiguous()
    q, qi = _tile_scales(LUT)
    t32 = K.tiles_panels(top, q, normalize=False, rounding=rounding,
                         orientation="fy")
    rec = K.encode_quantize32(img, LUT, rounding=rounding)
    assert torch.equal(panel.tiles_to_group8(t32), rec)
    assert torch.equal(
        K.detile_panels(panel.group8_to_tiles(rec, 256, 384), qi,
                        normalize=False, orientation="fy"),
        K.decode_quantize32(rec, LUT, 384, 512))
    q, qi = _tile_scales(LUT_Q)
    tq = K.tiles_panels(top, q, normalize=True, rounding=rounding,
                        orientation="fx")
    for layout, conv in (("scalar", panel.tiles_to_block_contiguous),
                         ("pair", panel.tiles_to_pair)):
        rec = K.encode_quantize(img, LUT_Q, rounding=rounding, layout=layout)
        assert torch.equal(conv(tq), rec)
        back = (panel.block_contiguous_to_tiles if layout == "scalar"
                else panel.pair_to_tiles)(rec, 256, 384)
        assert torch.equal(
            K.detile_panels(back, qi, normalize=True, orientation="fx"),
            K.decode_quantize(rec, LUT_Q, 384, 512, layout))
    ts = K.tiles_panels(img.view(2, 2, 256, 384), q, normalize=True,
                        rounding=rounding, orientation="fy")
    rec = K.encode_quantize_stereo(img, LUT_Q, rounding=rounding)
    assert torch.equal(panel.tiles_to_planar(ts), rec)
    px = K.detile_panels(panel.planar_to_tiles(rec, 256, 384), qi,
                         normalize=True, orientation="fy")
    assert torch.equal(px.view(2, 512, 384),
                       K.decode_quantize_stereo(rec, LUT_Q, 384, 512))


# -- batches longer than one launch takes -------------------------------------

def test_batches_split_across_launches(gen, monkeypatch):
    """With the per-launch limit patched to 3 frames, a 7-frame batch goes
    out in 3 launches per kernel and equals the frames run one by one."""
    q, qi = _tile_scales(LUT)
    img = _img(gen, 7, 256, 128)
    want = {"enc32": K.encode_quantize32(img, LUT),
            "encq": K.encode_quantize(img, LUT_Q, layout="pair"),
            "enc_stereo": K.encode_quantize_stereo(img, LUT_Q,
                                                   view_layout="native"),
            "tiles": K.tiles_panels(img, q, normalize=False, rounding="rne",
                                    orientation="fy")}
    monkeypatch.setattr(K, "_MAX_BATCH", 3)
    K.reset_launch_counts()
    got = {"enc32": K.encode_quantize32(img, LUT),
           "encq": K.encode_quantize(img, LUT_Q, layout="pair"),
           "enc_stereo": K.encode_quantize_stereo(img, LUT_Q,
                                                  view_layout="native"),
           "tiles": K.tiles_panels(img, q, normalize=False, rounding="rne",
                                   orientation="fy")}
    dec = K.detile_panels(got["tiles"], qi, normalize=False, orientation="fy")
    torch.cuda.synchronize()
    for name in got:
        assert torch.equal(got[name], want[name]), name
        assert K.LAUNCHES[name] == 3, name
    assert K.LAUNCHES["detile"] == 3
    for i in range(7):
        assert torch.equal(got["enc32"][i], K.encode_quantize32(img[i], LUT))
        assert torch.equal(dec[i], K.detile_panels(
            got["tiles"][i], qi, normalize=False, orientation="fy"))


# -- the compat tier on the card ---------------------------------------------

@pytest.mark.parametrize("mode", ["enc_quant", "enc_quant32", "stereo"])
@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_compat_on_the_card_equals_the_cpu(gen, mode, rounding):
    """The compat tier's eager ops give the same bytes on the card as on
    the CPU (which the CPU tests hold to the C++ oracle), both ways."""
    enc, dec, lut = {
        "enc_quant": (sd.encode_quantize, sd.decode_quantize, LUT_Q),
        "enc_quant32": (sd.encode_quantize32, sd.decode_quantize32, LUT),
        "stereo": (sd.encode_quantize_stereo, sd.decode_quantize_stereo,
                   LUT_Q)}[mode]
    img = _img(gen, 2, 256, 384)
    rec = enc(img, lut, rounding=rounding, compat=True)
    assert rec.device.type == "cuda"
    assert torch.equal(rec.cpu(), enc(img.cpu(), lut, rounding=rounding,
                                      compat=True))
    px = dec(rec, lut, 384, 256, compat=True)
    assert torch.equal(px.cpu(), dec(rec.cpu(), lut, 384, 256, compat=True))
    _ok(rec, enc(img, lut, rounding=rounding))


def test_scales_on_the_card_equal_the_host(gen):
    """The scales are computed on the host, then moved: on the card PyTorch
    divides by a scalar as a multiply by its reciprocal."""
    from simd_dct_tpu_torch.core.quantize import dequant_scales, quant_scales
    for lut in (LUT, LUT_Q, CHROMA):
        assert torch.equal(quant_scales(lut, "cuda").cpu(), quant_scales(lut))
        assert torch.equal(dequant_scales(lut, "cuda").cpu(),
                           dequant_scales(lut))
