"""The CUDA kernels against the plain version, and the compat tier, on the
card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false.  The test configuration of this directory imports jax, which the
machine with the card does not have, so run these there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports no jax.  Run as a script it is one rank of the gather
across processes (``_procs_worker``).
"""

import os
import sys

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


@pytest.mark.parametrize("shape", [(16, 1984), (256, 192), (8, 1088, 1920)])
def test_roundtrip32_strip_tiles(gen, shape):
    """The strip-tile round trip where strips end in a short tile (W = 1984,
    W = 192) and on an 8-frame batch: one launch of its plan's tiles, equal
    to decode(encode(x))."""
    img = _img(gen, *shape)
    h, w = shape[-2:]
    plan = K.roundtrip32_launch_plan(img)
    frames = img.numel() // (h * w)
    assert plan.tiles == frames * -(-h // 32) * plan.tiles_per_row
    assert plan.smem == K.roundtrip32_smem() and 1 <= plan.grid <= plan.tiles
    K.reset_launch_counts()
    fused = K.roundtrip_quantize32(img, LUT)
    torch.cuda.synchronize()
    assert K.LAUNCHES["roundtrip32"] == 1
    assert torch.equal(fused, K.decode_quantize32(K.encode_quantize32(img, LUT),
                                                  LUT, w, h))


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


def _over_junk(fn, *args, **kw):
    """fn's result, its output allocated over bytes just set to 0xAB (the
    caching allocator hands the same block back): an unwritten byte
    shows."""
    out = fn(*args, **kw)
    out.fill_(0xAB)
    del out
    return fn(*args, **kw)


def test_mode32_plans_and_views_off_16_bytes(gen):
    """The encode and the decode take tensor copies on every tensor a
    wrapper accepts; a view off a 16-byte boundary is refused, and the api
    realigns it."""
    img = _img(gen, 8, 1088, 1920)
    rec = K.encode_quantize32(img, LUT)
    for plan in (K.mode32_launch_plan("enc32", img),
                 K.mode32_launch_plan("dec32", rec, size_x=1920,
                                      size_y=1088)):
        assert plan.variant == "tensor"
        assert (plan.tiles, plan.tail_blocks) == (8 * 68 * 8, 16)
    top = img[:, :544]
    flat = torch.empty(top.numel() + 16, dtype=torch.uint8, device="cuda")
    off = flat[8:8 + top.numel()].view(top.shape)
    off.copy_(top)
    with pytest.raises(ValueError):
        K.encode32_view(off, LUT)
    assert torch.equal(sd.encode_quantize32(img, LUT), rec)


# a strip of one whole tile (W = 256), of 7 and a tile of 16 blocks (1920),
# of one short tile (64)
@pytest.mark.parametrize("w", [256, 1920, 64])
@pytest.mark.parametrize("sy,ey", [(16, 16), (32, 95), (48, 1 << 40),
                                   (-(1 << 40), 0)])
def test_enc32_strip_ranges_leave_one_writer_a_byte(gen, w, sy, ey):
    """Kept strips hold the full-range encode's bytes, the others zeros,
    over outputs preset to 0xAB (the plain version agrees within +-1)."""
    img = _img(gen, 2, 256, w)
    whole = K.encode_quantize32(img, LUT).view(2, 16, 8 * w)
    kept = [sy <= 16 * s <= ey for s in range(16)]
    want = whole * torch.tensor(kept, device="cuda")[None, :, None]
    got = _over_junk(K.encode_quantize32, img, LUT, sy, ey)
    assert torch.equal(got, want.view(2, -1))
    _ok(got, TP.encode_quantize32(img, LUT, sy, ey))


def test_enc32_batch_top_views_against_plain_and_frame_by_frame(gen):
    # frames 1088 rows apart, of which the encode reads the top 544
    img = _img(gen, 8, 1088, 1920)
    rec = K.encode_quantize32(img, LUT)
    assert torch.equal(rec, TP.encode_quantize32(img, LUT))
    for i in (0, 7):
        assert torch.equal(rec[i], K.encode_quantize32(img[i], LUT))
    pix = K.decode_quantize32(rec, LUT, 1920, 1088)
    _ok(pix, TP.decode_quantize32(rec, LUT, 1920, 1088))
    assert torch.equal(pix[7], K.decode_quantize32(rec[7], LUT, 1920, 1088))


def test_encode32_view_of_a_shard_stride(gen):
    img = _img(gen, 3, 544, 1920)
    # a shard: strips 4..11 of each frame, frames 544 rows apart
    shard = img[:, 32:96]
    assert shard.stride(0) == 544 * 1920
    got = K.encode32_view(shard, LUT)
    assert torch.equal(got, K.encode32_view(shard.contiguous(), LUT))
    _ok(got, TP.encode32_view(shard.contiguous(), LUT))


@pytest.mark.parametrize("shape", [(16, 1984), (1088, 1920), (4, 256, 192)])
def test_roundtrip32_equals_decode_of_encode(gen, shape):
    img = _img(gen, *shape)
    h, w = shape[-2:]
    assert torch.equal(K.roundtrip_quantize32(img, LUT),
                       K.decode_quantize32(K.encode_quantize32(img, LUT),
                                           LUT, w, h))


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


@pytest.mark.parametrize("shape", [(544, 1920), (8, 1088, 1920)])
def test_encq_tensor_and_plain_variants_give_the_same_bytes(gen, shape):
    img = _img(gen, *shape)
    h, w = shape[-2:]
    assert K.encq_launch_plan("encq", img).variant == "tensor"
    for layout in LAYOUTS:
        for rounding in ("rne", "scalar", "clamp_first"):
            assert torch.equal(
                K.encode_quantize(img, LUT_Q, rounding=rounding,
                                  layout=layout),
                K._encode_quantize(img, LUT_Q, rounding=rounding,
                                   layout=layout, variant="plain"))
    for layout in ("scalar", "pair"):
        rec = TP.encode_quantize(img, LUT_Q, layout=layout)
        assert torch.equal(
            K.decode_quantize(rec, LUT_Q, w, h, layout),
            K._decode_quantize(rec, LUT_Q, w, h, layout, variant="plain"))


# a strip of one whole tile (W = 256), of 7 and a tile of 16 blocks (1920),
# of one tile and a tile of one cell (272): a spill leaves each kind
@pytest.mark.parametrize("w", [256, 1920, 272])
@pytest.mark.parametrize("sy,ey,legacy", [(16, 16, False), (0, 20, True),
                                          (32, 95, False),
                                          (48, 1 << 40, False)])
def test_encq_strip_ranges_leave_one_writer_a_byte(gen, w, sy, ey, legacy):
    img = _img(gen, 2, 256, w)
    for layout in LAYOUTS:
        got = _over_junk(K.encode_quantize, img, LUT_Q, sy, ey,
                         layout=layout, legacy_range=legacy)
        assert torch.equal(got, TP.encode_quantize(
            img, LUT_Q, sy, ey, layout=layout, legacy_range=legacy))


def test_encq_batch_against_plain_and_frame_by_frame(gen):
    # frames 1088 rows apart, of which the encode reads the top 544
    img = _img(gen, 8, 1088, 1920)
    for layout in LAYOUTS:
        rec = K.encode_quantize(img, LUT_Q, layout=layout)
        assert torch.equal(rec, TP.encode_quantize(img, LUT_Q,
                                                   layout=layout))
        for i in (0, 7):
            assert torch.equal(rec[i], K.encode_quantize(img[i], LUT_Q,
                                                         layout=layout))
        if layout != "pair_as_written":
            _ok(K.decode_quantize(rec, LUT_Q, 1920, 1088, layout),
                TP.decode_quantize(rec, LUT_Q, 1920, 1088, layout))


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


@pytest.mark.parametrize("shape", [(1088, 1920), (2, 256, 128)])
@pytest.mark.parametrize("view_layout", VIEW_LAYOUTS)
def test_stereo_tensor_and_plain_variants_give_the_same_bytes(gen, shape,
                                                              view_layout):
    img = _img(gen, *shape)
    h, w = shape[-2:]
    assert K.stereo_launch_plan("enc_stereo", img, view_layout).variant \
        == "tensor"
    for rounding in ("rne", "scalar", "clamp_first"):
        assert torch.equal(
            K.encode_quantize_stereo(img, LUT_Q, rounding=rounding,
                                     view_layout=view_layout),
            K.encode_quantize_stereo(img, LUT_Q, rounding=rounding,
                                     view_layout=view_layout,
                                     variant="plain"))
    rec = TP.encode_quantize_stereo(img, LUT_Q, view_layout=view_layout)
    assert torch.equal(
        K.decode_quantize_stereo(rec, LUT_Q, w, h, view_layout),
        K.decode_quantize_stereo(rec, LUT_Q, w, h, view_layout,
                                 variant="plain"))


@pytest.mark.parametrize("view_layout", VIEW_LAYOUTS)
def test_stereo_views_off_16_bytes_and_a_shard_stride(gen, view_layout):
    img = _img(gen, 544, 1920)
    flat = torch.empty(544 * 1920 + 64, dtype=torch.uint8, device="cuda")
    off = flat[8:8 + 544 * 1920].view(2, 272, 1920)
    off.copy_(img.view(2, 272, 1920))
    before = dict(K.VARIANT_LAUNCHES["enc_stereo"])
    assert torch.equal(K.encode_stereo_view(off, LUT_Q,
                                            view_layout=view_layout),
                       K.encode_quantize_stereo(img, LUT_Q,
                                                view_layout=view_layout))
    assert K.VARIANT_LAUNCHES["enc_stereo"]["plain"] == before["plain"] + 1
    shard = img.view(2, 272, 1920)[:, 32:96]      # strips 4..11 of each view
    assert shard.stride(0) == 272 * 1920
    got = K.encode_stereo_view(shard, LUT_Q, view_layout=view_layout)
    whole = shard.reshape(128, 1920)      # a contiguous copy of the rows
    assert torch.equal(got, K.encode_quantize_stereo(
        whole, LUT_Q, view_layout=view_layout))
    _ok(got, TP.encode_quantize_stereo(whole, LUT_Q, view_layout=view_layout))


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


def _enc32_rgb_ok(got, planes, rounding):
    """rne and clamp_first equal the plain version byte for byte; scalar
    (an IEEE division there, a reciprocal in the plain version) within the
    +-1 contract."""
    want = TP.encode_ycbcr32(planes, LUMA, CHROMA, rounding)
    if rounding == "scalar":
        _ok(got, want)
    else:
        assert torch.equal(got, want)


# (3, 16, 1984): bw = 248, so each strip ends in a short tile of 8 blocks
@pytest.mark.parametrize("shape", [(3, 256, 192), (3, 272, 64),
                                   (3, 16, 1984), (3, 3, 1088, 1920)])
@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_enc32_rgb_against_plain(gen, shape, rounding):
    planes = _img(gen, *shape)
    _enc32_rgb_ok(K.encode_quantize32_ycbcr(planes, LUMA, CHROMA, rounding),
                  planes, rounding)


@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
@pytest.mark.parametrize("shift,pad", [(8, 0), (0, 8), (8, 24)])
def test_enc32_rgb_view_misaligned_takes_plain_loads(gen, rounding, shift,
                                                     pad):
    """A view whose base (shift) or plane stride (H*W + pad) is 8 bytes
    off a 16-byte boundary runs the plain-load variant, with the same
    bytes."""
    h, w = 32, 1984
    flat = _img(gen, 3 * (h * w + pad) + 64)
    view = flat[shift:].as_strided((3, h // 2, w), (h * w + pad, w, 1))
    plan = K.color_plan("enc32_rgb", 1, h // 2, w, base=view.data_ptr(),
                        plane_stride=view.stride(0),
                        capacity=lambda v: (1, 1))
    assert plan.variant == "plain"
    got = K.encode32_rgb_view(view, LUMA, CHROMA, rounding)
    planes = torch.stack([view[c] for c in range(3)]).contiguous()
    _enc32_rgb_ok(got, torch.cat([planes, planes], dim=1), rounding)
    assert torch.equal(got, K.encode32_rgb_view(view.contiguous(), LUMA,
                                                CHROMA, rounding))


@pytest.mark.parametrize("shape", [(3, 256, 192), (3, 16, 1984),
                                   (2, 3, 1088, 1920)])
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


# the strip-tile decode: each strip of 1984 columns ends in a tile of 8
# blocks; an 8-frame batch walks its frames' tiles in one persistent grid
@pytest.mark.parametrize("shape", [(3, 16, 1984), (8, 3, 1088, 1920)])
def test_dec32_rgb_strip_tiles(gen, shape):
    planes = _img(gen, *shape)
    h, w = shape[-2:]
    rec = TP.encode_ycbcr32(planes, LUMA, CHROMA)
    plan = K.color_launch_plan("dec32_rgb", rec, size_x=w)
    assert plan.variant == "tensor" and plan.grid <= plan.tiles
    assert plan.tail_blocks == (8 if w == 1984 else 16)
    _ok(K.decode_quantize32_ycbcr(rec, LUMA, CHROMA, w, h),
        TP.decode_ycbcr32(rec, LUMA, CHROMA, w, h))
    fused = K.roundtrip_quantize32_ycbcr(planes, LUMA, CHROMA)
    composed = K.decode_quantize32_ycbcr(
        K.encode_quantize32_ycbcr(planes, LUMA, CHROMA), LUMA, CHROMA, w, h)
    assert torch.equal(fused, composed)


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


@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_420_y_segment_is_enc32_rgb_luma_on_a_batch(gen, rounding):
    planes = _img(gen, 8, 3, 1088, 1920)
    stream = K.encode_quantize32_ycbcr420(planes, LUMA, CHROMA, rounding)
    luma = K.encode_quantize32_ycbcr(planes, LUMA, CHROMA, rounding)
    assert torch.equal(stream[:, : 544 * 1920], luma[:, 0])


@pytest.mark.parametrize("rows", [(0, 64), (64, 160), (960, 1024)])
def test_enc420_rgb_shard_rows_equal_the_whole(gen, rows):
    """A shard's rows of the top view, planes a whole image apart, through
    encode420_rgb_view: the strips of the whole image's stream."""
    from simd_dct_tpu_torch.layout.color420 import unpack_records
    h, w = 2048, 1920
    planes = _img(gen, 3, h, w)
    r0, r1 = rows
    view = planes[:, r0:r1]
    plan = K._color420_plan_of(view, view.data_ptr(), 1, r1 - r0, w,
                               view.stride(0))
    assert plan.tiles == (r1 - r0) // 16 * (w // 128)
    y, c = unpack_records(K.encode420_rgb_view(view, LUMA, CHROMA), w,
                          r1 - r0)
    y_all, c_all = unpack_records(
        K.encode_quantize32_ycbcr420(planes, LUMA, CHROMA), w, h // 2)
    assert torch.equal(y, y_all[r0 // 8:r1 // 8])
    assert torch.equal(c, c_all[:, r0 // 16:r1 // 16])


@pytest.mark.parametrize("shape", [(3, 64, 384), (8, 3, 1088, 1920)])
@pytest.mark.parametrize("records", ["encoded", "random"])
def test_dec420_rgb_strip_tiles_against_plain(gen, shape, records):
    """The strip-tile decode: one launch of its plan's tiles, within the
    plain version's budget on encoded streams and on random bytes (which
    clip at both rails)."""
    planes = _img(gen, *shape)
    h, w = shape[-2:]
    frames = shape[0] if len(shape) == 4 else 1
    rec = TP.encode_ycbcr420(planes, LUMA, CHROMA)
    if records == "random":
        rec = _img(gen, *rec.shape)
    plan = K.color420_launch_plan(rec, size_x=w)
    assert plan.tiles == frames * (h // 32) * (w // 128)
    assert plan.smem == K.color420_smem("dec420_rgb")
    assert 1 <= plan.grid <= plan.tiles
    K.reset_launch_counts()
    got = K.decode_quantize32_ycbcr420(rec, LUMA, CHROMA, w, h)
    torch.cuda.synchronize()
    assert K.LAUNCHES["dec420_rgb"] == 1
    _ok(got, TP.decode_ycbcr420(rec, LUMA, CHROMA, w, h))


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


@pytest.mark.parametrize("shape", [(128, 128), (2, 256, 128),
                                   (8, 1024, 1920)])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("orientation", ["fy", "fx"])
def test_tiles_strip_tiles_against_plain(gen, shape, normalize, orientation):
    """The strip-tile kernel at W = 128 and on an 8-frame batch, one launch
    of its plan's tiles, the detile's strip tiles."""
    from simd_dct_tpu_torch.kernels import panel
    q, _ = _tile_scales(LUT_Q if normalize else LUT)
    view = _img(gen, *shape)
    plan = K.tiles_launch_plan(view, "rne", normalize, orientation)
    assert plan.tiles == view.numel() // (16 * 128)
    assert plan.smem == K.tiles_smem() and 1 <= plan.grid <= plan.tiles
    K.reset_launch_counts()
    got = K.tiles_panels(view, q, normalize=normalize, rounding="rne",
                         orientation=orientation)
    torch.cuda.synchronize()
    assert K.LAUNCHES["tiles"] == 1
    _ok(got, panel.forward_tiles(view, q, normalize=normalize,
                                 orientation=orientation, rounding="rne"))


@pytest.mark.parametrize("shape", [(128, 128), (2, 256, 128),
                                   (8, 1024, 1920)])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("orientation", ["fy", "fx"])
def test_detile_strip_tiles_against_plain(gen, shape, normalize, orientation):
    """The strip-tile inverse at W = 128 and on an 8-frame batch, on the
    tiles of a view and on random bytes (which clip at both rails), one
    launch of its plan's tiles each."""
    from simd_dct_tpu_torch.kernels import panel
    q, qi = _tile_scales(LUT_Q if normalize else LUT)
    view = _img(gen, *shape)
    h2, w = shape[-2:]
    coded = panel.forward_tiles(view, q, normalize=normalize,
                                orientation=orientation, rounding="rne")
    for tiles in (coded, _img(gen, *coded.shape)):
        plan = K.detile_launch_plan(tiles, normalize, orientation)
        assert plan.tiles == view.numel() // (16 * 128)
        assert plan.smem == K.detile_smem() and 1 <= plan.grid <= plan.tiles
        K.reset_launch_counts()
        got = K.detile_panels(tiles, qi, normalize=normalize,
                              orientation=orientation)
        torch.cuda.synchronize()
        assert K.LAUNCHES["detile"] == 1
        _ok(got, panel.inverse_tiles(tiles, qi, normalize=normalize,
                                     orientation=orientation))


@pytest.mark.parametrize("shape", [(256, 384), (2, 2048, 1920)])
def test_detile_of_stereo_records_equals_dec_stereo(gen, shape):
    """The detile of the stereo records, converted, is the stereo decode
    byte for byte: the two share their arithmetic."""
    from simd_dct_tpu_torch.kernels import panel
    img = _img(gen, *shape)
    h, w = shape[-2:]
    rec = K.encode_quantize_stereo(img, LUT_Q)
    _, qi = _tile_scales(LUT_Q)
    px = K.detile_panels(panel.planar_to_tiles(rec, h // 2, w), qi,
                         normalize=True, orientation="fy")
    assert torch.equal(px.reshape(img.shape),
                       K.decode_quantize_stereo(rec, LUT_Q, w, h))


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


# -- the dist path: four shards on one card and the plane gather -------------

def _mesh4():
    from simd_dct_tpu_torch import dist
    return dist.make_mesh(4, devices=["cuda:0"] * 4)


@pytest.mark.parametrize("view_layout", ["interleaved", "native"])
def test_ring_gather_equals_the_ring_and_the_unsharded_call(gen, view_layout):
    from simd_dct_tpu_torch import dist
    from simd_dct_tpu_torch.dist import collectives as C
    mesh = _mesh4()
    img = _img(gen, 512, 384)
    seg = dist.encode_quantize_stereo_sharded(img, LUT_Q, mesh,
                                              view_layout=view_layout)
    K.reset_launch_counts()
    got = C.gather_planes_remote(seg, mesh)
    assert K.LAUNCHES["ring_gather"] == 1
    ring = C.gather_planes_ring(seg, mesh)
    want = sd.encode_quantize_stereo(img, LUT_Q, view_layout=view_layout)
    for a, b in zip(got.shards, ring.shards):
        assert torch.equal(a, b)
        assert torch.equal(a.reshape(want.shape), want)


def test_ring_gather_byte_rows_and_a_2d_mesh(gen):
    from simd_dct_tpu_torch import dist
    from simd_dct_tpu_torch.dist import collectives as C
    mesh2 = dist.make_mesh_2d((2, 2), devices=["cuda:0"] * 4)
    seg = _img(gen, 64, 16, 15)                 # 120-byte rows: byte stores
    got = C.gather_planes_remote(seg, mesh2, axis_name="chip")
    for replica in got.shards:
        assert torch.equal(replica, seg)


@pytest.mark.parametrize("ranks, shape", [
    (4, (16, 4 * 41, 400)),     # 16,400-byte rows: two pieces, the last short
    (4, (70, 4 * 13, 80)),      # 1,040-byte rows: 15 a tile, the last 10
    (4, (1, 4 * 64, 1024)),     # outer == 1
    (2, (64, 2 * 64, 480)),     # a ring of 2 on one card
    (8, (64, 8 * 16, 480)),     # a ring of 8 on one card
    (4, (64, 4 * 64, 960)),     # the 4K stereo segments' 61,440-byte rows
])
def test_ring_gather_tiles_equal_the_ring(gen, ranks, shape):
    """The bulk variant's tiles, ragged and whole, on rings of 2, 4 and 8
    ranks of one card: every replica equals the plain ring byte for byte."""
    from simd_dct_tpu_torch import dist
    from simd_dct_tpu_torch.dist import collectives as C
    mesh = dist.make_mesh(ranks, devices=["cuda:0"] * ranks)
    seg = _img(gen, *shape)
    got = C.gather_planes_remote(seg, mesh)
    ring = C.gather_planes_ring(seg, mesh)
    C.check_workspace(mesh)
    for a, b in zip(got.shards, ring.shards):
        assert torch.equal(a, b)
    assert torch.equal(got.shards[0], seg)


def test_selfring_on_the_card(gen):
    from simd_dct_tpu_torch.dist import collectives as C
    assert C.remote_dma_selfring_smoke() is True
    x = _img(gen, 8, 8, 128)
    assert torch.equal(C.selfring(x), C.selfring_plain(x))


def test_a_spin_that_times_out_raises(gen):
    from simd_dct_tpu_torch import dist
    from simd_dct_tpu_torch.dist import collectives as C
    mesh = _mesh4()
    seg = dist.strip_sharding(_img(gen, 64, 64, 32), mesh, dim=1)
    C.gather_planes_remote(seg, mesh)
    mesh._collective_workspace.arr[0] += 1      # one arrival too many expected
    C.gather_planes_remote(seg, mesh, timeout_s=0.05)     # does not wait
    with pytest.raises(sd.SimdDctError, match="within"):
        C.check_workspace(mesh)
    assert mesh._collective_workspace is None
    again = C.gather_planes_remote(seg, mesh)
    assert torch.equal(again.shards[0], seg.full())


def test_a_timed_out_gather_is_reported_by_the_next(gen):
    from simd_dct_tpu_torch import dist
    from simd_dct_tpu_torch.dist import collectives as C
    mesh = _mesh4()
    seg = dist.strip_sharding(_img(gen, 64, 64, 32), mesh, dim=1)
    C.gather_planes_remote(seg, mesh)
    mesh._collective_workspace.arr[1] += 1
    C.gather_planes_remote(seg, mesh, timeout_s=0.05)
    torch.cuda.synchronize()
    with pytest.raises(sd.SimdDctError, match="arrive"):
        C.gather_planes_remote(seg, mesh)
    assert mesh._collective_workspace is None
    assert torch.equal(C.gather_planes_remote(seg, mesh).shards[3],
                       seg.full())


def _cards_mesh():
    from simd_dct_tpu_torch import dist
    n = min(torch.cuda.device_count(), 4)
    if n < 2:
        pytest.skip("needs two or more CUDA cards")
    return dist.make_mesh(n)


def _sleep_ms(dev, ms):
    """Keep ``dev``'s current stream busy for about ``ms`` milliseconds."""
    with torch.cuda.device(dev):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        torch.cuda._sleep(int(ms * 1e7 / start.elapsed_time(end)))


def test_a_lagging_card_does_not_time_out(gen):
    """A card busy for six spin bounds: its peers' streams wait for it, so
    no kernel spins out and every replica is exact."""
    from simd_dct_tpu_torch import dist
    from simd_dct_tpu_torch.dist import collectives as C
    mesh = _cards_mesh()
    cards = list(mesh.devices.flat)
    seg = dist.strip_sharding(_img(gen, 64, 16 * len(cards), 480), mesh,
                              dim=1)
    C.gather_planes_remote(seg, mesh)
    _sleep_ms(cards[-1], 300)
    got = C.gather_planes_remote(seg, mesh, timeout_s=0.05)
    C.check_workspace(mesh)
    for replica in got.shards:
        assert torch.equal(replica.cpu(), seg.full().cpu())


def test_a_timeout_across_cards_never_writes_freed_memory(gen, monkeypatch):
    """Without the streams' joins, card 0 spins out at the barrier while the
    last card is busy; that card's kernel still stores into card 0's output
    later.  The output was dropped at once and a new tensor of its size
    taken on card 0: it must keep its bytes, and the error must be raised
    only after every card has finished."""
    from simd_dct_tpu_torch import dist
    from simd_dct_tpu_torch.dist import collectives as C
    mesh = _cards_mesh()
    cards = list(mesh.devices.flat)
    seg = dist.strip_sharding(_img(gen, 64, 16 * len(cards), 480), mesh,
                              dim=1)
    shape = C.gather_planes_remote(seg, mesh).shards[0].shape
    C.check_workspace(mesh)
    monkeypatch.setattr(C, "_start_together", lambda cards: None)
    _sleep_ms(cards[-1], 300)
    got = C.gather_planes_remote(seg, mesh, timeout_s=0.05)
    del got
    with torch.cuda.device(cards[0]):
        keep = torch.full(shape, 7, dtype=torch.uint8, device=cards[0])
    with pytest.raises(sd.SimdDctError, match="within"):
        C.check_workspace(mesh)
    assert int((keep != 7).sum()) == 0
    monkeypatch.undo()
    again = C.gather_planes_remote(seg, mesh)
    assert torch.equal(again.shards[0].cpu(), seg.full().cpu())


def test_sharded_mode32_and_colour_equal_the_unsharded_calls(gen):
    from simd_dct_tpu_torch import dist
    mesh = _mesh4()
    img = _img(gen, 512, 384)
    rec = dist.encode_quantize32_sharded(img, LUT, mesh)
    assert torch.equal(rec.full().reshape(-1), sd.encode_quantize32(img, LUT))
    rgb = _img(gen, 3, 512, 384)
    crec = dist.encode_quantize32_ycbcr_sharded(rgb, LUT, CHROMA, mesh)
    assert torch.equal(crec.full().reshape(3, -1),
                       sd.encode_quantize32_ycbcr(rgb, LUT, CHROMA))


@pytest.mark.parametrize("depth", [1, 3])
def test_feed_streams_equal_the_api_on_the_card(gen, depth):
    """The feed's streams (upload, compute and download streams, the
    page-locked ring) against per-frame api calls, byte for byte."""
    from simd_dct_tpu_torch import entropy
    from simd_dct_tpu_torch.utils import feed
    frames = [_img(gen, 256, 384).cpu().numpy() for _ in range(5)]
    outs = list(feed.stream_roundtrip32(frames, LUT, depth=depth))
    blobs = list(feed.stream_encode32_compressed(frames, LUT, depth=depth))
    sparse = list(feed.stream_encode32_compressed(frames, LUT, depth=depth,
                                                  sparse=True))
    dec = list(feed.stream_decode32_compressed(blobs, LUT, 384, 256,
                                               depth=depth))
    for fr, out, blob, sblob, d in zip(frames, outs, blobs, sparse, dec):
        rec = sd.encode_quantize32(fr, LUT)
        assert np.array_equal(out, sd.roundtrip_quantize32(fr, LUT).cpu())
        assert np.array_equal(entropy.decompress(blob), rec.cpu().reshape(-1))
        assert np.array_equal(entropy.decompress(sblob),
                              rec.cpu().reshape(-1))
        assert np.array_equal(d, sd.decode_quantize32(rec, LUT, 384,
                                                      256).cpu())
    got = [t.cpu() for t in feed.FrameFeeder(
        lambda x: x * 2, depth=depth).map(frames)]
    assert all(torch.equal(g, torch.from_numpy(f) * 2)
               for g, f in zip(got, frames))


@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("sparse", [False, True])
def test_feed_encode_from_a_source_that_refills_its_buffer(gen, depth,
                                                           sparse):
    """The encode streams fill the ring in the background: a source that
    refills one buffer for every frame (a video reader) still gives each
    frame its own records, and frames of a new shape reallocate the ring."""
    from simd_dct_tpu_torch import entropy
    from simd_dct_tpu_torch.utils import feed
    frames = ([_img(gen, 256, 384).cpu().numpy() for _ in range(6)]
              + [_img(gen, 128, 192).cpu().numpy() for _ in range(3)])

    def reader():
        buf = {}
        for fr in frames:
            b = buf.setdefault(fr.shape, np.empty_like(fr))
            np.copyto(b, fr)
            yield b

    blobs = list(feed.stream_encode32_compressed(reader(), LUT, depth=depth,
                                                 sparse=sparse))
    assert len(blobs) == len(frames)
    for fr, blob in zip(frames, blobs):
        assert np.array_equal(entropy.decompress(blob),
                              sd.encode_quantize32(fr, LUT).cpu().reshape(-1))


def test_histogram_tensor_queues_without_a_synchronisation(gen):
    from simd_dct_tpu_torch import entropy
    rec = _img(gen, 1 << 20)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist = entropy.histogram_tensor(rec)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert np.array_equal(hist.cpu().numpy(),
                          np.bincount(rec.cpu().numpy(), minlength=256))


# -- the gather across processes, two ranks on card 0 ------------------------

def _procs_worker(port: str, rank: str, ending: str) -> int:
    """One rank: a strip-sharded stereo encode with gather=True over a mesh
    of the two processes on cuda:0, against the same gather by one process
    over two shards of cuda:0; prints the gathered bytes' checksum.  With
    ``ending == "store host dies"`` rank 0 (the store's host) then exits
    at once, and rank 1's next gather must raise ``SimdDctError`` within
    the spin bound plus 1 s."""
    import time
    import torch.distributed as tdist
    from simd_dct_tpu_torch import dist
    from simd_dct_tpu_torch.dist import collectives as C
    r = int(rank)
    assert dist.initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=r)
    mesh = dist.make_mesh(2, devices=["cuda:0"] * 2)
    one = dist.Mesh(["cuda:0"] * 2, ("data",))
    g = torch.Generator(device="cuda").manual_seed(18)
    img = torch.randint(0, 256, (512, 384), generator=g, dtype=torch.uint8,
                        device="cuda")
    for view_layout in ("interleaved", "native"):
        K.reset_launch_counts()
        got = dist.encode_quantize_stereo_sharded(
            img, LUT_Q, mesh, gather=True, view_layout=view_layout).full()
        assert K.LAUNCHES["ring_gather"] == 1, K.LAUNCHES
        want = dist.encode_quantize_stereo_sharded(
            img, LUT_Q, one, gather=True, view_layout=view_layout)
        assert all(torch.equal(got, w) for w in want.shards)
    print(f"PROCS_OK rank={r} sum={int(got.sum())}", flush=True)
    tdist.barrier()
    if ending == "clean":
        tdist.destroy_process_group()
        return 0
    if r == 0:
        os._exit(0)
    seg = dist.encode_quantize_stereo_sharded(img, LUT_Q, mesh)
    torch.cuda.synchronize()
    time.sleep(0.5)         # the store's host is gone
    t0 = time.perf_counter()
    try:
        C.gather_planes_remote(seg, mesh)
    except sd.SimdDctError as e:
        after = time.perf_counter() - t0
        assert after < C.SPIN_TIMEOUT_S + 1.0, after
        assert "store" in str(e), e
        print(f"DIED_OK after={after:.3f}", flush=True)
        os._exit(0)
    raise AssertionError("a gather without the store's host must raise")


@pytest.mark.parametrize("ending", ["clean", "store host dies"])
def test_two_processes_on_one_card_gather_as_one_process(gen, ending):
    import socket
    import subprocess
    if torch.cuda.device_count() < 1:
        pytest.skip("needs a CUDA card")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [repo, os.environ.get("PYTHONPATH")])))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(port), str(r),
         ending], cwd=repo, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, text[-3000:]
    sums = [line.split("sum=")[1] for text in outs
            for line in text.splitlines() if "PROCS_OK" in line]
    assert len(sums) == 2 and sums[0] == sums[1]
    if ending != "clean":
        assert "DIED_OK" in outs[1], outs[1][-3000:]


def test_numpy_tier_refuses_a_cuda_tensor_and_agrees_with_the_card(gen):
    img = _img(gen, 64, 128)
    with pytest.raises(sd.NotSupportedError, match=r"\.cpu\(\)"):
        sd.encode_quantize32(img, LUT, backend="numpy")
    from simd_dct_tpu_torch.dispatch import set_max_backend
    set_max_backend("numpy")
    try:
        with pytest.raises(sd.NotSupportedError, match=r"\.cpu\(\)"):
            sd.encode_quantize_stereo(img, LUT_Q)
    finally:
        set_max_backend("cuda")
    golden = sd.encode_quantize32(img.cpu().numpy(), LUT, backend="numpy")
    assert golden.device.type == "cpu"
    _ok(sd.encode_quantize32(img, LUT).cpu(), golden)


if __name__ == "__main__":
    sys.exit(_procs_worker(*sys.argv[1:]))
