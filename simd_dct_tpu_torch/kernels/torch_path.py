"""Plain PyTorch version of the mode32, enc-quant, stereo and YCbCr 4:4:4
and 4:2:0 colour kernels (the ``torch`` tier).

Counterpart of ``simd_dct_tpu/kernels/xla_path.py`` (its generic einsum
branch: blockize, ``dct8x8``, quantize, then the record layout) and of the
XLA tiers of ``simd_dct_tpu/kernels/color32.py`` and ``color420.py``.  It runs
on any device PyTorch runs on.  The CPU tests hold it against the JAX
package, and ``chip_smoke.py`` holds the CUDA kernels
(``kernels/cuda_dct.py``) against it on the card.

Every function takes optional leading batch axes.  The strip range
``[start_y, end_y]`` keeps strip ``s`` (rows ``[8s, 8s+8)`` of the top
view, and for stereo the same rows of the bottom view) iff
``start_y <= 16*s <= end_y`` -- the SIMD kernels' ``y*2``
convention (src/simd_dct.cpp:1686-1696) -- or, with ``legacy_range``, iff
``start_y <= 8*s <= end_y``, the NoSimd enc-quant kernel's test
(src/simd_dct.cpp:377,384).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dct import dct8x8, idct8x8
from ..core.quantize import (INV_255, dequant_scales, dequantize_from_u8,
                             quant_scales, quantize_to_u8)
from ..layout import blocks as L_blocks
from ..layout import color as L_color
from ..layout import color420 as L_color420
from ..layout import reorder as L_reorder
from ..layout import stereo as L_stereo


ENCQ_LAYOUTS = ("scalar", "pair", "pair_as_written")


def _strip_mask(num_strips: int, start_y: int, end_y: int,
                legacy_range: bool = False) -> np.ndarray:
    y = np.arange(num_strips, dtype=np.int64) * (8 if legacy_range else 16)
    return (y >= start_y) & (y <= end_y)


def _apply_mask(flat: torch.Tensor, mask: np.ndarray,
                bytes_per_strip: int) -> torch.Tensor:
    """Zero the bytes of excluded strips in (..., S*bytes_per_strip)."""
    if mask.all():
        return flat
    m = torch.as_tensor(np.repeat(mask, bytes_per_strip), device=flat.device)
    return torch.where(m, flat, torch.zeros((), dtype=flat.dtype,
                                            device=flat.device))


def _dct_buffers(blocks: torch.Tensor,
                 orientation: str = "fy") -> torch.Tensor:
    """(..., S, BW, 8, 8) f32 blocks -> (..., S, BW, 64) f32 coefficient
    buffers."""
    return L_reorder.coeffs_to_buffer(dct8x8(blocks), orientation)


def _coeff_buffers(view_u8: torch.Tensor, normalize: bool = False,
                   orientation: str = "fy") -> torch.Tensor:
    """(..., S*8, W) u8 -> (..., S, BW, 64) f32 coefficient buffers.
    ``normalize`` multiplies the pixels by f32(1/255) before the DCT (the
    enc-quant domain); mode32 keeps the raw 0..255 domain."""
    x = L_blocks.blockize(view_u8).to(torch.float32)
    if normalize:
        x = x * torch.tensor(INV_255, device=x.device)
    return _dct_buffers(x, orientation)


def _buffers_to_view(bufs: torch.Tensor, normalize: bool = False,
                     orientation: str = "fy") -> torch.Tensor:
    """(..., S, BW, 64) f32 coefficient buffers -> (..., S*8, W) u8 pixels
    (``normalize``: times 255 after the IDCT; then round half to even and
    clip to [0, 255])."""
    x = idct8x8(L_reorder.buffer_to_coeffs(bufs, orientation))
    if normalize:
        x = x * torch.tensor(np.float32(255.0), device=x.device)
    px = torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)
    return L_blocks.unblockize(px)


def encode32_view(view: torch.Tensor, lut,
                  rounding: str = "rne") -> torch.Tensor:
    """Mode32 encode of a bare (..., H2, W) view -> (..., H2*W) records."""
    bufs = _coeff_buffers(view)
    data = quantize_to_u8(bufs, quant_scales(lut, view.device), rounding)
    return L_reorder.group8(data)


def encode_quantize32(img: torch.Tensor, lut, start_y: int = 0,
                      end_y: int = 1 << 30,
                      rounding: str = "rne") -> torch.Tensor:
    """simdDCT_EncodeQuantize32ReorderBuffer semantics on the TOP view of a
    (..., H, W) dual-view image: raw 0..255 domain, fy-major buffers,
    coefficient-major 512-byte group records.  -> (..., H/2*W) u8."""
    h, w = img.shape[-2:]
    flat = encode32_view(L_stereo.top_view(img), lut, rounding)
    return _apply_mask(flat, _strip_mask(h // 16, start_y, end_y), 8 * w)


def decode_quantize32(data: torch.Tensor, lut, size_x: int,
                      size_y: int) -> torch.Tensor:
    """(..., size_y/2*size_x) records -> (..., size_y/2, size_x) u8."""
    bufs = L_reorder.group8_inverse(data, size_x // 8)
    coeffs = dequantize_from_u8(bufs, dequant_scales(lut, data.device))
    return _buffers_to_view(coeffs)


def roundtrip_quantize32(img: torch.Tensor, lut) -> torch.Tensor:
    """Mode32 encode (``rne``) then decode of the TOP view, composed."""
    h, w = img.shape[-2:]
    return decode_quantize32(encode_quantize32(img, lut), lut, w, h)


def encode_quantize(img: torch.Tensor, lut, start_y: int = 0,
                    end_y: int = 1 << 30, rounding: str = "rne",
                    layout: str = "scalar",
                    legacy_range: bool = False) -> torch.Tensor:
    """simdDCT_EncodeQuantizeBuffer semantics on the TOP view of a
    (..., H, W) dual-view image: the 1/255 domain, fx-major buffers, then
    the ``scalar``, ``pair`` or ``pair_as_written`` layout.
    -> (..., H/2*W) u8."""
    if layout not in ENCQ_LAYOUTS:
        raise ValueError(f"layout must be one of {ENCQ_LAYOUTS}, "
                         f"got {layout!r}")
    h, w = img.shape[-2:]
    bufs = _coeff_buffers(L_stereo.top_view(img), normalize=True,
                          orientation="fx")
    data = quantize_to_u8(bufs, quant_scales(lut, img.device), rounding)
    flat = (L_reorder.block_contiguous(data) if layout == "scalar"
            else L_reorder.pair_cells(data))
    mask = _strip_mask(h // 16, start_y, end_y, legacy_range)
    if layout == "pair_as_written":
        return L_reorder.pair_as_written_masked(flat, mask, 8 * w)
    return _apply_mask(flat, mask, 8 * w)


def decode_quantize(data: torch.Tensor, lut, size_x: int, size_y: int,
                    layout: str = "scalar") -> torch.Tensor:
    """Inverse of ``encode_quantize`` for the ``scalar`` and ``pair``
    layouts: (..., size_y/2*size_x) -> (..., size_y/2, size_x) u8."""
    if layout not in ("scalar", "pair"):
        raise ValueError(f"decodable layouts are 'scalar' and 'pair', "
                         f"got {layout!r}")
    bw = size_x // 8
    bufs = (L_reorder.block_contiguous_inverse(data, bw) if layout == "scalar"
            else L_reorder.pair_cells_inverse(data, bw))
    coeffs = dequantize_from_u8(bufs, dequant_scales(lut, data.device))
    return _buffers_to_view(coeffs, normalize=True, orientation="fx")


def encode_quantize_stereo(img: torch.Tensor, lut, start_y: int = 0,
                           end_y: int = 1 << 30, rounding: str = "rne",
                           view_layout: str = "interleaved") -> torch.Tensor:
    """simdDCT_EncodeQuantizeReorderStereoBuffer semantics on BOTH views of
    a (..., H, W) dual-view image: the 1/255 domain, fy-major buffers, 64
    coefficient planes.  Every byte of an excluded strip is zero, native
    pad included; an included strip's native pad holds 127.
    -> (..., H*W) interleaved, (..., 2, 64, S, BW) planar or
    (..., 2, 64, S, BWP) native u8."""
    L_stereo.check_view_layout(view_layout)
    h, w = img.shape[-2:]
    bufs = _coeff_buffers(L_stereo.split_views(img), normalize=True,
                          orientation="fy")               # (..., 2, S, BW, 64)
    data = quantize_to_u8(bufs, quant_scales(lut, img.device), rounding)
    views = data.movedim(-1, -3)                          # (..., 2, 64, S, BW)
    # the native form pads each plane row; every form zeroes excluded strips
    row = L_stereo.native_stereo_bwp(w) if view_layout == "native" else w // 8
    views = L_reorder.stereo_views_to_native(
        views, row, _strip_mask(h // 16, start_y, end_y))
    if view_layout == "interleaved":
        return L_reorder.stereo_views_to_interleaved(views)
    return views.contiguous()


def decode_quantize_stereo(data: torch.Tensor, lut, size_x: int, size_y: int,
                           view_layout: str = "interleaved") -> torch.Tensor:
    """Inverse of ``encode_quantize_stereo`` for each form: (..., H*W)
    interleaved, (..., 2, 64, S, BW) planar or (..., 2, 64, S, BWP) native
    (whose pad columns are never read) -> (..., size_y, size_x) u8."""
    L_stereo.check_view_layout(view_layout)
    s, bw = size_y // 16, size_x // 8
    if view_layout == "interleaved":
        views = L_reorder.stereo_interleaved_to_views(data, s, bw)
    else:
        views = data[..., :bw]
    coeffs = dequantize_from_u8(views.movedim(-3, -1),    # (..., 2, S, BW, 64)
                                dequant_scales(lut, data.device))
    return L_stereo.stack_views(
        _buffers_to_view(coeffs, normalize=True, orientation="fy"))


def _ycc(view: torch.Tensor) -> torch.Tensor:
    """(..., 3, H2, W) u8 planar RGB of a bare view -> (..., 3, H2, W) f32
    YCbCr: the BT.601 mix, bias added, no u8 step."""
    return L_color.mix_planes(view.to(torch.float32), L_color.RGB2YCC,
                              L_color.YCC_BIAS)


def _plane_records(planes: torch.Tensor, scales: torch.Tensor,
                   rounding: str) -> torch.Tensor:
    """(..., H, W) f32 planes -> (..., H*W) u8 mode32 records in the raw
    0..255 domain."""
    bufs = _dct_buffers(L_blocks.blockize(planes))
    return L_reorder.group8(quantize_to_u8(bufs, scales, rounding))


def _plane_values(records: torch.Tensor, scales: torch.Tensor,
                  size_x: int) -> torch.Tensor:
    """Inverse of ``_plane_records`` up to the rounding to u8:
    (..., H*W) u8 records of W-wide planes -> (..., H, W) f32 values."""
    bufs = L_reorder.group8_inverse(records, size_x // 8)
    coeffs = dequantize_from_u8(bufs, scales)
    return L_blocks.unblockize(idct8x8(L_reorder.buffer_to_coeffs(coeffs)))


def _unmix(ycc: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) f32 YCbCr, bias removed -> u8 planar RGB: the inverse
    mix, round half to even, clip."""
    rgb = L_color.mix_planes(ycc, L_color.YCC2RGB)
    return torch.clamp(torch.round(rgb), 0.0, 255.0).to(torch.uint8)


def _channel_scales(scales_of, luma, chroma, device) -> torch.Tensor:
    """(3, 1, 1, 64) f32: the luma LUT's scales for Y, the chroma LUT's for
    Cb and Cr, broadcasting over (..., 3, S, BW, 64) buffers."""
    y, c = scales_of(luma, device), scales_of(chroma, device)
    return torch.stack([y, c, c])[:, None, None, :]


def encode_ycbcr32(planes: torch.Tensor, luma, chroma,
                   rounding: str = "rne") -> torch.Tensor:
    """Colour mode32 encode of the TOP view of a (..., 3, H, W) planar RGB
    dual-view image: the BT.601 mix to f32 YCbCr (no u8 step), then per
    channel the mode32 encode in the raw 0..255 domain, Y with ``luma``'s
    scales and Cb, Cr with ``chroma``'s.  -> (..., 3, H/2*W) u8 (counterpart
    of ``simd_dct_tpu/kernels/color32.py`` ``encode_ycbcr_xla``)."""
    return encode_ycbcr32_view(L_stereo.top_view(planes), luma, chroma,
                               rounding)


def encode_ycbcr32_view(view: torch.Tensor, luma, chroma,
                        rounding: str = "rne") -> torch.Tensor:
    """``encode_ycbcr32`` of a bare (..., 3, H2, W) planar RGB view ->
    (..., 3, H2*W) u8 records."""
    return _plane_records(
        _ycc(view), _channel_scales(quant_scales, luma, chroma, view.device),
        rounding)


def decode_ycbcr32(data: torch.Tensor, luma, chroma, size_x: int,
                   size_y: int) -> torch.Tensor:
    """Inverse of ``encode_ycbcr32``: (..., 3, size_y/2*size_x) records ->
    (..., 3, size_y/2, size_x) u8 planar RGB.  The YCbCr values go from the
    IDCT to the inverse mix in f32, unrounded (``decode_ycbcr_xla``)."""
    ycc = _plane_values(
        data, _channel_scales(dequant_scales, luma, chroma, data.device),
        size_x)
    bias = torch.as_tensor(L_color.YCC_BIAS, device=data.device)
    return _unmix(ycc - bias[:, None, None])


def roundtrip_ycbcr32(planes: torch.Tensor, luma, chroma) -> torch.Tensor:
    """Colour mode32 encode (``rne``) then decode of the TOP view, composed:
    (..., 3, H, W) -> (..., 3, H/2, W) u8."""
    h, w = planes.shape[-2:]
    return decode_ycbcr32(encode_ycbcr32(planes, luma, chroma), luma, chroma,
                          w, h)


def encode_ycbcr420(planes: torch.Tensor, luma, chroma,
                    rounding: str = "rne") -> torch.Tensor:
    """Colour 4:2:0 encode of the TOP view of a (..., 3, H, W) planar RGB
    dual-view image: the BT.601 mix to f32 YCbCr, Cb and Cr pooled over 2x2
    pixels (``layout.color420.pool2x2``), then the mode32 encode of each
    plane in the raw 0..255 domain, Y with ``luma``'s scales and the half-
    resolution Cb, Cr with ``chroma``'s.  -> (..., 1.5*H/2*W) u8 stream
    [Y | Cb | Cr] (counterpart of ``simd_dct_tpu/kernels/color420.py``
    ``encode_ycbcr420_xla`` and ``pack_records``)."""
    return encode_ycbcr420_view(L_stereo.top_view(planes), luma, chroma,
                                rounding)


def encode_ycbcr420_view(view: torch.Tensor, luma, chroma,
                         rounding: str = "rne") -> torch.Tensor:
    """``encode_ycbcr420`` of a bare (..., 3, H2, W) planar RGB view ->
    (..., 1.5*H2*W) u8 stream."""
    h2, w = view.shape[-2:]
    ycc = _ycc(view)
    dev = view.device
    y_rec = _plane_records(ycc[..., 0, :, :], quant_scales(luma, dev),
                           rounding)
    c_rec = _plane_records(L_color420.pool2x2(ycc[..., 1:, :, :]),
                           quant_scales(chroma, dev), rounding)
    return L_color420.pack_records(
        y_rec.unflatten(-1, (h2 // 8, 8 * w)),
        c_rec.unflatten(-1, (h2 // 16, 4 * w)))


def decode_ycbcr420(data: torch.Tensor, luma, chroma, size_x: int,
                    size_y: int) -> torch.Tensor:
    """Inverse of ``encode_ycbcr420``: (..., 1.5*size_y/2*size_x) stream ->
    (..., 3, size_y/2, size_x) u8 planar RGB.  Each plane goes through the
    IDCT; Cb and Cr lose their bias and each value covers 2x2 pixels
    (``replicate2x2``); the inverse mix takes the unrounded f32 values
    (``decode_ycbcr420_xla``)."""
    y_rec, c_rec = L_color420.unpack_records(data, size_x, size_y // 2)
    dev = data.device
    ylum = _plane_values(y_rec.flatten(-2), dequant_scales(luma, dev),
                         size_x)
    half = _plane_values(c_rec.flatten(-2), dequant_scales(chroma, dev),
                         size_x // 2)
    bias = torch.as_tensor(L_color.YCC_BIAS, device=dev)
    ycc = torch.cat([(ylum - bias[0]).unsqueeze(-3),
                     L_color420.replicate2x2(half - bias[1:, None, None])],
                    dim=-3)
    return _unmix(ycc)


def probe_trial(x: torch.Tensor) -> torch.Tensor:
    """The tier probe's trial operation: u8 + 1 in int32, clipped, u8."""
    return (x.to(torch.int32) + 1).clamp(0, 255).to(torch.uint8)
