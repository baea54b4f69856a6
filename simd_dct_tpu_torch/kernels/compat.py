"""Strict-IEEE compat tier: byte-identical to the C++ oracle
(``native/golden_dct.cpp``).  Counterpart of
``simd_dct_tpu/kernels/compat.py``.

The DCT runs in the reference butterfly's exact f32 association order
(src/simd_dct.cpp:138-172), the quantizer in the oracle's op order, and
the inverse as the oracle's plain dot products against its kD table, in
ascending k.  Each float operation is one eager torch op on whole tensors
(plain ``*``, ``+`` and ``-``), so each result is rounded once: eager ops
never contract a multiply into an add, where a compiler may (an FMA keeps
the product unrounded).  No ``sum``, ``matmul``, ``einsum``, ``addcmul``,
``add(alpha=...)`` or ``torch.compile``: those fuse or reorder, and a CUDA
reduction's order is unspecified.  Every constant is a 0-dim f32 tensor on
the input's device, or an f32 table, so that no op widens to double.

The tier runs on the input's device, as the JAX package runs its compat
engine as XLA ops on its device: on a CUDA tensor it runs on the card as
eager ops (a conformance tier, not a fast path: a launch per op), on a
CPU tensor on the host.  The functions take the arguments of
``kernels/torch_path.py``'s and optional leading batch axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.dct import C_A, C_B, C_C, C_D, C_E, C_F, C_NORM
from ..core.quantize import INV_255, VR
from ..layout import blocks as L_blocks
from ..layout import reorder as L_reorder
from ..layout import stereo as L_stereo
from .torch_path import ENCQ_LAYOUTS, _apply_mask, _strip_mask

_HALF_BIAS = np.float32(np.float32(127.0) / np.float32(255.0))


@functools.lru_cache(maxsize=None)
def _consts(device: torch.device) -> dict[str, torch.Tensor]:
    """The f32 constants of the tier as 0-dim tensors on ``device``."""
    vals = {"A": C_A, "B": C_B, "C": C_C, "D": C_D, "E": C_E, "F": C_F,
            "N": C_NORM, "inv255": INV_255, "127": np.float32(127.0),
            "255": np.float32(255.0), "half_bias": _HALF_BIAS,
            "0.5": np.float32(0.5), "1": np.float32(1.0)}
    return {k: torch.tensor(np.float32(v), device=device)
            for k, v in vals.items()}


# ---------------------------------------------------------------------------
# the 1-D butterfly, products and sums each rounded once
# ---------------------------------------------------------------------------

def _dct8_exact(v: torch.Tensor) -> torch.Tensor:
    """(..., 8) f32 -> (..., 8): the reference butterfly along the last axis
    (the JAX engine's stage 1, then stage 2)."""
    k = _consts(v.device)
    a, b, c, d, e, f, n = (k[x] for x in "ABCDEFN")
    v0, v1, v2, v3, v4, v5, v6, v7 = v.unbind(-1)
    x07p = v0 + v7
    x16p = v1 + v6
    x25p = v2 + v5
    x34p = v3 + v4
    x07m = v0 - v7
    x61m = v6 - v1
    x25m = v2 - v5
    x43m = v4 - v3
    pp = x07p + x34p
    pm = x07p - x34p
    qp = x16p + x25p
    qm = x16p - x25p
    o0 = n * (pp + qp)
    o2 = n * (b * pm + e * qm)
    o4 = n * (pp - qp)
    o6 = n * (e * pm - b * qm)
    o1 = n * (a * x07m - c * x61m + d * x25m - f * x43m)
    o3 = n * (c * x07m + f * x61m - a * x25m + d * x43m)
    o5 = n * (d * x07m + a * x61m + f * x25m - c * x43m)
    o7 = n * (f * x07m + d * x61m + c * x25m + a * x43m)
    return torch.stack([o0, o1, o2, o3, o4, o5, o6, o7], dim=-1)


def dct2d_fx_major_exact(blocks: torch.Tensor) -> torch.Tensor:
    """Enc-quant orientation (DCT rows, transpose, DCT rows) on (..., 8, 8);
    the flat result is the fx-major buffer (src/simd_dct.cpp:347-358)."""
    return _dct8_exact(_dct8_exact(blocks).transpose(-1, -2))


def dct2d_fy_major_exact(blocks: torch.Tensor) -> torch.Tensor:
    """Stereo and mode32 orientation (a leading transpose,
    src/simd_dct.cpp:224-227); the flat result is the fy-major buffer."""
    b = _dct8_exact(blocks.transpose(-1, -2))
    return _dct8_exact(b.transpose(-1, -2))


# ---------------------------------------------------------------------------
# the exact quantizer (oracle op order: native/golden_dct.cpp:98-119)
# ---------------------------------------------------------------------------

def _roundf(v: torch.Tensor) -> torch.Tensor:
    """Exact roundf (half away from zero) for v >= 0; floor(v + 0.5)
    differs where v + 0.5 rounds up across an integer."""
    k = _consts(v.device)
    w = torch.floor(v)
    return torch.where(v - w >= k["0.5"], w + k["1"], w).to(torch.uint8)


def quantize_exact(buffer: torch.Tensor, lut, rounding: str) -> torch.Tensor:
    """(..., 64) f32 buffers -> biased u8 with the oracle's rounding."""
    k = _consts(buffer.device)
    lut_f = np.asarray(lut, np.float32).reshape(64)
    if rounding == "scalar":
        q = np.float32(1.0) / (lut_f * VR)
        x = buffer * torch.as_tensor(q, device=buffer.device)
        return _roundf(torch.clamp(x + k["half_bias"], 0.0, 1.0) * k["255"])
    q = np.float32(255.0) / (lut_f * VR)
    x = buffer * torch.as_tensor(q, device=buffer.device)
    if rounding == "rne":
        # clamping the rounded value to [-127, 128] equals the oracle's
        # int clamp(rint(x) + 127, 0, 255) for every finite x
        v = torch.round(x).clamp(-127.0, 128.0).to(torch.int32) + 127
        return v.to(torch.uint8)
    if rounding == "clamp_first":
        return torch.round(torch.clamp(x + k["127"], 0.0, 255.0)) \
            .to(torch.uint8)
    raise ValueError(f"unknown rounding {rounding!r}")


# ---------------------------------------------------------------------------
# encode (the arguments of kernels/torch_path.py)
# ---------------------------------------------------------------------------

def _blocks(view: torch.Tensor, normalize: bool) -> torch.Tensor:
    x = L_blocks.blockize(view).to(torch.float32)
    return x * _consts(x.device)["inv255"] if normalize else x


def _buffers(blocks: torch.Tensor, orientation: str) -> torch.Tensor:
    dct = dct2d_fx_major_exact if orientation == "fx" else \
        dct2d_fy_major_exact
    c = dct(blocks)
    return c.reshape(*c.shape[:-2], 64)


def encode_quantize(img: torch.Tensor, lut, start_y: int = 0,
                    end_y: int = 1 << 30, rounding: str = "rne",
                    layout: str = "scalar",
                    legacy_range: bool = False) -> torch.Tensor:
    """Enc-quant of the TOP view of (..., H, W): (..., H/2*W) u8."""
    if layout not in ENCQ_LAYOUTS:
        raise ValueError(f"layout must be one of {ENCQ_LAYOUTS}, "
                         f"got {layout!r}")
    h, w = img.shape[-2:]
    bufs = _buffers(_blocks(L_stereo.top_view(img), True), "fx")
    data = quantize_exact(bufs, lut, rounding)
    flat = (L_reorder.block_contiguous(data) if layout == "scalar"
            else L_reorder.pair_cells(data))
    mask = _strip_mask(h // 16, start_y, end_y, legacy_range)
    if layout == "pair_as_written":
        return L_reorder.pair_as_written_masked(flat, mask, 8 * w)
    return _apply_mask(flat, mask, 8 * w)


def encode_quantize32(img: torch.Tensor, lut, start_y: int = 0,
                      end_y: int = 1 << 30,
                      rounding: str = "rne") -> torch.Tensor:
    """Mode32 of the TOP view of (..., H, W): (..., H/2*W) u8."""
    h, w = img.shape[-2:]
    bufs = _buffers(_blocks(L_stereo.top_view(img), False), "fy")
    flat = L_reorder.group8(quantize_exact(bufs, lut, rounding))
    return _apply_mask(flat, _strip_mask(h // 16, start_y, end_y), 8 * w)


def encode_quantize_stereo(img: torch.Tensor, lut, start_y: int = 0,
                           end_y: int = 1 << 30, rounding: str = "rne",
                           view_layout: str = "interleaved") -> torch.Tensor:
    """Stereo of BOTH views of (..., H, W): the interleaved stream
    (..., H*W), or through the layout converters the planar
    (..., 2, 64, S, BW) or native (..., 2, 64, S, BWP) form (an included
    strip's native pad holds 127; every byte of an excluded strip is 0)."""
    L_stereo.check_view_layout(view_layout)
    h, w = img.shape[-2:]
    bufs = _buffers(_blocks(L_stereo.split_views(img), True), "fy")
    flat = L_reorder.planar_stereo(quantize_exact(bufs, lut, rounding))
    strips = _strip_mask(h // 16, start_y, end_y)
    flat = _apply_mask(flat.unflatten(-1, (64, -1)), strips, w // 4) \
        .flatten(-2)
    if view_layout == "interleaved":
        return flat
    views = L_reorder.stereo_interleaved_to_views(flat, h // 16, w // 8)
    row = L_stereo.native_stereo_bwp(w) if view_layout == "native" \
        else w // 8
    return L_reorder.stereo_views_to_native(views, row, strips).contiguous()


# ---------------------------------------------------------------------------
# the exact inverse (oracle op order: native/golden_dct.cpp idct8,
# x[n] = sum_k kD[k][n] * v[k], plain dot products in ascending k)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _idct_kd() -> np.ndarray:
    """The oracle's kD table: kD[k] is row k of the forward butterfly's
    basis, each entry one f32 product."""
    n, a, b, c, d, e, f = (np.float32(C_NORM), np.float32(C_A),
                           np.float32(C_B), np.float32(C_C),
                           np.float32(C_D), np.float32(C_E), np.float32(C_F))
    one = np.float32(1.0)
    rows = [
        [one, one, one, one, one, one, one, one],
        [a, c, d, f, -f, -d, -c, -a],
        [b, e, -e, -b, -b, -e, e, b],
        [c, -f, -a, -d, d, a, f, -c],
        [one, -one, -one, one, one, -one, -one, one],
        [d, -a, f, c, -c, -f, a, -d],
        [e, -b, b, -e, -e, b, -b, e],
        [f, -d, c, -a, a, -c, d, -f],
    ]
    kd = np.empty((8, 8), np.float32)
    for k in range(8):
        for j in range(8):
            kd[k, j] = n * np.float32(rows[k][j])
    return kd


def _idct8_exact(v: torch.Tensor) -> torch.Tensor:
    """(..., 8) -> (..., 8) along the last axis: the products
    p[..., n, k] = kD[k][n] * v[..., k], then s = p[..., 0] + p[..., 1] +
    ... + p[..., 7], one add at a time."""
    kd_t = torch.as_tensor(_idct_kd().T.copy(), device=v.device)  # [n, k]
    p = v.unsqueeze(-2) * kd_t
    s = p[..., 0]
    for k in range(1, 8):
        s = s + p[..., k]
    return s


def _dequant_blocks(data: torch.Tensor, lut) -> torch.Tensor:
    """(..., 64) u8 -> (..., 8, 8) f32: (v - 127) * qi, with the oracle's
    qi = (lut * vr) / 255 in numpy f32."""
    lut_f = np.asarray(lut, np.float32).reshape(64)
    qi = (lut_f * np.float32(VR)) / np.float32(255.0)
    b = (data.to(torch.float32) - _consts(data.device)["127"]) \
        * torch.as_tensor(qi, device=data.device)
    return b.reshape(*b.shape[:-1], 8, 8)


def _pixels(x: torch.Tensor) -> torch.Tensor:
    return torch.round(x).clamp(0.0, 255.0).to(torch.uint8)


def _idct2d_exact_pixels(data: torch.Tensor, lut, orientation: str,
                         scaled: bool) -> torch.Tensor:
    """(..., 64) u8 records -> (..., 8, 8) u8 pixels.  fy: buffer rows are
    the first pass, then a transpose, the second pass and a transpose back;
    fx: no trailing transpose (the inverse of DCT rows, transpose, DCT
    rows)."""
    s = _idct8_exact(_dequant_blocks(data, lut))
    s = _idct8_exact(s.transpose(-1, -2))
    if orientation == "fy":
        s = s.transpose(-1, -2)
    if scaled:
        s = s * _consts(s.device)["255"]
    return _pixels(s)


# ---------------------------------------------------------------------------
# decode (the arguments of kernels/torch_path.py)
# ---------------------------------------------------------------------------

def decode_quantize(data: torch.Tensor, lut, size_x: int, size_y: int,
                    layout: str = "scalar") -> torch.Tensor:
    """Enc-quant inverse (fx-major, the 1/255 domain): (..., size_y/2*
    size_x) -> (..., size_y/2, size_x) u8.  ``pair_as_written`` has no
    inverse."""
    if layout not in ("scalar", "pair"):
        raise ValueError(f"decodable layouts are 'scalar' and 'pair', "
                         f"got {layout!r}")
    bw = size_x // 8
    bufs = (L_reorder.block_contiguous_inverse(data, bw) if layout == "scalar"
            else L_reorder.pair_cells_inverse(data, bw))
    return L_blocks.unblockize(_idct2d_exact_pixels(bufs, lut, "fx", True))


def decode_quantize32(data: torch.Tensor, lut, size_x: int,
                      size_y: int) -> torch.Tensor:
    """Mode32 inverse (fy-major, the raw domain)."""
    bufs = L_reorder.group8_inverse(data, size_x // 8)
    return L_blocks.unblockize(_idct2d_exact_pixels(bufs, lut, "fy", False))


def decode_quantize_stereo(data: torch.Tensor, lut, size_x: int, size_y: int,
                           view_layout: str = "interleaved") -> torch.Tensor:
    """Stereo inverse of both views (fy-major, the 1/255 domain): the
    interleaved (..., H*W), planar (..., 2, 64, S, BW) or native
    (..., 2, 64, S, BWP) form, the latter two turned into the interleaved
    stream first -> (..., size_y, size_x) u8."""
    L_stereo.check_view_layout(view_layout)
    s, bw = size_y // 16, size_x // 8
    if view_layout != "interleaved":
        data = L_reorder.stereo_views_to_interleaved(data[..., :bw])
    bufs = L_reorder.planar_stereo_inverse(data, s, bw)
    px = _idct2d_exact_pixels(bufs, lut, "fy", True)
    return L_stereo.stack_views(L_blocks.unblockize(px))
