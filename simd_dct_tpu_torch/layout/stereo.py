"""Stereo dual-view geometry (counterpart of ``simd_dct_tpu/layout/stereo.py``).

Every reference mode treats the (H, W) buffer as two vertically stacked
views of height H/2 (src/simd_dct.cpp:268): the enc-quant and mode32 modes
encode the first view per call, the stereo mode encodes both.  This module
also holds the port's single definition of the native stereo record
format's padded plane-row length, ``native_stereo_bwp``.
"""

from __future__ import annotations

import torch

CHUNK = 128     # pixels: the width the native format's rows are padded from
VIEW_LAYOUTS = ("interleaved", "planar", "native")


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def native_stereo_bwp(size_x: int) -> int:
    """Plane-row length, in block columns, of the native stereo record
    format (``view_layout="native"``): W padded to a multiple of 128 px,
    in blocks, then rounded up to a multiple of 128 bytes.  512 for
    W=3840, 256 for W=1920, 128 for W=200 (the JAX package's
    ``pallas_dct.native_stereo_bwp``)."""
    return _ceil_to(_ceil_to(size_x, CHUNK) // 8, 128)


def check_view_layout(view_layout: str) -> None:
    if view_layout not in VIEW_LAYOUTS:
        raise ValueError(f"view_layout must be one of {VIEW_LAYOUTS}, "
                         f"got {view_layout!r}")


def record_shape(view_layout: str, size_y: int,
                 size_x: int) -> tuple[int, ...]:
    """One frame's stereo records: (H*W,) ``interleaved``,
    (2, 64, H/16, W/8) ``planar`` or (2, 64, H/16, BWP) ``native``."""
    check_view_layout(view_layout)
    if view_layout == "interleaved":
        return (size_y * size_x,)
    bw = native_stereo_bwp(size_x) if view_layout == "native" \
        else size_x // 8
    return (2, 64, size_y // 16, bw)


def split_views(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., 2, H/2, W): [left/top, right/bottom] views."""
    *lead, h, w = img.shape
    return img.reshape(*lead, 2, h // 2, w)


def stack_views(views: torch.Tensor) -> torch.Tensor:
    """(..., 2, H/2, W) -> (..., H, W)."""
    *lead, two, h2, w = views.shape
    if two != 2:
        raise ValueError(f"expected (..., 2, H/2, W) views, got {views.shape}")
    return views.reshape(*lead, 2 * h2, w)


def top_view(img: torch.Tensor) -> torch.Tensor:
    """The first (top) view: what enc-quant and mode32 encode."""
    return img[..., : img.shape[-2] // 2, :]
