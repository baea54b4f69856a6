"""The reference's mode32, enc-quant and stereo byte layouts as tensor
transforms (counterpart of ``simd_dct_tpu/layout/reorder.py``).

Buffer orders (coefficient index p within a block's 64-byte buffer):

* mode32 and stereo store **fy-major**, ``p = fy*8 + fx``
  (src/simd_dct.cpp:1983-2011, 224-227; orientation ``"fy"``);
* enc-quant stores **fx-major**, ``p = fx*8 + fy`` (DCT rows, transpose,
  DCT rows, src/simd_dct.cpp:347-358; orientation ``"fx"``): the buffer is
  the transposed coefficient matrix, ``buffer[p] = C[p % 8][p // 8]``.

The quantization LUT indexes buffer order, whichever it is.  Record
layouts: mode32 groups 8 blocks into a 512-byte coefficient-major record
(byte ``p*8 + b`` is coefficient p of block b, src/simd_dct.cpp:2021-2025);
enc-quant stores 64 contiguous bytes per block (``scalar``) or 128-byte
two-block pair cells (``pair``, ``pair_as_written``).  Every function here
takes optional leading batch axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

ORIENTATIONS = ("fy", "fx")


def _check_orientation(orientation: str) -> None:
    if orientation not in ORIENTATIONS:
        raise ValueError(
            f"orientation must be 'fx' or 'fy', got {orientation!r}")


def coeffs_to_buffer(coeffs: torch.Tensor,
                     orientation: str = "fy") -> torch.Tensor:
    """(..., 8, 8) (fy, fx)-indexed coefficients -> (..., 64) buffer order."""
    _check_orientation(orientation)
    if orientation == "fx":
        coeffs = coeffs.transpose(-1, -2)
    return coeffs.reshape(*coeffs.shape[:-2], 64)


def buffer_to_coeffs(buf: torch.Tensor,
                     orientation: str = "fy") -> torch.Tensor:
    """(..., 64) buffer order -> (..., 8, 8) (fy, fx)-indexed coefficients."""
    _check_orientation(orientation)
    c = buf.reshape(*buf.shape[:-1], 8, 8)
    return c.transpose(-1, -2) if orientation == "fx" else c


# -- enc-quant: block-contiguous / SIMD pair cells -------------------------

def block_contiguous(bufs: torch.Tensor) -> torch.Tensor:
    """(..., S, BW, 64) per-block records -> (..., S*BW*64) strip stream:
    blocks in raster order, 64 contiguous bytes each
    (src/simd_dct.cpp:361-364)."""
    return bufs.reshape(*bufs.shape[:-3], -1)


def block_contiguous_inverse(flat: torch.Tensor, bw: int) -> torch.Tensor:
    """(..., S*BW*64) -> (..., S, BW, 64)."""
    return flat.reshape(*flat.shape[:-1], -1, bw, 64)


def pair_cell_permutation(as_written: bool = False) -> np.ndarray:
    """Byte offsets of the SIMD enc-quant two-block cell (the counterpart
    of ``simd_dct_tpu/core/golden.py`` ``pair_cell_permutation``).

    ``perm[blk, p]`` is the byte offset within the 128-byte cell where
    buffer coefficient p of block blk is stored by the SSE4.1/SSSE3
    kernels (src/simd_dct.cpp:1662-1670,1822-1830): with ``i = p // 8``,
    ``j = p % 8`` and ``half = (j >> 1) & 1``, the offset is
    ``half*64 + i*8 + blk*4 + (j//4)*2 + j%2``.  ``as_written=True`` puts
    the second half at +128 instead of +64, as the kernels are coded
    (adjacent cells then overlap)."""
    half_base = 128 if as_written else 64
    perm = np.empty((2, 64), dtype=np.int64)
    for blk in range(2):
        for p in range(64):
            i, j = divmod(p, 8)
            half = (j >> 1) & 1
            perm[blk, p] = half * half_base + i * 8 + blk * 4 \
                + (j // 4) * 2 + (j % 2)
    return perm


@functools.lru_cache(maxsize=None)
def _pair_maps() -> tuple[np.ndarray, np.ndarray]:
    """(perm, inv): perm[blk*64 + p] is the cell byte of coefficient p of
    block blk; inv[k] the (blk*64 + p) index stored at cell byte k."""
    perm = pair_cell_permutation(False).reshape(-1)
    inv = np.empty(128, np.int64)
    inv[perm] = np.arange(128)
    return perm, inv


def pair_cells(bufs: torch.Tensor) -> torch.Tensor:
    """(..., S, BW, 64) -> (..., S*BW*64) stream of 128-byte two-block
    cells (the SIMD enc-quant layout, intended non-overlapping form).
    BW must be even."""
    *lead, s, bw, _ = bufs.shape
    pairs = bufs.reshape(*lead, s, bw // 2, 128)
    idx = torch.as_tensor(_pair_maps()[1], device=bufs.device)
    return pairs.index_select(-1, idx).reshape(*lead, s * bw * 64)


def pair_cells_inverse(flat: torch.Tensor, bw: int) -> torch.Tensor:
    """(..., S*BW*64) pair-cell stream -> (..., S, BW, 64)."""
    *lead, n = flat.shape
    cells = flat.reshape(*lead, n // (bw * 64), bw // 2, 128)
    idx = torch.as_tensor(_pair_maps()[0], device=flat.device)
    return cells.index_select(-1, idx).reshape(*lead, n // (bw * 64), bw, 64)


def pair_as_written(flat_pair: torch.Tensor) -> torch.Tensor:
    """Intended pair-cell stream -> the bytes the kernels as coded leave:
    each cell's second half is stored at +128, onto the next cell's first
    half, which then overwrites it (src/simd_dct.cpp:1662-1670).  Net
    effect: bytes [0, 64) of every cell are the intended first half, bytes
    [64, 128) are zero."""
    cells = flat_pair.reshape(*flat_pair.shape[:-1], -1, 2, 64)
    out = torch.cat([cells[..., :1, :], torch.zeros_like(cells[..., 1:, :])],
                    dim=-2)
    return out.reshape(flat_pair.shape)


def pair_as_written_masked(flat_pair: torch.Tensor, mask,
                           bytes_per_strip: int) -> torch.Tensor:
    """``pair_as_written`` under a strip range (reference cursor
    semantics): bytes of excluded strips are zero, except that an included
    strip s-1 followed by an excluded strip s hands the second half of
    strip s-1's last cell to the first 64 bytes of strip s (the next
    strip's first cell would otherwise overwrite it).  ``mask`` is the
    per-strip inclusion (numpy bool, S)."""
    out = pair_as_written(flat_pair)
    mask = np.asarray(mask, bool)
    if mask.all():
        return out
    *lead, n = out.shape
    strips = out.reshape(*lead, mask.size, bytes_per_strip)
    keep = torch.as_tensor(mask, device=out.device)[:, None]
    strips = torch.where(keep, strips, torch.zeros((), dtype=out.dtype,
                                                   device=out.device))
    spill_into = np.zeros_like(mask)
    spill_into[1:] = mask[:-1] & ~mask[1:]
    rows = np.nonzero(spill_into)[0]
    if rows.size:
        src = flat_pair.reshape(*lead, mask.size, bytes_per_strip)
        rows = torch.as_tensor(rows, device=out.device)
        strips[..., rows, :64] = src[..., rows - 1, -64:]
    return strips.reshape(*lead, n)


# -- mode32: group-of-8 coefficient-major ----------------------------------

def group8(bufs: torch.Tensor) -> torch.Tensor:
    """(..., S, BW, 64) per-block records -> (..., S*BW*64) flat stream of
    512-byte coefficient-major group records."""
    *lead, s, bw, _ = bufs.shape
    g = bufs.reshape(*lead, s, bw // 8, 8, 64)
    return g.transpose(-1, -2).reshape(*lead, s * bw * 64)


def group8_inverse(flat: torch.Tensor, bw: int) -> torch.Tensor:
    """(..., S*BW*64) flat stream -> (..., S, BW, 64) per-block records."""
    *lead, n = flat.shape
    s = n // (bw * 64)
    g = flat.reshape(*lead, s, bw // 8, 64, 8)
    return g.transpose(-1, -2).reshape(*lead, s, bw, 64)


# -- stereo: fully coefficient-planar, both views ---------------------------
#
# Three forms of the same bytes (fy-major buffers, S = H/16 strips,
# BW = W/8 blocks a view row):
#   * interleaved (..., H*W): the reference's stream, 64 planes; per plane
#     and strip, BW bytes of the left view, then BW of the right
#     (src/simd_dct.cpp:258-264,284-294);
#   * planar (..., 2, 64, S, BW): the views stored apart;
#   * native (..., 2, 64, S, BWP): planar with each plane row padded to
#     ``layout.stereo.native_stereo_bwp(W)`` columns of 127.

def planar_stereo(bufs: torch.Tensor) -> torch.Tensor:
    """(..., 2, S, BW, 64) [view, strip, block, coeff] -> (..., 64*S*2*BW)
    interleaved stream."""
    planes = bufs.movedim(-1, -4).transpose(-3, -2)    # (..., 64, S, 2, BW)
    return planes.reshape(*bufs.shape[:-4], -1)


def planar_stereo_inverse(flat: torch.Tensor, s: int, bw: int) -> torch.Tensor:
    """(..., 64*S*2*BW) interleaved stream -> (..., 2, S, BW, 64)."""
    planes = flat.reshape(*flat.shape[:-1], 64, s, 2, bw)
    return planes.transpose(-3, -2).movedim(-4, -1)


def stereo_views_to_interleaved(views: torch.Tensor) -> torch.Tensor:
    """(..., 2, 64, S, BW) planar -> (..., 64*S*2*BW) interleaved stream."""
    return views.movedim(-4, -2).reshape(*views.shape[:-4], -1)


def stereo_interleaved_to_views(flat: torch.Tensor, s: int,
                                bw: int) -> torch.Tensor:
    """(..., 64*S*2*BW) interleaved stream -> (..., 2, 64, S, BW) planar."""
    return flat.reshape(*flat.shape[:-1], 64, s, 2, bw).movedim(-2, -4)


def stereo_views_to_native(views: torch.Tensor, bwp: int,
                           strips) -> torch.Tensor:
    """(..., 2, 64, S, BW) planar -> (..., 2, 64, S, BWP) native: the plane
    rows padded to ``bwp`` columns of 127 (a quantized zero), then every
    byte of an excluded strip, pad included, zeroed.  ``strips`` is the
    per-strip inclusion (numpy bool, S).  With ``bwp == BW`` only the
    zeroing is left: the planar form under a strip range."""
    pad = bwp - views.shape[-1]
    if pad:
        fill = torch.full((*views.shape[:-1], pad), 127, dtype=views.dtype,
                          device=views.device)
        views = torch.cat([views, fill], dim=-1)
    strips = np.asarray(strips, bool)
    if strips.all():
        return views
    keep = torch.as_tensor(strips, device=views.device)[:, None]
    return torch.where(keep, views, torch.zeros((), dtype=views.dtype,
                                                device=views.device))
