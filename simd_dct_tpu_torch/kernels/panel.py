"""Panel engine: the DCT over 128x128 tiles, and the tile <-> record
converters (counterpart of ``simd_dct_tpu/kernels/panel.py``).

A (H2, W) view is cut into P = H2/128 panels of NJ = W/128 tiles.  The
quantized tile tensor (..., P, 128, NJ, 128) u8 holds, at row ``u*16 + m``
and column ``g*64 + v*8 + b`` of tile (p, j), coefficient (u, v) of block
(m, 8g + b) of that tile, the natural Z layout of

    B[u*16 + m, 8m + r]         = D[u, r]     (column DCT, u-major rows)
    A[8(8g+b) + c, g*64+v*8+b]  = D[v, c]     (row DCT, (g,v,b)-ordered cols)

with Z = B X A.  Each mode's byte records are a reshape and a permute of Z
(the hybrid route: tiles, then a converter).  ``forward_tiles`` and
``inverse_tiles`` are the plain versions of the CUDA tile and detile
kernels (``csrc/tiles.cu``, wrapped by ``kernels/cuda_dct.py``
``tiles_panels`` / ``detile_panels``): two f32 matmuls against the bases
(full f32 on the card as long as ``torch.backends.cuda.matmul.allow_tf32``
keeps its default, False).  Every function takes optional leading batch
axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core.dct import dct_basis_np
from ..core.quantize import INV_255, dequantize_from_u8, round_to_u8
from ..layout.reorder import check_orientation, pair_cell_permutation

TILE = 128


@functools.lru_cache(maxsize=None)
def row_basis_np() -> np.ndarray:
    """B: column-DCT basis, output rows u-major (see module docstring)."""
    d = dct_basis_np("float32")
    b = np.zeros((128, 128), np.float32)
    for u in range(8):
        for m in range(16):
            b[u * 16 + m, m * 8: m * 8 + 8] = d[u]
    return b


@functools.lru_cache(maxsize=None)
def col_basis_np() -> np.ndarray:
    """A: row-DCT basis, output columns (group, v, block)-ordered."""
    d = dct_basis_np("float32")
    a = np.zeros((128, 128), np.float32)
    for g in range(2):
        for v in range(8):
            for b in range(8):
                n = 8 * g + b
                a[n * 8: n * 8 + 8, g * 64 + v * 8 + b] = d[v]
    return a


def supports(h2: int, w: int) -> bool:
    """The panel engine's geometry: whole 128x128 tiles."""
    return h2 > 0 and w > 0 and h2 % TILE == 0 and w % TILE == 0


def q_tile(scales64, orientation: str,
           device: torch.device | str = "cpu") -> torch.Tensor:
    """(128, 128) f32 multiplier aligned with Z's (u-major, (g, v, b)) axes.

    ``orientation`` picks the LUT's buffer order: 'fy' (p = u*8 + v; stereo
    and mode32) or 'fx' (p = v*8 + u; enc-quant)."""
    check_orientation(orientation)
    if isinstance(scales64, torch.Tensor):
        q8 = scales64.detach().to("cpu", torch.float32).reshape(8, 8)
    else:
        q8 = torch.tensor(np.asarray(scales64, np.float32)).reshape(8, 8)
    if orientation == "fx":
        q8 = q8.T                        # q8[u, v] = scales[v*8 + u]
    qb = q8.repeat_interleave(16, dim=0).repeat_interleave(8, dim=1)
    return torch.cat([qb, qb], dim=1).to(device)


def _bases(device) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(row_basis_np(), device=device),
            torch.as_tensor(col_basis_np(), device=device))


def _tile_shape(h2: int, w: int) -> tuple[int, int]:
    if not supports(h2, w):
        raise ValueError(f"the panel engine needs H2 % 128 == 0 and "
                         f"W % 128 == 0, got H2={h2}, W={w}")
    return h2 // TILE, w // TILE


def forward_tiles(view: torch.Tensor, scales, *, normalize: bool,
                  orientation: str, rounding: str) -> torch.Tensor:
    """(..., H2, W) u8 -> quantized tiles (..., P, 128, NJ, 128) u8:
    optionally x f32(1/255), the 2-D DCT, x the scale of ``orientation``,
    ``rounding``, +127."""
    *lead, h2, w = view.shape
    p, nj = _tile_shape(h2, w)
    x4 = view.reshape(*lead, p, TILE, nj, TILE).to(torch.float32)
    if normalize:
        x4 = x4 * torch.tensor(INV_255, device=view.device)
    b, a = _bases(view.device)
    y = torch.einsum("uR,...pRjk->...pujk", b, x4)
    z = torch.einsum("...pujk,kv->...pujv", y, a)
    zq = z * q_tile(scales, orientation, view.device)[:, None, :]
    return round_to_u8(zq, rounding)


def inverse_tiles(tiles: torch.Tensor, inv_scales, *, normalize: bool,
                  orientation: str) -> torch.Tensor:
    """Inverse of ``forward_tiles``: (..., P, 128, NJ, 128) u8 -> (..., H2, W)
    u8: -127, x the inverse scale, the 2-D IDCT, optionally x 255, round
    half to even, clip."""
    *lead, p, _, nj, _ = tiles.shape
    qi = q_tile(inv_scales, orientation, tiles.device)[:, None, :]
    z = dequantize_from_u8(tiles, qi)
    b, a = _bases(tiles.device)
    # X = B^T Z A^T (B and A are permuted orthonormal bases)
    y = torch.einsum("uR,...pujk->...pRjk", b, z)
    x4 = torch.einsum("...pRjk,vk->...pRjv", y, a)
    if normalize:
        x4 = x4 * torch.tensor(np.float32(255.0), device=tiles.device)
    out = torch.clamp(torch.round(x4), 0.0, 255.0).to(torch.uint8)
    return out.reshape(*lead, p * TILE, nj * TILE)


# -- byte records of each mode <-> tiles -----------------------------------

def _permute_tail(t: torch.Tensor, order: tuple[int, ...]) -> torch.Tensor:
    """Permute the last len(order) axes of t, keeping the leading ones."""
    lead = t.ndim - len(order)
    return t.permute(*range(lead), *(lead + i for i in order))


def _lead_and_tiles(tiles: torch.Tensor) -> tuple[list[int], int, int]:
    *lead, p, rows, nj, cols = tiles.shape
    if rows != TILE or cols != TILE:
        raise ValueError(f"expected (..., P, 128, NJ, 128) tiles, got "
                         f"{tuple(tiles.shape)}")
    return lead, p, nj


def tiles_to_group8(tiles: torch.Tensor) -> torch.Tensor:
    """Mode32 records: strip byte j*1024 + g*512 + u*64 + v*8 + b.
    (..., P, 128, NJ, 128) -> (..., H2*W)."""
    lead, p, nj = _lead_and_tiles(tiles)
    t6 = tiles.reshape(*lead, p, 8, 16, nj, 2, 64)     # (p,u,m,j,g,vb)
    return _permute_tail(t6, (0, 2, 3, 4, 1, 5)).reshape(*lead, -1)


def group8_to_tiles(flat: torch.Tensor, h2: int, w: int) -> torch.Tensor:
    p, nj = _tile_shape(h2, w)
    rec = flat.reshape(*flat.shape[:-1], p, 16, nj, 2, 8, 64)  # (p,m,j,g,u,vb)
    t6 = _permute_tail(rec, (0, 4, 1, 2, 3, 5))
    return t6.reshape(*flat.shape[:-1], p, TILE, nj, TILE)


def tiles_to_block_contiguous(tiles: torch.Tensor) -> torch.Tensor:
    """Enc-quant ``scalar`` records: strip byte n*64 + v*8 + u with
    n = j*16 + g*8 + b.  (..., P, 128, NJ, 128) -> (..., H2*W)."""
    lead, p, nj = _lead_and_tiles(tiles)
    t7 = tiles.reshape(*lead, p, 8, 16, nj, 2, 8, 8)   # (p,u,m,j,g,v,b)
    rec = _permute_tail(t7, (0, 2, 3, 4, 6, 5, 1))     # (p,m,j,g,b,v,u)
    return rec.reshape(*lead, -1)


def block_contiguous_to_tiles(flat: torch.Tensor, h2: int,
                              w: int) -> torch.Tensor:
    p, nj = _tile_shape(h2, w)
    rec = flat.reshape(*flat.shape[:-1], p, 16, nj, 2, 8, 8, 8)
    t7 = _permute_tail(rec, (0, 6, 1, 2, 3, 5, 4))     # (p,u,m,j,g,v,b)
    return t7.reshape(*flat.shape[:-1], p, TILE, nj, TILE)


@functools.lru_cache(maxsize=None)
def _pair_lanes() -> tuple[np.ndarray, np.ndarray]:
    """(perm, inv) over one 128-byte two-block cell: cell byte perm[k] holds
    record byte k (k = blk*64 + p), and cell byte k holds record byte
    inv[k]."""
    perm = pair_cell_permutation(False).reshape(-1)
    inv = np.empty(128, np.int64)
    inv[perm] = np.arange(128)
    return perm, inv


def tiles_to_pair(tiles: torch.Tensor) -> torch.Tensor:
    """Enc-quant ``pair`` records (the intended two-block cells)."""
    flat = tiles_to_block_contiguous(tiles)
    cells = flat.reshape(*flat.shape[:-1], -1, 128)
    idx = torch.as_tensor(_pair_lanes()[1], device=tiles.device)
    return cells.index_select(-1, idx).reshape(flat.shape)


def pair_to_tiles(flat: torch.Tensor, h2: int, w: int) -> torch.Tensor:
    cells = flat.reshape(*flat.shape[:-1], -1, 128)
    idx = torch.as_tensor(_pair_lanes()[0], device=flat.device)
    rec = cells.index_select(-1, idx).reshape(flat.shape)
    return block_contiguous_to_tiles(rec, h2, w)


def tiles_to_planar(tiles_lr: torch.Tensor) -> torch.Tensor:
    """Stereo: the tiles of both views, (..., 2, P, 128, NJ, 128) -> the
    reference's interleaved 64-plane stream (..., 2*H2*W): plane (u, v)
    holds per strip BW bytes of the left view, then BW of the right
    (src/simd_dct.cpp:258-264,284-294; ``view_layout="interleaved"``)."""
    lead, p, nj = _lead_and_tiles(tiles_lr)
    if not lead or lead[-1] != 2:
        raise ValueError(f"expected (..., 2, P, 128, NJ, 128) tiles of two "
                         f"views, got {tuple(tiles_lr.shape)}")
    t8 = tiles_lr.reshape(*lead[:-1], 2, p, 8, 16, nj, 2, 8, 8)
    # (view,p,u,m,j,g,v,b) -> (u,v,p,m,view,j,g,b)
    planes = _permute_tail(t8, (2, 6, 1, 3, 0, 4, 5, 7))
    return planes.reshape(*lead[:-1], -1)


def planar_to_tiles(flat: torch.Tensor, h2: int, w: int) -> torch.Tensor:
    """Inverse of ``tiles_to_planar``; ``h2`` is one view's height."""
    p, nj = _tile_shape(h2, w)
    planes = flat.reshape(*flat.shape[:-1], 8, 8, p, 16, 2, nj, 2, 8)
    t8 = _permute_tail(planes, (4, 2, 0, 3, 5, 6, 1, 7))
    return t8.reshape(*flat.shape[:-1], 2, p, TILE, nj, TILE)
