"""The mode32 byte layout as tensor transforms (counterpart of the
mode32 part of ``simd_dct_tpu/layout/reorder.py``).

Mode32 stores each block's 64 coefficients **fy-major** (``p = fy*8 + fx``,
src/simd_dct.cpp:1983-2011; orientation ``"fy"`` in the JAX package), and
each group of 8 blocks as a 512-byte coefficient-major record: byte
``p*8 + b`` is coefficient p of block b of the group
(src/simd_dct.cpp:2021-2025).  Every function here takes optional leading
batch axes.
"""

from __future__ import annotations

import torch


def coeffs_to_buffer(coeffs: torch.Tensor) -> torch.Tensor:
    """(..., 8, 8) (fy, fx)-indexed coefficients -> (..., 64) fy-major
    buffer order."""
    return coeffs.reshape(*coeffs.shape[:-2], 64)


def buffer_to_coeffs(buf: torch.Tensor) -> torch.Tensor:
    """(..., 64) fy-major buffer order -> (..., 8, 8) coefficients."""
    return buf.reshape(*buf.shape[:-1], 8, 8)


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
