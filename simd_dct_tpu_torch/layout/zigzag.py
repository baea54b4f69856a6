"""Zigzag coefficient ordering (counterpart of
``simd_dct_tpu/layout/zigzag.py``).

The reference has no zigzag (its reorder layouts are plane/group-major);
JPEG-style pipelines want it, so it ships as a layout transform.  The
permutation is built in NumPy; the take indexes the tensor on its own
device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def zigzag_order() -> np.ndarray:
    """perm[k] = (fy*8 + fx) index of the k-th zigzag coefficient."""
    order = sorted(
        ((y, x) for y in range(8) for x in range(8)),
        key=lambda p: (p[0] + p[1],
                       p[0] if (p[0] + p[1]) % 2 else p[1]),
    )
    return np.array([y * 8 + x for y, x in order], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def zigzag_inverse_order() -> np.ndarray:
    perm = zigzag_order()
    inv = np.empty_like(perm)
    inv[perm] = np.arange(64, dtype=np.int32)
    return inv


def _take(bufs: torch.Tensor, perm: np.ndarray) -> torch.Tensor:
    idx = torch.as_tensor(perm.astype(np.int64), device=bufs.device)
    return torch.index_select(bufs, -1, idx)


def to_zigzag(bufs: torch.Tensor) -> torch.Tensor:
    """(..., 64) fy-major coefficient records -> zigzag order."""
    return _take(bufs, zigzag_order())


def from_zigzag(bufs: torch.Tensor) -> torch.Tensor:
    return _take(bufs, zigzag_inverse_order())
