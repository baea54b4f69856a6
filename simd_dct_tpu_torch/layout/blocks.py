"""Image planes <-> batches of 8x8 blocks (counterpart of
``simd_dct_tpu/layout/blocks.py``): a reshape and one axis move."""

from __future__ import annotations

import torch

BLOCK = 8


def blockize(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., H/8, W/8, 8, 8) with (row, col) minor axes."""
    *lead, h, w = img.shape
    if h % BLOCK or w % BLOCK:
        raise ValueError(f"image dims must be multiples of 8, got {(h, w)}")
    x = img.reshape(*lead, h // BLOCK, BLOCK, w // BLOCK, BLOCK)
    return x.movedim(-3, -2)


def unblockize(blocks: torch.Tensor) -> torch.Tensor:
    """(..., H/8, W/8, 8, 8) -> (..., H, W)."""
    *lead, bh, bw, b0, b1 = blocks.shape
    if b0 != BLOCK or b1 != BLOCK:
        raise ValueError(f"expected (..., 8, 8) blocks, got {blocks.shape}")
    x = blocks.movedim(-2, -3)
    return x.reshape(*lead, bh * BLOCK, bw * BLOCK)
