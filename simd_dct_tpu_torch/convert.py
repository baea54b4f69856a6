"""State carried across from the JAX package.

The system has no learned weights: its state is the 64-entry quantization
LUT and the mode32 record streams.  A LUT gives the same f32 scales in both
packages, and a mode32 stream written by either package decodes in the
other (the byte layout is the reference's, src/simd_dct.cpp:2021-2025).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.quantize import dequant_scales, lut_array, quant_scales


def lut_from_numpy(lut, device: torch.device | str = "cpu"
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """64-entry LUT -> (quant_scales, dequant_scales) f32 tensors on
    ``device``, bit-identical to the JAX package's for the same LUT (they
    are computed on the CPU in the same f32 operation order, then moved)."""
    lut = lut_array(lut)
    return (quant_scales(lut).to(device), dequant_scales(lut).to(device))


def records_from_numpy(records, size_x: int, size_y: int,
                       device: torch.device | str = "cpu") -> torch.Tensor:
    """A mode32 stream, or a batch of them, as written by either package
    (flat H/2*W bytes per frame) -> u8 tensor of shape (H/2*W,) or
    (B, H/2*W) on ``device``."""
    arr = np.asarray(records)
    if arr.dtype != np.uint8:
        raise ValueError(f"records must be uint8, got {arr.dtype}")
    arr = np.ascontiguousarray(arr)
    per_frame = (size_y // 2) * size_x
    if per_frame <= 0 or arr.size % per_frame:
        raise ValueError(f"expected a multiple of {per_frame} bytes for "
                         f"{(size_x, size_y)}, got {arr.size}")
    shape = (-1,) if arr.ndim <= 1 else (arr.size // per_frame, per_frame)
    return torch.as_tensor(arr.reshape(shape), device=device)


def records_to_numpy(records: torch.Tensor) -> np.ndarray:
    """u8 record tensor (any device) -> numpy u8 array of the same shape,
    the form the JAX package's decode takes."""
    if records.dtype != torch.uint8:
        raise ValueError(f"records must be uint8, got {records.dtype}")
    return records.detach().cpu().numpy()
