"""State carried across from the JAX package.

The system has no learned weights: its state is the 64-entry quantization
LUT and the record streams.  A LUT gives the same f32 scales in both
packages, and a mode32, enc-quant, stereo or YCbCr 4:4:4 or 4:2:0 colour
stream or a panel engine tile tensor written by either package decodes in
the other (the byte layouts are the reference's,
src/simd_dct.cpp:258-264,361-364,1662-1670,2021-2025, and the JAX package's
planar and native stereo forms, per-channel colour records, [Y | Cb | Cr]
4:2:0 streams and Z tiles).
Like the api, these functions put their result on the card unless the
caller names another ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.quantize import dequant_scales, lut_array, quant_scales
from .dispatch.capability import default_device
from .layout.color420 import record_bytes_420
from .layout.stereo import record_shape


def lut_from_numpy(lut, device: torch.device | str | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """64-entry LUT -> (quant_scales, dequant_scales) f32 tensors on
    ``device``, bit-identical to the JAX package's for the same LUT (they
    are computed on the CPU in the same f32 operation order, then moved)."""
    dev = default_device(device)
    lut = lut_array(lut)
    return (quant_scales(lut).to(dev), dequant_scales(lut).to(dev))


def records_from_numpy(records, size_x: int, size_y: int,
                       device: torch.device | str | None = None
                       ) -> torch.Tensor:
    """A record stream, or a batch of them, as written by either package
    (flat H/2*W bytes per frame) -> u8 tensor of shape (H/2*W,) or
    (B, H/2*W) on ``device``.  The bytes are carried as they are, so this
    takes every stream of H/2*W bytes a frame: mode32, and enc-quant in
    the ``scalar`` and ``pair`` layouts (``pair_as_written`` too, which
    decodes in neither package)."""
    dev = default_device(device)
    return _flat_frames(_u8_array(records), (size_y // 2) * size_x, size_x,
                        size_y, dev)


def _u8_array(records) -> np.ndarray:
    arr = np.asarray(records)
    if arr.dtype != np.uint8:
        raise ValueError(f"records must be uint8, got {arr.dtype}")
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:     # torch warns on read-only buffers
        arr = arr.copy()
    return arr


def _flat_frames(arr: np.ndarray, per_frame: int, size_x: int, size_y: int,
                 dev: torch.device) -> torch.Tensor:
    """Flat streams of ``per_frame`` bytes a frame -> (n,) or (B, n)."""
    if per_frame <= 0 or arr.size % per_frame:
        raise ValueError(f"expected a multiple of {per_frame} bytes for "
                         f"{(size_x, size_y)}, got {arr.size}")
    shape = (-1,) if arr.ndim <= 1 else (arr.size // per_frame, per_frame)
    return torch.as_tensor(arr.reshape(shape), device=dev)


def stereo_records_from_numpy(records, size_x: int, size_y: int,
                              view_layout: str = "interleaved",
                              device: torch.device | str | None = None
                              ) -> torch.Tensor:
    """Stereo records, or a batch of them, as written by either package ->
    u8 tensor on ``device``: the interleaved stream (H*W bytes per frame)
    as (H*W,) or (B, H*W); the ``planar`` (..., 2, 64, H/16, W/8) and
    ``native`` (..., 2, 64, H/16, BWP) forms in their exact shape."""
    expect = record_shape(view_layout, size_y, size_x)
    dev = default_device(device)
    arr = _u8_array(records)
    if view_layout == "interleaved":
        return _flat_frames(arr, expect[0], size_x, size_y, dev)
    if arr.ndim not in (4, 5) or arr.shape[-4:] != expect:
        raise ValueError(f"{view_layout} stereo records must have shape "
                         f"(..., {', '.join(map(str, expect))}), got "
                         f"{arr.shape}")
    return torch.as_tensor(arr, device=dev)


def color_records_from_numpy(records, size_x: int, size_y: int,
                             device: torch.device | str | None = None
                             ) -> torch.Tensor:
    """YCbCr 4:4:4 colour records, or a batch of them, as written by either
    package (3*H/2*W bytes per frame: the mode32 stream of Y, then Cb, then
    Cr) -> u8 tensor of shape (3, H/2*W), or (B, 3, H/2*W) for more than one
    frame or a batched input (ndim >= 3), on ``device``."""
    plane = (size_y // 2) * size_x
    dev = default_device(device)
    arr = _u8_array(records)
    if plane <= 0 or arr.size == 0 or arr.size % (3 * plane):
        raise ValueError(f"expected a multiple of {3 * plane} bytes for "
                         f"{(size_x, size_y)}, got {arr.size}")
    batch = arr.size // (3 * plane)
    shape = (batch, 3, plane) if batch > 1 or arr.ndim >= 3 else (3, plane)
    return torch.as_tensor(arr.reshape(shape), device=dev)


def color420_records_from_numpy(records, size_x: int, size_y: int,
                                device: torch.device | str | None = None
                                ) -> torch.Tensor:
    """YCbCr 4:2:0 streams, or a batch of them, as written by either package
    (1.5*H/2*W bytes per frame: the mode32 records of Y, then of the
    half-resolution Cb and Cr) -> u8 tensor of shape (1.5*H/2*W,), or
    (B, 1.5*H/2*W) for a batched input (ndim >= 2, B == 1 included), on
    ``device``."""
    dev = default_device(device)
    arr = _u8_array(records)
    if arr.size == 0:
        raise ValueError("expected at least one frame of records, got none")
    return _flat_frames(arr, record_bytes_420(size_y // 2, size_x), size_x,
                        size_y, dev)


def tiles_from_numpy(tiles, h2: int, w: int,
                     device: torch.device | str | None = None
                     ) -> torch.Tensor:
    """Quantized coefficient tiles of a (h2, w) view, as the JAX package's
    ``_tiles_panels`` or ``panel.forward_tiles`` writes them, with optional
    leading axes: (..., h2/128, 128, w/128, 128) u8 -> the same tensor on
    ``device``."""
    if h2 <= 0 or w <= 0 or h2 % 128 or w % 128:
        raise ValueError(f"tiles need h2 % 128 == 0 and w % 128 == 0, got "
                         f"{(h2, w)}")
    expect = (h2 // 128, 128, w // 128, 128)
    dev = default_device(device)
    arr = _u8_array(tiles)
    if arr.ndim < 4 or arr.shape[-4:] != expect:
        raise ValueError(f"tiles must have shape (..., "
                         f"{', '.join(map(str, expect))}), got {arr.shape}")
    return torch.as_tensor(arr, device=dev)


def records_to_numpy(records: torch.Tensor) -> np.ndarray:
    """u8 record tensor (any device) -> numpy u8 array of the same shape,
    the form the JAX package's decode takes."""
    if records.dtype != torch.uint8:
        raise ValueError(f"records must be uint8, got {records.dtype}")
    return records.detach().cpu().numpy()
