"""The YCbCr 4:2:0 record stream and the 2x2 chroma pool and replicate
(counterpart of ``pack_records`` / ``unpack_records`` and the chroma
resampling of ``simd_dct_tpu/kernels/color420.py``).

A frame's stream is one flat run of 1.5*H2*W bytes for an H2 x W top view:
the mode32 records of Y (H2*W bytes), then those of the half-resolution
Cb plane, then Cr (H2*W/4 bytes each).

``pool2x2`` sums in a fixed order, ``((x00 + x01) + (x10 + x11)) * 0.25``
in f32, the order the kernels of ``csrc/color420.cu`` use, so the plain
version and the kernels agree on the pooled chroma bit for bit.
"""

from __future__ import annotations

import torch


def record_bytes_420(h2: int, w: int) -> int:
    """Bytes of one frame's 4:2:0 stream for an h2 x w top view."""
    return (3 * h2 * w) // 2


def pack_records(y_rec: torch.Tensor, c_rec: torch.Tensor) -> torch.Tensor:
    """((..., S, 8W) Y records, (..., 2, S/2, 4W) Cb and Cr records) ->
    (..., 1.5*H2*W) flat stream [Y | Cb | Cr]."""
    lead = y_rec.shape[:-2]
    return torch.cat([y_rec.reshape(*lead, -1), c_rec.reshape(*lead, -1)],
                     dim=-1)


def unpack_records(data: torch.Tensor, size_x: int,
                   h2: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 1.5*H2*W) flat stream -> ((..., S, 8W), (..., 2, S/2, 4W))
    views of its Y and its Cb, Cr records."""
    n_y = h2 * size_x
    lead = data.shape[:-1]
    y_rec = data[..., :n_y].reshape(*lead, h2 // 8, 8 * size_x)
    c_rec = data[..., n_y:].reshape(*lead, 2, h2 // 16, 4 * size_x)
    return y_rec, c_rec


def pool2x2(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) f32 -> (..., H/2, W/2): the mean of each 2x2 pixel
    square, ``((x00 + x01) + (x10 + x11)) * 0.25``, every step rounded."""
    top = x[..., 0::2, 0::2] + x[..., 0::2, 1::2]
    bottom = x[..., 1::2, 0::2] + x[..., 1::2, 1::2]
    return (top + bottom) * 0.25


def replicate2x2(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W) -> (..., 2H, 2W): each value over a 2x2 pixel square."""
    return x.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
