"""Colour planes and the BT.601 YCbCr mix (counterpart of
``simd_dct_tpu/layout/color.py``).

The mix matrices are written out as f32 hex literals: the JAX package takes
``YCC2RGB`` from ``np.linalg.inv`` of the f32 forward matrix, whose bits
depend on the LAPACK build that computes it.  These literals are its bits
(its "zero" entries are 6.84e-9 and 1.56e-8, not 0); the CUDA kernels get
the same bits from here (``kernels/cuda_dct.py``).

Every mix sums its three products left to right in f32,
``(m0*x0 + m1*x1) + m2*x2``, then adds the bias: the order the colour
kernels of ``csrc/color32.cu`` use, so the plain version and the kernels
agree on the YCbCr values bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch


def _f32(rows) -> np.ndarray:
    return np.array([[float.fromhex(v) for v in row] for row in rows],
                    dtype=np.float32)


# JPEG-standard chroma quantization table (Annex K) on the reference's
# ~1/100 luma scale (src/main.cpp:179-189 divides classic tables by ~100).
BASE_CHROMA_QUANT_TABLE = np.array(
    [
        0.17, 0.18, 0.24, 0.47, 0.99, 0.99, 0.99, 0.99,
        0.18, 0.21, 0.26, 0.66, 0.99, 0.99, 0.99, 0.99,
        0.24, 0.26, 0.56, 0.99, 0.99, 0.99, 0.99, 0.99,
        0.47, 0.66, 0.99, 0.99, 0.99, 0.99, 0.99, 0.99,
        0.99, 0.99, 0.99, 0.99, 0.99, 0.99, 0.99, 0.99,
        0.99, 0.99, 0.99, 0.99, 0.99, 0.99, 0.99, 0.99,
        0.99, 0.99, 0.99, 0.99, 0.99, 0.99, 0.99, 0.99,
        0.99, 0.99, 0.99, 0.99, 0.99, 0.99, 0.99, 0.99,
    ],
    dtype=np.float32,
)

# BT.601 full-range RGB -> YCbCr (the JPEG convention), f32.
RGB2YCC = _f32([
    ["0x1.322d0ep-2", "0x1.2c8b44p-1", "0x1.d2f1aap-4"],
    ["-0x1.599234p-3", "-0x1.5336e6p-2", "0x1.000000p-1"],
    ["0x1.000000p-1", "-0x1.acbc70p-2", "-0x1.4d0e3ep-4"],
])
# Its f32 inverse, as the JAX package computes it.
YCC2RGB = _f32([
    ["0x1.000000p+0", "0x1.d61f9ep-28", "0x1.66e97ap+0"],
    ["0x1.000000p+0", "-0x1.606544p-2", "-0x1.6da346p-1"],
    ["0x1.000000p+0", "0x1.c5a1cap+0", "0x1.0c5dacp-26"],
])
# Added to Y, Cb, Cr after the forward mix (simd_dct_tpu/kernels/color32.py:39)
YCC_BIAS = np.array([0.0, 128.0, 128.0], dtype=np.float32)


def mix_planes(planes: torch.Tensor, matrix: np.ndarray,
               bias: np.ndarray | None = None) -> torch.Tensor:
    """(..., 3, H, W) f32 -> (..., 3, H, W) f32: plane i is
    ``(m[i,0]*x0 + m[i,1]*x1) + m[i,2]*x2`` (+ ``bias[i]``), every step
    rounded to f32."""
    m = torch.as_tensor(matrix, device=planes.device)
    x0, x1, x2 = planes.unbind(-3)
    out = []
    for i in range(3):
        v = x0 * m[i, 0] + x1 * m[i, 1] + x2 * m[i, 2]
        if bias is not None:
            v = v + torch.as_tensor(bias[i], device=planes.device)
        out.append(v)
    return torch.stack(out, dim=-3)


def rgb_to_planar(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) interleaved -> (..., 3, H, W) planar."""
    return img.movedim(-1, -3)


def planar_to_rgb(planes: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) planar -> (..., H, W, 3) interleaved."""
    return planes.movedim(-3, -1)


def rgb_to_ycbcr(img: torch.Tensor) -> torch.Tensor:
    """u8 (..., H, W, 3) RGB -> f32 (..., H, W, 3) YCbCr (Cb/Cr biased
    +128)."""
    planes = rgb_to_planar(img).to(torch.float32)
    return planar_to_rgb(mix_planes(planes, RGB2YCC, YCC_BIAS))


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    """f32 (..., H, W, 3) YCbCr -> u8 RGB (round half to even, clipped)."""
    planes = rgb_to_planar(ycc) - torch.as_tensor(
        YCC_BIAS, device=ycc.device)[:, None, None]
    rgb = mix_planes(planes, YCC2RGB)
    return planar_to_rgb(torch.clamp(torch.round(rgb), 0.0, 255.0)
                         .to(torch.uint8))
