"""Quantization / dequantization with the reference's per-mode semantics.

Counterpart of ``simd_dct_tpu/core/quantize.py``: ``q = 255 / (lut * 0.95)``,
+127 bias, clamp to u8, in the three rounding variants ``rne`` (SSE/AVX,
round half to even), ``scalar`` (NoSimd, round half away in the /255
domain) and ``clamp_first`` (SSE2/SSSE3 stereo: float clamp, then RNE).
Every scale is computed on the host in f32, in the JAX package's operation
order, so the tensors are bit-identical to its ``quant_scales`` /
``dequant_scales`` on any device.
"""

from __future__ import annotations

import numpy as np
import torch

VR = np.float32(0.95)        # headroom factor (src/simd_dct.cpp:191,905,1871)
BIAS = np.float32(127.0)     # +127 coefficient bias (src/simd_dct.cpp:906,1880)
# f32(1/255), the pixel scale of the 1/255 domain (enc-quant and stereo;
# core/golden.py:184, kernels/xla_path.py:43)
INV_255 = np.float32(1.0 / 255.0)

ROUNDING_MODES = ("rne", "scalar", "clamp_first")

# The CLI's base quantize table (src/main.cpp:179-189).
BASE_QUANT_TABLE = np.array(
    [
        0.17, 0.11, 0.10, 0.16, 0.24, 0.40, 0.51, 0.61,
        0.12, 0.12, 0.14, 0.19, 0.26, 0.58, 0.60, 0.55,
        0.14, 0.13, 0.16, 0.24, 0.40, 0.57, 0.69, 0.56,
        0.14, 0.17, 0.22, 0.29, 0.51, 0.87, 0.80, 0.62,
        0.18, 0.22, 0.37, 0.56, 0.68, 1.09, 1.03, 0.77,
        0.24, 0.35, 0.55, 0.64, 0.81, 1.04, 1.13, 0.92,
        0.49, 0.64, 0.78, 0.87, 1.03, 1.21, 1.20, 1.01,
        0.72, 0.92, 0.95, 0.98, 1.12, 1.00, 1.03, 0.99,
    ],
    dtype=np.float32,
)


def default_quant_lut(quality: float | None = None) -> np.ndarray:
    """The CLI's 64-entry LUT, optionally scaled by ``--quality``
    (src/main.cpp:179-189,214-217)."""
    lut = BASE_QUANT_TABLE.copy()
    if quality is not None:
        lut *= np.float32(quality)
    return lut


def lut_array(lut) -> np.ndarray:
    """A 64-entry LUT (array-like, or a tensor on any device) as a flat
    host f32 array; ``ValueError`` for any other size."""
    if isinstance(lut, torch.Tensor):
        lut = lut.detach().cpu().numpy()
    arr = np.asarray(lut, np.float32).reshape(-1)
    if arr.size != 64:
        raise ValueError(f"lut must have 64 entries, got {arr.size}")
    return arr


def _lut_tensor(lut, device) -> torch.Tensor:
    if isinstance(lut, torch.Tensor):
        return lut.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(lut, np.float32), device=device)


def quant_scales(lut, device: torch.device | str = "cpu") -> torch.Tensor:
    """``q[p] = 255 / (lut[p] * 0.95)`` in f32, computed on the host and
    placed on ``device``."""
    lut = _lut_tensor(lut, "cpu")
    q = torch.tensor(255.0, dtype=torch.float32) / (lut * float(VR))
    return q.to(device)


def dequant_scales(lut, device: torch.device | str = "cpu") -> torch.Tensor:
    """Decode multiplier ``(lut * 0.95) / 255`` in f32, computed on the host
    and placed on ``device``: on the card PyTorch divides by a scalar as a
    multiply by its reciprocal, whose last bit can differ."""
    lut = _lut_tensor(lut, "cpu")
    return ((lut * float(VR)) / 255.0).to(device)


def quantize_to_u8(coeffs: torch.Tensor, scales: torch.Tensor,
                   rounding: str = "rne") -> torch.Tensor:
    """Quantize f32 coefficients to biased u8 per the selected variant.

    Every path clamps before the u8 cast: a negative or out-of-range float
    is never cast to ``torch.uint8`` directly.  ``rne`` clamps the rounded
    value to [-127, 128] in float, which equals the JAX package's int32
    ``clip(rint(x) + 127, 0, 255)`` for every finite input (rounding is
    monotone and the bounds are integers) and keeps the int32 cast in
    range for any scale."""
    return round_to_u8(coeffs * scales, rounding)


def round_to_u8(x: torch.Tensor, rounding: str = "rne") -> torch.Tensor:
    """Scaled f32 coefficients -> biased u8, the second half of
    ``quantize_to_u8`` (the panel engine scales its tiles itself)."""
    if rounding == "rne":
        v = torch.round(x).clamp(-127.0, 128.0).to(torch.int32) + 127
        return v.to(torch.uint8)
    if rounding == "clamp_first":
        v = torch.clamp(x + float(BIAS), 0.0, 255.0)
        return torch.round(v).to(torch.uint8)
    if rounding == "scalar":
        bias = torch.tensor(BIAS / np.float32(255.0), dtype=torch.float32)
        v = torch.clamp(x / 255.0 + bias.to(x.device), 0.0, 1.0) * 255.0
        return torch.floor(v + 0.5).to(torch.uint8)
    raise ValueError(f"unknown rounding mode {rounding!r}; "
                     f"expected one of {ROUNDING_MODES}")


def dequantize_from_u8(data: torch.Tensor,
                       inv_scales: torch.Tensor) -> torch.Tensor:
    """Invert ``quantize_to_u8``: ``(byte - 127) * (lut * 0.95) / 255``."""
    return (data.to(torch.float32) - float(BIAS)) * inv_scales
