"""Bit-exact butterfly DCT + quantization (``compat=True`` on the numpy tier).

The port's own copy of ``simd_dct_tpu/core/butterfly.py``.  The other
tiers evaluate the 2-D DCT as matmuls against the basis matrix, a
*different f32 association order* than the reference butterfly
(src/simd_dct.cpp:138-172), so quantized bytes can differ by ±1 when a
coefficient lands exactly on a rounding boundary.

This module evaluates the SAME 29-mul/29-add dataflow as the reference
butterfly (and as ``native/golden_dct.cpp:dct8``, the strict-IEEE oracle),
op for op, left-to-right — so its f32 results are bit-identical to the
oracle.  Quantization is likewise evaluated in the oracle's exact op order
per rounding mode, including a true ``roundf`` (half-away-from-zero)
instead of the ``floor(v+0.5)`` approximation (which diverges when
``v+0.5`` rounds up across an integer).

NumPy ONLY: plain NumPy never contracts mul+add into an FMA, so the
association order holds by construction (``kernels/compat.py`` is the
same dataflow in eager PyTorch ops on any device).
"""

from __future__ import annotations

import numpy as np

from .dct import C_A, C_B, C_C, C_D, C_E, C_F, C_NORM
from .quantize import VR

__all__ = [
    "dct8_butterfly", "dct2d_fx_major", "dct2d_fy_major", "quantize_exact",
]

_HALF_BIAS = np.float32(np.float32(127.0) / np.float32(255.0))


def dct8_butterfly(v):
    """1-D 8-point DCT-II along the last axis (length 8), evaluated with the
    reference butterfly's exact f32 association order
    (src/simd_dct.cpp:148-171 dataflow; ≡ native/golden_dct.cpp:dct8).
    NumPy arrays only (see module docstring)."""
    v0, v1, v2, v3 = v[..., 0], v[..., 1], v[..., 2], v[..., 3]
    v4, v5, v6, v7 = v[..., 4], v[..., 5], v[..., 6], v[..., 7]
    x07p = v0 + v7
    x16p = v1 + v6
    x25p = v2 + v5
    x34p = v3 + v4
    x07m = v0 - v7
    x61m = v6 - v1
    x25m = v2 - v5
    x43m = v4 - v3
    pp = x07p + x34p
    pm = x07p - x34p
    qp = x16p + x25p
    qm = x16p - x25p

    def m(c, x):  # individually-rounded product (NumPy never contracts)
        return c * x

    o0 = C_NORM * (pp + qp)
    o2 = C_NORM * (m(C_B, pm) + m(C_E, qm))
    o4 = C_NORM * (pp - qp)
    o6 = C_NORM * (m(C_E, pm) - m(C_B, qm))
    o1 = C_NORM * (m(C_A, x07m) - m(C_C, x61m) + m(C_D, x25m) - m(C_F, x43m))
    o3 = C_NORM * (m(C_C, x07m) + m(C_F, x61m) - m(C_A, x25m) + m(C_D, x43m))
    o5 = C_NORM * (m(C_D, x07m) + m(C_A, x61m) + m(C_F, x25m) - m(C_C, x43m))
    o7 = C_NORM * (m(C_F, x07m) + m(C_D, x61m) + m(C_C, x25m) + m(C_A, x43m))
    return np.stack([o0, o1, o2, o3, o4, o5, o6, o7], axis=-1)


def _swap(b):
    return np.swapaxes(b, -1, -2)


def dct2d_fx_major(blocks):
    """enc-quant orientation on (..., 8, 8) blocks: DCT rows, transpose,
    DCT rows (src/simd_dct.cpp:347-358); flattening the result gives the
    fx-major 64-float buffer."""
    b = dct8_butterfly(blocks)
    b = _swap(b)
    return dct8_butterfly(b)


def dct2d_fy_major(blocks):
    """stereo / mode32 orientation: leading transpose, DCT rows, transpose,
    DCT rows (src/simd_dct.cpp:224-227); flat result is fy-major."""
    b = dct8_butterfly(_swap(blocks))
    b = _swap(b)
    return dct8_butterfly(b)


def _roundf_nonneg(v):
    """Exact ``roundf`` (round-half-away-from-zero) for v >= 0: the
    ``floor(v + 0.5)`` shortcut diverges when ``v + 0.5f`` rounds up across
    an integer; comparing the exact fraction ``v - floor(v)`` does not."""
    w = np.floor(v)
    return np.where(v - w >= np.float32(0.5), w + np.float32(1.0), w)


def quantize_exact(buffer, lut, rounding: str):
    """Quantize f32 coefficient buffers (..., 64) to u8 with the oracle's
    exact op order (native/golden_dct.cpp:quantize_one / build_qtables;
    reference: src/simd_dct.cpp:1020-1024, :245, :1245-1249).

    ``lut`` is the raw 64-entry table; the per-mode q tables are computed
    here exactly as the oracle does (255/(lut*vr) and 1/(lut*vr), f32)."""
    lut_f = np.asarray(lut, np.float32).reshape(64)
    q_rne = (np.float32(255.0) / (lut_f * VR)).astype(np.float32)
    if rounding == "rne":
        x = buffer * q_rne
        v = np.rint(x).astype(np.int32) + 127
        return np.clip(v, 0, 255).astype(np.uint8)
    if rounding == "clamp_first":
        x = buffer * q_rne
        v = np.clip(x + np.float32(127.0), np.float32(0.0), np.float32(255.0))
        return np.rint(v).astype(np.uint8)
    if rounding == "scalar":
        q_scalar = (np.float32(1.0) / (lut_f * VR)).astype(np.float32)
        x = buffer * q_scalar
        v = np.clip(x + _HALF_BIAS, np.float32(0.0), np.float32(1.0)) \
            * np.float32(255.0)
        return _roundf_nonneg(v).astype(np.uint8)
    raise ValueError(f"unknown rounding {rounding!r}")
