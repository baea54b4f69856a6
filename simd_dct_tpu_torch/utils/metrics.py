"""Image-quality metrics (counterpart of ``simd_dct_tpu/utils/metrics.py``,
NumPy, unchanged).  Pass tensors as ``t.cpu()``."""

from __future__ import annotations

import numpy as np


def psnr(reference, reconstructed, peak: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB between two images/arrays."""
    a = np.asarray(reference, np.float64)
    b = np.asarray(reconstructed, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    mse = np.mean((a - b) ** 2)
    return float("inf") if mse == 0 else 10.0 * np.log10(peak * peak / mse)


def mse(reference, reconstructed) -> float:
    a = np.asarray(reference, np.float64)
    b = np.asarray(reconstructed, np.float64)
    return float(np.mean((a - b) ** 2))
