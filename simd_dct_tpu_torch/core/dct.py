"""8-point / 8x8 DCT-II transform math in PyTorch.

Counterpart of ``simd_dct_tpu/core/dct.py``.  The 2-D block transform is
``C = D @ X @ D.T`` with ``D`` the orthonormal DCT-II basis, assembled from
the reference butterfly's own f32 constants (src/simd_dct.cpp:140-146) so
that every matrix entry is bit-identical to the JAX package's
``dct_basis_np``.  The constants are carried here, not imported: the JAX
package's ``__init__`` imports jax, which this package must never do.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

C_A = np.float32(1.3870398453221474618216191915664)   # sqrt(2) * cos(1*pi/16)
C_B = np.float32(1.3065629648763765278566431734272)   # sqrt(2) * cos(2*pi/16)
C_C = np.float32(1.1758756024193587169744671046113)   # sqrt(2) * cos(3*pi/16)
C_D = np.float32(0.78569495838710218127789736765722)  # sqrt(2) * cos(5*pi/16)
C_E = np.float32(0.54119610014619698439972320536639)  # sqrt(2) * cos(6*pi/16)
C_F = np.float32(0.27589937928294301233595756366937)  # sqrt(2) * cos(7*pi/16)
C_NORM = np.float32(0.35355339059327376220042218105242)  # 1/sqrt(8)

_ONE = np.float32(1.0)


@functools.lru_cache(maxsize=None)
def _basis_f64() -> np.ndarray:
    n = np.arange(8)[None, :]
    k = np.arange(8)[:, None]
    d = np.sqrt(2.0 / 8.0) * np.cos((2 * n + 1) * k * np.pi / 16.0)
    d[0, :] = 1.0 / np.sqrt(8.0)
    return d


@functools.lru_cache(maxsize=None)
def dct_basis_np(dtype: str = "float32") -> np.ndarray:
    """The 8x8 orthonormal DCT-II basis ``D`` (rows = frequencies), built
    from the butterfly constants exactly as the JAX package builds it."""
    if dtype == "float64":
        return _basis_f64()
    a, b, c, d_, e, f, o = C_A, C_B, C_C, C_D, C_E, C_F, _ONE
    rows = np.array(
        [
            [o, o, o, o, o, o, o, o],
            [a, c, d_, f, -f, -d_, -c, -a],
            [b, e, -e, -b, -b, -e, e, b],
            [c, -f, -a, -d_, d_, a, f, -c],
            [o, -o, -o, o, o, -o, -o, o],
            [d_, -a, f, c, -c, -f, a, -d_],
            [e, -b, b, -e, -e, b, -b, e],
            [f, -d_, c, -a, a, -c, d_, -f],
        ],
        dtype=np.float32,
    )
    return (C_NORM * rows).astype(np.dtype(dtype))


def dct_basis(dtype: torch.dtype = torch.float32,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """``D`` as a tensor on ``device``."""
    name = "float64" if dtype == torch.float64 else "float32"
    return torch.as_tensor(dct_basis_np(name), device=device).to(dtype)


def dct8x8(blocks: torch.Tensor) -> torch.Tensor:
    """Forward 2-D DCT on ``(..., 8, 8)`` float blocks: ``C = D @ X @ D.T``
    (``C[..., u, v]``: u vertical, v horizontal frequency)."""
    d = dct_basis(blocks.dtype, blocks.device)
    return torch.einsum("uj,...jk,vk->...uv", d, blocks, d)


def idct8x8(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse 2-D DCT on ``(..., 8, 8)`` coefficients: ``X = D.T @ C @ D``."""
    d = dct_basis(coeffs.dtype, coeffs.device)
    return torch.einsum("ju,...jk,kv->...uv", d, coeffs, d)


def dct8(vecs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """1-D 8-point DCT-II along ``axis`` (which must have length 8)."""
    d = dct_basis(vecs.dtype, vecs.device)
    moved = torch.movedim(vecs, axis, -1)
    return torch.movedim(torch.einsum("kj,...j->...k", d, moved), -1, axis)


def idct8(vecs: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """1-D inverse 8-point DCT along ``axis``."""
    d = dct_basis(vecs.dtype, vecs.device)
    moved = torch.movedim(vecs, axis, -1)
    return torch.movedim(torch.einsum("jk,...j->...k", d, moved), -1, axis)
