"""Seeded u8 frames, made on the device in a few large calls.

A frame is a smooth random field (a coarse grid of random levels, upsampled
bicubically), a finer field of smaller amplitude, and Gaussian noise: the
mix of flat areas, gradients and grain of camera frames, so that the
quantizer meets every range of coefficients.  The kernels' work does not
depend on the pixels, so every seed gives the same work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def generator(seed: int, stream: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` for sub-stream ``stream`` of ``seed`` (any
    whole number)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def _field(g: torch.Generator, n: int, h: int, w: int, cell: int,
           device: torch.device) -> torch.Tensor:
    """(n, h, w) f32 in [0, 1): random levels on a grid of ``cell`` pixels,
    upsampled bicubically."""
    coarse = torch.rand((n, 1, h // cell + 3, w // cell + 3), generator=g,
                        device=device)
    up = F.interpolate(coarse, scale_factor=float(cell), mode="bicubic",
                       align_corners=False)
    return up[:, 0, cell:cell + h, cell:cell + w]


def frames(g: torch.Generator, n: int, h: int, w: int,
           device: torch.device, chunk: int = 4) -> torch.Tensor:
    """(n, h, w) u8 frames from ``g``, ``chunk`` frames a step."""
    out = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for lo in range(0, n, chunk):
        k = min(chunk, n - lo)
        x = 40.0 + 175.0 * _field(g, k, h, w, 64, device)
        x += 40.0 * (_field(g, k, h, w, 8, device) - 0.5)
        x += 4.0 * torch.randn((k, h, w), generator=g, device=device)
        out[lo:lo + k] = x.round_().clamp_(0.0, 255.0).to(torch.uint8)
    return out
