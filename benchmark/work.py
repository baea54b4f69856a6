"""The work a call needs, counted from its shapes alone.

Bytes: each input byte read once and each output byte written once,
whatever a kernel reads again.  Operations: f32 fused multiply-adds of the
cheapest transform, 29 an 8-point DCT or IDCT (the upstream's butterfly,
src/simd_dct.cpp:140-146), 16 of them an 8x8 block, plus one a coefficient
for the quantizer and one for the dequantizer; the 1/255 and 255 scales of
the stereo domain fold into those.  The counts do not depend on what
implements the call, so a later program that does the same work with
other kernels reads against the same least time.
"""

from __future__ import annotations

from typing import NamedTuple

FMA_PER_TRANSFORM = 29
TRANSFORMS_PER_BLOCK = 16
FMA_PER_BLOCK = FMA_PER_TRANSFORM * TRANSFORMS_PER_BLOCK   # 464
COEFFS_PER_BLOCK = 64


class Work(NamedTuple):
    bytes: int      # read once and written once
    fmas: int       # f32 fused multiply-adds

    def least_seconds(self, peaks: dict) -> float:
        """The least time a card with ``peaks`` needs for this work: the
        larger of its bytes over the memory bandwidth and its FMAs over the
        f32 FMA rate."""
        return max(self.bytes / peaks["hbm_bytes_per_s"],
                   self.fmas / peaks["f32_fma_per_s"])


def _blocks(h: int, w: int) -> int:
    return (h // 8) * (w // 8)


def stereo_encode(batch: int, h: int, w: int) -> Work:
    """Both views of ``batch`` (h, w) u8 dual views -> as many record bytes."""
    pixels = batch * h * w
    return Work(2 * pixels, batch * _blocks(h, w)
                * (FMA_PER_BLOCK + COEFFS_PER_BLOCK))


def stereo_decode(batch: int, h: int, w: int) -> Work:
    """``batch`` dual views' records -> (h, w) u8 pixels each."""
    return stereo_encode(batch, h, w)


def mode32_encode(batch: int, h: int, w: int) -> Work:
    """The top (h/2, w) view of ``batch`` dual-view buffers -> as many
    record bytes; the bottom views are never read."""
    pixels = batch * (h // 2) * w
    return Work(2 * pixels, batch * _blocks(h // 2, w)
                * (FMA_PER_BLOCK + COEFFS_PER_BLOCK))


def mode32_roundtrip(batch: int, h: int, w: int) -> Work:
    """The top (h/2, w) view of ``batch`` dual-view buffers -> as many
    pixels: an encode and a decode, the records never stored."""
    pixels = batch * (h // 2) * w
    return Work(2 * pixels, batch * _blocks(h // 2, w)
                * 2 * (FMA_PER_BLOCK + COEFFS_PER_BLOCK))
