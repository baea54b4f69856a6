"""Auxiliary subsystems: profiling and roofline reporting, the pipelined
frame feed, verification aids and image-quality metrics."""

from .profiling import (
    CHIP_SPECS, ChipSpec, chip_spec, hbm_peak_gbps, RooflineReport,
    device_timer, trace, measure, queued_ms, sleep_cycles_per_ms, wall_ms,
)
from .debug import check_deterministic, compare_backends
from .feed import (FrameFeeder, stream_roundtrip32,
                   stream_encode32_compressed,
                   stream_decode32_compressed)
from .metrics import psnr, mse

__all__ = [
    "CHIP_SPECS", "ChipSpec", "chip_spec", "hbm_peak_gbps",
    "RooflineReport", "device_timer", "trace", "measure",
    "queued_ms", "sleep_cycles_per_ms", "wall_ms",
    "check_deterministic", "compare_backends",
    "psnr", "mse",
    "FrameFeeder", "stream_roundtrip32", "stream_encode32_compressed",
    "stream_decode32_compressed",
]
