"""Benchmark statistics (the reference's rdtsc / QPC statistics loop) and
the rate-distortion sweep (``bench.rd``, imported on demand)."""

from .stats import (
    MAX_RUN_COUNT, DEFAULT_RUN_COUNT, RunStats, HEADER, time_fn,
)

__all__ = ["MAX_RUN_COUNT", "DEFAULT_RUN_COUNT", "RunStats", "HEADER",
           "time_fn"]
