"""Benchmark statistics (the reference's rdtsc / QPC statistics loop), the
rate-distortion sweep (``bench.rd``) and the BASELINE config ladder
(``bench.harness``, ``python -m simd_dct_tpu_torch.bench.harness``), the
last two imported on demand."""

from .stats import (
    MAX_RUN_COUNT, DEFAULT_RUN_COUNT, RunStats, HEADER, time_fn,
)

__all__ = ["MAX_RUN_COUNT", "DEFAULT_RUN_COUNT", "RunStats", "HEADER",
           "time_fn"]
