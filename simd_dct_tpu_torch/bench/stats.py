"""Benchmark statistics mirroring the reference harness's reporting
(counterpart of ``simd_dct_tpu/bench/stats.py``, the same rows).

The reference records per-run rdtsc cycles + wall ns for up to 1024 runs and
reports min / mean / stddev as clocks-per-byte and MiB/s
(src/main.cpp:21-80,508-592).  Here each run is a wall in ns, ended by a
synchronise with the card for card work, reported as ns/byte and GB/s.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

MAX_RUN_COUNT = 1024          # src/main.cpp:21
DEFAULT_RUN_COUNT = 128       # src/main.cpp:22


@dataclasses.dataclass
class RunStats:
    name: str
    bytes_processed: int
    ns: list[float]

    @property
    def min_ns(self) -> float:
        return min(self.ns)

    @property
    def mean_ns(self) -> float:
        return sum(self.ns) / len(self.ns)

    @property
    def stddev_ns(self) -> float:
        m = self.mean_ns
        return math.sqrt(sum((x - m) ** 2 for x in self.ns) / len(self.ns))

    def gbps(self, ns: float) -> float:
        return self.bytes_processed / ns  # bytes/ns == GB/s

    def mibps(self, ns: float) -> float:
        return (self.bytes_processed / (1 << 20)) / (ns * 1e-9)

    @property
    def ns_per_byte(self) -> float:
        return self.min_ns / self.bytes_processed

    def row(self) -> str:
        return (f"{self.name:<28} | {self.ns_per_byte:9.4f} ns/B | "
                f"{self.gbps(self.min_ns):8.2f} GB/s (min) | "
                f"{self.gbps(self.mean_ns):8.2f} GB/s (mean) | "
                f"sigma {self.stddev_ns / 1e6:7.3f} ms")


HEADER = (f"{'codec':<28} | {'ns/byte':>12} | {'GB/s (best)':>16} | "
          f"{'GB/s (mean)':>16} | stddev")


def time_fn(name: str, fn: Callable[[], object], bytes_processed: int,
            runs: int = DEFAULT_RUN_COUNT, warmup: int = 3,
            sync: Callable[[object], None] | None = None) -> RunStats:
    """Run ``fn`` ``runs`` times (after ``warmup``), timing each run.

    ``sync(result)`` must block until the work is done; for card work,
    ``lambda r: torch.cuda.synchronize()``.
    """
    runs = min(runs, MAX_RUN_COUNT)
    if sync is None:
        sync = lambda r: None
    for _ in range(warmup):
        sync(fn())
    ns = []
    for _ in range(runs):
        t0 = time.perf_counter_ns()
        sync(fn())
        ns.append(time.perf_counter_ns() - t0)
    return RunStats(name=name, bytes_processed=bytes_processed, ns=ns)
