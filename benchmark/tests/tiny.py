"""A copy of the benchmark at a tiny size, for runs on the CPU."""

import json
import shutil
from pathlib import Path

from benchmark import harness

TINY_BUFFER = [32, 128]     # one strip of each view; W a multiple of 64
TINY_BATCH = 2


def tiny_copy(dest: Path) -> Path:
    """``BENCHMARK.json`` and ``benchmark/`` under ``dest``, every
    configuration cut to ``TINY_BUFFER`` and every cell to ``TINY_BATCH``
    frames a call."""
    shutil.copy(harness.ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.Bench(dest)
    for c in bench.spec["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["buffer"] = TINY_BUFFER
        path.write_text(json.dumps(cfg))
    for path in (dest / "benchmark" / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        wl["batch"] = TINY_BATCH
        path.write_text(json.dumps(wl))
    return dest
