"""Profiling and roofline reporting (counterpart of
``simd_dct_tpu/utils/profiling.py``; the reference's rdtsc + mfence harness,
src/main.cpp:508-592, re-expressed for a CUDA card: walls ended by a CUDA
event synchronise, ``torch.profiler`` traces, and fraction-of-roofline
reporting).  ``queued_ms`` is the device time a call: CUDA events around
calls queued behind a device-side sleep, so the host's launch cost stays
out of the reading; ``chip_smoke.py`` and ``bench.harness`` time with it.

Device rule: work runs on the card unless the caller asks for the host
(``device="cpu"``, or CPU tensors among ``measure``'s arguments); on a
machine with no card a call that did not ask for the host raises
``NotSupportedError``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import statistics
import time

import torch

from ..dispatch.capability import default_device


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """Per-card figures from NVIDIA's data sheets (dense rates, no
    sparsity), used for roofline fractions where no same-run copy is
    measured."""
    name: str            # product name
    hbm_gbps: float      # peak device-memory GB/s
    bf16_tflops: float   # peak dense bf16 tensor-core TFLOP/s
    hbm_gb: float        # device memory, GB


# Keyed by a prefix of ``torch.cuda.get_device_name()``; the longest
# matching prefix wins.
CHIP_SPECS = {
    "NVIDIA H100 80GB HBM3": ChipSpec("H100 SXM", 3350.0, 989.0, 80.0),
    "NVIDIA H100 PCIe": ChipSpec("H100 PCIe", 2000.0, 756.0, 80.0),
    "NVIDIA H100 NVL": ChipSpec("H100 NVL", 3900.0, 835.0, 94.0),
}


def _device_kind(device: torch.device) -> str:
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def chip_spec(device_kind: str | None = None) -> ChipSpec | None:
    """Longest-prefix spec lookup (``device_kind`` defaults to the card's
    name); None for unknown kinds, so callers report an unknown roofline
    rather than assume a card."""
    if device_kind is None:
        device_kind = _device_kind(default_device(None))
    best = None
    for k, v in CHIP_SPECS.items():
        if device_kind.startswith(k) and (best is None or len(k) > best[0]):
            best = (len(k), v)
    return best[1] if best else None


def hbm_peak_gbps(device_kind: str | None = None) -> float | None:
    """Peak device-memory GB/s for the device kind, or None when unknown."""
    spec = chip_spec(device_kind)
    return spec.hbm_gbps if spec else None


@dataclasses.dataclass
class RooflineReport:
    bytes_processed: int
    seconds: float
    device_kind: str

    @property
    def gbps(self) -> float:
        return self.bytes_processed / self.seconds / 1e9

    @property
    def fraction_of_roofline(self) -> float | None:
        peak = hbm_peak_gbps(self.device_kind)
        return None if peak is None else self.gbps / peak

    def __str__(self) -> str:
        frac = self.fraction_of_roofline
        if frac is None:
            return (f"{self.gbps:.1f} GB/s on {self.device_kind} "
                    f"(unknown roofline for this device kind)")
        return (f"{self.gbps:.1f} GB/s on {self.device_kind} "
                f"({100 * frac:.1f}% of "
                f"{hbm_peak_gbps(self.device_kind):.0f} GB/s HBM roofline)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(device=None):
    """Wall-clock a region; the result object gains ``.seconds`` after the
    block exits.  On the card the wall ends when an event recorded on the
    current stream at the block's end has completed, so work queued
    inside the block is counted."""
    dev = default_device(device)

    class _T:
        seconds = None
    t = _T()
    t0 = time.perf_counter()
    try:
        yield t
    finally:
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            done.synchronize()
        t.seconds = time.perf_counter() - t0


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (the card's activity too when
    there is one); writes a Chrome trace, ``log_dir/trace.json``, and
    yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _args_device(args, device) -> torch.device:
    if device is None:
        for a in args:
            if isinstance(a, torch.Tensor):
                return a.device
    return default_device(device)


def measure(fn, args=(), *, bytes_processed: int, runs: int = 16,
            warmup: int = 2, device=None) -> RooflineReport:
    """Queued measurement: enqueue ``runs`` calls, synchronise once
    (amortises the per-call launch cost).  The device is ``device``, else
    that of the first tensor in ``args``, else the card."""
    dev = _args_device(args, device)
    for _ in range(warmup):
        fn(*args)
        _sync(dev)
    t0 = time.perf_counter()
    results = [fn(*args) for _ in range(runs)]
    _sync(dev)
    dt = (time.perf_counter() - t0) / runs
    del results
    return RooflineReport(bytes_processed=bytes_processed, seconds=dt,
                          device_kind=_device_kind(dev))


# -- device time per call on the card -----------------------------------------

def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on the current
    card."""
    torch.cuda._sleep(1000)
    start, end = _events()
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def wall_ms(fn, inputs, reps):
    """Median ms per call of back-to-back calls between two CUDA events:
    the pace a caller sees, host launch cost included."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    start, end = _events()
    per_call = []
    for _ in range(reps):
        start.record()
        for x in inputs:
            fn(x)
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / len(inputs))
    return statistics.median(per_call)


def queued_ms(fn, inputs, reps, cycles_per_ms):
    """Median device ms per call by CUDA events, with the host's launch cost
    hidden: each repetition queues the whole rotation behind a device-side
    sleep, so the kernels run back to back.  A repetition counts only if
    the host finished queueing before the device reached the first launch;
    otherwise the sleep doubles.  Rotate over inputs larger than the L2
    cache (50 MB on an H100) to time reads from device memory.  fn must
    not synchronise."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in inputs:
        fn(x)
    sleep_ms = 2e3 * (time.perf_counter() - t0) + 0.5
    torch.cuda.synchronize()
    start, end = _events()
    per_call = []
    while len(per_call) < reps:
        if sleep_ms >= 1000:
            raise RuntimeError("the host did not queue a rotation within 1 s")
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        start.record()
        for x in inputs:
            fn(x)
        end.record()
        hidden = not start.query()
        end.synchronize()
        if hidden:
            per_call.append(start.elapsed_time(end) / len(inputs))
        else:
            sleep_ms *= 2
    return statistics.median(per_call)
