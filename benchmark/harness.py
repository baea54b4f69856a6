"""The benchmark of ``simd_dct_tpu_torch``: one cell a run, driven by data.

``BENCHMARK.json`` names the cells, configurations and metrics; every piece
is a file found by its name:

* ``benchmark/workloads/<cell>.json``: the traffic of a cell (the kind of
  call, frames a call, calls in flight, input batches that alternate, the
  calls whose outputs are judged) and the limits of its comparison;
* the configuration's ``file``: sizes, LUT and rounding;
* ``benchmark/entries/<entry>.py``: how a kind of call is made, its seeded
  inputs, its work and what the reference computes for it;
* ``benchmark/metrics/<metric>.py``: a reader that takes one metric from
  the run's ``Readings``, or gives ``None`` when it finds nothing to read.

A run makes its inputs on the card from the seed, warms up the cell's own
shapes, then keeps ``in_flight`` calls queued for ``--seconds`` (a closed
loop: before each call the host stamps the clock and submits it, a CUDA
event follows the call, and once ``in_flight`` calls are outstanding the
host waits for the oldest).  With ``--trace 1`` the window runs under
``torch.profiler`` and the run reports the per-layer metrics in place of
the end-to-end ones.  After the window the outputs of a few calls drawn
from the seed are compared with the plain reference
(``benchmark/reference``), and the last line of standard output is the
result as one JSON object.
"""

from __future__ import annotations

import collections
import gc
import importlib.util
import json
import os
import random
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Callable, NamedTuple

from benchmark import trace as trace_mod

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "simd_dct_tpu")
PROGRAM = "simd_dct_tpu_torch"


def log(*parts: Any) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, the
    names compared whole (``simd_dct_tpu_torch`` is not ``simd_dct_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def _load(path: Path, kind: str):
    """The module in ``path``, loaded under a name of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` of the checkout at ``root`` and the files it
    names."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def _named(self, key: str, name: str) -> dict:
        for item in self.spec[key]:
            if item["name"] == name:
                return item
        raise KeyError(f"BENCHMARK.json has no {key[:-1]} named {name!r}")

    def cell(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        """The configuration's file; its LUT as 64 host f32, as a caller
        keeps it."""
        with open(self.root / self._named("configs", name)["file"]) as f:
            cfg = json.load(f)
        import numpy as np
        cfg["lut"] = np.asarray(cfg["lut"], np.float32)
        return cfg

    def workload(self, name: str) -> dict:
        """The cell's traffic file, checked against its entry."""
        cell = self.cell(name)
        with open(self.dir / "workloads" / f"{name}.json") as f:
            wl = json.load(f)
        for key in ("config", "traffic"):
            if wl[key] != cell[key]:
                raise ValueError(f"workloads/{name}.json: {key} {wl[key]!r}, "
                                 f"BENCHMARK.json {cell[key]!r}")
        return wl

    def entry(self, name: str):
        return _load(self.dir / "entries" / f"{name}.py", "entry")

    def metric(self, name: str):
        return _load(self.dir / "metrics" / f"{name}.py", "metric")

    def metrics_of(self, cell: str, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def peaks(self) -> dict:
        with open(self.dir / "peaks.json") as f:
            return json.load(f)


class Readings(NamedTuple):
    """What one run measured; the metric readers take their numbers from
    it."""
    calls: int                  # calls completed in the window
    frames: int                 # frames those calls returned
    window_s: float             # host clock: first submission to last completion
    host_s: list[float]         # each call's enqueue, entry to return
    latency_s: list[float]      # each call's submission to its observed completion
    setup_s: float
    peak_bytes: int             # the program's peak, the held samples left out
    work: Any                   # work.Work of one call
    peaks: dict | None          # the card's entry of peaks.json
    trace: Any                  # trace.Trace of a traced run, else None


# -- the stream and the allocator ---------------------------------------------

class _CudaMarks:
    """A ring of events recorded on the current stream after each call."""

    def __init__(self, torch, size: int):
        self.torch = torch
        self.stream = torch.cuda.current_stream()
        self.ring = [torch.cuda.Event() for _ in range(size)]
        self.i = 0

    def mark(self):
        ev = self.ring[self.i % len(self.ring)]
        self.i += 1
        ev.record(self.stream)
        return ev

    @staticmethod
    def wait(ev) -> None:
        ev.synchronize()

    def sync(self) -> None:
        self.torch.cuda.synchronize()


class _HostMarks:
    """The same on the CPU, where every call has finished when it returns
    (the tests' tiny runs)."""

    @staticmethod
    def mark():
        return None

    @staticmethod
    def wait(_) -> None:
        pass

    def sync(self) -> None:
        pass


def _block_bytes(t) -> int:
    """The bytes the CUDA caching allocator counts for ``t``'s storage: its
    size rounded up to the allocator's 512-byte blocks."""
    n = t.untyped_storage().nbytes()
    return -(-n // 512) * 512


class _Memory:
    """The allocator's peak, read in segments between the calls whose
    outputs the benchmark holds for its comparison, so that those held
    outputs can be left out: the program's peak is the largest of each
    segment's peak less the held bytes that were live through it."""

    def __init__(self, torch=None, device=None):
        self.torch, self.device = torch, device
        self.raw = 0            # the card's peak, the held outputs in it
        self.program = 0        # the same less the held outputs

    def start(self) -> None:
        if self.torch is not None:
            self.torch.cuda.reset_peak_memory_stats(self.device)

    def mark(self, held_bytes: int) -> None:
        """Close the segment through which ``held_bytes`` were held."""
        if self.torch is None:
            return
        peak = self.torch.cuda.max_memory_allocated(self.device)
        self.raw = max(self.raw, peak)
        self.program = max(self.program, peak - held_bytes)
        self.torch.cuda.reset_peak_memory_stats(self.device)


class _Loop(NamedTuple):
    calls: int
    window_s: float
    host_s: list
    latency_s: list
    held: list          # (call index, input index, output)
    error: str | None


def closed_loop(call: Callable, xs: list, marks, memory: _Memory, *,
                in_flight: int, seconds: float, max_calls: int | None = None,
                hold: Callable[[int, float], bool] = lambda n, t: False,
                label: Callable | None = None) -> _Loop:
    """Submit calls on ``xs`` in turn, ``in_flight`` outstanding, until
    ``seconds`` have passed since the first submission (or ``max_calls``
    were made), then wait for the rest.  The host stamps each call's
    submission; an event follows the call on the stream, and once
    ``in_flight`` calls are outstanding the host waits for the oldest's
    event and stamps its completion.  Like a pipelined caller, the loop
    keeps each output until its completion is seen.  ``hold(n, t)`` keeps
    call n's output for the comparison (t: seconds into the window at its
    submission)."""
    pending: collections.deque = collections.deque()
    host_s, latency_s, held = [], [], []
    held_bytes = 0
    error = None

    def retire():
        t_sub, mark, _ = pending.popleft()
        marks.wait(mark)
        latency_s.append(time.perf_counter() - t_sub)

    memory.start()
    n = 0
    t0 = time.perf_counter()
    while True:
        t_sub = time.perf_counter()
        if t_sub - t0 >= seconds or (max_calls is not None and n >= max_calls):
            break
        x = xs[n % len(xs)]
        try:
            if label is None:
                out = call(x)
            else:
                with label():
                    out = call(x)
        except Exception:                    # a call that fails ends the window
            error = traceback.format_exc()
            break
        host_s.append(time.perf_counter() - t_sub)
        pending.append((t_sub, marks.mark(), out))
        if hold(n, t_sub - t0):
            memory.mark(held_bytes)
            held.append((n, n % len(xs), out))
            held_bytes += _block_bytes(out)
        del out
        n += 1
        if len(pending) >= in_flight:
            retire()
    while pending:
        retire()
    window_s = time.perf_counter() - t0
    memory.mark(held_bytes)
    return _Loop(n, window_s, host_s, latency_s, held, error)


def pin_this_thread() -> set[int] | None:
    """Keep the calling thread on one core, the last it may use, so that the
    window's host work does not move between cores; returns the cores it
    had, for ``unpin``.  Threads started before keep their own cores."""
    cores = os.sched_getaffinity(0)
    if len(cores) < 2:
        return None
    os.sched_setaffinity(0, {max(cores)})
    return cores


def unpin(cores: set[int] | None) -> None:
    if cores is not None:
        os.sched_setaffinity(0, cores)


def sample_points(seed: int, k: int) -> list[float]:
    """Where in the window (shares of its length) the judged calls are
    submitted: ``k`` points drawn from the seed."""
    rng = random.Random(f"samples:{seed}")
    return sorted(rng.uniform(0.05, 0.95) for _ in range(k))


def _holder(points: list[float], seconds: float):
    """A ``hold`` for ``closed_loop``: the first call submitted at or after
    each point."""
    todo = list(points)

    def hold(n: int, t: float) -> bool:
        taken = False
        while todo and t >= todo[0] * seconds:
            todo.pop(0)
            taken = True
        return taken
    return hold


# -- one run ------------------------------------------------------------------

def compare(out, ref) -> tuple[int, int, int]:
    """(largest absolute byte difference, bytes that differ, bytes) of an
    output against its u8 reference, a frame at a time.  An output of
    another shape or type differs in every byte, by 256."""
    import torch
    if out.shape != ref.shape or out.dtype != ref.dtype:
        return 256, ref.numel(), ref.numel()
    worst = differ = 0
    for a, b in zip(out, ref):
        d = (a.to(torch.int16) - b.to(torch.int16)).abs_()
        worst = max(worst, int(d.max()))
        differ += int(torch.count_nonzero(d))
    return worst, differ, out.numel()


def judged(out_ref_pairs, limits: dict) -> tuple[dict, int]:
    """The numbers compared over the judged outputs, each beside its limit,
    and how many of those outputs fail a limit alone."""
    worst = differ = total = bad = 0
    for out, ref in out_ref_pairs:
        w, d, t = compare(out, ref)
        worst, differ, total = max(worst, w), differ + d, total + t
        if w > limits["max_abs_diff"] or d * 1e6 / t > limits["mismatch_ppm"]:
            bad += 1
    numbers = {
        "max_abs_diff": {"value": worst, "limit": limits["max_abs_diff"]},
        "mismatch_ppm": {"value": differ * 1e6 / max(total, 1),
                         "limit": limits["mismatch_ppm"]},
    }
    return numbers, bad


def run_cell(bench: Bench, name: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t0: float | None = None,
             control: str | None = None,
             stages: list[tuple[str, float]] | None = None) -> dict:
    """One run of cell ``name``; returns the result object.

    ``control``, a precision of ``benchmark.reference.plain``, puts the
    reference computed in it in the program's place: the control, which has
    to come out as not correct.  ``stages``: the set-up's stages so far, as
    (what, when it ended) on the host clock from ``t0``, for the log."""
    t0 = time.perf_counter() if t0 is None else t0
    stages = list(stages or [])
    cell = bench.cell(name)
    wl = bench.workload(name)
    cfg = bench.config(cell["config"])
    entry = bench.entry(wl["entry"])
    metric_specs = bench.metrics_of(name,
                                    "per_layer" if trace else "end_to_end")
    readers = {m["name"]: bench.metric(m["name"]) for m in metric_specs}

    import torch
    dev = torch.device(device)
    program = __import__(PROGRAM)
    from simd_dct_tpu_torch.kernels import cuda_dct

    on_card = dev.type == "cuda"
    if on_card:
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        torch.cuda.init()
    stages.append(("the card's context" if stages
                   else "torch, the program and the card", time.perf_counter()))
    xs = entry.inputs(cfg, wl, seed, dev)
    stages.append(("inputs", time.perf_counter()))
    if control is None:
        def call(x):
            return entry.call(program, x, cfg)
    else:
        def call(x):
            return entry.reference(x, cfg, control)
    marks = (_CudaMarks(torch, wl["in_flight"] + 3) if on_card
             else _HostMarks())
    memory = _Memory(torch, dev) if on_card else _Memory()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    # warm-up: the window's own pattern, its judged outputs held as well
    samples = wl["samples"]
    warm = closed_loop(call, xs, marks, memory, in_flight=wl["in_flight"],
                       seconds=float("inf"),
                       max_calls=samples + 2 * wl["in_flight"] + len(xs),
                       hold=lambda n, t: n < samples)
    if warm.error:
        raise RuntimeError(f"warm-up call failed:\n{warm.error}")
    del warm
    marks.sync()
    stages.append(("warm-up", time.perf_counter()))

    label = None
    if trace:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function, schedule)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        prof = profile(activities=acts,
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1))
        prof.start()
        closed_loop(call, xs, marks, memory, in_flight=wl["in_flight"],
                    seconds=float("inf"), max_calls=2 * wl["in_flight"])
        marks.sync()
        prof.step()

        def label():
            return record_function(trace_mod.CALL)
    for k in cuda_dct.LAUNCHES:
        cuda_dct.LAUNCHES[k] = 0

    hold = _holder(sample_points(seed, samples), seconds)
    gc.collect()
    gc.freeze()     # the set-up's objects are the process's long-lived ones
    setup_s = time.perf_counter() - t0
    stages.append(("profiler" if trace else "the rest", t0 + setup_s))
    log("set-up: " + ", ".join(
        f"{what} {t - (stages[i - 1][1] if i else t0):.3f} s"
        for i, (what, t) in enumerate(stages)))
    cores = pin_this_thread() if on_card else None
    if trace:
        with record_function(trace_mod.WINDOW):
            loop = closed_loop(call, xs, marks, memory,
                               in_flight=wl["in_flight"], seconds=seconds,
                               hold=hold, label=label)
    else:
        loop = closed_loop(call, xs, marks, memory, in_flight=wl["in_flight"],
                           seconds=seconds, hold=hold)
    unpin(cores)
    gc.unfreeze()
    launches = {k: v for k, v in cuda_dct.LAUNCHES.items() if v}
    tr = None
    if trace:
        prof.step()
        prof.stop()
        t_read = time.perf_counter()
        tr = trace_mod.read(prof.profiler.kineto_results.events())
        log(f"trace: {len(tr.device_ops)} device operations, "
            f"{len(tr.host_ops)} host ranges, read in "
            f"{time.perf_counter() - t_read:.2f} s")
        del prof
    held, error = loop.held, loop.error
    if error:
        log(f"a call failed after {loop.calls} calls:\n{error}")

    kind_name = (torch.cuda.get_device_name(dev) if on_card else "cpu")
    peaks = bench.peaks().get(kind_name)
    work = entry.work(cfg, wl)
    readings = Readings(
        calls=loop.calls, frames=loop.calls * wl["batch"],
        window_s=loop.window_s, host_s=loop.host_s, latency_s=loop.latency_s,
        setup_s=setup_s, peak_bytes=memory.program, work=work, peaks=peaks,
        trace=tr)
    metrics = {}
    for m in metric_specs:
        value = readers[m["name"]].read(readings)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"{name}: {loop.calls} calls of {wl['batch']} frames in "
        f"{loop.window_s:.4f} s; program launches {launches} "
        f"({sum(launches.values()) / max(loop.calls, 1):.4f} a call)")

    # the program's state goes before the reference runs; the inputs are
    # the benchmark's own
    del loop
    if on_card:
        torch.cuda.empty_cache()
    refs: dict[int, Any] = {}
    pairs = []
    for n, i, out in held:
        if i not in refs:
            refs[i] = entry.reference(xs[i], cfg, "float32")
        pairs.append((out, refs[i]))
    numbers, bad = judged(pairs, wl["limits"])
    failed = bad + (1 if error else 0)
    correct = (bool(held) and failed == 0
               and all(v["value"] <= v["limit"] for v in numbers.values()))
    log(f"judged the outputs of calls {[n for n, _, _ in held]}")
    result = {
        "correct": correct,
        "attempted": readings.calls,
        "failed": failed,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": kind_name, "count": cell["chips"],
                   "memory_peak_bytes": memory.raw},
    }
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = {
            "device_ops": trace_mod.device_op_seconds(tr),
            "idle_gaps": trace_mod.idle_by_host(tr)}
    result["checks"] = numbers
    return result
