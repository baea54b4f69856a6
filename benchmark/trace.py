"""The device's side of a traced window, read from a ``torch.profiler`` trace.

``read`` takes the profiler's events after it stopped and returns a
``Trace``: every operation that ran on the card (kernels, copies, memsets)
inside the span of the host range named ``WINDOW``, and the host's ranges
(the benchmark's own labels, PyTorch's operators, CUDA runtime calls), so
that an idle stretch of the card can be put down to what the host was doing
then.  Timestamps are the profiler's, in nanoseconds, on one clock for both
sides.
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import NamedTuple

WINDOW = "benchmark.window"          # host range around the measured window
CALL = "benchmark.call"              # host range around each timed call
_LABELS = (WINDOW, CALL)
# device-side records that are no operation of the card: synchronisations
# seen on the device timeline, and the profiler's own step ranges
_NOT_AN_OP = re.compile(r"Sync|Wait|^ProfilerStep")


class Op(NamedTuple):
    name: str
    start: int          # ns
    end: int            # ns


class Trace(NamedTuple):
    window: tuple[int, int] | None  # ns, the host range WINDOW
    device_ops: list[Op]            # on the card, inside the window
    host_ops: list[Op]              # on the host, sorted by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9 if self.window else 0.0

    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of the device operations' intervals, clipped to the
        window, in order."""
        lo, hi = self.window if self.window else (None, None)
        spans = sorted((max(o.start, lo), min(o.end, hi))
                       for o in self.device_ops)
        merged: list[list[int]] = []
        for s, e in spans:
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def device_seconds(self) -> float:
        """The summed durations of the device operations."""
        return sum(o.end - o.start for o in self.device_ops) * 1e-9

    def idle_gaps(self) -> list[tuple[int, int]]:
        """The stretches of the window in which no device operation ran."""
        if not self.window:
            return []
        gaps, t = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if self.window[1] > t:
            gaps.append((t, self.window[1]))
        return gaps


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace, template
    arguments and parameters: ``void (anonymous namespace)::
    enc_stereo_kernel<0, 1>(unsigned char const*, ...)`` ->
    ``enc_stereo_kernel``; copies and memsets keep their names."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    base = re.sub(r"^(void|__global__)\s+", "", name)
    base = base.replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", base, 1)[0].split("::")[-1].strip() or name


def read(events) -> Trace:
    """A ``Trace`` from the profiler's raw events (``profile.profiler.
    kineto_results.events()``)."""
    window = None
    device, host = [], []
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        on_device = str(e.device_type()).endswith("CUDA")
        if on_device:
            if not (e.is_user_annotation() or name in _LABELS
                    or _NOT_AN_OP.search(name)):
                device.append(Op(name, start, end))
        else:
            if name == WINDOW:
                window = (start, end)
            if not name.startswith("ProfilerStep"):
                host.append(Op(name, start, end))
    if window:
        device = [o for o in device if o.end > window[0]
                  and o.start < window[1]]
    host.sort(key=lambda o: o.start)
    return Trace(window, device, host)


def device_op_seconds(trace: Trace, top: int = 10) -> list[list]:
    """The device operations that took most time, summed by short name."""
    total: dict[str, float] = defaultdict(float)
    for o in trace.device_ops:
        total[short_name(o.name)] += (o.end - o.start) * 1e-9
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:top]]


def idle_by_host(trace: Trace, top: int = 10) -> list[list]:
    """The card's idle time in the window summed by what the host was doing
    when each idle stretch began: the innermost host range open then
    (``benchmark.call`` is the program's Python between its operators),
    or ``benchmark`` where none but the window was."""
    starts = [o.start for o in trace.host_ops]
    longest = max((o.end - o.start for o in trace.host_ops
                   if o.name != WINDOW), default=0)
    total: dict[str, float] = defaultdict(float)
    for s, e in trace.idle_gaps():
        at, name = s + 1, "benchmark"
        i = bisect.bisect_right(starts, at) - 1
        while i >= 0 and trace.host_ops[i].start >= at - longest:
            o = trace.host_ops[i]
            if o.name != WINDOW and o.start <= at < o.end:
                name = o.name
                break
            i -= 1
        total[name] += (e - s) * 1e-9
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])
            [:top]]
