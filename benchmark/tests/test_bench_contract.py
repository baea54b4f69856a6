"""``BENCHMARK.json`` and a run's output keep to the benchmark's contract:
the allowed characters of names and units, the keys of the result line, and
no JAX or JAX package loaded by what the benchmark runs."""

import json
import re
import subprocess
import sys

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _spec():
    return harness.Bench().spec


def test_top_level_keys():
    assert set(_spec()) == {"command", "paths", "run_seconds", "configs",
                            "workloads", "end_to_end", "per_layer"}


def test_names_and_units_use_the_allowed_characters():
    spec = _spec()
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        names += [item["name"] for item in spec[key]]
    for cell in spec["workloads"]:
        names += [cell["config"], cell["traffic"]]
    for c in spec["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    texts = [c["why"] for c in spec["configs"] + spec["workloads"]]
    texts += [c["source"] for c in spec["configs"]]
    texts += [m["layer"] for m in spec["per_layer"]] + spec["command"]
    for t in texts:
        assert LINE.match(t), t


def test_entries_have_just_the_contract_keys():
    spec = _spec()
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(spec["paths"][0] + "/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    layer_names = {m["name"] for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["moves"] in layer_names
    assert "setup_s" in layer_names
    assert 1 <= spec["run_seconds"] <= 51
    for p in spec["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(json.dumps(spec)) < 64 * 1024


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(tiny_root, trace):
    r = harness.run_cell(harness.Bench(tiny_root), "uhd_stereo.enc.b8", 11,
                         0.2, trace, device="cpu")
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += ["breakdown", "checks"] if trace else ["checks"]
    assert list(r) == want
    assert set(r["device"]) >= {"platform", "kind", "count",
                                "memory_peak_bytes"}
    if trace:
        assert set(r["device"]) >= {"busy_s", "window_s"}
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("simd_dct_tpu_torch.api", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "simd_dct_tpu.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert harness.forbidden_modules() == ["jaxlib", "simd_dct_tpu.core"]


def test_the_harness_loads_no_jax():
    """After the harness, every entry, metric and the program are imported,
    no module named jax, jaxlib, flax or simd_dct_tpu is loaded."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import harness, trace, calibrate\n"
        "import simd_dct_tpu_torch\n"
        "b = harness.Bench()\n"
        "[b.entry(b.workload(c['name'])['entry']) for c in b.spec['workloads']]\n"
        "[b.metric(m['name']) for m in b.spec['end_to_end'] + b.spec['per_layer']]\n"
        "print(harness.forbidden_modules())\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_card_no_result(tmp_path):
    """Without the cards a cell asks for, or without the program, a run
    exits with another code than 0 and prints nothing on standard output."""
    import shutil
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (harness.ROOT, tmp_path):
        out = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "uhd_stereo.enc.b8", "--seed", "3000000001", "--seconds", "1",
             "--trace", "0"], capture_output=True, text=True, timeout=120,
            cwd=cwd, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "HOME": str(tmp_path)})
        assert out.returncode != 0
        assert out.stdout == ""


class _FakeCuda:
    """The allocator's counters, driven by hand."""

    def __init__(self):
        self.allocated = self.peak = 0

    def alloc(self, n):
        self.allocated += n
        self.peak = max(self.peak, self.allocated)

    def max_memory_allocated(self, device=None):
        return self.peak

    def reset_peak_memory_stats(self, device=None):
        self.peak = self.allocated


class _FakeTorch:
    def __init__(self):
        self.cuda = _FakeCuda()


def test_memory_leaves_the_held_outputs_out():
    torch = _FakeTorch()
    mem = harness._Memory(torch, None)
    mem.start()
    torch.cuda.alloc(100)           # inputs
    torch.cuda.alloc(30)            # a workspace, freed again
    torch.cuda.alloc(-30)
    mem.mark(0)                     # the first held output comes next
    torch.cuda.alloc(10)            # it is held
    torch.cuda.alloc(20)            # a later workspace
    mem.mark(10)
    assert mem.raw == 130
    assert mem.program == 130       # 100 + 30 before anything was held
    torch.cuda.alloc(35)
    mem.mark(10)
    assert mem.raw == 165 and mem.program == 155


def test_latency_is_submission_to_observed_completion():
    """With the host's clock standing in for the card, a call's latency
    holds its own enqueue and the wait behind the call before it."""
    import time

    def call(x):
        time.sleep(0.002)
        return x

    loop = harness.closed_loop(call, [1, 2], harness._HostMarks(),
                               harness._Memory(), in_flight=2,
                               seconds=float("inf"), max_calls=20)
    assert loop.calls == 20 and len(loop.latency_s) == 20
    # every call but the last is retired after the next one's enqueue
    assert min(loop.latency_s[:-1]) >= 0.004
    assert all(h >= 0.002 for h in loop.host_s)


def test_pinning_keeps_one_core_and_gives_the_rest_back():
    import os
    before = os.sched_getaffinity(0)
    cores = harness.pin_this_thread()
    try:
        if len(before) > 1:
            assert os.sched_getaffinity(0) == {max(before)}
        else:
            assert cores is None
    finally:
        harness.unpin(cores)
    assert os.sched_getaffinity(0) == before
