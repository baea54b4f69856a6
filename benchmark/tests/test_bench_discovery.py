"""The harness finds configurations, cells, kinds of call and metrics by
the names in ``BENCHMARK.json``, and a cell added as files alone runs."""

import json

import pytest

from benchmark import harness


def test_every_name_resolves():
    bench = harness.Bench()
    spec = bench.spec
    for c in spec["configs"]:
        cfg = bench.config(c["name"])
        assert cfg["name"] == c["name"]
        assert cfg["lut"].shape == (64,)
    for cell in spec["workloads"]:
        wl = bench.workload(cell["name"])
        assert wl["why"] == cell["why"]
        entry = bench.entry(wl["entry"])
        for fn in ("inputs", "call", "reference", "work"):
            assert callable(getattr(entry, fn))
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            assert callable(bench.metric(m["name"]).read)


def test_every_config_is_used_and_files_are_distinct():
    spec = harness.Bench().spec
    used = {c["config"] for c in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    files = [c["file"] for c in spec["configs"]]
    assert len(set(files)) == len(files)


def test_a_missing_name_raises():
    bench = harness.Bench()
    with pytest.raises(KeyError):
        bench.cell("no_such.cell")
    with pytest.raises(FileNotFoundError):
        bench.entry("no_such_entry")


def test_a_cell_that_disagrees_with_its_file_is_refused(tiny_root):
    path = tiny_root / "benchmark" / "workloads" / "uhd_stereo.enc.b8.json"
    wl = json.loads(path.read_text())
    wl["config"] = "video1080p"
    path.write_text(json.dumps(wl))
    with pytest.raises(ValueError):
        harness.Bench(tiny_root).workload("uhd_stereo.enc.b8")


def test_a_throwaway_cell_added_as_files_runs(tiny_root):
    """A new configuration, cell and per-layer metric, added as files and
    entries alone, run through the harness on the CPU."""
    bdir = tiny_root / "benchmark"
    cfg = json.loads((bdir / "configs" / "video1080p.json").read_text())
    cfg["name"] = "tiny_mono"
    (bdir / "configs" / "tiny_mono.json").write_text(json.dumps(cfg))
    wl = {"config": "tiny_mono", "traffic": "enc.b3", "entry":
          "encode_quantize32", "batch": 3, "in_flight": 3, "inputs": 2,
          "samples": 2, "limits": {"max_abs_diff": 1, "mismatch_ppm": 2000},
          "why": "a throwaway cell"}
    (bdir / "workloads" / "tiny_mono.enc.b3.json").write_text(json.dumps(wl))
    (bdir / "metrics" / "calls_made.py").write_text(
        "def read(r):\n    return float(r.calls)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "tiny_mono", "source": "https://example.org",
                            "file": "benchmark/configs/tiny_mono.json",
                            "reduced": [], "why": "a throwaway config"})
    spec["workloads"].append({"name": "tiny_mono.enc.b3", "config": "tiny_mono",
                              "traffic": "enc.b3", "chips": 1,
                              "why": "a throwaway cell"})
    spec["per_layer"].append({"name": "calls_made", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "api", "moves": "frames_per_s",
                              "workloads": ["tiny_mono.enc.b3"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    bench = harness.Bench(tiny_root)
    r = harness.run_cell(bench, "tiny_mono.enc.b3", 3, 0.2, True,
                         device="cpu")
    assert r["correct"] is True
    assert r["metrics"]["calls_made"]["value"] == r["attempted"] > 0
    # readers that find no device trace give nothing
    assert "kernel_roofline_share" not in r["metrics"]
    # the metric is the new cell's alone
    other = harness.run_cell(bench, "video1080p.enc.b64", 3, 0.2, True,
                             device="cpu")
    assert "calls_made" not in other["metrics"]


def test_calibrate_prints_both_sides(tiny_root):
    import os
    import subprocess
    import sys
    out = subprocess.run(
        [sys.executable, str(tiny_root / "benchmark" / "calibrate.py"),
         "--workload", "uhd_stereo.dec.b8", "--seeds", "1,2",
         "--control-seeds", "3", "--seconds", "0.1", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(harness.ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(s) for s in out.stdout.splitlines()]
    assert [ln.get("side") for ln in lines[:3]] == ["program", "program",
                                                     "tf32"]
    assert lines[0]["correct"] and not lines[2]["correct"]
    assert lines[-2]["side"] == "program" and "max" in lines[-2]
    assert lines[-1]["side"] == "tf32" and "min" in lines[-1]
