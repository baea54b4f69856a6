"""A run whose timed path is broken underneath comes out as not correct:
the control (the reference in TensorFloat-32 in the program's place) and
each fault a cell can have, planted in the program's plain tier, which the
api runs on the CPU.  The harness's look for a card is skipped: the runs
are the CPU's, at a tiny size."""

import pytest

from benchmark import harness
from benchmark.tests.faults import CELLS, FAULTS
from simd_dct_tpu_torch.kernels import torch_path


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny_root, cell):
    r = harness.run_cell(harness.Bench(tiny_root), cell, 2**31 + 17, 0.2,
                         False, device="cpu")
    assert r["correct"] is True and r["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    r = harness.run_cell(harness.Bench(tiny_root), cell, 2**31 + 19, 0.2,
                         False, device="cpu", control="tf32")
    assert r["correct"] is False
    assert (r["checks"]["mismatch_ppm"]["value"]
            > r["checks"]["mismatch_ppm"]["limit"])


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tiny_root, monkeypatch, cell, fault):
    name = CELLS[cell]
    monkeypatch.setattr(torch_path, name, fault(getattr(torch_path, name)))
    r = harness.run_cell(harness.Bench(tiny_root), cell, 2**31 + 23, 0.2,
                         False, device="cpu")
    assert r["correct"] is False
    assert r["failed"] >= 1


def test_a_call_that_raises_ends_the_window(tiny_root, monkeypatch):
    calls = []
    orig = torch_path.encode_quantize_stereo

    def breaks_later(*a, **k):
        calls.append(1)
        if len(calls) > 20:
            raise RuntimeError("planted")
        return orig(*a, **k)
    monkeypatch.setattr(torch_path, "encode_quantize_stereo", breaks_later)
    r = harness.run_cell(harness.Bench(tiny_root), "uhd_stereo.enc.b8", 5,
                         5.0, False, device="cpu")
    assert r["correct"] is False and r["failed"] >= 1
