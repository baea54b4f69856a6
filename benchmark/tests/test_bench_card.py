"""The cells on the card at their own size, briefly: a sound run is
correct, and the control and each fault a cell can have, wrapped around
the api's entry that the window calls, are not.  Marked ``cuda``; skips
without a card.  Run on the machine with the card with

    python -m pytest -m cuda benchmark/tests/test_bench_card.py
"""

import pytest

from benchmark import harness
from benchmark.tests.faults import CELLS, FAULTS

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell):
    bench = harness.Bench()
    r = harness.run_cell(bench, cell, 3000000007, 1.0, False,
                         device=str(card))
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu"
    c = harness.run_cell(bench, cell, 3000000008, 1.0, False,
                         device=str(card), control="tf32")
    assert c["correct"] is False


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_on_the_card(card, monkeypatch, cell, fault):
    program = __import__(harness.PROGRAM)
    name = CELLS[cell]
    monkeypatch.setattr(program, name, fault(getattr(program, name)))
    r = harness.run_cell(harness.Bench(), cell, 3000000009, 0.5, False,
                         device=str(card))
    assert r["correct"] is False
    assert r["failed"] >= 1
