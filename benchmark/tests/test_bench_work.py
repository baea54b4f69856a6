"""The byte and FMA counts of ``benchmark/work.py`` for each cell's shapes,
and the least times they give on the card of ``peaks.json``."""

import pytest

from benchmark import harness, work

H100 = "NVIDIA H100 80GB HBM3"
BLOCK_FMAS = 16 * 29 + 64          # 16 transforms and the quantizer a block


@pytest.mark.parametrize("cell, want_bytes, want_fmas", [
    # 8 dual views of 4320 x 3840, both views read and as many bytes out
    ("uhd_stereo.enc.b8", 2 * 8 * 4320 * 3840,
     8 * 540 * 480 * BLOCK_FMAS),
    ("uhd_stereo.dec.b8", 2 * 8 * 4320 * 3840,
     8 * 540 * 480 * BLOCK_FMAS),
    # 64 top views of 1080 x 1920; the bottom views are never read
    ("video1080p.enc.b64", 2 * 64 * 1080 * 1920,
     64 * 135 * 240 * BLOCK_FMAS),
    # an encode and a decode, the records never stored
    ("video1080p.rt.b64", 2 * 64 * 1080 * 1920,
     64 * 135 * 240 * 2 * BLOCK_FMAS),
])
def test_cell_work(cell, want_bytes, want_fmas):
    bench = harness.Bench()
    wl = bench.workload(cell)
    cfg = bench.config(bench.cell(cell)["config"])
    got = bench.entry(wl["entry"]).work(cfg, wl)
    assert got == work.Work(want_bytes, want_fmas)
    peaks = bench.peaks()[H100]
    # every cell is bound by its bytes on the H100
    assert want_fmas / 33.5e12 < want_bytes / 3.35e12
    assert got.least_seconds(peaks) == pytest.approx(want_bytes / 3.35e12)


def test_stereo_least_time_of_a_uhd_dual_view():
    # 33.18 MB at 3.35 TB/s: 9.90 us, against 4.09 us of FMAs
    w = work.stereo_encode(1, 4320, 3840)
    peaks = harness.Bench().peaks()[H100]
    assert w.least_seconds(peaks) == pytest.approx(9.904e-6, rel=1e-3)
    assert w.fmas / peaks["f32_fma_per_s"] == pytest.approx(4.087e-6,
                                                            rel=1e-3)


def test_fma_bound_when_the_fma_rate_is_the_limit():
    w = work.mode32_roundtrip(1, 16, 64)
    slow = {"hbm_bytes_per_s": 1e15, "f32_fma_per_s": 1e9}
    assert w.least_seconds(slow) == w.fmas / 1e9
