"""The port's frame feed (``utils.feed``), profiling helpers
(``utils.profiling``) and run statistics (``bench.stats``) against the JAX
package's, on the CPU.

The feed runs its plain version here (``device="cpu"``: the same
generator, no streams and no page-locked buffers); the card path runs in
``chip_smoke.py``.  Frames are seeded smooth 32x64 images (mode32's
smallest dual view, W % 64 == 0); the JAX side runs its own stream
functions once per module.  Tolerances:
  * the port's streams against its own per-frame api calls: exact;
  * port records and pixels against the JAX package's (decoded from the
    JAX streams, or decoded from the SAME records): at most +-1 on at most
    0.2% of bytes -- the ``compare_backends`` contract of
    ``test_torch_mode32.py``;
  * round trips against the JAX round trips: PSNR against the source
    within 0.1 dB (``test_torch_mode32.py``'s round-trip tolerance);
  * the order of pulls and results, the profiling figures and the
    statistics rows: exact.
"""

import numpy as np
import pytest
import torch

from simd_dct_tpu import entropy as JE
from simd_dct_tpu.bench import stats as JS
from simd_dct_tpu.utils import feed as JF
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import entropy as E
from simd_dct_tpu_torch.api import NotSupportedError
from simd_dct_tpu_torch.bench import stats as S
from simd_dct_tpu_torch.utils import feed as F
from simd_dct_tpu_torch.utils import profiling as P
from simd_dct_tpu_torch.utils.debug import compare_backends
from simd_dct_tpu_torch.utils.metrics import psnr

CPU = {"device": "cpu"}
H, W = 32, 64
LUT = T.default_quant_lut(100) * np.float32(255.0)


def _contract(a, b):
    report = compare_backends({"a": np.asarray(a).reshape(-1),
                               "b": np.asarray(b).reshape(-1)})
    assert all(v["ok"] for v in report.values()), report


def _frames(n=4):
    yy, xx = np.mgrid[0:H, 0:W]
    return [np.clip(128 + 50 * np.sin((xx + 3 * p) / 7) * np.cos(yy / 5),
                    0, 255).astype(np.uint8) for p in range(n)]


def _records(fr):
    return T.encode_quantize32(fr, LUT, **CPU).numpy().reshape(-1)


@pytest.fixture(scope="module")
def jax_streams():
    frames = _frames()
    return {
        "roundtrip": [np.asarray(o) for o in
                      JF.stream_roundtrip32(iter(frames), LUT, depth=2)],
        "plain": list(JF.stream_encode32_compressed(iter(frames), LUT,
                                                    depth=2)),
        "sparse": list(JF.stream_encode32_compressed(iter(frames), LUT,
                                                     depth=2, sparse=True)),
    }


# ---------------------------------------------------------------------------
# FrameFeeder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 5])
def test_feeder_results_match_sequential(depth):
    f = lambda x: (x.to(torch.int32) * 2 + 1).sum()
    frames = [np.full((16, 16), i, np.uint8) for i in range(7)]
    got = [int(v) for v in F.FrameFeeder(f, depth=depth, **CPU).map(frames)]
    assert got == [int(f(torch.from_numpy(fr))) for fr in frames]


def test_feeder_generator_input_and_depth1():
    gen = (np.full((8,), i, np.uint8) for i in range(3))
    outs = list(F.FrameFeeder(lambda x: x + 1, depth=1, **CPU).map(gen))
    assert [int(o[0]) for o in outs] == [1, 2, 3]
    assert all(isinstance(o, torch.Tensor) and o.device.type == "cpu"
               for o in outs)


@pytest.mark.parametrize("call", ["feeder", "roundtrip", "encode", "decode"])
def test_depth_zero_raises(call):
    frames = _frames(1)
    with pytest.raises(ValueError):
        if call == "feeder":
            F.FrameFeeder(lambda x: x, depth=0, **CPU)
        elif call == "roundtrip":
            list(F.stream_roundtrip32(frames, LUT, depth=0, **CPU))
        elif call == "encode":
            list(F.stream_encode32_compressed(frames, LUT, depth=0, **CPU))
        else:
            list(F.stream_decode32_compressed([], LUT, W, H, depth=0, **CPU))


def test_a_device_frame_is_not_moved_to_the_host_quietly():
    with pytest.raises(ValueError):
        list(F.FrameFeeder(lambda x: x, **CPU).map(
            [torch.empty(0, device="meta")]))


def test_feed_without_a_card_raises_and_names_the_cpu_option():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: F.FrameFeeder(lambda x: x),
                 lambda: F.stream_roundtrip32(_frames(1), LUT),
                 lambda: next(F.stream_encode32_compressed(_frames(1), LUT)),
                 lambda: F.stream_decode32_compressed([], LUT, W, H)):
        with pytest.raises(NotSupportedError, match='device="cpu"'):
            call()


# ---------------------------------------------------------------------------
# the stream functions against sequential calls and the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth", [1, 2, 4])
def test_stream_roundtrip32(jax_streams, depth):
    frames = _frames()
    outs = list(F.stream_roundtrip32(iter(frames), LUT, depth=depth, **CPU))
    assert len(outs) == len(frames)
    for fr, out, ref in zip(frames, outs, jax_streams["roundtrip"]):
        assert isinstance(out, np.ndarray) and out.shape == (H // 2, W)
        want = T.roundtrip_quantize32(fr, LUT, **CPU).numpy()
        assert np.array_equal(out, want)
        assert abs(psnr(fr[: H // 2], out) - psnr(fr[: H // 2], ref)) < 0.1


@pytest.mark.parametrize("sparse", [False, True], ids=["plain", "sparse"])
@pytest.mark.parametrize("depth", [1, 2])
def test_stream_encode32_compressed(jax_streams, sparse, depth):
    frames = _frames()
    blobs = list(F.stream_encode32_compressed(iter(frames), LUT, depth=depth,
                                              sparse=sparse, **CPU))
    ref = jax_streams["sparse" if sparse else "plain"]
    assert len(blobs) == len(frames)
    for fr, blob, jblob in zip(frames, blobs, ref):
        want = _records(fr)
        assert np.array_equal(E.decompress(blob), want)
        assert np.array_equal(JE.decompress(blob), want)
        _contract(JE.decompress(jblob), want)
        assert blob[:4].tobytes() == jblob[:4].tobytes()


def test_stream_encode_shares_the_first_table():
    """shared_table=True packs with the first frame's table until a frame
    holds a symbol that table lacks, then with that frame's own;
    shared_table=False with each frame's own (feed.py:83-135)."""
    frames = _frames() + [np.full((H, W), 127, np.uint8)]
    shared = list(F.stream_encode32_compressed(frames, LUT, **CPU))
    own = list(F.stream_encode32_compressed(frames, LUT, shared_table=False,
                                            **CPU))
    lengths = None
    for fr, blob_s, blob_o in zip(frames, shared, own):
        rec = _records(fr)
        table = E.build_lengths(np.bincount(rec, minlength=256))
        lengths = table if lengths is None else lengths
        try:
            want = E.compress(rec, lengths)
        except E.EntropyError:
            lengths = table
            want = E.compress(rec, lengths)
        assert np.array_equal(blob_s, want)
        assert np.array_equal(blob_o, E.compress(rec, table))


def test_stream_encode_packs_each_frame_once(monkeypatch):
    """The rebuild is decided from the frame's histogram before the pack:
    one ``entropy.compress`` a frame, where the JAX package packs a frame
    the shared table cannot code twice."""
    frames = _frames() + [np.full((H, W), 127, np.uint8)] + _frames(2)
    calls = []
    pack = E.compress
    monkeypatch.setattr(E, "compress",
                        lambda *a, **kw: calls.append(1) or pack(*a, **kw))
    blobs = list(F.stream_encode32_compressed(frames, LUT, **CPU))
    assert len(blobs) == len(frames) == len(calls)


class _LoggedStages:
    """Stages whose every frame stays in its (background) staging copy
    until issued, as the card's encode streams: a log of the calls."""

    def __init__(self, log):
        self.log = log

    def start(self, item):
        self.log.append(("start", item))
        return {"k": item, "issued": False}

    def issue(self, entry):
        if not entry["issued"]:
            entry["issued"] = True
            self.log.append(("issue", entry["k"]))

    def finish(self, entry):
        self.issue(entry)
        return entry["k"]


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipeline_issues_in_order_before_pull_and_return(depth):
    """With the ring filled in the background: frames are queued on the
    card in order; a frame's staging copy ends (it is issued) before the
    next frame is pulled; the next frame is queued before a frame is
    returned; ``depth`` frames past it have been pulled by then."""
    n = 7
    log = []

    def source():
        for k in range(n):
            log.append(("pull", k))
            yield k

    for k in F._pipeline(source(), _LoggedStages(log), depth):
        log.append(("yield", k))
    at = {e: i for i, e in enumerate(log)}
    assert [k for op, k in log if op == "issue"] == list(range(n))
    assert [k for op, k in log if op == "yield"] == list(range(n))
    for k in range(n):
        if k + 1 < n:
            assert at[("issue", k)] < at[("pull", k + 1)]
            assert at[("issue", k + 1)] < at[("yield", k)]
        assert at[("pull", min(k + depth, n - 1))] < at[("yield", k)]


def test_stream_compressed_table_rebuild():
    """A frame with symbols absent from the shared table rebuilds from its
    own histogram instead of failing (test_utils.py:156)."""
    flat = np.full((H, W), 127, np.uint8)            # near-empty spectrum
    noisy = np.random.default_rng(1).integers(0, 256, (H, W), np.uint8)
    blobs = list(F.stream_encode32_compressed(iter([flat, noisy]), LUT,
                                              **CPU))
    jblobs = list(JF.stream_encode32_compressed(iter([flat, noisy]), LUT))
    assert len(blobs) == 2
    assert np.array_equal(E.decompress(blobs[1]), _records(noisy))
    _contract(JE.decompress(jblobs[1]), _records(noisy))


@pytest.mark.parametrize("payload", ["plain", "sparse"])
@pytest.mark.parametrize("depth", [1, 3])
def test_stream_decode32_compressed(jax_streams, payload, depth):
    blobs = jax_streams[payload]
    outs = list(F.stream_decode32_compressed(iter(blobs), LUT, W, H,
                                             depth=depth, **CPU))
    jouts = list(JF.stream_decode32_compressed(iter(blobs), LUT, W, H,
                                               depth=2))
    assert len(outs) == len(blobs)
    for blob, out, jout in zip(blobs, outs, jouts):
        want = T.decode_quantize32(E.decompress(blob), LUT, W, H,
                                   **CPU).numpy()
        assert isinstance(out, np.ndarray) and np.array_equal(out, want)
        _contract(out, jout)


def _pull_order(stream_fn, blobs):
    log = []

    def source():
        for k, blob in enumerate(blobs):
            log.append(("pull", k))
            yield blob

    for k, _ in enumerate(stream_fn(source())):
        log.append(("yield", k))
    return log


def test_depth1_keeps_a_frame_in_flight(jax_streams):
    """ROADMAP Queue 3 (c): with depth=1 the port has pulled (unpacked and
    dispatched) blob k+1 before it returns frame k; the JAX package's
    ``stream_decode32_compressed`` (feed.py:163) returns frame k before
    it pulls blob k+1, so nothing is in flight while the host works."""
    blobs = jax_streams["plain"]
    port = _pull_order(lambda src: F.stream_decode32_compressed(
        src, LUT, W, H, depth=1, **CPU), blobs)
    jax = _pull_order(lambda src: JF.stream_decode32_compressed(
        src, LUT, W, H, depth=1), blobs)
    for k in range(len(blobs) - 1):
        assert port.index(("pull", k + 1)) < port.index(("yield", k))
        assert jax.index(("pull", k + 1)) > jax.index(("yield", k))
    # the roundtrip and encode streams count the same way
    for fn in (lambda src: F.stream_roundtrip32(src, LUT, depth=1, **CPU),
               lambda src: F.stream_encode32_compressed(src, LUT, depth=1,
                                                        **CPU)):
        log = _pull_order(fn, _frames())
        assert log[:3] == [("pull", 0), ("pull", 1), ("yield", 0)]


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_chip_specs():
    assert P.hbm_peak_gbps("NVIDIA H100 80GB HBM3") == 3350.0
    assert P.hbm_peak_gbps("NVIDIA H100 PCIe") == 2000.0
    assert P.chip_spec("NVIDIA H100 NVL").hbm_gb == 94.0
    assert P.chip_spec("NVIDIA H100 80GB HBM3").bf16_tflops == 989.0
    assert P.hbm_peak_gbps("NVIDIA Z999 future") is None
    assert P.hbm_peak_gbps("TPU v5 lite") is None     # no TPU figures
    assert all(k.startswith("NVIDIA ") for k in P.CHIP_SPECS)


def test_roofline_report_text():
    r = P.RooflineReport(bytes_processed=3_350_000_000, seconds=2.0,
                         device_kind="NVIDIA H100 80GB HBM3")
    assert r.gbps == 1.675 and abs(r.fraction_of_roofline - 0.0005) < 1e-12
    assert str(r) == ("1.7 GB/s on NVIDIA H100 80GB HBM3 "
                      "(0.1% of 3350 GB/s HBM roofline)")
    unk = P.RooflineReport(bytes_processed=1, seconds=1.0,
                           device_kind="cpu")
    assert unk.fraction_of_roofline is None
    assert "unknown roofline" in str(unk)


def test_measure_and_device_timer_on_the_host():
    rep = P.measure(lambda x: x + 1, (torch.zeros((8, 128)),),
                    bytes_processed=1024, runs=3, warmup=1)
    assert rep.seconds > 0 and rep.gbps > 0 and rep.device_kind == "cpu"
    rep = P.measure(lambda: 1, bytes_processed=8, runs=2, device="cpu")
    assert rep.device_kind == "cpu"
    with P.device_timer(device="cpu") as t:
        torch.ones(1000).sum()
    assert t.seconds is not None and t.seconds >= 0


def test_profiling_without_a_card_names_the_cpu_option():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(NotSupportedError, match='device="cpu"'):
        P.chip_spec()
    with pytest.raises(NotSupportedError):
        P.measure(lambda: 1, bytes_processed=8)


def test_trace_writes_a_chrome_trace(tmp_path):
    with P.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert prof is not None
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


# ---------------------------------------------------------------------------
# bench.stats
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ns", [[1000.0], [1200.0, 800.0, 950.5],
                                [3.5e6, 2.25e6, 4.0e6, 2.5e6]])
def test_run_stats_rows_equal_the_jax_rows(ns):
    port = S.RunStats("enc-quant32", 7_864_320, list(ns))
    ref = JS.RunStats("enc-quant32", 7_864_320, list(ns))
    assert port.row() == ref.row()
    assert (port.mibps(port.min_ns), port.stddev_ns) == \
        (ref.mibps(ref.min_ns), ref.stddev_ns)
    assert S.HEADER == JS.HEADER
    assert (S.MAX_RUN_COUNT, S.DEFAULT_RUN_COUNT) == \
        (JS.MAX_RUN_COUNT, JS.DEFAULT_RUN_COUNT)


def test_time_fn_syncs_every_run():
    calls = []
    st = S.time_fn("x", lambda: 7, bytes_processed=4, runs=5, warmup=2,
                   sync=calls.append)
    assert calls == [7] * 7 and len(st.ns) == 5
    assert len(S.time_fn("x", lambda: 0, 4, runs=5000).ns) == \
        S.MAX_RUN_COUNT
