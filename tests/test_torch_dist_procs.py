"""The port's dist path across processes, on the CPU: two processes over
gloo, and the pure pieces of the gather across processes.

The two-process test runs this file as a script in two processes (the
worker below, as ``test_dist.py::test_two_process_cpu_cluster`` runs
``_dist_worker.py``), under one 120 s deadline for both processes.  Each
worker bootstraps through ``dist.initialize_distributed`` (a ``TCPStore``
on 127.0.0.1, the gloo group), builds a mesh of the two ranks on the CPU,
runs the strip-sharded stereo encode at 512x128 (``_dist_worker.py``'s
geometry and seed) with ``gather=True`` -- the plain version across
processes, an all-gather over gloo -- and a strip-sharded mode32 encode,
and saves its gathered bytes and its local mode32 shard.  The test holds
both processes' gathered bytes to the JAX package's XLA tier
(``xla_path.encode_quantize_stereo`` for the interleaved stream,
``api.encode_quantize_stereo(view_layout="native", backend="xla")`` for
the native planes), and each mode32 shard to the JAX single-device
encode's rows, computed here on the same seeded input: equal byte for byte
(the port's plain version and the JAX XLA tier agree exactly on this
input).

The kernel's side of the gather across processes needs a card
(``tests/test_torch_cuda.py``); here its descriptors are built from fake
peer pointers and offsets, and its rendezvous runs on a real ``TCPStore``
with threads as ranks, and with a rank in a process of its own that is
killed (the store's host or a peer).
"""

import datetime
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
H, W = 512, 128


def _image():
    rng = np.random.default_rng(0xD157)
    return rng.integers(0, 256, (H, W), dtype=np.uint8)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# ---------------------------------------------------------------------------
# the worker (this file run as a script)
# ---------------------------------------------------------------------------

def _worker(port: str, pid: str, out_dir: str) -> int:
    sys.path.insert(0, str(REPO))
    import torch.distributed as tdist
    from simd_dct_tpu_torch import dist
    from simd_dct_tpu_torch.api import NotSupportedError
    from simd_dct_tpu_torch.core.quantize import default_quant_lut

    rank = int(pid)
    ok = dist.initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2,
        process_id=rank)
    assert ok is True and tdist.get_backend() == "gloo", tdist.get_backend()
    assert dist.initialize_distributed() is True     # idempotent
    # no card on this rank and none named: make_mesh raises on every rank
    if not torch.cuda.is_available():
        try:
            dist.make_mesh(2)
        except ValueError as e:
            assert "devices=" in str(e), e
        else:
            raise AssertionError("make_mesh(2) without a card must raise")
    mesh = dist.make_mesh(2, devices=["cpu"] * 2)
    assert mesh.process_count == 2 and mesh.local_positions == [rank]
    assert mesh.ranks.tolist() == [0, 1] and mesh.is_local(rank)

    img = _image()
    lut = default_quant_lut(50)
    full = dist.encode_quantize_stereo_sharded(img, lut, mesh, gather=True)
    assert full.is_fully_replicated and len(full.shards) == 1
    np.save(os.path.join(out_dir, f"stereo{rank}.npy"),
            full.full().numpy().reshape(-1))
    native = dist.encode_quantize_stereo_sharded(img, lut, mesh, gather=True,
                                                 view_layout="native")
    np.save(os.path.join(out_dir, f"native{rank}.npy"), native.full().numpy())

    rec = dist.encode_quantize32_sharded(img, lut * np.float32(255.0), mesh)
    (piece,) = rec.addressable_shards
    assert piece.position == rank and len(rec.shards) == 1
    try:
        rec.full()
    except NotSupportedError:
        pass
    else:
        raise AssertionError("full() of a value split across processes")
    np.save(os.path.join(out_dir, f"m32_{rank}.npy"), piece.data.numpy())
    tdist.destroy_process_group()
    print(f"DIST_OK rank={rank}", flush=True)
    return 0


# ---------------------------------------------------------------------------
# tests
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    out = tmp_path_factory.mktemp("procs")
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_RANK")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(port), str(pid), str(out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for pid in (0, 1)]
    outs = []
    deadline = time.monotonic() + 120     # one deadline for both processes
    try:
        for p in procs:
            text, _ = p.communicate(
                timeout=max(0.0, deadline - time.monotonic()))
            outs.append(text)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, text in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{text[-3000:]}"
        assert "DIST_OK" in text
    return out


def test_two_processes_gather_the_jax_bytes(two_processes):
    import jax.numpy as jnp
    from simd_dct_tpu import api as JA
    from simd_dct_tpu.core import default_quant_lut
    from simd_dct_tpu.kernels import xla_path as X

    img = _image()
    lut = default_quant_lut(50)
    want = np.asarray(X.encode_quantize_stereo(jnp.asarray(img),
                                               jnp.asarray(lut)))
    native = np.asarray(JA.encode_quantize_stereo(
        img, lut, view_layout="native", backend="xla"))
    for rank in (0, 1):
        got = np.load(two_processes / f"stereo{rank}.npy")
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            np.load(two_processes / f"native{rank}.npy"), native)


def test_two_processes_mode32_shards_match_jax(two_processes):
    import jax.numpy as jnp
    from simd_dct_tpu.core import default_quant_lut
    from simd_dct_tpu.kernels import xla_path as X

    img = _image()
    lut = default_quant_lut(50) * np.float32(255.0)
    whole = np.asarray(X.encode_quantize32(jnp.asarray(img),
                                           jnp.asarray(lut)))
    strips = whole.reshape(H // 16, 8 * W)
    for rank in (0, 1):
        got = np.load(two_processes / f"m32_{rank}.npy")
        half = H // 32
        np.testing.assert_array_equal(got, strips[rank * half:
                                                  (rank + 1) * half])


def test_initialize_distributed_defaults_to_gloo(monkeypatch):
    import torch.distributed as tdist
    from simd_dct_tpu_torch.dist import mesh as M
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert M.initialize_distributed() is False     # a plain process
    assert not tdist.is_initialized()
    try:
        assert M.initialize_distributed(
            coordinator_address=f"127.0.0.1:{_free_port()}",
            num_processes=1, process_id=0) is True
        assert tdist.get_backend() == "gloo"
        assert M.store() is M._STORE
        # a world of one: the mesh stays within the process
        mesh = M.make_mesh(2, devices=["cpu"] * 2)
        assert mesh.process_count == 1 and mesh.local_positions == [0, 1]
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        M._STORE = None


def _fake_mesh(n, rank=0):
    from simd_dct_tpu_torch.dist.mesh import Mesh
    return Mesh(["cpu"] * n, ("data",), ranks=list(range(n)), rank=rank,
                key="sdct/test")


@pytest.mark.parametrize("me", [0, 1, 2])
def test_descriptor_across_processes_puts_each_slot(me):
    """Fake pointers: position k's output as this process addresses it is
    a mapped base plus the peer's offset (its own pointer at ``me``); the
    segment lands ``me * row`` bytes into each output's row."""
    from simd_dct_tpu_torch.dist import collectives as C
    n, row = 3, 4096
    bases = [0x7F0000000000 + k * 0x100000000 for k in range(n)]
    offsets = [0x200, 0x0, 0x12400]
    outs = [b + o for b, o in zip(bases, offsets)]
    src = 0x600000000000
    R = C.MAX_RING

    def field(words, i, count=R):
        return words[7 + i * R: 7 + i * R + count]

    desc = C._procs_desc(src, me, outs, row, 9)
    assert len(desc) == C._DESC_WORDS
    # no arrival counter of its own, no barrier slots, no target
    assert desc[:7] == [src, 0, n, 0, 0, 9, 0]
    assert field(desc, 0, n) == [outs[k] + me * row for k in range(n)]
    assert field(desc, 0)[n:] == [0] * (R - n)
    assert field(desc, 1) == [0] * R             # no peer's arrivals
    assert field(desc, 2) == field(desc, 3) == [0] * R     # no barrier


def test_rendezvous_agrees_aborts_and_rejoins():
    """Threads as the two ranks of a ring, each with its own client of one
    store: both come -> "go" and each other's payloads; one comes alone ->
    it raises (None) after the timeout; the other, coming later, finds the
    abort and joins the next generation, where both meet."""
    import torch.distributed as tdist
    from simd_dct_tpu_torch.dist import collectives as C
    master = tdist.TCPStore("127.0.0.1", 0, 1, True,
                            timeout=datetime.timedelta(seconds=30))
    clients = [tdist.TCPStore("127.0.0.1", master.port, 1, False,
                              timeout=datetime.timedelta(seconds=30))
               for _ in range(2)]
    got = [None, None]

    def meet(me, key, timeout=5.0):
        got[me] = C._meet(clients[me], key, me, 2, f"r{me}".encode(),
                          timeout)

    ts = [threading.Thread(target=meet, args=(me, "t/g1")) for me in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert got == [[b"r0", b"r1"]] * 2
    meet(0, "t/g2", timeout=0.2)        # rank 1 skips generation 2
    assert got[0] is None
    meet(1, "t/g2")                      # ... and comes after the abort
    assert got[1] == []
    ts = [threading.Thread(target=meet, args=(me, "t/g3")) for me in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert got == [[b"r0", b"r1"]] * 2
    for me in (0, 1):
        C._forget(clients[me], "t/g1", me)
        C._deleter(clients[me]).flush()
    assert not master.check(["t/g1/p0"]) and not master.check(["t/g1/dec"])
    assert master.check(["t/g3/p0"])


def test_rendezvous_of_three_aborts_every_rank_that_came():
    """Ranks 0 and 1 of three come, rank 2 does not: rank 0's shorter
    wait aborts the ring, and rank 1, still waiting, learns it at once
    (None, never a read of rank 2's missing payload); rank 2, coming
    after, joins the next generation, where all three meet."""
    import time
    import torch.distributed as tdist
    from simd_dct_tpu_torch.dist import collectives as C
    master = tdist.TCPStore("127.0.0.1", 0, 1, True,
                            timeout=datetime.timedelta(seconds=30))
    clients = [tdist.TCPStore("127.0.0.1", master.port, 1, False,
                              timeout=datetime.timedelta(seconds=30))
               for _ in range(3)]
    got, ended = ["unset"] * 3, [None] * 3

    def meet(me, key, timeout):
        got[me] = C._meet(clients[me], key, me, 3, b"x", timeout)
        ended[me] = time.perf_counter()

    t0 = time.perf_counter()
    ts = [threading.Thread(target=meet, args=(0, "t3/g1", 0.3)),
          threading.Thread(target=meet, args=(1, "t3/g1", 20.0))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert got[:2] == [None, None]
    assert ended[1] is not None and ended[1] - t0 < 5.0
    meet(2, "t3/g1", 20.0)
    assert got[2] == []
    ts = [threading.Thread(target=meet, args=(me, "t3/g2", 20.0))
          for me in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    assert got == [[b"x"] * 3] * 3


def test_second_rendezvous_counts_arrivals_and_errors():
    """The ring's one counter: both ranks' arrivals end the k-th gather;
    a rank whose kernel reported shows in both ranks' error count; a rank
    alone gets None after the timeout."""
    import torch.distributed as tdist
    from simd_dct_tpu_torch.dist import collectives as C
    master = tdist.TCPStore("127.0.0.1", 0, 1, True,
                            timeout=datetime.timedelta(seconds=30))
    clients = [tdist.TCPStore("127.0.0.1", master.port, 1, False,
                              timeout=datetime.timedelta(seconds=30))
               for _ in range(2)]
    got = [None, None]

    def done(me, k, failed):
        got[me] = C._done(clients[me], "t", k, 2, failed, 5.0)

    for k, failed, want in ((1, (False, False), 0), (2, (True, False), 1),
                            (3, (False, False), 1)):
        ts = [threading.Thread(target=done, args=(me, k, failed[me]))
              for me in (0, 1)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
        assert got == [want, want]
    assert C._done(clients[0], "t", 4, 2, False, 0.2) is None


def test_sharded_value_across_processes_holds_its_own_pieces():
    from simd_dct_tpu_torch.api import NotSupportedError
    from simd_dct_tpu_torch.dist.mesh import replicated, strip_sharding
    mesh = _fake_mesh(2, rank=1)
    x = torch.arange(8 * 3, dtype=torch.uint8).reshape(8, 3)
    s = strip_sharding(x, mesh)
    (piece,) = s.addressable_shards
    assert piece.position == 1 and len(s.shards) == 1
    assert torch.equal(piece.data, x[4:])
    with pytest.raises(NotSupportedError):
        s.full()
    r = replicated(x, mesh)
    assert torch.equal(r.full(), x)


# a rank of the rendezvous in a process of its own: the store's host (rank
# 0, which prints the store's port) or a peer (rank 1, a client of the
# port given); it meets the test's rank under "t/g1", then waits to be
# killed
_RANK_PROC = r"""
import datetime, sys, time
import torch.distributed as tdist
sys.path.insert(0, sys.argv[1])
from simd_dct_tpu_torch.dist import collectives as C
host = sys.argv[2] == "host"
kv = tdist.TCPStore("127.0.0.1", 0 if host else int(sys.argv[3]), 1, host,
                    timeout=datetime.timedelta(seconds=30))
print(kv.port, flush=True)
me = 0 if host else 1
print("MET", C._meet(kv, "t/g1", me, 2, b"r%d" % me, 20.0), flush=True)
time.sleep(120)
"""


@pytest.mark.parametrize("dead", ["store host", "peer"])
def test_rendezvous_raises_when_a_rank_dies(dead):
    """A rank meets the test's rank once and is then killed.  The store's
    host killed: a rendezvous already waiting and every one after raise
    ``SimdDctError`` at once, well inside the bound (the store's failure,
    not a timeout).  A peer killed: the first and the second rendezvous
    end within the bound plus 1 s with no decision (None), which the
    gather raises as ``SimdDctError``."""
    import time
    import torch.distributed as tdist
    from simd_dct_tpu_torch.api import SimdDctError
    from simd_dct_tpu_torch.dist import collectives as C
    timeout = datetime.timedelta(seconds=30)
    master = None
    if dead == "peer":
        master = tdist.TCPStore("127.0.0.1", 0, 1, True, timeout=timeout)
    proc = subprocess.Popen(
        [sys.executable, "-c", _RANK_PROC, str(REPO),
         "host" if dead == "store host" else "peer",
         str(master.port if master else 0)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        port = int(proc.stdout.readline())
        kv = tdist.TCPStore("127.0.0.1", port, 1, False, timeout=timeout)
        me = 1 if dead == "store host" else 0
        assert C._meet(kv, "t/g1", me, 2, b"r%d" % me, 20.0) == [b"r0",
                                                                  b"r1"]
        assert proc.stdout.readline().startswith("MET")
        bound = 2.0 if dead == "store host" else 0.5
        if dead == "store host":
            raised = []

            def meet():
                try:
                    C._meet(kv, "t/g2", me, 2, b"r1", bound)
                except SimdDctError as e:
                    raised.append(e)

            t = threading.Thread(target=meet)
            t.start()
            time.sleep(0.3)     # the rank waits in the rendezvous
            proc.kill()
            killed = time.perf_counter()
            t.join(timeout=30)
            assert not t.is_alive()
            assert len(raised) == 1 and "store" in str(raised[0])
            assert time.perf_counter() - killed < bound
            for step in (lambda: C._meet(kv, "t/g3", me, 2, b"r1", bound),
                         lambda: C._done(kv, "t", 1, 2, False, bound)):
                t0 = time.perf_counter()
                with pytest.raises(SimdDctError, match="store"):
                    step()
                assert time.perf_counter() - t0 < bound
        else:
            proc.kill()
            proc.wait()
            for step in (lambda: C._meet(kv, "t/g2", me, 2, b"r0", bound),
                         lambda: C._done(kv, "t", 1, 2, False, bound)):
                t0 = time.perf_counter()
                assert step() is None
                assert time.perf_counter() - t0 < bound + 1.0
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))
