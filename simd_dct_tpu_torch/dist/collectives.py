"""The plane all-gather: the dist path's only data that crosses devices.

Counterpart of ``simd_dct_tpu/dist/collectives.py``.  DCT blocks are
independent, so the one collective is reassembling the stereo mode's 64
coefficient planes from per-shard strip segments (the multi-device analog
of the reference's per-strip plane-cursor advance,
src/simd_dct.cpp:1075-1083).  Four forms, identical bytes:

* ``gather_planes_remote`` -- the kernel (``csrc/collectives.cu``
  ``ring_gather_kernel``) on a mesh of cards; its plain version,
  ``gather_planes_ring``, on a CPU mesh;
* ``gather_planes_auto``   -- what ``gather=True`` uses: the above;
* ``gather_planes_ring``   -- the plain version: n-1 forwarding steps,
  each rank passing its newest segment to the right, with the slot
  arithmetic of the reference's ``lax.ppermute`` ring;
* ``gather_planes_allgather`` -- one ``torch.cat`` per rank.

Each takes a ``Sharded`` value split over ``axis_name`` (or a whole
(64, S, seg) tensor, split along its strip axis) and returns it
replicated along that axis: on a 2-D mesh one ring per row.  The strip
axis must divide evenly over the ring.

The reference's ``next_collective_id`` and its per-trace allocator exist
because Mosaic keys barrier semaphores by id within one traced program.
Eager PyTorch has no trace: each mesh owns a flag workspace on its cards,
allocated once, and each gather takes the next generation and arrival
targets under the workspace's lock.

A gather on cards never waits for a stream.  A spin that times out writes
an error code into its card's word of pinned host memory; the next gather
on the mesh reads those words and raises ``SimdDctError``, as does
``check_workspace``, which first waits for the mesh's cards.  Either way
every card of the mesh is synchronised before the workspace is dropped.
The gather that failed has then returned outputs that are incomplete, as
a failed CUDA launch leaves them.  On a mesh of several cards each card's
stream first waits for every other card's stream (events), so the kernels
start together and a card busy with earlier work makes its peers wait on
the stream, not in the kernel; and after the launches each card's stream
waits for every other card's again, so nothing queued next on a card's
stream, not even a new tensor in the memory of an output dropped at once,
runs while a peer may still store into that card.  What is left to the
spin bound (``SPIN_TIMEOUT_S``) is a kernel that cannot start for longer
than that once its stream reaches it, for example while kernels of other
streams hold the card: that becomes ``SimdDctError``.

``remote_dma_selfring_smoke`` is the one-card preflight of the kernel's
machinery (``selfring_kernel``, the same device code on a ring of one whose
peer is the card itself).

Across processes (a mesh whose positions are the ranks of a process
group, ``mesh.py``), each rank holds one segment.  On a mesh of CPUs the
plain version is a ``torch.distributed.all_gather`` over the group (gloo)
of the local segments, joined in ring order.  On a mesh of cards each
rank launches ``ring_gather_kernel`` once, for its own segment, storing it
into slot ``me`` of its own output and, through CUDA IPC, of every peer's
output (``sdct_ipc_handle`` / ``sdct_ipc_open``; a peer's mapped
allocation is cached per card by its handle, since one process may not
open an allocation twice, and a rank's own slot takes its own pointer).
Events cannot cross processes, so the host orders the ranks, through
rendezvous in the group's key-value store (``_meet``), in this order:

1. the rank synchronises its stream, so nothing queued earlier on it
   still uses the memory of the new output that peers will store into;
2. rendezvous 1: each rank posts its output's handle and offset and
   reads every peer's; every rank launches only once every rank has come;
3. the launch, with no barrier slots and no arrival counter in the
   descriptor: the kernel never waits for another process, so two
   processes that time-slice one card cannot stall it (a kernel that
   waited for its peers' flags across processes took milliseconds on one
   card, PERF.md);
4. the rank synchronises its stream (its stores into every output have
   landed) and meets the others again (rendezvous 2: one counter a ring,
   each rank adding its arrival and whether its part failed): no output
   is returned, and no peer's memory freed, before every kernel that
   stores into it has ended.  Every rank told to go comes to rendezvous
   2, also when its mapping or launch failed, so the ring's counter stays
   in step and the peers learn that a segment is missing.

A rendezvous's keys are deleted once every rank is past it, by a thread
with a client of its own (``_Deleter``), off the gather's path.

A rendezvous that is not complete within ``timeout_s`` (the spin bound)
is aborted for the whole ring: every rank that had come raises
``SimdDctError``; a rank that comes later finds the abort and joins the
ring's next gather instead, so the ranks stay in step and no rank hangs.
A store that fails (its host, rank 0, died, or the connection to it
broke) raises ``SimdDctError`` at once.  An output whose second
rendezvous failed, or whose first failed by the store, is kept, never
freed, since a peer's kernel may still store into it.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import datetime
import math
import struct
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from ..api import InvalidParameterError, NotSupportedError, SimdDctError
from ..dispatch.capability import default_device
from ..kernels import _build
from ..kernels import cuda_dct as _cuda
from .mesh import DATA_AXIS, Mesh, Sharded, shard, store

# How long a CTA spins on a flag before it gives up and reports.
SPIN_TIMEOUT_S = 1.0
# csrc/collectives.cu: ranks of a ring, ranks of one launch and the int64
# words of a rank's descriptor
MAX_RING = 8
MAX_LOCAL = 8
_DESC_WORDS = 7 + 4 * MAX_RING
# csrc/collectives.cu kMaxTile and kMaxStages: a tile is at most 16 KB
# (whole rows, or a piece of one row), a CTA cycles through 2 to 4 of them
_TILE = 16384
_STAGES = 4
# CTAs of one launch on a streaming multiprocessor, at most; and the bytes
# of a segment that earn a rank one more CTA
_CTAS_PER_SM = 2
_CTA_BYTES = 32768
# a mesh position's flag words: a barrier slot for each rank of its ring,
# then its arrival counter
_SLOT_WORDS = MAX_RING + 1
_U32 = 0xFFFFFFFF
_ERRORS = {1: "a peer never entered the kernel (barrier)",
           2: "a peer's stores never arrived",
           3: "a bulk load into shared memory never completed"}
# peer allocations kept mapped, per card, before the least recently used
# is unmapped
_OPEN_CACHE = 64
# CUDA_IPC_HANDLE_SIZE
_IPC_HANDLE = 64


def _segments(segments, mesh: Mesh, axis_name: str) -> Sharded:
    """``segments`` as a value split over ``axis_name``: a ``Sharded`` on
    ``mesh`` as it is, a whole (64, S, seg) tensor split along S."""
    a = mesh.axis(axis_name)
    n = mesh.devices.shape[a]
    if isinstance(segments, Sharded):
        if segments.mesh is not mesh:
            raise InvalidParameterError("segments lie on another mesh")
        if segments.dims[a] is None or segments.shape is not None:
            raise InvalidParameterError(
                f"segments are not split over {axis_name!r}")
        if len({tuple(s.shape) for s in segments.shards}) != 1:
            raise InvalidParameterError(
                "the ring forwards equal-size slots: every shard must have "
                "one shape")
        return segments
    t = segments if isinstance(segments, torch.Tensor) else \
        torch.from_numpy(np.ascontiguousarray(np.asarray(segments)))
    if t.shape[1] % n:
        # the ring forwards equal-size slots; a ragged strip axis would
        # silently corrupt the tail shard's segment
        raise InvalidParameterError(
            f"gather_planes_remote needs the strip axis ({t.shape[1]}) to "
            f"divide evenly over the {n} '{axis_name}' shards")
    return shard(t, mesh, {axis_name: 1})


def _rings(mesh: Mesh, a: int) -> list[list[int]]:
    """Flat mesh positions of each ring along axis ``a``, in ring order."""
    grid = mesh.devices.shape
    rings = []
    for idx in np.ndindex(grid):
        if idx[a] == 0:
            rings.append([int(np.ravel_multi_index(
                idx[:a] + (k,) + idx[a + 1:], grid)) for k in range(grid[a])])
    return rings


def _replicated_along(seg: Sharded, a: int, shards) -> Sharded:
    dims = list(seg.dims)
    dims[a] = None
    return Sharded(tuple(shards), seg.mesh, tuple(dims))


def gather_planes_ring(segments, mesh: Mesh, *,
                       axis_name: str = DATA_AXIS) -> Sharded:
    """The plain version: a ring all-gather.  Each of n-1 steps every rank
    passes the segment it received last to its right neighbour (a copy to
    that neighbour's device); then each rank joins its pieces, newest
    first, and rolls them by (its index + 1) segments, which puts rank k's
    segment in slot k (``simd_dct_tpu/dist/collectives.py:125-153``)."""
    seg = _segments(segments, mesh, axis_name)
    a = mesh.axis(axis_name)
    if mesh.process_count > 1:
        return _replicated_along(seg, a, [_allgather_procs(seg, a)])
    d = seg.dims[a]
    out = [None] * mesh.size
    for ring in _rings(mesh, a):
        n = len(ring)
        devs = [mesh.devices.flat[p] for p in ring]
        bufs = [seg.shards[p] for p in ring]
        pieces = [[b] for b in bufs]
        for _ in range(n - 1):
            bufs = [bufs[(k - 1) % n].to(devs[k]) for k in range(n)]
            for k in range(n):
                pieces[k].append(bufs[k])
        chunk = bufs[0].shape[d]
        for k, p in enumerate(ring):
            stacked = torch.cat(pieces[k][::-1], dim=d)
            out[p] = torch.roll(stacked, (k + 1) * chunk, dims=d)
    return _replicated_along(seg, a, out)


def gather_planes_allgather(segments, mesh: Mesh, *,
                            axis_name: str = DATA_AXIS) -> Sharded:
    """Every rank joins the ring's segments in order: one ``torch.cat``.
    Across processes: a ``torch.distributed.all_gather`` of the local
    segments over the ring's process group (gloo), joined in ring order
    (a CUDA segment goes through the host)."""
    seg = _segments(segments, mesh, axis_name)
    a = mesh.axis(axis_name)
    if mesh.process_count > 1:
        return _replicated_along(seg, a, [_allgather_procs(seg, a)])
    d = seg.dims[a]
    out = [None] * mesh.size
    for ring in _rings(mesh, a):
        for p in ring:
            dev = mesh.devices.flat[p]
            out[p] = torch.cat([seg.shards[q].to(dev) for q in ring], dim=d)
    return _replicated_along(seg, a, out)


def gather_planes_remote(segments, mesh: Mesh, *, axis_name: str = DATA_AXIS,
                         timeout_s: float = SPIN_TIMEOUT_S) -> Sharded:
    """The ring all-gather kernel: on a mesh of cards one launch of
    ``ring_gather_kernel`` per card, covering every rank on it; on a CPU
    mesh the plain version (``gather_planes_ring``).  It does not wait for
    the cards: a spin that ran out (after ``timeout_s``) raises
    ``SimdDctError`` from the next gather on the mesh or from
    ``check_workspace``.  Across processes: one launch in each process
    (``_gather_procs``), or on a mesh of CPUs the all-gather over the
    process group; a rendezvous incomplete after ``timeout_s`` raises
    ``SimdDctError`` in the call."""
    seg = _segments(segments, mesh, axis_name)
    a = mesh.axis(axis_name)
    if mesh.devices.shape[a] == 1:
        return _replicated_along(seg, a, seg.shards)
    if mesh.process_count > 1:
        if mesh.device_type == "cpu":
            return gather_planes_allgather(seg, mesh, axis_name=axis_name)
        return _replicated_along(seg, a, [_gather_procs(seg, a,
                                                        timeout_s=timeout_s)])
    if mesh.device_type == "cpu":
        return gather_planes_ring(seg, mesh, axis_name=axis_name)
    return _replicated_along(seg, a,
                             _gather_on_cards(seg, a, timeout_s=timeout_s))


def gather_planes_auto(segments, mesh: Mesh, *,
                       axis_name: str = DATA_AXIS) -> Sharded:
    """What ``gather=True`` uses: ``gather_planes_remote`` (the kernel on a
    mesh of cards, within a process or across processes; the plain
    version on a mesh of CPUs)."""
    return gather_planes_remote(segments, mesh, axis_name=axis_name)


# -- the kernel's host side ---------------------------------------------------

class _ErrorWords:
    """u32 words of pinned host memory that every card can store into
    (``sdct_host_words``), handed out one a card of a workspace.  A word is
    never reused and its memory never freed, so a kernel that reports late
    writes into nothing else."""

    CHUNK = 4096

    def __init__(self):
        self.lock = threading.Lock()
        self.words = None
        self.used = self.CHUNK

    def take(self, lib) -> tuple[np.ndarray, int]:
        """(the chunk's words as a live numpy view, index of a new word)."""
        with self.lock:
            if self.used == self.CHUNK:
                ptr = ctypes.c_void_p()
                _build.check(lib, lib.sdct_host_words(self.CHUNK,
                                                      ctypes.byref(ptr)),
                             "pinned error words")
                self.words = np.ctypeslib.as_array(
                    ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint32)),
                    shape=(self.CHUNK,))
                self.used = 0
            self.used += 1
            return self.words, self.used - 1


_ERROR_WORDS = _ErrorWords()


class _Workspace:
    """A mesh's flags: on each card an int32 tensor holding, for each mesh
    position on the card, a barrier slot for each rank of its ring and an
    arrival counter; a host-mapped error word for each card; and on the
    host the last generation and the value each arrival counter must reach
    next (mod 2^32: the kernel compares signed differences)."""

    def __init__(self, mesh: Mesh, lib):
        self.lock = threading.Lock()
        per_dev = _per_device(mesh)
        self.slot = {p: (dev, _SLOT_WORDS * i)
                     for dev, ps in per_dev.items() for i, p in enumerate(ps)}
        self.flags = {dev: torch.zeros(_SLOT_WORDS * len(ps),
                                       dtype=torch.int32, device=dev)
                      for dev, ps in per_dev.items()}
        # a peer may signal a card before that card's stream has run the
        # zeroing: finish it everywhere first (once per mesh)
        for dev in self.flags:
            torch.cuda.synchronize(dev)
        self.err = {dev: _ERROR_WORDS.take(lib) for dev in self.flags}
        self.gen = 0
        self.arr = [0] * mesh.size
        self.capacity: dict[tuple[torch.device, bool], tuple[int, int]] = {}
        self.last_plan: _Plan | None = None

    def bar_ptr(self, p: int, k: int) -> int:
        """Slot ``k`` (ring position of the peer) of position p's barrier."""
        dev, i = self.slot[p]
        return self.flags[dev].data_ptr() + 4 * (i + k)

    def arr_ptr(self, p: int) -> int:
        return self.bar_ptr(p, MAX_RING)

    def err_ptr(self, dev: torch.device) -> int:
        words, i = self.err[dev]
        return words.ctypes.data + 4 * i

    def errors(self) -> dict[torch.device, int]:
        """The cards whose kernels reported, with their codes."""
        codes = {dev: int(words[i]) for dev, (words, i) in self.err.items()}
        return {dev: c for dev, c in codes.items() if c}

    def capacity_of(self, lib, dev: torch.device,
                    vec: bool) -> tuple[int, int]:
        """(CTAs of the variant an SM holds at once, SMs) of the card
        (queried once per card and variant)."""
        if (dev, vec) not in self.capacity:
            out = np.zeros(2, np.int32)
            with torch.cuda.device(dev):
                _build.check(lib, lib.sdct_gather_capacity(
                    int(vec), out.ctypes.data, out.ctypes.data + 4),
                    "gather capacity")
            self.capacity[dev, vec] = (int(out[0]), int(out[1]))
        return self.capacity[dev, vec]


_workspace_lock = threading.Lock()


def _workspace(mesh: Mesh, lib) -> _Workspace:
    with _workspace_lock:
        if mesh._collective_workspace is None:
            mesh._collective_workspace = _Workspace(mesh, lib)
        return mesh._collective_workspace


def _drop(mesh: Mesh, ws: _Workspace) -> dict[torch.device, int]:
    """Wait for every card of the mesh, so that no kernel of the workspace
    still runs, then drop it (its counters are out of step); the codes its
    kernels reported."""
    for dev in ws.flags:
        torch.cuda.synchronize(dev)
    if mesh._collective_workspace is ws:
        mesh._collective_workspace = None
    return ws.errors()


def _raise_reported(mesh: Mesh, ws: _Workspace, *, wait: bool) -> None:
    """Raise ``SimdDctError`` if a kernel of the workspace reported: after
    waiting for the mesh's cards (``wait``), or as far as the words show
    now."""
    if wait:
        for dev in ws.flags:
            torch.cuda.synchronize(dev)
    if not ws.errors():
        return
    bad = _drop(mesh, ws)
    what = "; ".join(f"{dev}: {_ERRORS.get(c, c)}" for dev, c in bad.items())
    raise SimdDctError(
        f"plane gather on {what}, within the spin bound; the mesh's flag "
        "workspace was dropped")


def check_workspace(mesh: Mesh) -> None:
    """Wait for the mesh's cards and raise ``SimdDctError`` if a spin of
    one of its gathers timed out.  The counters are then out of step, so
    the workspace is dropped and the next gather allocates a new one.
    Across processes a gather raises in the call, so there is nothing
    left to report here."""
    ws = mesh._collective_workspace
    if ws is not None and not isinstance(ws, _ProcWorkspace):
        _raise_reported(mesh, ws, wait=True)


_peer_lock = threading.Lock()
_peers_enabled: set[tuple[int, int]] = set()


def _enable_peers(lib, mesh: Mesh, rings) -> None:
    """Peer access between every two cards of a ring; raises where a pair
    has none (no staging through the host)."""
    with _peer_lock:
        for ring in rings:
            cards = {mesh.devices.flat[p].index for p in ring}
            for i in cards:
                for j in cards - {i}:
                    if (i, j) in _peers_enabled:
                        continue
                    rc = lib.sdct_enable_peer(i, j)
                    if rc:
                        raise SimdDctError(
                            f"cuda:{i} cannot store into cuda:{j}'s memory "
                            f"(peer access: {lib.sdct_error_string(rc)})")
                    _peers_enabled.add((i, j))


def _gather_view(t: torch.Tensor, d: int) -> torch.Tensor:
    """(outer, chunk, inner) contiguous, 16-byte aligned view of a shard
    split on dim ``d``."""
    t = t.contiguous()
    if t.data_ptr() % 16:
        t = t.clone()
    return t.view(math.prod(t.shape[:d]), t.shape[d],
                  math.prod(t.shape[d + 1:]))


def _desc(src: int, arr: int, gen: int, arr_target: int, dsts, flags,
          signal, wait) -> list[int]:
    """One rank's descriptor, in the order csrc/collectives.cu unpacks."""
    def pad(ptrs):
        return [*ptrs, *([0] * (MAX_RING - len(ptrs)))]
    words = [src, arr, len(dsts), len(signal), len(wait), gen & _U32,
             arr_target & _U32, *pad(dsts), *pad(flags), *pad(signal),
             *pad(wait)]
    return [w - (1 << 64) if w >= 1 << 63 else w for w in words]


class _Plan(NamedTuple):
    """How one gather launches (csrc/collectives.cu): ``tile`` bytes a
    tile, ``stages`` shared buffers a CTA (the bulk variant), ``blocks``
    CTAs a rank, and ``arrivals``, what the gather adds to each rank's
    arrival counter (one from each CTA of each peer that stores into it)."""
    tile: int
    stages: int
    blocks: int
    arrivals: int

    def target(self, counter: int) -> int:
        """The value an arrival counter at ``counter`` must reach (mod
        2^32: the kernel compares signed differences)."""
        return (counter + self.arrivals) & _U32


def _tile(outer: int, row: int) -> int:
    """Bytes of a tile: as many whole rows as fit in ``_TILE`` (at most
    ``outer``); a longer row cut into the fewest pieces of at most
    ``_TILE`` bytes, rounded up to 16 (the last piece takes what is
    left)."""
    if row <= _TILE:
        return min(_TILE // row, outer) * row
    pieces = -(-row // _TILE)
    return (-(-row // pieces) + 15) // 16 * 16


def _n_tiles(outer: int, row: int, tile: int) -> int:
    if tile >= row:
        return -(-outer // (tile // row))
    return outer * -(-row // tile)


def _ctas_fit(per_sm: int, sms: int, local_ranks: int) -> int:
    """CTAs a rank may take on a card of ``sms`` SMs holding ``per_sm``
    CTAs each, shared by ``local_ranks`` ranks: at most ``_CTAS_PER_SM``
    an SM for the whole launch, and all of them resident at once."""
    fit = min(per_sm, _CTAS_PER_SM) * sms // local_ranks
    if fit < 1:
        raise NotSupportedError("too many ranks on one card for the gather")
    return fit


def _plan(outer: int, row: int, fit: int, peers: int) -> _Plan:
    """The launch for segments of ``outer`` rows of ``row`` bytes: one CTA
    a rank for each ``_CTA_BYTES`` of its segment, at most ``fit`` (the
    least over the cards); as many stages as a CTA has tiles, 2 to
    ``_STAGES``.  ``peers``: the ranks that store into each rank, each
    with ``blocks`` CTAs (n - 1 on a ring of n; 1 on the self-ring, whose
    one peer is itself)."""
    tile = _tile(outer, row)
    blocks = max(1, min(fit, -(-outer * row // _CTA_BYTES)))
    per_cta = -(-_n_tiles(outer, row, tile) // blocks)
    return _Plan(tile, max(2, min(_STAGES, per_cta)), blocks, peers * blocks)


def _per_device(mesh: Mesh) -> dict[torch.device, list[int]]:
    """The mesh positions on each device, in mesh order."""
    per_dev: dict[torch.device, list[int]] = {}
    for p, dev in enumerate(mesh.devices.flat):
        per_dev.setdefault(dev, []).append(p)
    return per_dev


def _system_scope(per_dev) -> bool:
    """Flags at system scope: the ranks, hence the destinations, lie on
    more than one card.  On one card, card scope orders them as well."""
    return len(per_dev) > 1


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev)


def _join_streams(cards) -> None:
    """Each card's stream waits for every other card's stream as it stands
    (an event each)."""
    marks = {}
    for dev in cards:
        marks[dev] = torch.cuda.Event()
        marks[dev].record(_stream(dev))
    for dev in cards:
        for other in cards:
            if other != dev:
                _stream(dev).wait_event(marks[other])


def _start_together(cards) -> None:
    """Before the launches: the kernels start only once every card has
    finished its earlier work, so none spins while a peer is still busy."""
    _join_streams(cards)


def _gather_on_cards(seg: Sharded, a: int, *,
                     timeout_s: float) -> list[torch.Tensor]:
    mesh = seg.mesh
    d = seg.dims[a]
    rings = _rings(mesh, a)
    n = len(rings[0])
    if n > MAX_RING:
        raise NotSupportedError(
            f"the gather kernel takes rings of at most {MAX_RING} ranks, "
            f"got {n}")
    per_dev = _per_device(mesh)
    if max(len(r) for r in per_dev.values()) > MAX_LOCAL:
        raise NotSupportedError(
            f"the gather kernel takes at most {MAX_LOCAL} ranks on one card")
    lib = _build.load()
    _enable_peers(lib, mesh, rings)
    ws = _workspace(mesh, lib)
    # an earlier gather's timeout, as far as its card has reported it
    _raise_reported(mesh, ws, wait=False)
    views = [_gather_view(s, d) for s in seg.shards]
    outer, chunk, inner = views[0].shape
    row = chunk * inner
    shape = list(seg.shards[0].shape)
    shape[d] *= n
    outs = [torch.empty(shape, dtype=torch.uint8, device=v.device)
            for v in views]
    vec = row % 16 == 0 and all(t.data_ptr() % 16 == 0
                                for t in views + outs)
    ring_of = {p: (ring, k) for ring in rings for k, p in enumerate(ring)}
    sys_scope = _system_scope(per_dev)
    try:
        with ws.lock:
            fit = min(_ctas_fit(*ws.capacity_of(lib, dev, vec), len(ranks))
                      for dev, ranks in per_dev.items())
            plan = ws.last_plan = _plan(outer, row, fit, n - 1)
            ws.gen = (ws.gen + 1) & _U32
            if sys_scope:
                _start_together(per_dev)
            for dev, ranks in per_dev.items():
                desc = []
                for p in ranks:
                    ring, me = ring_of[p]
                    peers = [(k, q) for k, q in enumerate(ring) if q != p]
                    ws.arr[p] = plan.target(ws.arr[p])
                    desc += _desc(
                        views[p].data_ptr(), ws.arr_ptr(p), ws.gen, ws.arr[p],
                        [outs[q].data_ptr() + me * row for q in ring],
                        [0 if q == p else ws.arr_ptr(q) for q in ring],
                        [ws.bar_ptr(q, me) for _, q in peers],
                        [ws.bar_ptr(p, k) for k, _ in peers])
                words = np.asarray(desc, np.int64)
                with torch.cuda.device(dev):
                    rc = lib.sdct_ring_gather(
                        words.ctypes.data, len(ranks), plan.blocks, outer,
                        row, n * row, int(vec), int(sys_scope), plan.tile,
                        plan.stages, ws.err_ptr(dev), int(timeout_s * 1e9),
                        _stream(dev).cuda_stream)
                    _cuda.LAUNCHES["ring_gather"] += 1
                _build.check(lib, rc, "ring_gather")
            if sys_scope:
                # after the launches: what each card queues next, a reuse of
                # a dropped output or flag tensor included, waits for every
                # card's kernel, the peers that store into its memory.
                # (record_stream cannot say this: a card's default stream
                # has the same handle as every other card's, which the
                # caching allocator takes for its own stream and ignores.)
                _join_streams(per_dev)
    except BaseException:
        _drop(mesh, ws)     # kernels already launched run out first
        raise
    return outs


# -- across processes ---------------------------------------------------------

def _my_ring(mesh: Mesh, a: int) -> tuple[list[int], int]:
    """The ring along axis ``a`` that holds this process's position, and
    that position's index in it."""
    p = mesh.local_positions[0]
    for ring in _rings(mesh, a):
        if p in ring:
            return ring, ring.index(p)
    raise AssertionError("a position lies on no ring")


def _ring_group(mesh: Mesh, a: int, ring: list[int]):
    """The process group of this process's ring along axis ``a``: the
    default group when the ring is the whole world, else one made for each
    ring of the axis (collective the first time, in the same order on
    every rank) and kept on the mesh."""
    import torch.distributed as tdist
    ranks = [int(mesh.ranks.flat[q]) for q in ring]
    if len(ranks) == tdist.get_world_size():
        return None
    groups = mesh.__dict__.setdefault("_ring_groups", {})
    if a not in groups:
        groups[a] = {}
        for r in _rings(mesh, a):
            rr = tuple(int(mesh.ranks.flat[q]) for q in r)
            groups[a][rr] = tdist.new_group(list(rr))
    return groups[a][tuple(ranks)]


def _allgather_procs(seg: Sharded, a: int) -> torch.Tensor:
    """The plain version across processes: the ring's segments gathered
    over its process group and joined in ring order, on the segment's
    device (through the host)."""
    import torch.distributed as tdist
    mesh = seg.mesh
    ring, _ = _my_ring(mesh, a)
    d = seg.dims[a]
    local = seg.shards[0]
    host = local.cpu().contiguous()
    pieces = [torch.empty_like(host) for _ in ring]
    tdist.all_gather(pieces, host, group=_ring_group(mesh, a, ring))
    return torch.cat(pieces, dim=d).to(local.device)


class _StoreLost(SimdDctError):
    """The process group's key-value store failed, not by a timeout: its
    host, rank 0, died or the connection to it broke."""


@contextlib.contextmanager
def _store_lost(key: str):
    """Store errors within the block as ``_StoreLost``."""
    try:
        yield
    except RuntimeError as e:    # torch's DistNetworkError and the like
        why = str(e).strip().splitlines()[0] if str(e).strip() else ""
        raise _StoreLost(
            f"plane gather across processes: the process group's store "
            f"failed at {key} ({type(e).__name__}: {why}); rank 0, which "
            "hosts it, may have died") from None


def _meet(kv, key: str, me: int, n: int, payload: bytes,
          timeout_s: float) -> list[bytes] | None:
    """One rendezvous of a ring's ``n`` ranks under ``key``: post
    ``payload`` and agree.  Exactly one decision is taken, by the store's
    compare-and-set: "go" by the last rank to come, or "abort" by a rank
    that waited ``timeout_s`` in vain.  Returns every rank's payload in
    ring order on "go"; None where this rank was there when the ring
    aborted; ``[]`` where it came after the abort (it joins the next
    gather).  A failing store raises ``_StoreLost``."""
    import torch.distributed as tdist
    with _store_lost(key):
        kv.set(f"{key}/p{me}", payload)
        came = kv.add(f"{key}/n", 1)
        dec = f"{key}/dec"
        if came == n:
            decision = kv.compare_set(dec, "", "go")
        else:
            try:
                kv.wait([dec], datetime.timedelta(seconds=timeout_s))
                decision = kv.get(dec)
            except tdist.DistStoreError:     # the wait timed out
                decision = kv.compare_set(dec, "",
                                          f"abort {kv.add(f'{key}/n', 0)}")
        if decision == b"go":
            # every payload is posted: the last rank decides after posting
            # its own, the others posted before they counted themselves
            # (after an abort a payload may never come, so it is read only
            # on "go")
            return kv.multi_get([f"{key}/p{k}" for k in range(n)])
    there = int(decision.split()[1])
    return None if came <= there else []


def _forget(kv, key: str, me: int) -> None:
    """Delete a finished rendezvous's keys: each rank its own payload, the
    ring's first rank the count and the decision (on the deleting thread
    where the store has one)."""
    drop = _deleter(kv)
    drop(f"{key}/p{me}")
    if me == 0:
        drop(f"{key}/n")
        drop(f"{key}/dec")


# a rank's arrival at the second rendezvous adds 1 to its ring's counter,
# and this much more if its part of the gather failed
_ERR_UNIT = 1 << 40


def _done(kv, key: str, k: int, n: int, failed: bool,
          timeout_s: float) -> int | None:
    """The second rendezvous of the ring's k-th gather (every rank told to
    go comes here unless it died): each rank adds its arrival, and
    ``_ERR_UNIT`` if its part failed, to the ring's one counter; the rank
    that brings the arrivals to n*k posts the counter under
    ``{key}/done{k}``, which the others wait for.  Returns the error units
    the ring has counted so far, or None after ``timeout_s``.  A failing
    store raises ``_StoreLost``."""
    import torch.distributed as tdist
    mark = f"{key}/done{k}"
    with _store_lost(mark):
        v = kv.add(f"{key}/done", 1 + (_ERR_UNIT if failed else 0))
        if v % _ERR_UNIT == n * k:
            kv.set(mark, str(v))
        else:
            try:
                kv.wait([mark], datetime.timedelta(seconds=timeout_s))
            except tdist.DistStoreError:     # the wait timed out
                return None
            v = int(kv.get(mark))
    return v // _ERR_UNIT


class _Deleter:
    """Deletes finished rendezvous keys on a thread of its own, through a
    client of its own to the same store (connected on that thread), so
    that no gather waits for the round trips."""

    def __init__(self, kv):
        import queue
        self.host, self.port = kv.host, kv.port
        self.keys: queue.Queue = queue.Queue()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="sdct-store-deleter")
        self.thread.start()

    def __call__(self, key: str) -> None:
        self.keys.put(key)

    def _run(self) -> None:
        import torch.distributed as tdist
        try:
            client = tdist.TCPStore(self.host, self.port, is_master=False,
                                    timeout=datetime.timedelta(seconds=30))
        except RuntimeError:     # the store is gone: nothing to delete
            client = None
        while True:
            key = self.keys.get()
            try:
                if key is None:
                    return
                if client is not None:
                    client.delete_key(key)
            except RuntimeError:     # the store is gone: nothing to keep
                pass
            finally:
                self.keys.task_done()

    def flush(self) -> None:
        """Wait until every key handed over so far is deleted."""
        self.keys.join()

    def stop(self) -> None:
        self.keys.put(None)
        self.thread.join(timeout=5.0)


_deleters: dict[int, _Deleter] = {}
_deleters_lock = threading.Lock()


def _deleter(kv):
    """The deleting thread of the store ``initialize_distributed`` made (a
    ``TCPStore``), else the store's own ``delete_key``."""
    import torch.distributed as tdist
    if not isinstance(kv, tdist.TCPStore):
        return kv.delete_key
    with _deleters_lock:
        if id(kv) not in _deleters:
            _deleters[id(kv)] = _Deleter(kv)
            import atexit
            atexit.register(_deleters[id(kv)].stop)
        return _deleters[id(kv)]


_opened_lock = threading.Lock()
# (card index, handle bytes) -> mapped base, least recently used first
_opened: collections.OrderedDict = collections.OrderedDict()


def _export(lib, t: torch.Tensor) -> tuple[bytes, int]:
    """The IPC handle of the allocation holding ``t`` and t's offset in it."""
    handle = ctypes.create_string_buffer(_IPC_HANDLE)
    off = ctypes.c_longlong()
    _build.check(lib, lib.sdct_ipc_handle(t.data_ptr(), handle,
                                          ctypes.byref(off)),
                 "exporting a CUDA IPC handle")
    return handle.raw, off.value


def _open_peer(lib, dev: torch.device, handle: bytes, stats: dict) -> int:
    """A peer process's allocation mapped into this one on ``dev`` (cached
    by its handle; the least recently used mapping beyond ``_OPEN_CACHE``
    a card is unmapped once the card has finished its work)."""
    key = (dev.index, handle)
    with _opened_lock:
        if key in _opened:
            _opened.move_to_end(key)
            stats["hits"] += 1
            return _opened[key]
        t0 = time.perf_counter()
        ptr = ctypes.c_void_p()
        with torch.cuda.device(dev):
            rc = lib.sdct_ipc_open(handle, ctypes.byref(ptr))
        if rc:
            raise SimdDctError(
                f"cannot map a peer process's memory on {dev} (CUDA IPC: "
                f"{lib.sdct_error_string(rc).decode(errors='replace')})")
        stats["opens"] += 1
        stats["open_s"] += time.perf_counter() - t0
        _opened[key] = ptr.value
        mine = [k for k in _opened if k[0] == dev.index]
        if len(mine) > _OPEN_CACHE:
            torch.cuda.synchronize(dev)     # no kernel still stores there
            old = mine[0]
            _build.check(lib, lib.sdct_ipc_close(_opened.pop(old)),
                         "unmapping a peer's memory")
        return ptr.value


def _procs_desc(src: int, me: int, outs, row: int, gen: int) -> list[int]:
    """This rank's descriptor for the gather across processes: no arrival
    counter, no barrier slots.  ``outs[k]``: ring position k's output as
    this process addresses it (its own pointer at ``me``, a peer's mapped
    base plus its offset elsewhere); the segment goes to slot ``me`` of
    each, ``me * row`` bytes into a row."""
    n = len(outs)
    return _desc(src, 0, gen, 0, [o + me * row for o in outs], [0] * n,
                 [], [])


# a rank's payload at the first rendezvous: its output's IPC handle and
# offset, and whether its segment and output take the 16-byte variant
_PAYLOAD = struct.Struct(f"<{_IPC_HANDLE}sqi")


class _ProcWorkspace:
    """A mesh's state for the gather across processes, in one process: its
    card's error word, the last generation and the gathers ended of each
    ring, the error units seen, and the host's phases of the last
    gather."""

    def __init__(self, lib, dev: torch.device):
        self.lock = threading.Lock()
        self.dev = dev
        self.err = _ERROR_WORDS.take(lib)
        self.gen: dict[str, int] = {}
        self.done: dict[str, int] = {}
        self.errors_seen: dict[str, int] = {}
        self.capacity: dict[bool, tuple[int, int]] = {}
        self.last_plan: _Plan | None = None
        self.last_host: dict[str, float] = {}
        self.stats = {"opens": 0, "hits": 0, "open_s": 0.0, "skipped": 0}

    def error(self) -> int:
        words, i = self.err
        return int(words[i])

    def err_ptr(self) -> int:
        words, i = self.err
        return words.ctypes.data + 4 * i

    def capacity_of(self, lib, vec: bool) -> tuple[int, int]:
        if vec not in self.capacity:
            out = np.zeros(2, np.int32)
            with torch.cuda.device(self.dev):
                _build.check(lib, lib.sdct_gather_capacity(
                    int(vec), out.ctypes.data, out.ctypes.data + 4),
                    "gather capacity")
            self.capacity[vec] = (int(out[0]), int(out[1]))
        return self.capacity[vec]


# outputs into which a peer's kernel may still store: their memory is never
# given back
_held: list[torch.Tensor] = []


def _gather_procs(seg: Sharded, a: int, *, timeout_s: float) -> torch.Tensor:
    """This process's rank of the gather across processes (module
    docstring): one launch of ``ring_gather_kernel``."""
    mesh = seg.mesh
    ring, me = _my_ring(mesh, a)
    n = len(ring)
    if n > MAX_RING:
        raise NotSupportedError(
            f"the gather kernel takes rings of at most {MAX_RING} ranks, "
            f"got {n}")
    d = seg.dims[a]
    dev = seg.shards[0].device
    lib = _build.load()
    with _workspace_lock:
        if mesh._collective_workspace is None:
            mesh._collective_workspace = _ProcWorkspace(lib, dev)
        ws = mesh._collective_workspace
    view = _gather_view(seg.shards[0], d)
    outer, chunk, inner = view.shape
    row = chunk * inner
    shape = list(seg.shards[0].shape)
    shape[d] *= n
    out = torch.empty(shape, dtype=torch.uint8, device=dev)
    vec = row % 16 == 0 and view.data_ptr() % 16 == 0 \
        and out.data_ptr() % 16 == 0
    kv = store()
    ring_key = f"{mesh.key}/a{a}/r{ring[0]}"
    stream = _stream(dev)
    t0 = time.perf_counter()
    with ws.lock:
        # step 1: nothing queued earlier still uses out's memory
        stream.synchronize()
        t1 = time.perf_counter()
        handle, off = _export(lib, out)
        payload = _PAYLOAD.pack(handle, off, int(vec))
        try:
            while True:
                gen = ws.gen[ring_key] = ws.gen.get(ring_key, 0) + 1
                got = _meet(kv, f"{ring_key}/g{gen}", me, n, payload,
                            timeout_s)
                if got != []:
                    break
                ws.stats["skipped"] += 1    # came after an abort: next one
        except _StoreLost:
            _held.append(out)     # a peer may have been told to go
            raise
        t2 = time.perf_counter()
        if got is None:
            raise SimdDctError(
                f"plane gather across processes: not every rank of the ring "
                f"came within {timeout_s} s (rank "
                f"{int(mesh.ranks.flat[ring[me]])}, generation {gen})")
        k = ws.done[ring_key] = ws.done.get(ring_key, 0) + 1
        fault = None
        t3 = t2
        try:
            peers = [_PAYLOAD.unpack(b) for b in got]
            vec = all(p[2] for p in peers)
            plan = ws.last_plan = _plan(
                outer, row, _ctas_fit(*ws.capacity_of(lib, vec), 1), 0)
            outs = [out.data_ptr() if j == me else
                    _open_peer(lib, dev, h, ws.stats) + o
                    for j, (h, o, _) in enumerate(peers)]
            words = np.asarray(_procs_desc(view.data_ptr(), me, outs, row,
                                           gen), np.int64)
            t3 = time.perf_counter()
            # no flags, so card scope (the stores are ordered by the
            # kernel's end and step 4)
            with torch.cuda.device(dev):
                rc = lib.sdct_ring_gather(
                    words.ctypes.data, 1, plan.blocks, outer, row, n * row,
                    int(vec), 0, plan.tile, plan.stages, ws.err_ptr(),
                    int(timeout_s * 1e9), stream.cuda_stream)
                _cuda.LAUNCHES["ring_gather"] += 1
            _build.check(lib, rc, "ring_gather")
        except Exception as e:     # still meet: the ring stays in step
            fault = e
        # every rank is past the ring's gather before this one: its keys go
        _forget(kv, f"{ring_key}/g{gen - 1}", me)
        if me == 0 and k > 1:
            _deleter(kv)(f"{ring_key}/done{k - 1}")
        # step 4: this rank's stores have landed; then every rank's
        stream.synchronize()
        t4 = time.perf_counter()
        code = ws.error()
        try:
            errors = _done(kv, ring_key, k, n, fault is not None or bool(code),
                           timeout_s)
        except _StoreLost:
            _held.append(out)
            raise
        if errors is None:
            _held.append(out)
            raise SimdDctError(
                f"plane gather across processes: not every rank ended its "
                f"part within {timeout_s} s (generation {gen}); the output "
                "is kept, never freed")
        peer_failed = errors - ws.errors_seen.get(ring_key, 0) \
            > (fault is not None or bool(code))
        ws.errors_seen[ring_key] = errors
        ws.last_host = dict(sync=t1 - t0, meet=t2 - t1, open=t3 - t2,
                            launch_sync=t4 - t3,
                            meet_done=time.perf_counter() - t4)
        if fault is not None:
            raise fault
        if code:
            ws.err = _ERROR_WORDS.take(lib)     # a word is never reused
            raise SimdDctError(
                f"plane gather across processes: "
                f"{_ERRORS.get(code, code)}, within the spin bound")
        if peer_failed:
            raise SimdDctError(
                "plane gather across processes: a peer's part failed, so "
                "its segment is missing from the output")
    return out


# -- the one-card preflight ---------------------------------------------------

def selfring_plain(local: torch.Tensor) -> torch.Tensor:
    """The self-ring's plain version: (outer, chunk, inner) ->
    (outer, 2*chunk, inner), the segment in both slots (a copy)."""
    return torch.cat([local, local.clone()], dim=1)


_self_meshes: dict[torch.device, Mesh] = {}


def selfring(local: torch.Tensor, *,
             timeout_s: float = SPIN_TIMEOUT_S) -> torch.Tensor:
    """The self-ring kernel on a one-rank ring whose peer is the card
    itself: (outer, chunk, inner) u8 -> (outer, 2*chunk, inner), slot 0 by
    a local store and slot 1 through the peer-pointer path, behind the
    barrier signalled twice and waited for 2.  Waits for the card and
    raises ``SimdDctError`` if a spin timed out.  A CPU tensor takes the
    plain version."""
    if local.dtype != torch.uint8 or local.ndim != 3:
        raise InvalidParameterError(
            f"expected an (outer, chunk, inner) u8 segment, got "
            f"{tuple(local.shape)} {local.dtype}")
    if local.device.type == "cpu":
        return selfring_plain(local)
    with _workspace_lock:
        mesh = _self_meshes.setdefault(local.device,
                                       Mesh([local.device], ("strip",)))
    src = _gather_view(local, 1)
    outer, chunk, inner = src.shape
    row = chunk * inner
    out = torch.empty((outer, 2 * chunk, inner), dtype=torch.uint8,
                      device=local.device)
    vec = row % 16 == 0
    lib = _build.load()
    ws = _workspace(mesh, lib)
    with ws.lock:
        fit = _ctas_fit(*ws.capacity_of(lib, local.device, vec), 1)
        plan = ws.last_plan = _plan(outer, row, fit, 1)
        ws.gen = (ws.gen + 1) & _U32
        ws.arr[0] = plan.target(ws.arr[0])
        slots = [ws.bar_ptr(0, 0), ws.bar_ptr(0, 1)]
        desc = _desc(src.data_ptr(), ws.arr_ptr(0), ws.gen, ws.arr[0],
                     [out.data_ptr(), out.data_ptr() + row],
                     [0, ws.arr_ptr(0)], slots, slots)
        words = np.asarray(desc, np.int64)
        with _cuda._on_device_of(local):
            rc = lib.sdct_selfring(words.ctypes.data, plan.blocks, outer, row,
                                   2 * row, int(vec), plan.tile, plan.stages,
                                   ws.err_ptr(local.device),
                                   int(timeout_s * 1e9),
                                   _stream(local.device).cuda_stream)
            _cuda.LAUNCHES["selfring"] += 1
    _build.check(lib, rc, "selfring")
    check_workspace(mesh)
    return out


def remote_dma_selfring_smoke(device=None) -> bool:
    """One-card preflight of the gather kernel's machinery: the barrier,
    the local copy and one store through the peer-pointer path, on a ring
    of one whose peer is the card itself (``selfring``), at the
    reference's (8, 16, 128) u8 shape.  True when the bytes are exact;
    raises on a build or launch failure or a timed-out spin.  ``device``:
    the card by default; ``"cpu"`` runs the plain version."""
    dev = default_device(device)
    rng = np.random.default_rng(0)
    seg = rng.integers(0, 256, (8, 16, 128), np.uint8)
    local = np.ascontiguousarray(seg[:, :8, :])
    got = selfring(torch.from_numpy(local).to(dev)).cpu().numpy()
    return bool(np.array_equal(got, np.concatenate([local] * 2, axis=1)))
