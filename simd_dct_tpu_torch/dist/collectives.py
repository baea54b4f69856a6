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
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..api import InvalidParameterError, NotSupportedError, SimdDctError
from ..dispatch.capability import default_device
from ..kernels import _build
from ..kernels import cuda_dct as _cuda
from .mesh import DATA_AXIS, Mesh, Sharded, shard

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
    """Every rank joins the ring's segments in order: one ``torch.cat``."""
    seg = _segments(segments, mesh, axis_name)
    a = mesh.axis(axis_name)
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
    ``check_workspace``."""
    seg = _segments(segments, mesh, axis_name)
    a = mesh.axis(axis_name)
    if mesh.devices.shape[a] == 1:
        return _replicated_along(seg, a, seg.shards)
    if mesh.device_type == "cpu":
        return gather_planes_ring(seg, mesh, axis_name=axis_name)
    return _replicated_along(seg, a,
                             _gather_on_cards(seg, a, timeout_s=timeout_s))


def gather_planes_auto(segments, mesh: Mesh, *,
                       axis_name: str = DATA_AXIS) -> Sharded:
    """What ``gather=True`` uses: ``gather_planes_remote``."""
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
    the workspace is dropped and the next gather allocates a new one."""
    ws = mesh._collective_workspace
    if ws is not None:
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
