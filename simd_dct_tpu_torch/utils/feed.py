"""Host -> card frame pipelining (counterpart of
``simd_dct_tpu/utils/feed.py``; SURVEY.md §5: host <-> device overlap by
asynchronous dispatch and double-buffered input feeding).

The reference streams frames through a malloc'd buffer on one thread
(src/main.cpp:137-177,510-530).  Here the card stays busy while the host
prepares the next frames.  On the card each frame goes through three
streams:

* **upload**: the frame is copied from its NumPy or pageable source into
  a ring of page-locked buffers, one per frame in flight and one for the
  frame being returned (sized by the first frame, reallocated when the
  shape changes), then sent to the card with ``non_blocking=True`` on an
  upload stream; an event follows the copy.  A ring slot is refilled only
  after the event of the copy that last read it has completed.  The ring
  is filled by torch's ``copy_``, which splits a frame over torch's
  OpenMP threads.  The streams that run the host coder fill it instead by
  ``np.copyto`` on a thread of their own, in the background while the
  coder packs an earlier frame: OpenMP's threads spin on after a copy and
  take the cores the coder packs on, and the coder's pack is the host
  time a frame, so the copy runs beside it.
* **compute**: the caller's current stream waits on that event (a wait on
  the card, never on the host) and runs ``fn``; the device input is
  released to the allocator only after the compute stream's work on it.
* **download** (the stream functions): the results come back into
  page-locked host memory by ``non_blocking`` copies on a download stream
  after the compute event.  Uploads and downloads take separate streams:
  on one stream the next frame's upload would queue behind a download
  that waits for the compute.

``depth`` counts the frames truly in flight: when frame k is returned,
frames k+1 .. k+depth have been fetched, and their transfers and
dispatches queued, so with ``depth=1`` the transfer and dispatch of frame
k+1 overlap the return of frame k.  Where the ring fills in the
background, frame k+depth may still be in its staging copy when frame k
is returned (frame k+1 never is); a frame's copy ends before the next
frame is pulled, since a source may refill the buffer it gave.  (The JAX package's ``stream_decode32_compressed`` keeps
``len(pending) < depth`` after each yield, which makes ``depth=1`` fully
synchronous: feed.py:163.)  Results come back in order, each once its own
completion event has fired.

On the CPU (``device="cpu"``) the same generator runs the plain version:
no stream and no page-locked memory.  With no ``device`` the pipeline runs
on the card, and raises ``NotSupportedError`` on a machine without one.
"""

from __future__ import annotations

import functools
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from ..dispatch.capability import default_device


def _each(out, f):
    """``f`` over a result's tensors (a tensor, or a tuple of them)."""
    if isinstance(out, tuple):
        return tuple(f(t) for t in out)
    return f(out)


def _host_array(item) -> np.ndarray:
    if isinstance(item, torch.Tensor):
        if item.device.type != "cpu":
            raise ValueError(f"a host frame was expected, got a tensor on "
                             f"{item.device}")
        return item.numpy()
    return np.asarray(item)


@functools.lru_cache(maxsize=None)
def _staging_worker() -> ThreadPoolExecutor:
    """The thread that fills the ring in the background for the host
    coder's streams, made at first use and shared by every feed of the
    process."""
    return ThreadPoolExecutor(1, thread_name_prefix="feed-staging")


class _Staging:
    """The ring of page-locked upload buffers: one per frame in flight and
    one for the frame being returned.  Filled by torch's copy, or, given
    ``worker``, by ``np.copyto`` on that thread (NumPy lets go of the GIL
    for a large copy)."""

    def __init__(self, slots: int, worker: ThreadPoolExecutor | None = None):
        self._slots = slots
        self._worker = worker
        self._key = None
        self._bufs: list[torch.Tensor] = []
        self._views: list[np.ndarray] = []
        self._read: list = []
        self._next = 0

    def fill(self, arr: np.ndarray):
        """Copy ``arr`` into the next slot, once the upload that last read
        that slot has completed; returns the slot's buffer, its index and
        the future of a background copy (None once the copy is done)."""
        key = (arr.shape, arr.dtype)
        if key != self._key:
            # a dropped buffer returns to torch's page-locked cache only
            # after the copies recorded on it have completed
            dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
            self._bufs = [torch.empty(arr.shape, dtype=dtype,
                                      pin_memory=True)
                          for _ in range(self._slots)]
            self._views = [b.numpy() for b in self._bufs]
            self._read = [None] * self._slots
            self._key, self._next = key, 0
        s = self._next
        self._next = (s + 1) % self._slots
        if self._read[s] is not None:
            self._read[s].synchronize()
        if self._worker is not None:
            return self._bufs[s], s, self._worker.submit(
                np.copyto, self._views[s], arr)
        if arr.flags.writeable and arr.flags.c_contiguous:
            # torch's copy splits a large frame over the host threads
            self._bufs[s].copy_(torch.from_numpy(arr))
        else:
            np.copyto(self._views[s], arr)
        return self._bufs[s], s, None

    def read_by(self, slot: int, event) -> None:
        self._read[slot] = event


class _CardStages:
    """Upload, compute and download streams of one card.  An entry is
    ``[staging, issued]``: ``staging`` holds (future, buffer, slot) while
    a background staging copy runs, ``issued`` the (result, completion
    event) pair once the frame's upload, compute and download are
    queued."""

    def __init__(self, fn, device: torch.device, depth: int, put, to_host,
                 host_coder: bool):
        self._fn, self._dev, self._put = fn, device, put
        self._compute = torch.cuda.current_stream(device)
        self._up = torch.cuda.Stream(device)
        self._down = torch.cuda.Stream(device) if to_host else None
        self._staging = _Staging(
            depth + 1, _staging_worker() if host_coder else None)

    def _event(self, stream) -> torch.cuda.Event:
        ev = torch.cuda.Event()
        ev.record(stream)
        return ev

    def start(self, item):
        if isinstance(item, torch.Tensor) and item.device.type == "cuda":
            return [None, self._launch(item)]      # already on the card
        if self._put is not None:
            with torch.cuda.stream(self._up):
                x = self._put(item)
                ready = self._event(self._up)
            return [None, self._launch(x, ready)]
        buf, slot, copying = self._staging.fill(_host_array(item))
        if copying is not None:
            return [(copying, buf, slot), None]
        return [None, self._send(buf, slot)]

    def issue(self, entry) -> None:
        """Queue the frame's upload, compute and download, once its
        staging copy has ended."""
        if entry[1] is None:
            copying, buf, slot = entry[0]
            copying.result()
            entry[0], entry[1] = None, self._send(buf, slot)

    def _send(self, buf, slot):
        with torch.cuda.stream(self._up):
            x = torch.empty(buf.shape, dtype=buf.dtype, device=self._dev)
            x.copy_(buf, non_blocking=True)
            ready = self._event(self._up)
        self._staging.read_by(slot, ready)
        return self._launch(x, ready)

    def _launch(self, x, ready=None):
        if ready is not None:
            self._compute.wait_event(ready)
            x.record_stream(self._compute)
        with torch.cuda.stream(self._compute):
            out = self._fn(x)
        if self._down is None:
            return out, self._event(self._compute)
        self._down.wait_event(self._event(self._compute))
        with torch.cuda.stream(self._down):
            host = _each(out, lambda t: torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True).copy_(
                    t, non_blocking=True))
        _each(out, lambda t: t.record_stream(self._down))
        return host, self._event(self._down)

    def finish(self, entry):
        self.issue(entry)
        out, done = entry[1]
        done.synchronize()
        if self._down is None:
            return out
        return _each(out, lambda t: t.numpy())


class _HostStages:
    """The plain version: each stage runs at once, on the CPU."""

    def __init__(self, fn, put, to_host):
        self._fn, self._put, self._to_host = fn, put, to_host

    def start(self, item):
        if self._put is not None:
            x = self._put(item)
        else:
            arr = _host_array(item)
            # torch warns on read-only buffers
            x = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        out = self._fn(x)
        return _each(out, lambda t: t.numpy()) if self._to_host else out

    def issue(self, entry) -> None:
        pass

    def finish(self, entry):
        return entry


def _pipeline(items: Iterable[Any], stages, depth: int) -> Iterator[Any]:
    inflight: deque = deque()
    it = iter(items)
    exhausted = False
    while True:
        # fetch and dispatch until ``depth`` frames are in flight beyond
        # the one returned next
        while not exhausted and len(inflight) <= depth:
            if inflight:
                # a source may refill the buffer it gave: the newest
                # frame's staging copy ends before the next pull
                stages.issue(inflight[-1])
            try:
                item = next(it)
            except StopIteration:
                exhausted = True
                break
            inflight.append(stages.start(item))
        if not inflight:
            return
        # the next frame is queued on the card before this one is returned
        for entry in islice(inflight, 2):
            stages.issue(entry)
        yield stages.finish(inflight.popleft())


def _feed(items, fn, *, depth: int, device, put=None,
          to_host: bool = False, host_coder: bool = False) -> Iterator[Any]:
    """``host_coder``: the caller packs each result on the host, so the
    ring is filled in the background (see the module's docstring)."""
    if depth < 1:
        raise ValueError("depth must be >= 1")
    dev = default_device(device)
    if dev.type == "cuda":
        stages = _CardStages(fn, dev, depth, put, to_host, host_coder)
    else:
        stages = _HostStages(fn, put, to_host)
    return _pipeline(items, stages, depth)


class FrameFeeder:
    """Pipelined frame feed: ``depth`` frames in flight.

    ``fn`` is a computation applied to each frame once it lies on
    ``device`` (the card unless the call names another).  ``map`` yields
    the results in order, as tensors on that device; while one is
    returned, the transfers and dispatches of the next ``depth`` frames
    are already queued, so the card never waits on the host and the host
    never holds more than ``depth + 1`` frames."""

    def __init__(self, fn: Callable[[Any], Any], *, depth: int = 2,
                 device=None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._fn = fn
        self._depth = depth
        self._device = default_device(device)

    def map(self, frames: Iterable[Any]) -> Iterator[Any]:
        """Apply ``fn`` over ``frames`` with pipelined transfers: the same
        results as ``(fn(f) for f in frames)``."""
        return _feed(frames, self._fn, depth=self._depth,
                     device=self._device)


def stream_roundtrip32(frames: Iterable[Any], lut, *, depth: int = 2,
                       device=None) -> Iterator[np.ndarray]:
    """Pipelined fused mode32 round trips over a frame stream (the BASELINE
    config-4 video workload as a streaming API); yields host arrays."""
    from .. import api

    return _feed(frames, lambda fr: api.roundtrip_quantize32(fr, lut),
                 depth=depth, device=device, to_host=True)


def stream_encode32_compressed(frames: Iterable[Any], lut, *,
                               depth: int = 2, device=None,
                               shared_table: bool = True,
                               sparse: bool = False) -> Iterator[np.ndarray]:
    """Pipelined full codec: the mode32 encode and the 256-bin histogram of
    each frame on the card, overlapped with the host Huffman pack of the
    frames before it.  Records and counts come back by the download
    stream; the encode of frame k+1 is queued before the pack of frame k
    starts.

    ``shared_table=True`` builds the code table from the first frame's
    histogram and reuses it (stationary video statistics); a frame with a
    symbol absent from the shared table rebuilds from its own histogram.
    Its histogram shows that before the pack, so no pack is thrown away
    (the JAX package packs, fails and packs again: the same bytes).

    ``sparse=True`` compacts each frame's records on the card
    (``entropy.compress_sparse``, SDS1) before the host packs the kept
    blocks; ``shared_table`` does not apply there.  Every stream decodes
    by ``entropy.decompress``."""
    from .. import api, entropy

    dev = default_device(device)
    if sparse:
        # the compaction runs on a stream of its own, so its count's read
        # back does not wait for the encodes queued behind this frame
        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        for rec in _feed(frames, lambda fr: api.encode_quantize32(fr, lut),
                         depth=depth, device=dev, host_coder=True):
            if side is None:
                blob = entropy.compress_sparse(rec)
            else:
                rec.record_stream(side)     # complete: its event has fired
                with torch.cuda.stream(side):
                    blob = entropy.compress_sparse(rec)
            yield blob
        return

    def on_card(fr):
        rec = api.encode_quantize32(fr, lut)
        return rec, entropy.histogram_tensor(rec)

    lengths = None
    for rec, hist in _feed(frames, on_card, depth=depth, device=dev,
                           to_host=True, host_coder=True):
        hist = hist.astype(np.uint64)
        if (lengths is None or not shared_table
                or hist[lengths == 0].any()):
            lengths = entropy.build_lengths(hist)
        yield entropy.compress(rec, lengths)


def stream_decode32_compressed(blobs: Iterable[Any], lut, size_x: int,
                               size_y: int, *, depth: int = 2,
                               backend: str | None = None,
                               device=None) -> Iterator[np.ndarray]:
    """Pipelined inverse of ``stream_encode32_compressed``: the host unpack
    of blob k+1 and its upload (``entropy.decompress_to_device`` on the
    upload stream: SDN1 / SDS1 streams send only their parts and expand on
    the card) overlap the mode32 decode of blob k; yields host arrays.
    Accepts every stream ``entropy.decompress`` reads."""
    from .. import api, entropy

    dev = default_device(device)
    return _feed(blobs, lambda rec: api.decode_quantize32(
        rec, lut, size_x, size_y, backend=backend), depth=depth, device=dev,
        put=lambda blob: entropy.decompress_on(blob, dev), to_host=True)
