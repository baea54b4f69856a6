"""Device meshes and sharded values.

Counterpart of ``simd_dct_tpu/dist/mesh.py``.  The reference splits the
strip axis of an image over the chips of a ``jax.sharding.Mesh`` (the
TPU analog of the CPU reference's ``startY``/``endY`` row ranges,
src/simd_dct.h:29-31).  Here a ``Mesh`` is an n-d array of
``torch.device``s with axis names, and a ``Sharded`` value -- one tensor
per mesh position -- takes the place of a sharded ``jax.Array``.

A mesh is either all CPU devices (the plain version; the tests) or all
CUDA cards (the kernels).  ``make_mesh(n)`` takes the cards ``cuda:0..``
and raises when there are fewer than ``n``: it never falls back to the CPU.
Shards share a card only when asked: ``make_mesh(4, devices=["cuda:0"] *
4)`` is four shards on one card, ``devices=["cpu"] * 4`` four on the host.

Across processes (after ``initialize_distributed``, as with
``jax.distributed``), a mesh's positions are the world's ranks, one rank
a process: ``make_mesh(n)`` with n the world size puts rank r on
``cuda:{LOCAL_RANK}`` (raising when this rank has no such card), or on
``devices[r]`` where the call names each rank's device (two ranks share
a card only so: ``devices=["cuda:0"] * 2``; ``["cpu"] * 2`` for a CPU
cluster).  Building it is collective: every rank calls it, in the same
order, and the ranks exchange their devices through the process group's
key-value store.  ``Mesh.ranks`` holds each position's
rank and ``Mesh.is_local(k)`` says whether it is this process's.  A
``Sharded`` value then holds this process's shards only
(``addressable_shards``); ``full()`` of a value split across processes
raises, as ``numpy.asarray`` of a jax.Array that is not fully addressable
does, while a replicated value's ``full()`` is the local replica.
``shard`` / ``strip_sharding`` of a whole host array take only this
process's pieces, as ``jax.make_array_from_callback`` does.  A mesh within
one process behaves as it did.
"""

from __future__ import annotations

import dataclasses
import datetime
import itertools
import os
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..api import InvalidParameterError, NotSupportedError, SimdDctError


DATA_AXIS = "data"
# the key-value store of the process group that initialize_distributed
# set up (None: the default group's, if any)
_STORE = None
# meshes across processes built by this process: every rank builds them
# in the same order, so the count names a mesh's keys in the store
_MESH_SEQ = itertools.count()
_mesh_seq_lock = threading.Lock()
# how long building a mesh across processes waits for every rank
MESH_TIMEOUT_S = 120.0


def _device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    return dev


class Mesh:
    """An n-d array of devices with one name per axis (the part of
    ``jax.sharding.Mesh`` the sharded functions use: ``devices``,
    ``axis_names``, ``shape[axis]``, ``size``).  Every device is a CPU or
    every device is a card; a mix raises.  A device may repeat: each
    position is a shard of its own.

    ``ranks`` (same shape) holds the process of each position; by default
    every position is this process's.  Across processes ``devices[k]`` is
    the device as rank ``ranks[k]`` names it, ``rank`` this process's rank
    and ``key`` the mesh's prefix in the store."""

    def __init__(self, devices, axis_names, *, ranks=None, rank: int = 0,
                 key: str | None = None):
        arr = np.asarray(devices, dtype=object)
        names = (axis_names,) if isinstance(axis_names, str) else \
            tuple(axis_names)
        if arr.ndim != len(names):
            raise InvalidParameterError(
                f"{arr.ndim}-d devices need {arr.ndim} axis names, got "
                f"{names}")
        if len(set(names)) != len(names):
            raise InvalidParameterError(f"axis names repeat: {names}")
        if arr.size == 0:
            raise InvalidParameterError("a mesh needs at least one device")
        devs = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            devs[idx] = _device(arr[idx])
        kinds = {d.type for d in devs.flat}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise InvalidParameterError(
                f"a mesh is all CPU or all CUDA devices, got {sorted(kinds)}")
        self.devices = devs
        self.axis_names = names
        self.ranks = (np.full(arr.shape, rank, dtype=np.int64)
                      if ranks is None
                      else np.asarray(ranks, np.int64).reshape(arr.shape))
        self.rank = int(rank)
        self.key = key
        self.local_positions = [k for k in range(devs.size)
                                if self.ranks.flat[k] == self.rank]
        self._collective_workspace = None

    @property
    def process_count(self) -> int:
        return len(set(self.ranks.flat))

    def is_local(self, k: int) -> bool:
        """Whether flat position ``k`` is this process's."""
        return int(self.ranks.flat[k]) == self.rank

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise InvalidParameterError(
                f"mesh has axes {self.axis_names}, not {name!r}")
        return self.axis_names.index(name)

    def __repr__(self) -> str:
        procs = ("" if self.process_count == 1 else
                 f", ranks {self.ranks.reshape(-1).tolist()}")
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]}{procs})")


def _devices_for(need: int | None, devices) -> list[torch.device]:
    """The first ``need`` of ``devices`` (all of them when ``need`` is
    None), by default the cards; a ValueError when there are fewer (never
    a fallback to the CPU)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = [_device(d) for d in devices]
    if need is None:
        return devs
    if len(devs) < need:
        raise ValueError(
            f"need {need} devices, have {len(devs)}"
            + ("" if devices is not None else
               f" (CUDA cards); for virtual shards pass devices=, e.g. "
               f"devices=['cuda:0'] * {need} or devices=['cpu'] * {need}"))
    return devs[:need]


def _world() -> tuple[int, int] | None:
    """(rank, world size) of the initialized process group, or None."""
    import torch.distributed as tdist
    if not (tdist.is_available() and tdist.is_initialized()):
        return None
    return tdist.get_rank(), tdist.get_world_size()


def store():
    """The process group's key-value store (``initialize_distributed``'s,
    or the default group's)."""
    if _STORE is not None:
        return _STORE
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()


def _my_device(rank: int, need: int, devices) -> torch.device:
    """This rank's device in a mesh across processes: ``devices[rank]``, or
    ``cuda:{LOCAL_RANK}``, which must exist."""
    if devices is not None:
        devs = [_device(d) for d in devices]
        if len(devs) < need:
            raise ValueError(
                f"devices= names {len(devs)} devices; a mesh across "
                f"processes needs one for each of the {need} ranks")
        return devs[rank]
    local = int(os.environ.get("LOCAL_RANK", rank))
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= count:
        raise ValueError(
            f"rank {rank} (local rank {local}) has no card: this machine "
            f"has {count} CUDA cards; name each rank's device with devices=, "
            f"e.g. devices=['cuda:0'] * {need} or devices=['cpu'] * {need}")
    return torch.device("cuda", local)


def _world_mesh(shape: tuple, axis_names, devices) -> Mesh:
    """A mesh whose positions are the world's ranks (collective: the ranks
    exchange their devices through the store)."""
    rank, world = _world()
    need = int(np.prod(shape))
    if need != world:
        raise ValueError(
            f"a mesh across processes has one position a rank: {need} "
            f"positions for a world of {world}")
    mine = _my_device(rank, need, devices)
    with _mesh_seq_lock:
        key = f"sdct/mesh{next(_MESH_SEQ)}"
    kv = store()
    keys = [f"{key}/dev/{r}" for r in range(world)]
    try:
        kv.set(keys[rank], str(mine).encode())
        kv.wait(keys, datetime.timedelta(seconds=MESH_TIMEOUT_S))
        got = kv.multi_get(keys)
    except RuntimeError as e:    # a timeout, or the store's host is gone
        raise SimdDctError(
            f"building a mesh across processes: not every rank joined "
            f"within {MESH_TIMEOUT_S} s, or the store failed ({e})") from None
    devs = np.empty(need, dtype=object)
    devs[:] = [torch.device(d.decode()) for d in got]
    return Mesh(devs.reshape(shape), axis_names,
                ranks=np.arange(world).reshape(shape), rank=rank, key=key)


def make_mesh(num_devices: int | None = None, axis_name: str = DATA_AXIS,
              devices=None) -> Mesh:
    """1-D mesh over the first ``num_devices`` of ``devices`` (default: the
    CUDA cards; all of them when ``num_devices`` is None).  Across
    processes (an initialized process group of more than one rank) the
    positions are the ranks, ``num_devices`` (default: the world size)
    must be the world size, and ``devices`` names each rank's device."""
    world = _world()
    if world is not None and world[1] > 1:
        return _world_mesh((num_devices or world[1],), (axis_name,), devices)
    if num_devices is None:
        num_devices = len(_devices_for(None, devices)) or 1
    return Mesh(_devices_for(num_devices, devices), (axis_name,),
                rank=0 if world is None else world[0])


def make_mesh_2d(shape: tuple[int, int],
                 axis_names: tuple[str, str] = ("host", "chip"),
                 devices=None) -> Mesh:
    """(host, chip) mesh: shard frames over the first axis and strips over
    the second.  Devices as for ``make_mesh``; across processes the ranks
    fill it in row-major order."""
    world = _world()
    if world is not None and world[1] > 1:
        return _world_mesh(tuple(shape), axis_names, devices)
    need = shape[0] * shape[1]
    devs = np.empty(need, dtype=object)
    devs[:] = _devices_for(need, devices)
    return Mesh(devs.reshape(shape), axis_names,
                rank=0 if world is None else world[0])


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           **kwargs) -> bool:
    """Multi-process bootstrap: ``torch.distributed.init_process_group``
    with the standard environment (``MASTER_ADDR`` / ``MASTER_PORT`` /
    ``RANK`` / ``WORLD_SIZE``) or an explicit ``host:port`` address.

    True if a process group is (now) initialized; False, with nothing
    changed, in a plain single-process run (no address, no process count
    and no ``MASTER_ADDR``), so it is safe to call unconditionally.
    Idempotent.  The backend is ``gloo``, card or not, unless ``backend=``
    says: the group carries the handle exchange, host barriers and the CPU
    plain version, while the bytes on the cards move by the package's own
    gather kernel (and NCCL refuses two ranks on one card).  Rank 0 hosts
    the group's key-value store (a ``TCPStore`` at the address), which the
    gather across processes uses for its rendezvous."""
    global _STORE
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return True
    has_config = (coordinator_address is not None
                  or num_processes is not None
                  or "MASTER_ADDR" in os.environ)
    if not has_config:
        return False
    backend = kwargs.pop("backend", None) or "gloo"
    if coordinator_address:
        host, _, port = coordinator_address.rpartition(":")
    else:
        host = os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = os.environ.get("MASTER_PORT", "29500")
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    timeout = kwargs.get("timeout", datetime.timedelta(seconds=300))
    kv = tdist.TCPStore(host, int(port), world, rank == 0, timeout=timeout)
    tdist.init_process_group(backend, store=kv, world_size=world,
                             rank=rank, **kwargs)
    _STORE = kv
    return True


class Shard(NamedTuple):
    """One addressable piece of a ``Sharded`` value (the part of a
    jax.Array's ``Shard`` the tests read)."""
    position: int           # flat mesh position
    device: torch.device
    data: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A value split over a mesh: ``shards[i]`` lies on the device of this
    process's i-th position, ``mesh.local_positions[i]`` (every position
    within one process).  ``dims[a]`` is the tensor dim that mesh axis
    ``a`` splits, or None where the value is replicated along that axis.
    ``shape``, when given, is the value's logical shape: the assembled
    tensor reshaped (a decode that returns (H, W) from (2, H/2, W) views
    sharded on rows)."""

    shards: tuple
    mesh: Mesh
    dims: tuple
    shape: tuple | None = None

    def __post_init__(self):
        if len(self.shards) != len(self.mesh.local_positions):
            raise InvalidParameterError(
                f"{len(self.shards)} shards for "
                f"{len(self.mesh.local_positions)} positions of the mesh "
                "in this process")
        if len(self.dims) != len(self.mesh.axis_names):
            raise InvalidParameterError(
                f"dims {self.dims} do not match the mesh axes "
                f"{self.mesh.axis_names}")

    @property
    def spec(self) -> tuple:
        """The axis name each tensor dim is split over, or None (the
        layout's ``PartitionSpec``)."""
        spec = [None] * self.shards[0].ndim
        for name, d in zip(self.mesh.axis_names, self.dims):
            if d is not None:
                spec[d] = name
        return tuple(spec)

    @property
    def is_fully_replicated(self) -> bool:
        return all(d is None for d in self.dims)

    @property
    def addressable_shards(self) -> list[Shard]:
        """This process's shards, with their positions and devices."""
        return [Shard(k, self.mesh.devices.flat[k], t)
                for k, t in zip(self.mesh.local_positions, self.shards)]

    def full(self, device=None) -> torch.Tensor:
        """The whole value on ``device`` (default: the first shard's):
        shards joined along each split axis, one replica of each
        replicated one.  A value split across processes raises
        ``NotSupportedError`` (this process holds only its pieces); a
        replicated one gives the local replica."""
        dev = self.shards[0].device if device is None else _device(device)
        if self.mesh.process_count > 1:
            if not self.is_fully_replicated:
                raise NotSupportedError(
                    "the value is split across processes: this process "
                    "holds only its addressable_shards (gather it first, "
                    "e.g. gather=True)")
            out = self.shards[0].to(dev)
            return out if self.shape is None else out.reshape(self.shape)
        grid = self.mesh.devices.shape

        def join(axis: int, idx: tuple) -> torch.Tensor:
            if axis == len(grid):
                k = int(np.ravel_multi_index(idx, grid))
                return self.shards[k].to(dev)
            if self.dims[axis] is None:
                return join(axis + 1, idx + (0,))
            return torch.cat([join(axis + 1, idx + (i,))
                              for i in range(grid[axis])],
                             dim=self.dims[axis])

        out = join(0, ())
        return out if self.shape is None else out.reshape(self.shape)


def shard(x, mesh: Mesh, dims: dict[str, int]) -> Sharded:
    """Split ``x`` (a tensor, or anything ``numpy.asarray`` takes) over
    ``mesh``: along tensor dim ``dims[a]`` for each mesh axis ``a`` named
    there, replicated along the others; each piece on its position's
    device, and only this process's pieces.  A piece on the device ``x``
    already lies on is a view (its leading axes may be strided).  Each
    split dim must divide evenly."""
    if isinstance(x, Sharded):
        x = x.full()
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(x)))
    per_axis = tuple(dims.get(name) for name in mesh.axis_names)
    unknown = set(dims) - set(mesh.axis_names)
    if unknown:
        raise InvalidParameterError(
            f"mesh has axes {mesh.axis_names}, not {sorted(unknown)}")
    grid = mesh.devices.shape
    for a, d in enumerate(per_axis):
        if d is not None and t.shape[d] % grid[a]:
            raise ValueError(
                f"dim {d} of shape {tuple(t.shape)} does not divide over the "
                f"{grid[a]} shards of mesh axis {mesh.axis_names[a]!r}")
    shards = []
    for k in mesh.local_positions:
        idx = tuple(int(i) for i in np.unravel_index(k, grid))
        piece = t
        for a, d in enumerate(per_axis):
            if d is not None:
                size = t.shape[d] // grid[a]
                piece = piece.narrow(d, idx[a] * size, size)
        shards.append(piece.to(mesh.devices[idx]))
    return Sharded(tuple(shards), mesh, per_axis)


def strip_sharding(x, mesh: Mesh, axis_name: str = DATA_AXIS,
                   dim: int = 0) -> Sharded:
    """``x`` split along ``dim`` (the rows of a (H, W) image) over mesh axis
    ``axis_name``, replicated along any other axis."""
    mesh.axis(axis_name)
    return shard(x, mesh, {axis_name: dim})


def replicated(x, mesh: Mesh) -> Sharded:
    """A copy of ``x`` on every mesh position."""
    return shard(x, mesh, {})
