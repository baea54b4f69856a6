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
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from ..api import InvalidParameterError


DATA_AXIS = "data"


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
    position is a shard of its own."""

    def __init__(self, devices, axis_names):
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
        self._collective_workspace = None

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
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.flat]})")


def _devices_for(need: int, devices) -> list[torch.device]:
    """The first ``need`` of ``devices``, by default the cards; a
    ValueError when there are fewer (never a fallback to the CPU)."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devs = [torch.device("cuda", i) for i in range(count)]
    else:
        devs = [_device(d) for d in devices]
    if len(devs) < need:
        raise ValueError(
            f"need {need} devices, have {len(devs)}"
            + ("" if devices is not None else
               f" (CUDA cards); for virtual shards pass devices=, e.g. "
               f"devices=['cuda:0'] * {need} or devices=['cpu'] * {need}"))
    return devs[:need]


def make_mesh(num_devices: int | None = None, axis_name: str = DATA_AXIS,
              devices=None) -> Mesh:
    """1-D mesh over the first ``num_devices`` of ``devices`` (default: the
    CUDA cards; all of them when ``num_devices`` is None)."""
    if num_devices is None:
        num_devices = len(_devices_for(0, devices)) or 1
    return Mesh(_devices_for(num_devices, devices), (axis_name,))


def make_mesh_2d(shape: tuple[int, int],
                 axis_names: tuple[str, str] = ("host", "chip"),
                 devices=None) -> Mesh:
    """(host, chip) mesh: shard frames over the first axis and strips over
    the second.  Devices as for ``make_mesh``."""
    need = shape[0] * shape[1]
    devs = np.empty(need, dtype=object)
    devs[:] = _devices_for(need, devices)
    return Mesh(devs.reshape(shape), axis_names)


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
    Idempotent.  The backend is ``nccl`` where a card is present and
    ``gloo`` otherwise, unless ``backend=`` says."""
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return True
    has_config = (coordinator_address is not None
                  or num_processes is not None
                  or "MASTER_ADDR" in os.environ)
    if not has_config:
        return False
    backend = kwargs.pop("backend", None) or (
        "nccl" if torch.cuda.is_available() else "gloo")
    init = (f"tcp://{coordinator_address}" if coordinator_address
            else "env://")
    world = (num_processes if num_processes is not None
             else int(os.environ.get("WORLD_SIZE", "1")))
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    tdist.init_process_group(backend, init_method=init, world_size=world,
                             rank=rank, **kwargs)
    return True


@dataclasses.dataclass(frozen=True)
class Sharded:
    """A value split over a mesh: ``shards[k]`` lies on
    ``mesh.devices.flat[k]``.  ``dims[a]`` is the tensor dim that mesh axis
    ``a`` splits, or None where the value is replicated along that axis.
    ``shape``, when given, is the value's logical shape: the assembled
    tensor reshaped (a decode that returns (H, W) from (2, H/2, W) views
    sharded on rows)."""

    shards: tuple
    mesh: Mesh
    dims: tuple
    shape: tuple | None = None

    def __post_init__(self):
        if len(self.shards) != self.mesh.size:
            raise InvalidParameterError(
                f"{len(self.shards)} shards for a mesh of {self.mesh.size}")
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

    def full(self, device=None) -> torch.Tensor:
        """The whole value on ``device`` (default: the first shard's):
        shards joined along each split axis, one replica of each
        replicated one."""
        dev = self.shards[0].device if device is None else _device(device)
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
    device.  A piece on the device ``x`` already lies on is a view (its
    leading axes may be strided).  Each split dim must divide evenly."""
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
    for idx in np.ndindex(grid):
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
