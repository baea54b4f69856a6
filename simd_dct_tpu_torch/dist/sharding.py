"""Sharded encode/decode: strip-axis and frame-axis parallelism.

Counterpart of ``simd_dct_tpu/dist/sharding.py``, with the same names,
arguments and checks.  8x8 blocks never cross a 16-image-row boundary (8
rows in each of the two stacked views), so splitting the strip axis needs
no halo exchange: each shard runs the single-card kernel on its own rows.
The only data that crosses devices is the stereo planes' all-gather
(``gather=True``, ``dist/collectives.py``).  Frame-axis (video)
parallelism splits a leading batch axis; on a (host, chip) mesh frames
split over one axis and strips over the other.

Each function takes a whole tensor (or anything ``numpy.asarray`` takes),
which it splits over the mesh's devices, or, for the decoders, the
encoders' ``Sharded`` output as it comes; it returns a ``Sharded`` value
(``.full()`` joins it).  On a mesh across processes each process passes
the same whole value and computes its own positions only.  Each shard calls the kernel wrappers of
``kernels/cuda_dct.py`` on its own device's slice: the kernel on a card,
the plain version on the CPU.  Shards on one card run one after another
on its current stream, a launch each.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import InvalidParameterError, _kernel_ready
from ..core.quantize import lut_array
from ..kernels import cuda_dct as K
from ..layout.color420 import pack_records, unpack_records
from . import collectives as C
from .mesh import DATA_AXIS, Mesh, Sharded, shard


def _num_shards(mesh: Mesh, axis_name: str) -> int:
    return mesh.devices.shape[mesh.axis(axis_name)]


def _tensor(x) -> torch.Tensor:
    """A whole input as the kernels take it: contiguous and 16-byte
    aligned, so that every shard's row range is too (W % 64 == 0)."""
    if isinstance(x, Sharded):
        x = x.full()
    if isinstance(x, torch.Tensor):
        return _kernel_ready(x)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _as_sharded(x, mesh: Mesh, dims: dict[str, int]) -> Sharded:
    """``x`` split as ``dims`` says: a ``Sharded`` already so split as it
    is, anything else split (a replicated value from its local replicas)."""
    want = tuple(dims.get(name) for name in mesh.axis_names)
    if (isinstance(x, Sharded) and x.mesh is mesh and x.dims == want
            and x.shape is None):
        return x
    return shard(x, mesh, dims)


def _strips(x, mesh: Mesh, axis_name: str, dim: int) -> int:
    """Length of dim ``dim`` of the whole value ``x``."""
    if isinstance(x, Sharded):
        a = mesh.axis(axis_name)
        local = x.shards[0].shape[dim]
        return local * (x.mesh.devices.shape[a] if x.dims[a] == dim else 1)
    return _tensor(x).shape[dim]


def _map(fn, *parts: Sharded, dims: tuple | None = None,
         shape: tuple | None = None) -> Sharded:
    """``fn`` on the shards of each of this process's positions (every
    position within one process); the result split as ``dims`` (default:
    as the first input)."""
    mesh = parts[0].mesh
    out = tuple(fn(*local) for local in zip(*(p.shards for p in parts)))
    return Sharded(out, mesh, parts[0].dims if dims is None else dims, shape)


def _dims(mesh: Mesh, dims: dict[str, int]) -> tuple:
    return tuple(dims.get(name) for name in mesh.axis_names)


def _check_view_layout(view_layout: str) -> None:
    if view_layout not in ("interleaved", "native"):
        raise InvalidParameterError(
            f"sharded stereo supports view_layout 'interleaved' or "
            f"'native', got {view_layout!r}")


# ---------------------------------------------------------------------------
# strip-sharded single images
# ---------------------------------------------------------------------------

def encode_quantize32_sharded(img, lut, mesh: Mesh, *,
                              axis_name: str = DATA_AXIS,
                              rounding: str = "rne") -> Sharded:
    """Mode32 encode with the TOP view's strips sharded over the mesh.

    ``img`` is (H, W); each shard encodes H/2/n contiguous view rows.
    Returns records (S, 8W) split on the strip axis -- a purely local
    computation, no data crosses devices."""
    img = _tensor(img)
    h, w = img.shape
    n = _num_shards(mesh, axis_name)
    assert (h // 2) % (n * 8) == 0, "strips must divide evenly over shards"
    lut = lut_array(lut)
    parts = shard(img[: h // 2, :], mesh, {axis_name: 0})
    return _map(lambda local: K.encode32_view(
        local, lut, rounding).reshape(local.shape[0] // 8, -1),
        parts)


def decode_quantize32_sharded(records, lut, size_x: int, size_y: int,
                              mesh: Mesh, *,
                              axis_name: str = DATA_AXIS) -> Sharded:
    """Inverse: records (S, 8W) split on strips -> the (H/2, W) top view
    split on rows."""
    lut = lut_array(lut)
    parts = _as_sharded(records, mesh, {axis_name: 0})
    if parts.shards[0].shape[-1] != 8 * size_x:
        raise InvalidParameterError(
            f"a strip of records is 8*size_x = {8 * size_x} bytes, got "
            f"{parts.shards[0].shape[-1]}")
    return _map(lambda local: K.decode32_view(_kernel_ready(local), lut),
                parts)


def encode_quantize_stereo_sharded(img, lut, mesh: Mesh, *,
                                   axis_name: str = DATA_AXIS,
                                   rounding: str = "rne",
                                   gather: bool = False,
                                   view_layout: str = "interleaved"
                                   ) -> Sharded:
    """Stereo planar encode, strips sharded; both views stay on the shard
    that owns their strip range.

    ``view_layout='interleaved'`` returns plane segments shaped
    (64, S, W/4), split on the strip axis; flattening (plane, strip,
    segment byte) gives the reference byte stream.  ``'native'`` returns
    the (2, 64, S, BWP) tensor, split on its strip axis (dim 2), pad
    columns 127.  ``gather=True`` replicates the whole planes on every
    shard (the one collective of the dist path,
    ``collectives.gather_planes_auto``)."""
    _check_view_layout(view_layout)
    img = _tensor(img)
    h, w = img.shape
    n = _num_shards(mesh, axis_name)
    assert (h // 2) % (n * 8) == 0
    lut = lut_array(lut)
    native = view_layout == "native"
    parts = shard(img.reshape(2, h // 2, w), mesh, {axis_name: 1})

    def one(local_views):
        # this shard's strip range of BOTH views, a view stride apart
        s_local = local_views.shape[1] // 8
        out = K.encode_stereo_view(local_views, lut, rounding, view_layout)
        return out if native else out.reshape(64, s_local, w // 4)

    out = _map(one, parts, dims=_dims(mesh, {axis_name: 2 if native else 1}))
    if gather:
        out = C.gather_planes_auto(out, mesh, axis_name=axis_name)
    return out


def decode_quantize_stereo_sharded(planes, lut, size_x: int, size_y: int,
                                   mesh: Mesh, *,
                                   axis_name: str = DATA_AXIS,
                                   view_layout: str = "interleaved"
                                   ) -> Sharded:
    """Inverse: (64, S, W/4) plane segments split on strips -- or the
    (2, 64, S, BWP) native tensor for ``view_layout='native'`` -> the
    (H, W) image: its (2, H/2, W) views split on rows within each view
    (``.full()`` gives (H, W))."""
    _check_view_layout(view_layout)
    lut = lut_array(lut)
    w = size_x
    native = view_layout == "native"
    parts = _as_sharded(planes, mesh, {axis_name: 2 if native else 1})

    def one(local):
        s_local = local.shape[2 if native else 1]
        data = _kernel_ready(local)
        out = K.decode_quantize_stereo(data if native else data.reshape(-1),
                                       lut, w, s_local * 16, view_layout)
        return out.reshape(2, s_local * 8, w)

    return _map(one, parts, dims=_dims(mesh, {axis_name: 1}),
                shape=(size_y, size_x))


# ---------------------------------------------------------------------------
# frame-sharded batches (video workload, BASELINE config 4-5)
# ---------------------------------------------------------------------------

def encode_quantize32_batch(frames, lut, mesh: Mesh, *,
                            frame_axis: str = DATA_AXIS,
                            rounding: str = "rne") -> Sharded:
    """(B, H, W) u8 frames, B split over ``frame_axis`` -> (B, S, 8W)
    records; each shard encodes its frames in one launch.  On a 2-D mesh
    the other axis holds replicas (``encode_quantize32_batch_2d`` also
    splits the strips)."""
    frames = _tensor(frames)
    _, h, w = frames.shape
    lut = lut_array(lut)
    parts = shard(frames, mesh, {frame_axis: 0})
    return _map(lambda local: K.encode_quantize32(
        _kernel_ready(local), lut, 0, 1 << 30, rounding).reshape(
            local.shape[0], (h // 2) // 8, 8 * w), parts)


def encode_quantize32_batch_2d(frames, lut, mesh: Mesh, *,
                               frame_axis: str = "host",
                               strip_axis: str = "chip",
                               rounding: str = "rne") -> Sharded:
    """(B, H, W) frames over a 2-D (host, chip) mesh: frames split over
    ``frame_axis`` and each frame's top-view strips over ``strip_axis`` --
    the multi-host layout of BASELINE config 5.  Returns (B, S, 8W)
    records split on both axes; a shard's frames go in one launch."""
    frames = _tensor(frames)
    _, h, w = frames.shape
    n_s = _num_shards(mesh, strip_axis)
    assert (h // 2) % (n_s * 8) == 0
    lut = lut_array(lut)
    parts = shard(frames[:, : h // 2, :], mesh,
                  {frame_axis: 0, strip_axis: 1})
    return _map(lambda local: K.encode32_view(
        local, lut, rounding).reshape(
            local.shape[0], local.shape[1] // 8, 8 * w), parts)


def roundtrip_quantize32_batch(frames, lut, mesh: Mesh, *,
                               frame_axis: str = DATA_AXIS) -> Sharded:
    """Fused encode -> decode round trip per frame (BASELINE config 4:
    batched video): (B, H, W) -> (B, H/2, W), B split over the mesh."""
    frames = _tensor(frames)
    lut = lut_array(lut)
    parts = shard(frames, mesh, {frame_axis: 0})
    return _map(lambda local: K.roundtrip_quantize32(_kernel_ready(local),
                                                     lut), parts)


def encode_quantize32_ycbcr_sharded(planes, luma, chroma, mesh: Mesh, *,
                                    axis_name: str = DATA_AXIS,
                                    rounding: str = "rne") -> Sharded:
    """Fused YCbCr mode32 encode with the TOP view's strips sharded:
    (3, H, W) planar RGB -> (3, S, 8W) records split on the strip axis
    (the colour mix is per pixel and blocks never cross a shard's rows)."""
    planes = _tensor(planes)
    _, h, w = planes.shape
    n = _num_shards(mesh, axis_name)
    assert (h // 2) % (n * 8) == 0, "strips must divide evenly over shards"
    luma, chroma = lut_array(luma), lut_array(chroma)
    parts = shard(planes[:, : h // 2, :], mesh, {axis_name: 1})
    return _map(lambda local: K.encode32_rgb_view(
        local, luma, chroma, rounding).reshape(
            3, local.shape[1] // 8, 8 * w), parts)


def encode_quantize32_ycbcr420_sharded(planes, luma, chroma, mesh: Mesh, *,
                                       axis_name: str = DATA_AXIS,
                                       rounding: str = "rne"):
    """Fused YCbCr 4:2:0 encode with the TOP view's strips sharded:
    (3, H, W) planar RGB -> ((S, 8W) luma records split on strips,
    (2, S/2, 4W) chroma records split on chroma strips).

    The 2x2 chroma fold pairs luma strips, so each shard must own an even
    strip count (chroma strips never cross a 32-row boundary)."""
    planes = _tensor(planes)
    _, h, w = planes.shape
    n = _num_shards(mesh, axis_name)
    assert (h // 2) % (n * 16) == 0, \
        "420 sharding needs an even strip count per shard"
    luma, chroma = lut_array(luma), lut_array(chroma)
    parts = shard(planes[:, : h // 2, :], mesh, {axis_name: 1})
    streams = [K.encode420_rgb_view(local, luma, chroma,
                                    rounding) for local in parts.shards]
    recs = [unpack_records(s, w, local.shape[1])
            for s, local in zip(streams, parts.shards)]
    return (Sharded(tuple(y for y, _ in recs), mesh,
                    _dims(mesh, {axis_name: 0})),
            Sharded(tuple(c for _, c in recs), mesh,
                    _dims(mesh, {axis_name: 1})))


def decode_quantize32_ycbcr420_sharded(y_rec, c_rec, luma, chroma,
                                       size_x: int, size_y: int,
                                       mesh: Mesh, *,
                                       axis_name: str = DATA_AXIS
                                       ) -> Sharded:
    """Inverse: strip-split ((S, 8W), (2, S/2, 4W)) 4:2:0 records ->
    (3, H/2, W) planar RGB split on rows (the 2x2 upsample stays on the
    shard: a chroma strip feeds exactly its own shard's two luma
    strips)."""
    luma, chroma = lut_array(luma), lut_array(chroma)
    n = _num_shards(mesh, axis_name)
    s = _strips(y_rec, mesh, axis_name, 0)
    assert s % (2 * n) == 0
    ys = _as_sharded(y_rec, mesh, {axis_name: 0})
    cs = _as_sharded(c_rec, mesh, {axis_name: 1})
    return _map(lambda y, c: K.decode_quantize32_ycbcr420(
        pack_records(y, c), luma, chroma, size_x, 16 * y.shape[0]),
        ys, cs, dims=_dims(mesh, {axis_name: 1}))


def decode_quantize32_ycbcr_sharded(records, luma, chroma, size_x: int,
                                    size_y: int, mesh: Mesh, *,
                                    axis_name: str = DATA_AXIS) -> Sharded:
    """Inverse: (3, S, 8W) records split on strips -> (3, H/2, W) planar
    RGB split on rows."""
    luma, chroma = lut_array(luma), lut_array(chroma)
    parts = _as_sharded(records, mesh, {axis_name: 1})
    return _map(lambda local: K.decode_quantize32_ycbcr(
        _kernel_ready(local).reshape(3, -1), luma, chroma, size_x,
        16 * local.shape[1]), parts)
