"""Wrappers around the hand-written CUDA kernels: mode32 (``csrc/dct32.cu``),
enc-quant (``csrc/encq.cu``), stereo (``csrc/stereo.cu``), YCbCr 4:4:4
colour (``csrc/color32.cu``), YCbCr 4:2:0 colour (``csrc/color420.cu``) and
the panel engine's tiles (``csrc/tiles.cu``), with view-level forms of the
mode32 and colour encodes for the shards of ``dist`` (whose plane gather
launches through ``dist/collectives.py`` and counts here).

Counterpart of ``simd_dct_tpu/kernels/pallas_dct.py`` (``encode_quantize32``
/ ``decode_quantize32`` / ``roundtrip_quantize32``, ``encode_quantize`` /
``decode_quantize``, ``encode_quantize_stereo`` / ``decode_quantize_stereo``),
of ``simd_dct_tpu/kernels/color32.py`` (``encode_quantize32_ycbcr`` /
``decode_quantize32_ycbcr`` / ``roundtrip_quantize32_ycbcr``), of
``simd_dct_tpu/kernels/color420.py`` (``enc420_rgb`` / ``dec420_rgb`` with
``pack_records`` / ``unpack_records``), of ``_tiles_panels`` /
``_detile_panels`` of ``pallas_dct.py`` (``tiles_panels`` /
``detile_panels``) and of the trial kernel of ``dispatch/capability.py``.

Device rule: a CPU tensor goes to the plain PyTorch version
(``kernels/torch_path.py``, for the tiles ``kernels/panel.py``); a CUDA
tensor launches the kernel, on
PyTorch's current stream, or raises.  There is no fallback from a failed
build or launch to the plain version.  Each wrapper checks device, dtype
(u8), shape and contiguity first, whatever the device, allocates its output
with ``torch.empty`` and raises if the launch returns a CUDA error.

``LAUNCHES`` counts the launches of each kernel; a wrapper adds one where
it launches, and nowhere else.  A batch lies on one grid axis, which holds
at most 65,535 frames, so a longer batch goes out in launches of at most
that many frames (``batch_slices``), each counted.
"""

from __future__ import annotations

import contextlib
import functools
import logging
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.quantize import (ROUNDING_MODES, dequant_scales, lut_array,
                             quant_scales)
from ..layout import color as L_color
from ..layout.color420 import record_bytes_420
from ..layout import reorder as L_reorder
from ..layout import stereo as L_stereo
from . import _build
from . import panel as _panel
from . import torch_path as _tp

LAUNCHES = {"enc32": 0, "dec32": 0, "roundtrip32": 0, "probe": 0,
            "encq": 0, "decq": 0, "enc_stereo": 0, "dec_stereo": 0,
            "enc32_rgb": 0, "dec32_rgb": 0, "roundtrip32_rgb": 0,
            "enc420_rgb": 0, "dec420_rgb": 0, "tiles": 0, "detile": 0,
            "ring_gather": 0, "selfring": 0}

_ROUNDING_CODE = {"rne": 0, "scalar": 1, "clamp_first": 2}
_LAYOUT_CODE = {"scalar": 0, "pair": 1, "pair_as_written": 2}
_VIEW_LAYOUT_CODE = {"interleaved": 0, "planar": 1, "native": 2}
_ORIENTATION_CODE = {"fy": 0, "fx": 1}
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_MAX_BATCH = 65535   # frames a launch takes (its grid.y; stereo, tiles: z)
_MODE32 = ("enc_quant32", "dec_quant32", "roundtrip32", "enc_quant32_ycbcr",
           "dec_quant32_ycbcr", "roundtrip32_ycbcr")
# 4:2:0: the half-resolution chroma planes keep mode32's own geometry
_MODE420 = ("enc_quant32_ycbcr420", "dec_quant32_ycbcr420")
# The colour kernels' ColorMix, 21 host f32 passed by value: RGB -> YCbCr
# and back (row-major), then the bias; the bits of layout/color.py.
_COLOR_MIX = np.concatenate([L_color.RGB2YCC.ravel(), L_color.YCC2RGB.ravel(),
                             L_color.YCC_BIAS]).astype(np.float32)
_COLOR_MIX.flags.writeable = False


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in VARIANT_LAUNCHES.values():
        for variant in counts:
            counts[variant] = 0


def supports_mode(mode: str, h: int, w: int, layout: str = "scalar") -> bool:
    """Geometry the kernels take directly: any H % 16 == 0 and, for the
    mode32 family and its YCbCr colour form, W % 64 == 0 (groups of 8
    blocks, src/simd_dct.cpp:118); for YCbCr 4:2:0, H % 32 == 0 and
    W % 128 == 0, so that the half-resolution chroma planes meet mode32's
    rule; for enc-quant, W % 8 == 0 in the ``scalar`` layout and W % 16 == 0
    in the pair layouts (whole two-block cells); for stereo, W % 8 == 0 in
    every view layout.  No padding or slicing pass exists or is needed."""
    if h <= 0 or w <= 0 or h % 16:
        return False
    if mode in _MODE420:
        return h % 32 == 0 and w % 128 == 0
    if mode in _MODE32:
        return w % 64 == 0
    if mode in ("enc_quant", "dec_quant"):
        return w % (8 if layout == "scalar" else 16) == 0
    if mode in ("enc_quant_stereo", "dec_quant_stereo"):
        return w % 8 == 0
    return False


def _check_tensor(t, name: str, ndims: tuple[int, ...],
                  strided_lead: bool = False, align: int = 16) -> None:
    """Device, dtype, dims, contiguity and alignment.  ``strided_lead``
    takes a view whose rows are contiguous but whose leading axis may be
    strided, as a row range of a larger image is (the view-level kernels
    take that frame or plane stride: a whole number of ``align``-byte
    units, no smaller than one view).  A CUDA tensor starts on an
    ``align``-byte boundary."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} lies on {t.device}; the kernels take CUDA "
                         "tensors and the plain version CPU tensors")
    if t.dtype != torch.uint8:
        raise TypeError(f"{name} must be uint8, got {t.dtype}")
    if t.ndim not in ndims:
        raise ValueError(f"{name} must have {' or '.join(map(str, ndims))} "
                         f"dims, got shape {tuple(t.shape)}")
    if strided_lead:
        h2, w = t.shape[-2:]
        if t.stride(-1) != 1 or (h2 > 1 and t.stride(-2) != w):
            raise ValueError(f"{name} must have contiguous rows")
        if t.ndim == 3 and t.shape[0] > 1 and (t.stride(0) < h2 * w
                                               or t.stride(0) % align):
            raise ValueError(f"{name}'s leading stride {t.stride(0)} must be "
                             f"a multiple of {align} and at least {h2 * w}")
    elif not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary")


def _check_geometry(mode: str, h: int, w: int,
                    layout: str = "scalar") -> None:
    if not supports_mode(mode, h, w, layout):
        if mode in _MODE420:
            raise ValueError(f"{mode} needs H % 32 == 0 and W % 128 == 0, "
                             f"got H={h}, W={w}")
        need = 64 if mode in _MODE32 else (
            8 if layout == "scalar" or mode.endswith("stereo") else 16)
        what = f"{mode} ({layout})" if mode.endswith("quant") else mode
        raise ValueError(f"{what} needs H % 16 == 0 and W % {need} == 0, "
                         f"got H={h}, W={w}")


@functools.lru_cache(maxsize=32)
def _scales_of(lut_bytes: bytes) -> tuple[np.ndarray, np.ndarray]:
    lut = np.frombuffer(lut_bytes, np.float32)
    out = (np.ascontiguousarray(quant_scales(lut).numpy()),
           np.ascontiguousarray(dequant_scales(lut).numpy()))
    for a in out:
        a.flags.writeable = False     # shared by every caller of the cache
    return out


def _host_scales(lut) -> tuple[np.ndarray, np.ndarray]:
    """(quant, dequant) scales, 64 host f32 each, passed to the kernels by
    value; cached per LUT, since computing them costs more host time than
    a launch."""
    return _scales_of(lut_array(lut).tobytes())


def _batch_of(t: torch.Tensor, base_ndim: int) -> int:
    return t.shape[0] if t.ndim > base_ndim else 1


def batch_slices(batch: int) -> list[tuple[int, int]]:
    """(first frame, frames) of each launch of a ``batch``-frame call, in
    order: at most ``_MAX_BATCH`` frames each, every frame in exactly one."""
    return [(lo, min(_MAX_BATCH, batch - lo))
            for lo in range(0, batch, _MAX_BATCH)]


def _launch(name: str, tensors: tuple[torch.Tensor, ...], batch: int,
            launch, frame_bytes: list[int] | None = None) -> None:
    """Launch kernel ``name`` once per slice of ``batch_slices(batch)``:
    ``launch(lib, src, dst, frames)`` gets the pointers of ``tensors``
    (input, output; each ``batch`` frames, contiguous unless
    ``frame_bytes`` gives their strides) advanced to the slice's first
    frame.  Each launch adds one to ``LAUNCHES[name]``, so a batch of more
    than ``_MAX_BATCH`` frames counts more than one; a launch that returns
    a CUDA error raises."""
    lib = _build.load()
    if frame_bytes is None:
        frame_bytes = [t.numel() // batch for t in tensors]
    with _on_device_of(tensors[0]):
        for lo, n in batch_slices(batch):
            rc = launch(lib, *(t.data_ptr() + lo * f
                               for t, f in zip(tensors, frame_bytes)), n)
            LAUNCHES[name] += 1
            _build.check(lib, rc, name)


def _clamp_i32(y: int) -> int:
    """A strip-range bound as the kernels' int: clamping keeps every
    comparison with 16*s (or 8*s) as it was."""
    return min(max(int(y), _I32_MIN), _I32_MAX)


def _on_device_of(t: torch.Tensor):
    """Make t's card current for the launch (a no-op when it already is)."""
    if t.device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(t.device)


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else \
        torch.cuda.current_device()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_capacity(kind: str, out: np.ndarray, smem: int) -> tuple[int, int]:
    """(CTAs an SM, SMs) from a capacity entry point's (smem, per_sm, sms),
    once its shared bytes equal the plan's."""
    if int(out[0]) != smem:
        raise RuntimeError(f"{kind}: the kernel lays out {int(out[0])} shared "
                           f"bytes, the plan {smem}")
    return int(out[1]), int(out[2])


def encode_quantize32(img: torch.Tensor, lut, start_y: int = 0,
                      end_y: int = 1 << 30,
                      rounding: str = "rne") -> torch.Tensor:
    """Mode32 encode of the TOP view of a (H, W) or (B, H, W) dual-view
    image -> (H/2*W,) or (B, H/2*W) u8 records; one launch per 65,535
    frames."""
    _check_tensor(img, "img", (2, 3))
    h, w = img.shape[-2:]
    _check_geometry("enc_quant32", h, w)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if img.device.type == "cpu":
        return _tp.encode_quantize32(img, lut, start_y, end_y, rounding)
    out = torch.empty(img.shape[:-2] + (h // 2 * w,), dtype=torch.uint8,
                      device=img.device)
    _enc32(img, out, h // 2, w, h * w, lut, start_y, end_y, rounding)
    return out


def _enc32(src: torch.Tensor, out: torch.Tensor, h2: int, w: int,
           frame_stride: int, lut, start_y: int, end_y: int,
           rounding: str) -> None:
    """The encode's launches: the top h2 rows of each of ``out``'s frames
    of ``src``, ``frame_stride`` bytes apart."""
    if out.numel() == 0:
        return
    batch = out.numel() // (h2 * w)
    q, _ = _host_scales(lut)

    def launch(lib, src_p, dst_p, n):
        plan = _row_tile_plan_of("enc32", src, n, h2, w, src_p, dst_p,
                                 frame_stride, rounding=rounding)
        return lib.sdct_enc32(
            src_p, dst_p, q.ctypes.data, n, h2, w, frame_stride,
            _clamp_i32(start_y), _clamp_i32(end_y), _ROUNDING_CODE[rounding],
            plan.grid, plan.smem, _stream(src))

    _launch("enc32", (src, out), batch, launch,
            frame_bytes=[frame_stride, h2 * w])


def decode_quantize32(data: torch.Tensor, lut, size_x: int,
                      size_y: int) -> torch.Tensor:
    """Mode32 records, (size_y/2*size_x,) or (B, size_y/2*size_x) u8 ->
    (size_y/2, size_x) or (B, size_y/2, size_x) u8 pixels."""
    _check_tensor(data, "data", (1, 2))
    _check_geometry("dec_quant32", size_y, size_x)
    h2 = size_y // 2
    if data.shape[-1] != h2 * size_x:
        raise ValueError(f"expected {h2 * size_x} record bytes per frame, "
                         f"got {data.shape[-1]}")
    if data.device.type == "cpu":
        return _tp.decode_quantize32(data, lut, size_x, size_y)
    batch = _batch_of(data, 1)
    out = torch.empty(data.shape[:-1] + (h2, size_x), dtype=torch.uint8,
                      device=data.device)
    if out.numel() == 0:
        return out
    _, qi = _host_scales(lut)

    def launch(lib, src, dst, n):
        plan = _row_tile_plan_of("dec32", data, n, h2, size_x, dst, src,
                                 h2 * size_x)
        return lib.sdct_dec32(src, dst, qi.ctypes.data, n, h2, size_x,
                              plan.grid, plan.smem, _stream(data))

    _launch("dec32", (data, out), batch, launch)
    return out


def roundtrip_quantize32(img: torch.Tensor, lut) -> torch.Tensor:
    """Fused mode32 encode (``rne``) -> decode of the TOP view:
    (H, W) or (B, H, W) u8 -> (H/2, W) or (B, H/2, W) u8."""
    _check_tensor(img, "img", (2, 3))
    h, w = img.shape[-2:]
    _check_geometry("roundtrip32", h, w)
    if img.device.type == "cpu":
        return _tp.roundtrip_quantize32(img, lut)
    batch = _batch_of(img, 2)
    h2 = h // 2
    out = torch.empty(img.shape[:-2] + (h2, w), dtype=torch.uint8,
                      device=img.device)
    if out.numel() == 0:
        return out
    q, qi = _host_scales(lut)

    def launch(lib, src, dst, n):
        plan = _roundtrip32_plan_of(img, src, n, h2, w, h * w)
        return lib.sdct_roundtrip32(src, dst, q.ctypes.data, qi.ctypes.data,
                                    n, h2, w, h * w, plan.grid, plan.smem,
                                    _stream(img))

    _launch("roundtrip32", (img, out), batch, launch)
    return out


# -- the fused round trip's launch plan (csrc/dct32.cu roundtrip32_kernel) ----

ROUNDTRIP32_TILE_BLOCKS = 16   # blocks of each strip a tile (kRtTileBlocks)
ROUNDTRIP32_TILE_STRIPS = 2    # strips a tile (kRtTileStrips)
ROUNDTRIP32_WARPS = 2          # warps a CTA, each on its own tiles (kRtWarps)
ROUNDTRIP32_STAGES = 2         # a warp's input tiles in flight
ROUNDTRIP32_OUT_BUFFERS = 2    # a warp's pixel tile buffers


class Roundtrip32Plan(NamedTuple):
    """A launch of ``roundtrip32_kernel``."""
    tile_blocks: int      # 8x8 blocks of each strip a tile
    tile_strips: int      # strips a tile
    tiles_per_row: int    # tiles across the width
    tail_blocks: int      # blocks of each strip of a row's last tile
    tiles: int            # of the launch, over (frame, row of tiles, tile)
    smem: int             # dynamic shared bytes of a CTA
    ctas_per_sm: int
    grid: int             # persistent CTAs; warp w of CTA c takes tiles
                          # c * ROUNDTRIP32_WARPS + w, + grid * WARPS, ...


def roundtrip32_smem() -> int:
    """Dynamic shared bytes of a CTA (``kRtSmem`` in dct32.cu): each
    warp's ``ROUNDTRIP32_STAGES`` input tiles and
    ``ROUNDTRIP32_OUT_BUFFERS`` pixel tiles, each 8 *
    ``ROUNDTRIP32_TILE_STRIPS`` rows of 8 * ``ROUNDTRIP32_TILE_BLOCKS``
    pixels."""
    return (ROUNDTRIP32_WARPS * (ROUNDTRIP32_STAGES + ROUNDTRIP32_OUT_BUFFERS)
            * 64 * ROUNDTRIP32_TILE_STRIPS * ROUNDTRIP32_TILE_BLOCKS)


def roundtrip32_plan(batch: int, h2: int, w: int, *, base: int,
                     frame_stride: int,
                     capacity: Callable[[], tuple[int, int]]
                     ) -> Roundtrip32Plan:
    """The launch for ``batch`` frames whose top (h2, W) views start at
    address ``base``, ``frame_stride`` bytes apart (both multiples of 16:
    one tensor copy a tile in, one tensor store out).  A tile is
    ``ROUNDTRIP32_TILE_BLOCKS`` blocks of each of ``ROUNDTRIP32_TILE_STRIPS``
    strips; the last of a row of tiles is short where 8 *
    ``ROUNDTRIP32_TILE_BLOCKS`` does not divide W, and the last row where
    the strips do not divide by ``ROUNDTRIP32_TILE_STRIPS``.
    ``capacity()`` gives (CTAs an SM holds, SMs); the grid is as many CTAs
    as the card holds at once, and no more than the tiles need."""
    if (base | frame_stride) % 16:
        raise ValueError(f"roundtrip32 needs 16-byte addresses and frame "
                         f"strides, got base {base} and stride {frame_stride}")
    if h2 <= 0 or h2 % 8 or w <= 0 or w % 64 or frame_stride < h2 * w:
        raise ValueError(f"roundtrip32 needs H2 % 8 == 0, W % 64 == 0 and a "
                         f"frame stride of at least H2*W, got H2={h2}, W={w}, "
                         f"stride {frame_stride}")
    bw = w // 8
    tpr = -(-bw // ROUNDTRIP32_TILE_BLOCKS)
    rows = -(-(h2 // 8) // ROUNDTRIP32_TILE_STRIPS)
    tiles = batch * rows * tpr
    if tiles >= 1 << 31:
        raise ValueError(f"roundtrip32: {tiles} tiles in one launch exceed "
                         "2^31 - 1")
    smem = roundtrip32_smem()
    per_sm, sms = capacity()
    if per_sm < 1:
        raise ValueError(f"roundtrip32: no CTA of {smem} shared bytes fits "
                         "an SM")
    return Roundtrip32Plan(
        ROUNDTRIP32_TILE_BLOCKS, ROUNDTRIP32_TILE_STRIPS, tpr,
        bw - (tpr - 1) * ROUNDTRIP32_TILE_BLOCKS, tiles, smem, per_sm,
        min(-(-tiles // ROUNDTRIP32_WARPS), sms * per_sm))


@functools.lru_cache(maxsize=16)
def _roundtrip32_capacity(device: int) -> tuple[int, int]:
    lib = _build.load()
    out = np.zeros(6, np.int32)
    with torch.cuda.device(device):
        _build.check(lib, lib.sdct_roundtrip32_capacity(
            *(out.ctypes.data + 4 * i for i in range(6))),
            "roundtrip32 capacity")
    layout = tuple(int(v) for v in out[3:])
    plan = (ROUNDTRIP32_TILE_BLOCKS, ROUNDTRIP32_TILE_STRIPS, ROUNDTRIP32_WARPS)
    if layout != plan:
        raise RuntimeError(f"roundtrip32: the kernel takes tiles of {layout[0]}"
                           f" blocks x {layout[1]} strips, {layout[2]} a CTA; "
                           f"the plan {plan[0]} x {plan[1]}, {plan[2]}")
    return _check_capacity("roundtrip32", out, roundtrip32_smem())


def _roundtrip32_plan_of(t: torch.Tensor, base: int, batch: int, h2: int,
                         w: int, frame_stride: int) -> Roundtrip32Plan:
    dev = _device_index(t)
    return roundtrip32_plan(batch, h2, w, base=base, frame_stride=frame_stride,
                            capacity=lambda: _roundtrip32_capacity(dev))


def roundtrip32_launch_plan(img: torch.Tensor) -> Roundtrip32Plan:
    """The plan ``roundtrip_quantize32`` launches for a (H, W) or (B, H, W)
    CUDA image of at most 65,535 frames."""
    h, w = img.shape[-2:]
    return _roundtrip32_plan_of(img, img.data_ptr(), _batch_of(img, 2),
                                h // 2, w, h * w)


def encode_quantize(img: torch.Tensor, lut, start_y: int = 0,
                    end_y: int = 1 << 30, rounding: str = "rne",
                    layout: str = "scalar",
                    legacy_range: bool = False) -> torch.Tensor:
    """Enc-quant encode of the TOP view of a (H, W) or (B, H, W) dual-view
    image -> (H/2*W,) or (B, H/2*W) u8 records in ``layout``; one launch
    per 65,535 frames."""
    return _encode_quantize(img, lut, start_y, end_y, rounding, layout,
                            legacy_range)


def _encode_quantize(img: torch.Tensor, lut, start_y: int = 0,
                     end_y: int = 1 << 30, rounding: str = "rne",
                     layout: str = "scalar", legacy_range: bool = False,
                     variant: str | None = None) -> torch.Tensor:
    """``encode_quantize``, with ``variant`` ("tensor" or "plain")
    overriding the plan's choice (``encq_plan``; checks and timing only,
    the bytes are the same)."""
    _check_tensor(img, "img", (2, 3))
    h, w = img.shape[-2:]
    if layout not in _LAYOUT_CODE:
        raise ValueError(f"layout must be one of {tuple(_LAYOUT_CODE)}")
    _check_geometry("enc_quant", h, w, layout)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if img.device.type == "cpu":
        return _tp.encode_quantize(img, lut, start_y, end_y, rounding,
                                   layout, legacy_range)
    batch = _batch_of(img, 2)
    h2 = h // 2
    out = torch.empty(img.shape[:-2] + (h2 * w,), dtype=torch.uint8,
                      device=img.device)
    if out.numel() == 0:
        return out
    q, _ = _host_scales(lut)

    def launch(lib, src, dst, n):
        plan = _launching("encq", _row_tile_plan_of(
            "encq", img, n, h2, w, src, dst, h * w, layout, rounding,
            variant), n, h, w, layout)
        return lib.sdct_encq(
            src, dst, q.ctypes.data, n, h2, w, h * w, _clamp_i32(start_y),
            _clamp_i32(end_y), int(legacy_range), _ROUNDING_CODE[rounding],
            _LAYOUT_CODE[layout], plan.grid, _VARIANT_CODE[plan.variant],
            plan.smem, _stream(img))

    _launch("encq", (img, out), batch, launch)
    return out


def decode_quantize(data: torch.Tensor, lut, size_x: int, size_y: int,
                    layout: str = "scalar") -> torch.Tensor:
    """Enc-quant records in the ``scalar`` or ``pair`` layout,
    (size_y/2*size_x,) or (B, size_y/2*size_x) u8 -> (size_y/2, size_x) or
    (B, size_y/2, size_x) u8 pixels."""
    return _decode_quantize(data, lut, size_x, size_y, layout)


def _decode_quantize(data: torch.Tensor, lut, size_x: int, size_y: int,
                     layout: str = "scalar",
                     variant: str | None = None) -> torch.Tensor:
    """``decode_quantize``, with ``variant`` as for ``_encode_quantize``."""
    _check_tensor(data, "data", (1, 2))
    if layout not in ("scalar", "pair"):
        raise ValueError("decodable layouts are 'scalar' and 'pair'")
    _check_geometry("dec_quant", size_y, size_x, layout)
    h2 = size_y // 2
    if data.shape[-1] != h2 * size_x:
        raise ValueError(f"expected {h2 * size_x} record bytes per frame, "
                         f"got {data.shape[-1]}")
    if data.device.type == "cpu":
        return _tp.decode_quantize(data, lut, size_x, size_y, layout)
    batch = _batch_of(data, 1)
    out = torch.empty(data.shape[:-1] + (h2, size_x), dtype=torch.uint8,
                      device=data.device)
    if out.numel() == 0:
        return out
    _, qi = _host_scales(lut)

    def launch(lib, src, dst, n):
        plan = _launching("decq", _row_tile_plan_of(
            "decq", data, n, h2, size_x, dst, src, h2 * size_x, layout,
            variant=variant), n, size_y, size_x, layout)
        return lib.sdct_decq(
            src, dst, qi.ctypes.data, n, h2, size_x, _LAYOUT_CODE[layout],
            plan.grid, _VARIANT_CODE[plan.variant], plan.smem, _stream(data))

    _launch("decq", (data, out), batch, launch)
    return out


# -- the enc-quant kernels' launch plans (csrc/encq.cu) -----------------------

ENCQ_TILE_BLOCKS = 32     # blocks of one strip a tile (kEqTileBlocks)
_EQ_KINDS = ("encq", "decq")


class RowTilePlan(NamedTuple):
    """A launch of a kernel on tiles of blocks of one strip row:
    ``encq_kernel``, ``decq_kernel``, ``enc32_kernel`` or
    ``dec32_kernel``."""
    variant: str          # "tensor" or "plain": how the pixels move
    tile_blocks: int      # blocks of one strip a tile
    tiles_per_strip: int
    tail_blocks: int      # blocks of each strip's last tile
    tiles: int            # of the launch, over (frame, strip, tile)
    smem: int             # dynamic shared bytes of a CTA
    ctas_per_sm: int
    grid: int             # persistent CTAs, each taking every grid-th tile


def encq_variant(w: int, pixels: int, frame_stride: int) -> str:
    """Tensor copies of the pixels need rows of W % 16 == 0 and 16-byte
    pixel addresses and frame strides; anything else takes the plain
    variant (the threads' 8-byte loads and stores).  The records always
    move by 1-D bulk copies."""
    aligned = (pixels | frame_stride) % 16 == 0
    return "tensor" if w % 16 == 0 and aligned else "plain"


def encq_smem() -> int:
    """Dynamic shared bytes of an encode CTA (``kEqSmem`` in encq.cu): the
    scales, one pixel tile and two record buffers (64 bytes a block each)
    and the f32 crossing buffer."""
    return 64 * 4 + 3 * 64 * ENCQ_TILE_BLOCKS + 4 * 64 * ENCQ_TILE_BLOCKS


def decq_smem() -> int:
    """Dynamic shared bytes of a decode CTA (``kDqSmem`` in encq.cu): the
    scales, one record tile and two pixel tiles (64 bytes a block each) and
    the f32 crossing buffer."""
    return 64 * 4 + 3 * 64 * ENCQ_TILE_BLOCKS + 4 * 64 * ENCQ_TILE_BLOCKS


def _row_tile_plan(kind: str, batch: int, h2: int, w: int, wmul: int, *,
                   pixels: int, records: int, frame_stride: int,
                   capacity: Callable[[str], tuple[int, int]],
                   variant: str | None, tile_blocks: int,
                   smem: int) -> RowTilePlan:
    """The launch of ``batch`` frames of (h2, W) views, W % ``wmul`` == 0,
    in tiles of ``tile_blocks`` blocks of one strip (the encq_plan and
    enc32_plan rules)."""
    if h2 <= 0 or h2 % 8 or w <= 0 or w % wmul:
        raise ValueError(f"{kind} needs H2 % 8 == 0 and W % {wmul} == 0, got "
                         f"H2={h2}, W={w}")
    if not 1 <= batch <= _MAX_BATCH:
        raise ValueError(f"{kind}: a launch takes 1 to {_MAX_BATCH} frames, "
                         f"got {batch}")
    if records % 16 or (pixels | frame_stride) % 8 or frame_stride < h2 * w:
        raise ValueError(f"{kind} needs 16-byte records, 8-byte pixels and a "
                         f"frame stride of at least H2*W in 8-byte units, got"
                         f" records at {records}, pixels at {pixels}, stride "
                         f"{frame_stride}")
    best = encq_variant(w, pixels, frame_stride)
    if variant is None:
        variant = best
    elif variant not in _VARIANT_CODE or (variant == "tensor"
                                          and best != "tensor"):
        raise ValueError(f"{kind}: variant {variant!r} is not possible here "
                         f"(tensor copies need W % 16 == 0 and 16-byte pixels"
                         f" and stride; W={w}, pixels at {pixels}, stride "
                         f"{frame_stride})")
    bw = w // 8
    tps = -(-bw // tile_blocks)
    tiles = batch * (h2 // 8) * tps
    if tiles >= 1 << 31:
        raise ValueError(f"{kind}: {tiles} tiles in one launch exceed "
                         "2^31 - 1")
    per_sm, sms = capacity(variant)
    if per_sm < 1:
        raise ValueError(f"{kind}: no CTA of {smem} shared bytes fits an SM")
    return RowTilePlan(variant, tile_blocks, tps, bw - (tps - 1) * tile_blocks,
                       tiles, smem, per_sm, min(tiles, sms * per_sm))


def _eq_plan(kind: str, batch: int, h2: int, w: int, layout: str, *,
             pixels: int, records: int, frame_stride: int,
             capacity: Callable[[str], tuple[int, int]],
             variant: str | None, tile_blocks: int,
             smem: int) -> RowTilePlan:
    if kind not in _EQ_KINDS:
        raise ValueError(f"no enc-quant plan for {kind!r}")
    layouts = _LAYOUT_CODE if kind == "encq" else ("scalar", "pair")
    if layout not in layouts:
        raise ValueError(f"{kind}: layout must be one of {tuple(layouts)}")
    return _row_tile_plan(f"{kind} ({layout})", batch, h2, w,
                          8 if layout == "scalar" else 16,
                          pixels=pixels, records=records,
                          frame_stride=frame_stride, capacity=capacity,
                          variant=variant, tile_blocks=tile_blocks, smem=smem)


def encq_plan(batch: int, h2: int, w: int, layout: str, *, pixels: int,
              records: int, frame_stride: int,
              capacity: Callable[[str], tuple[int, int]],
              variant: str | None = None) -> RowTilePlan:
    """The launch of the encode for ``batch`` frames whose top (h2, W) views
    start at address ``pixels``, ``frame_stride`` bytes apart, into records
    at ``records``.  A tile is ``ENCQ_TILE_BLOCKS`` blocks of one strip,
    never crossing a strip (the last of a strip holds the rest), and owns
    64 bytes a block of consecutive records in every layout.  ``variant``
    overrides the alignment's choice ("tensor" only where it is possible);
    ``capacity(variant)`` gives (CTAs of that launch an SM holds, SMs); the
    grid is as many CTAs as the card holds at once, at most one a tile."""
    return _eq_plan("encq", batch, h2, w, layout, pixels=pixels,
                    records=records, frame_stride=frame_stride,
                    capacity=capacity, variant=variant,
                    tile_blocks=ENCQ_TILE_BLOCKS, smem=encq_smem())


def decq_plan(batch: int, h2: int, w: int, layout: str, *, records: int,
              pixels: int, capacity: Callable[[str], tuple[int, int]],
              variant: str | None = None) -> RowTilePlan:
    """The launch of the decode of ``batch`` frames of records at address
    ``records`` into (h2, W) views at ``pixels``, H2*W bytes apart, in the
    encode's tiles."""
    return _eq_plan("decq", batch, h2, w, layout, pixels=pixels,
                    records=records, frame_stride=h2 * w, capacity=capacity,
                    variant=variant, tile_blocks=ENCQ_TILE_BLOCKS,
                    smem=decq_smem())


def encq_launch_plan(kind: str, t: torch.Tensor, layout: str = "scalar",
                     rounding: str = "rne", *, size_x: int | None = None,
                     size_y: int | None = None) -> RowTilePlan:
    """The plan ``encode_quantize`` (kind "encq", ``t`` a (H, W) or
    (B, H, W) image) or ``decode_quantize`` ("decq", ``t`` the records of a
    ``size_y`` x ``size_x`` image) launches for a CUDA tensor of at most
    65,535 frames; the output's address is taken as 16-byte aligned, as the
    wrappers allocate it."""
    if kind == "encq":
        h, w = t.shape[-2:]
        return _row_tile_plan_of(kind, t, _batch_of(t, 2), h // 2, w,
                                 t.data_ptr(), 0, h * w, layout, rounding)
    h2 = size_y // 2
    return _row_tile_plan_of(kind, t, _batch_of(t, 1), h2, size_x, 0,
                             t.data_ptr(), h2 * size_x, layout)


# -- the mode32 encode's and decode's launch plans (csrc/dct32.cu) ------------

MODE32_TILE_BLOCKS = 32   # blocks of one strip a tile (kM32TileBlocks)
_M32_KINDS = ("enc32", "dec32")
_GROUP_STRIDE = 528       # a staged 512-byte group record (kGroupStride)


def enc32_smem() -> int:
    """Dynamic shared bytes of an encode CTA (``kE32Smem`` in dct32.cu): the
    scales, one pixel tile (64 bytes a block), two record buffers of padded
    groups (``_GROUP_STRIDE`` bytes for 8 blocks) and the f32 crossing
    buffer."""
    nb = MODE32_TILE_BLOCKS
    return 64 * 4 + 64 * nb + 2 * (nb // 8) * _GROUP_STRIDE + 4 * 64 * nb


def dec32_smem() -> int:
    """Dynamic shared bytes of a decode CTA (``kD32Smem`` in dct32.cu): the
    scales, two pixel tiles, one record buffer of padded groups and the f32
    crossing buffer."""
    nb = MODE32_TILE_BLOCKS
    return 64 * 4 + 2 * 64 * nb + (nb // 8) * _GROUP_STRIDE + 4 * 64 * nb


def _m32_plan(kind: str, batch: int, h2: int, w: int, *, pixels: int,
              records: int, frame_stride: int,
              capacity: Callable[[str], tuple[int, int]], tile_blocks: int,
              smem: int) -> RowTilePlan:
    if kind not in _M32_KINDS:
        raise ValueError(f"no mode32 plan for {kind!r}")
    return _row_tile_plan(kind, batch, h2, w, 64, pixels=pixels,
                          records=records, frame_stride=frame_stride,
                          capacity=capacity, variant="tensor",
                          tile_blocks=tile_blocks, smem=smem)


def enc32_plan(batch: int, h2: int, w: int, *, pixels: int, records: int,
               frame_stride: int,
               capacity: Callable[[str], tuple[int, int]]) -> RowTilePlan:
    """The launch of the encode for ``batch`` frames whose top (h2, W) views
    start at address ``pixels``, ``frame_stride`` bytes apart, into records
    at ``records``.  A tile is ``MODE32_TILE_BLOCKS`` blocks of one strip,
    never crossing a strip (the last of a strip holds the rest, whole
    8-block groups), and owns its 64 bytes a block of consecutive records.
    The pixels move by tensor copies, so the addresses and the frame stride
    must be multiples of 16 (W % 64 == 0 keeps the rows so).
    ``capacity("tensor")`` gives (CTAs of that launch an SM holds, SMs); the
    grid is as many CTAs as the card holds at once, at most one a tile."""
    return _m32_plan("enc32", batch, h2, w, pixels=pixels, records=records,
                     frame_stride=frame_stride, capacity=capacity,
                     tile_blocks=MODE32_TILE_BLOCKS, smem=enc32_smem())


def dec32_plan(batch: int, h2: int, w: int, *, records: int, pixels: int,
               capacity: Callable[[str], tuple[int, int]]) -> RowTilePlan:
    """The launch of the decode of ``batch`` frames of records at address
    ``records`` into (h2, W) views at ``pixels``, H2*W bytes apart, in the
    encode's tiles."""
    return _m32_plan("dec32", batch, h2, w, pixels=pixels, records=records,
                     frame_stride=h2 * w, capacity=capacity,
                     tile_blocks=MODE32_TILE_BLOCKS, smem=dec32_smem())


def mode32_launch_plan(kind: str, t: torch.Tensor, rounding: str = "rne", *,
                       size_x: int | None = None,
                       size_y: int | None = None) -> RowTilePlan:
    """The plan ``encode_quantize32`` (kind "enc32", ``t`` a (H, W) or
    (B, H, W) image) or ``decode_quantize32`` ("dec32", ``t`` the records of
    a ``size_y`` x ``size_x`` image) launches for a CUDA tensor of at most
    65,535 frames; the output's address is taken as 16-byte aligned, as the
    wrappers allocate it."""
    if kind == "enc32":
        h, w = t.shape[-2:]
        return _row_tile_plan_of(kind, t, _batch_of(t, 2), h // 2, w,
                                 t.data_ptr(), 0, h * w, rounding=rounding)
    h2 = size_y // 2
    return _row_tile_plan_of(kind, t, _batch_of(t, 1), h2, size_x, 0,
                             t.data_ptr(), h2 * size_x)


# -- the row-tile kernels' plans on a card (encq.cu, dct32.cu) ----------------

@functools.lru_cache(maxsize=64)
def _row_tile_capacity(device: int, kind: str, rounding: str, layout: str,
                       variant: str) -> tuple[int, int]:
    """(CTAs an SM, SMs) of ``kind``'s instantiation for these options on
    card ``device``, once its tile width and shared bytes equal the
    plan's."""
    lib = _build.load()
    r, lay, v = (_ROUNDING_CODE[rounding], _LAYOUT_CODE[layout],
                 _VARIANT_CODE[variant])
    # kind -> (capacity entry point, its options, tile width, shared bytes)
    entry, options, nb, smem = {
        "encq": (lib.sdct_encq_capacity, (r, lay, v), ENCQ_TILE_BLOCKS,
                 encq_smem()),
        "decq": (lib.sdct_decq_capacity, (lay, v), ENCQ_TILE_BLOCKS,
                 decq_smem()),
        "enc32": (lib.sdct_enc32_capacity, (r,), MODE32_TILE_BLOCKS,
                  enc32_smem()),
        "dec32": (lib.sdct_dec32_capacity, (), MODE32_TILE_BLOCKS,
                  dec32_smem())}[kind]
    out = np.zeros(4, np.int32)
    with torch.cuda.device(device):
        rc = entry(*options, *(out.ctypes.data + 4 * i for i in range(4)))
        _build.check(lib, rc, f"{kind} capacity")
    if (int(out[0]), int(out[1])) != (nb, smem):
        raise RuntimeError(f"{kind}: the kernel lays out tiles of "
                           f"{int(out[0])} blocks in {int(out[1])} shared "
                           f"bytes, the plan {nb} in {smem}")
    return int(out[2]), int(out[3])


def _row_tile_plan_of(kind: str, t: torch.Tensor, batch: int, h2: int,
                      w: int, pixels: int, records: int, frame_stride: int,
                      layout: str = "scalar", rounding: str = "rne",
                      variant: str | None = None) -> RowTilePlan:
    """The plan of a launch of ``kind`` ("encq", "decq", "enc32" or
    "dec32") on ``t``'s card.  It depends on the addresses only through
    their offsets from a 16-byte boundary, so it is cached by those: a
    wrapper call pays one lookup (its host time: PERF.md)."""
    return _row_tile_plan_cached(kind, _device_index(t), batch, h2, w,
                                 layout, pixels % 16, records % 16,
                                 frame_stride, rounding, variant)


@functools.lru_cache(maxsize=256)
def _row_tile_plan_cached(kind: str, dev: int, batch: int, h2: int, w: int,
                          layout: str, pixels: int, records: int,
                          frame_stride: int, rounding: str,
                          variant: str | None) -> RowTilePlan:
    def capacity(v):
        return _row_tile_capacity(dev, kind, rounding, layout, v)

    at = dict(pixels=pixels, records=records, capacity=capacity)
    if kind == "encq":
        return encq_plan(batch, h2, w, layout, frame_stride=frame_stride,
                         variant=variant, **at)
    if kind == "decq":
        return decq_plan(batch, h2, w, layout, variant=variant, **at)
    if kind == "enc32":
        return enc32_plan(batch, h2, w, frame_stride=frame_stride, **at)
    return dec32_plan(batch, h2, w, **at)


def encode_quantize_stereo(img: torch.Tensor, lut, start_y: int = 0,
                           end_y: int = 1 << 30, rounding: str = "rne",
                           view_layout: str = "interleaved", *,
                           variant: str | None = None) -> torch.Tensor:
    """Stereo encode of both views of a (H, W) or (B, H, W) dual-view image
    -> records in ``view_layout``: (..., H*W) interleaved,
    (..., 2, 64, H/16, W/8) planar or (..., 2, 64, H/16, BWP) native u8;
    one launch per 65,535 frames.  ``variant`` ("tensor" or "plain")
    overrides the plan's choice (``stereo_plan``); the bytes are the
    same."""
    _check_tensor(img, "img", (2, 3))
    h, w = img.shape[-2:]
    frame = L_stereo.record_shape(view_layout, h, w)
    _check_geometry("enc_quant_stereo", h, w)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if img.device.type == "cpu":
        return _tp.encode_quantize_stereo(img, lut, start_y, end_y, rounding,
                                          view_layout)
    out = torch.empty(img.shape[:-2] + frame, dtype=torch.uint8,
                      device=img.device)
    _enc_stereo(img, out, _batch_of(img, 2), h, w, (h // 2) * w, lut,
                start_y, end_y, rounding, view_layout, variant)
    return out


def _enc_stereo(img, out, batch: int, h: int, w: int, view_stride: int, lut,
                start_y: int, end_y: int, rounding: str, view_layout: str,
                variant: str | None) -> None:
    if out.numel() == 0:
        return
    q, _ = _host_scales(lut)

    def launch(lib, src, dst, n):
        plan = _launching("enc_stereo", _stereo_plan_of(
            "enc_stereo", img, n, h, w, view_layout, src, dst, view_stride,
            rounding, variant), n, h, w, view_layout)
        return lib.sdct_enc_stereo(
            src, dst, q.ctypes.data, n, h, w, L_stereo.native_stereo_bwp(w),
            _clamp_i32(start_y), _clamp_i32(end_y), _ROUNDING_CODE[rounding],
            _VIEW_LAYOUT_CODE[view_layout], view_stride, plan.grid,
            plan.tile_blocks, _VARIANT_CODE[plan.variant], plan.smem,
            _stream(img))

    _launch("enc_stereo", (img, out), batch, launch,
            frame_bytes=[h * w, out.numel() // batch])


def decode_quantize_stereo(data: torch.Tensor, lut, size_x: int, size_y: int,
                           view_layout: str = "interleaved", *,
                           variant: str | None = None) -> torch.Tensor:
    """Stereo records in ``view_layout`` (one frame's shape as
    ``encode_quantize_stereo`` returns it, with an optional batch axis) ->
    (size_y, size_x) or (B, size_y, size_x) u8 pixels of both views.
    ``variant`` as for ``encode_quantize_stereo``."""
    frame = L_stereo.record_shape(view_layout, size_y, size_x)
    _check_tensor(data, "data", (len(frame), len(frame) + 1))
    _check_geometry("dec_quant_stereo", size_y, size_x)
    if tuple(data.shape[data.ndim - len(frame):]) != frame:
        raise ValueError(f"expected {view_layout} stereo records of shape "
                         f"(..., {', '.join(map(str, frame))}), got "
                         f"{tuple(data.shape)}")
    if data.device.type == "cpu":
        return _tp.decode_quantize_stereo(data, lut, size_x, size_y,
                                          view_layout)
    batch = _batch_of(data, len(frame))
    out = torch.empty(data.shape[:data.ndim - len(frame)] + (size_y, size_x),
                      dtype=torch.uint8, device=data.device)
    if out.numel() == 0:
        return out
    _, qi = _host_scales(lut)

    def launch(lib, src, dst, n):
        plan = _launching("dec_stereo", _stereo_plan_of(
            "dec_stereo", data, n, size_y, size_x, view_layout, dst, src,
            (size_y // 2) * size_x, variant=variant), n, size_y, size_x,
            view_layout)
        return lib.sdct_dec_stereo(
            src, dst, qi.ctypes.data, n, size_y, size_x,
            L_stereo.native_stereo_bwp(size_x), _VIEW_LAYOUT_CODE[view_layout],
            plan.grid, plan.tile_blocks, _VARIANT_CODE[plan.variant],
            plan.smem, _stream(data))

    _launch("dec_stereo", (data, out), batch, launch)
    return out


# -- the stereo kernels' launch plan (csrc/stereo.cu) -------------------------

STEREO_TILE_BLOCKS = 32   # block columns a tile, of one (frame, strip, view)
_STEREO_KIND_CODE = {"enc_stereo": 0, "dec_stereo": 1}
# launches of each stereo and enc-quant kernel by variant (counted beside
# LAUNCHES)
VARIANT_LAUNCHES = {k: {"tensor": 0, "plain": 0}
                    for k in (*_STEREO_KIND_CODE, "encq", "decq")}
_log = logging.getLogger(__name__)


class StereoPlan(NamedTuple):
    """A launch of ``enc_stereo_kernel`` or ``dec_stereo_kernel``."""
    variant: str          # "tensor" or "plain"
    tile_blocks: int      # nb: block columns a tile
    tiles_per_row: int    # of a (frame, strip, view) row
    tail_blocks: int      # columns of each row's last tile
    tiles: int            # of the launch, over (frame, strip, view, tile)
    smem: int             # dynamic shared bytes of a CTA
    ctas_per_sm: int
    grid: int             # persistent CTAs, each taking every grid-th tile


def stereo_variant(w: int, pixels: int, records: int, view_stride: int) -> str:
    """Tensor copies need rows of W % 128 == 0 (whole 16-byte record
    segments, BW % 16 == 0) and 16-byte pixel and record addresses and view
    stride; anything else takes the plain variant."""
    aligned = (pixels | records | view_stride) % 16 == 0
    return "tensor" if w % 128 == 0 and aligned else "plain"


def stereo_smem() -> int:
    """Dynamic shared bytes of a CTA (``kStereoSmem`` in stereo.cu): the
    scales, the input tile and two output tiles (64 segments, or 8 pixel
    rows, of nb bytes each) and the f32 crossing buffer."""
    return 64 * 4 + 3 * 64 * STEREO_TILE_BLOCKS + 4 * 64 * STEREO_TILE_BLOCKS


def stereo_plan(kind: str, batch: int, h: int, w: int, view_layout: str, *,
                pixels: int, records: int, view_stride: int,
                capacity: Callable[[str], tuple[int, int]],
                variant: str | None = None) -> StereoPlan:
    """The launch for ``batch`` (H, W) dual-view frames whose pixels start
    at address ``pixels`` (the bottom view ``view_stride`` bytes after the
    top one) and whose records start at ``records``.  A tile is
    ``STEREO_TILE_BLOCKS`` block columns of one (frame, strip, view) row, never
    crossing a strip or a view; the last of a row holds the rest.  The
    encode's native rows are BWP columns long (the pad has its tiles), the
    decode's BW (the pad is never read).  ``variant`` overrides the
    alignment's choice ("tensor" only where it is possible);
    ``capacity(variant)`` gives (CTAs of that launch an SM holds, SMs); the
    grid is as many CTAs as the card holds at once, at most one a tile."""
    if kind not in _STEREO_KIND_CODE:
        raise ValueError(f"no stereo plan for {kind!r}")
    L_stereo.check_view_layout(view_layout)
    best = stereo_variant(w, pixels, records, view_stride)
    if variant is None:
        variant = best
    elif variant not in _VARIANT_CODE or (variant == "tensor"
                                          and best != "tensor"):
        raise ValueError(f"{kind}: variant {variant!r} is not possible here "
                         f"(W={w}, pixels at {pixels}, records at {records},"
                         f" view stride {view_stride})")
    bw = w // 8
    row = (L_stereo.native_stereo_bwp(w)
           if kind == "enc_stereo" and view_layout == "native" else bw)
    nb = STEREO_TILE_BLOCKS
    tpr = -(-row // nb)
    tiles = batch * (h // 16) * 2 * tpr
    if tiles >= 1 << 31:
        raise ValueError(f"{kind}: {tiles} tiles in one launch exceed "
                         "2^31 - 1")
    per_sm, sms = capacity(variant)
    smem = stereo_smem()
    if per_sm < 1:
        raise ValueError(f"{kind}: no CTA of {smem} shared bytes fits an SM")
    return StereoPlan(variant, nb, tpr, row - (tpr - 1) * nb, tiles, smem,
                      per_sm, min(tiles, sms * per_sm))


@functools.lru_cache(maxsize=16)
def _stereo_capacity(device: int, kind: str, rounding: str,
                     variant: str) -> tuple[int, int]:
    lib = _build.load()
    out = np.zeros(4, np.int32)
    with torch.cuda.device(device):
        _build.check(lib, lib.sdct_stereo_capacity(
            _STEREO_KIND_CODE[kind], _ROUNDING_CODE[rounding],
            _VARIANT_CODE[variant], *(out.ctypes.data + 4 * i
                                      for i in range(4))),
            f"{kind} capacity")
    nb, smem = int(out[0]), int(out[1])
    if nb != STEREO_TILE_BLOCKS or smem != stereo_smem():
        raise RuntimeError(f"{kind}: the kernel lays out tiles of {nb} blocks "
                           f"in {smem} shared bytes, the plan "
                           f"{STEREO_TILE_BLOCKS} in {stereo_smem()}")
    return int(out[2]), int(out[3])


def _stereo_plan_of(kind: str, t: torch.Tensor, batch: int, h: int, w: int,
                    view_layout: str, pixels: int, records: int,
                    view_stride: int, rounding: str = "rne",
                    variant: str | None = None) -> StereoPlan:
    dev = _device_index(t)
    return stereo_plan(kind, batch, h, w, view_layout, pixels=pixels,
                       records=records, view_stride=view_stride,
                       capacity=lambda v: _stereo_capacity(dev, kind,
                                                           rounding, v),
                       variant=variant)


def _launching(kind: str, plan, batch: int, h: int, w: int, layout: str):
    """Count and log the variant of a stereo or enc-quant launch."""
    VARIANT_LAUNCHES[kind][plan.variant] += 1
    if _log.isEnabledFor(logging.DEBUG):
        _log.debug("%s %dx%dx%d %s: %s", kind, batch, h, w, layout, plan)
    return plan


def stereo_launch_plan(kind: str, t: torch.Tensor, view_layout: str,
                       size_x: int | None = None, size_y: int | None = None,
                       rounding: str = "rne") -> StereoPlan:
    """The plan ``encode_quantize_stereo`` (kind "enc_stereo", ``t`` the
    image) or ``decode_quantize_stereo`` ("dec_stereo", ``t`` the records
    of a ``size_y`` x ``size_x`` image) launches for a CUDA tensor of at
    most 65,535 frames; the records' or the pixels' address is taken as
    16-byte aligned, as the wrappers allocate them."""
    if kind == "enc_stereo":
        h, w = t.shape[-2:]
        batch, pixels, records = _batch_of(t, 2), t.data_ptr(), 0
    else:
        h, w = size_y, size_x
        frame = L_stereo.record_shape(view_layout, h, w)
        batch, pixels, records = _batch_of(t, len(frame)), 0, t.data_ptr()
    dev = _device_index(t)
    return stereo_plan(kind, batch, h, w, view_layout, pixels=pixels,
                       records=records, view_stride=(h // 2) * w,
                       capacity=lambda v: _stereo_capacity(dev, kind,
                                                           rounding, v))


def _check_planes(t, name: str) -> None:
    _check_tensor(t, name, (3, 4))
    if t.shape[-3] != 3:
        raise ValueError(f"{name} must be (3, H, W) planar RGB or a "
                         f"(B, 3, H, W) batch, got shape {tuple(t.shape)}")


def encode_quantize32_ycbcr(planes: torch.Tensor, luma, chroma,
                            rounding: str = "rne") -> torch.Tensor:
    """Colour mode32 encode of the TOP view of a (3, H, W) or (B, 3, H, W)
    planar RGB dual-view image -> (3, H/2*W) or (B, 3, H/2*W) u8 records
    (Y with ``luma``, Cb and Cr with ``chroma``); one launch per 65,535
    frames."""
    _check_planes(planes, "planes")
    h, w = planes.shape[-2:]
    _check_geometry("enc_quant32_ycbcr", h, w)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if planes.device.type == "cpu":
        return _tp.encode_ycbcr32(planes, luma, chroma, rounding)
    h2 = h // 2
    out = torch.empty(planes.shape[:-2] + (h2 * w,), dtype=torch.uint8,
                      device=planes.device)
    _enc32_rgb(planes, out, _batch_of(planes, 3), h2, w, h * w, luma, chroma,
               rounding)
    return out


def _enc32_rgb(src: torch.Tensor, out: torch.Tensor, batch: int, h2: int,
               w: int, plane_stride: int, luma, chroma, rounding: str) -> None:
    if out.numel() == 0:
        return
    ql, _ = _host_scales(luma)
    qc, _ = _host_scales(chroma)

    def launch(lib, src_p, dst_p, n):
        plan = _color_plan_of("enc32_rgb", src, src_p, n, h2, w, plane_stride,
                              rounding)
        return lib.sdct_enc32_rgb(
            src_p, dst_p, ql.ctypes.data, qc.ctypes.data,
            _COLOR_MIX.ctypes.data, n, h2, w, plane_stride,
            _ROUNDING_CODE[rounding], plan.grid, _VARIANT_CODE[plan.variant],
            plan.smem, _stream(src))

    _launch("enc32_rgb", (src, out), batch, launch,
            frame_bytes=[3 * plane_stride, 3 * h2 * w])


def decode_quantize32_ycbcr(data: torch.Tensor, luma, chroma, size_x: int,
                            size_y: int) -> torch.Tensor:
    """Colour mode32 records, (3, size_y/2*size_x) or (B, 3, size_y/2*size_x)
    u8 -> (3, size_y/2, size_x) or (B, 3, size_y/2, size_x) u8 planar RGB."""
    _check_tensor(data, "data", (2, 3))
    _check_geometry("dec_quant32_ycbcr", size_y, size_x)
    h2 = size_y // 2
    if tuple(data.shape[-2:]) != (3, h2 * size_x):
        raise ValueError(f"expected (..., 3, {h2 * size_x}) record bytes, "
                         f"got {tuple(data.shape)}")
    if data.device.type == "cpu":
        return _tp.decode_ycbcr32(data, luma, chroma, size_x, size_y)
    batch = _batch_of(data, 2)
    out = torch.empty(data.shape[:-1] + (h2, size_x), dtype=torch.uint8,
                      device=data.device)
    if out.numel() == 0:
        return out
    _, qil = _host_scales(luma)
    _, qic = _host_scales(chroma)

    def launch(lib, src, dst, n):
        plan = _color_plan_of("dec32_rgb", data, src, n, h2, size_x,
                              h2 * size_x)
        return lib.sdct_dec32_rgb(
            src, dst, qil.ctypes.data, qic.ctypes.data,
            _COLOR_MIX.ctypes.data, n, h2, size_x, plan.grid, plan.smem,
            _stream(data))

    _launch("dec32_rgb", (data, out), batch, launch)
    return out


def roundtrip_quantize32_ycbcr(planes: torch.Tensor, luma,
                               chroma) -> torch.Tensor:
    """Fused colour mode32 encode (``rne``) -> decode of the TOP view:
    (3, H, W) or (B, 3, H, W) u8 -> (3, H/2, W) or (B, 3, H/2, W) u8."""
    _check_planes(planes, "planes")
    h, w = planes.shape[-2:]
    _check_geometry("roundtrip32_ycbcr", h, w)
    if planes.device.type == "cpu":
        return _tp.roundtrip_ycbcr32(planes, luma, chroma)
    batch = _batch_of(planes, 3)
    h2 = h // 2
    out = torch.empty(planes.shape[:-2] + (h2, w), dtype=torch.uint8,
                      device=planes.device)
    if out.numel() == 0:
        return out
    ql, qil = _host_scales(luma)
    qc, qic = _host_scales(chroma)

    def launch(lib, src, dst, n):
        plan = _color_plan_of("roundtrip32_rgb", planes, src, n, h2, w, h * w)
        return lib.sdct_roundtrip32_rgb(
            src, dst, ql.ctypes.data, qc.ctypes.data, qil.ctypes.data,
            qic.ctypes.data, _COLOR_MIX.ctypes.data, n, h2, w, h * w,
            plan.grid, plan.smem, _stream(planes))

    _launch("roundtrip32_rgb", (planes, out), batch, launch)
    return out


# -- the colour tile kernels' launch plan (csrc/color32.cu) -------------------

COLOR_TILE_BLOCKS = 16    # 8x8 blocks of one strip a tile (kTileBlocks)
COLOR_DEC_STAGES = 2      # record buffers the decode keeps in flight
COLOR_DEC_OUT_BUFFERS = 2   # the decode's pixel tile buffers
SMEM_LIMIT = 232448       # 227 KB: dynamic shared memory a CTA may take
_COLOR_SCALES = {"enc32_rgb": 2, "roundtrip32_rgb": 4, "dec32_rgb": 2}
_COLOR_TILE_IN = 24 * 8 * COLOR_TILE_BLOCKS      # 3 planes x 8 rows
_COLOR_TILE_REC = 3 * (COLOR_TILE_BLOCKS // 8) * 528   # padded records
_COLOR_CROSS = 3 * 64 * COLOR_TILE_BLOCKS * 4    # the crossing buffer
# input loads: one tensor copy a tile, or (the encode of a view whose base
# or plane stride is not a multiple of 16) the threads' 8-byte loads
_VARIANT_CODE = {"plain": 0, "tensor": 1}
_KIND_CODE = {"enc32_rgb": 0, "roundtrip32_rgb": 1, "dec32_rgb": 2}


class ColorPlan(NamedTuple):
    """A launch of ``enc32_rgb_kernel``, ``roundtrip32_rgb_kernel`` or
    ``dec32_rgb_kernel``."""
    variant: str          # "tensor" or "plain"
    tile_blocks: int      # 8x8 blocks a tile
    tiles_per_strip: int
    tail_blocks: int      # blocks of each strip's last tile
    tiles: int            # of the launch, over (frame, strip, tile)
    smem: int             # dynamic shared bytes of a CTA
    ctas_per_sm: int
    grid: int             # persistent CTAs, each taking every grid-th tile


def color_variant(base: int, plane_stride: int) -> str:
    """Tensor copies need 16-byte addresses and strides: every row of the
    input lies at base + k*plane_stride + a multiple of 64 (W % 64 == 0)."""
    return "tensor" if (base | plane_stride) % 16 == 0 else "plain"


def color_smem(kind: str) -> int:
    """Dynamic shared bytes of a CTA (``tile_smem`` and ``kDecSmem`` in
    color32.cu): the scales, the input tile (the decode: its
    ``COLOR_DEC_STAGES`` record buffers), two output tiles (records, or
    pixels for the round trip; the decode's ``COLOR_DEC_OUT_BUFFERS``)
    and the crossing buffer."""
    if kind == "dec32_rgb":
        return (_COLOR_SCALES[kind] * 256 + COLOR_DEC_STAGES * _COLOR_TILE_REC
                + COLOR_DEC_OUT_BUFFERS * _COLOR_TILE_IN + _COLOR_CROSS)
    out = _COLOR_TILE_IN if kind == "roundtrip32_rgb" else _COLOR_TILE_REC
    return (_COLOR_SCALES[kind] * 256 + _COLOR_TILE_IN + 2 * out
            + _COLOR_CROSS)


def color_plan(kind: str, batch: int, h2: int, w: int, *, base: int,
               plane_stride: int,
               capacity: Callable[[str], tuple[int, int]]) -> ColorPlan:
    """The launch for ``batch`` frames of a (3, h2, W) view whose input
    starts at address ``base`` with planes ``plane_stride`` bytes apart
    (the decode: its records, planes h2*W apart).  Tiles of
    ``COLOR_TILE_BLOCKS`` blocks never cross a strip (the last of a strip
    holds the rest); the variant follows the alignment (the round trip and
    the decode, whose wrappers take whole aligned tensors, have only tensor
    or bulk copies); ``capacity(variant)`` gives (CTAs of that launch an SM
    holds, SMs); the grid is as many CTAs as the card holds at once, at
    most one a tile."""
    if kind not in _KIND_CODE:
        raise ValueError(f"no tile plan for {kind!r}")
    variant = color_variant(base, plane_stride)
    if variant == "plain" and kind != "enc32_rgb":
        raise ValueError(f"{kind} needs 16-byte addresses and plane strides, "
                         f"got base {base} and plane stride {plane_stride}")
    smem = color_smem(kind)
    bw = w // 8
    tps = -(-bw // COLOR_TILE_BLOCKS)
    tiles = batch * (h2 // 8) * tps
    if tiles >= 1 << 31:
        raise ValueError(f"{kind}: {tiles} tiles in one launch exceed "
                         "2^31 - 1")
    per_sm, sms = capacity(variant)
    if per_sm < 1:
        raise ValueError(f"{kind}: no CTA of {smem} shared bytes fits an SM")
    return ColorPlan(variant, COLOR_TILE_BLOCKS, tps,
                     bw - (tps - 1) * COLOR_TILE_BLOCKS, tiles, smem, per_sm,
                     min(tiles, sms * per_sm))


@functools.lru_cache(maxsize=16)
def _color_capacity(device: int, kind: str, rounding: str,
                    variant: str) -> tuple[int, int]:
    lib = _build.load()
    out = np.zeros(3, np.int32)
    with torch.cuda.device(device):
        _build.check(lib, lib.sdct_color_capacity(
            _KIND_CODE[kind], _ROUNDING_CODE[rounding], _VARIANT_CODE[variant],
            out.ctypes.data, out.ctypes.data + 4, out.ctypes.data + 8),
            f"{kind} capacity")
    if int(out[0]) != color_smem(kind):
        raise RuntimeError(f"{kind}: the kernel lays out {int(out[0])} "
                           f"shared bytes, the plan {color_smem(kind)}")
    return int(out[1]), int(out[2])


def _color_plan_of(kind: str, t: torch.Tensor, base: int, batch: int,
                   h2: int, w: int, plane_stride: int,
                   rounding: str = "rne") -> ColorPlan:
    dev = _device_index(t)
    return color_plan(kind, batch, h2, w, base=base, plane_stride=plane_stride,
                      capacity=lambda v: _color_capacity(dev, kind, rounding,
                                                         v))


def color_launch_plan(kind: str, t: torch.Tensor, rounding: str = "rne", *,
                      size_x: int | None = None) -> ColorPlan:
    """The plan ``encode_quantize32_ycbcr`` (kind "enc32_rgb") or
    ``roundtrip_quantize32_ycbcr`` ("roundtrip32_rgb") launches for a
    (3, H, W) or (B, 3, H, W) CUDA tensor, or ``decode_quantize32_ycbcr``
    ("dec32_rgb") for (3, H2*W) or (B, 3, H2*W) records of width
    ``size_x``; at most 65,535 frames."""
    if kind == "dec32_rgb":
        if size_x is None:
            raise ValueError("the dec32_rgb plan needs size_x")
        h2, w = t.shape[-1] // size_x, size_x
        return _color_plan_of(kind, t, t.data_ptr(), _batch_of(t, 2), h2, w,
                              h2 * w, rounding)
    h, w = t.shape[-2:]
    return _color_plan_of(kind, t, t.data_ptr(), _batch_of(t, 3), h // 2, w,
                          h * w, rounding)


# -- the 4:2:0 kernels' launch plan (csrc/color420.cu) ------------------------

COLOR420_TILE_MACROBLOCKS = 8   # 16x16 macroblocks of one row a tile
COLOR420_STAGES = 1             # input tiles the encode keeps in flight
COLOR420_REC_BUFFERS = 1        # its record staging buffers
COLOR420_DEC_STAGES = 2         # record buffers the decode keeps in flight
COLOR420_DEC_OUT_BUFFERS = 1    # its pixel tile buffers
_COLOR420_TILE_IN = 3 * 16 * 128                 # 3 planes x 16 rows
_COLOR420_TILE_REC = 6 * 528                     # 4 Y groups, Cb, Cr: padded
_COLOR420_CROSS = 4 * (2 * 64 * 16 + 2 * 64 * 16)   # Y, pooled, chroma (f32)
# the decode's: Y and chroma crossings, the chroma values (2 x 8 x 64 f32)
_COLOR420_DEC_CROSS = 4 * (2 * 64 * 16 + 64 * 16 + 2 * 8 * 64)
_COLOR420_KINDS = ("enc420_rgb", "dec420_rgb")


class Color420Plan(NamedTuple):
    """A launch of ``enc420_rgb_kernel`` or ``dec420_rgb_kernel``."""
    tile_macroblocks: int   # 16x16 macroblocks of one macroblock row a tile
    tiles_per_row: int      # of a macroblock row: W / 128
    tail_macroblocks: int   # macroblocks of each row's last tile
    tiles: int              # of the launch, over (frame, row, tile)
    smem: int               # dynamic shared bytes of a CTA
    ctas_per_sm: int
    grid: int               # persistent CTAs, each taking every grid-th tile


def color420_smem(kind: str = "enc420_rgb") -> int:
    """Dynamic shared bytes of a CTA (``k420Smem`` and ``k420DecSmem`` in
    color420.cu).  The encode: luma and chroma scales,
    ``COLOR420_STAGES`` input tiles, ``COLOR420_REC_BUFFERS`` record
    buffers and the Y crossing, pooled chroma and chroma crossing buffers.
    The decode: the scales, ``COLOR420_DEC_OUT_BUFFERS`` pixel tiles,
    ``COLOR420_DEC_STAGES`` record buffers, the Y and chroma crossings and
    the chroma values."""
    if kind == "dec420_rgb":
        return (2 * 256 + COLOR420_DEC_OUT_BUFFERS * _COLOR420_TILE_IN
                + COLOR420_DEC_STAGES * _COLOR420_TILE_REC
                + _COLOR420_DEC_CROSS)
    return (2 * 256 + COLOR420_STAGES * _COLOR420_TILE_IN
            + COLOR420_REC_BUFFERS * _COLOR420_TILE_REC + _COLOR420_CROSS)


def color420_plan(kind: str, batch: int, h2: int, w: int, *, base: int,
                  plane_stride: int,
                  capacity: Callable[[], tuple[int, int]]) -> Color420Plan:
    """The launch of the 4:2:0 encode (kind "enc420_rgb") for ``batch``
    frames of a (3, h2, W) view at address ``base``, planes
    ``plane_stride`` bytes apart (both multiples of 16: one tensor copy a
    tile), or of the decode ("dec420_rgb") of ``batch`` streams at address
    ``base`` into (3, h2, W) frames, whose planes are h2*W bytes apart
    (``plane_stride`` must say so).  A tile is
    ``COLOR420_TILE_MACROBLOCKS`` macroblocks of one macroblock row, 16
    rows x 128 columns; W % 128 == 0 makes every row a whole number of
    tiles.  ``capacity()`` gives (CTAs an SM holds, SMs); the grid is as
    many CTAs as the card holds at once, at most one a tile."""
    if kind not in _COLOR420_KINDS:
        raise ValueError(f"no 4:2:0 tile plan for {kind!r}")
    if (base | plane_stride) % 16:
        raise ValueError(f"{kind} needs 16-byte addresses and plane strides, "
                         f"got base {base} and plane stride {plane_stride}")
    if h2 % 16 or w % 128:
        raise ValueError(f"{kind} needs H2 % 16 == 0 and W % 128 == 0, got "
                         f"H2={h2}, W={w}")
    if kind == "dec420_rgb" and plane_stride != h2 * w:
        raise ValueError(f"{kind} writes planes H2*W = {h2 * w} bytes apart, "
                         f"not {plane_stride}")
    smem = color420_smem(kind)
    mbw = w // 16
    tpr = mbw // COLOR420_TILE_MACROBLOCKS
    tiles = batch * (h2 // 16) * tpr
    if tiles >= 1 << 31:
        raise ValueError(f"{kind}: {tiles} tiles in one launch exceed "
                         "2^31 - 1")
    per_sm, sms = capacity()
    if per_sm < 1:
        raise ValueError(f"{kind}: no CTA of {smem} shared bytes fits an SM")
    return Color420Plan(COLOR420_TILE_MACROBLOCKS, tpr,
                        mbw - (tpr - 1) * COLOR420_TILE_MACROBLOCKS, tiles,
                        smem, per_sm, min(tiles, sms * per_sm))


@functools.lru_cache(maxsize=16)
def _color420_capacity(device: int, kind: str,
                       rounding: str) -> tuple[int, int]:
    lib = _build.load()
    out = np.zeros(3, np.int32)
    ptrs = (out.ctypes.data, out.ctypes.data + 4, out.ctypes.data + 8)
    with torch.cuda.device(device):
        rc = (lib.sdct_dec420_capacity(*ptrs) if kind == "dec420_rgb" else
              lib.sdct_color420_capacity(_ROUNDING_CODE[rounding], *ptrs))
        _build.check(lib, rc, f"{kind} capacity")
    if int(out[0]) != color420_smem(kind):
        raise RuntimeError(f"{kind}: the kernel lays out {int(out[0])} "
                           f"shared bytes, the plan {color420_smem(kind)}")
    return int(out[1]), int(out[2])


def _color420_plan_of(t: torch.Tensor, base: int, batch: int, h2: int,
                      w: int, plane_stride: int, rounding: str = "rne",
                      kind: str = "enc420_rgb") -> Color420Plan:
    dev = _device_index(t)
    return color420_plan(kind, batch, h2, w, base=base,
                         plane_stride=plane_stride,
                         capacity=lambda: _color420_capacity(dev, kind,
                                                             rounding))


def color420_launch_plan(planes: torch.Tensor, rounding: str = "rne", *,
                         size_x: int | None = None) -> Color420Plan:
    """The plan ``encode_quantize32_ycbcr420`` launches for a (3, H, W) or
    (B, 3, H, W) CUDA tensor of at most 65,535 frames; with ``size_x``,
    the plan ``decode_quantize32_ycbcr420`` launches for ``planes``, then
    (1.5*H2*W,) or (B, 1.5*H2*W) streams of that width."""
    if size_x is not None:
        h2 = planes.shape[-1] * 2 // (3 * size_x)
        return _color420_plan_of(planes, planes.data_ptr(),
                                 _batch_of(planes, 1), h2, size_x,
                                 h2 * size_x, kind="dec420_rgb")
    h, w = planes.shape[-2:]
    return _color420_plan_of(planes, planes.data_ptr(), _batch_of(planes, 3),
                             h // 2, w, h * w, rounding)


def encode_quantize32_ycbcr420(planes: torch.Tensor, luma, chroma,
                               rounding: str = "rne") -> torch.Tensor:
    """Colour 4:2:0 encode of the TOP view of a (3, H, W) or (B, 3, H, W)
    planar RGB dual-view image -> (1.5*H/2*W,) or (B, 1.5*H/2*W) u8 streams
    [Y | Cb | Cr] (Y with ``luma``, the 2x2-pooled Cb and Cr with
    ``chroma``); one launch per 65,535 frames."""
    _check_planes(planes, "planes")
    h, w = planes.shape[-2:]
    _check_geometry("enc_quant32_ycbcr420", h, w)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if planes.device.type == "cpu":
        return _tp.encode_ycbcr420(planes, luma, chroma, rounding)
    h2 = h // 2
    out = torch.empty(planes.shape[:-3] + (record_bytes_420(h2, w),),
                      dtype=torch.uint8, device=planes.device)
    _enc420_rgb(planes, out, _batch_of(planes, 3), h2, w, h * w, luma,
                chroma, rounding)
    return out


def _enc420_rgb(src: torch.Tensor, out: torch.Tensor, batch: int, h2: int,
                w: int, plane_stride: int, luma, chroma,
                rounding: str) -> None:
    if out.numel() == 0:
        return
    ql, _ = _host_scales(luma)
    qc, _ = _host_scales(chroma)

    def launch(lib, src_p, dst_p, n):
        plan = _color420_plan_of(src, src_p, n, h2, w, plane_stride, rounding)
        return lib.sdct_enc420_rgb(
            src_p, dst_p, ql.ctypes.data, qc.ctypes.data,
            _COLOR_MIX.ctypes.data, n, h2, w, plane_stride,
            _ROUNDING_CODE[rounding], plan.grid, plan.smem, _stream(src))

    _launch("enc420_rgb", (src, out), batch, launch,
            frame_bytes=[3 * plane_stride, record_bytes_420(h2, w)])


def decode_quantize32_ycbcr420(data: torch.Tensor, luma, chroma, size_x: int,
                               size_y: int) -> torch.Tensor:
    """Colour 4:2:0 streams, (1.5*size_y/2*size_x,) or (B, 1.5*size_y/2*
    size_x) u8 -> (3, size_y/2, size_x) or (B, 3, size_y/2, size_x) u8
    planar RGB."""
    _check_tensor(data, "data", (1, 2))
    _check_geometry("dec_quant32_ycbcr420", size_y, size_x)
    h2 = size_y // 2
    n = record_bytes_420(h2, size_x)
    if data.shape[-1] != n:
        raise ValueError(f"expected {n} record bytes per frame, got "
                         f"{data.shape[-1]}")
    if data.device.type == "cpu":
        return _tp.decode_ycbcr420(data, luma, chroma, size_x, size_y)
    batch = _batch_of(data, 1)
    out = torch.empty(data.shape[:-1] + (3, h2, size_x), dtype=torch.uint8,
                      device=data.device)
    if out.numel() == 0:
        return out
    _, qil = _host_scales(luma)
    _, qic = _host_scales(chroma)

    def launch(lib, src, dst, n):
        plan = _color420_plan_of(data, src, n, h2, size_x, h2 * size_x,
                                 kind="dec420_rgb")
        return lib.sdct_dec420_rgb(
            src, dst, qil.ctypes.data, qic.ctypes.data,
            _COLOR_MIX.ctypes.data, n, h2, size_x, plan.grid, plan.smem,
            _stream(data))

    _launch("dec420_rgb", (data, out), batch, launch)
    return out


# -- bare views: the shards of ``dist`` ---------------------------------------

def _lead_stride(t: torch.Tensor) -> int:
    h2, w = t.shape[-2:]
    return t.stride(0) if t.ndim == 3 and t.shape[0] > 1 else h2 * w


def encode32_view(view: torch.Tensor, lut,
                  rounding: str = "rne") -> torch.Tensor:
    """Mode32 encode of a bare (H2, W) view, or a (B, H2, W) batch of them,
    -> (H2*W,) or (B, H2*W) u8 records (every strip).  The rows must be
    contiguous, the frames may lie a stride apart: a shard's row range of
    a top view or of a batch of frames goes in as it is."""
    _check_tensor(view, "view", (2, 3), strided_lead=True)
    h2, w = view.shape[-2:]
    _check_geometry("enc_quant32", 2 * h2, w)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if view.device.type == "cpu":
        return _tp.encode32_view(view, lut, rounding)
    out = torch.empty(view.shape[:-2] + (h2 * w,), dtype=torch.uint8,
                      device=view.device)
    _enc32(view, out, h2, w, _lead_stride(view), lut, 0, _I32_MAX, rounding)
    return out


def decode32_view(records: torch.Tensor, lut) -> torch.Tensor:
    """Mode32 records as strips, (S, 8W) or (B, S, 8W) u8 -> the (8S, W) or
    (B, 8S, W) u8 view (``decode_quantize32`` of the flat records)."""
    _check_tensor(records, "records", (2, 3))
    s, row = records.shape[-2:]
    if row % 8:
        raise ValueError(f"a strip of records is 8*W bytes, got {row}")
    return decode_quantize32(records.reshape(records.shape[:-2] + (s * row,)),
                             lut, row // 8, 16 * s)


def encode_stereo_view(views: torch.Tensor, lut, rounding: str = "rne",
                       view_layout: str = "interleaved", *,
                       variant: str | None = None) -> torch.Tensor:
    """Stereo encode of a bare (2, H2, W) pair of views -- one row range of
    the top view and the same of the bottom view, rows contiguous, the two
    a stride apart (a shard's strips of a dual-view image go in as they
    are) -> the records ``encode_quantize_stereo`` gives for the (2*H2, W)
    image they make; one launch.  The base and the view stride need only
    be multiples of 8: where either is not a multiple of 16 the plan takes
    the plain variant (``stereo_plan``)."""
    _check_tensor(views, "views", (3,), strided_lead=True, align=8)
    if views.shape[0] != 2:
        raise ValueError(f"views must be (2, H2, W), got shape "
                         f"{tuple(views.shape)}")
    h2, w = views.shape[-2:]
    h = 2 * h2
    frame = L_stereo.record_shape(view_layout, h, w)
    _check_geometry("enc_quant_stereo", h, w)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if views.device.type == "cpu":
        return _tp.encode_quantize_stereo(views.reshape(h, w), lut, 0,
                                          1 << 30, rounding, view_layout)
    out = torch.empty(frame, dtype=torch.uint8, device=views.device)
    _enc_stereo(views, out, 1, h, w, _lead_stride(views), lut, 0, 1 << 30,
                rounding, view_layout, variant)
    return out


def _check_rgb_view(view, geometry: str,
                    align: int = 16) -> tuple[int, int]:
    _check_tensor(view, "view", (3,), strided_lead=True, align=align)
    if view.shape[0] != 3:
        raise ValueError(f"view must be (3, H2, W) planar RGB, got shape "
                         f"{tuple(view.shape)}")
    h2, w = view.shape[-2:]
    _check_geometry(geometry, 2 * h2, w)
    return h2, w


def encode32_rgb_view(view: torch.Tensor, luma, chroma,
                      rounding: str = "rne") -> torch.Tensor:
    """Colour mode32 encode of a bare (3, H2, W) planar RGB view, whose
    planes may lie a stride apart (a shard's rows of a (3, H, W) image) ->
    (3, H2*W) u8 records; one launch.  The base and the plane stride need
    only be multiples of 8: where either is not a multiple of 16 the plan
    takes the plain-load variant (``color_plan``)."""
    h2, w = _check_rgb_view(view, "enc_quant32_ycbcr", align=8)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if view.device.type == "cpu":
        return _tp.encode_ycbcr32_view(view, luma, chroma, rounding)
    out = torch.empty((3, h2 * w), dtype=torch.uint8, device=view.device)
    _enc32_rgb(view, out, 1, h2, w, _lead_stride(view), luma, chroma,
               rounding)
    return out


def encode420_rgb_view(view: torch.Tensor, luma, chroma,
                       rounding: str = "rne") -> torch.Tensor:
    """Colour 4:2:0 encode of a bare (3, H2, W) planar RGB view, planes a
    stride apart as for ``encode32_rgb_view`` -> the (1.5*H2*W,) u8 stream
    [Y | Cb | Cr]; one launch."""
    h2, w = _check_rgb_view(view, "enc_quant32_ycbcr420")
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if view.device.type == "cpu":
        return _tp.encode_ycbcr420_view(view, luma, chroma, rounding)
    out = torch.empty((record_bytes_420(h2, w),), dtype=torch.uint8,
                      device=view.device)
    _enc420_rgb(view, out, 1, h2, w, _lead_stride(view), luma, chroma,
                rounding)
    return out


def _host_f32(scales, n: int = 64) -> np.ndarray:
    """``n`` scales (array-like, or a tensor on any device) as contiguous
    host f32, the form the kernels take by value."""
    if isinstance(scales, torch.Tensor):
        scales = scales.detach().cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(scales, np.float32).reshape(-1))
    if arr.size != n:
        raise ValueError(f"expected {n} scales, got {arr.size}")
    return arr


def _check_tile_options(orientation: str, rounding: str = "rne") -> None:
    L_reorder.check_orientation(orientation)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")


def _check_tile_geometry(h2: int, w: int) -> None:
    if not _panel.supports(h2, w):
        raise ValueError(f"tiles need H2 % 128 == 0 and W % 128 == 0, got "
                         f"H2={h2}, W={w}")


# -- the tile kernels' launch plans (csrc/tiles.cu) ---------------------------

STRIP_BLOCK_ROWS = 2         # block rows of one 128x128 tile a strip tile
STRIP_TILE_BLOCKS = STRIP_BLOCK_ROWS * _panel.TILE // 8   # 32 blocks
TILES_STAGES = 1             # the tile kernel's pixel tiles in flight
TILES_OUT_BUFFERS = 1        # its Z buffers
DETILE_STAGES = 1            # the tile inverse's input tiles in flight
DETILE_OUT_BUFFERS = 1       # its pixel tile buffers
_STRIP_BYTES = 16 * _panel.TILE   # a strip tile's Z rows, or pixel rows
_STRIP_CROSS = 4 * 64 * STRIP_TILE_BLOCKS   # the f32 crossing buffer


class StripTilePlan(NamedTuple):
    """A launch of ``tiles_kernel`` or ``detile_kernel``."""
    tile_blocks: int      # 8x8 blocks a strip tile: 2 block rows x 16
    tiles_per_view: int   # strip tiles a (H2, W) view: H2/16 x W/128
    tiles: int            # of the launch: (frame, 128-row band, q, column)
    smem: int             # dynamic shared bytes of a CTA
    ctas_per_sm: int
    grid: int             # persistent CTAs, each taking every grid-th tile


def tiles_smem() -> int:
    """Dynamic shared bytes of a tile kernel CTA (``kTilesSmem`` in
    tiles.cu): the 64 scales, ``TILES_OUT_BUFFERS`` Z buffers,
    ``TILES_STAGES`` pixel tiles (2 KB each) and the f32 crossing
    buffer."""
    return (256 + (TILES_OUT_BUFFERS + TILES_STAGES) * _STRIP_BYTES
            + _STRIP_CROSS)


def detile_smem() -> int:
    """Dynamic shared bytes of a tile inverse CTA (``kDetileSmem`` in
    tiles.cu): the 64 scales, ``DETILE_OUT_BUFFERS`` pixel tiles,
    ``DETILE_STAGES`` input tiles (2 KB each) and the f32 crossing
    buffer."""
    return (256 + (DETILE_OUT_BUFFERS + DETILE_STAGES) * _STRIP_BYTES
            + _STRIP_CROSS)


def _strip_plan(kind: str, smem: int, batch: int, h2: int, w: int, base: int,
                capacity: Callable[[], tuple[int, int]]) -> StripTilePlan:
    if base % 16:
        raise ValueError(f"{kind} needs a 16-byte address, got {base}")
    if not _panel.supports(h2, w):
        raise ValueError(f"{kind} needs H2 % 128 == 0 and W % 128 == 0, got "
                         f"H2={h2}, W={w}")
    per_view = (h2 // (8 * STRIP_BLOCK_ROWS)) * (w // _panel.TILE)
    tiles = batch * per_view
    if tiles >= 1 << 31:
        raise ValueError(f"{kind}: {tiles} tiles in one launch exceed "
                         "2^31 - 1")
    per_sm, sms = capacity()
    if per_sm < 1:
        raise ValueError(f"{kind}: no CTA of {smem} shared bytes fits an SM")
    return StripTilePlan(STRIP_TILE_BLOCKS, per_view, tiles, smem, per_sm,
                         min(tiles, sms * per_sm))


def tiles_plan(batch: int, h2: int, w: int, *, base: int,
               capacity: Callable[[], tuple[int, int]]) -> StripTilePlan:
    """The launch of the tile kernel for ``batch`` (H2, W) u8 views at
    address ``base`` (a multiple of 16: one tensor copy a strip tile in,
    one tensor store out).  A strip tile is block rows 2q and 2q + 1 of one
    128x128 tile; H2 % 128 == 0 and W % 128 == 0 leave no part tile.
    ``capacity()`` gives (CTAs an SM holds, SMs); the grid is as many CTAs
    as the card holds at once, at most one a tile."""
    return _strip_plan("tiles", tiles_smem(), batch, h2, w, base, capacity)


def detile_plan(batch: int, h2: int, w: int, *, base: int,
                capacity: Callable[[], tuple[int, int]]) -> StripTilePlan:
    """The launch of the tile inverse for ``batch`` (H2/128, 128, W/128,
    128) tile frames at address ``base`` (a multiple of 16), in the strip
    tiles of ``tiles_plan``."""
    return _strip_plan("detile", detile_smem(), batch, h2, w, base, capacity)


@functools.lru_cache(maxsize=32)
def _tiles_capacity(device: int, rounding: str, normalize: bool,
                    orientation: str) -> tuple[int, int]:
    lib = _build.load()
    out = np.zeros(3, np.int32)
    with torch.cuda.device(device):
        _build.check(lib, lib.sdct_tiles_capacity(
            _ROUNDING_CODE[rounding], int(normalize),
            _ORIENTATION_CODE[orientation], out.ctypes.data,
            out.ctypes.data + 4, out.ctypes.data + 8), "tiles capacity")
    return _check_capacity("tiles", out, tiles_smem())


@functools.lru_cache(maxsize=16)
def _detile_capacity(device: int, normalize: bool,
                     orientation: str) -> tuple[int, int]:
    lib = _build.load()
    out = np.zeros(3, np.int32)
    with torch.cuda.device(device):
        _build.check(lib, lib.sdct_detile_capacity(
            int(normalize), _ORIENTATION_CODE[orientation], out.ctypes.data,
            out.ctypes.data + 4, out.ctypes.data + 8), "detile capacity")
    return _check_capacity("detile", out, detile_smem())


def _tiles_plan_of(t: torch.Tensor, base: int, batch: int, h2: int, w: int,
                   rounding: str, normalize: bool,
                   orientation: str) -> StripTilePlan:
    dev = _device_index(t)
    return tiles_plan(batch, h2, w, base=base,
                      capacity=lambda: _tiles_capacity(
                          dev, rounding, bool(normalize), orientation))


def _detile_plan_of(t: torch.Tensor, base: int, batch: int, h2: int, w: int,
                    normalize: bool, orientation: str) -> StripTilePlan:
    dev = _device_index(t)
    return detile_plan(batch, h2, w, base=base,
                       capacity=lambda: _detile_capacity(dev, bool(normalize),
                                                         orientation))


def tiles_launch_plan(view: torch.Tensor, rounding: str = "rne",
                      normalize: bool = False,
                      orientation: str = "fy") -> StripTilePlan:
    """The plan ``tiles_panels`` launches for a (..., H2, W) CUDA view of at
    most 65,535 frames."""
    h2, w = view.shape[-2:]
    return _tiles_plan_of(view, view.data_ptr(), view.numel() // (h2 * w),
                          h2, w, rounding, normalize, orientation)


def detile_launch_plan(tiles: torch.Tensor, normalize: bool = False,
                       orientation: str = "fy") -> StripTilePlan:
    """The plan ``detile_panels`` launches for a (..., P, 128, NJ, 128)
    CUDA tensor of at most 65,535 frames."""
    p, _, nj, _ = tiles.shape[-4:]
    h2, w = p * _panel.TILE, nj * _panel.TILE
    return _detile_plan_of(tiles, tiles.data_ptr(),
                           tiles.numel() // (h2 * w), h2, w, normalize,
                           orientation)


def tiles_panels(view: torch.Tensor, scales, *, normalize: bool,
                 rounding: str, orientation: str) -> torch.Tensor:
    """The tile kernel: a (..., H2, W) u8 view (no more than two leading
    axes, e.g. a batch of frames, each holding both stereo views) ->
    (..., P, 128, NJ, 128) u8 quantized coefficient tiles in the panel
    engine's natural Z layout (``kernels/panel.py``).  ``scales``: the 64
    quant scales in the orientation's buffer order
    (``core.quantize.quant_scales`` of the LUT), as ``_tiles_panels``
    takes them; host arrays are best, since scales on the card are copied
    to the host first (a synchronisation).  One launch per 65,535
    frames."""
    _check_tensor(view, "view", (2, 3, 4))
    h2, w = view.shape[-2:]
    _check_tile_geometry(h2, w)
    _check_tile_options(orientation, rounding)
    q = _host_f32(scales)
    if view.device.type == "cpu":
        return _panel.forward_tiles(view, q, normalize=normalize,
                                    orientation=orientation,
                                    rounding=rounding)
    p, nj = h2 // _panel.TILE, w // _panel.TILE
    out = torch.empty(view.shape[:-2] + (p, _panel.TILE, nj, _panel.TILE),
                      dtype=torch.uint8, device=view.device)
    if out.numel() == 0:
        return out

    def launch(lib, src, dst, n):
        plan = _tiles_plan_of(view, src, n, h2, w, rounding, normalize,
                              orientation)
        return lib.sdct_tiles(src, dst, q.ctypes.data, n, h2, w,
                              int(bool(normalize)),
                              _ORIENTATION_CODE[orientation],
                              _ROUNDING_CODE[rounding], plan.grid, plan.smem,
                              _stream(view))

    _launch("tiles", (view, out), view.numel() // (h2 * w), launch)
    return out


def detile_panels(tiles: torch.Tensor, inv_scales, *, normalize: bool,
                  orientation: str) -> torch.Tensor:
    """The detile kernel, the inverse of ``tiles_panels``:
    (..., P, 128, NJ, 128) u8 tiles -> (..., H2, W) u8 pixels.
    ``inv_scales``: the 64 dequant scales in the orientation's buffer order
    (``core.quantize.dequant_scales``).  One launch per 65,535 frames."""
    _check_tensor(tiles, "tiles", (4, 5, 6))
    p, rows, nj, cols = tiles.shape[-4:]
    if rows != _panel.TILE or cols != _panel.TILE:
        raise ValueError(f"expected (..., P, 128, NJ, 128) tiles, got "
                         f"{tuple(tiles.shape)}")
    h2, w = p * _panel.TILE, nj * _panel.TILE
    _check_tile_geometry(h2, w)
    _check_tile_options(orientation)
    qi = _host_f32(inv_scales)
    if tiles.device.type == "cpu":
        return _panel.inverse_tiles(tiles, qi, normalize=normalize,
                                    orientation=orientation)
    out = torch.empty(tiles.shape[:-4] + (h2, w), dtype=torch.uint8,
                      device=tiles.device)
    if out.numel() == 0:
        return out

    def launch(lib, src, dst, n):
        plan = _detile_plan_of(tiles, src, n, h2, w, normalize, orientation)
        return lib.sdct_detile(src, dst, qi.ctypes.data, n, h2, w,
                               int(bool(normalize)),
                               _ORIENTATION_CODE[orientation], plan.grid,
                               plan.smem, _stream(tiles))

    _launch("detile", (tiles, out), tiles.numel() // (h2 * w), launch)
    return out


def probe_trial(x: torch.Tensor) -> torch.Tensor:
    """The tier probe's trial kernel: u8 + 1, clipped, on a 2-D u8 tensor."""
    _check_tensor(x, "x", (2,))
    if x.device.type == "cpu":
        return _tp.probe_trial(x)
    if x.numel() > _I32_MAX:
        raise ValueError("probe input too large")
    out = torch.empty_like(x)
    lib = _build.load()
    with _on_device_of(x):
        rc = lib.sdct_probe(x.data_ptr(), out.data_ptr(), x.numel(),
                            _stream(x))
        LAUNCHES["probe"] += 1
    _build.check(lib, rc, "probe")
    return out
