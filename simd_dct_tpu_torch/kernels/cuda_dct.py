"""Wrappers around the hand-written CUDA kernels: mode32 (``csrc/dct32.cu``),
enc-quant (``csrc/encq.cu``), stereo (``csrc/stereo.cu``), YCbCr 4:4:4
colour (``csrc/color32.cu``), YCbCr 4:2:0 colour (``csrc/color420.cu``) and
the panel engine's tiles (``csrc/tiles.cu``).

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
            "enc420_rgb": 0, "dec420_rgb": 0, "tiles": 0, "detile": 0}

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


def _check_tensor(t, name: str, ndims: tuple[int, ...]) -> None:
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
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


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
            launch) -> None:
    """Launch kernel ``name`` once per slice of ``batch_slices(batch)``:
    ``launch(lib, src, dst, frames)`` gets the pointers of ``tensors``
    (input, output; each ``batch`` contiguous frames) advanced to the
    slice's first frame.  Each launch adds one to ``LAUNCHES[name]``, so a
    batch of more than ``_MAX_BATCH`` frames counts more than one; a launch
    that returns a CUDA error raises."""
    lib = _build.load()
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


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


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
    batch = _batch_of(img, 2)
    h2 = h // 2
    out = torch.empty(img.shape[:-2] + (h2 * w,), dtype=torch.uint8,
                      device=img.device)
    if out.numel() == 0:
        return out
    q, _ = _host_scales(lut)
    _launch("enc32", (img, out), batch,
            lambda lib, src, dst, n: lib.sdct_enc32(
                src, dst, q.ctypes.data, n, h2, w, h * w,
                _clamp_i32(start_y), _clamp_i32(end_y),
                _ROUNDING_CODE[rounding], _stream(img)))
    return out


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
    _launch("dec32", (data, out), batch,
            lambda lib, src, dst, n: lib.sdct_dec32(
                src, dst, qi.ctypes.data, n, h2, size_x, _stream(data)))
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
    _launch("roundtrip32", (img, out), batch,
            lambda lib, src, dst, n: lib.sdct_roundtrip32(
                src, dst, q.ctypes.data, qi.ctypes.data, n, h2, w, h * w,
                _stream(img)))
    return out


def encode_quantize(img: torch.Tensor, lut, start_y: int = 0,
                    end_y: int = 1 << 30, rounding: str = "rne",
                    layout: str = "scalar",
                    legacy_range: bool = False) -> torch.Tensor:
    """Enc-quant encode of the TOP view of a (H, W) or (B, H, W) dual-view
    image -> (H/2*W,) or (B, H/2*W) u8 records in ``layout``; one launch
    per 65,535 frames."""
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
    _launch("encq", (img, out), batch,
            lambda lib, src, dst, n: lib.sdct_encq(
                src, dst, q.ctypes.data, n, h2, w, h * w,
                _clamp_i32(start_y), _clamp_i32(end_y), int(legacy_range),
                _ROUNDING_CODE[rounding], _LAYOUT_CODE[layout], _stream(img)))
    return out


def decode_quantize(data: torch.Tensor, lut, size_x: int, size_y: int,
                    layout: str = "scalar") -> torch.Tensor:
    """Enc-quant records in the ``scalar`` or ``pair`` layout,
    (size_y/2*size_x,) or (B, size_y/2*size_x) u8 -> (size_y/2, size_x) or
    (B, size_y/2, size_x) u8 pixels."""
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
    _launch("decq", (data, out), batch,
            lambda lib, src, dst, n: lib.sdct_decq(
                src, dst, qi.ctypes.data, n, h2, size_x, _LAYOUT_CODE[layout],
                _stream(data)))
    return out


def encode_quantize_stereo(img: torch.Tensor, lut, start_y: int = 0,
                           end_y: int = 1 << 30, rounding: str = "rne",
                           view_layout: str = "interleaved") -> torch.Tensor:
    """Stereo encode of both views of a (H, W) or (B, H, W) dual-view image
    -> records in ``view_layout``: (..., H*W) interleaved,
    (..., 2, 64, H/16, W/8) planar or (..., 2, 64, H/16, BWP) native u8;
    one launch per 65,535 frames."""
    _check_tensor(img, "img", (2, 3))
    h, w = img.shape[-2:]
    frame = L_stereo.record_shape(view_layout, h, w)
    _check_geometry("enc_quant_stereo", h, w)
    if rounding not in ROUNDING_MODES:
        raise ValueError(f"rounding must be one of {ROUNDING_MODES}")
    if img.device.type == "cpu":
        return _tp.encode_quantize_stereo(img, lut, start_y, end_y, rounding,
                                          view_layout)
    batch = _batch_of(img, 2)
    out = torch.empty(img.shape[:-2] + frame, dtype=torch.uint8,
                      device=img.device)
    if out.numel() == 0:
        return out
    q, _ = _host_scales(lut)
    _launch("enc_stereo", (img, out), batch,
            lambda lib, src, dst, n: lib.sdct_enc_stereo(
                src, dst, q.ctypes.data, n, h, w,
                L_stereo.native_stereo_bwp(w), _clamp_i32(start_y),
                _clamp_i32(end_y), _ROUNDING_CODE[rounding],
                _VIEW_LAYOUT_CODE[view_layout], _stream(img)))
    return out


def decode_quantize_stereo(data: torch.Tensor, lut, size_x: int, size_y: int,
                           view_layout: str = "interleaved") -> torch.Tensor:
    """Stereo records in ``view_layout`` (one frame's shape as
    ``encode_quantize_stereo`` returns it, with an optional batch axis) ->
    (size_y, size_x) or (B, size_y, size_x) u8 pixels of both views."""
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
    _launch("dec_stereo", (data, out), batch,
            lambda lib, src, dst, n: lib.sdct_dec_stereo(
                src, dst, qi.ctypes.data, n, size_y, size_x,
                L_stereo.native_stereo_bwp(size_x),
                _VIEW_LAYOUT_CODE[view_layout], _stream(data)))
    return out


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
    batch = _batch_of(planes, 3)
    h2 = h // 2
    out = torch.empty(planes.shape[:-2] + (h2 * w,), dtype=torch.uint8,
                      device=planes.device)
    if out.numel() == 0:
        return out
    ql, _ = _host_scales(luma)
    qc, _ = _host_scales(chroma)
    _launch("enc32_rgb", (planes, out), batch,
            lambda lib, src, dst, n: lib.sdct_enc32_rgb(
                src, dst, ql.ctypes.data, qc.ctypes.data,
                _COLOR_MIX.ctypes.data, n, h2, w, h * w,
                _ROUNDING_CODE[rounding], _stream(planes)))
    return out


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
    _launch("dec32_rgb", (data, out), batch,
            lambda lib, src, dst, n: lib.sdct_dec32_rgb(
                src, dst, qil.ctypes.data, qic.ctypes.data,
                _COLOR_MIX.ctypes.data, n, h2, size_x, _stream(data)))
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
    _launch("roundtrip32_rgb", (planes, out), batch,
            lambda lib, src, dst, n: lib.sdct_roundtrip32_rgb(
                src, dst, ql.ctypes.data, qc.ctypes.data, qil.ctypes.data,
                qic.ctypes.data, _COLOR_MIX.ctypes.data, n, h2, w, h * w,
                _stream(planes)))
    return out


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
    batch = _batch_of(planes, 3)
    h2 = h // 2
    out = torch.empty(planes.shape[:-3] + (record_bytes_420(h2, w),),
                      dtype=torch.uint8, device=planes.device)
    if out.numel() == 0:
        return out
    ql, _ = _host_scales(luma)
    qc, _ = _host_scales(chroma)
    _launch("enc420_rgb", (planes, out), batch,
            lambda lib, src, dst, n: lib.sdct_enc420_rgb(
                src, dst, ql.ctypes.data, qc.ctypes.data,
                _COLOR_MIX.ctypes.data, n, h2, w, h * w,
                _ROUNDING_CODE[rounding], _stream(planes)))
    return out


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
    _launch("dec420_rgb", (data, out), batch,
            lambda lib, src, dst, n: lib.sdct_dec420_rgb(
                src, dst, qil.ctypes.data, qic.ctypes.data,
                _COLOR_MIX.ctypes.data, n, h2, size_x, _stream(data)))
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
    _launch("tiles", (view, out), view.numel() // (h2 * w),
            lambda lib, src, dst, n: lib.sdct_tiles(
                src, dst, q.ctypes.data, n, h2, w, int(bool(normalize)),
                _ORIENTATION_CODE[orientation], _ROUNDING_CODE[rounding],
                _stream(view)))
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
    _launch("detile", (tiles, out), tiles.numel() // (h2 * w),
            lambda lib, src, dst, n: lib.sdct_detile(
                src, dst, qi.ctypes.data, n, h2, w, int(bool(normalize)),
                _ORIENTATION_CODE[orientation], _stream(tiles)))
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
