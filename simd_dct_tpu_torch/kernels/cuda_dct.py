"""Wrappers around the hand-written CUDA kernels: mode32 (``csrc/dct32.cu``),
enc-quant (``csrc/encq.cu``), stereo (``csrc/stereo.cu``), YCbCr 4:4:4
colour (``csrc/color32.cu``) and YCbCr 4:2:0 colour (``csrc/color420.cu``).

Counterpart of ``simd_dct_tpu/kernels/pallas_dct.py`` (``encode_quantize32``
/ ``decode_quantize32`` / ``roundtrip_quantize32``, ``encode_quantize`` /
``decode_quantize``, ``encode_quantize_stereo`` / ``decode_quantize_stereo``),
of ``simd_dct_tpu/kernels/color32.py`` (``encode_quantize32_ycbcr`` /
``decode_quantize32_ycbcr`` / ``roundtrip_quantize32_ycbcr``), of
``simd_dct_tpu/kernels/color420.py`` (``enc420_rgb`` / ``dec420_rgb`` with
``pack_records`` / ``unpack_records``) and of the trial kernel of
``dispatch/capability.py``.

Device rule: a CPU tensor goes to the plain PyTorch version
(``kernels/torch_path.py``); a CUDA tensor launches the kernel, on
PyTorch's current stream, or raises.  There is no fallback from a failed
build or launch to the plain version.  Each wrapper checks device, dtype
(u8), shape and contiguity first, whatever the device, allocates its output
with ``torch.empty`` and raises if the launch returns a CUDA error.

``LAUNCHES`` counts the launches of each kernel; a wrapper adds one where
it launches, and nowhere else.
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
from ..layout import stereo as L_stereo
from . import _build
from . import torch_path as _tp

LAUNCHES = {"enc32": 0, "dec32": 0, "roundtrip32": 0, "probe": 0,
            "encq": 0, "decq": 0, "enc_stereo": 0, "dec_stereo": 0,
            "enc32_rgb": 0, "dec32_rgb": 0, "roundtrip32_rgb": 0,
            "enc420_rgb": 0, "dec420_rgb": 0}

_ROUNDING_CODE = {"rne": 0, "scalar": 1, "clamp_first": 2}
_LAYOUT_CODE = {"scalar": 0, "pair": 1, "pair_as_written": 2}
_VIEW_LAYOUT_CODE = {"interleaved": 0, "planar": 1, "native": 2}
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
_MAX_BATCH = 65535   # grid.y (grid.z for stereo) of one launch
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
    b = t.shape[0] if t.ndim > base_ndim else 1
    if b > _MAX_BATCH:
        raise ValueError(f"at most {_MAX_BATCH} frames per launch, got {b}")
    return b


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
    image -> (H/2*W,) or (B, H/2*W) u8 records; one launch per batch."""
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
    lib = _build.load()
    with _on_device_of(img):
        rc = lib.sdct_enc32(img.data_ptr(), out.data_ptr(), q.ctypes.data,
                            batch, h2, w, h * w, _clamp_i32(start_y),
                            _clamp_i32(end_y), _ROUNDING_CODE[rounding],
                            _stream(img))
        LAUNCHES["enc32"] += 1
    _build.check(lib, rc, "enc32")
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
    lib = _build.load()
    with _on_device_of(data):
        rc = lib.sdct_dec32(data.data_ptr(), out.data_ptr(), qi.ctypes.data,
                            batch, h2, size_x, _stream(data))
        LAUNCHES["dec32"] += 1
    _build.check(lib, rc, "dec32")
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
    lib = _build.load()
    with _on_device_of(img):
        rc = lib.sdct_roundtrip32(img.data_ptr(), out.data_ptr(),
                                  q.ctypes.data, qi.ctypes.data, batch, h2,
                                  w, h * w, _stream(img))
        LAUNCHES["roundtrip32"] += 1
    _build.check(lib, rc, "roundtrip32")
    return out


def encode_quantize(img: torch.Tensor, lut, start_y: int = 0,
                    end_y: int = 1 << 30, rounding: str = "rne",
                    layout: str = "scalar",
                    legacy_range: bool = False) -> torch.Tensor:
    """Enc-quant encode of the TOP view of a (H, W) or (B, H, W) dual-view
    image -> (H/2*W,) or (B, H/2*W) u8 records in ``layout``; one launch
    per batch."""
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
    lib = _build.load()
    with _on_device_of(img):
        rc = lib.sdct_encq(img.data_ptr(), out.data_ptr(), q.ctypes.data,
                           batch, h2, w, h * w, _clamp_i32(start_y),
                           _clamp_i32(end_y), int(legacy_range),
                           _ROUNDING_CODE[rounding], _LAYOUT_CODE[layout],
                           _stream(img))
        LAUNCHES["encq"] += 1
    _build.check(lib, rc, "encq")
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
    lib = _build.load()
    with _on_device_of(data):
        rc = lib.sdct_decq(data.data_ptr(), out.data_ptr(), qi.ctypes.data,
                           batch, h2, size_x, _LAYOUT_CODE[layout],
                           _stream(data))
        LAUNCHES["decq"] += 1
    _build.check(lib, rc, "decq")
    return out


def encode_quantize_stereo(img: torch.Tensor, lut, start_y: int = 0,
                           end_y: int = 1 << 30, rounding: str = "rne",
                           view_layout: str = "interleaved") -> torch.Tensor:
    """Stereo encode of both views of a (H, W) or (B, H, W) dual-view image
    -> records in ``view_layout``: (..., H*W) interleaved,
    (..., 2, 64, H/16, W/8) planar or (..., 2, 64, H/16, BWP) native u8;
    one launch per batch."""
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
    lib = _build.load()
    with _on_device_of(img):
        rc = lib.sdct_enc_stereo(img.data_ptr(), out.data_ptr(), q.ctypes.data,
                                 batch, h, w, L_stereo.native_stereo_bwp(w),
                                 _clamp_i32(start_y), _clamp_i32(end_y),
                                 _ROUNDING_CODE[rounding],
                                 _VIEW_LAYOUT_CODE[view_layout], _stream(img))
        LAUNCHES["enc_stereo"] += 1
    _build.check(lib, rc, "enc_stereo")
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
    lib = _build.load()
    with _on_device_of(data):
        rc = lib.sdct_dec_stereo(data.data_ptr(), out.data_ptr(),
                                 qi.ctypes.data, batch, size_y, size_x,
                                 L_stereo.native_stereo_bwp(size_x),
                                 _VIEW_LAYOUT_CODE[view_layout], _stream(data))
        LAUNCHES["dec_stereo"] += 1
    _build.check(lib, rc, "dec_stereo")
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
    (Y with ``luma``, Cb and Cr with ``chroma``); one launch per batch."""
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
    lib = _build.load()
    with _on_device_of(planes):
        rc = lib.sdct_enc32_rgb(planes.data_ptr(), out.data_ptr(),
                                ql.ctypes.data, qc.ctypes.data,
                                _COLOR_MIX.ctypes.data, batch, h2, w, h * w,
                                _ROUNDING_CODE[rounding], _stream(planes))
        LAUNCHES["enc32_rgb"] += 1
    _build.check(lib, rc, "enc32_rgb")
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
    lib = _build.load()
    with _on_device_of(data):
        rc = lib.sdct_dec32_rgb(data.data_ptr(), out.data_ptr(),
                                qil.ctypes.data, qic.ctypes.data,
                                _COLOR_MIX.ctypes.data, batch, h2, size_x,
                                _stream(data))
        LAUNCHES["dec32_rgb"] += 1
    _build.check(lib, rc, "dec32_rgb")
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
    lib = _build.load()
    with _on_device_of(planes):
        rc = lib.sdct_roundtrip32_rgb(planes.data_ptr(), out.data_ptr(),
                                      ql.ctypes.data, qc.ctypes.data,
                                      qil.ctypes.data, qic.ctypes.data,
                                      _COLOR_MIX.ctypes.data, batch, h2, w,
                                      h * w, _stream(planes))
        LAUNCHES["roundtrip32_rgb"] += 1
    _build.check(lib, rc, "roundtrip32_rgb")
    return out


def encode_quantize32_ycbcr420(planes: torch.Tensor, luma, chroma,
                               rounding: str = "rne") -> torch.Tensor:
    """Colour 4:2:0 encode of the TOP view of a (3, H, W) or (B, 3, H, W)
    planar RGB dual-view image -> (1.5*H/2*W,) or (B, 1.5*H/2*W) u8 streams
    [Y | Cb | Cr] (Y with ``luma``, the 2x2-pooled Cb and Cr with
    ``chroma``); one launch per batch."""
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
    lib = _build.load()
    with _on_device_of(planes):
        rc = lib.sdct_enc420_rgb(planes.data_ptr(), out.data_ptr(),
                                 ql.ctypes.data, qc.ctypes.data,
                                 _COLOR_MIX.ctypes.data, batch, h2, w, h * w,
                                 _ROUNDING_CODE[rounding], _stream(planes))
        LAUNCHES["enc420_rgb"] += 1
    _build.check(lib, rc, "enc420_rgb")
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
    lib = _build.load()
    with _on_device_of(data):
        rc = lib.sdct_dec420_rgb(data.data_ptr(), out.data_ptr(),
                                 qil.ctypes.data, qic.ctypes.data,
                                 _COLOR_MIX.ctypes.data, batch, h2, size_x,
                                 _stream(data))
        LAUNCHES["dec420_rgb"] += 1
    _build.check(lib, rc, "dec420_rgb")
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
