"""Public API: validated enc-quant, mode32, stereo and YCbCr 4:4:4 and 4:2:0
colour entry points.

Counterpart of the enc-quant, mode32, stereo, 4:4:4 and 4:2:0 colour part
of ``simd_dct_tpu/api.py``, with the same validation contract and the same
typed errors
(``simdDctResult``, src/simd_dct.h:22-27).

Device rule: every entry point runs on the card unless the caller asks for
the host.  A torch tensor stays where the caller put it: a CUDA tensor runs
the hand-written kernels, a CPU tensor the plain PyTorch version
(``dispatch/capability.py``), and data is never moved quietly.  Anything
else that ``numpy.asarray`` takes is placed on ``device``, which defaults
to ``cuda``; on a machine without a card that raises
``NotSupportedError`` -- pass ``device="cpu"`` to run the plain version on
the host.  The result lies on the input's device.  A ``(B, H, W)`` batch
(``(B, 3, H, W)`` for colour) is one batch dimension all the way down: one
kernel launch covers up to 65,535 frames.

``compat=True`` (enc-quant, mode32 and stereo, encode and decode) selects
the strict-IEEE tier (``kernels/compat.py``): byte-identical to the C++
oracle (``native/golden_dct.cpp``), on the input's device, as eager
PyTorch ops; a conformance tier, not a fast path.  Without it, each tier
agrees with the oracle within +-1 on rounding-boundary bytes.
"""

from __future__ import annotations

import enum
from typing import Any

import numpy as np
import torch

from .core.quantize import ROUNDING_MODES, lut_array
from .dispatch.capability import default_device, select_backend
from .kernels import compat as _compat
from .kernels import cuda_dct as _cuda
from .kernels import torch_path as _tp
from .layout.color420 import record_bytes_420
from .layout.stereo import VIEW_LAYOUTS, record_shape


class SimdDctResult(enum.IntEnum):
    """Mirror of simdDctResult (src/simd_dct.h:22-27)."""
    SUCCESS = 0
    INVALID_PARAMETER = 1
    NOT_SUPPORTED = 2


class SimdDctError(Exception):
    result: SimdDctResult = SimdDctResult.INVALID_PARAMETER


class InvalidParameterError(SimdDctError):
    result = SimdDctResult.INVALID_PARAMETER


class NotSupportedError(SimdDctError):
    result = SimdDctResult.NOT_SUPPORTED


_END_Y_SENTINEL = 1 << 30


def _as_tensor(x: Any, device, name: str) -> torch.Tensor:
    """A tensor stays where it is (a ``device`` that differs raises: data
    is never moved quietly); anything else is placed on ``device``, by
    default the card (``default_device``)."""
    if isinstance(x, torch.Tensor):
        if device is not None:
            want = torch.device(device)
            if want.type != x.device.type or (
                    want.index is not None and want.index != x.device.index):
                raise InvalidParameterError(
                    f"{name} lies on {x.device}, but device={want} was "
                    "requested; move it explicitly")
        return x
    dev = default_device(device)
    arr = np.asarray(x)
    if not arr.flags.writeable:     # torch warns on read-only buffers
        arr = arr.copy()
    try:
        return torch.as_tensor(arr, device=dev)
    except TypeError as e:
        raise InvalidParameterError(f"cannot read {name}: {e}") from None


def _kernel_ready(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels take it."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _validate(image: Any, lut: Any, *, multiple_of_64: bool = False,
              allow_spill: bool = False, device=None):
    if image is None or lut is None:
        raise InvalidParameterError("image and lut must not be None")
    img = _as_tensor(image, device, "image")
    if img.ndim not in (2, 3):
        raise InvalidParameterError(
            f"expected a (H, W) image or (B, H, W) batch, got shape "
            f"{tuple(img.shape)}")
    h, w = img.shape[-2:]
    if (w % 8) or (h % 8):
        raise NotSupportedError(
            f"image dims must be multiples of 8, got {(w, h)}")
    if h % 16 and not allow_spill:
        raise NotSupportedError(
            f"dual-view geometry requires H % 16 == 0, got H={h} "
            "(pass spill=True for reference spill semantics)")
    if multiple_of_64 and (w % 64):
        raise NotSupportedError(
            f"enc-quant32 requires W % 64 == 0 (src/simd_dct.cpp:118), got {w}")
    if img.dtype != torch.uint8:
        raise InvalidParameterError(f"image must be uint8, got {img.dtype}")
    lut_arr = _lut_array(lut)
    if not np.all(np.isfinite(lut_arr)) or np.any(lut_arr <= 0):
        raise InvalidParameterError("lut entries must be positive and finite")
    return img, lut_arr, h, w


def _lut_array(lut: Any) -> np.ndarray:
    try:
        return lut_array(lut)
    except ValueError as e:
        raise InvalidParameterError(str(e)) from None


def _check_rounding(rounding: str):
    if rounding not in ROUNDING_MODES:
        raise InvalidParameterError(
            f"rounding must be one of {ROUNDING_MODES}, got {rounding!r}")


def _resolve_end_y(end_y):
    """None -> open-ended (the reference compares the raw caller value
    against y*2 each strip, src/simd_dct.cpp:268)."""
    return _END_Y_SENTINEL if end_y is None else int(end_y)


def _spill_view_image(img: torch.Tensor, w: int) -> torch.Tensor:
    """(..., H, W) u8 with H % 16 == 8 -> (..., 2*R, W) dual-view image
    whose TOP view is rows [0, R), R = ceil((H/2)/8)*8: the rows the
    reference's spill strip reads (4 rows into the second view,
    src/simd_dct.cpp:268).  The zero bottom view is never read."""
    h = img.shape[-2]
    rows = -(-(h // 2) // 8) * 8
    top = img[..., :rows, :]
    pad = torch.zeros(img.shape[:-2] + (rows, w), dtype=torch.uint8,
                      device=img.device)
    return torch.cat([top, pad], dim=-2)


def _spill_stereo_image(img: torch.Tensor, w: int) -> torch.Tensor:
    """(..., H, W) u8 dual view with H % 16 == 8 -> (..., 2*R, W) dual
    view, R = ceil((H/2)/8)*8.  The reference's spill strip
    (src/simd_dct.cpp:1073) reads its LEFT-eye rows [H/2-4, H/2+4), 4 rows
    into the right eye, so the extended left view is img[:R].  Its
    RIGHT-eye rows [H-4, H+4) run past the caller's buffer (undefined in
    the reference); those 4 rows are zeros here, a documented divergence
    kept from the JAX package."""
    h = img.shape[-2]
    rows = -(-(h // 2) // 8) * 8
    pad = torch.zeros(img.shape[:-2] + (rows - h // 2, w), dtype=torch.uint8,
                      device=img.device)
    return torch.cat([img[..., :rows, :], img[..., h // 2:, :], pad], dim=-2)


# ---------------------------------------------------------------------------
# enc-quant: encode / decode
# ---------------------------------------------------------------------------

def encode_quantize(image, lut, start_y: int = 0, end_y: int | None = None,
                    *, rounding: str = "rne", layout: str = "scalar",
                    backend: str | None = None, legacy_range: bool = False,
                    compat: bool = False, spill: bool = False,
                    device=None) -> torch.Tensor:
    """≙ simdDCT_EncodeQuantizeBuffer: block-contiguous (``scalar``) or
    SIMD pair-cell (``pair``, ``pair_as_written``) encode of the TOP view
    in the 1/255 domain.  Returns H/2*W u8 bytes per frame: (H/2*W,) or
    (B, H/2*W).  Bytes of strips outside [start_y, end_y] are zero (a
    ``pair_as_written`` strip range also keeps the reference's spill into
    the next excluded strip); ``legacy_range`` compares ``8*s`` instead of
    ``16*s`` against the range, as the NoSimd kernel does.  ``spill=True``
    accepts H % 16 == 8 with the reference's spill semantics (the output
    grows to ceil((H/2)/8)*8*W)."""
    img, lut_arr, h, w = _validate(image, lut, allow_spill=spill,
                                   device=device)
    _check_rounding(rounding)
    if spill and h % 16:
        img = _spill_view_image(img, w)
    if layout not in _tp.ENCQ_LAYOUTS:
        raise InvalidParameterError(
            "layout must be 'scalar', 'pair' or 'pair_as_written', "
            f"got {layout!r}")
    if layout != "scalar" and w % 16:
        # a pair cell holds exactly 2 blocks (src/simd_dct.cpp:1588)
        raise NotSupportedError(
            f"layout {layout!r} requires W % 16 == 0, got W={w}")
    tier = select_backend(backend, device=img.device)
    args = (int(start_y), _resolve_end_y(end_y), rounding, layout,
            bool(legacy_range))
    if compat:
        return _compat.encode_quantize(img, lut_arr, *args)
    if tier == "cuda":
        return _cuda.encode_quantize(_kernel_ready(img), lut_arr, *args)
    return _tp.encode_quantize(img, lut_arr, *args)


def decode_quantize(data, lut, size_x: int, size_y: int, *,
                    layout: str = "scalar", backend: str | None = None,
                    compat: bool = False, device=None) -> torch.Tensor:
    """Inverse of ``encode_quantize`` for the ``scalar`` and ``pair``
    layouts: records -> the TOP view, (size_y/2, size_x) or
    (B, size_y/2, size_x) u8."""
    if layout not in ("scalar", "pair"):
        # pair_as_written drops every cell's second half
        # (src/simd_dct.cpp:1662-1670 overlap): not invertible
        raise InvalidParameterError(
            f"decodable layouts are 'scalar' and 'pair', got {layout!r}")
    if layout == "pair" and size_x % 16:
        raise NotSupportedError(
            f"layout 'pair' requires W % 16 == 0, got W={size_x}")
    d, lut_arr = _validate_decode(data, lut, size_x, size_y,
                                  (size_y // 2) * size_x, device)
    tier = select_backend(backend, device=d.device)
    if compat:
        return _compat.decode_quantize(d, lut_arr, size_x, size_y, layout)
    if tier == "cuda":
        return _cuda.decode_quantize(_kernel_ready(d), lut_arr, size_x,
                                     size_y, layout)
    return _tp.decode_quantize(d, lut_arr, size_x, size_y, layout)


# ---------------------------------------------------------------------------
# mode32: encode / decode / round trip
# ---------------------------------------------------------------------------

def encode_quantize32(image, lut, start_y: int = 0, end_y: int | None = None,
                      *, rounding: str = "rne", backend: str | None = None,
                      compat: bool = False, spill: bool = False,
                      device=None) -> torch.Tensor:
    """≙ simdDCT_EncodeQuantize32ReorderBuffer: 8-block coefficient-major
    encode of the TOP view in the raw 0..255 domain.  Returns H/2*W u8
    bytes per frame: (H/2*W,) or (B, H/2*W).  Bytes of strips outside
    [start_y, end_y] are zero.  ``spill=True`` accepts H % 16 == 8 with the
    reference's spill semantics (the output grows to ceil((H/2)/8)*8*W)."""
    img, lut_arr, h, w = _validate(image, lut, multiple_of_64=True,
                                   allow_spill=spill, device=device)
    _check_rounding(rounding)
    if spill and h % 16:
        img = _spill_view_image(img, w)
    tier = select_backend(backend, device=img.device)
    ey = _resolve_end_y(end_y)
    if compat:
        return _compat.encode_quantize32(img, lut_arr, int(start_y), ey,
                                         rounding)
    if tier == "cuda":
        return _cuda.encode_quantize32(_kernel_ready(img), lut_arr,
                                       int(start_y), ey, rounding)
    return _tp.encode_quantize32(img, lut_arr, int(start_y), ey, rounding)


def _check_decode_dims(size_x, size_y):
    if size_x <= 0 or size_y <= 0:
        raise InvalidParameterError(
            f"invalid dimensions {(size_x, size_y)}")
    if (size_x % 8) or (size_y % 8):
        raise NotSupportedError(
            f"dims must be multiples of 8, got {(size_x, size_y)}")
    if size_y % 16:
        raise NotSupportedError(
            f"dual-view geometry requires H % 16 == 0, got H={size_y}")


def _check_u8_records(d: torch.Tensor):
    if d.dtype != torch.uint8:
        raise InvalidParameterError(
            f"record streams must be uint8, got {d.dtype}")


def _validate_decode(data, lut, size_x, size_y, expect_bytes, device):
    if data is None or lut is None:
        raise InvalidParameterError("data and lut must not be None")
    _check_decode_dims(size_x, size_y)
    d = _as_tensor(data, device, "data")
    _check_u8_records(d)
    if d.numel() % expect_bytes:
        raise InvalidParameterError(
            f"expected a multiple of {expect_bytes} bytes for "
            f"{(size_x, size_y)}, got {d.numel()}")
    batch = d.numel() // expect_bytes
    # a batched input keeps its batch axis even for B == 1
    batched = batch > 1 or d.ndim >= 2
    d = d.reshape(batch, expect_bytes) if batched else d.reshape(-1)
    return d, _lut_array(lut)


def decode_quantize32(data, lut, size_x: int, size_y: int, *,
                      backend: str | None = None, compat: bool = False,
                      device=None) -> torch.Tensor:
    """Inverse of ``encode_quantize32``: records -> the TOP view,
    (size_y/2, size_x) or (B, size_y/2, size_x) u8."""
    if size_x % 64:
        raise NotSupportedError("enc-quant32 requires W % 64 == 0")
    d, lut_arr = _validate_decode(data, lut, size_x, size_y,
                                  (size_y // 2) * size_x, device)
    tier = select_backend(backend, device=d.device)
    if compat:
        return _compat.decode_quantize32(d, lut_arr, size_x, size_y)
    if tier == "cuda":
        return _cuda.decode_quantize32(_kernel_ready(d), lut_arr, size_x,
                                       size_y)
    return _tp.decode_quantize32(d, lut_arr, size_x, size_y)


def roundtrip_quantize32(image, lut, *, backend: str | None = None,
                         device=None) -> torch.Tensor:
    """Mode32 encode (``rne``) -> decode of the TOP view: (H/2, W) or
    (B, H/2, W) u8.  The ``cuda`` tier runs one fused kernel whose records
    never reach device memory; it equals decode(encode(x)) byte for byte."""
    img, lut_arr, h, w = _validate(image, lut, multiple_of_64=True,
                                   device=device)
    tier = select_backend(backend, device=img.device)
    if tier == "cuda":
        return _cuda.roundtrip_quantize32(_kernel_ready(img), lut_arr)
    return _tp.roundtrip_quantize32(img, lut_arr)


# ---------------------------------------------------------------------------
# stereo: encode / decode of both views
# ---------------------------------------------------------------------------

def _check_view_layout(view_layout: str):
    if view_layout not in VIEW_LAYOUTS:
        raise InvalidParameterError(
            "view_layout must be 'interleaved', 'planar' or 'native', "
            f"got {view_layout!r}")


def encode_quantize_stereo(image, lut, start_y: int = 0,
                           end_y: int | None = None, *, rounding: str = "rne",
                           backend: str | None = None, compat: bool = False,
                           spill: bool = False,
                           view_layout: str = "interleaved",
                           device=None) -> torch.Tensor:
    """≙ simdDCT_EncodeQuantizeReorderStereoBuffer: coefficient-planar
    encode of BOTH views in the 1/255 domain.  ``view_layout``:

    * ``interleaved`` (the reference's stream): (H*W,) or (B, H*W), 64
      planes, each strip's BW left-view bytes then BW right-view bytes;
    * ``planar``: (2, 64, S, W/8) or (B, 2, 64, S, W/8), the views apart;
    * ``native``: (..., 2, 64, S, BWP), planar with each plane row padded
      to ``layout.stereo.native_stereo_bwp(W)`` columns of 127.

    Bytes of strips outside [start_y, end_y] are zero, in native form the
    pad too.  ``spill=True`` accepts H % 16 == 8 with the reference's spill
    semantics (``_spill_stereo_image``; the output grows to 2*R*W bytes)."""
    _check_view_layout(view_layout)
    img, lut_arr, h, w = _validate(image, lut, allow_spill=spill,
                                   device=device)
    if spill and h % 16:
        img = _spill_stereo_image(img, w)
    _check_rounding(rounding)
    tier = select_backend(backend, device=img.device)
    args = (int(start_y), _resolve_end_y(end_y), rounding, view_layout)
    if compat:
        return _compat.encode_quantize_stereo(img, lut_arr, *args)
    if tier == "cuda":
        return _cuda.encode_quantize_stereo(_kernel_ready(img), lut_arr,
                                            *args)
    return _tp.encode_quantize_stereo(img, lut_arr, *args)


def _validate_stereo_planes(data, lut, size_x, size_y, view_layout, device):
    """Planar or native stereo records: (2, 64, S, BW[P]) or a batch of
    them, exactly."""
    if data is None or lut is None:
        raise InvalidParameterError("data and lut must not be None")
    d = _as_tensor(data, device, "data")
    expect = record_shape(view_layout, size_y, size_x)
    if d.ndim not in (4, 5) or tuple(d.shape[-4:]) != expect:
        raise InvalidParameterError(
            f"{view_layout} stereo data must have shape (..., 2, 64, "
            f"{expect[2]}, {expect[3]}), got {tuple(d.shape)}")
    _check_decode_dims(size_x, size_y)
    _check_u8_records(d)
    return d, _lut_array(lut)


def decode_quantize_stereo(data, lut, size_x: int, size_y: int, *,
                           backend: str | None = None, compat: bool = False,
                           view_layout: str = "interleaved",
                           device=None) -> torch.Tensor:
    """Inverse of ``encode_quantize_stereo`` for each ``view_layout``:
    records -> both views, (size_y, size_x) or (B, size_y, size_x) u8.  The
    native form's pad columns are never read."""
    _check_view_layout(view_layout)
    if view_layout == "interleaved":
        d, lut_arr = _validate_decode(data, lut, size_x, size_y,
                                      size_y * size_x, device)
    else:
        d, lut_arr = _validate_stereo_planes(data, lut, size_x, size_y,
                                             view_layout, device)
    tier = select_backend(backend, device=d.device)
    if compat:
        return _compat.decode_quantize_stereo(d, lut_arr, size_x, size_y,
                                              view_layout)
    if tier == "cuda":
        return _cuda.decode_quantize_stereo(_kernel_ready(d), lut_arr, size_x,
                                            size_y, view_layout)
    return _tp.decode_quantize_stereo(d, lut_arr, size_x, size_y, view_layout)


# ---------------------------------------------------------------------------
# YCbCr 4:4:4 colour: encode / decode / round trip
# ---------------------------------------------------------------------------

def _validate_color(planes, luma_lut, chroma_lut, device):
    """(3, H, W) planar RGB or a (B, 3, H, W) batch, with the mode32
    geometry of each plane and two valid LUTs."""
    if planes is None or luma_lut is None or chroma_lut is None:
        raise InvalidParameterError("planes and luts must not be None")
    p = _as_tensor(planes, device, "planes")
    if p.ndim not in (3, 4) or p.shape[-3] != 3:
        raise InvalidParameterError(
            "expected (3, H, W) planar RGB or a (B, 3, H, W) batch, got "
            f"shape {tuple(p.shape)}")
    _, lut_l, _, _ = _validate(p[..., 0, :, :], luma_lut, multiple_of_64=True)
    _, lut_c, _, _ = _validate(p[..., 0, :, :], chroma_lut,
                               multiple_of_64=True)
    return p, lut_l, lut_c


def encode_quantize32_ycbcr(planes, luma_lut, chroma_lut, *,
                            rounding: str = "rne", backend: str | None = None,
                            device=None) -> torch.Tensor:
    """(3, H, W) u8 planar RGB, or a (B, 3, H, W) batch -> (3, H/2*W) or
    (B, 3, H/2*W) u8 per-channel YCbCr mode32 records of the TOP view: the
    BT.601 full-range mix in f32 (no u8 step), Y quantized with
    ``luma_lut``, Cb and Cr with ``chroma_lut``, both in mode32's raw
    0..255 domain (255x hotter than enc-quant's; the chroma table is
    ``layout.BASE_CHROMA_QUANT_TABLE * quality * 255``)."""
    _check_rounding(rounding)
    p, lut_l, lut_c = _validate_color(planes, luma_lut, chroma_lut, device)
    tier = select_backend(backend, device=p.device)
    if tier == "cuda":
        return _cuda.encode_quantize32_ycbcr(_kernel_ready(p), lut_l, lut_c,
                                             rounding)
    return _tp.encode_ycbcr32(p, lut_l, lut_c, rounding)


def decode_quantize32_ycbcr(data, luma_lut, chroma_lut, size_x: int,
                            size_y: int, *, backend: str | None = None,
                            device=None) -> torch.Tensor:
    """Inverse of ``encode_quantize32_ycbcr``: a multiple of
    3*(size_y/2)*size_x record bytes -> (3, size_y/2, size_x) u8 planar
    RGB, or (B, 3, size_y/2, size_x) for more than one frame or a batched
    input (ndim >= 3, B == 1 included)."""
    if data is None or luma_lut is None or chroma_lut is None:
        raise InvalidParameterError("data and luts must not be None")
    _check_decode_dims(size_x, size_y)
    if size_x % 64:
        raise NotSupportedError("enc-quant32 requires W % 64 == 0")
    d = _as_tensor(data, device, "data")
    _check_u8_records(d)
    plane = (size_y // 2) * size_x
    if d.numel() == 0 or d.numel() % (3 * plane):
        raise InvalidParameterError(
            f"expected a multiple of {3 * plane} record bytes for "
            f"{(size_x, size_y)}, got {d.numel()}")
    batch = d.numel() // (3 * plane)
    # a batched input keeps its batch axis even for B == 1
    d = d.reshape(batch, 3, plane) if batch > 1 or d.ndim >= 3 \
        else d.reshape(3, plane)
    lut_l, lut_c = _lut_array(luma_lut), _lut_array(chroma_lut)
    tier = select_backend(backend, device=d.device)
    if tier == "cuda":
        return _cuda.decode_quantize32_ycbcr(_kernel_ready(d), lut_l, lut_c,
                                             size_x, size_y)
    return _tp.decode_ycbcr32(d, lut_l, lut_c, size_x, size_y)


def roundtrip_quantize32_ycbcr(planes, luma_lut, chroma_lut, *,
                               backend: str | None = None,
                               device=None) -> torch.Tensor:
    """YCbCr mode32 encode (``rne``) -> decode of the TOP view: (3, H, W) or
    (B, 3, H, W) u8 planar RGB -> (3, H/2, W) or (B, 3, H/2, W) u8.  The
    ``cuda`` tier runs one fused kernel whose records never reach device
    memory; it equals decode(encode(x)) byte for byte."""
    p, lut_l, lut_c = _validate_color(planes, luma_lut, chroma_lut, device)
    tier = select_backend(backend, device=p.device)
    if tier == "cuda":
        return _cuda.roundtrip_quantize32_ycbcr(_kernel_ready(p), lut_l,
                                                lut_c)
    return _tp.roundtrip_ycbcr32(p, lut_l, lut_c)


# ---------------------------------------------------------------------------
# YCbCr 4:2:0 colour: encode / decode with 2x2-subsampled chroma
# ---------------------------------------------------------------------------

def _check_420_geometry(h: int, w: int):
    if w % 128:
        raise NotSupportedError(
            f"enc-quant32-ycbcr420 requires W % 128 == 0 (half-res chroma "
            f"W/2 % 64), got {w}")
    if h % 32:
        raise NotSupportedError(
            f"enc-quant32-ycbcr420 requires H % 32 == 0 (half-res chroma "
            f"strips), got {h}")


def encode_quantize32_ycbcr420(planes, luma_lut, chroma_lut, *,
                               rounding: str = "rne",
                               backend: str | None = None,
                               device=None) -> torch.Tensor:
    """(3, H, W) u8 planar RGB, or a (B, 3, H, W) batch -> (1.5*H/2*W,) or
    (B, 1.5*H/2*W) u8 4:2:0 streams of the TOP view, ``[Y records | Cb
    records | Cr records]``: the BT.601 mix in f32, Cb and Cr averaged over
    2x2 pixels to half resolution, then the mode32 records of each plane, Y
    quantized with ``luma_lut`` and Cb, Cr with ``chroma_lut`` (the raw
    0..255 domain, as ``encode_quantize32_ycbcr``).  Needs W % 128 == 0 and
    H % 32 == 0, so the half-resolution planes meet mode32's geometry."""
    _check_rounding(rounding)
    p, lut_l, lut_c = _validate_color(planes, luma_lut, chroma_lut, device)
    h, w = p.shape[-2:]
    _check_420_geometry(h, w)
    tier = select_backend(backend, device=p.device)
    if tier == "cuda":
        return _cuda.encode_quantize32_ycbcr420(_kernel_ready(p), lut_l,
                                                lut_c, rounding)
    return _tp.encode_ycbcr420(p, lut_l, lut_c, rounding)


def decode_quantize32_ycbcr420(data, luma_lut, chroma_lut, size_x: int,
                               size_y: int, *, backend: str | None = None,
                               device=None) -> torch.Tensor:
    """Inverse of ``encode_quantize32_ycbcr420``: a multiple of
    1.5*(size_y/2)*size_x stream bytes -> (3, size_y/2, size_x) u8 planar
    RGB, or (B, 3, size_y/2, size_x) for more than one frame or a batched
    input (ndim >= 2, B == 1 included, so that decode(encode(x)) has the
    shape of x's top view; the JAX package drops the axis of a batch of
    one).  Each chroma value covers its 2x2 pixels."""
    if data is None or luma_lut is None or chroma_lut is None:
        raise InvalidParameterError("data and luts must not be None")
    if size_x <= 0 or size_y <= 0:
        raise InvalidParameterError(
            f"invalid dimensions {(size_x, size_y)}")
    _check_420_geometry(size_y, size_x)
    d = _as_tensor(data, device, "data")
    _check_u8_records(d)
    frame = record_bytes_420(size_y // 2, size_x)
    if d.numel() == 0 or d.numel() % frame:
        raise InvalidParameterError(
            f"expected a multiple of {frame} record bytes for "
            f"{(size_x, size_y)}, got {d.numel()}")
    batch = d.numel() // frame
    d = d.reshape(batch, frame) if batch > 1 or d.ndim >= 2 else d.reshape(-1)
    lut_l, lut_c = _lut_array(luma_lut), _lut_array(chroma_lut)
    tier = select_backend(backend, device=d.device)
    if tier == "cuda":
        return _cuda.decode_quantize32_ycbcr420(_kernel_ready(d), lut_l,
                                                lut_c, size_x, size_y)
    return _tp.decode_ycbcr420(d, lut_l, lut_c, size_x, size_y)


# ---------------------------------------------------------------------------
# C-enum-style wrapper
# ---------------------------------------------------------------------------
#
# The raising entry points return a fresh tensor with excluded strips
# zero-filled.  The try_* wrappers restore the reference behaviour: they
# copy only the bytes the reference writes for the strip range into
# ``out`` and leave the rest untouched (src/simd_dct.cpp:1075-1083).

def _strip_byte_mask(h: int, w: int, start_y, end_y, *, spill: bool = False,
                     legacy_range: bool = False, pair_spill: bool = False,
                     view_layout: str | None = None) -> np.ndarray | None:
    """Bool mask over the output bytes written for the strip range, or
    None when every strip is included.  ``pair_spill``: the as-written
    pair layout's last cell of an included strip also writes the first 64
    bytes of an excluded successor (src/simd_dct.cpp:1662-1670).
    ``view_layout`` names a stereo output: the interleaved stream's mask
    (each strip owns W/4 bytes of each of the 64 planes,
    src/simd_dct.cpp:275), or for ``planar`` / ``native`` a (2, 64, S, 1)
    mask that broadcasts over the plane rows."""
    n_strips = -(-h // 16) if (spill and h % 16) else h // 16
    cmp = np.arange(n_strips, dtype=np.int64) * (8 if legacy_range else 16)
    ey = _resolve_end_y(end_y)
    strips = (cmp >= int(start_y)) & (cmp <= ey)
    if strips.all():
        return None
    if view_layout == "interleaved":
        return np.tile(np.repeat(strips, w // 4), 64)
    if view_layout is not None:
        return np.broadcast_to(strips[:, None], (2, 64, n_strips, 1))
    mask = np.repeat(strips, 8 * w)
    if pair_spill:
        for r in np.nonzero(strips[:-1] & ~strips[1:])[0] + 1:
            mask[r * 8 * w: r * 8 * w + 64] = True
    return mask


def _try_encode(encode, image, out, lut, size_x, size_y, start_y, end_y,
                kw, view_layout: str | None = None) -> SimdDctResult:
    """Run ``encode`` and copy the bytes it writes for the strip range into
    ``out`` (a u8 numpy array of the result's shape); return a
    SimdDctResult instead of raising.  ``view_layout``: the stereo output
    form, None for the one-view modes."""
    try:
        result = encode(image, lut, start_y, end_y, **kw)
    except SimdDctError as e:
        return e.result
    mask = _strip_byte_mask(
        size_y, size_x, start_y, end_y, spill=kw.get("spill", False),
        legacy_range=kw.get("legacy_range", False),
        pair_spill=kw.get("layout") == "pair_as_written",
        view_layout=view_layout)
    np.copyto(out, result.cpu().numpy(),
              where=True if mask is None else mask)
    return SimdDctResult.SUCCESS


def try_encode_quantize(image, out, lut, size_x, size_y, start_y, end_y,
                        **kw) -> SimdDctResult:
    """Reference-shaped enc-quant call (see ``_try_encode``)."""
    return _try_encode(encode_quantize, image, out, lut, size_x, size_y,
                       start_y, end_y, kw)


def try_encode_quantize32(image, out, lut, size_x, size_y, start_y, end_y,
                          **kw) -> SimdDctResult:
    """Reference-shaped mode32 call (see ``_try_encode``)."""
    return _try_encode(encode_quantize32, image, out, lut, size_x, size_y,
                       start_y, end_y, kw)


def try_encode_quantize_stereo(image, out, lut, size_x, size_y, start_y,
                               end_y, **kw) -> SimdDctResult:
    """Reference-shaped stereo call (see ``_try_encode``).  Unlike the JAX
    package's, its mask follows ``spill``: with H % 16 == 8 it covers the
    2*R*W bytes the spilled encode returns."""
    return _try_encode(encode_quantize_stereo, image, out, lut, size_x,
                       size_y, start_y, end_y, kw,
                       view_layout=kw.get("view_layout", "interleaved"))
