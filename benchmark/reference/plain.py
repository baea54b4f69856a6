"""Plain PyTorch transforms that the benchmark judges the program's outputs by.

The upstream library (rainerzufalldererste/simd_dct) defines four of the
calls the benchmark drives:

* the stereo encode (``enc-quant-stereo``): both stacked views of an
  (H, W) u8 buffer, pixels times f32(1/255), the orthonormal 8x8 DCT-II,
  coefficients in fy-major order (p = fy*8 + fx), quantized by
  q = 255 / (lut * 0.95) with +127 and round half to even, then 64
  coefficient planes, each strip's W/8 left-view bytes before its W/8
  right-view bytes (src/simd_dct.cpp:224-227,258-294);
* its decode: the inverse, times 255, round half to even, clip to u8;
* the mode32 encode (``enc-quant32``): the top (H/2, W) view in the raw
  0..255 domain, the same transform and quantizer, and 512-byte records of
  8 blocks, coefficient-major (byte p*8 + b is coefficient p of block b,
  src/simd_dct.cpp:2021-2025);
* the mode32 round trip: that encode, then its decode.

Written from those semantics and frozen here: it imports nothing of the
program.  Every function takes a (B, H, W) batch and works on whatever
device its input lies on; the caller feeds it a few frames at a time.

``precision="float32"`` computes every product in f32 with TF32 off.
``precision="tf32"`` rounds each operand of each 8-point transform to
TensorFloat-32 (10 explicit mantissa bits, round to nearest even) and
accumulates in f32, as a TF32 tensor core does: the benchmark's control,
one precision below the configurations' float32.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

PRECISIONS = ("float32", "tf32")

# sqrt(2) cos(k pi / 16) and 1/sqrt(8): the upstream butterfly's f32
# constants (src/simd_dct.cpp:140-146)
_A = np.float32(1.3870398453221474618216191915664)
_B = np.float32(1.3065629648763765278566431734272)
_C = np.float32(1.1758756024193587169744671046113)
_D = np.float32(0.78569495838710218127789736765722)
_E = np.float32(0.54119610014619698439972320536639)
_F = np.float32(0.27589937928294301233595756366937)
_NORM = np.float32(0.35355339059327376220042218105242)
_BASIS_ROWS = np.array([
    [1, 1, 1, 1, 1, 1, 1, 1],
    [_A, _C, _D, _F, -_F, -_D, -_C, -_A],
    [_B, _E, -_E, -_B, -_B, -_E, _E, _B],
    [_C, -_F, -_A, -_D, _D, _A, _F, -_C],
    [1, -1, -1, 1, 1, -1, -1, 1],
    [_D, -_A, _F, _C, -_C, -_F, _A, -_D],
    [_E, -_B, _B, -_E, -_E, _B, -_B, _E],
    [_F, -_D, _C, -_A, _A, -_C, _D, -_F],
], dtype=np.float32)
BASIS = (_NORM * _BASIS_ROWS).astype(np.float32)   # rows: frequencies

VR = np.float32(0.95)
BIAS = np.float32(127.0)
INV_255 = np.float32(1.0 / 255.0)


def quant_scales(lut) -> np.ndarray:
    """q[p] = 255 / (lut[p] * 0.95), in f32."""
    lut = np.asarray(lut, np.float32).reshape(64)
    return (np.float32(255.0) / (lut * VR)).astype(np.float32)


def dequant_scales(lut) -> np.ndarray:
    """(lut[p] * 0.95) / 255, in f32."""
    lut = np.asarray(lut, np.float32).reshape(64)
    return ((lut * VR) / np.float32(255.0)).astype(np.float32)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to the nearest TensorFloat-32 value (ties to even),
    kept as f32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & -0x2000
    return bits.view(torch.float32)


@contextlib.contextmanager
def _full_f32():
    """Matrix products in full f32 on the card, whatever the caller set."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _mm(x: torch.Tensor, m: torch.Tensor, precision: str) -> torch.Tensor:
    """x @ m over the last axis, operands rounded to ``precision``."""
    if precision == "tf32":
        x, m = _tf32(x), _tf32(m)
    with _full_f32():
        return x @ m


def _blocks(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W) -> (B, H/8, W/8, 8, 8) f32 blocks, (row, col) minor."""
    b, h, w = img.shape
    x = img.reshape(b, h // 8, 8, w // 8, 8).transpose(2, 3)
    return x.to(torch.float32)


def _unblocks(x: torch.Tensor) -> torch.Tensor:
    """(B, S, BW, 8, 8) -> (B, S*8, BW*8)."""
    b, s, bw = x.shape[:3]
    return x.transpose(2, 3).reshape(b, s * 8, bw * 8)


def dct2(x: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """C = D X D^T of (..., 8, 8) f32 blocks: C[..., fy, fx]."""
    d = torch.as_tensor(BASIS, device=x.device)
    rows = _mm(x, d.T, precision)                          # X D^T
    return _mm(rows.transpose(-1, -2), d.T, precision).transpose(-1, -2)


def idct2(c: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """X = D^T C D of (..., 8, 8) f32 coefficients."""
    d = torch.as_tensor(BASIS, device=c.device)
    rows = _mm(c, d, precision)                            # C D
    return _mm(rows.transpose(-1, -2), d, precision).transpose(-1, -2)


def _quantize(coeffs: torch.Tensor, lut) -> torch.Tensor:
    """(..., 8, 8) coefficients -> (..., 64) biased u8, fy-major, rne."""
    q = torch.as_tensor(quant_scales(lut), device=coeffs.device)
    v = coeffs.reshape(*coeffs.shape[:-2], 64) * q
    return (torch.round(v).clamp(-127.0, 128.0).to(torch.int32) + 127) \
        .to(torch.uint8)


def _dequantize(data: torch.Tensor, lut) -> torch.Tensor:
    """(..., 64) biased u8 -> (..., 8, 8) f32 coefficients."""
    s = torch.as_tensor(dequant_scales(lut), device=data.device)
    c = (data.to(torch.float32) - float(BIAS)) * s
    return c.reshape(*data.shape[:-1], 8, 8)


def _pixels(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def _check(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")


def encode_stereo(img: torch.Tensor, lut,
                  precision: str = "float32") -> torch.Tensor:
    """(B, H, W) u8 dual views -> (B, H*W) interleaved stereo records."""
    _check(precision)
    b, h, w = img.shape
    x = _blocks(img) * torch.tensor(INV_255, device=img.device)
    data = _quantize(dct2(x, precision), lut)               # (B, 2S, BW, 64)
    s, bw = h // 16, w // 8
    views = data.reshape(b, 2, s, bw, 64)
    # (B, 64, S, 2, BW): per plane and strip, the left view then the right
    return views.permute(0, 4, 2, 1, 3).reshape(b, h * w)


def decode_stereo(data: torch.Tensor, lut, size_x: int, size_y: int,
                  precision: str = "float32") -> torch.Tensor:
    """(B, H*W) interleaved stereo records -> (B, H, W) u8 dual views."""
    _check(precision)
    b = data.shape[0]
    s, bw = size_y // 16, size_x // 8
    planes = data.reshape(b, 64, s, 2, bw).permute(0, 3, 2, 4, 1)
    coeffs = _dequantize(planes.reshape(b, 2 * s, bw, 64), lut)
    x = idct2(coeffs, precision) * torch.tensor(np.float32(255.0),
                                                device=data.device)
    return _unblocks(_pixels(x))


def encode32(img: torch.Tensor, lut,
             precision: str = "float32") -> torch.Tensor:
    """(B, H, W) u8 dual-view buffers -> (B, H/2*W) mode32 records of the
    top views."""
    _check(precision)
    b, h, w = img.shape
    data = _quantize(dct2(_blocks(img[:, : h // 2]), precision), lut)
    s, bw = h // 16, w // 8
    groups = data.reshape(b, s, bw // 8, 8, 64).transpose(-1, -2)
    return groups.reshape(b, (h // 2) * w)


def roundtrip32(img: torch.Tensor, lut,
                precision: str = "float32") -> torch.Tensor:
    """(B, H, W) u8 dual-view buffers -> (B, H/2, W) u8: the mode32 encode
    of the top views, then its decode."""
    _check(precision)
    h = img.shape[1]
    data = _quantize(dct2(_blocks(img[:, : h // 2]), precision), lut)
    return _unblocks(_pixels(idct2(_dequantize(data, lut), precision)))
