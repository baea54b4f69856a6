"""The repo's native C++ libraries, built with ``g++`` and loaded by ctypes.

Two sources under the repository's ``native/`` serve the port as they are:

* ``native/entropy.cpp``, the host entropy coder behind ``entropy``
  (order-0 canonical Huffman, RLE, nibble split; built ``-O3 -pthread``);
* ``native/golden_dct.cpp``, the strict-IEEE oracle of the three modes'
  encode and decode (built ``-O2`` without fast math, with
  ``-ffp-contract=off -frounding-math``: the point of an oracle), whose
  API this module carries (the counterpart of ``simd_dct_tpu/native.py``).

Each library is compiled at first use into ``simd_dct_tpu_torch/_build/
native/``, again whenever its source is newer, with no ``-march=native``
(a checkout may be shared between hosts).  It is compiled to a temporary
path and renamed into place, so processes that build at the same time never
load a partial file.  A missing source or a failed compile raises
``NativeBuildError`` with the path and the compiler's output.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE_DIR = os.path.join(os.path.dirname(_PKG), "native")
BUILD_DIR = os.path.join(_PKG, "_build", "native")

_COMMON = ("-fPIC", "-shared", "-std=c++17")
FLAGS = {
    "entropy": ("-O3", *_COMMON, "-pthread"),
    "golden_dct": ("-O2", *_COMMON, "-fno-fast-math", "-ffp-contract=off",
                   "-frounding-math"),
}

ROUNDING_CODE = {"rne": 0, "scalar": 1, "clamp_first": 2}
LAYOUT_CODE = {"scalar": 0, "pair": 1, "pair_as_written": 2}
RESULT_NAMES = {0: "success", 1: "invalid_parameter", 2: "not_supported"}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


class NativeBuildError(RuntimeError):
    """A native source is missing or does not compile."""


class NativeGoldenError(RuntimeError):
    def __init__(self, code: int):
        self.code = code
        super().__init__(
            f"native golden returned {RESULT_NAMES.get(code, code)}")


def build(name: str) -> str:
    """Compile ``native/<name>.cpp`` unless its library is current; return
    the library's path."""
    src = os.path.join(SOURCE_DIR, f"{name}.cpp")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    if not os.path.isfile(src):
        raise NativeBuildError(f"native source {src} not found")
    if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(src):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", *FLAGS[name], src, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError:
        raise NativeBuildError(f"cannot build {src}: g++ not found") from None
    if proc.returncode:
        raise NativeBuildError(f"g++ failed (exit {proc.returncode}) on "
                               f"{src}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, so)
    return so


def library(name: str, declare) -> ctypes.CDLL:
    """The loaded library ``name``, built at first use; ``declare(lib)``
    sets its functions' ``argtypes`` and ``restype`` once."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            declare(lib)
            _libs[name] = lib
    return lib


def u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


# ---------------------------------------------------------------------------
# the strict-IEEE oracle (native/golden_dct.cpp)
# ---------------------------------------------------------------------------

def _declare_golden(lib: ctypes.CDLL) -> None:
    u8, f32 = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    st, i = ctypes.c_size_t, ctypes.c_int
    sigs = {
        "golden_encode_quantize": [u8, u8, f32, st, st, st, st, i, i, i],
        "golden_encode_quantize32": [u8, u8, f32, st, st, st, st, i],
        "golden_encode_quantize_stereo": [u8, u8, f32, st, st, st, st, i],
        "golden_decode_quantize32": [u8, u8, f32, st, st],
        "golden_decode_quantize_stereo": [u8, u8, f32, st, st],
        "golden_decode_quantize": [u8, u8, f32, st, st, i],
    }
    for fn_name, argtypes in sigs.items():
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = ctypes.c_int, argtypes
    for fn_name in ("golden_dct2d_fx_major", "golden_dct2d_fy_major"):
        fn = getattr(lib, fn_name)
        fn.restype, fn.argtypes = None, [f32, st]


def _golden() -> ctypes.CDLL:
    return library("golden_dct", _declare_golden)


def _prep(image, lut):
    img = np.ascontiguousarray(image, np.uint8)
    lut = np.ascontiguousarray(lut, np.float32)
    if lut.size != 64:
        raise ValueError("lut must have 64 entries")
    return img, lut


def _spill_bytes(h: int, w: int) -> int:
    """Output bytes of a one-view encode: with H % 16 == 8 the reference's
    last strip spills past the view and writes ceil((H/2)/8)*8*W bytes."""
    return -(-(h // 2) // 8) * 8 * w


def _check(rc: int) -> None:
    if rc:
        raise NativeGoldenError(rc)


def encode_quantize(image, lut, start_y=0, end_y=None, *, rounding="rne",
                    layout="scalar", legacy_range=False,
                    out=None) -> np.ndarray:
    """``out`` (optional caller buffer, u8 H/2*W): like the reference, the
    bytes of strips outside [start_y, end_y] are left untouched."""
    img, lut = _prep(image, lut)
    h, w = img.shape
    end_y = h if end_y is None else end_y
    if out is None:
        out = np.zeros(_spill_bytes(h, w), np.uint8)
    _check(_golden().golden_encode_quantize(
        u8p(img), u8p(out), _f32p(lut), w, h, start_y, end_y,
        ROUNDING_CODE[rounding], LAYOUT_CODE[layout], int(legacy_range)))
    return out


def encode_quantize32(image, lut, start_y=0, end_y=None, *, rounding="rne",
                      out=None) -> np.ndarray:
    img, lut = _prep(image, lut)
    h, w = img.shape
    end_y = h if end_y is None else end_y
    if out is None:
        out = np.zeros(_spill_bytes(h, w), np.uint8)
    _check(_golden().golden_encode_quantize32(
        u8p(img), u8p(out), _f32p(lut), w, h, start_y, end_y,
        ROUNDING_CODE[rounding]))
    return out


def encode_quantize_stereo(image, lut, start_y=0, end_y=None, *,
                           rounding="rne", out=None) -> np.ndarray:
    img, lut = _prep(image, lut)
    h, w = img.shape
    end_y = h if end_y is None else end_y
    if out is None:
        out = np.zeros(h * w, np.uint8)
    _check(_golden().golden_encode_quantize_stereo(
        u8p(img), u8p(out), _f32p(lut), w, h, start_y, end_y,
        ROUNDING_CODE[rounding]))
    return out


def decode_quantize(data, lut, size_x: int, size_y: int,
                    layout: str = "scalar") -> np.ndarray:
    """The oracle's enc-quant decode (``pair_as_written`` is not
    decodable)."""
    d = np.ascontiguousarray(data, np.uint8).reshape(-1)
    lut = np.ascontiguousarray(lut, np.float32)
    out = np.zeros((size_y // 2, size_x), np.uint8)
    _check(_golden().golden_decode_quantize(
        u8p(d), u8p(out), _f32p(lut), size_x, size_y, LAYOUT_CODE[layout]))
    return out


def decode_quantize32(data, lut, size_x: int, size_y: int) -> np.ndarray:
    d = np.ascontiguousarray(data, np.uint8).reshape(-1)
    lut = np.ascontiguousarray(lut, np.float32)
    out = np.zeros((size_y // 2, size_x), np.uint8)
    _check(_golden().golden_decode_quantize32(
        u8p(d), u8p(out), _f32p(lut), size_x, size_y))
    return out


def decode_quantize_stereo(data, lut, size_x: int,
                           size_y: int) -> np.ndarray:
    d = np.ascontiguousarray(data, np.uint8).reshape(-1)
    lut = np.ascontiguousarray(lut, np.float32)
    out = np.zeros((size_y, size_x), np.uint8)
    _check(_golden().golden_decode_quantize_stereo(
        u8p(d), u8p(out), _f32p(lut), size_x, size_y))
    return out


def dct2d_blocks(blocks: np.ndarray, orientation: str = "fy") -> np.ndarray:
    """Butterfly 2-D DCT on (..., 64) f32 block buffers (in the reference's
    association order); ``'fx'`` is the enc-quant buffer order, ``'fy'``
    the stereo and mode32 order."""
    b = np.ascontiguousarray(blocks, np.float32).copy()
    flat = b.reshape(-1, 64)
    lib = _golden()
    fn = (lib.golden_dct2d_fx_major if orientation == "fx"
          else lib.golden_dct2d_fy_major)
    fn(_f32p(flat), flat.shape[0])
    return flat.reshape(b.shape)
