"""Scalar NumPy golden model of every reference encode mode (+ decode).

The port's own copy of ``simd_dct_tpu/core/golden.py`` (the JAX package's
``__init__`` imports jax, which this package never does), byte for byte
the same model: the analog of the reference's ``*_NoSimd_Float``
"Reference Implementation" kernels (src/simd_dct.cpp:137,176), a
readable, obviously-correct model that every other tier is tested
against, and the ``numpy`` tier of the api (``backend="numpy"``,
``--max-simd none``).  It is intentionally written block-by-block (not
vectorized over the image) to stay structurally close to the reference
semantics it mirrors, so it is slow: keep its inputs small.

Mode semantics (derived from the reference, cited per function):

* every mode treats the (H, W) buffer as TWO vertically stacked views of
  height H/2 and iterates strips ``y in [0, H/2) step 8``
  (src/simd_dct.cpp:268,375,1073,...);
* ``enc_quant`` and ``enc_quant32`` encode ONLY the first (top) view per
  call; ``stereo`` encodes both;
* strip selection: skip while ``y*2 < startY``, stop when ``y*2 > endY``
  (src/simd_dct.cpp:1686,2042) -- except the NoSimd enc-quant kernel which
  compares ``y`` directly (src/simd_dct.cpp:377,384), reproduced via
  ``legacy_range=True``.

All DCTs here run in float32 matmul form against the basis matrix; the
reference's butterfly is the same linear map evaluated in a different
association order, so float results can differ by ~1 ulp (the reference is
additionally compiled with fast-math, project.lua:59).  u8-level agreement
with the C++ golden (native/) is asserted statistically in tests.
"""

from __future__ import annotations

import numpy as np

from .dct import dct_basis_np
from .quantize import VR

__all__ = [
    "encode_quantize_golden",
    "encode_quantize32_golden",
    "encode_quantize_stereo_golden",
    "decode_quantize_golden",
    "decode_quantize32_golden",
    "decode_quantize_stereo_golden",
    "pair_cell_permutation",
]


def _dct2d(block_f32: np.ndarray) -> np.ndarray:
    d = dct_basis_np("float32")
    # D @ X @ D.T, evaluated in f32 like the reference kernels.
    return (d @ block_f32.astype(np.float32) @ d.T).astype(np.float32)


def _buffer_fx(block_f32: np.ndarray, compat: bool) -> np.ndarray:
    """fx-major 64-float buffer of a block (enc-quant orientation).

    compat=True evaluates the butterfly association order — bit-identical
    to the C++ oracle; compat=False is the matmul form (±1 ulp)."""
    if compat:
        from . import butterfly
        return butterfly.dct2d_fx_major(block_f32).reshape(64)
    return _dct2d(block_f32).T.reshape(64)


def _buffer_fy(block_f32: np.ndarray, compat: bool) -> np.ndarray:
    """fy-major buffer (stereo / mode32 orientation)."""
    if compat:
        from . import butterfly
        return butterfly.dct2d_fy_major(block_f32).reshape(64)
    return _dct2d(block_f32).reshape(64)


def _idct2d(coeff_f32: np.ndarray) -> np.ndarray:
    d = dct_basis_np("float32")
    return (d.T @ coeff_f32.astype(np.float32) @ d).astype(np.float32)


def _quantize(buffer64: np.ndarray, lut: np.ndarray, rounding: str,
              compat: bool = False) -> np.ndarray:
    """buffer64: float coeffs in buffer order; returns u8 in buffer order."""
    if compat:
        from . import butterfly
        return butterfly.quantize_exact(buffer64, lut, rounding)
    lut = np.asarray(lut, np.float32)
    if rounding == "rne":
        q = (np.float32(255.0) / (lut * VR)).astype(np.float32)
        v = np.rint(buffer64 * q).astype(np.int64) + 127
        return np.clip(v, 0, 255).astype(np.uint8)
    if rounding == "scalar":
        # src/simd_dct.cpp:194-212,245: q = 1/(lut*vr) on /255-domain coeffs,
        # +127/255, clamp [0,1], *255, roundf (half away from zero).
        q = (np.float32(1.0) / (lut * VR)).astype(np.float32)
        v = np.clip(buffer64 * q + np.float32(127.0 / 255.0), 0.0, 1.0) * np.float32(255.0)
        return np.floor(v + np.float32(0.5)).astype(np.uint8)
    if rounding == "clamp_first":
        q = (np.float32(255.0) / (lut * VR)).astype(np.float32)
        v = np.clip(buffer64 * q + np.float32(127.0), 0.0, 255.0)
        return np.rint(v).astype(np.uint8)
    raise ValueError(f"unknown rounding {rounding!r}")


def _strips(size_y: int, start_y: int, end_y: int, legacy_range: bool):
    """Yield included strip top rows ``y`` (within the first view)."""
    for y in range(0, size_y // 2, 8):
        cmp = y if legacy_range else y * 2
        if cmp < start_y:
            continue
        if cmp > end_y:
            break
        yield y


# ---------------------------------------------------------------------------
# enc-quant (block-contiguous): simdDCT_EncodeQuantizeBuffer
# ---------------------------------------------------------------------------

def pair_cell_permutation(as_written: bool = False) -> np.ndarray:
    """Byte offsets of the SIMD enc-quant 2-block cell.

    Returns ``perm`` of shape (2, 64): ``perm[blk, p]`` is the byte offset
    within the 128-byte pair cell where buffer coefficient ``p`` of block
    ``blk`` is stored by the SSE4.1/SSSE3 kernels
    (src/simd_dct.cpp:1662-1670,1822-1830):

      row ``i = p // 8``, col ``j = p % 8``;
      half   = 0 for j in {0,1,4,5}, 1 for j in {2,3,6,7}
      offset = half*64 + i*8 + blk*4 + (j//4)*2 + (j%2)

    With ``as_written=True`` the second half is placed at +128 instead of
    +64 -- reproducing byte-for-byte the kernels as coded
    (``uint16_t*[64..67]`` == byte offset 128, src/simd_dct.cpp:1667-1670),
    where adjacent pair cells OVERLAP: pair t's second half lands exactly on
    pair t+1's first half and is clobbered (and the final pair of a strip
    writes 64 bytes past the strip).  The in-repo benchmark never reads the
    output, so this goes unnoticed there; we default to the evidently
    intended, invertible layout (+64).
    """
    half_base = 128 if as_written else 64
    perm = np.empty((2, 64), dtype=np.int64)
    for blk in range(2):
        for p in range(64):
            i, j = divmod(p, 8)
            half = (j >> 1) & 1
            q = (j // 4) * 2 + (j % 2)
            perm[blk, p] = half * half_base + i * 8 + blk * 4 + q
    return perm


def encode_quantize_golden(image: np.ndarray, lut: np.ndarray,
                           start_y: int = 0, end_y: int | None = None, *,
                           rounding: str = "rne", layout: str = "scalar",
                           legacy_range: bool | None = None,
                           emulate_overlap_bug: bool = False,
                           compat: bool = False) -> np.ndarray:
    """Golden enc-quant: block-contiguous output for the TOP view only.

    Mirrors ``simdDCT_EncodeQuantizeBuffer`` (src/simd_dct.cpp:93-111):
    pixels /255, 2-D DCT *without* leading transpose (DCT rows -> transpose
    -> DCT rows, src/simd_dct.cpp:347-358) so the 64-float buffer is
    fx-major: ``buffer[p] == C[p % 8, p // 8]`` with C (fy, fx) indexed.
    The quant LUT applies in buffer order.

    layout='scalar': 64 contiguous bytes per block, blocks raster order
    (src/simd_dct.cpp:361-364).  layout='pair': the SIMD kernels' 2-block
    128-byte cells (see pair_cell_permutation).
    """
    img = np.asarray(image, np.uint8)
    h, w = img.shape
    if layout == "pair_as_written":
        layout, emulate_overlap_bug = "pair", True
    if end_y is None:
        end_y = h
    if legacy_range is None:
        legacy_range = (layout == "scalar" and rounding == "scalar")
    # H % 16 == 8: the reference's strip loop (y < H/2, src/simd_dct.cpp:
    # 268) lets the last strip read 4 rows past the first view and write
    # ceil((H/2)/8)*8*W bytes — spill semantics reproduced here (and in
    # the C++ oracle) so the api-level rejection is a *documented,
    # testable* deviation (SURVEY.md §7 "odd geometry rules").
    out = np.zeros(-(-(h // 2) // 8) * 8 * w, np.uint8)
    perm = pair_cell_permutation(emulate_overlap_bug) if layout == "pair" else None
    for y in _strips(h, start_y, end_y, legacy_range):
        strip_base = y * w
        for bx in range(w // 8):
            x = bx * 8
            block = img[y:y + 8, x:x + 8].astype(np.float32) * np.float32(1.0 / 255.0)
            buffer64 = _buffer_fx(block, compat)  # fx-major buffer order
            bytes64 = _quantize(buffer64, lut, rounding, compat)
            if layout == "scalar":
                out[strip_base + bx * 64: strip_base + bx * 64 + 64] = bytes64
            elif layout == "pair":
                cell = strip_base + (bx // 2) * 128
                offs = cell + perm[bx % 2]
                if emulate_overlap_bug:
                    valid = offs < out.size
                    out[offs[valid]] = bytes64[valid]
                else:
                    out[offs] = bytes64
            else:
                raise ValueError(f"unknown layout {layout!r}")
    return out


def decode_quantize_golden(data: np.ndarray, lut: np.ndarray, size_x: int,
                           size_y: int, *, layout: str = "scalar") -> np.ndarray:
    """Inverse of encode_quantize_golden (north-star decode; no reference
    analog).  Returns the reconstructed TOP view, shape (size_y//2, size_x)."""
    lut = np.asarray(lut, np.float32)
    q = (lut * VR) / np.float32(255.0)
    out = np.zeros((size_y // 2, size_x), np.uint8)
    data = np.asarray(data, np.uint8)
    perm = pair_cell_permutation(False) if layout == "pair" else None
    for y in range(0, size_y // 2, 8):
        strip_base = y * size_x
        for bx in range(size_x // 8):
            if layout == "scalar":
                bytes64 = data[strip_base + bx * 64: strip_base + bx * 64 + 64]
            elif layout == "pair":
                cell = strip_base + (bx // 2) * 128
                bytes64 = data[cell + perm[bx % 2]]
            else:
                raise ValueError(f"unknown layout {layout!r}")
            buffer64 = (bytes64.astype(np.float32) - np.float32(127.0)) * q
            c = buffer64.reshape(8, 8).T  # undo fx-major
            block = _idct2d(c) * np.float32(255.0)
            out[y:y + 8, bx * 8: bx * 8 + 8] = np.clip(
                np.rint(block), 0, 255).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# enc-quant32 (group-of-8 coefficient-major): simdDCT_EncodeQuantize32ReorderBuffer
# ---------------------------------------------------------------------------

def encode_quantize32_golden(image: np.ndarray, lut: np.ndarray,
                             start_y: int = 0, end_y: int | None = None, *,
                             rounding: str = "rne",
                             compat: bool = False) -> np.ndarray:
    """Golden enc-quant32: 8-block-group coefficient-major, TOP view only.

    Mirrors ``simdDCT_EncodeQuantize32ReorderBuffer`` AVX-512 semantics
    (src/simd_dct.cpp:1869-2059): pixels kept RAW 0..255 (no /255 -- the
    quant multiplier is still 255/(lut*0.95), a deliberate 255x difference
    vs the other modes), fy-major coefficient order, and per 8-block group
    the output is coefficient-major: ``out[g*512 + p*8 + b]`` = coefficient
    p of block b (src/simd_dct.cpp:2021-2025).  Requires W % 64 == 0
    (src/simd_dct.cpp:118).
    """
    img = np.asarray(image, np.uint8)
    h, w = img.shape
    if end_y is None:
        end_y = h
    out = np.zeros(-(-(h // 2) // 8) * 8 * w, np.uint8)  # spill, see above
    for y in _strips(h, start_y, end_y, False):
        strip_base = y * w
        for g in range(w // 64):
            group = np.empty((64, 8), np.uint8)
            for b in range(8):
                x = g * 64 + b * 8
                block = img[y:y + 8, x:x + 8].astype(np.float32)  # raw 0..255
                buffer64 = _buffer_fy(block, compat)  # fy-major
                group[:, b] = _quantize(buffer64, lut, rounding, compat)
            out[strip_base + g * 512: strip_base + (g + 1) * 512] = group.reshape(512)
    return out


def decode_quantize32_golden(data: np.ndarray, lut: np.ndarray, size_x: int,
                             size_y: int) -> np.ndarray:
    """Inverse of encode_quantize32_golden; returns TOP view."""
    lut = np.asarray(lut, np.float32)
    q = (lut * VR) / np.float32(255.0)
    out = np.zeros((size_y // 2, size_x), np.uint8)
    data = np.asarray(data, np.uint8)
    for y in range(0, size_y // 2, 8):
        strip_base = y * size_x
        for g in range(size_x // 64):
            group = data[strip_base + g * 512: strip_base + (g + 1) * 512]
            group = group.reshape(64, 8)
            for b in range(8):
                buffer64 = (group[:, b].astype(np.float32) - np.float32(127.0)) * q
                c = buffer64.reshape(8, 8)  # fy-major
                block = _idct2d(c)  # raw-0..255 domain already
                x = g * 64 + b * 8
                out[y:y + 8, x:x + 8] = np.clip(np.rint(block), 0, 255).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# enc-quant-stereo (fully coefficient-planar, both views):
# simdDCT_EncodeQuantizeReorderStereoBuffer
# ---------------------------------------------------------------------------

def encode_quantize_stereo_golden(image: np.ndarray, lut: np.ndarray,
                                  start_y: int = 0, end_y: int | None = None, *,
                                  rounding: str = "rne",
                                  compat: bool = False) -> np.ndarray:
    """Golden stereo planar encode.

    Mirrors ``simdDCT_EncodeQuantizeReorderStereoBuffer``
    (src/simd_dct.cpp:177-298): EXTRA leading transpose before the first DCT
    (src/simd_dct.cpp:224-227) so the 64-float buffer is fy-major
    (transposed vs enc-quant); output is 64 coefficient planes of
    ``W*H/64`` bytes (plane p at ``p * W*H/64``, src/simd_dct.cpp:258-264).
    Per 8-row strip each plane receives W/8 bytes from the LEFT view then
    W/8 bytes from the RIGHT view (right view starts at row H/2,
    src/simd_dct.cpp:284-294), i.e. the per-strip plane cursor advances
    W/4 (src/simd_dct.cpp:275).
    """
    img = np.asarray(image, np.uint8)
    h, w = img.shape
    if h % 16:
        # the reference's right-view read would run past the input buffer
        # (src/simd_dct.cpp:292) — undefined behavior, not reproduced
        raise ValueError("stereo requires H % 16 == 0 (reference UB)")
    if end_y is None:
        end_y = h
    plane_size = (w * h) // 64
    out = np.zeros(64 * plane_size, np.uint8)
    blocks_per_row = w // 8
    for y in _strips(h, start_y, end_y, False):
        strip_idx = y // 8
        cursor = strip_idx * (w // 4)  # per-plane byte offset of this strip
        for view in range(2):  # 0 = left (top half), 1 = right (bottom half)
            y_src = y + view * (h // 2)
            for bx in range(blocks_per_row):
                x = bx * 8
                block = img[y_src:y_src + 8, x:x + 8].astype(np.float32) * np.float32(1.0 / 255.0)
                # The (transpose, DCT, transpose, DCT) sequence of the
                # reference leaves the buffer fy-major == C row-major,
                # with C = D @ X @ D.T of the original (row, col) block.
                buffer64 = _buffer_fy(block, compat)
                bytes64 = _quantize(buffer64, lut, rounding, compat)
                pos = cursor + view * blocks_per_row + bx
                out[np.arange(64) * plane_size + pos] = bytes64
    return out


def decode_quantize_stereo_golden(data: np.ndarray, lut: np.ndarray,
                                  size_x: int, size_y: int) -> np.ndarray:
    """Inverse of encode_quantize_stereo_golden; returns full (H, W) image
    (both views)."""
    lut = np.asarray(lut, np.float32)
    q = (lut * VR) / np.float32(255.0)
    w, h = size_x, size_y
    plane_size = (w * h) // 64
    data = np.asarray(data, np.uint8)
    out = np.zeros((h, w), np.uint8)
    blocks_per_row = w // 8
    for y in range(0, h // 2, 8):
        cursor = (y // 8) * (w // 4)
        for view in range(2):
            y_dst = y + view * (h // 2)
            for bx in range(blocks_per_row):
                pos = cursor + view * blocks_per_row + bx
                bytes64 = data[np.arange(64) * plane_size + pos]
                buffer64 = (bytes64.astype(np.float32) - np.float32(127.0)) * q
                c = buffer64.reshape(8, 8)  # fy-major
                block = _idct2d(c) * np.float32(255.0)
                out[y_dst:y_dst + 8, bx * 8: bx * 8 + 8] = np.clip(
                    np.rint(block), 0, 255).astype(np.uint8)
    return out
