#!/usr/bin/env python3
"""Time variants of the tile kernel, the tile inverse (``tiles_kernel`` and
``detile_kernel`` in ``csrc/tiles.cu``) and the fused mode32 round trip
(``roundtrip32_kernel`` in ``csrc/dct32.cu``) against each other on one
CUDA card, in turns, in one process, and hold their bytes to the
package's.

    python3 tiles_variants.py [--rounds N] [--reps N] [--parent DIR]
                              [--kernels K,...] [--only NAME ...]

The tile kernels are timed on the 2048x3840 top view of a 4K image and on
8 views of 1024x1920, raw and 'fy' (mode32's configuration, as
``chip_smoke.py`` times them); the round trip on the 4096x3840 image and
on an 8-frame 1088x1920 batch; each by CUDA events around a rotation
queued behind a device sleep and by the profiler:

* the package's kernels, and the same kernels launched on the fewest CTAs
  that take their tiles in as few rounds as the card's capacity does (the
  package launches as many CTAs as the card holds at once);
* builds of ``csrc/tiles.cu`` or ``csrc/dct32.cu`` with a source edit (of it
  or of the headers it includes), made at run time under the port's build
  directory (which git ignores) and never used by the package.  The tile
  inverse: two threads an 8x8 block instead of four, two input buffers, two
  pixel buffers, two of each, ``__launch_bounds__`` asking for 16 CTAs an
  SM (a register cap).  The tile kernel: two threads a block, two pixel
  tiles in flight, two Z buffers, two of each, the register cap.  The round
  trip: the crossed form (its code is in this script: eight threads a
  block, three crossings through shared memory; tiles of 16 or 32 blocks
  of one strip; no occupancy hint), the whole form on tiles of 32 blocks of
  one strip, one or four warps a CTA instead of two, one input buffer, one
  pixel buffer, ``__launch_bounds__`` asking for 20 or 28 warps an SM
  instead of 24, or for none.  All three: the DCT basis
  read from dct_common.cuh's constant bank (``kD``), and the byte
  conversions on the conversion unit (``(float)b``, ``rintf`` and int
  casts: the same bytes).  For timing only (their bytes are logged, not
  required): the arithmetic skipped at run time (the round trip: its first
  three passes), or the tensor loads and stores;
* with ``--parent``, a checkout of an earlier version of the repository:
  its ``tiles.cu`` and ``dct32.cu`` built alone the same way and called
  through that version's C entry points (with or without the launch plan's
  arguments, by the entry points it has).  First every byte of the
  package's kernels must equal it: the tile kernel on ``chip_smoke.py``'s
  TILE_GEOMETRIES, both orientations, with and without ``normalize``, in
  every rounding; the tile inverse there on the tiles of random views and
  on random bytes; the round trip on 4096x3840, 1088x1920, 256x192 (W % 128
  == 64), 16x1984, an 8-frame 1088x1920 batch and frames read further apart
  than the view, at two quality levels.  Then the earlier kernels are timed
  with the others.

``--kernels`` times only the named kernels (the byte checks run whole);
``--only`` builds only the named variants; ``--sass`` first prints the
static instruction count of each timed kernel by opcode.  A build whose bytes must equal
the package's is checked on both timing cases first.  The SM clock and
power under each package kernel and the earlier version's (nvidia-smi
samples over 1.5 s) come first.  One line a run, then a JSON summary.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from color_variants import build_lib, clock_under_load
from simd_dct_tpu_torch.core.quantize import default_quant_lut
from simd_dct_tpu_torch.kernels import _build, cuda_dct as K, panel

DET, TIL, RT = "detile", "tiles", "roundtrip32"
KINDS = (DET, TIL, RT)
SOURCE = {DET: "tiles.cu", TIL: "tiles.cu", RT: "dct32.cu"}
# (label, H2 or H, W, frames, rotation): the tile kernels take (H2, W)
# views, the round trip (H, W) dual-view images
CASES = {TIL: [("2048x3840 top view", 2048, 3840, 1, 16),
               ("8x1024x1920 views", 1024, 1920, 8, 6)],
         RT: [("4096x3840 image", 4096, 3840, 1, 16),
              ("8x1088x1920 batch", 1088, 1920, 8, 6)]}
CASES[DET] = CASES[TIL]
ROUND_TRIP_IMAGES = [(4096, 3840, 1), (1088, 1920, 1), (256, 192, 1),
                     (16, 1984, 1), (1088, 1920, 8)]
ORIENTATIONS = ("fy", "fx")
_ARRIVE = ('  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"('
           'saddr(bar)) : "memory");\n  return;\n')
# tile_common.cuh tensor_load_3d's arming: the builds without loads arrive
# without bytes there and copy nothing (dct32.cu and encq.cu take their 3-D
# pixel tiles through it)
_TENSOR_LOAD = "  arrive_expect(bar, bytes);\n"
# tile_common.cuh: the basis table and the byte conversions
_BASIS = "  return t[i];\n}"
_DEQ = ("  return __fmul_rn(__fsub_rn(__int_as_float(0x4B000000u | b), "
        "kTwo23 + 127.0f), q);\n")
_PACK = ("  return rint_bits(fminf(fmaxf(N ? __fmul_rn(y, 255.0f) : y, 0.0f), "
         "255.0f));\n")
_BYTE = ("  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B00u, 0x5440 + "
         "i)), kTwo23);\n")
_RINT = "  return __fsub_rn(__fadd_rn(x, kRound), kRound);\n"
_QUANT = ("  if (R == kRne) return (uint8_t)(rint_bits(fminf(fmaxf(x, "
          "-127.0f), 128.0f)) + 127u);\n")
_UNIT = [(_DEQ, "  return __fmul_rn((float)b - 127.0f, q);\n"),
         (_PACK, "  return (uint32_t)(int)fminf(fmaxf(rintf(N ? __fmul_rn("
                 "y, 255.0f) : y), 0.0f), 255.0f);\n"),
         (_BYTE, "  return (float)((w >> (8 * i)) & 0xffu);\n"),
         (_RINT, "  return rintf(x);\n"),
         (_QUANT, "  if (R == kRne) return (uint8_t)(int)(fminf(fmaxf("
                  "rintf(x), -127.0f), 128.0f) + 127.0f);\n")]


def _const(name: str, old, new) -> tuple[str, str]:
    return (f"constexpr {name} = {old};", f"constexpr {name} = {new};")


# tiles.cu: the two kernels' loops of arithmetic, and their loads and stores
_DET_LOOPS = ["for (int h = 0; h < kDetileLines; ++h) {\n      // column v",
              "for (int h = 0; h < kDetileLines; ++h) {\n      // row j"]
_TIL_LOOPS = ["for (int h = 0; h < kTilesLines; ++h) {\n      // t[u][k]",
              "for (int h = 0; h < kTilesLines; ++h) {\n      // row u"]
_TILE_NO_MEMORY = [("  arrive_expect(bar, kStripBytes);\n", _ARRIVE),
                   ("if (storer) store_rows16(",
                    "if (storer && g.nj == 0) store_rows16("),
                   ("if (storer) store_z(", "if (storer && g.nj == 0) store_z(")]
# dct32.cu: the whole form's first three passes, its loads and stores
_RT_FIRST = ("#pragma unroll\n    for (int k = 0; k < 8; ++k) {  // t[u][k] = "
             "sum_j D[u][j] x[j][k]")
_RT_AFTER = "    uint8_t* o = outs + (i % kRtOutBuffers) * kRtTileBytes;\n    //"
# the occupancy hint taken away (the crossed form runs without)
_RT_NO_HINT = ("__launch_bounds__(kRtThreads, kRtCtas)",
               "__launch_bounds__(kRtThreads)")
# The crossed form of the round trip, built into dct32.cu in place of the
# package's (one thread a block, whole in registers) for the comparison.
_RT_CROSSED_FN = r"""
// The crossed form (roundtrip32_rgb_kernel's without the mix): eight
// threads a block; lane l of warp w holds block b = 16 * (w % H) + (l & 15)
// of the tile (H halves of 16 blocks) and index x = 2 (w / H) + (l >> 4): as
// column x it runs dct2d's column pass, as row x the row pass and the
// quantizer, as column x idct2d's first pass and as row x its second, the
// values crossing through cross_at (the half as its channel) between them.
__device__ __forceinline__ void roundtrip_crossed(const Scales& q, const Scales& qi,
                                                  const RtGeom& g, const CUtensorMap* tin,
                                                  const CUtensorMap* tout, uint8_t* smem,
                                                  uint64_t (&bars)[kRtStages]) {
  constexpr int H = kRtTileBlocks / 16;
  float* sq = reinterpret_cast<float*>(smem);
  float* sqi = sq + 64;
  uint8_t* stages = smem + 2 * 64 * 4;  // 128-byte aligned, as the tensor copies want
  uint8_t* outs = stages + kRtStages * kRtTileBytes;
  float* cross = reinterpret_cast<float*>(outs + kRtOutBuffers * kRtTileBytes);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ch = warp % H, x = 2 * (warp / H) + (lane >> 4), b = lane & 15;
  const int col = 8 * (16 * ch + b);      // the block's first pixel column in the tile
  const bool storer = threadIdx.x == 32;  // lane 0 of warp 1
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i) sq[i] = q.v[i], sqi[i] = qi.v[i];
#pragma unroll
    for (int s = 0; s < kRtStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(saddr(&bars[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kRtStages; ++s)
      rt_load(tin, g, blockIdx.x + s * gridDim.x, stages + s * kRtTileBytes, &bars[s]);
  }
  unsigned i = 0;  // the CTA's tile count
  for (unsigned t = blockIdx.x; t < g.tiles; t += gridDim.x, ++i) {
    const unsigned s = i % kRtStages;
    wait_full(&bars[s], (i / kRtStages) & 1);
    {  // column x: t[u][x] = sum_j D[u][j] x[j][x]
      const uint8_t* in = stages + s * kRtTileBytes + col + x;
      float xc[8], tc[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) xc[r] = u8f(in[r * kRtRow]);
      dct_column(xc, tc);
#pragma unroll
      for (int u = 0; u < 8; ++u) cross[cross_at(ch, u, x, b)] = tc[u];
    }
    if (storer) bulk_wait_read<kRtOutBuffers - 1>();
    __syncthreads();
    if (threadIdx.x == 0)
      rt_load(tin, g, t + kRtStages * gridDim.x, stages + s * kRtTileBytes, &bars[s]);
    float c[8];
    {  // row x: c[x][v] = sum_k t[x][k] D[v][k], requantized
      float tr[8], qv[8], qiv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) tr[k] = cross[cross_at(ch, x, k, b)];
      dct_row(tr, c);
      row_scales(sq, x, qv);
      row_scales(sqi, x, qiv);
#pragma unroll
      for (int v = 0; v < 8; ++v) c[v] = requant(c[v], qv[v], qiv[v]);
    }
    __syncthreads();
#pragma unroll
    for (int v = 0; v < 8; ++v) cross[cross_at(ch, x, v, b)] = c[v];
    __syncthreads();
    {  // column x: t[j][x] = sum_u D[u][j] c[u][x]
      float cu[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) cu[u] = cross[cross_at(ch, u, x, b)];
      idct_column(cu, c);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) cross[cross_at(ch, j, x, b)] = c[j];
    __syncthreads();
    // row x: x[x][k] = sum_v t[x][v] D[v][k], rounded and packed
    uint8_t* o = outs + (i % kRtOutBuffers) * kRtTileBytes;
    float tv[8];
#pragma unroll
    for (int v = 0; v < 8; ++v) tv[v] = cross[cross_at(ch, x, v, b)];
    *reinterpret_cast<uint2*>(o + x * kRtRow + col) = idct_row_pixels<false>(tv);
    fence_async_shared();
    __syncthreads();
    if (storer) rt_store(tout, g, t, o);
  }
  if (storer) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

"""
_RT_KERNEL = "// Replaces simd_dct_tpu/kernels/pallas_dct.py _roundtrip_kernel."
_RT_CROSSED = [
    _const("int kRtTileStrips", 2, 1), _const("int kRtWarps", 2, 1),
    _const("int kRtThreads", "32 * kRtWarps", "8 * kRtTileBlocks"),
    ('static_assert(kRtTileStrips * kRtTileBlocks == 32, "a warp a tile");',
     ""),
    _const("int kRtSmem",
           "kRtWarps * (kRtStages + kRtOutBuffers) * kRtTileBytes",
           "2 * 64 * 4 + (kRtStages + kRtOutBuffers) * kRtTileBytes + "
           "4 * 64 * kRtTileBlocks"),
    _RT_NO_HINT,
    ("  roundtrip_whole(q, qi, g, &tin, &tout, smem, full[threadIdx.x >> 5]);",
     "  roundtrip_crossed(q, qi, g, &tin, &tout, smem, full[0]);"),
    (_RT_KERNEL, _RT_CROSSED_FN.lstrip("\n") + _RT_KERNEL)]
# the package's kernels on the fewest CTAs that take their tiles in as few
# rounds as the plan's grid
EVEN = "grid of even rounds"
# name -> (edits of the source or its headers, the kernels it is timed
# for, timing only)
BUILDS = {
    "detile: two threads a block": (
        [_const("int kDetileBlockThreads", 4, 2)], (DET,), False),
    "detile: two input buffers": (
        [_const("int kDetileStages", 1, 2)], (DET,), False),
    "detile: two pixel buffers": (
        [_const("int kDetileOutBuffers", 1, 2)], (DET,), False),
    "detile: 16 CTAs an SM": (
        [("__launch_bounds__(kDetileThreads)",
          "__launch_bounds__(kDetileThreads, 2048 / kDetileThreads)")],
        (DET,), False),
    "tiles: two threads a block": (
        [_const("int kTilesBlockThreads", 4, 2)], (TIL,), False),
    "tiles: two pixel tiles in flight": (
        [_const("int kTilesStages", 1, 2)], (TIL,), False),
    "tiles: two Z buffers": (
        [_const("int kTilesOutBuffers", 1, 2)], (TIL,), False),
    "tiles: two of each buffer": (
        [_const("int kTilesStages", 1, 2),
         _const("int kTilesOutBuffers", 1, 2)], (TIL,), False),
    "tiles: 16 CTAs an SM": (
        [("__launch_bounds__(kTilesThreads)",
          "__launch_bounds__(kTilesThreads, 2048 / kTilesThreads)")],
        (TIL,), False),
    "round trip: crossed, 16 blocks": (_RT_CROSSED, (RT,), False),
    "round trip: crossed, 32 blocks": (
        _RT_CROSSED + [_const("int kRtTileBlocks", 16, 32)], (RT,), False),
    "round trip: tiles of one strip, 32 blocks": (
        [_const("int kRtTileStrips", 2, 1),
         _const("int kRtTileBlocks", 16, 32)], (RT,), False),
    "round trip: one warp a CTA": (
        [_const("int kRtWarps", 2, 1)], (RT,), False),
    "round trip: four warps a CTA": (
        [_const("int kRtWarps", 2, 4)], (RT,), False),
    "round trip: one input buffer": (
        [_const("int kRtStages", 2, 1)], (RT,), False),
    "round trip: one pixel buffer": (
        [_const("int kRtOutBuffers", 2, 1)], (RT,), False),
    "round trip: no CTAs-an-SM hint": ([_RT_NO_HINT], (RT,), False),
    "round trip: 20 warps an SM": (
        [_const("int kRtCtas", "24 / kRtWarps", "20 / kRtWarps")], (RT,),
        False),
    "round trip: 28 warps an SM": (
        [_const("int kRtCtas", "24 / kRtWarps", "28 / kRtWarps")], (RT,),
        False),
    "basis from the constant bank": (
        [(_BASIS, "  return kD[i];\n}")], KINDS, False),
    "conversions by the unit": (_UNIT, KINDS, False),
    "tile kernels: no arithmetic": (
        [(loop, loop.replace("h < k", "h < (g.nj == 0) * k"))
         for loop in _DET_LOOPS + _TIL_LOOPS], (DET, TIL), True),
    "tile kernels: no loads and no stores": (_TILE_NO_MEMORY, (DET, TIL),
                                             True),
    "round trip: no first three passes": (
        [(_RT_FIRST, "if (g.tiles == 0) {\n" + _RT_FIRST),
         (_RT_AFTER, "    }\n" + _RT_AFTER)], (RT,), True),
    "round trip: no loads and no stores": (
        [(_TENSOR_LOAD, _ARRIVE),
         ("if (lane == 0) rt_store(", "if (lane == 0 && g.tiles == 0) rt_store(")],
        (RT,), True),
}


def load_lib(proc: subprocess.Popen, name: str, kinds) -> ctypes.CDLL:
    """The library a build made, its C interfaces bound by the entry points
    it has (with or without the launch plan's arguments).  Prints the
    ptxas lines of the given kernels."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif (any(f"{k}_kernel" in entry for k in kinds)
              and ("registers" in line or "stack" in line)):
            print(f"  ptxas {name}: {line.strip()}", flush=True)
    dll = ctypes.CDLL(proc.lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(dll, "sdct_tiles"):
        dll.sdct_detile_capacity.argtypes = [i, i, p, p, p]
        dll.sdct_detile.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        if hasattr(dll, "sdct_tiles_capacity"):
            dll.sdct_tiles_capacity.argtypes = [i, i, i, p, p, p]
            dll.sdct_tiles.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
        else:
            dll.sdct_tiles.argtypes = [p, p, p, i, i, i, i, i, i, p]
    if hasattr(dll, "sdct_roundtrip32"):
        if hasattr(dll, "sdct_roundtrip32_capacity"):
            dll.sdct_roundtrip32_capacity.argtypes = [p, p, p, p, p, p]
            dll.sdct_roundtrip32.argtypes = [p, p, p, p, i, i, i, ll, i, i, p]
        else:
            dll.sdct_roundtrip32.argtypes = [p, p, p, p, i, i, i, ll, p]
    return dll


def _check(rc, what):
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _capacity(fn, *args, n: int = 3) -> np.ndarray:
    out = np.zeros(n, np.int32)
    _check(fn(*args, *(out.ctypes.data + 4 * i for i in range(n))),
           "capacity")
    return out


def lib_calls(dll, even: bool = False) -> dict:
    """The kernels of a library through its C entry points, each with the
    package's plan for the capacity and the shared bytes that library
    reports: ``detile(tiles, qi, normalize, orientation)``, ``tiles(view,
    q, normalize, orientation, rounding)`` and ``roundtrip32(img, q, qi,
    h2=, frame_stride=)`` (the top H/2 rows of each frame by default).
    The grid is the plan's (as many CTAs as the card holds, at most one a
    tile), or with ``even`` the fewest CTAs that take the tiles in as few
    rounds."""

    def grid_of(plan_grid, ctas, slots):
        return -(-ctas // -(-ctas // slots)) if even else plan_grid

    calls = {}
    if hasattr(dll, "sdct_tiles"):
        caps = {}

        def plan_args(kind, cap_fn, cap_key, n, h2, w, base):
            if cap_key not in caps:
                caps[cap_key] = _capacity(cap_fn, *cap_key[1:])
            cap = caps[cap_key]
            plan = K._strip_plan(kind, int(cap[0]), n, h2, w, base,
                                 lambda: (int(cap[1]), int(cap[2])))
            return (grid_of(plan.grid, plan.tiles, int(cap[1] * cap[2])),
                    plan.smem)

        def detile(tiles, qi, normalize, orientation):
            p, _, nj, _ = tiles.shape[-4:]
            h2, w = 128 * p, 128 * nj
            n = tiles.numel() // (h2 * w)
            out = torch.empty(tiles.shape[:-4] + (h2, w), dtype=torch.uint8,
                              device=tiles.device)
            o = K._ORIENTATION_CODE[orientation]
            extra = plan_args(DET, dll.sdct_detile_capacity,
                              (DET, int(normalize), o), n, h2, w,
                              tiles.data_ptr())
            _check(dll.sdct_detile(tiles.data_ptr(), out.data_ptr(),
                                   qi.ctypes.data, n, h2, w, int(normalize),
                                   o, *extra, K._stream(tiles)), DET)
            return out

        def tiles(view, q, normalize, orientation, rounding="rne"):
            h2, w = view.shape[-2:]
            n = view.numel() // (h2 * w)
            out = torch.empty(view.shape[:-2] + (h2 // 128, 128, w // 128,
                                                 128),
                              dtype=torch.uint8, device=view.device)
            o = K._ORIENTATION_CODE[orientation]
            r = K._ROUNDING_CODE[rounding]
            extra = ()
            if hasattr(dll, "sdct_tiles_capacity"):
                extra = plan_args(TIL, dll.sdct_tiles_capacity,
                                  (TIL, r, int(normalize), o), n, h2, w,
                                  view.data_ptr())
            _check(dll.sdct_tiles(view.data_ptr(), out.data_ptr(),
                                  q.ctypes.data, n, h2, w, int(normalize), o,
                                  r, *extra, K._stream(view)), TIL)
            return out

        calls[DET], calls[TIL] = detile, tiles
    if hasattr(dll, "sdct_roundtrip32"):
        planned = hasattr(dll, "sdct_roundtrip32_capacity")
        cap = _capacity(dll.sdct_roundtrip32_capacity, n=6) if planned \
            else None

        def roundtrip32(img, q, qi, h2=None, frame_stride=None):
            h, w = img.shape[-2:]
            h2 = h // 2 if h2 is None else h2
            stride = h * w if frame_stride is None else frame_stride
            n = img.numel() // (h * w)
            out = torch.empty((n, h2, w), dtype=torch.uint8,
                              device=img.device)
            extra = ()
            if planned:
                smem, per_sm, sms, blocks, strips, workers = (int(v)
                                                              for v in cap)
                tiles = n * -(-(h2 // 8) // strips) * -(-(w // 8) // blocks)
                ctas = -(-tiles // workers)
                extra = (grid_of(min(ctas, per_sm * sms), ctas, per_sm * sms),
                         smem)
            _check(dll.sdct_roundtrip32(img.data_ptr(), out.data_ptr(),
                                        q.ctypes.data, qi.ctypes.data, n, h2,
                                        w, stride, *extra, K._stream(img)),
                   RT)
            return out.view(img.shape[:-2] + (h2, w))

        calls[RT] = roundtrip32
    return calls


def sass_counts(lib: str, kinds) -> dict:
    """Instructions of each kernel instantiation of the given kinds in the
    package's library, by opcode (``cuobjdump -sass`` from the toolkit of
    ``nvcc``): the static count of the whole function, loop and prologue
    together."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function : " in line:
            fn = line.split("Function : ")[1].strip()
            name = next((k for k in kinds if f"{k}_kernel" in fn), None)
            if name:
                name = fn
                out[name] = {}
        elif name and line.strip().startswith("/*") and "*/" in line:
            ins = line.split("*/", 1)[1].strip().lstrip("{").strip()
            if ins and not ins.startswith("/*"):
                op = ins.split()[0] if not ins.startswith("@") \
                    else ins.split()[1]
                op = op.split(".")[0].rstrip(";")
                out[name][op] = out[name].get(op, 0) + 1
    return {k: {"total": sum(v.values()),
                "ops": dict(sorted(v.items(), key=lambda kv: -kv[1])[:16])}
            for k, v in out.items()}


def tile_scales(normalize: bool):
    """(quant, dequant) host scales: the 1/255 domain when normalized,
    mode32's raw domain otherwise (chip_smoke.py's LUTs)."""
    lut = default_quant_lut(50) * (1 if normalize else np.float32(255.0))
    return cs.tile_scales(lut)


def rt_scales(quality: int):
    """Mode32's (quant, dequant) host scales at a quality."""
    return K._host_scales(default_quant_lut(quality) * np.float32(255.0))


def parent_equal(gen, pkg, parent) -> dict:
    """The package's kernels against the earlier version's: the mismatches
    of each comparison (all must be 0)."""
    out = {}

    def count(key, got, want):
        n = int((got != want).sum())
        out[key] = n
        print(f"  parent {key}: {n} mismatches", flush=True)
        cs.require(n == 0, f"{key} equals the earlier version's bytes")

    for h2, w, frames in cs.TILE_GEOMETRIES:
        view = cs.random_images(gen, h2, w, frames)
        tag = f"{frames}x{h2}x{w}"
        for normalize in (False, True):
            q, qi = tile_scales(normalize)
            for o in ORIENTATIONS:
                for rounding in cs.ROUNDINGS:
                    count(f"tiles {tag} {o} normalize={normalize} {rounding}",
                          pkg[TIL](view, q, normalize, o, rounding),
                          parent[TIL](view, q, normalize, o, rounding))
                coded = pkg[TIL](view, q, normalize, o)
                noise = torch.randint(0, 256, coded.shape, generator=gen,
                                      dtype=torch.uint8, device="cuda")
                for what, tiles in (("coded", coded), ("random", noise)):
                    count(f"detile {tag} {o} normalize={normalize} {what}",
                          pkg[DET](tiles, qi, normalize, o),
                          parent[DET](tiles, qi, normalize, o))
    for quality in (50, 100):
        q, qi = rt_scales(quality)
        for h, w, frames in ROUND_TRIP_IMAGES:
            img = cs.random_images(gen, h, w, frames)
            count(f"roundtrip32 {frames}x{h}x{w} q{quality}",
                  pkg[RT](img, q, qi), parent[RT](img, q, qi))
        # three 128x192 views, frames of 288 rows (55,296 bytes) apart
        img = cs.random_images(gen, 288, 192, 3)
        count(f"roundtrip32 3x128x192 frame stride 55296 q{quality}",
              pkg[RT](img, q, qi, h2=128), parent[RT](img, q, qi, h2=128))
    return out


def package_calls() -> dict:
    """The package's kernels with ``lib_calls``' signatures."""
    return {
        DET: lambda t, qi, nz, o: K.detile_panels(t, qi, normalize=nz,
                                                  orientation=o),
        TIL: lambda v, q, nz, o, r="rne": K.tiles_panels(
            v, q, normalize=nz, rounding=r, orientation=o),
        RT: lib_calls(_build.load())[RT]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", help="a checkout of an earlier version")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--kernels", default=",".join(KINDS),
                    help="the kernels to time, comma-separated")
    ap.add_argument("--only", nargs="*", help="build only these variants")
    ap.add_argument("--sass", action="store_true",
                    help="first print each timed kernel's instructions by "
                    "opcode")
    args = ap.parse_args(argv)
    timed_kinds = [k for k in args.kernels.split(",") if k]
    if not set(timed_kinds) <= set(KINDS):
        ap.error(f"--kernels takes {', '.join(KINDS)}")
    if not torch.cuda.is_available():
        print("tiles_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    procs = {}   # (build, source) -> (process, kernels, timing only)
    for name, (edits, kinds, timing) in BUILDS.items():
        kinds = [k for k in kinds if k in timed_kinds]
        if not kinds or (args.only is not None and name not in args.only):
            continue
        for src in sorted({SOURCE[k] for k in kinds}):
            procs[name, src] = (build_lib(name, _build.CSRC, edits, src,
                                          "tiles_variants"),
                                [k for k in kinds if SOURCE[k] == src],
                                timing)
    parent_procs = []
    if args.parent:
        src_dir = os.path.join(args.parent, "simd_dct_tpu_torch", "csrc")
        parent_procs = [build_lib("parent", src_dir, (), f, "tiles_variants")
                        for f in ("tiles.cu", "dct32.cu")]
    _build.load()
    if args.sass:
        for fn, counts in sass_counts(_build.build(), timed_kinds).items():
            print(f"sass {fn}: {json.dumps(counts)}", flush=True)
    pkg = package_calls()
    others = {}   # build -> ({kernel: call}, timing only)
    if args.only is None or EVEN in args.only:
        others[EVEN] = (lib_calls(_build.load(), even=True), False)
    for (name, _), (proc, kinds, timing) in procs.items():
        calls = lib_calls(load_lib(proc, name, kinds))
        others.setdefault(name, ({}, timing))[0].update(
            {k: calls[k] for k in kinds})
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {}
    if args.parent:
        parent = {}
        for proc in parent_procs:
            parent.update(lib_calls(load_lib(proc, "parent", KINDS)))
        runs["parent bytes"] = parent_equal(gen, pkg, parent)
        others["parent"] = (parent, False)
    cycles = cs.sleep_cycles_per_ms()

    def time_turns(name, label, variants):
        order = list(variants)
        for r in range(args.rounds):
            for key in order if r % 2 == 0 else order[::-1]:
                call, inputs = variants[key]
                q = cs.queued_ms(call, inputs, args.reps, cycles) * 1e3
                prof, _ = cs.profiled_us(call, inputs)
                runs.setdefault(f"{name} {label} {key}", []).append((q, prof))
                print(f"{name:11s} {label:19s} {key:36s} round {r}: queued "
                      f"{q:8.3f} us  profiler "
                      f"{prof if prof is None else round(prof, 3)}",
                      flush=True)

    q, qi = tile_scales(False)
    qr, qir = rt_scales(50)
    for kind in timed_kinds:
        for label, h, w, frames, n_rot in CASES[kind]:
            imgs = [cs.random_images(gen, h, w, frames) for _ in range(n_rot)]
            if kind == DET:
                inputs = [panel.forward_tiles(v, q, normalize=False,
                                              orientation="fy",
                                              rounding="rne") for v in imgs]
                plan = K.detile_launch_plan(inputs[0])

                def bind(fn):
                    return lambda t: fn(t, qi, False, "fy")
            elif kind == TIL:
                inputs = imgs
                plan = K.tiles_launch_plan(inputs[0])

                def bind(fn):
                    return lambda v: fn(v, q, False, "fy")
            else:
                inputs = imgs
                plan = K.roundtrip32_launch_plan(inputs[0])

                def bind(fn):
                    return lambda x: fn(x, qr, qir)
            print(f"{kind} {label} plan {plan._asdict()}", flush=True)
            want = bind(pkg[kind])(inputs[0])
            variants = {"package": (bind(pkg[kind]), inputs)}
            for b, (calls, timing) in others.items():
                if kind not in calls:
                    continue
                call = bind(calls[kind])
                same = torch.equal(call(inputs[0]), want)
                if not same:
                    print(f"{kind} {b}: bytes differ", flush=True)
                cs.require(same or timing, f"{kind} {b} gives the package's "
                           "bytes")
                variants[b] = (call, inputs)
            for key in ("package", "parent"):
                if key in variants:
                    call, inp = variants[key]
                    clocks = clock_under_load(call, inp)
                    runs[f"{kind} {label} {key} clock"] = clocks
                    print(f"{kind:11s} {label:19s} {key:36s} under load: "
                          f"{clocks}", flush=True)
            time_turns(kind, label, variants)
    summary = {k: v if isinstance(v, dict) else {
                   "queued_us": [x for x, _ in v],
                   "profiler_us": [p for _, p in v],
                   "median_queued_us": statistics.median(x for x, _ in v)}
               for k, v in runs.items()}
    print(json.dumps({"card": smi.stdout.strip(), "runs": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
