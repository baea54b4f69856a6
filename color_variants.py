#!/usr/bin/env python3
"""Time variants of the colour tile kernels (``enc32_rgb_kernel``,
``roundtrip32_rgb_kernel`` and ``dec32_rgb_kernel`` in ``csrc/color32.cu``,
``enc420_rgb_kernel`` and ``dec420_rgb_kernel`` in ``csrc/color420.cu``)
against each other on one CUDA card, in turns, in one process.

    python3 color_variants.py [--rounds N] [--parent DIR] [--kernels K,...]

Each variant is timed on the 4K RGB dual view (3, 4096, 3840) and on an
8-frame (8, 3, 1088, 1920) batch by CUDA events around a rotation queued
behind a device sleep and by the profiler, as ``chip_smoke.py`` times them,
and its bytes are checked against the package's kernels:

* the package's kernels, and the encode's plain-load variant on (3, 2048,
  3840) views 8 bytes off a 16-byte boundary (4K only), against the same
  views aligned;
* builds of ``csrc/color32.cu`` or ``csrc/color420.cu`` with a source edit
  (of it or of the headers it includes), made at run time under the
  port's build directory (which git ignores) and never used by the
  package: the encode's ``__launch_bounds__`` given a least number of CTAs
  an SM (a register cap) or the round trip's taken away; the encode with
  its byte conversions on the conversion unit (``(float)b``, and ``rintf``
  and an int cast in the rne quantizer: the same bytes); the decode with
  eight or two threads an 8x8 block, or one record buffer, or one of each
  buffer, the 4:2:0 encode with two input buffers or two record
  buffers, and the 4:2:0 decode with 2 or 8 warps a CTA (64 or 256
  threads), one record buffer, two pixel buffers or two of each (the same
  bytes); and, for timing only (their bytes are logged, not required), no
  proxy fence before the bulk stores, and the encodes and the decodes
  with their arithmetic, or their loads and stores, skipped at run time
  (the colour encode also its column or its row phase alone);
* with ``--parent``, a checkout of an earlier version of the repository:
  its ``color32.cu`` and ``color420.cu`` built alone the same way, their
  kernels called through that version's C entry points (with or without
  the launch plan's arguments, by its source), and every byte of the
  package's kernels held equal to them first: enc32_rgb (every rounding),
  dec32_rgb and roundtrip32_rgb on chip_smoke.py's COLOR_GEOMETRIES,
  enc420_rgb (every rounding) and dec420_rgb on its GEOMETRIES_420.

``--kernels`` times only the named kernels (the byte checks run whole).
The SM clock and power under each kernel and the earlier version's
(nvidia-smi samples while it runs back to back for 1.5 s) come first.  One
line a run, then a JSON summary.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as cs
from simd_dct_tpu_torch.core.quantize import default_quant_lut
from simd_dct_tpu_torch.kernels import _build, cuda_dct as K, torch_path as TP
from simd_dct_tpu_torch.layout import BASE_CHROMA_QUANT_TABLE

CASES = [("4096x3840 image", 4096, 3840, 1, 8),
         ("8x1088x1920 batch", 1088, 1920, 8, 3)]
ENC, RT, DEC = "enc32_rgb", "roundtrip32_rgb", "dec32_rgb"
E420, D420 = "enc420_rgb", "dec420_rgb"
KINDS = (ENC, RT, DEC, E420, D420)    # timed
SOURCE = {ENC: "color32.cu", RT: "color32.cu", DEC: "color32.cu",
          E420: "color420.cu", D420: "color420.cu"}
_BOUNDS = "__launch_bounds__(kTileThreads)"
_COLUMNS = "    mix_columns(stage, cross, mix, b, x);\n"
_ROWS = ("    uint8_t* rec = recs + half * kTileRec;\n#pragma unroll\n"
         "    for (int ch = 0; ch < 3; ++ch) {")
_ARM = ('  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], '
        '%1;" ::"r"(saddr(bar)),\n               "r"(kTileIn)\n'
        '               : "memory");\n')
_ARRIVE = ('  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" '
           '::"r"(saddr(bar)) : "memory");\n  return;\n')
_NO_COLUMNS = (_COLUMNS,
               "    if (g.w < 0) mix_columns(stage, cross, mix, b, x);\n")
_NO_ROWS = (_ROWS, _ROWS.replace("ch < 3", "ch < (g.w < 0 ? 3 : 0)"))
_NO_LOADS = (_ARM, _ARRIVE)
_NO_STORES = ("  if (lane < 3 * groups) {", "  if (lane < 0) {")
_U8F = "  return __fsub_rn(__int_as_float(0x4B000000u | b), kTwo23);\n"
_QUANT = ("  if (R == kRne) return (uint8_t)(rint_bits(fminf(fmaxf(x, "
          "-127.0f), 128.0f)) + 127u);\n")
# the decode (color32.cu dec32_rgb_kernel)
_DEC_COLUMNS = ("    for (int h = 0; h < kDecLines; ++h) {\n"
                "      // column v of block b")
_DEC_ROWS = "    for (int h = 0; h < kDecLines; ++h) {\n      // row j of block b"
_NO_LINES = ("h < kDecLines", "h < (g.w < 0 ? kDecLines : 0)")
_DEC_NO_MATH = [(_DEC_COLUMNS, _DEC_COLUMNS.replace(*_NO_LINES)),
                (_DEC_ROWS, _DEC_ROWS.replace(*_NO_LINES))]
_DEC_NO_MEMORY = [("  arrive_expect(bar, 3 * 512 * groups);\n", _ARRIVE),
                  ("    if (storer) store_rows(&tout, g, t, pix);\n", "")]
# the 4:2:0 encode (color420.cu enc420_rgb_kernel)
_E420_COLUMNS = "    {\n      // columns 8bc + 2cp + e"
_E420_YROWS = "    for (int h = 0; h < 2; ++h) {\n      const int u = cp + 4 * h;"
_E420_CCOLUMNS = "t[u][x] = sum_j D[u][j] x[j][x]\n    {"
_E420_CROWS = "quantized with the chroma scales\n    {"
_E420_NO_MATH = [
    (_E420_COLUMNS, _E420_COLUMNS.replace("{", "if (g.tiles == 0) {", 1)),
    (_E420_YROWS, _E420_YROWS.replace("h < 2", "h < (g.tiles == 0 ? 2 : 0)")),
    (_E420_CCOLUMNS, _E420_CCOLUMNS.replace("{", "if (g.tiles == 0) {")),
    (_E420_CROWS, _E420_CROWS.replace("{", "if (g.tiles == 0) {"))]
_E420_NO_MEMORY = [("  arrive_expect(bar, k420TileIn);\n", _ARRIVE),
                   ("  if (lane < 6) {", "  if (lane < 0) {")]
# the 4:2:0 decode (color420.cu dec420_rgb_kernel): its five loops of
# arithmetic (Y and chroma columns, Y and chroma rows, the mix) skipped
_D420_LOOPS = [
    "for (int e = 0; e < k420DecY; ++e) {\n      // Y column",
    "for (int e = 0; e < k420DecC; ++e) {\n      // chroma column",
    "for (int h = 0; h < k420DecY; ++h) {\n      float tv[8];",
    "for (int e = 0; e < k420DecC; ++e) {\n      // chroma row",
    "for (int h = 0; h < k420DecY; ++h) {\n      // pixel row"]
_D420_NO_MATH = [(loop, loop.replace(" < k420Dec",
                                     " < (g.tiles == 0) * k420Dec"))
                 for loop in _D420_LOOPS]
_D420_NO_MEMORY = [("  arrive_expect(bar, 6 * 512);\n", _ARRIVE),
                   ("if (storer) store_pixels420(",
                    "if (storer && g.tiles == 0) store_pixels420(")]
# name -> (edits, the kernels it is timed for, timing only)
BUILDS = {
    "conversions by the unit": (
        [(_U8F, "  return (float)b;\n"),
         (_QUANT, "  if (R == kRne) return (uint8_t)(int)(fminf(fmaxf("
                  "rintf(x), -127.0f), 128.0f) + 127.0f);\n")], (ENC,),
        False),
    "encode for 7 CTAs an SM": (
        [(_BOUNDS, "__launch_bounds__(kTileThreads, 7)")], (ENC,), False),
    "encode for 8 CTAs an SM": (
        [(_BOUNDS, "__launch_bounds__(kTileThreads, 8)")], (ENC,), False),
    "round trip uncapped": (
        [("__launch_bounds__(kTileThreads, kRoundtripCtas)", _BOUNDS)], (RT,),
        False),
    "no proxy fence": (
        [("    fence_async_shared();\n", "")], (ENC, RT), True),
    "encode without columns": ([_NO_COLUMNS], (ENC,), True),
    "encode without rows": ([_NO_ROWS], (ENC,), True),
    "encode without either": ([_NO_COLUMNS, _NO_ROWS], (ENC,), True),
    "encode without memory": ([_NO_LOADS, _NO_STORES], (ENC,), True),
    "decode 8 threads a block": (
        [("kDecBlockThreads = 4;", "kDecBlockThreads = 8;")], (DEC,), False),
    "decode 2 threads a block": (
        [("kDecBlockThreads = 4;", "kDecBlockThreads = 2;")], (DEC,), False),
    "decode one record buffer": (
        [("kDecStages = 2;", "kDecStages = 1;")], (DEC,), False),
    "decode one buffer each": (
        [("kDecStages = 2;", "kDecStages = 1;"),
         ("kDecOutBuffers = 2;", "kDecOutBuffers = 1;")], (DEC,), False),
    "decode without arithmetic": (_DEC_NO_MATH, (DEC,), True),
    "decode without memory": (_DEC_NO_MEMORY, (DEC,), True),
    "420 two input buffers": (
        [("k420Stages = 1;", "k420Stages = 2;")], (E420,), False),
    "420 two record buffers": (
        [("k420RecBuffers = 1;", "k420RecBuffers = 2;")], (E420,), False),
    "420 without arithmetic": (_E420_NO_MATH, (E420,), True),
    "420 without memory": (_E420_NO_MEMORY, (E420,), True),
    "420 decode 2 warps": (
        [("k420DecWarps = 4;", "k420DecWarps = 2;")], (D420,), False),
    "420 decode 8 warps": (
        [("k420DecWarps = 4;", "k420DecWarps = 8;")], (D420,), False),
    "420 decode one record buffer": (
        [("k420DecStages = 2;", "k420DecStages = 1;")], (D420,), False),
    "420 decode two pixel buffers": (
        [("k420DecOutBuffers = 1;", "k420DecOutBuffers = 2;")], (D420,),
        False),
    "420 decode one record and two pixel buffers": (
        [("k420DecStages = 2;", "k420DecStages = 1;"),
         ("k420DecOutBuffers = 1;", "k420DecOutBuffers = 2;")], (D420,),
        False),
    "420 decode without arithmetic": (_D420_NO_MATH, (D420,), True),
    "420 decode without memory": (_D420_NO_MEMORY, (D420,), True),
}


def build_lib(name: str, src_dir: str, edits=(), source: str = "color32.cu",
              subdir: str = "color_variants") -> subprocess.Popen:
    """Start nvcc on ``src_dir``'s ``source`` alone, with ``edits`` applied
    to it or to the headers beside it (each edit to the first file that
    holds its text), under ``_build/<subdir>/<name>``."""
    out_dir = os.path.join(_build.BUILD_ROOT, subdir,
                           name.replace(" ", "_") + "_" + source[:-3])
    os.makedirs(out_dir, exist_ok=True)
    texts = {}
    for f in (source, "dct_common.cuh", "tile_common.cuh"):
        path = os.path.join(src_dir, f)
        if os.path.exists(path):      # an earlier version may lack a header
            with open(path) as fin:
                texts[f] = fin.read()
    for old, new in edits:
        hits = [f for f, text in texts.items() if old in text]
        if not hits:
            raise RuntimeError(f"{name}: {old!r} not in {source} or its "
                               "headers")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    for f, text in texts.items():
        with open(os.path.join(out_dir, f), "w") as fout:
            fout.write(text)
    lib = os.path.join(out_dir, f"lib{source[:-3]}.so")
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib,
           os.path.join(out_dir, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.lib = lib
    proc.abi = abi_of(texts[source])
    return proc


def abi_of(text: str) -> dict:
    """Which C interfaces a version of a source has: the colour encode and
    round trip with or without the launch plan's arguments, the decodes
    and the 4:2:0 encode as strip tiles (grid and smem) or not."""
    return {"plan": "sdct_color_capacity" in text,
            "dec_tiles": "kDecSmem" in text,
            "enc420_tiles": "sdct_color420_capacity" in text,
            "dec420_tiles": "sdct_dec420_capacity" in text}


def load_lib(proc: subprocess.Popen, name: str) -> ctypes.CDLL:
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
    for line in log.splitlines():
        if "registers" in line or "stack" in line:
            print(f"  ptxas {name}: {line.strip()}", flush=True)
    dll = ctypes.CDLL(proc.lib)
    dll.abi = proc.abi
    return dll


def lib_calls(dll, luma, chroma) -> dict:
    """The kernels of a separate build of one source, through its C entry
    points, each ``f(x, rounding="rne")``; where the build takes a launch
    plan, the package's plan with the capacity and shared bytes asked of
    that build."""
    ql, qil = K._host_scales(luma)
    qc, qic = K._host_scales(chroma)
    mix = K._COLOR_MIX.ctypes.data
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    abi = dll.abi
    calls = {}

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    def top(x):
        h, w = x.shape[-2:]
        return K._batch_of(x, 3), h // 2, w, h * w

    if hasattr(dll, "sdct_enc32_rgb"):
        plan_abi = [i, i, i] if abi["plan"] else []
        dll.sdct_enc32_rgb.argtypes = [p, p, p, p, p, i, i, i, ll, i,
                                       *plan_abi, p]
        dll.sdct_roundtrip32_rgb.argtypes = [p, p, p, p, p, p, p, i, i, i, ll,
                                             *plan_abi[:2], p]
        dll.sdct_dec32_rgb.argtypes = [p, p, p, p, p, i, i, i,
                                       *([i, i] if abi["dec_tiles"] else []),
                                       p]
        if abi["plan"]:
            dll.sdct_color_capacity.argtypes = [i, i, i, p, p, p]

        def plan_of(kind, base, n, h2, w, ps, rounding):
            out = np.zeros(3, np.int32)
            check(dll.sdct_color_capacity(
                K._KIND_CODE[kind], K._ROUNDING_CODE[rounding],
                K._VARIANT_CODE[K.color_variant(base, ps)], out.ctypes.data,
                out.ctypes.data + 4, out.ctypes.data + 8), "capacity")
            plan = K.color_plan(kind, n, h2, w, base=base, plane_stride=ps,
                                capacity=lambda v: (int(out[1]), int(out[2])))
            return plan._replace(smem=int(out[0]))

        def enc(x, rounding="rne"):
            n, h2, w, ps = top(x)
            out = torch.empty(x.shape[:-2] + (h2 * w,), dtype=torch.uint8,
                              device=x.device)
            extra = ()
            if abi["plan"]:
                plan = plan_of(ENC, x.data_ptr(), n, h2, w, ps, rounding)
                extra = (plan.grid, K._VARIANT_CODE[plan.variant], plan.smem)
            check(dll.sdct_enc32_rgb(
                x.data_ptr(), out.data_ptr(), ql.ctypes.data, qc.ctypes.data,
                mix, n, h2, w, ps, K._ROUNDING_CODE[rounding], *extra,
                K._stream(x)), ENC)
            return out

        def roundtrip(x, rounding="rne"):
            n, h2, w, ps = top(x)
            out = torch.empty(x.shape[:-2] + (h2, w), dtype=torch.uint8,
                              device=x.device)
            extra = ()
            if abi["plan"]:
                plan = plan_of(RT, x.data_ptr(), n, h2, w, ps, rounding)
                extra = (plan.grid, plan.smem)
            check(dll.sdct_roundtrip32_rgb(
                x.data_ptr(), out.data_ptr(), ql.ctypes.data, qc.ctypes.data,
                qil.ctypes.data, qic.ctypes.data, mix, n, h2, w, ps, *extra,
                K._stream(x)), RT)
            return out

        def dec(rec, w, rounding="rne"):
            n, h2 = K._batch_of(rec, 2), rec.shape[-1] // w
            out = torch.empty(rec.shape[:-1] + (h2, w), dtype=torch.uint8,
                              device=rec.device)
            extra = ()
            if abi["dec_tiles"]:
                plan = plan_of(DEC, rec.data_ptr(), n, h2, w, h2 * w, rounding)
                extra = (plan.grid, plan.smem)
            check(dll.sdct_dec32_rgb(
                rec.data_ptr(), out.data_ptr(), qil.ctypes.data,
                qic.ctypes.data, mix, n, h2, w, *extra, K._stream(rec)), DEC)
            return out

        calls.update({ENC: enc, RT: roundtrip, DEC: dec})
    if hasattr(dll, "sdct_enc420_rgb"):
        dll.sdct_enc420_rgb.argtypes = [
            p, p, p, p, p, i, i, i, ll, i,
            *([i, i] if abi["enc420_tiles"] else []), p]
        dll.sdct_dec420_rgb.argtypes = [
            p, p, p, p, p, i, i, i, *([i, i] if abi["dec420_tiles"] else []),
            p]
        if abi["enc420_tiles"]:
            dll.sdct_color420_capacity.argtypes = [i, p, p, p]
        if abi["dec420_tiles"]:
            dll.sdct_dec420_capacity.argtypes = [p, p, p]

        def enc420(x, rounding="rne"):
            n, h2, w, ps = top(x)
            out = torch.empty(x.shape[:-3] + (3 * h2 * w // 2,),
                              dtype=torch.uint8, device=x.device)
            extra = ()
            if abi["enc420_tiles"]:
                cap = np.zeros(3, np.int32)
                check(dll.sdct_color420_capacity(
                    K._ROUNDING_CODE[rounding], cap.ctypes.data,
                    cap.ctypes.data + 4, cap.ctypes.data + 8), "capacity")
                plan = K.color420_plan(
                    E420, n, h2, w, base=x.data_ptr(), plane_stride=ps,
                    capacity=lambda: (int(cap[1]), int(cap[2])))
                extra = (plan.grid, int(cap[0]))
            check(dll.sdct_enc420_rgb(
                x.data_ptr(), out.data_ptr(), ql.ctypes.data, qc.ctypes.data,
                mix, n, h2, w, ps, K._ROUNDING_CODE[rounding], *extra,
                K._stream(x)), E420)
            return out

        def dec420(rec, w, rounding="rne"):
            n = K._batch_of(rec, 1)
            h2 = rec.shape[-1] * 2 // (3 * w)
            out = torch.empty(rec.shape[:-1] + (3, h2, w), dtype=torch.uint8,
                              device=rec.device)
            extra = ()
            if abi["dec420_tiles"]:
                cap = np.zeros(3, np.int32)
                check(dll.sdct_dec420_capacity(
                    cap.ctypes.data, cap.ctypes.data + 4,
                    cap.ctypes.data + 8), "capacity")
                plan = K.color420_plan(
                    D420, n, h2, w, base=rec.data_ptr(), plane_stride=h2 * w,
                    capacity=lambda: (int(cap[1]), int(cap[2])))
                extra = (plan.grid, int(cap[0]))
            check(dll.sdct_dec420_rgb(
                rec.data_ptr(), out.data_ptr(), qil.ctypes.data,
                qic.ctypes.data, mix, n, h2, w, *extra, K._stream(rec)), D420)
            return out

        calls.update({E420: enc420, D420: dec420})
    return calls


def package_calls(luma, chroma) -> dict:
    return {
        ENC: lambda x, r="rne": K.encode_quantize32_ycbcr(x, luma, chroma, r),
        RT: lambda x, r="rne": K.roundtrip_quantize32_ycbcr(x, luma, chroma),
        DEC: lambda rec, w, r="rne": K.decode_quantize32_ycbcr(
            rec, luma, chroma, w, rec.shape[-1] // w * 2),
        E420: lambda x, r="rne": K.encode_quantize32_ycbcr420(x, luma, chroma,
                                                              r),
        D420: lambda rec, w, r="rne": K.decode_quantize32_ycbcr420(
            rec, luma, chroma, w, rec.shape[-1] * 4 // (3 * w)),
    }


def parent_bytes(pkg, parent, gen, luma, chroma) -> dict:
    """Mismatched bytes of each package kernel against the earlier
    version's, over chip_smoke.py's colour geometries, every rounding."""
    counts = {}

    def count(key, got, want):
        n = int((got != want).sum())
        counts[key] = n
        print(f"  parent bytes {key}: {n} mismatches", flush=True)

    for h, w, frames in cs.COLOR_GEOMETRIES:
        rgb = cs.random_rgb(gen, h, w, frames)
        tag = f"{frames}x3x{h}x{w}"
        for r in cs.ROUNDINGS:
            count(f"{ENC} {tag} {r}", pkg[ENC](rgb, r), parent[ENC](rgb, r))
        count(f"{RT} {tag}", pkg[RT](rgb), parent[RT](rgb))
        rec = TP.encode_ycbcr32(rgb, luma, chroma)
        count(f"{DEC} {tag}", pkg[DEC](rec, w), parent[DEC](rec, w))
    for h, w, frames in cs.GEOMETRIES_420:
        rgb = cs.random_rgb(gen, h, w, frames)
        tag = f"{frames}x3x{h}x{w}"
        for r in cs.ROUNDINGS:
            count(f"{E420} {tag} {r}", pkg[E420](rgb, r), parent[E420](rgb, r))
        rec = TP.encode_ycbcr420(rgb, luma, chroma)
        count(f"{D420} {tag}", pkg[D420](rec, w), parent[D420](rec, w))
    return counts


def clock_under_load(fn, inputs, seconds: float = 1.5) -> dict:
    """SM clock (MHz) and power (W) that nvidia-smi samples every 100 ms
    while ``fn`` runs back to back over ``inputs`` for about ``seconds``:
    medians over the samples."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                for x in inputs:
                    fn(x)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out = smi.communicate()[0]
    rows = [[float(v) for v in line.split(",")]
            for line in out.splitlines() if line.count(",") == 1]
    rows = rows[2:-1] or rows   # the samples inside the busy span
    return {"sm_mhz": statistics.median(r[0] for r in rows),
            "power_w": statistics.median(r[1] for r in rows),
            "samples": len(rows)}


def top_views(rgbs, shift: int):
    """The (3, H/2, W) top views of (3, H, W) images, copied to start
    ``shift`` bytes into a fresh buffer (planes H/2*W apart)."""
    views = []
    for x in rgbs:
        h2, w = x.shape[-2] // 2, x.shape[-1]
        flat = torch.empty(3 * h2 * w + 64, dtype=torch.uint8,
                           device=x.device)
        view = flat[shift:shift + 3 * h2 * w].view(3, h2, w)
        view.copy_(x[:, :h2])
        views.append(view)
    return views


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", help="a checkout of an earlier version")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--kernels", default=",".join(KINDS),
                    help="the kernels to time, comma-separated")
    args = ap.parse_args(argv)
    timed_kinds = [k for k in args.kernels.split(",") if k]
    if not set(timed_kinds) <= set(KINDS):
        ap.error(f"--kernels takes {', '.join(KINDS)}")
    if not torch.cuda.is_available():
        print("color_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    luma = default_quant_lut(100) * np.float32(255.0)
    chroma = BASE_CHROMA_QUANT_TABLE * np.float32(100 * 255)
    pkg = package_calls(luma, chroma)
    procs = {name: (build_lib(name, _build.CSRC, edits,
                              SOURCE[kinds[0]]), kinds, timing)
             for name, (edits, kinds, timing) in BUILDS.items()
             if set(kinds) & set(timed_kinds)}
    if args.parent:
        src = os.path.join(args.parent, "simd_dct_tpu_torch", "csrc")
        parent_procs = [build_lib("parent", src, source=f)
                        for f in ("color32.cu", "color420.cu")]
    others = {name: (lib_calls(load_lib(proc, name), luma, chroma), kinds,
                     timing)
              for name, (proc, kinds, timing) in procs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs, mismatches = {}, {}
    if args.parent:
        parent = {}
        for proc in parent_procs:
            parent.update(lib_calls(load_lib(proc, "parent"), luma, chroma))
        mismatches = parent_bytes(pkg, parent, gen, luma, chroma)
        cs.require(not any(mismatches.values()),
                   "every kernel gives the earlier version's bytes")
        others["parent"] = (parent, KINDS, False)
    cycles = cs.sleep_cycles_per_ms()

    def time_turns(name, label, variants):
        order = list(variants)
        for r in range(args.rounds):
            for key in order if r % 2 == 0 else order[::-1]:
                call, inputs = variants[key]
                q = cs.queued_ms(call, inputs, args.reps, cycles) * 1e3
                prof, _ = cs.profiled_us(call, inputs)
                runs.setdefault(f"{name} {label} {key}", []).append((q, prof))
                print(f"{name:16s} {label:18s} {key:30s} round {r}: queued "
                      f"{q:8.3f} us  profiler "
                      f"{prof if prof is None else round(prof, 3)}",
                      flush=True)

    for label, h, w, frames, n_rot in CASES:
        rgbs = [cs.random_rgb(gen, h, w, frames) for _ in range(n_rot)]
        recs = [TP.encode_ycbcr32(x, luma, chroma) for x in rgbs]
        recs420 = [TP.encode_ycbcr420(x, luma, chroma) for x in rgbs]
        for name in timed_kinds:
            # one-argument calls on this case's inputs
            if name in (DEC, D420):
                inputs = recs if name == DEC else recs420

                def bind(fn):
                    return lambda r: fn(r, w)
            else:
                inputs = rgbs

                def bind(fn):
                    return lambda x: fn(x)
            fn = bind(pkg[name])
            want = fn(inputs[0])
            variants = {"package": (fn, inputs)}
            for b, (calls, kinds, timing) in others.items():
                if name not in kinds:
                    continue
                call = bind(calls[name])
                same = torch.equal(call(inputs[0]), want)
                if not same:
                    print(f"{name} {b}: bytes differ", flush=True)
                cs.require(same or timing, f"{name} {b} gives the package's "
                           "bytes")
                variants[b] = (call, inputs)
            if name == ENC and frames == 1:
                aligned, off = top_views(rgbs, 0), top_views(rgbs, 8)

                def view(v):
                    return K.encode32_rgb_view(v, luma, chroma)
                plan = K._color_plan_of(ENC, off[0], off[0].data_ptr(), 1,
                                        h // 2, w, off[0].stride(0))
                cs.require(plan.variant == "plain" and torch.equal(
                    view(off[0]), view(aligned[0])), "the view 8 bytes off "
                    "takes plain loads, with the same bytes")
                variants["view, tensor copies"] = (view, aligned)
                variants["view 8 bytes off, plain loads"] = (view, off)
            for key in ("package", "parent"):
                if key in variants:
                    call, inputs_k = variants[key]
                    clocks = clock_under_load(call, inputs_k)
                    runs[f"{name} {label} {key} clock"] = clocks
                    print(f"{name:16s} {label:18s} {key:30s} under load: "
                          f"{clocks}", flush=True)
            time_turns(name, label, variants)
    summary = {k: v if isinstance(v, dict) else {
                   "queued_us": [q for q, _ in v],
                   "profiler_us": [p for _, p in v],
                   "median_queued_us": statistics.median(q for q, _ in v)}
               for k, v in runs.items()}
    print(json.dumps({"card": smi.stdout.strip(), "runs": summary,
                      "parent_mismatches": mismatches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
