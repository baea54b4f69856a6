#!/usr/bin/env python3
"""Time variants of the enc-quant encode and decode (``encq_kernel`` and
``decq_kernel`` in ``csrc/encq.cu``) against each other on one CUDA card,
in turns, in one process, and hold their bytes to the package's.

    python3 encq_variants.py [--rounds N] [--reps N] [--parent DIR]
                             [--kernels encq,decq] [--only NAME ...] [--sass]
                             [--wall]

Each kernel is timed on the 4096x3840 image (its 2048x3840 top view) and
on an 8-frame 1088x1920 batch, as ``chip_smoke.py`` times it, and on a
4-frame 4096x3840 batch (more tiles a CTA): the encode in
the scalar, pair and pair_as_written layouts, the decode of scalar and pair
records; by CUDA events around a rotation queued behind a device sleep and
by the profiler:

* the package's kernels, the same launches with the plain variant forced
  (the threads' own pixel loads and stores; the same bytes), and the
  package's kernels on the fewest CTAs that take their tiles in as few
  rounds as the plan's grid;
* builds of ``csrc/encq.cu`` with a source edit (of it or of the headers it
  includes), made at run time under the port's build directory (which git
  ignores) and never used by the package: tiles of 16 or 24 blocks instead
  of 32 (both divide the 240 and 480 blocks of a 1080p and a 4K row), four
  threads an 8x8 block instead of two, two pixel tiles in flight or one
  record buffer (the encode), two record tiles in flight or one pixel
  buffer (the decode),
  ``__launch_bounds__`` asking for 24 CTAs an SM (a register cap), the
  encode's scales read from its kernel parameter instead of shared memory,
  rne's +127 added to each byte instead of to the packed word, the
  staged words stored without their rotation, the DCT basis read from
  dct_common.cuh's constant bank (``kD``), and the byte conversions on the
  conversion unit (``(float)b``, ``rintf`` and int casts: the same bytes).
  For timing only (their bytes are logged, not required): the arithmetic
  skipped at run time, or the pixel and record copies;
* with ``--parent``, a checkout of an earlier version of the repository:
  its ``encq.cu`` built alone the same way and called through that
  version's C entry points (with or without the launch plan's arguments,
  by the entry points it has).  First every byte of the package's kernels
  must equal it: the encode in every layout and rounding on 4096x3840,
  8x1088x1920, 4096x3848 (scalar: W % 16 == 8) and 16x1984 (a strip ends
  in a short tile), and in every layout on 2x512x3840 under each strip
  range of ``chip_smoke.py`` phase 6 (with and without legacy_range, the
  as-written spill included); the decode of the same geometries' records
  and of random bytes.  The count of comparisons is printed.  Then the
  earlier kernels are timed with the others.

``--wall`` also times the host's pace: back-to-back calls of
``cuda_dct.encode_quantize`` / ``decode_quantize`` and of the api's on the
4096x3840 image (and ``encq_launch_plan`` alone where a version has it),
microseconds a call between two CUDA events, each in a process of its own
that imports the package of this checkout (and, with ``--parent``, of the
earlier one, in turns).

``--kernels`` times only the named kernels (the byte checks run whole);
``--only`` builds only the named variants; ``--sass`` first prints the
static instruction count of each kernel instantiation by opcode.  A build
whose bytes must equal the package's is checked on each timing case
first.  The SM clock and
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
from simd_dct_tpu_torch.kernels import _build, cuda_dct as K
from simd_dct_tpu_torch.kernels import torch_path as TP

ENC, DEC = "encq", "decq"
KINDS = (ENC, DEC)
SOURCE = "encq.cu"
# (label, H, W, frames, rotation) of the dual-view images
CASES = [("4096x3840 image", 4096, 3840, 1, 16),
         ("8x1088x1920 batch", 1088, 1920, 8, 6),
         ("4x4096x3840 batch", 4096, 3840, 4, 3)]
# the timed jobs: (kernel, layout)
JOBS = [(ENC, "scalar"), (ENC, "pair"), (ENC, "pair_as_written"),
        (DEC, "scalar"), (DEC, "pair")]
# the geometries of the byte check against an earlier version
PARENT_IMAGES = [(4096, 3840, 1), (1088, 1920, 8), (4096, 3848, 1),
                 (16, 1984, 1)]
# strips are 16 rows of the dual-view buffer apart (8 with legacy_range):
# chip_smoke.py phase 6's ranges
RANGES = [(64, 191, False), (0, 100, True), (16, 16, False),
          (200, 1 << 40, True)]
_ARRIVE = ('  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"('
           'saddr(bar)) : "memory");\n  return;\n')
# tile_common.cuh tensor_load_3d's arming: the builds without loads arrive
# without bytes there and copy nothing (dct32.cu and encq.cu take their 3-D
# pixel tiles through it)
_TENSOR_LOAD = "  arrive_expect(bar, bytes);\n"
_DEC_LOAD = ("        arrive_expect(&full[s], 64u * n.n);\n"
             "        bulk_load(stages + s * kEqTileBytes, records + n.rec, "
             "64u * n.n, &full[s]);\n")
_DEC_ARRIVE = ('        asm volatile("mbarrier.arrive.shared::cta.b64 _, '
               '[%0];" ::"r"(saddr(&full[s])) : "memory");\n')
# tile_common.cuh and encq.cu: the basis table and the byte conversions
_BASIS = "  return t[i];\n}"
_DEQ = ("  return __fmul_rn(__fsub_rn(__int_as_float(0x4B000000u | b), "
        "kTwo23 + 127.0f), q);\n")
_UNIT = [
    (_DEQ, "  return __fmul_rn((float)b - 127.0f, q);\n"),
    ("  return rint_bits(fminf(fmaxf(N ? __fmul_rn(y, 255.0f) : y, 0.0f), "
     "255.0f));\n",
     "  return (uint32_t)(int)fminf(fmaxf(rintf(N ? __fmul_rn(y, 255.0f) : y"
     "), 0.0f), 255.0f);\n"),
    ("  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B00u, 0x5440 + "
     "i)), kTwo23);\n", "  return (float)((w >> (8 * i)) & 0xffu);\n"),
    ("  return rint_bits(fminf(fmaxf(__fmul_rn(c, q), -127.0f), 128.0f));\n",
     "  return (uint32_t)(int)fminf(fmaxf(rintf(__fmul_rn(c, q)), -127.0f), "
     "128.0f);\n")]
_NO_MATH = [
    ("      for (int h = 0; h < kEqLines; ++h) dct_column(x[h], tc[h]);",
     "      for (int h = 0; h < (g.tiles == 0) * kEqLines; ++h) "
     "dct_column(x[h], tc[h]);"),
    ("      for (int i = 0; i < kEqLines; ++i) {\n"
     "        const int u = row_of",
     "      for (int i = 0; i < (g.tiles == 0) * kEqLines; ++i) {\n"
     "        const int u = row_of"),
    ("    for (int h = 0; h < kEqLines; ++h) {\n      // column v",
     "    for (int h = 0; h < (g.tiles == 0) * kEqLines; ++h) {\n"
     "      // column v"),
    ("    for (int h = 0; h < kEqLines; ++h) {\n      // row j",
     "    for (int h = 0; h < (g.tiles == 0) * kEqLines; ++h) {\n"
     "      // row j")]
_NO_MEMORY = [(_TENSOR_LOAD, _ARRIVE),
              ("if (storer) store_records(",
               "if (storer && g.tiles == 0) store_records("),
              (_DEC_LOAD, _DEC_ARRIVE),
              ("if (V == kTensor && storer) store_pixels(",
               "if (V == kTensor && storer && g.tiles == 0) store_pixels(")]


# the encode's scales read from its kernel parameter (row u is uniform in a
# warp at two threads a block) instead of a shared table: 256 shared bytes
# less
_PARAM_SCALES = [
    ("constexpr int kEqSmem = 64 * 4 + (kEqStages",
     "constexpr int kEqSmem = 0 + (kEqStages"),
    ("  uint8_t* stages = smem + 64 * 4;             // 128-byte aligned, as "
     "the tensor copies want", "  uint8_t* stages = smem;"),
    ("  for (int i = threadIdx.x; i < 64; i += kEqThreads) sq[(i & 7) * 8 + "
     "(i >> 3)] = q.v[i];\n", ""),
    ("        row_scales(sq, u, qv);\n        dct_row(tr, c);",
     "#pragma unroll\n        for (int v = 0; v < 8; ++v) qv[v] = "
     "q.v[v * 8 + u];\n        dct_row(tr, c);")]
# rne's +127 added to each byte before the packing, instead of to the
# packed word at once
_BYTE_BIAS = [
    ("  if (R != kRne) return quantize_byte<R>(c, q);",
     "  return quantize_byte<R>(c, q);"),
    ("        for (int v = 0; v < 8; ++v) wd[v] = bias_bytes(wd[v]);",
     "        for (int v = 0; v < 0; ++v) wd[v] = bias_bytes(wd[v]);")]

# the decode's byte taken under 2^23's exponent by the one byte_perm that
# extracts it, instead of dequant_byte on the extracted byte
_WORD_DEQ = [("  return dequant_byte(__byte_perm(w, 0, 0x4440 + i), q);\n",
              "  return __fmul_rn(__fsub_rn(__int_as_float(__byte_perm(w, "
              "0x4B00u, 0x5440 + i)), kTwo23 + 127.0f), q);\n")]


def _const(name: str, old, new) -> tuple[str, str]:
    return (f"constexpr {name} = {old};", f"constexpr {name} = {new};")


# name -> (edits of the source or its headers, the kernels it is timed
# for, timing only)
BUILDS = {
    "tiles of 16 blocks": ([_const("int kEqTileBlocks", 32, 16)], KINDS,
                           False),
    "tiles of 24 blocks": ([_const("int kEqTileBlocks", 32, 24)], KINDS,
                           False),
    "four threads a block": ([_const("int kEqBlockThreads", 2, 4)], KINDS,
                             False),
    "two pixel tiles in flight": ([_const("int kEqStages", 1, 2)], (ENC,),
                                  False),
    "one record buffer": ([_const("int kEqOutBuffers", 2, 1)], (ENC,),
                          False),
    "two record tiles in flight": ([_const("int kDqStages", 1, 2)], (DEC,),
                                   False),
    "one pixel buffer": ([_const("int kDqOutBuffers", 2, 1)], (DEC,),
                         False),
    "24 CTAs an SM": ([("__launch_bounds__(kEqThreads)",
                        "__launch_bounds__(kEqThreads, 24)")], KINDS, False),
    "scales from the parameter space": (_PARAM_SCALES, (ENC,), False),
    "rne bias a byte at a time": (_BYTE_BIAS, (ENC,), False),
    "staged words not rotated": ([("  const int rot = (b >> 1) & 7;",
                                   "  const int rot = 0;")], (ENC,), False),
    "dequantized from the word": (_WORD_DEQ, (DEC,), False),
    "basis from the constant bank": ([(_BASIS, "  return kD[i];\n}")], KINDS,
                                     False),
    "conversions by the unit": (_UNIT, KINDS, False),
    "no arithmetic": (_NO_MATH, KINDS, True),
    "no loads and no stores": (_NO_MEMORY, KINDS, True),
}
PLAIN = "package, plain variant"
# a process timing back-to-back wrapper and api calls of the package in its
# working directory: argv[1] is [repetitions, calls a repetition]
_WALL = r"""
import json, statistics, sys
import torch
from simd_dct_tpu_torch import api
from simd_dct_tpu_torch.core.quantize import default_quant_lut
from simd_dct_tpu_torch.kernels import cuda_dct as K
reps, calls = json.loads(sys.argv[1])
lut = default_quant_lut(50)
gen = torch.Generator(device="cuda").manual_seed(0)
img = torch.randint(0, 256, (4096, 3840), generator=gen, dtype=torch.uint8,
                    device="cuda")
rec = K.encode_quantize(img, lut)
jobs = {"encq wrapper": lambda: K.encode_quantize(img, lut),
        "decq wrapper": lambda: K.decode_quantize(rec, lut, 3840, 4096),
        "encq api": lambda: api.encode_quantize(img, lut),
        "decq api": lambda: api.decode_quantize(rec, lut, 3840, 4096)}
if hasattr(K, "encq_launch_plan"):   # the host's launch plan alone
    jobs["encq plan"] = lambda: K.encq_launch_plan("encq", img)
out = {}
for name, fn in jobs.items():
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) * 1e3 / calls)
    out[name] = statistics.median(per_call)
print(json.dumps(out))
"""
EVEN = "grid of even rounds"


def load_lib(proc: subprocess.Popen, name: str) -> ctypes.CDLL:
    """The library a build made, its C interfaces bound by the entry points
    it has (with or without the launch plan's arguments).  Prints the
    ptxas lines of its kernels."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif "registers" in line or "spill" in line:
            print(f"  ptxas {name} {entry}: {line.strip()}", flush=True)
    dll = ctypes.CDLL(proc.lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(dll, "sdct_encq_capacity"):
        dll.sdct_encq_capacity.argtypes = [i, i, i, p, p, p, p]
        dll.sdct_decq_capacity.argtypes = [i, i, p, p, p, p]
        dll.sdct_encq.argtypes = [p, p, p, i, i, i, ll, i, i, i, i, i, i, i,
                                  i, p]
        dll.sdct_decq.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
    else:
        dll.sdct_encq.argtypes = [p, p, p, i, i, i, ll, i, i, i, i, i, p]
        dll.sdct_decq.argtypes = [p, p, p, i, i, i, i, p]
    return dll


def _check(rc, what):
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def lib_calls(dll, even: bool = False) -> dict:
    """The kernels of a library through its C entry points:
    ``encq(img, q, layout, rounding="rne", start_y=0, end_y=2^30,
    legacy=False)`` on (H, W) or (B, H, W) images and ``decq(records, qi,
    w, h, layout)``; a planned library takes the package's plan with the
    tile width, shared bytes and capacity it reports (with ``even``, on the
    fewest CTAs that take the tiles in as few rounds)."""
    planned = hasattr(dll, "sdct_encq_capacity")
    caps = {}

    def plan(kind, n, h2, w, layout, pixels, records, stride, rounding):
        key = (kind, rounding, layout)
        if key not in caps:
            out = np.zeros(4, np.int32)
            ptrs = [out.ctypes.data + 4 * i for i in range(4)]
            code = K._LAYOUT_CODE[layout]
            v = K._VARIANT_CODE[K.encq_variant(w, pixels, stride)]
            _check(dll.sdct_encq_capacity(K._ROUNDING_CODE[rounding], code,
                                          v, *ptrs) if kind == ENC else
                   dll.sdct_decq_capacity(code, v, *ptrs), f"{kind} capacity")
            caps[key] = out.copy()
        nb, smem, per_sm, sms = (int(x) for x in caps[key])
        pl = K._eq_plan(kind, n, h2, w, layout, pixels=pixels,
                        records=records, frame_stride=stride,
                        capacity=lambda v: (per_sm, sms), variant=None,
                        tile_blocks=nb, smem=smem)
        if even:
            pl = pl._replace(grid=-(-pl.tiles // -(-pl.tiles // pl.grid)))
        return pl

    def encq(img, q, layout, rounding="rne", start_y=0, end_y=1 << 30,
             legacy=False):
        h, w = img.shape[-2:]
        n = img.numel() // (h * w)
        out = torch.empty(img.shape[:-2] + (h // 2 * w,), dtype=torch.uint8,
                          device=img.device)
        args = (img.data_ptr(), out.data_ptr(), q.ctypes.data, n, h // 2, w,
                h * w, start_y, end_y, int(legacy),
                K._ROUNDING_CODE[rounding], K._LAYOUT_CODE[layout])
        extra = ()
        if planned:
            pl = plan(ENC, n, h // 2, w, layout, img.data_ptr(),
                      out.data_ptr(), h * w, rounding)
            extra = (pl.grid, K._VARIANT_CODE[pl.variant], pl.smem)
        _check(dll.sdct_encq(*args, *extra, K._stream(img)), ENC)
        return out

    def decq(rec, qi, w, h, layout):
        h2 = h // 2
        n = rec.numel() // (h2 * w)
        out = torch.empty(rec.shape[:-1] + (h2, w), dtype=torch.uint8,
                          device=rec.device)
        extra = ()
        if planned:
            pl = plan(DEC, n, h2, w, layout, out.data_ptr(), rec.data_ptr(),
                      h2 * w, "rne")
            extra = (pl.grid, K._VARIANT_CODE[pl.variant], pl.smem)
        _check(dll.sdct_decq(rec.data_ptr(), out.data_ptr(), qi.ctypes.data,
                             n, h2, w, K._LAYOUT_CODE[layout], *extra,
                             K._stream(rec)), DEC)
        return out

    return {ENC: encq, DEC: decq}


def package_calls(variant: str | None = None) -> dict:
    """The package's kernels (the plan's variant, or ``variant`` forced)
    with ``lib_calls``' signatures."""
    def encq(img, q, layout, rounding="rne", start_y=0, end_y=1 << 30,
             legacy=False):
        return K._encode_quantize(img, LUT, start_y, end_y, rounding, layout,
                                  legacy, variant=variant)

    def decq(rec, qi, w, h, layout):
        return K._decode_quantize(rec, LUT, w, h, layout, variant=variant)

    return {ENC: encq, DEC: decq}


LUT = default_quant_lut(50)


def parent_equal(gen, pkg, parent, q, qi) -> dict:
    """The package's kernels against the earlier version's: the mismatches
    of each comparison (all must be 0)."""
    out = {}

    def count(key, got, want):
        n = int((got != want).sum())
        out[key] = n
        print(f"  parent {key}: {n} mismatches", flush=True)
        cs.require(n == 0, f"{key} equals the earlier version's bytes")

    for h, w, frames in PARENT_IMAGES:
        img = cs.random_images(gen, h, w, frames)
        tag = f"{frames}x{h}x{w}"
        layouts = cs.LAYOUTS if w % 16 == 0 else ("scalar",)
        for layout in layouts:
            for rounding in cs.ROUNDINGS:
                count(f"encq {tag} {layout} {rounding}",
                      pkg[ENC](img, q, layout, rounding),
                      parent[ENC](img, q, layout, rounding))
            if layout == "pair_as_written":
                continue
            rec = TP.encode_quantize(img, LUT, layout=layout)
            noise = torch.randint(0, 256, rec.shape, generator=gen,
                                  dtype=torch.uint8, device="cuda")
            for what, r in (("records", rec), ("random", noise)):
                count(f"decq {tag} {layout} {what}",
                      pkg[DEC](r, qi, w, h, layout),
                      parent[DEC](r, qi, w, h, layout))
    img = cs.random_images(gen, 512, 3840, 2)
    for sy, ey, legacy in RANGES:
        for layout in cs.LAYOUTS:
            count(f"encq 2x512x3840 {layout} range [{sy}, {ey}] "
                  f"legacy={legacy}",
                  pkg[ENC](img, q, layout, "rne", K._clamp_i32(sy),
                           K._clamp_i32(ey), legacy),
                  parent[ENC](img, q, layout, "rne", K._clamp_i32(sy),
                              K._clamp_i32(ey), legacy))
    print(f"parent: {len(out)} comparisons, "
          f"{sum(out.values())} mismatching bytes", flush=True)
    return out


def host_walls(roots: dict, rounds: int, reps: int = 9, calls: int = 200,
               script: str = _WALL) -> dict:
    """Microseconds a call of each checkout's wrappers and api (``script``,
    by default ``_WALL``), the checkouts in turns (forwards, then
    backwards)."""
    walls = {}
    order = list(roots)
    for r in range(rounds):
        for name in order if r % 2 == 0 else order[::-1]:
            done = subprocess.run(
                [sys.executable, "-c", script, json.dumps([reps, calls])],
                cwd=roots[name], capture_output=True, text=True)
            if done.returncode:
                raise RuntimeError(f"wall of {name}: {done.stderr[-3000:]}")
            got = json.loads(done.stdout.strip().splitlines()[-1])
            for job, us in got.items():
                walls.setdefault(f"wall {job} {name}", []).append(us)
                print(f"wall {job:14s} {name:8s} round {r}: {us:8.3f} us a "
                      "call", flush=True)
    return walls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", help="a checkout of an earlier version")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--kernels", default=",".join(KINDS),
                    help="the kernels to time, comma-separated")
    ap.add_argument("--only", nargs="*", help="build only these variants")
    ap.add_argument("--sass", action="store_true",
                    help="first print each kernel's instructions by opcode")
    ap.add_argument("--wall", action="store_true",
                    help="also time back-to-back wrapper and api calls")
    args = ap.parse_args(argv)
    timed_kinds = [k for k in args.kernels.split(",") if k]
    if not set(timed_kinds) <= set(KINDS):
        ap.error(f"--kernels takes {', '.join(KINDS)}")
    if not torch.cuda.is_available():
        print("encq_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    procs = {}   # build -> (process, kernels, timing only)
    for name, (edits, kinds, timing) in BUILDS.items():
        kinds = [k for k in kinds if k in timed_kinds]
        if kinds and (args.only is None or name in args.only):
            procs[name] = (build_lib(name, _build.CSRC, edits, SOURCE,
                                     "encq_variants"), kinds, timing)
    parent_proc = None
    if args.parent:
        parent_proc = build_lib("parent", os.path.join(
            args.parent, "simd_dct_tpu_torch", "csrc"), (), SOURCE,
            "encq_variants")
    _build.load()
    if args.sass:
        from tiles_variants import sass_counts
        for fn, counts in sass_counts(_build.build(), timed_kinds).items():
            print(f"sass {fn}: {json.dumps(counts)}", flush=True)
    q, qi = K._host_scales(LUT)
    pkg = package_calls()
    others = {}   # build -> ({kernel: call}, timing only)
    if args.only is None or PLAIN in args.only:
        others[PLAIN] = (package_calls("plain"), False)
    if args.only is None or EVEN in args.only:
        others[EVEN] = (lib_calls(_build.load(), even=True), False)
    for name, (proc, kinds, timing) in procs.items():
        calls = lib_calls(load_lib(proc, name))
        others[name] = ({k: calls[k] for k in kinds}, timing)
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {}
    if parent_proc is not None:
        parent = lib_calls(load_lib(parent_proc, "parent"))
        runs["parent bytes"] = parent_equal(gen, pkg, parent, q, qi)
        others["parent"] = (parent, False)
    if args.wall:
        roots = {"package": os.path.dirname(os.path.abspath(__file__))}
        if args.parent:
            roots = {"parent": os.path.abspath(args.parent), **roots}
        for key, us in host_walls(roots, max(2, args.rounds)).items():
            runs[key] = {"us_a_call": us}
    cycles = cs.sleep_cycles_per_ms()

    def time_turns(label, variants):
        order = list(variants)
        for r in range(args.rounds):
            for key in order if r % 2 == 0 else order[::-1]:
                call, inputs = variants[key]
                t = cs.queued_ms(call, inputs, args.reps, cycles) * 1e3
                prof, _ = cs.profiled_us(call, inputs)
                runs.setdefault(f"{label} {key}", []).append((t, prof))
                print(f"{label:40s} {key:30s} round {r}: queued {t:8.3f} us"
                      f"  profiler {prof if prof is None else round(prof, 3)}",
                      flush=True)

    for case, h, w, frames, n_rot in CASES:
        imgs = [cs.random_images(gen, h, w, frames) for _ in range(n_rot)]
        for kind, layout in JOBS:
            if kind not in timed_kinds:
                continue
            label = f"{kind} {layout} {case}"
            if kind == ENC:
                inputs = imgs
                plan = K.encq_launch_plan(ENC, imgs[0], layout)

                def bind(calls, layout=layout):
                    return lambda x: calls[ENC](x, q, layout)
            else:
                inputs = [TP.encode_quantize(x, LUT, layout=layout)
                          for x in imgs]
                plan = K.encq_launch_plan(DEC, inputs[0], layout, size_x=w,
                                          size_y=h)

                def bind(calls, layout=layout):
                    return lambda r: calls[DEC](r, qi, w, h, layout)
            print(f"{label} plan {plan._asdict()}", flush=True)
            want = bind(pkg)(inputs[0])
            variants = {"package": (bind(pkg), inputs)}
            for b, (calls, timing) in others.items():
                if kind not in calls:
                    continue
                call = bind(calls)
                same = torch.equal(call(inputs[0]), want)
                if not same:
                    print(f"{label} {b}: bytes differ", flush=True)
                cs.require(same or timing, f"{label} {b} gives the package's "
                           "bytes")
                variants[b] = (call, inputs)
            if layout == "scalar":
                for key in ("package", "parent"):
                    if key in variants:
                        call, inp = variants[key]
                        clocks = clock_under_load(call, inp)
                        runs[f"{label} {key} clock"] = clocks
                        print(f"{label:40s} {key:30s} under load: {clocks}",
                              flush=True)
            time_turns(label, variants)
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
