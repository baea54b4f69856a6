#!/usr/bin/env python3
"""Time variants of the mode32 encode and decode (``enc32_kernel`` and
``dec32_kernel`` in ``csrc/dct32.cu``) against each other on one CUDA card,
in turns, in one process, and hold their bytes to the package's.

    python3 mode32_variants.py [--rounds N] [--reps N] [--parent DIR]
                               [--kernels enc32,dec32] [--only NAME ...]
                               [--sass] [--wall]

Each kernel is timed on the 4096x3840 image (its 2048x3840 top view) and
on an 8-frame 1088x1920 batch, as ``chip_smoke.py`` times it, and on a
4-frame 4096x3840 batch (more tiles a CTA), by CUDA events around a
rotation queued behind a device sleep and by the profiler:

* the package's kernels;
* builds of ``csrc/dct32.cu`` with a source edit (of it or of the headers
  it includes), made at run time under the port's build directory (which
  git ignores) and never used by the package: tiles of 16 blocks instead
  of 32, four threads an 8x8 block instead of two, two pixel tiles in
  flight or one record buffer (the encode), two record tiles in flight or
  one pixel buffer (the decode), the DCT basis read from dct_common.cuh's
  constant bank (``kD``), and the byte conversions on the conversion unit
  (``(float)b``, ``rintf`` and int casts: the same bytes).  For timing only
  (their bytes are logged, not required): the arithmetic skipped at run
  time, or the pixel and record copies;
* with ``--parent``, a checkout of an earlier version of the repository:
  its ``dct32.cu`` built alone the same way and called through that
  version's C entry points (with or without the launch plan's arguments,
  by the entry points it has).  First every byte of the package's kernels
  must equal it: the encode in every rounding on 4096x3840, 8x1088x1920,
  256x192, 16x1984 (a strip of one short tile) and 2x256x64 (a strip of
  one tile of 8 blocks), on 2x512x3840 under ``chip_smoke.py`` phase 3's
  strip range [64, 191] and a few more, and on 2x256x64, 2x256x256 and
  2x256x1920 under the card tests' strip ranges; the decode of the same
  geometries' records and of random bytes.  The count of comparisons is
  printed.  Then the earlier kernels are timed with the
  others.

``--wall`` also times the host's pace: back-to-back calls of
``cuda_dct.encode_quantize32`` / ``decode_quantize32`` and of the api's on
the 4096x3840 image (and ``mode32_launch_plan`` alone where a version has
it), microseconds a call between two CUDA events, each in a process of its
own that imports the package of this checkout (and, with ``--parent``, of
the earlier one, in turns).

``--kernels`` times only the named kernels (the byte checks run whole);
``--only`` builds only the named variants; ``--sass`` first prints the
static instruction count of each kernel instantiation by opcode.  A build
whose bytes must equal the package's is checked on each timing case
first.  The SM clock and power under each package kernel and the earlier
version's (nvidia-smi samples over 1.5 s) come first.  One line a run,
then a JSON summary.  Exits non-zero without a card.
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
from encq_variants import host_walls
from simd_dct_tpu_torch.core.quantize import default_quant_lut
from simd_dct_tpu_torch.kernels import _build, cuda_dct as K
from simd_dct_tpu_torch.kernels import torch_path as TP

ENC, DEC = "enc32", "dec32"
KINDS = (ENC, DEC)
SOURCE = "dct32.cu"
# (label, H, W, frames, rotation) of the dual-view images
CASES = [("4096x3840 image", 4096, 3840, 1, 16),
         ("8x1088x1920 batch", 1088, 1920, 8, 6),
         ("4x4096x3840 batch", 4096, 3840, 4, 3)]
# the geometries of the byte check against an earlier version
PARENT_IMAGES = [(4096, 3840, 1), (1088, 1920, 8), (256, 192, 1),
                 (16, 1984, 1), (256, 64, 2)]
# (H, W, start_y, end_y) of the strip ranges on 2-frame images (strips are
# 16 rows of the dual-view buffer apart): chip_smoke.py phase 3's range
# first, then tests/test_torch_cuda.py's
RANGES = [(512, 3840, 64, 191), (512, 3840, 0, 0), (512, 3840, 16, 16),
          (512, 3840, 200, 1 << 40), (512, 3840, -(1 << 40), 100),
          (256, 64, 48, 1 << 40), (256, 64, 16, 16), (256, 256, 32, 95),
          (256, 1920, -(1 << 40), 0)]
_ARRIVE = ('  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"('
           'saddr(bar)) : "memory");\n  return;\n')
# tile_common.cuh tensor_load_3d's arming: the builds without loads arrive
# without bytes there and copy nothing (dct32.cu and encq.cu take their 3-D
# pixel tiles through it)
_TENSOR_LOAD = "  arrive_expect(bar, bytes);\n"
# tile_common.cuh: the basis table and the byte conversions
_BASIS = "  return t[i];\n}"
_UNIT = [
    ("  return __fmul_rn(__fsub_rn(__int_as_float(0x4B000000u | b), "
     "kTwo23 + 127.0f), q);\n", "  return __fmul_rn((float)b - 127.0f, q);\n"),
    ("  return rint_bits(fminf(fmaxf(N ? __fmul_rn(y, 255.0f) : y, 0.0f), "
     "255.0f));\n",
     "  return (uint32_t)(int)fminf(fmaxf(rintf(N ? __fmul_rn(y, 255.0f) : y"
     "), 0.0f), 255.0f);\n"),
    ("  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B00u, 0x5440 + "
     "i)), kTwo23);\n", "  return (float)((w >> (8 * i)) & 0xffu);\n"),
    ("  if (R == kScalar) return quantize<kScalar>(c, q);",
     "  return quantize<R>(c, q);")]
_NO_MATH = [
    ("      for (int h = 0; h < kM32Lines; ++h) dct_column(x[h], tc[h]);",
     "      for (int h = 0; h < (g.tiles == 0) * kM32Lines; ++h) "
     "dct_column(x[h], tc[h]);"),
    ("      for (int i = 0; i < kM32Lines; ++i) {\n"
     "        const int u = kM32Lines * grp + i;",
     "      for (int i = 0; i < (g.tiles == 0) * kM32Lines; ++i) {\n"
     "        const int u = kM32Lines * grp + i;"),
    ("    for (int h = 0; h < kM32Lines; ++h) {\n      // column v",
     "    for (int h = 0; h < (g.tiles == 0) * kM32Lines; ++h) {\n"
     "      // column v"),
    ("    for (int h = 0; h < kM32Lines; ++h) {\n      // row j",
     "    for (int h = 0; h < (g.tiles == 0) * kM32Lines; ++h) {\n"
     "      // row j")]
_NO_MEMORY = [
    (_TENSOR_LOAD, _ARRIVE),
    ("  arrive_expect(bar, 64u * a.n);\n", _ARRIVE),
    ("if (storer) store_records(", "if (storer && g.tiles == 0) store_records("),
    ("if (storer) store_pixels(", "if (storer && g.tiles == 0) store_pixels(")]


def _const(name: str, old, new) -> tuple[str, str]:
    return (f"constexpr {name} = {old};", f"constexpr {name} = {new};")


# name -> (edits of the source or its headers, the kernels it is timed
# for, timing only)
BUILDS = {
    "tiles of 16 blocks": ([_const("int kM32TileBlocks", 32, 16)], KINDS,
                           False),
    "four threads a block": ([_const("int kM32BlockThreads", 2, 4)], KINDS,
                             False),
    "two pixel tiles in flight": ([_const("int kE32Stages", 1, 2)], (ENC,),
                                  False),
    "one record buffer": ([_const("int kE32OutBuffers", 2, 1)], (ENC,),
                          False),
    "two record tiles in flight": ([_const("int kD32Stages", 1, 2)], (DEC,),
                                   False),
    "one pixel buffer": ([_const("int kD32OutBuffers", 2, 1)], (DEC,),
                         False),
    "basis from the constant bank": ([(_BASIS, "  return kD[i];\n}")], KINDS,
                                     False),
    "conversions by the unit": (_UNIT, KINDS, False),
    "no arithmetic": (_NO_MATH, KINDS, True),
    "no loads and no stores": (_NO_MEMORY, KINDS, True),
}
# a process timing back-to-back wrapper and api calls of the package in its
# working directory: argv[1] is [repetitions, calls a repetition]
_WALL = r"""
import json, statistics, sys
import numpy as np
import torch
from simd_dct_tpu_torch import api
from simd_dct_tpu_torch.core.quantize import default_quant_lut
from simd_dct_tpu_torch.kernels import cuda_dct as K
reps, calls = json.loads(sys.argv[1])
lut = default_quant_lut(50) * np.float32(255.0)
gen = torch.Generator(device="cuda").manual_seed(0)
img = torch.randint(0, 256, (4096, 3840), generator=gen, dtype=torch.uint8,
                    device="cuda")
rec = K.encode_quantize32(img, lut)
jobs = {"enc32 wrapper": lambda: K.encode_quantize32(img, lut),
        "dec32 wrapper": lambda: K.decode_quantize32(rec, lut, 3840, 4096),
        "enc32 api": lambda: api.encode_quantize32(img, lut),
        "dec32 api": lambda: api.decode_quantize32(rec, lut, 3840, 4096)}
if hasattr(K, "mode32_launch_plan"):   # the host's launch plan alone
    jobs["enc32 plan"] = lambda: K.mode32_launch_plan("enc32", img)
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


def load_lib(proc: subprocess.Popen, name: str) -> ctypes.CDLL:
    """The library a build made, its C interfaces bound by the entry points
    it has (with or without the launch plan's arguments).  Prints the
    ptxas lines of its encode and decode."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line
        elif ("registers" in line or "spill" in line) and (
                "enc32_kernel" in entry or "dec32_kernel" in entry):
            print(f"  ptxas {name} {entry}: {line.strip()}", flush=True)
    dll = ctypes.CDLL(proc.lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(dll, "sdct_enc32_capacity"):
        dll.sdct_enc32_capacity.argtypes = [i, p, p, p, p]
        dll.sdct_dec32_capacity.argtypes = [p, p, p, p]
        dll.sdct_enc32.argtypes = [p, p, p, i, i, i, ll, i, i, i, i, i, p]
        dll.sdct_dec32.argtypes = [p, p, p, i, i, i, i, i, p]
    else:
        dll.sdct_enc32.argtypes = [p, p, p, i, i, i, ll, i, i, i, p]
        dll.sdct_dec32.argtypes = [p, p, p, i, i, i, p]
    return dll


def _check(rc, what):
    if rc:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def lib_calls(dll) -> dict:
    """The kernels of a library through its C entry points:
    ``enc32(img, q, rounding="rne", start_y=0, end_y=2^30)`` on (H, W) or
    (B, H, W) images and ``dec32(records, qi, w, h)``; a planned library
    takes the package's plan with the tile width, shared bytes and capacity
    it reports."""
    planned = hasattr(dll, "sdct_enc32_capacity")
    caps = {}

    def plan(kind, n, h2, w, pixels, records, stride, rounding):
        key = (kind, rounding)
        if key not in caps:
            out = np.zeros(4, np.int32)
            ptrs = [out.ctypes.data + 4 * i for i in range(4)]
            _check(dll.sdct_enc32_capacity(K._ROUNDING_CODE[rounding], *ptrs)
                   if kind == ENC else dll.sdct_dec32_capacity(*ptrs),
                   f"{kind} capacity")
            caps[key] = out.copy()
        nb, smem, per_sm, sms = (int(x) for x in caps[key])
        return K._m32_plan(kind, n, h2, w, pixels=pixels, records=records,
                           frame_stride=stride,
                           capacity=lambda v: (per_sm, sms), tile_blocks=nb,
                           smem=smem)

    def enc32(img, q, rounding="rne", start_y=0, end_y=1 << 30):
        h, w = img.shape[-2:]
        n = img.numel() // (h * w)
        out = torch.empty(img.shape[:-2] + (h // 2 * w,), dtype=torch.uint8,
                          device=img.device)
        args = (img.data_ptr(), out.data_ptr(), q.ctypes.data, n, h // 2, w,
                h * w, K._clamp_i32(start_y), K._clamp_i32(end_y),
                K._ROUNDING_CODE[rounding])
        extra = ()
        if planned:
            pl = plan(ENC, n, h // 2, w, img.data_ptr(), out.data_ptr(),
                      h * w, rounding)
            extra = (pl.grid, pl.smem)
        _check(dll.sdct_enc32(*args, *extra, K._stream(img)), ENC)
        return out

    def dec32(rec, qi, w, h):
        h2 = h // 2
        n = rec.numel() // (h2 * w)
        out = torch.empty(rec.shape[:-1] + (h2, w), dtype=torch.uint8,
                          device=rec.device)
        extra = ()
        if planned:
            pl = plan(DEC, n, h2, w, out.data_ptr(), rec.data_ptr(), h2 * w,
                      "rne")
            extra = (pl.grid, pl.smem)
        _check(dll.sdct_dec32(rec.data_ptr(), out.data_ptr(), qi.ctypes.data,
                              n, h2, w, *extra, K._stream(rec)), DEC)
        return out

    return {ENC: enc32, DEC: dec32}


LUT = default_quant_lut(50) * np.float32(255.0)


def package_calls() -> dict:
    """The package's kernels with ``lib_calls``' signatures."""
    def enc32(img, q, rounding="rne", start_y=0, end_y=1 << 30):
        return K.encode_quantize32(img, LUT, start_y, end_y, rounding)

    def dec32(rec, qi, w, h):
        return K.decode_quantize32(rec, LUT, w, h)

    return {ENC: enc32, DEC: dec32}


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
        for rounding in cs.ROUNDINGS:
            count(f"enc32 {tag} {rounding}", pkg[ENC](img, q, rounding),
                  parent[ENC](img, q, rounding))
        rec = TP.encode_quantize32(img, LUT)
        noise = torch.randint(0, 256, rec.shape, generator=gen,
                              dtype=torch.uint8, device="cuda")
        for what, r in (("records", rec), ("random", noise)):
            count(f"dec32 {tag} {what}", pkg[DEC](r, qi, w, h),
                  parent[DEC](r, qi, w, h))
    for h, w, sy, ey in RANGES:
        img = cs.random_images(gen, h, w, 2)
        count(f"enc32 2x{h}x{w} range [{sy}, {ey}]",
              pkg[ENC](img, q, "rne", sy, ey),
              parent[ENC](img, q, "rne", sy, ey))
    print(f"parent: {len(out)} comparisons, "
          f"{sum(out.values())} mismatching bytes", flush=True)
    return out


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
        print("mode32_variants: no CUDA device", file=sys.stderr)
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
                                     "mode32_variants"), kinds, timing)
    parent_proc = None
    if args.parent:
        parent_proc = build_lib("parent", os.path.join(
            args.parent, "simd_dct_tpu_torch", "csrc"), (), SOURCE,
            "mode32_variants")
    _build.load()
    if args.sass:
        from tiles_variants import sass_counts
        for fn, counts in sass_counts(_build.build(), timed_kinds).items():
            print(f"sass {fn}: {json.dumps(counts)}", flush=True)
    q, qi = K._host_scales(LUT)
    pkg = package_calls()
    others = {}   # build -> ({kernel: call}, timing only)
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
        for key, us in host_walls(roots, max(2, args.rounds),
                                  script=_WALL).items():
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
                print(f"{label:32s} {key:30s} round {r}: queued {t:8.3f} us"
                      f"  profiler {prof if prof is None else round(prof, 3)}",
                      flush=True)

    for case, h, w, frames, n_rot in CASES:
        imgs = [cs.random_images(gen, h, w, frames) for _ in range(n_rot)]
        for kind in timed_kinds:
            label = f"{kind} {case}"
            if kind == ENC:
                inputs = imgs
                plan = K.mode32_launch_plan(ENC, imgs[0])

                def bind(calls):
                    return lambda x: calls[ENC](x, q)
            else:
                inputs = [TP.encode_quantize32(x, LUT) for x in imgs]
                plan = K.mode32_launch_plan(DEC, inputs[0], size_x=w,
                                            size_y=h)

                def bind(calls):
                    return lambda r: calls[DEC](r, qi, w, h)
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
            for key in ("package", "parent"):
                if key in variants:
                    call, inp = variants[key]
                    clocks = clock_under_load(call, inp)
                    runs[f"{label} {key} clock"] = clocks
                    print(f"{label:32s} {key:30s} under load: {clocks}",
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
