#!/usr/bin/env python3
"""Time variants of the tile inverse (``detile_kernel`` in
``csrc/tiles.cu``) against each other on one CUDA card, in turns, in one
process, and hold their bytes to the package's.

    python3 tiles_variants.py [--rounds N] [--reps N] [--parent DIR]
                              [--only NAME ...]

Each variant is timed on the 2048x3840 top view of a 4K image and on 8
views of 1024x1920, raw and 'fy' (mode32's configuration, as
``chip_smoke.py`` times it), by CUDA events around a rotation queued
behind a device sleep and by the profiler:

* the package's kernel;
* builds of ``csrc/tiles.cu`` with a source edit (of it or of the headers
  it includes), made at run time under the port's build directory (which
  git ignores) and never used by the package: two threads an 8x8 block
  instead of four, two input buffers, two pixel buffers, two of each (with
  two or four threads a block), ``__launch_bounds__`` asking for 16 CTAs
  an SM (a register cap), the DCT basis read from dct_common.cuh's
  constant bank (``kD``), the byte conversions on the conversion unit
  (``(float)b``, ``rintf`` and int casts: the same bytes);
  and, for timing only (their bytes are logged, not required), the
  arithmetic skipped at run time, or the tensor loads and stores;
* with ``--parent``, a checkout of an earlier version of the repository:
  its ``simd_dct_tpu_torch/csrc/tiles.cu`` built alone the same way and
  called through that version's C entry points (with or without the launch
  plan's arguments, by its source).  First every byte of the package's
  detile must equal it on ``chip_smoke.py``'s TILE_GEOMETRIES, both
  orientations, with and without ``normalize``, on the tiles of random
  views and on random bytes; then the earlier detile is timed with the
  others, and the earlier and the package's tile kernel (``tiles_kernel``,
  which must keep its time) in turns beside them.

A build whose bytes must equal the package's is checked on both timing
cases first.  The SM clock and power under the package's kernel and the
earlier version's (nvidia-smi samples over 1.5 s) come first.  One line a
run, then a JSON summary.  Exits non-zero without a card.
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

CASES = [("2048x3840 top view", 2048, 3840, 1, 16),
         ("8x1024x1920 views", 1024, 1920, 8, 6)]
DET, TIL = "detile", "tiles"
ORIENTATIONS = ("fy", "fx")
_LOOPS = ["for (int h = 0; h < kDetileLines; ++h) {\n      // column v",
          "for (int h = 0; h < kDetileLines; ++h) {\n      // row j"]
_ARRIVE = ('  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"('
           'saddr(bar)) : "memory");\n  return;\n')
# tile_common.cuh: the basis table, the decode's byte conversions
_BASIS = "  return t[i];\n}"
_DEQ = ("  return __fmul_rn(__fsub_rn(__int_as_float(0x4B000000u | b), "
        "kTwo23 + 127.0f), q);\n")
_PACK = ("  return rint_bits(fminf(fmaxf(N ? __fmul_rn(y, 255.0f) : y, 0.0f), "
         "255.0f));\n")

_THREADS = ("constexpr int kDetileBlockThreads = 4;",
            "constexpr int kDetileBlockThreads = 2;")
_STAGES = ("constexpr int kDetileStages = 1;",
           "constexpr int kDetileStages = 2;")
_OUT = ("constexpr int kDetileOutBuffers = 1;",
        "constexpr int kDetileOutBuffers = 2;")
# name -> (edits of tiles.cu or its headers, timing only)
BUILDS = {
    "two threads a block": ([_THREADS], False),
    "two input buffers": ([_STAGES], False),
    "two pixel buffers": ([_OUT], False),
    "two of each buffer": ([_STAGES, _OUT], False),
    "two threads, two of each buffer": ([_THREADS, _STAGES, _OUT], False),
    "16 CTAs an SM": (
        [("__launch_bounds__(kDetileThreads)",
          "__launch_bounds__(kDetileThreads, 2048 / kDetileThreads)")],
        False),
    "basis from the constant bank": ([(_BASIS, "  return kD[i];\n}")], False),
    "conversions by the unit": (
        [(_DEQ, "  return __fmul_rn((float)b - 127.0f, q);\n"),
         (_PACK, "  return (uint32_t)(int)fminf(fmaxf(rintf(N ? __fmul_rn("
                 "y, 255.0f) : y), 0.0f), 255.0f);\n")], False),
    "no arithmetic": (
        [(loop, loop.replace("h < kDetileLines",
                             "h < (g.nj == 0) * kDetileLines"))
         for loop in _LOOPS], True),
    "no loads and no stores": (
        [("  arrive_expect(bar, kDetileBytes);\n", _ARRIVE),
         ("if (storer) store_rows16(",
          "if (storer && g.nj == 0) store_rows16(")],
        True),
}


def load_lib(proc: subprocess.Popen, name: str) -> ctypes.CDLL:
    """The library a build made, its C interfaces bound: the tile inverse
    with or without the launch plan's arguments (``dll.planned``).  Prints
    the tile inverse's ptxas lines."""
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
    entry = ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line
        elif "detile" in entry and ("registers" in line or "stack" in line):
            print(f"  ptxas {name}: {line.strip()}", flush=True)
    dll = ctypes.CDLL(proc.lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.planned = hasattr(dll, "sdct_detile_capacity")
    dll.sdct_tiles.argtypes = [p, p, p, i, i, i, i, i, i, p]
    if dll.planned:
        dll.sdct_detile.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        dll.sdct_detile_capacity.argtypes = [i, i, p, p, p]
    else:
        dll.sdct_detile.argtypes = [p, p, p, i, i, i, i, i, p]
    return dll


def lib_calls(dll) -> dict:
    """The tile inverse and the tile kernel through a separate build's C
    entry points: ``detile(tiles, qi, normalize, orientation)`` (with the
    package's plan for the capacity and the shared bytes that build
    reports) and ``tiles(view, q, normalize, orientation)`` (rne)."""

    def check(rc, what):
        if rc:
            raise RuntimeError(f"{what}: CUDA error {rc}")

    def detile(tiles, qi, normalize, orientation):
        p, _, nj, _ = tiles.shape[-4:]
        h2, w = 128 * p, 128 * nj
        n = tiles.numel() // (h2 * w)
        out = torch.empty(tiles.shape[:-4] + (h2, w), dtype=torch.uint8,
                          device=tiles.device)
        o = K._ORIENTATION_CODE[orientation]
        extra = ()
        if dll.planned:
            cap = np.zeros(3, np.int32)
            check(dll.sdct_detile_capacity(
                int(normalize), o, cap.ctypes.data, cap.ctypes.data + 4,
                cap.ctypes.data + 8), "detile capacity")
            plan = K.detile_plan(n, h2, w, base=tiles.data_ptr(),
                                 capacity=lambda: (int(cap[1]), int(cap[2])))
            extra = (plan.grid, int(cap[0]))
        check(dll.sdct_detile(tiles.data_ptr(), out.data_ptr(),
                              qi.ctypes.data, n, h2, w, int(normalize), o,
                              *extra, K._stream(tiles)), DET)
        return out

    def tiles(view, q, normalize, orientation):
        h2, w = view.shape[-2:]
        out = torch.empty(view.shape[:-2] + (h2 // 128, 128, w // 128, 128),
                          dtype=torch.uint8, device=view.device)
        check(dll.sdct_tiles(view.data_ptr(), out.data_ptr(), q.ctypes.data,
                             view.numel() // (h2 * w), h2, w, int(normalize),
                             K._ORIENTATION_CODE[orientation], 0,
                             K._stream(view)), TIL)
        return out

    return {DET: detile, TIL: tiles}


def scales(normalize: bool):
    """(quant, dequant) host scales: the 1/255 domain when normalized,
    mode32's raw domain otherwise (chip_smoke.py's LUTs)."""
    lut = default_quant_lut(50) * (1 if normalize else np.float32(255.0))
    return cs.tile_scales(lut)


def parent_equal(gen, parent) -> dict:
    """The package's detile against the earlier version's on every tile
    geometry, orientation and ``normalize``, on the tiles of random views
    and on random bytes: the mismatches of each comparison (all must be
    0)."""
    out = {}
    for h2, w, frames in cs.TILE_GEOMETRIES:
        view = cs.random_images(gen, h2, w, frames)
        tag = f"{frames}x{h2}x{w}"
        for normalize in (False, True):
            q, qi = scales(normalize)
            for o in ORIENTATIONS:
                coded = K.tiles_panels(view, q, normalize=normalize,
                                       rounding="rne", orientation=o)
                noise = torch.randint(0, 256, coded.shape, generator=gen,
                                      dtype=torch.uint8, device="cuda")
                for what, tiles in (("coded", coded), ("random", noise)):
                    key = f"detile {tag} {o} normalize={normalize} {what}"
                    n = int((K.detile_panels(tiles, qi, normalize=normalize,
                                             orientation=o)
                             != parent[DET](tiles, qi, normalize, o)).sum())
                    out[key] = n
                    print(f"  parent {key}: {n} mismatches", flush=True)
                    cs.require(n == 0, f"{key} equals the earlier version's "
                               "bytes")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", help="a checkout of an earlier version")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--only", nargs="*", help="build only these variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tiles_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    builds = {k: v for k, v in BUILDS.items()
              if args.only is None or k in args.only}
    procs = {name: (build_lib(name, _build.CSRC, edits, "tiles.cu",
                              "tiles_variants"), timing)
             for name, (edits, timing) in builds.items()}
    if args.parent:
        src = os.path.join(args.parent, "simd_dct_tpu_torch", "csrc")
        procs["parent"] = (build_lib("parent", src, (), "tiles.cu",
                                     "tiles_variants"), False)
    _build.load()
    others = {name: (lib_calls(load_lib(proc, name)), timing)
              for name, (proc, timing) in procs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {}
    if args.parent:
        runs["parent bytes"] = parent_equal(gen, others["parent"][0])
    cycles = cs.sleep_cycles_per_ms()

    def time_turns(name, label, variants):
        order = list(variants)
        for r in range(args.rounds):
            for key in order if r % 2 == 0 else order[::-1]:
                call, inputs = variants[key]
                q = cs.queued_ms(call, inputs, args.reps, cycles) * 1e3
                prof, _ = cs.profiled_us(call, inputs)
                runs.setdefault(f"{name} {label} {key}", []).append((q, prof))
                print(f"{name:7s} {label:19s} {key:30s} round {r}: queued "
                      f"{q:8.3f} us  profiler "
                      f"{prof if prof is None else round(prof, 3)}",
                      flush=True)

    q, qi = scales(False)
    for label, h2, w, frames, n_rot in CASES:
        views = [cs.random_images(gen, h2, w, frames) for _ in range(n_rot)]
        tiles = [panel.forward_tiles(v, q, normalize=False, orientation="fy",
                                     rounding="rne") for v in views]
        plan = K.detile_launch_plan(tiles[0])
        print(f"{DET} {label} plan {plan._asdict()}", flush=True)

        def package(t):
            return K.detile_panels(t, qi, normalize=False, orientation="fy")
        want = package(tiles[0])
        variants = {"package": (package, tiles)}
        for b, (calls, timing) in others.items():
            call = (lambda c: lambda t: c(t, qi, False, "fy"))(calls[DET])
            same = torch.equal(call(tiles[0]), want)
            if not same:
                print(f"{DET} {b}: bytes differ", flush=True)
            cs.require(same or timing, f"{DET} {b} gives the package's bytes")
            variants[b] = (call, tiles)
        for key in ("package", "parent"):
            if key in variants:
                call, inp = variants[key]
                clocks = clock_under_load(call, inp)
                runs[f"{DET} {label} {key} clock"] = clocks
                print(f"{DET:7s} {label:19s} {key:30s} under load: {clocks}",
                      flush=True)
        time_turns(DET, label, variants)
        if args.parent:
            parent = others["parent"][0][TIL]

            def tile_package(v):
                return K.tiles_panels(v, q, normalize=False, rounding="rne",
                                      orientation="fy")
            cs.require(torch.equal(tile_package(views[0]),
                                   parent(views[0], q, False, "fy")),
                       "tiles: the earlier version's bytes")
            time_turns(TIL, label, {
                "package": (tile_package, views),
                "parent": ((lambda v: parent(v, q, False, "fy")), views)})
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
