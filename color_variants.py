#!/usr/bin/env python3
"""Time variants of the colour tile kernels (``enc32_rgb_kernel`` and
``roundtrip32_rgb_kernel`` in ``csrc/color32.cu``) against each other on one
CUDA card, in turns, in one process.

    python3 color_variants.py [--rounds N] [--parent DIR]

Each variant is timed on the 4K RGB dual view (3, 4096, 3840) and on an
8-frame (8, 3, 1088, 1920) batch by CUDA events around a rotation queued
behind a device sleep and by the profiler, as ``chip_smoke.py`` times them,
and its bytes are checked against the package's kernels:

* the package's kernels, and the encode's plain-load variant on (3, 2048,
  3840) views 8 bytes off a 16-byte boundary (4K only), against the same
  views aligned;
* builds of ``csrc/color32.cu`` with a source edit (of it or of the
  headers it includes), made at run time under
  the port's build directory (which git ignores) and never used by the
  package: the encode's ``__launch_bounds__`` given a least number of CTAs
  an SM (a register cap) or the round trip's taken away; the encode with
  its byte conversions on the conversion unit (``(float)b``, and ``rintf``
  and an int cast in the rne quantizer: the same bytes); and, for timing
  only (their bytes are logged, not required), no proxy fence before the
  bulk stores, and the encode with its column phase, its row phase, both,
  or its loads and stores skipped at run time;
* with ``--parent``, a checkout of an earlier version of the repository:
  its ``simd_dct_tpu_torch/csrc/color32.cu`` built alone the same way and
  its two kernels called through the C entry points of that version (with
  or without the launch plan's arguments, by its source).

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
from simd_dct_tpu_torch.kernels import _build, cuda_dct as K
from simd_dct_tpu_torch.layout import BASE_CHROMA_QUANT_TABLE

CASES = [("4096x3840 image", 4096, 3840, 1, 8),
         ("8x1088x1920 batch", 1088, 1920, 8, 3)]
ENC, RT = "enc32_rgb", "roundtrip32_rgb"
_BOUNDS = "__launch_bounds__(kTileThreads)"
_COLUMNS = "    mix_columns(stage, cross, mix, b, x);\n"
_ROWS = ("    uint8_t* rec = recs + half * kTileRec;\n#pragma unroll\n"
         "    for (int ch = 0; ch < 3; ++ch) {")
_ARM = ('  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], '
        '%1;" ::"r"(saddr(bar)),\n               "r"(kTileIn)\n'
        '               : "memory");\n')
_NO_COLUMNS = (_COLUMNS,
               "    if (g.w < 0) mix_columns(stage, cross, mix, b, x);\n")
_NO_ROWS = (_ROWS, _ROWS.replace("ch < 3", "ch < (g.w < 0 ? 3 : 0)"))
_NO_LOADS = (_ARM, '  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" '
             '::"r"(saddr(bar)) : "memory");\n  return;\n')
_NO_STORES = ("  if (lane < 3 * groups) {", "  if (lane < 0) {")
_U8F = "  return __fsub_rn(__int_as_float(0x4B000000u | b), kTwo23);\n"
_QUANT = ("  if (R == kRne) return (uint8_t)(rint_bits(fminf(fmaxf(x, "
          "-127.0f), 128.0f)) + 127u);\n")
# name -> (edits of color32.cu, the kernels it is timed for, timing only)
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
}


def build_lib(name: str, src_dir: str, edits=(), source: str = "color32.cu",
              subdir: str = "color_variants") -> subprocess.Popen:
    """Start nvcc on ``src_dir``'s ``source`` alone, with ``edits`` applied
    to it or to the headers beside it (each edit to the first file that
    holds its text), under ``_build/<subdir>/<name>``."""
    out_dir = os.path.join(_build.BUILD_ROOT, subdir, name.replace(" ", "_"))
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
    return proc


def load_lib(proc: subprocess.Popen, name: str, old_abi: bool) -> ctypes.CDLL:
    log = proc.communicate()[0]
    if proc.returncode:
        raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
    for line in log.splitlines():
        if "registers" in line or "stack" in line:
            print(f"  ptxas {name}: {line.strip()}", flush=True)
    dll = ctypes.CDLL(proc.lib)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if old_abi:
        dll.sdct_enc32_rgb.argtypes = [p, p, p, p, p, i, i, i, ll, i, p]
        dll.sdct_roundtrip32_rgb.argtypes = [p, p, p, p, p, p, p, i, i, i, ll,
                                             p]
    else:
        dll.sdct_enc32_rgb.argtypes = [p, p, p, p, p, i, i, i, ll, i, i, i, i,
                                       p]
        dll.sdct_roundtrip32_rgb.argtypes = [p, p, p, p, p, p, p, i, i, i, ll,
                                             i, i, p]
        dll.sdct_color_capacity.argtypes = [i, i, i, p, p, p]
    return dll


def lib_calls(dll, luma, chroma, old_abi: bool):
    """enc32_rgb and roundtrip32_rgb (rne) through a separate build's C
    entry points; the current ones with the package's plan, the capacity
    asked of that build."""
    ql, qil = K._host_scales(luma)
    qc, qic = K._host_scales(chroma)
    mix = K._COLOR_MIX.ctypes.data

    def plan_args(kind, x, n, h2, w, ps):
        if old_abi:
            return ()

        def capacity(variant):
            out = np.zeros(3, np.int32)
            rc = dll.sdct_color_capacity(
                K._KIND_CODE[kind], 0, K._VARIANT_CODE[variant],
                out.ctypes.data, out.ctypes.data + 4, out.ctypes.data + 8)
            if rc:
                raise RuntimeError(f"capacity: CUDA error {rc}")
            return int(out[1]), int(out[2])
        plan = K.color_plan(kind, n, h2, w, base=x.data_ptr(), plane_stride=ps,
                            capacity=capacity)
        variant = (K._VARIANT_CODE[plan.variant],) if kind == ENC else ()
        return (plan.grid, *variant, plan.smem)

    def shape_of(x):
        h, w = x.shape[-2:]
        return K._batch_of(x, 3), h // 2, w, h * w

    def enc(x):
        n, h2, w, ps = shape_of(x)
        out = torch.empty(x.shape[:-2] + (h2 * w,), dtype=torch.uint8,
                          device=x.device)
        rc = dll.sdct_enc32_rgb(x.data_ptr(), out.data_ptr(), ql.ctypes.data,
                                qc.ctypes.data, mix, n, h2, w, ps, 0,
                                *plan_args(ENC, x, n, h2, w, ps),
                                K._stream(x))
        if rc:
            raise RuntimeError(f"enc32_rgb: CUDA error {rc}")
        return out

    def roundtrip(x):
        n, h2, w, ps = shape_of(x)
        out = torch.empty(x.shape[:-2] + (h2, w), dtype=torch.uint8,
                          device=x.device)
        rc = dll.sdct_roundtrip32_rgb(
            x.data_ptr(), out.data_ptr(), ql.ctypes.data, qc.ctypes.data,
            qil.ctypes.data, qic.ctypes.data, mix, n, h2, w, ps,
            *plan_args(RT, x, n, h2, w, ps), K._stream(x))
        if rc:
            raise RuntimeError(f"roundtrip32_rgb: CUDA error {rc}")
        return out

    return {ENC: enc, RT: roundtrip}


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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("color_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    luma = default_quant_lut(100) * np.float32(255.0)
    chroma = BASE_CHROMA_QUANT_TABLE * np.float32(100 * 255)
    kernels = {ENC: lambda x: K.encode_quantize32_ycbcr(x, luma, chroma),
               RT: lambda x: K.roundtrip_quantize32_ycbcr(x, luma, chroma)}
    procs = {name: (build_lib(name, _build.CSRC, edits), False, kinds, timing)
             for name, (edits, kinds, timing) in BUILDS.items()}
    if args.parent:
        src = os.path.join(args.parent, "simd_dct_tpu_torch", "csrc")
        with open(os.path.join(src, "color32.cu")) as f:
            # an earlier interface takes no launch-plan arguments
            old_abi = "sdct_color_capacity" not in f.read()
        procs["parent"] = (build_lib("parent", src), old_abi, (ENC, RT),
                           False)
    others = {name: (lib_calls(load_lib(proc, name, old), luma, chroma, old),
                     kinds, timing)
              for name, (proc, old, kinds, timing) in procs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    cycles = cs.sleep_cycles_per_ms()
    runs = {}

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
        for name, fn in kernels.items():
            want = fn(rgbs[0])
            variants = {"package": (fn, rgbs)}
            for b, (calls, kinds, timing) in others.items():
                if name not in kinds:
                    continue
                same = torch.equal(calls[name](rgbs[0]), want)
                if not same:
                    print(f"{name} {b}: bytes differ", flush=True)
                cs.require(same or timing, f"{name} {b} gives the package's "
                           "bytes")
                variants[b] = (calls[name], rgbs)
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
                    call, inputs = variants[key]
                    clocks = clock_under_load(call, inputs)
                    runs[f"{name} {label} {key} clock"] = clocks
                    print(f"{name:16s} {label:18s} {key:30s} under load: "
                          f"{clocks}", flush=True)
            time_turns(name, label, variants)
    summary = {k: v if isinstance(v, dict) else {
                   "queued_us": [q for q, _ in v],
                   "profiler_us": [p for _, p in v],
                   "median_queued_us": statistics.median(q for q, _ in v)}
               for k, v in runs.items()}
    print(json.dumps({"card": smi.stdout.strip(), "runs": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
