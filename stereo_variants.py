#!/usr/bin/env python3
"""Time variants of the stereo tile kernels (``enc_stereo_kernel`` and
``dec_stereo_kernel`` in ``csrc/stereo.cu``) against each other on one CUDA
card, in turns, in one process, and hold their bytes to the package's.

    python3 stereo_variants.py [--rounds N] [--reps N] [--parent DIR]
                               [--only NAME ...]

Each variant is timed on the 4K dual view (4096, 3840) in the interleaved
layout, and on an 8-frame (8, 1088, 1920) batch, by CUDA events around a
rotation queued behind a device sleep and by the profiler, as
``chip_smoke.py`` times them:

* the package's kernels with the plan's tensor variant, the plain variant
  forced on the same tensors, and (the encode, 4K) the plain variant that
  the plan picks for views 8 bytes off a 16-byte boundary;
* builds of ``csrc/stereo.cu`` with a source edit (of it or of the headers
  it includes), made at run time under the port's build directory (which
  git ignores) and never used by the package: the byte conversions on the
  conversion unit (``(float)b``, ``rintf`` and int casts: the same bytes),
  four threads a block (two columns, then two rows, each), the DCT basis
  read from dct_common.cuh's constant bank (``kD``) instead of
  compile-time values, ``__launch_bounds__`` asking for more CTAs an SM
  (a register cap); and, for timing only (their bytes are logged, not
  required), the arithmetic skipped at run time, or the tensor loads and
  stores;
* with ``--parent``, a checkout of an earlier version of the repository:
  its ``simd_dct_tpu_torch/csrc/stereo.cu`` built alone the same way and
  called through the C entry points of that version (with or without the
  launch plan's arguments, by its source).  The package's
  kernels, in both variants, must give its bytes at every geometry, view
  layout, rounding and strip range of ``chip_smoke.py``'s phase 8 (the
  encode of each, and the decode of the plain version's records).

A build whose bytes must equal the package's is checked on both timing
cases first.  The SM clock and power under the package's kernels and the
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
from simd_dct_tpu_torch.kernels import _build, cuda_dct as K, torch_path as TP
from simd_dct_tpu_torch.layout import stereo as L_stereo

CASES = [("4096x3840 image", 4096, 3840, 1, 16),
         ("8x1088x1920 batch", 1088, 1920, 8, 6)]
ENC, DEC = "enc_stereo", "dec_stereo"
_BOUNDS = "__launch_bounds__(kStereoThreads)"
_BYTE = ("  return __fsub_rn(__int_as_float(__byte_perm(w, 0x4B00u, "
         "0x5440 + i)), kTwo23);\n")
_QUANT = ("  if (R == kRne) return (uint8_t)(rint_bits(fminf(fmaxf(x, "
          "-127.0f), 128.0f)) + 127u);\n")
# the decode's byte conversions (tile_common.cuh, shared with tiles.cu)
_DEQ = ("  return __fmul_rn(__fsub_rn(__int_as_float(0x4B000000u | b), "
        "kTwo23 + 127.0f), q);\n")
_PACK = ("  return rint_bits(fminf(fmaxf(N ? __fmul_rn(y, 255.0f) : y, 0.0f), "
         "255.0f));\n")
# tile_common.cuh basis: the table, or (an edit) kD's constant bank
_BASIS = "  return t[i];\n}"
_COLS = ("for (int uu = 0; uu < 8; ++uu) {\n"
         "        float* dst = cross + enc_cross(")
_ROWS = ("for (int h = 0; h < kLines; ++h) {\n"
         "        const int u = kLines * w + h;")
_DCOLS = "for (int h = 0; h < kLines; ++h) {\n      // column v = kLines*w + h"
_DROWS = "for (int h = 0; h < kLines; ++h) {\n      // row j = kLines*w + h"


def _never(loop: str) -> tuple[str, str]:
    """An edit that skips the body of ``loop`` (a condition the compiler
    cannot fold; the loop still unrolls)."""
    head, rest = loop.split("{", 1)
    return loop, head + "if (g.w < 0) {" + rest


# name -> (edits of stereo.cu or its headers, kernels, timing only)
BUILDS = {
    "conversions by the unit": (
        [(_BYTE, "  return (float)((w >> (8 * i)) & 0xffu);\n"),
         (_QUANT, "  if (R == kRne) return (uint8_t)(int)(fminf(fmaxf("
                  "rintf(x), -127.0f), 128.0f) + 127.0f);\n"),
         (_DEQ, "  return __fmul_rn((float)b - 127.0f, q);\n"),
         (_PACK, "  return (uint32_t)(int)fminf(fmaxf(rintf(N ? __fmul_rn("
                 "y, 255.0f) : y), 0.0f), 255.0f);\n")], (ENC, DEC), False),
    "four threads a block": (
        [("constexpr int kBlockThreads = 2;",
          "constexpr int kBlockThreads = 4;")],
        (ENC, DEC), False),
    "basis from the constant bank": (
        [(_BASIS, "  return kD[i];\n}")], (ENC, DEC), False),
    "built for 2048 threads an SM": (
        [(_BOUNDS,
          "__launch_bounds__(kStereoThreads, 2048 / kStereoThreads)")],
        (ENC, DEC), False),
    "no arithmetic": (
        [_never(_COLS), _never(_ROWS), _never(_DCOLS), _never(_DROWS)],
        (ENC, DEC), True),
    "no loads and no stores": (
        [("  expect_tx(bar, kTileBytes);\n",
          '  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"('
          'saddr(bar)) : "memory");\n  return;\n'),
         ("if (storer) store_records(",
          "if (storer && g.w < 0) store_records("),
         ("storer) store_pixels(", "storer && g.w < 0) store_pixels(")],
        (ENC, DEC), True),
}


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
        dll.sdct_enc_stereo.argtypes = [p, p, p, i, i, i, i, i, i, i, i, ll, p]
        dll.sdct_dec_stereo.argtypes = [p, p, p, i, i, i, i, i, p]
    else:
        dll.sdct_enc_stereo.argtypes = [p, p, p, i, i, i, i, i, i, i, i, ll, i,
                                        i, i, i, p]
        dll.sdct_dec_stereo.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
        dll.sdct_stereo_capacity.argtypes = [i, i, i, p, p, p, p]
    return dll


def lib_calls(dll, lut, old_abi: bool):
    """The encode and decode through a separate build's C entry points,
    each as f(x, view_layout="interleaved", rounding="rne", sy=0,
    ey=2^30); the current ones with the package's plan for the tile width
    and capacity that build reports."""
    q, qi = K._host_scales(lut)

    def plan_args(kind, rounding, n, h, w, vl, pixels, records, stride):
        if old_abi:
            return ()
        out = np.zeros(4, np.int32)
        rc = dll.sdct_stereo_capacity(
            K._STEREO_KIND_CODE[kind], K._ROUNDING_CODE[rounding], 1,
            *(out.ctypes.data + 4 * i for i in range(4)))
        if rc:
            raise RuntimeError(f"capacity: CUDA error {rc}")
        nb = int(out[0])
        if nb != K.STEREO_TILE_BLOCKS:
            raise RuntimeError(f"a build with tiles of {nb} blocks: the plan "
                               f"knows {K.STEREO_TILE_BLOCKS}")

        def capacity(variant):
            c = np.zeros(4, np.int32)
            rc = dll.sdct_stereo_capacity(
                K._STEREO_KIND_CODE[kind], K._ROUNDING_CODE[rounding],
                K._VARIANT_CODE[variant],
                *(c.ctypes.data + 4 * i for i in range(4)))
            if rc:
                raise RuntimeError(f"capacity: CUDA error {rc}")
            return int(c[2]), int(c[3])
        plan = K.stereo_plan(kind, n, h, w, vl, pixels=pixels,
                             records=records, view_stride=stride,
                             capacity=capacity)
        # the shared bytes that build lays out
        return (plan.grid, nb, K._VARIANT_CODE[plan.variant], int(out[1]))

    def enc(x, vl="interleaved", rounding="rne", sy=0, ey=1 << 30):
        h, w = x.shape[-2:]
        n = K._batch_of(x, 2)
        out = torch.empty(x.shape[:-2] + L_stereo.record_shape(vl, h, w),
                          dtype=torch.uint8, device=x.device)
        rc = dll.sdct_enc_stereo(
            x.data_ptr(), out.data_ptr(), q.ctypes.data, n, h, w,
            L_stereo.native_stereo_bwp(w), sy, ey, K._ROUNDING_CODE[rounding],
            K._VIEW_LAYOUT_CODE[vl], (h // 2) * w,
            *plan_args(ENC, rounding, n, h, w, vl, x.data_ptr(),
                       out.data_ptr(), (h // 2) * w), K._stream(x))
        if rc:
            raise RuntimeError(f"enc_stereo: CUDA error {rc}")
        return out

    def dec(r, vl="interleaved", size=None):
        h, w = size
        frame = L_stereo.record_shape(vl, h, w)
        n = K._batch_of(r, len(frame))
        out = torch.empty(r.shape[:r.ndim - len(frame)] + (h, w),
                          dtype=torch.uint8, device=r.device)
        rc = dll.sdct_dec_stereo(
            r.data_ptr(), out.data_ptr(), qi.ctypes.data, n, h, w,
            L_stereo.native_stereo_bwp(w), K._VIEW_LAYOUT_CODE[vl],
            *plan_args(DEC, "rne", n, h, w, vl, out.data_ptr(), r.data_ptr(),
                       (h // 2) * w), K._stream(r))
        if rc:
            raise RuntimeError(f"dec_stereo: CUDA error {rc}")
        return out

    return {ENC: enc, DEC: dec}


def off_views(imgs, shift: int):
    """The (2, H/2, W) views of (H, W) images, copied to start ``shift``
    bytes into a fresh buffer."""
    views = []
    for x in imgs:
        h, w = x.shape
        flat = torch.empty(h * w + 64, dtype=torch.uint8, device=x.device)
        view = flat[shift:shift + h * w].view(2, h // 2, w)
        view.copy_(x.view(2, h // 2, w))
        views.append(view)
    return views


def parent_equal(gen, lut, parent) -> dict:
    """The package's kernels in both variants against the parent's on
    every phase-8 geometry, layout, rounding and strip range: the number
    of byte mismatches of each comparison (all must be 0)."""
    out = {}

    def same(tag, got, want):
        n = int((got != want).sum())
        out[tag] = n
        print(f"  parent {tag}: {n} mismatches", flush=True)
        cs.require(n == 0, f"{tag} equals the earlier version's bytes")

    for h, w, frames in cs.STEREO_GEOMETRIES:
        img = cs.random_images(gen, h, w, frames)
        tag = f"{frames}x{h}x{w}"
        roundings = cs.ROUNDINGS if h in (4096, 256) else ("rne",)
        for vl in cs.VIEW_LAYOUTS:
            for r in roundings:
                want = parent[ENC](img, vl, r)
                for var in ("tensor", "plain"):
                    if var == "tensor" and w % 128:
                        continue
                    same(f"enc {tag} {vl} {r} {var}",
                         K.encode_quantize_stereo(img, lut, rounding=r,
                                                  view_layout=vl,
                                                  variant=var), want)
            rec = TP.encode_quantize_stereo(img, lut, view_layout=vl)
            want = parent[DEC](rec, vl, (h, w))
            for var in ("tensor", "plain"):
                if var == "tensor" and w % 128:
                    continue
                same(f"dec {tag} {vl} {var}",
                     K.decode_quantize_stereo(rec, lut, w, h, vl,
                                              variant=var), want)
    for h, w in [(512, 3840), (256, 200)]:
        img = cs.random_images(gen, h, w, 2)
        for sy, ey in [(16, 16), (64, 191), (0, h - 32)]:
            for vl in cs.VIEW_LAYOUTS:
                same(f"enc 2x{h}x{w} {vl} [{sy}, {ey}]",
                     K.encode_quantize_stereo(img, lut, sy, ey,
                                              view_layout=vl),
                     parent[ENC](img, vl, "rne", sy, ey))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--parent", help="a checkout of an earlier version")
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--only", nargs="*", help="build only these variants")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("stereo_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    lut = default_quant_lut(50)
    builds = {k: v for k, v in BUILDS.items()
              if args.only is None or k in args.only}
    procs = {name: (build_lib(name, _build.CSRC, edits, "stereo.cu",
                              "stereo_variants"), False, kinds, timing)
             for name, (edits, kinds, timing) in builds.items()}
    if args.parent:
        src = os.path.join(args.parent, "simd_dct_tpu_torch", "csrc")
        with open(os.path.join(src, "stereo.cu")) as f:
            # an earlier interface takes no launch-plan arguments
            old_abi = "sdct_stereo_capacity" not in f.read()
        procs["parent"] = (build_lib("parent", src, (), "stereo.cu",
                                     "stereo_variants"), old_abi, (ENC, DEC),
                           False)
    _build.load()
    others = {name: (lib_calls(load_lib(proc, name, old), lut, old), kinds,
                     timing)
              for name, (proc, old, kinds, timing) in procs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = {}
    if args.parent:
        runs["parent bytes"] = parent_equal(gen, lut, others["parent"][0])
    cycles = cs.sleep_cycles_per_ms()

    def time_turns(name, label, variants):
        order = list(variants)
        for r in range(args.rounds):
            for key in order if r % 2 == 0 else order[::-1]:
                call, inputs = variants[key]
                q = cs.queued_ms(call, inputs, args.reps, cycles) * 1e3
                prof, _ = cs.profiled_us(call, inputs)
                runs.setdefault(f"{name} {label} {key}", []).append((q, prof))
                print(f"{name:10s} {label:18s} {key:30s} round {r}: queued "
                      f"{q:8.3f} us  profiler "
                      f"{prof if prof is None else round(prof, 3)}",
                      flush=True)

    for label, h, w, frames, n_rot in CASES:
        imgs = [cs.random_images(gen, h, w, frames) for _ in range(n_rot)]
        recs = [TP.encode_quantize_stereo(x, lut) for x in imgs]
        package = {
            ENC: (lambda v: lambda x: K.encode_quantize_stereo(
                x, lut, variant=v), imgs),
            DEC: (lambda v: lambda r: K.decode_quantize_stereo(
                r, lut, w, h, variant=v), recs)}
        for name, (make, inputs) in package.items():
            fn = make(None)
            plan = (K.stereo_launch_plan(ENC, inputs[0], "interleaved")
                    if name == ENC else K.stereo_launch_plan(
                        DEC, inputs[0], "interleaved", w, h))
            print(f"{name} {label} plan {plan._asdict()}", flush=True)
            want = fn(inputs[0])
            variants = {"package": (fn, inputs),
                        "package, plain forced": (make("plain"), inputs)}
            cs.require(torch.equal(make("plain")(inputs[0]), want),
                       f"{name}: the plain variant gives the same bytes")
            for b, (calls, kinds, timing) in others.items():
                if name not in kinds:
                    continue
                call = (calls[ENC] if name == ENC else
                        (lambda c: lambda r: c(r, "interleaved", (h, w)))(
                            calls[DEC]))
                same = torch.equal(call(inputs[0]), want)
                if not same:
                    print(f"{name} {b}: bytes differ", flush=True)
                cs.require(same or timing, f"{name} {b} gives the package's "
                           "bytes")
                variants[b] = (call, inputs)
            if name == ENC and frames == 1:
                off = off_views(imgs, 8)

                def view(v):
                    return K.encode_stereo_view(v, lut)
                cs.require(torch.equal(view(off[0]), want),
                           "the views 8 bytes off give the same bytes")
                variants["views 8 bytes off, plain"] = (view, off)
            for key in ("package", "parent"):
                if key in variants:
                    call, inp = variants[key]
                    clocks = clock_under_load(call, inp)
                    runs[f"{name} {label} {key} clock"] = clocks
                    print(f"{name:10s} {label:18s} {key:30s} under load: "
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
