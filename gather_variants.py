#!/usr/bin/env python3
"""Time variants of the plane gather (``csrc/collectives.cu``) against
each other on one CUDA card, in turns, in one process.

    python3 gather_variants.py [--rounds N]

The shapes are those ``chip_smoke.py`` times: the 4K dual view's stereo
segments over four shards of card 0 for ``ring_gather_kernel``, and
(8, 8, 128) for ``selfring_kernel``.  Two sets:

* builds of the source with a part of the synchronisation changed, made
  from ``csrc/collectives.cu`` at run time under the port's build
  directory (which git ignores) and never used by the package: the
  barrier off, the arrival off, both off, a scope fence before the
  arrival's release reductions, the first loads issued after the
  barrier instead of before it.  Without a barrier or an arrival the
  bytes are still right here only because one stream orders the calls;
* launch plans of the package's own build: CTAs an SM for the launch,
  stages, tile bytes.

Each variant is timed by CUDA events around a rotation queued behind a
device sleep and by the profiler, as ``chip_smoke.py`` times the gather,
and checked against the segments byte for byte.  One line a run, then a
JSON summary.  Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys

import torch

import chip_smoke as cs
from simd_dct_tpu_torch import dist
from simd_dct_tpu_torch.dist import collectives as C
from simd_dct_tpu_torch.kernels import _build

_ENTER = """    if (threadIdx.x == 0) bulk.begin();
    if (!enter<kSys>(p, r)) {
      if (threadIdx.x == 0) bulk.drain();
      return;
    }
"""
_ARRIVE = """  if constexpr (!kBulk) fence_scope<kSys>();
"""
_SIGNAL = """  if (blockIdx.x == 0 && threadIdx.x < r.nsig)"""
_WAIT = """      threadIdx.x >= r.nwait || wait_for<kSys>"""

# name -> [(text of the source, its replacement)]
_BUILDS = {
    "as built": [],
    "no barrier": [(_SIGNAL, "  if (false)"),
                   (_WAIT, "      true || wait_for<kSys>")],
    "no arrival": [(_ARRIVE, _ARRIVE + "  return;\n")],
    "no barrier, no arrival": [(_SIGNAL, "  if (false)"),
                               (_WAIT, "      true || wait_for<kSys>"),
                               (_ARRIVE, _ARRIVE + "  return;\n")],
    "scope fence before the release": [
        (_ARRIVE, "  fence_scope<kSys>();\n")],
    "first loads after the barrier": [
        (_ENTER, "    if (!enter<kSys>(p, r)) return;\n"
                 "    if (threadIdx.x == 0) bulk.begin();\n")],
}
# (CTAs an SM, stages, tile bytes) of the package's build
_PLANS = [(2, 4, 16384), (1, 4, 16384), (3, 4, 16384), (2, 2, 16384),
          (2, 3, 16384), (2, 4, 8192), (3, 2, 16384)]


class _Variant:
    """A build of the gather's entry points; every other symbol from the
    package's library."""

    def __init__(self, path: str, main):
        lib = ctypes.CDLL(path)
        p, i, ll, ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_ulonglong)
        lib.sdct_ring_gather.argtypes = [p, i, i, ll, ll, ll, i, i, ll, i, p,
                                         ull, p]
        lib.sdct_ring_gather.restype = i
        lib.sdct_selfring.argtypes = [p, i, ll, ll, ll, i, ll, i, p, ull, p]
        lib.sdct_selfring.restype = i
        lib.sdct_gather_capacity.argtypes = [i, p, p]
        lib.sdct_gather_capacity.restype = i
        self.lib, self.main = lib, main

    def __getattr__(self, name):
        if name in ("sdct_ring_gather", "sdct_selfring",
                    "sdct_gather_capacity"):
            return getattr(self.lib, name)
        return getattr(self.main, name)


def build_variants(main) -> dict[str, _Variant]:
    """Compile every variant of ``_BUILDS`` (one nvcc each, together)."""
    with open(os.path.join(_build.CSRC, "collectives.cu")) as f:
        src = f.read()
    out = os.path.join(_build.BUILD_ROOT, "gather_variants")
    os.makedirs(out, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for k, (name, edits) in enumerate(_BUILDS.items()):
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"variant {name!r}: the source no longer "
                                   f"holds {old.strip()!r}")
            text = text.replace(old, new)
        cu = os.path.join(out, f"variant{k}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(out, f"libvariant{k}.so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name!r}:\n"
                               f"{err.decode()[-3000:]}")
        libs[name] = _Variant(so, main)
    return libs


def time_once(mesh, segs, xs, cycles_per_ms) -> dict:
    """One variant's run: the gather (queued events and profiler) and the
    self-ring (profiler), after a byte-for-byte check of the gather."""
    mesh._collective_workspace = None
    for m in C._self_meshes.values():
        m._collective_workspace = None
    got = C.gather_planes_remote(segs[0], mesh)
    C.check_workspace(mesh)
    cs.require(all(torch.equal(r, segs[0].full()) for r in got.shards),
               "the variant's gather is exact")

    def gather(seg):
        return C.gather_planes_remote(seg, mesh)

    queued = cs.queued_ms(gather, segs, cs.REPS, cycles_per_ms) * 1e3
    C.check_workspace(mesh)
    prof, _ = cs.profiled_us(gather, segs, match="ring_gather")
    C.check_workspace(mesh)
    self_prof, _ = cs.profiled_us(C.selfring, xs, match="selfring")
    return {"gather_us": queued, "gather_profiler_us": prof,
            "selfring_profiler_us": self_prof,
            "plan": tuple(mesh._collective_workspace.last_plan)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2,
                    help="passes over each set, the order reversed each "
                    "pass")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device; nothing was run",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip(), flush=True)
    main_lib = _build.load()
    libs = build_variants(main_lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cycles_per_ms = cs.sleep_cycles_per_ms()
    mesh, _ = cs.dist_meshes()
    lut = cs.default_quant_lut(50)
    segs = [dist.encode_quantize_stereo_sharded(
        cs.random_images(gen, 4096, 3840, 1), lut, mesh) for _ in range(4)]
    xs = [torch.randint(0, 256, (8, 8, 128), generator=gen,
                        dtype=torch.uint8, device="cuda") for _ in range(4)]
    runs: dict[str, list[dict]] = {}
    load = _build.load
    try:
        for r in range(args.rounds):
            names = list(libs) if r % 2 == 0 else list(libs)[::-1]
            for name in names:
                _build.load = lambda name=name: libs[name]
                res = time_once(mesh, segs, xs, cycles_per_ms)
                runs.setdefault(f"build: {name}", []).append(res)
                print(f"build {name!r}: {res}", flush=True)
    finally:
        _build.load = load
    saved = (C._CTAS_PER_SM, C._STAGES, C._TILE)
    try:
        for r in range(args.rounds):
            plans = _PLANS if r % 2 == 0 else _PLANS[::-1]
            for plan in plans:
                C._CTAS_PER_SM, C._STAGES, C._TILE = plan
                res = time_once(mesh, segs, xs, cycles_per_ms)
                runs.setdefault(f"plan (CTAs an SM, stages, tile) {plan}",
                                []).append(res)
                print(f"plan {plan}: {res}", flush=True)
    finally:
        C._CTAS_PER_SM, C._STAGES, C._TILE = saved
    summary = {k: {m: [r[m] for r in v] for m in
                   ("gather_us", "gather_profiler_us",
                    "selfring_profiler_us")} | {"plan": v[0]["plan"]}
               for k, v in runs.items()}
    for k, v in summary.items():
        v["gather_us_median"] = statistics.median(v["gather_us"])
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
