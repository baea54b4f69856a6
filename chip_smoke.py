#!/usr/bin/env python3
"""Bring-up check of ``simd_dct_tpu_torch`` on one NVIDIA GPU.

Run from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, and the script exits non-zero without the
result line):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the kernels from csrc/ with nvcc (one process per source, all
     started together), print build time and ptxas register use, run the
     capability probe;
  3. each mode32 kernel against its plain PyTorch version on the same CUDA
     tensors (+-1 on at most 0.2% of bytes) at 4096x3840, 1088x1920,
     256x192, a batch of 8 frames of 1088x1920, every rounding mode and a
     strip range; the 256x192 encode also against an independent float64
     NumPy model;
  4. the fused mode32 round trip equals decode(encode(x)) byte for byte,
     and its PSNR on a smooth 4K view is within 0.1 dB of the plain
     version's;
  5. the mode32 main path through the public api, with every launch counter
     set to 0 just before: 4K encode, decode and round trip, and the
     64-frame 1088x1920 round trip of the BASELINE video ladder; every
     kernel of the path must have launched;
  6. the enc-quant kernels against their plain versions (+-1 on at most
     0.2% of bytes) at the same geometries plus 4096x3848 (scalar only,
     W % 16 == 8): all three layouts, every rounding mode at 4K, strip
     ranges with and without legacy_range (one where pair_as_written spills
     into an excluded strip); and three exact identities on the card: pair
     == scalar permuted by the pair-cell map, pair_as_written == pair with
     every second half zeroed, decode(scalar) == decode(pair);
  7. the enc-quant main path through the public api with numpy inputs and
     no device (they must land on the card), counters set to 0 just
     before: 4K encode in the scalar and pair layouts, the decode of both,
     and a 64-frame 1088x1920 batch in one launch each way; round-trip PSNR
     on the smooth 4K view at quality 50 within 0.1 dB of the plain
     version's;
  8. the stereo kernels against their plain versions (+-1 on at most 0.2%
     of bytes) at 4096x3840, 1088x1920, 256x200 (W % 128 != 0: the
     byte-wide plane-row path) and an 8-frame 1088x1920 batch, in the
     interleaved, planar and native view layouts, every rounding mode at
     4K; strip ranges ([16, 16], [64, 191] and one that drops the last
     strip) and the 1096x1920 spill geometry; exact identities on the
     card: planar == stereo_interleaved_to_views(interleaved), native[...,
     :BW] == planar, native pad 127 in included strips and 0 in excluded
     ones, zero bytes outside the strip range (from the strip geometry),
     decode(interleaved) == decode(planar) == decode(native);
  9. the stereo main path through the public api with numpy inputs and no
     device, counters set to 0 just before: the 4K dual view in each view
     layout and the decode of each, and a 64-frame 1088x1920 native batch
     in one launch each way (4 enc_stereo and 4 dec_stereo launches);
     round-trip PSNR on the smooth 4K dual view at quality 50 within 0.1
     dB of the plain version's;
  10. timing of kernel, plain version and a same-run device-to-device copy
      of the same bytes (one view's for mode32 and enc-quant, the whole
      dual view's for stereo, the three channels' top view for colour),
      rotating over inputs larger than the 50 MB L2, median of REPS
      repetitions: kernel and copy by CUDA events with the rotation queued
      behind a device-side sleep (no host launch cost in the reading), the
      plain version by torch.profiler device time, and the CUDA-event wall
      of back-to-back calls for each (the 4:2:0 rows beside the colour
      rows' copy of the three channels' top view);
  11. the YCbCr 4:4:4 colour kernels against their plain versions (+-1 on
      at most 0.2% of bytes) on (3, H, W) planar RGB at 4096x3840 (every
      rounding mode), 1088x1920, 256x192 (W % 128 != 0) and an 8-frame
      1088x1920 batch; the fused round trip equals decode(encode(x)) byte
      for byte; its PSNR on the config-3 gate's input (three correlated
      channels of one smooth field, a 1024x3840 top view,
      simd_dct_tpu/bench/harness.py:151-156) within 0.1 dB of the plain
      version's;
  12. the colour main path through the public api with numpy inputs and no
      device, counters set to 0 just before: encode, decode and round trip
      of the 4K RGB dual view (3, 4096, 3840) and of a 64-frame
      (64, 3, 1088, 1920) batch, one launch each (2 of each colour kernel);
  13. the YCbCr 4:2:0 kernels against their plain versions (+-1 on at most
      0.2% of bytes) at 4096x3840 (every rounding mode), 1088x1920, 64x384
      (W % 256 != 0: a CUDA block's 32 macroblocks cross a macroblock row)
      and an 8-frame 1088x1920 batch; the Y segment of each 4:2:0 stream
      equals channel 0 of enc32_rgb's records byte for byte; round-trip
      PSNR on the config-3 gate's input within 0.1 dB of the plain
      version's;
  14. the 4:2:0 main path through the public api with numpy inputs and no
      device, counters set to 0 just before: encode and decode of the 4K
      RGB dual view and of a 64-frame (64, 3, 1088, 1920) batch (2 launches
      of each 4:2:0 kernel);
  15. the tile kernels against their plain versions (+-1 on at most 0.2%
      of bytes) on 2048x3840 (the 4K top view), 1024x1920, 128x128 and an
      8-frame 1024x1920 batch of views, raw + fy (mode32), normalized + fx
      (enc-quant) and normalized + fy (stereo), every rounding mode; and the
      identities with the kernels ported earlier, each with its mismatch
      count: tiles_to_group8 == enc32, tiles_to_block_contiguous == encq
      scalar, tiles_to_pair == encq pair, tiles_to_planar of both views ==
      enc_stereo interleaved, and the detile of each converted record ==
      dec32, decq scalar / pair and the stereo decode;
  16. the tile main path, the hybrid route (tile kernel, then a converter
      into the records of one mode, and back), counters set to 0 just
      before: mode32, enc-quant scalar and pair, and stereo (both views in
      one launch) on the 4096x3840 dual view, and a 64-frame 1024x1920
      mode32 batch each way; both tile kernels must have launched and the
      results lie on the card;
  17. the compat tier on the card: the three encodes at 4096x3840 (rne)
      and at 256x384 in every rounding, layout, strip range and view
      layout, and the three decodes, each byte-identical to the same call
      on CPU tensors and within +-1 on at most 0.2% of the fast kernels;
      the wall time and the CUDA kernels (profiler) of each 4K call;
  18. a batch of 65,536 frames of 16x64 (64 MB, one more than a launch
      takes) through encode_quantize32 / decode_quantize32,
      encode_quantize (scalar) and encode_quantize_stereo: each equals its
      two halves run apart, and the launch counters show 2 launches.
Phase 10 runs last, after phase 18.  The line before the last is a JSON
object with one entry per kernel (its time, its bound and its share of the
copy); the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from simd_dct_tpu_torch import api as sd
from simd_dct_tpu_torch.core.dct import dct_basis_np
from simd_dct_tpu_torch.core.quantize import VR, default_quant_lut
from simd_dct_tpu_torch.dispatch import capability
from simd_dct_tpu_torch.kernels import _build, cuda_dct, panel, torch_path
from simd_dct_tpu_torch.layout import BASE_CHROMA_QUANT_TABLE
from simd_dct_tpu_torch.layout.reorder import stereo_interleaved_to_views
from simd_dct_tpu_torch.utils.debug import compare_backends
from simd_dct_tpu_torch.utils.metrics import psnr

DCT32 = "simd_dct_tpu_torch/csrc/dct32.cu"
ENCQ = "simd_dct_tpu_torch/csrc/encq.cu"
STEREO = "simd_dct_tpu_torch/csrc/stereo.cu"
COLOR = "simd_dct_tpu_torch/csrc/color32.cu"
COLOR420 = "simd_dct_tpu_torch/csrc/color420.cu"
TILES = "simd_dct_tpu_torch/csrc/tiles.cu"
PALLAS = "simd_dct_tpu/kernels/pallas_dct.py"
COLOR32 = "simd_dct_tpu/kernels/color32.py"
C420 = "simd_dct_tpu/kernels/color420.py"
# kernel -> (source, the TPU kernel it replaces, main path)
KERNELS = {
    "enc32": (DCT32, f"{PALLAS}:81", "mode32"),
    "dec32": (DCT32, f"{PALLAS}:178", "mode32"),
    "roundtrip32": (DCT32, f"{PALLAS}:392", "mode32"),
    "probe": (DCT32, "simd_dct_tpu/dispatch/capability.py:55", "mode32"),
    "encq": (ENCQ, f"{PALLAS}:760", "enc-quant"),
    "decq": (ENCQ, f"{PALLAS}:882", "enc-quant"),
    "enc_stereo": (STEREO, f"{PALLAS}:1221 and {PALLAS}:1259", "stereo"),
    "dec_stereo": (STEREO, f"{PALLAS}:1015", "stereo"),
    "enc32_rgb": (COLOR, f"{COLOR32}:42", "colour"),
    "dec32_rgb": (COLOR, f"{COLOR32}:136", "colour"),
    "roundtrip32_rgb": (COLOR, f"{COLOR32}:207", "colour"),
    "enc420_rgb": (COLOR420, f"{C420}:135", "colour 4:2:0"),
    "dec420_rgb": (COLOR420, f"{C420}:260", "colour 4:2:0"),
    "tiles": (TILES, f"{PALLAS}:267", "tiles"),
    "detile": (TILES, f"{PALLAS}:331", "tiles"),
}
# (H, W, frames) of the dual-view images the comparisons run on
GEOMETRIES = [(4096, 3840, 1), (1088, 1920, 1), (256, 192, 1), (1088, 1920, 8)]
# 4:2:0 needs W % 128 == 0 and H % 32 == 0; at W = 384 (24 macroblocks a
# row) a CUDA block's 32 macroblocks cross a macroblock row
GEOMETRIES_420 = [(4096, 3840, 1), (1088, 1920, 1), (64, 384, 1),
                  (1088, 1920, 8)]
# stereo: W = 200 (BW = 25) takes the kernels' byte-wide plane-row path
STEREO_GEOMETRIES = [(4096, 3840, 1), (1088, 1920, 1), (256, 200, 1),
                     (1088, 1920, 8)]
# tiles: (H2, W, frames) of the views (H2 % 128 == 0, W % 128 == 0)
TILE_GEOMETRIES = [(2048, 3840, 1), (1024, 1920, 1), (128, 128, 1),
                   (1024, 1920, 8)]
LAYOUTS = ("scalar", "pair", "pair_as_written")
VIEW_LAYOUTS = ("interleaved", "planar", "native")
ROUNDINGS = ("rne", "scalar", "clamp_first")
DEV = "cuda"
REPS = 25
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FMA/s on the CUDA
# cores (67 TFLOP/s)
PEAK_BYTES_S = 3.35e12
PEAK_FMA_S = 33.5e12
# f32 FMAs per pixel of the cheapest form of one 2-D pass: the reference
# butterfly's 29 multiplies and 29 adds per 8-point transform
# (simd_dct_tpu/core/butterfly.py:8) fused into 29 FMAs, 16 transforms per
# 8x8 block (7.25 a pixel), plus one for the (de)quantizer's scale.  The
# colour kernels count per pixel position: per channel one pass (two for
# the round trip) and 3 FMAs for each BT.601 mix, the bias folded in.  The
# 4:2:0 kernels pass a quarter of the pixels per chroma channel, and the
# encode pools them: 3 adds per 4 pixels (the 1/4 folds into the scale).
PASS_FMA_PER_PX = 16 * 29 / 64 + 1
MIX_FMA_PER_PX = 3
POOL_FMA_PER_PX = 3 / 4
FMA_PER_PX = {"enc32": PASS_FMA_PER_PX, "dec32": PASS_FMA_PER_PX,
              "roundtrip32": 2 * PASS_FMA_PER_PX, "probe": 0,
              "encq": PASS_FMA_PER_PX, "decq": PASS_FMA_PER_PX,
              "enc_stereo": PASS_FMA_PER_PX, "dec_stereo": PASS_FMA_PER_PX,
              "enc32_rgb": 3 * (PASS_FMA_PER_PX + MIX_FMA_PER_PX),
              "dec32_rgb": 3 * (PASS_FMA_PER_PX + MIX_FMA_PER_PX),
              "roundtrip32_rgb": 3 * (2 * PASS_FMA_PER_PX
                                      + 2 * MIX_FMA_PER_PX),
              "enc420_rgb": (1.5 * PASS_FMA_PER_PX + 3 * MIX_FMA_PER_PX
                             + 2 * POOL_FMA_PER_PX),
              "dec420_rgb": 1.5 * PASS_FMA_PER_PX + 3 * MIX_FMA_PER_PX,
              "tiles": PASS_FMA_PER_PX, "detile": PASS_FMA_PER_PX}


def log(*args):
    print(*args, flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def random_images(gen, h, w, frames):
    shape = (h, w) if frames == 1 else (frames, h, w)
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device=DEV)


def smooth_image(gen, h, w):
    """The smooth test image of simd_dct_tpu/bench/harness.py:62-66."""
    yy = torch.arange(h, device=DEV, dtype=torch.float64)[:, None]
    xx = torch.arange(w, device=DEV, dtype=torch.float64)[None, :]
    noise = torch.randn((h, w), generator=gen, device=DEV,
                        dtype=torch.float64) * 3
    img = (128 + 45 * torch.sin(xx / 9.0) * torch.cos(yy / 7.0)
           + 30 * (xx / max(w - 1, 1)) + noise)
    return img.clamp(0, 255).to(torch.uint8)


def agree(name: str, got, want, errs: dict, key: str) -> None:
    rep = compare_backends({"kernel": got, "plain": want})["kernel-vs-plain"]
    log(f"  {name}: max_abs_diff={rep['max_abs_diff']} "
        f"mismatch_rate={rep['mismatch_rate']:.3e} ok={rep['ok']}")
    errs[key] = max(errs.get(key, 0), rep["max_abs_diff"])
    require(rep["ok"], f"{name} within +-1 on at most 0.2% of bytes")


def numpy_encode32_f64(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """Independent float64 model of the mode32 encode (rne)."""
    h, w = img.shape
    s, bw = h // 16, w // 8
    x = img[: h // 2].reshape(s, 8, bw, 8).transpose(0, 2, 1, 3)
    d = dct_basis_np("float64")
    c = np.einsum("uj,sbjk,vk->sbuv", d, x.astype(np.float64), d)
    q = 255.0 / (lut.astype(np.float64) * float(VR))
    n = np.clip(np.rint(c.reshape(s, bw, 64) * q) + 127, 0, 255)
    recs = n.astype(np.uint8).reshape(s, bw // 8, 8, 64).transpose(0, 1, 3, 2)
    return recs.reshape(-1)


def phase_compare(gen, lut, errs):
    log("phase 3: kernels against the plain version on the card")
    for h, w, frames in GEOMETRIES:
        img = random_images(gen, h, w, frames)
        tag = f"{frames}x{h}x{w}"
        modes = ("rne", "scalar", "clamp_first") if h == 4096 else ("rne",)
        for rounding in modes:
            agree(f"enc32 {tag} {rounding}",
                  cuda_dct.encode_quantize32(img, lut, rounding=rounding),
                  torch_path.encode_quantize32(img, lut, rounding=rounding),
                  errs, "enc32")
        rec = torch_path.encode_quantize32(img, lut)
        agree(f"dec32 {tag} (same records)",
              cuda_dct.decode_quantize32(rec, lut, w, h),
              torch_path.decode_quantize32(rec, lut, w, h), errs, "dec32")
        fused = cuda_dct.roundtrip_quantize32(img, lut)
        composed = cuda_dct.decode_quantize32(
            cuda_dct.encode_quantize32(img, lut), lut, w, h)
        require(torch.equal(fused, composed),
                f"roundtrip32 {tag}: fused == composed byte for byte")
        plain_rt = torch_path.roundtrip_quantize32(img, lut)
        diff = (fused.to(torch.int16) - plain_rt.to(torch.int16)).abs()
        errs["roundtrip32"] = max(errs.get("roundtrip32", 0),
                                  int(diff.max()))
        log(f"  roundtrip32 {tag}: fused == composed; against plain "
            f"max_abs_diff={int(diff.max())} "
            f"mismatch_rate={float((diff > 0).double().mean()):.3e}")
    img = random_images(gen, 512, 3840, 1)
    agree("enc32 512x3840 strip range [64, 191]",
          cuda_dct.encode_quantize32(img, lut, 64, 191),
          torch_path.encode_quantize32(img, lut, 64, 191), errs, "enc32")
    recs = cuda_dct.encode_quantize32(img, lut, 64, 191).view(32, -1)
    require(not recs[:4].any() and not recs[12:].any() and recs[4:12].any(),
            "strip range keeps strips 4..11 only")
    small = random_images(gen, 256, 192, 1)
    rep = compare_backends({
        "kernel": cuda_dct.encode_quantize32(small, lut),
        "numpy_f64": numpy_encode32_f64(small.cpu().numpy(), lut)})
    log(f"  enc32 256x192 against float64 numpy: {rep}")
    require(all(v["ok"] for v in rep.values()), "enc32 against float64 model")
    x = random_images(gen, 8, 128, 1)
    got = cuda_dct.probe_trial(x)
    errs["probe"] = int((got.to(torch.int16)
                         - torch_path.probe_trial(x).to(torch.int16))
                        .abs().max())
    require(errs["probe"] == 0, "probe kernel equals its plain version")
    log("  probe (8,128): equal")


def phase_psnr(gen, lut):
    log("phase 4: round-trip PSNR on a smooth 4K view")
    img = smooth_image(gen, 4096, 3840)
    top = img[:2048].cpu().numpy()
    fused = cuda_dct.roundtrip_quantize32(img, lut).cpu().numpy()
    plain = torch_path.roundtrip_quantize32(img, lut).cpu().numpy()
    p_k, p_p = psnr(top, fused), psnr(top, plain)
    log(f"  psnr kernel={p_k:.4f} dB plain={p_p:.4f} dB "
        f"delta={p_k - p_p:+.4f} dB")
    require(abs(p_k - p_p) < 0.1, "round-trip PSNR within 0.1 dB of plain")


def phase_main_path(gen, lut):
    log("phase 5: the main path through the public api")
    img = smooth_image(gen, 4096, 3840)
    video = random_images(gen, 1088, 1920, 64)
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    capability.probe.cache_clear()      # a fresh process probes on first use
    rec = sd.encode_quantize32(img, lut)
    pix = sd.decode_quantize32(rec, lut, 3840, 4096)
    rt = sd.roundtrip_quantize32(img, lut)
    vid = sd.roundtrip_quantize32(video, lut)
    torch.cuda.synchronize()
    counts = dict(cuda_dct.LAUNCHES)
    log(f"  launches: {counts}")
    for name, (_, _, path) in KERNELS.items():
        if path == "mode32":
            require(counts[name] > 0, f"{name} launched on the main path")
    require(rec.shape == (2048 * 3840,) and rec.dtype == torch.uint8,
            "record shape")
    require(pix.shape == rt.shape == (2048, 3840), "view shape")
    require(vid.shape == (64, 544, 1920), "video batch shape")
    require(rec.device.type == pix.device.type == vid.device.type == DEV,
            "results stay on the card")
    require(torch.equal(pix, rt), "api round trip == api decode(encode)")
    p = psnr(img[:2048].cpu().numpy(), rt.cpu().numpy())
    require(15.0 < p < 99.0, f"main-path PSNR {p:.2f} dB is plausible")
    log(f"  4K round-trip PSNR {p:.4f} dB; video batch {tuple(vid.shape)}")
    return counts


def phase_compare_encq(gen, lut, errs):
    log("phase 6: enc-quant kernels against the plain version on the card")
    geoms = GEOMETRIES + [(4096, 3848, 1)]
    for h, w, frames in geoms:
        img = random_images(gen, h, w, frames)
        tag = f"{frames}x{h}x{w}"
        layouts = LAYOUTS if w % 16 == 0 else ("scalar",)
        roundings = ROUNDINGS if h == 4096 else ("rne",)
        for layout in layouts:
            for rounding in roundings:
                agree(f"encq {tag} {layout} {rounding}",
                      cuda_dct.encode_quantize(img, lut, rounding=rounding,
                                               layout=layout),
                      torch_path.encode_quantize(img, lut, rounding=rounding,
                                                 layout=layout),
                      errs, "encq")
        for layout in layouts[:2]:
            rec = torch_path.encode_quantize(img, lut, layout=layout)
            agree(f"decq {tag} {layout} (same records)",
                  cuda_dct.decode_quantize(rec, lut, w, h, layout),
                  torch_path.decode_quantize(rec, lut, w, h, layout),
                  errs, "decq")
    img = random_images(gen, 512, 3840, 2)
    # strips are 16 rows of the dual-view buffer apart (8 with legacy_range)
    ranges = [(64, 191, False), (0, 100, True), (16, 16, False),
              (200, 1 << 40, True)]
    for sy, ey, legacy in ranges:
        for layout in LAYOUTS:
            got = cuda_dct.encode_quantize(img, lut, sy, ey, layout=layout,
                                           legacy_range=legacy)
            want = torch_path.encode_quantize(img, lut, sy, ey, layout=layout,
                                              legacy_range=legacy)
            agree(f"encq 2x512x3840 {layout} range [{sy}, {ey}] "
                  f"legacy={legacy}", got, want, errs, "encq")
            # the bytes the strip geometry leaves unwritten, spill included
            written = sd._strip_byte_mask(
                512, 3840, sy, ey, legacy_range=legacy,
                pair_spill=layout == "pair_as_written")
            if written is not None:
                skipped = torch.from_numpy(~written).to(DEV)
                require(not got[:, skipped].any()
                        and not want[:, skipped].any(),
                        "bytes outside the strip range and its spill are "
                        "zero in kernel and plain version")
    spilled = cuda_dct.encode_quantize(img, lut, 16, 16,
                                       layout="pair_as_written").view(2, 32, -1)
    require(spilled[:, 2, :64].any() and not spilled[:, 2, 64:].any()
            and not spilled[:, 3:].any(),
            "pair_as_written spills 64 bytes into the excluded strip 2")
    log("  pair_as_written range [16, 16]: strip 1 spills 64 bytes into "
        "strip 2")
    for h, w, frames in [(4096, 3840, 1), (1088, 1920, 8)]:
        img = random_images(gen, h, w, frames)
        scal = cuda_dct.encode_quantize(img, lut)
        pair = cuda_dct.encode_quantize(img, lut, layout="pair")
        aw = cuda_dct.encode_quantize(img, lut, layout="pair_as_written")
        bufs = scal.view(*scal.shape[:-1], h // 16, w // 8, 64)
        require(torch.equal(pair, torch_path.L_reorder.pair_cells(bufs)),
                "pair == scalar permuted by the pair-cell map")
        halves = pair.view(-1, 2, 64).clone()
        halves[:, 1] = 0
        require(torch.equal(aw, halves.view(aw.shape)),
                "pair_as_written == pair with second halves zeroed")
        require(torch.equal(cuda_dct.decode_quantize(scal, lut, w, h),
                            cuda_dct.decode_quantize(pair, lut, w, h,
                                                     "pair")),
                "decode(scalar) == decode(pair)")
        log(f"  {frames}x{h}x{w}: pair == perm(scalar), pair_as_written == "
            "pair with zero halves, decq(scalar) == decq(pair): exact")


def phase_main_path_encq(gen, lut):
    log("phase 7: the enc-quant main path through the public api "
        "(numpy inputs, no device)")
    img = smooth_image(gen, 4096, 3840).cpu().numpy()
    video = random_images(gen, 1088, 1920, 64).cpu().numpy()
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    rec = sd.encode_quantize(img, lut)
    rec_pair = sd.encode_quantize(img, lut, layout="pair")
    pix = sd.decode_quantize(rec, lut, 3840, 4096)
    pix_pair = sd.decode_quantize(rec_pair, lut, 3840, 4096, layout="pair")
    vid_rec = sd.encode_quantize(video, lut, layout="pair")
    vid = sd.decode_quantize(vid_rec, lut, 1920, 1088, layout="pair")
    torch.cuda.synchronize()
    counts = dict(cuda_dct.LAUNCHES)
    log(f"  launches: {counts}")
    for name, (_, _, path) in KERNELS.items():
        if path == "enc-quant":
            require(counts[name] > 0, f"{name} launched on the main path")
    require(counts["encq"] == 3 and counts["decq"] == 3,
            "one launch per call, the 64-frame batch included")
    require(all(t.device.type == DEV for t in
                (rec, rec_pair, pix, pix_pair, vid_rec, vid)),
            "numpy inputs with no device run on the card")
    require(rec.shape == rec_pair.shape == (2048 * 3840,), "record shape")
    require(pix.shape == (2048, 3840) and vid.shape == (64, 544, 1920),
            "view shapes")
    require(torch.equal(pix, pix_pair), "decode(scalar) == decode(pair)")
    top = img[:2048]
    plain = torch_path.decode_quantize(
        torch_path.encode_quantize(torch.from_numpy(img).to(DEV), lut),
        lut, 3840, 4096).cpu().numpy()
    p_k, p_p = psnr(top, pix.cpu().numpy()), psnr(top, plain)
    log(f"  4K enc-quant round-trip PSNR at quality 50: kernel {p_k:.4f} dB "
        f"plain {p_p:.4f} dB delta {p_k - p_p:+.4f} dB; video batch "
        f"{tuple(vid.shape)}")
    require(abs(p_k - p_p) < 0.1, "round-trip PSNR within 0.1 dB of plain")
    require(15.0 < p_k < 99.0, f"enc-quant PSNR {p_k:.2f} dB is plausible")
    return counts


def check_stereo_identities(img, lut, tag):
    """Exact identities of one image's three forms, all strips included:
    planar == views(interleaved), native[..., :BW] == planar, native pad
    == 127, and the three decodes equal."""
    h, w = img.shape[-2:]
    s, bw = h // 16, w // 8
    ilv, pla, nat = (cuda_dct.encode_quantize_stereo(img, lut, view_layout=vl)
                     for vl in VIEW_LAYOUTS)
    require(torch.equal(pla, stereo_interleaved_to_views(ilv, s, bw)),
            f"{tag}: planar == stereo_interleaved_to_views(interleaved)")
    require(torch.equal(nat[..., :bw], pla), f"{tag}: native[..., :BW] == planar")
    require(bool((nat[..., bw:] == 127).all()), f"{tag}: native pad == 127")
    dec = [cuda_dct.decode_quantize_stereo(r, lut, w, h, vl)
           for r, vl in zip((ilv, pla, nat), VIEW_LAYOUTS)]
    require(torch.equal(dec[0], dec[1]) and torch.equal(dec[0], dec[2]),
            f"{tag}: decode(interleaved) == decode(planar) == decode(native)")
    log(f"  {tag}: planar == views(interleaved), native[..., :BW] == planar, "
        "pad == 127, three decodes equal: exact")


def phase_compare_stereo(gen, lut, errs):
    log("phase 8: stereo kernels against the plain version on the card")
    for h, w, frames in STEREO_GEOMETRIES:
        img = random_images(gen, h, w, frames)
        tag = f"{frames}x{h}x{w}"
        roundings = ROUNDINGS if h == 4096 else ("rne",)
        for vl in VIEW_LAYOUTS:
            for rounding in roundings:
                agree(f"enc_stereo {tag} {vl} {rounding}",
                      cuda_dct.encode_quantize_stereo(img, lut,
                                                      rounding=rounding,
                                                      view_layout=vl),
                      torch_path.encode_quantize_stereo(img, lut,
                                                        rounding=rounding,
                                                        view_layout=vl),
                      errs, "enc_stereo")
            rec = torch_path.encode_quantize_stereo(img, lut, view_layout=vl)
            agree(f"dec_stereo {tag} {vl} (same records)",
                  cuda_dct.decode_quantize_stereo(rec, lut, w, h, vl),
                  torch_path.decode_quantize_stereo(rec, lut, w, h, vl),
                  errs, "dec_stereo")
        if frames > 1 or h != 1088:
            check_stereo_identities(img, lut, tag)
    # [16, 16] keeps strip 1 only; [0, H - 32] drops the last strip
    for h, w in [(512, 3840), (256, 200)]:
        img = random_images(gen, h, w, 2)
        for sy, ey in [(16, 16), (64, 191), (0, h - 32)]:
            strips = torch_path._strip_mask(h // 16, sy, ey)
            for vl in VIEW_LAYOUTS:
                got = cuda_dct.encode_quantize_stereo(img, lut, sy, ey,
                                                      view_layout=vl)
                want = torch_path.encode_quantize_stereo(img, lut, sy, ey,
                                                         view_layout=vl)
                agree(f"enc_stereo 2x{h}x{w} {vl} range [{sy}, {ey}]", got,
                      want, errs, "enc_stereo")
                # the bytes the strip geometry leaves unwritten
                written = sd._strip_byte_mask(h, w, sy, ey, view_layout=vl)
                skipped = torch.from_numpy(np.ascontiguousarray(
                    ~np.broadcast_to(written, got.shape[1:]))).to(DEV)
                require(not got[:, skipped].any() and not want[:, skipped].any(),
                        "bytes outside the strip range are zero in kernel and "
                        "plain version")
                if vl == "native":
                    pad = got[..., w // 8:]
                    inc = torch.from_numpy(strips).to(DEV)
                    require(bool((pad[:, :, :, inc] == 127).all())
                            and not pad[:, :, :, ~inc].any(),
                            "native pad is 127 in included strips, 0 in "
                            "excluded ones")
        log(f"  2x{h}x{w}: unwritten bytes zero, native pad 127 / 0 by "
            "strip: exact")
    # spill: H % 16 == 8, the kernel sees the (2R, W) spill image
    img = random_images(gen, 1096, 1920, 1)
    spilled = sd._spill_stereo_image(img, 1920)
    require(spilled.shape == (1104, 1920), "spill image is (2R, W)")
    for vl in VIEW_LAYOUTS:
        got = cuda_dct.encode_quantize_stereo(spilled, lut, view_layout=vl)
        agree(f"enc_stereo spill 1096x1920 {vl}", got,
              torch_path.encode_quantize_stereo(spilled, lut, view_layout=vl),
              errs, "enc_stereo")
        require(torch.equal(sd.encode_quantize_stereo(img, lut, spill=True,
                                                      view_layout=vl), got),
                "api spill == kernel on the spill image")


def phase_main_path_stereo(gen, lut):
    log("phase 9: the stereo main path through the public api "
        "(numpy inputs, no device)")
    img = smooth_image(gen, 4096, 3840).cpu().numpy()
    video = random_images(gen, 1088, 1920, 64).cpu().numpy()
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    recs = {vl: sd.encode_quantize_stereo(img, lut, view_layout=vl)
            for vl in VIEW_LAYOUTS}
    pixs = {vl: sd.decode_quantize_stereo(recs[vl], lut, 3840, 4096,
                                          view_layout=vl)
            for vl in VIEW_LAYOUTS}
    vid_rec = sd.encode_quantize_stereo(video, lut, view_layout="native")
    vid = sd.decode_quantize_stereo(vid_rec, lut, 1920, 1088,
                                    view_layout="native")
    torch.cuda.synchronize()
    counts = dict(cuda_dct.LAUNCHES)
    log(f"  launches: {counts}")
    require(counts["enc_stereo"] == 4 and counts["dec_stereo"] == 4,
            "one launch per call, the 64-frame batch included")
    outs = [*recs.values(), *pixs.values(), vid_rec, vid]
    require(all(t.device.type == DEV for t in outs),
            "numpy inputs with no device run on the card")
    require(recs["interleaved"].shape == (4096 * 3840,)
            and recs["planar"].shape == (2, 64, 256, 480)
            and recs["native"].shape == (2, 64, 256, 512)
            and vid_rec.shape == (64, 2, 64, 68, 256), "record shapes")
    require(all(p.shape == (4096, 3840) for p in pixs.values())
            and vid.shape == (64, 1088, 1920), "image shapes")
    require(torch.equal(pixs["interleaved"], pixs["planar"])
            and torch.equal(pixs["interleaved"], pixs["native"]),
            "the three forms decode to the same pixels")
    plain = torch_path.decode_quantize_stereo(
        torch_path.encode_quantize_stereo(torch.from_numpy(img).to(DEV), lut),
        lut, 3840, 4096).cpu().numpy()
    p_k = psnr(img, pixs["interleaved"].cpu().numpy())
    p_p = psnr(img, plain)
    log(f"  4K dual-view stereo round-trip PSNR at quality 50: kernel "
        f"{p_k:.4f} dB plain {p_p:.4f} dB delta {p_k - p_p:+.4f} dB; video "
        f"batch {tuple(vid.shape)}")
    require(abs(p_k - p_p) < 0.1, "round-trip PSNR within 0.1 dB of plain")
    require(15.0 < p_k < 99.0, f"stereo PSNR {p_k:.2f} dB is plausible")
    return counts


def random_rgb(gen, h, w, frames):
    """(3, H, W) planar RGB, or a (frames, 3, H, W) batch, on the card."""
    shape = (3, h, w) if frames == 1 else (frames, 3, h, w)
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device=DEV)


def gate_rgb(h2: int = 1024, w: int = 3840) -> np.ndarray:
    """The config-3 PSNR gate's input (simd_dct_tpu/bench/harness.py:62-66,
    151-156): three correlated channels of one smooth field as the top
    view of a (3, 2*h2, w) dual view whose bottom view is zero."""
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[0:h2, 0:w]
    field = (128 + 45 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
             + 30 * (xx / max(w - 1, 1)) + rng.normal(0, 3, (h2, w)))
    base = np.clip(field, 0, 255).astype(np.uint8).astype(np.float32)
    top = np.clip(np.stack([base, base * 0.9 + 12, base * 0.8 + 25]), 0,
                  255).astype(np.uint8)
    return np.concatenate([top, np.zeros_like(top)], axis=1)


def phase_compare_color(gen, luma, chroma, errs):
    log("phase 11: YCbCr 4:4:4 colour kernels against the plain version on "
        "the card")
    for h, w, frames in GEOMETRIES:
        rgb = random_rgb(gen, h, w, frames)
        tag = f"{frames}x3x{h}x{w}"
        roundings = ROUNDINGS if h == 4096 else ("rne",)
        for rounding in roundings:
            agree(f"enc32_rgb {tag} {rounding}",
                  cuda_dct.encode_quantize32_ycbcr(rgb, luma, chroma,
                                                   rounding),
                  torch_path.encode_ycbcr32(rgb, luma, chroma, rounding),
                  errs, "enc32_rgb")
        rec = torch_path.encode_ycbcr32(rgb, luma, chroma)
        agree(f"dec32_rgb {tag} (same records)",
              cuda_dct.decode_quantize32_ycbcr(rec, luma, chroma, w, h),
              torch_path.decode_ycbcr32(rec, luma, chroma, w, h), errs,
              "dec32_rgb")
        fused = cuda_dct.roundtrip_quantize32_ycbcr(rgb, luma, chroma)
        composed = cuda_dct.decode_quantize32_ycbcr(
            cuda_dct.encode_quantize32_ycbcr(rgb, luma, chroma), luma, chroma,
            w, h)
        require(torch.equal(fused, composed),
                f"roundtrip32_rgb {tag}: fused == composed byte for byte")
        log(f"  roundtrip32_rgb {tag}: fused == composed byte for byte")
        agree(f"roundtrip32_rgb {tag}", fused,
              torch_path.roundtrip_ycbcr32(rgb, luma, chroma), errs,
              "roundtrip32_rgb")
    planes = gate_rgb()
    top = planes[:, : planes.shape[1] // 2]
    x = torch.from_numpy(planes).to(DEV)
    fused = cuda_dct.roundtrip_quantize32_ycbcr(x, luma, chroma).cpu().numpy()
    plain = torch_path.roundtrip_ycbcr32(x, luma, chroma).cpu().numpy()
    p_k, p_p = psnr(top, fused), psnr(top, plain)
    log(f"  config-3 gate input (3x1024x3840 top view), quality 100: psnr "
        f"kernel={p_k:.4f} dB plain={p_p:.4f} dB delta={p_k - p_p:+.4f} dB")
    require(abs(p_k - p_p) < 0.1, "colour round-trip PSNR within 0.1 dB of "
            "plain")
    require(30.0 < p_k < 99.0, f"colour PSNR {p_k:.2f} dB is plausible")


def phase_main_path_color(gen, luma, chroma):
    log("phase 12: the colour main path through the public api "
        "(numpy inputs, no device)")
    rgb = np.stack([smooth_image(gen, 4096, 3840).cpu().numpy()
                    for _ in range(3)])
    video = random_rgb(gen, 1088, 1920, 64).cpu().numpy()
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    rec = sd.encode_quantize32_ycbcr(rgb, luma, chroma)
    pix = sd.decode_quantize32_ycbcr(rec, luma, chroma, 3840, 4096)
    rt = sd.roundtrip_quantize32_ycbcr(rgb, luma, chroma)
    vid_rec = sd.encode_quantize32_ycbcr(video, luma, chroma)
    vid = sd.decode_quantize32_ycbcr(vid_rec, luma, chroma, 1920, 1088)
    vid_rt = sd.roundtrip_quantize32_ycbcr(video, luma, chroma)
    torch.cuda.synchronize()
    counts = dict(cuda_dct.LAUNCHES)
    log(f"  launches: {counts}")
    require(all(counts[k] == 2 for k in
                ("enc32_rgb", "dec32_rgb", "roundtrip32_rgb")),
            "one launch per call, the 64-frame batch included")
    require(all(t.device.type == DEV for t in
                (rec, pix, rt, vid_rec, vid, vid_rt)),
            "numpy inputs with no device run on the card")
    require(rec.shape == (3, 2048 * 3840)
            and vid_rec.shape == (64, 3, 544 * 1920), "record shapes")
    require(pix.shape == rt.shape == (3, 2048, 3840)
            and vid.shape == vid_rt.shape == (64, 3, 544, 1920),
            "image shapes")
    require(torch.equal(pix, rt) and torch.equal(vid, vid_rt),
            "api round trip == api decode(encode)")
    p = psnr(rgb[:, :2048], rt.cpu().numpy())
    log(f"  4K RGB round-trip PSNR at quality 100: {p:.4f} dB; video batch "
        f"{tuple(vid.shape)}")
    require(15.0 < p < 99.0, f"colour main-path PSNR {p:.2f} dB is plausible")
    return counts


def phase_compare_color420(gen, luma, chroma, errs):
    log("phase 13: YCbCr 4:2:0 colour kernels against the plain version on "
        "the card")
    for h, w, frames in GEOMETRIES_420:
        rgb = random_rgb(gen, h, w, frames)
        tag = f"{frames}x3x{h}x{w}"
        roundings = ROUNDINGS if h == 4096 else ("rne",)
        for rounding in roundings:
            stream = cuda_dct.encode_quantize32_ycbcr420(rgb, luma, chroma,
                                                         rounding)
            agree(f"enc420_rgb {tag} {rounding}", stream,
                  torch_path.encode_ycbcr420(rgb, luma, chroma, rounding),
                  errs, "enc420_rgb")
            y444 = cuda_dct.encode_quantize32_ycbcr(rgb, luma, chroma,
                                                    rounding)[..., 0, :]
            require(torch.equal(stream[..., : y444.shape[-1]], y444),
                    f"{tag} {rounding}: the 4:2:0 Y segment == enc32_rgb's "
                    "channel 0")
            log(f"  {tag} {rounding}: Y segment == enc32_rgb channel 0 byte "
                "for byte")
        rec = torch_path.encode_ycbcr420(rgb, luma, chroma)
        agree(f"dec420_rgb {tag} (same records)",
              cuda_dct.decode_quantize32_ycbcr420(rec, luma, chroma, w, h),
              torch_path.decode_ycbcr420(rec, luma, chroma, w, h), errs,
              "dec420_rgb")
    planes = gate_rgb()
    top = planes[:, : planes.shape[1] // 2]
    h, w = planes.shape[-2:]
    x = torch.from_numpy(planes).to(DEV)
    kern = cuda_dct.decode_quantize32_ycbcr420(
        cuda_dct.encode_quantize32_ycbcr420(x, luma, chroma), luma, chroma,
        w, h).cpu().numpy()
    plain = torch_path.decode_ycbcr420(
        torch_path.encode_ycbcr420(x, luma, chroma), luma, chroma, w,
        h).cpu().numpy()
    p_k, p_p = psnr(top, kern), psnr(top, plain)
    log(f"  config-3 gate input (3x1024x3840 top view), quality 100: 4:2:0 "
        f"round-trip psnr kernel={p_k:.4f} dB plain={p_p:.4f} dB "
        f"delta={p_k - p_p:+.4f} dB")
    require(abs(p_k - p_p) < 0.1, "4:2:0 round-trip PSNR within 0.1 dB of "
            "plain")
    require(30.0 < p_k < 99.0, f"4:2:0 PSNR {p_k:.2f} dB is plausible")


def phase_main_path_color420(gen, luma, chroma):
    log("phase 14: the 4:2:0 main path through the public api (numpy "
        "inputs, no device)")
    rgb = np.stack([smooth_image(gen, 4096, 3840).cpu().numpy()
                    for _ in range(3)])
    video = random_rgb(gen, 1088, 1920, 64).cpu().numpy()
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    rec = sd.encode_quantize32_ycbcr420(rgb, luma, chroma)
    pix = sd.decode_quantize32_ycbcr420(rec, luma, chroma, 3840, 4096)
    vid_rec = sd.encode_quantize32_ycbcr420(video, luma, chroma)
    vid = sd.decode_quantize32_ycbcr420(vid_rec, luma, chroma, 1920, 1088)
    torch.cuda.synchronize()
    counts = dict(cuda_dct.LAUNCHES)
    log(f"  launches: {counts}")
    require(counts["enc420_rgb"] == 2 and counts["dec420_rgb"] == 2,
            "one launch per call, the 64-frame batch included")
    require(all(t.device.type == DEV for t in (rec, pix, vid_rec, vid)),
            "numpy inputs with no device run on the card")
    require(rec.shape == (2048 * 3840 * 3 // 2,)
            and vid_rec.shape == (64, 544 * 1920 * 3 // 2), "stream shapes")
    require(pix.shape == (3, 2048, 3840) and vid.shape == (64, 3, 544, 1920),
            "image shapes")
    p = psnr(rgb[:, :2048], pix.cpu().numpy())
    log(f"  4K RGB 4:2:0 round-trip PSNR at quality 100: {p:.4f} dB; video "
        f"batch {tuple(vid.shape)}")
    require(15.0 < p < 99.0, f"4:2:0 main-path PSNR {p:.2f} dB is plausible")
    return counts


# -- the panel engine's tiles -------------------------------------------------

# (name, normalize, orientation, LUT key): the three configurations of the
# modes, mode32's raw domain and the 1/255 domain of enc-quant and stereo
TILE_CONFIGS = [("mode32", False, "fy", "raw"), ("enc-quant", True, "fx", "q"),
                ("stereo", True, "fy", "q")]


def tile_scales(lut):
    """(quant, dequant) scales of a LUT as the tile wrappers take them: host
    f32 arrays (scales on the card would cost a synchronisation a call)."""
    from simd_dct_tpu_torch.core.quantize import dequant_scales, quant_scales
    return quant_scales(lut).numpy(), dequant_scales(lut).numpy()


def count_identity(name: str, got, want, mismatches: dict) -> None:
    """An identity that is expected exact: log its mismatch count and hold
    it to the +-1 on at most 0.2% contract."""
    n = int((got != want).sum())
    mismatches[name] = mismatches.get(name, 0) + n
    rep = compare_backends({"tiles": got, "kernel": want})["tiles-vs-kernel"]
    log(f"  identity {name}: mismatches={n} of {got.numel()} "
        f"max_abs_diff={rep['max_abs_diff']}")
    require(rep["ok"], f"{name} within +-1 on at most 0.2% of bytes")


def phase_compare_tiles(gen, luts, errs):
    log("phase 15: tile kernels against the plain version on the card, and "
        "the identities with the mode kernels")
    mismatches: dict[str, int] = {}
    for h2, w, frames in TILE_GEOMETRIES:
        img = random_images(gen, 2 * h2, w, frames)    # dual view
        top = img[..., :h2, :].contiguous()
        tag = f"{frames}x{h2}x{w}"
        for name, normalize, orientation, key in TILE_CONFIGS:
            q, qi = tile_scales(luts[key])
            view = img.view(*img.shape[:-2], 2, h2, w) \
                if name == "stereo" else top
            for rounding in ROUNDINGS:
                tiles = cuda_dct.tiles_panels(
                    view, q, normalize=normalize, rounding=rounding,
                    orientation=orientation)
                agree(f"tiles {tag} {name} {rounding}", tiles,
                      panel.forward_tiles(view, q, normalize=normalize,
                                          orientation=orientation,
                                          rounding=rounding), errs, "tiles")
                if name == "mode32":
                    rec = cuda_dct.encode_quantize32(img, luts[key],
                                                     rounding=rounding)
                    count_identity(f"{tag} {rounding} tiles_to_group8 == "
                                   "enc32", panel.tiles_to_group8(tiles),
                                   rec, mismatches)
                elif name == "enc-quant":
                    for layout, conv in (
                            ("scalar", panel.tiles_to_block_contiguous),
                            ("pair", panel.tiles_to_pair)):
                        rec = cuda_dct.encode_quantize(
                            img, luts[key], rounding=rounding, layout=layout)
                        count_identity(f"{tag} {rounding} {conv.__name__} "
                                       f"== encq {layout}", conv(tiles), rec,
                                       mismatches)
                else:
                    rec = cuda_dct.encode_quantize_stereo(img, luts[key],
                                                          rounding=rounding)
                    count_identity(f"{tag} {rounding} tiles_to_planar == "
                                   "enc_stereo interleaved",
                                   panel.tiles_to_planar(tiles), rec,
                                   mismatches)
            agree(f"detile {tag} {name} (same tiles)",
                  cuda_dct.detile_panels(tiles, qi, normalize=normalize,
                                         orientation=orientation),
                  panel.inverse_tiles(tiles, qi, normalize=normalize,
                                      orientation=orientation), errs,
                  "detile")
        # the detile of each mode's records, converted, == its decode
        q32 = luts["raw"]
        rec = cuda_dct.encode_quantize32(img, q32)
        _, qi = tile_scales(q32)
        count_identity(f"{tag} detile(group8_to_tiles) == dec32",
                       cuda_dct.detile_panels(
                           panel.group8_to_tiles(rec, h2, w), qi,
                           normalize=False, orientation="fy"),
                       cuda_dct.decode_quantize32(rec, q32, w, 2 * h2),
                       mismatches)
        _, qi = tile_scales(luts["q"])
        for layout, back in (("scalar", panel.block_contiguous_to_tiles),
                             ("pair", panel.pair_to_tiles)):
            rec = cuda_dct.encode_quantize(img, luts["q"], layout=layout)
            count_identity(f"{tag} detile({back.__name__}) == decq {layout}",
                           cuda_dct.detile_panels(
                               back(rec, h2, w), qi, normalize=True,
                               orientation="fx"),
                           cuda_dct.decode_quantize(rec, luts["q"], w, 2 * h2,
                                                    layout), mismatches)
        rec = cuda_dct.encode_quantize_stereo(img, luts["q"])
        views = cuda_dct.detile_panels(panel.planar_to_tiles(rec, h2, w), qi,
                                       normalize=True, orientation="fy")
        count_identity(f"{tag} detile(planar_to_tiles) == dec_stereo",
                       views.reshape(img.shape),
                       cuda_dct.decode_quantize_stereo(rec, luts["q"], w,
                                                       2 * h2), mismatches)
    nonzero = {k: n for k, n in mismatches.items() if n}
    log(f"  identities: {len(mismatches)}, mismatches in all: "
        f"{sum(mismatches.values())}; nonzero: {json.dumps(nonzero)}")
    return mismatches


def phase_main_path_tiles(gen, luts):
    log("phase 16: the tile main path (the hybrid route: tile kernel, then "
        "a converter into each mode's records, and back)")
    img = smooth_image(gen, 4096, 3840)
    top = img[:2048].contiguous()
    views = img.view(2, 2048, 3840)
    video = random_images(gen, 1024, 1920, 64)
    q32, qi32 = tile_scales(luts["raw"])
    qq, qiq = tile_scales(luts["q"])
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    t32 = cuda_dct.tiles_panels(top, q32, normalize=False, rounding="rne",
                                orientation="fy")
    rec32 = panel.tiles_to_group8(t32)
    pix32 = cuda_dct.detile_panels(panel.group8_to_tiles(rec32, 2048, 3840),
                                   qi32, normalize=False, orientation="fy")
    tq = cuda_dct.tiles_panels(top, qq, normalize=True, rounding="rne",
                               orientation="fx")
    recq = {"scalar": panel.tiles_to_block_contiguous(tq),
            "pair": panel.tiles_to_pair(tq)}
    pixq = {"scalar": cuda_dct.detile_panels(
                panel.block_contiguous_to_tiles(recq["scalar"], 2048, 3840),
                qiq, normalize=True, orientation="fx"),
            "pair": cuda_dct.detile_panels(
                panel.pair_to_tiles(recq["pair"], 2048, 3840), qiq,
                normalize=True, orientation="fx")}
    ts = cuda_dct.tiles_panels(views, qq, normalize=True, rounding="rne",
                               orientation="fy")
    rec_st = panel.tiles_to_planar(ts)
    pix_st = cuda_dct.detile_panels(panel.planar_to_tiles(rec_st, 2048, 3840),
                                    qiq, normalize=True, orientation="fy")
    tv = cuda_dct.tiles_panels(video, q32, normalize=False, rounding="rne",
                               orientation="fy")
    vid_rec = panel.tiles_to_group8(tv)
    vid = cuda_dct.detile_panels(panel.group8_to_tiles(vid_rec, 1024, 1920),
                                 qi32, normalize=False, orientation="fy")
    torch.cuda.synchronize()
    counts = dict(cuda_dct.LAUNCHES)
    log(f"  launches: {counts}")
    require(counts["tiles"] == 4 and counts["detile"] == 5,
            "4 tile and 5 detile launches, the 64-frame batch one each way")
    outs = [t32, rec32, pix32, tq, *recq.values(), *pixq.values(), ts,
            rec_st, pix_st, tv, vid_rec, vid]
    require(all(t.device.type == DEV for t in outs), "results on the card")
    require(rec32.shape == (2048 * 3840,) and rec_st.shape == (4096 * 3840,)
            and vid_rec.shape == (64, 1024 * 1920), "record shapes")
    require(pix32.shape == (2048, 3840) and pix_st.shape == (2, 2048, 3840)
            and vid.shape == (64, 1024, 1920), "image shapes")
    # the hybrid route's records are the mode kernels' (checked after the
    # counts were read: these launches are not the tile path's)
    require(torch.equal(rec32, cuda_dct.encode_quantize32(img, luts["raw"]))
            and torch.equal(recq["scalar"],
                            cuda_dct.encode_quantize(img, luts["q"]))
            and torch.equal(recq["pair"], cuda_dct.encode_quantize(
                img, luts["q"], layout="pair"))
            and torch.equal(rec_st, cuda_dct.encode_quantize_stereo(
                img, luts["q"])), "hybrid records == the mode kernels'")
    p32 = psnr(img[:2048].cpu().numpy(), pix32.cpu().numpy())
    pst = psnr(img.cpu().numpy(), pix_st.reshape(4096, 3840).cpu().numpy())
    log(f"  hybrid 4K round-trip PSNR: mode32 {p32:.4f} dB, stereo "
        f"{pst:.4f} dB; video batch {tuple(vid.shape)}")
    require(15.0 < min(p32, pst) and max(p32, pst) < 99.0,
            "hybrid PSNR is plausible")
    return counts


# -- the compat tier on the card ---------------------------------------------

def cuda_kernels_of(fn) -> int | None:
    """CUDA activities (kernels and copies) torch.profiler records during
    one call; None when it records none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    return n or None


def compat_equal(name: str, call, args, kw, fast=None) -> torch.Tensor:
    """call(*args, compat=True) on the card == the same call on CPU
    tensors, byte for byte; and within +-1 on at most 0.2% of ``fast``."""
    got = call(*args, compat=True, **kw)
    cpu_args = [a.cpu() if isinstance(a, torch.Tensor) else a for a in args]
    want = call(*cpu_args, compat=True, **kw)
    require(got.device.type == DEV, f"compat {name} runs on the card")
    n = int((got.cpu() != want).sum())
    msg = f"  compat {name}: card vs cpu mismatches={n}"
    require(n == 0, f"compat {name}: the card's bytes == the CPU's")
    if fast is not None:
        rep = compare_backends({"compat": got, "fast": fast})["compat-vs-fast"]
        msg += (f"; against the fast kernel max_abs_diff="
                f"{rep['max_abs_diff']} mismatch_rate="
                f"{rep['mismatch_rate']:.3e}")
        require(rep["ok"], f"compat {name} within +-1 of the fast kernel")
    log(msg)
    return got


def phase_compat(gen, lut, lut_q):
    log("phase 17: the compat tier on the card (strict IEEE, eager ops)")
    img = random_images(gen, 4096, 3840, 1)
    stats = {}
    encodes = {
        "encode_quantize32": (sd.encode_quantize32, lut),
        "encode_quantize": (sd.encode_quantize, lut_q),
        "encode_quantize_stereo": (sd.encode_quantize_stereo, lut_q)}
    decodes = {"encode_quantize32": sd.decode_quantize32,
               "encode_quantize": sd.decode_quantize,
               "encode_quantize_stereo": sd.decode_quantize_stereo}
    for name, (enc, l) in encodes.items():
        rec = compat_equal(f"{name} 4096x3840", enc, (img, l), {},
                           fast=enc(img, l))
        dec = decodes[name]
        compat_equal(f"{dec.__name__} 4096x3840", dec, (rec, l, 3840, 4096),
                     {}, fast=dec(rec, l, 3840, 4096))
        for label, fn in ((name, lambda: enc(img, l, compat=True)),
                          (dec.__name__,
                           lambda: dec(rec, l, 3840, 4096, compat=True))):
            fn()
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
            n = cuda_kernels_of(fn)
            wall = statistics.median(walls)
            stats[label] = {"wall_ms": wall, "cuda_kernels": n}
            log(f"  compat {label} 4096x3840: wall {wall:.3f} ms (median of "
                f"5), {n} CUDA kernels (profiler)")
    small = random_images(gen, 256, 384, 2)
    for rounding in ROUNDINGS:
        for layout in LAYOUTS:
            for sy, ey, legacy in [(0, None, False), (16, 100, False),
                                   (0, 60, True)]:
                kw = dict(rounding=rounding, layout=layout,
                          legacy_range=legacy)
                compat_equal(f"encode_quantize 2x256x384 {rounding} {layout} "
                             f"[{sy}, {ey}] legacy={legacy}",
                             sd.encode_quantize, (small, lut_q, sy, ey), kw,
                             fast=sd.encode_quantize(small, lut_q, sy, ey,
                                                     **kw))
        for sy, ey in [(0, None), (16, 100)]:
            kw = dict(rounding=rounding)
            compat_equal(f"encode_quantize32 2x256x384 {rounding} "
                         f"[{sy}, {ey}]", sd.encode_quantize32,
                         (small, lut, sy, ey), kw,
                         fast=sd.encode_quantize32(small, lut, sy, ey, **kw))
            for vl in VIEW_LAYOUTS:
                kw = dict(rounding=rounding, view_layout=vl)
                compat_equal(f"encode_quantize_stereo 2x256x384 {rounding} "
                             f"{vl} [{sy}, {ey}]", sd.encode_quantize_stereo,
                             (small, lut_q, sy, ey), kw,
                             fast=sd.encode_quantize_stereo(small, lut_q, sy,
                                                            ey, **kw))
    for layout in ("scalar", "pair"):
        rec = sd.encode_quantize(small, lut_q, layout=layout)
        compat_equal(f"decode_quantize 2x256x384 {layout}",
                     sd.decode_quantize, (rec, lut_q, 384, 256),
                     dict(layout=layout),
                     fast=sd.decode_quantize(rec, lut_q, 384, 256,
                                             layout=layout))
    rec = sd.encode_quantize32(small, lut)
    compat_equal("decode_quantize32 2x256x384", sd.decode_quantize32,
                 (rec, lut, 384, 256), {},
                 fast=sd.decode_quantize32(rec, lut, 384, 256))
    for vl in VIEW_LAYOUTS:
        rec = sd.encode_quantize_stereo(small, lut_q, view_layout=vl)
        compat_equal(f"decode_quantize_stereo 2x256x384 {vl}",
                     sd.decode_quantize_stereo, (rec, lut_q, 384, 256),
                     dict(view_layout=vl),
                     fast=sd.decode_quantize_stereo(rec, lut_q, 384, 256,
                                                    view_layout=vl))
    return stats


# -- a batch longer than one launch takes -------------------------------------

def phase_large_batch(gen, lut, lut_q):
    log("phase 18: 65,536 frames of 16x64 (one more than a launch takes)")
    frames = 65536
    img = random_images(gen, 16, 64, frames)
    half = frames // 2
    calls = {
        "enc32": lambda x: sd.encode_quantize32(x, lut),
        "encq": lambda x: sd.encode_quantize(x, lut_q),
        "enc_stereo": lambda x: sd.encode_quantize_stereo(x, lut_q),
    }
    recs = {}
    for name, call in calls.items():
        torch.cuda.synchronize()
        cuda_dct.reset_launch_counts()
        whole = call(img)
        torch.cuda.synchronize()
        n = cuda_dct.LAUNCHES[name]
        parts = torch.cat([call(img[:half]), call(img[half:])])
        require(n == 2, f"{name}: 65,536 frames take 2 launches, got {n}")
        require(torch.equal(whole, parts), f"{name}: the batch == its halves")
        log(f"  {name}: {tuple(whole.shape)} in {n} launches, equal to the "
            "two halves run apart")
        recs[name] = whole
    rec = recs["enc32"]
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    whole = sd.decode_quantize32(rec, lut, 64, 16)
    torch.cuda.synchronize()
    n = cuda_dct.LAUNCHES["dec32"]
    parts = torch.cat([sd.decode_quantize32(rec[:half], lut, 64, 16),
                       sd.decode_quantize32(rec[half:], lut, 64, 16)])
    require(n == 2 and torch.equal(whole, parts),
            "dec32: 65,536 frames in 2 launches == the two halves")
    log(f"  dec32: {tuple(whole.shape)} in {n} launches, equal to the two "
        "halves run apart")


def copy_pair(p):
    """Device-to-device copy of p[0] into p[1]: the same-run speed limit."""
    return p[1].copy_(p[0])


def _events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def sleep_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    torch.cuda._sleep(1000)
    start, end = _events()
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 1e7 / start.elapsed_time(end)


def wall_ms(fn, inputs, reps):
    """Median ms per call of back-to-back calls between two CUDA events:
    the pace a caller sees, host launch cost included."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    start, end = _events()
    per_call = []
    for _ in range(reps):
        start.record()
        for x in inputs:
            fn(x)
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / len(inputs))
    return statistics.median(per_call)


def queued_ms(fn, inputs, reps, cycles_per_ms):
    """Median device ms per call by CUDA events, with the host's launch cost
    hidden: each repetition queues the whole rotation behind a device-side
    sleep, so the kernels run back to back.  A repetition counts only if
    the host finished queueing before the device reached the first launch;
    otherwise the sleep doubles.  fn must not synchronise."""
    for x in inputs[:2]:
        fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in inputs:
        fn(x)
    sleep_ms = 2e3 * (time.perf_counter() - t0) + 0.5
    torch.cuda.synchronize()
    start, end = _events()
    per_call = []
    while len(per_call) < reps:
        require(sleep_ms < 1000, "the host queues a rotation within 1 s")
        torch.cuda._sleep(int(sleep_ms * cycles_per_ms))
        start.record()
        for x in inputs:
            fn(x)
        end.record()
        hidden = not start.query()
        end.synchronize()
        if hidden:
            per_call.append(start.elapsed_time(end) / len(inputs))
        else:
            sleep_ms *= 2
    return statistics.median(per_call)


def profiled_us(fn, inputs, tries=3):
    """Device time per call (us) from torch.profiler: for each GPU activity
    it records, its mean time times its launches per call (robust to
    dropped records).  (None, []) when ``tries`` profiles in a row record
    no device activity.  Also the names of the kernels it ran."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        for x in inputs[:2]:
            fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for x in inputs:
                fn(x)
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.count > 0 and e.self_device_time_total > 0]
        if evts:
            us = sum(e.self_device_time_total / e.count
                     * max(1, round(e.count / len(inputs))) for e in evts)
            return us, sorted({e.key[:60] for e in evts})
    return None, []


def phase_timing(gen, lut, lut_q, chroma, reps):
    log("phase 10: timing, median of "
        f"{reps} repetitions over rotations larger than L2.  kernel and "
        "copy: CUDA events with the rotation queued behind a device sleep; "
        "plain: torch.profiler device time (it synchronises on its scale "
        "uploads, so it cannot be queued); wall: back-to-back calls")
    cycles_per_ms = sleep_cycles_per_ms()
    rows, table = {}, []
    # mode32, enc-quant and colour encode the top 2048x3840 view, stereo
    # both views
    cases = [("4096x3840 image", 4096, 3840, 1, 16),
             ("8x1088x1920 batch", 1088, 1920, 8, 6)]
    for label, h, w, frames, n_rot in cases:
        imgs = [random_images(gen, h, w, frames) for _ in range(n_rot)]
        recs = [torch_path.encode_quantize32(x, lut) for x in imgs]
        recs_q = [torch_path.encode_quantize(x, lut_q) for x in imgs]
        recs_p = [torch_path.encode_quantize(x, lut_q, layout="pair")
                  for x in imgs]
        recs_s = [torch_path.encode_quantize_stereo(x, lut_q) for x in imgs]
        recs_n = [torch_path.encode_quantize_stereo(x, lut_q,
                                                    view_layout="native")
                  for x in imgs]
        recs_sp = [torch_path.encode_quantize_stereo(x, lut_q,
                                                     view_layout="planar")
                   for x in imgs]
        # (3, H, W) planar RGB: three times the bytes, half the rotation
        rgbs = [random_rgb(gen, h, w, frames) for _ in range(n_rot // 2)]
        recs_c = [torch_path.encode_ycbcr32(x, lut, chroma) for x in rgbs]
        recs_420 = [torch_path.encode_ycbcr420(x, lut, chroma) for x in rgbs]
        # tiles: the top 2048x3840 view of each 4K image; the batch case
        # takes 8 views of 1024x1920 (544 rows are no whole tiles)
        tviews = ([x[: h // 2].contiguous() for x in imgs] if frames == 1
                  else [random_images(gen, 1024, w, frames)
                        for _ in range(n_rot)])
        tq, tqi = tile_scales(lut)
        tiles = [panel.forward_tiles(v, tq, normalize=False,
                                     orientation="fy", rounding="rne")
                 for v in tviews]
        # one view's bytes (mode32, enc-quant), the whole dual view's
        # (stereo encodes both) and the three channels' top view (colour)
        copies = {}
        srcs_of = [("view", recs), ("dual", imgs), ("colour", recs_c)]
        if frames > 1:
            srcs_of.append(("tile", tviews))
        for key, srcs in srcs_of:
            pairs = [(r, torch.empty_like(r)) for r in srcs]
            c_us = queued_ms(copy_pair, pairs, reps, cycles_per_ms) * 1e3
            c_prof, _ = profiled_us(copy_pair, pairs)
            copies[key] = c_us
            log(f"  copy {label} ({key}, {srcs[0].numel()} bytes): "
                f"{c_us:.3f} us (profiler {c_prof})")
        view_px, dual_px = frames * (h // 2) * w, frames * h * w
        native_bytes = dual_px + recs_n[0].numel()
        # name -> (kernel, plain version, inputs, bytes moved, pixels, copy)
        view = (2 * view_px, view_px, copies["view"])
        dual = (2 * dual_px, dual_px, copies["dual"])
        native = (native_bytes, dual_px, copies["dual"])
        colour = (6 * view_px, view_px, copies["colour"])
        # 4:2:0: 3 bytes in and 1.5 out per pixel position
        c420 = (9 * view_px // 2, view_px, copies["colour"])
        tile_px = tviews[0].numel()
        tile_label = ("2048x3840 top view" if frames == 1
                      else f"{frames}x1024x{w} views")
        tile = (2 * tile_px, tile_px, copies.get("tile", copies["view"]))
        jobs = {
            "enc32": (lambda x: cuda_dct.encode_quantize32(x, lut),
                      lambda x: torch_path.encode_quantize32(x, lut), imgs,
                      *view),
            "dec32": (lambda r: cuda_dct.decode_quantize32(r, lut, w, h),
                      lambda r: torch_path.decode_quantize32(r, lut, w, h),
                      recs, *view),
            "roundtrip32": (lambda x: cuda_dct.roundtrip_quantize32(x, lut),
                            lambda x: torch_path.roundtrip_quantize32(x, lut),
                            imgs, *view),
            "encq": (lambda x: cuda_dct.encode_quantize(x, lut_q),
                     lambda x: torch_path.encode_quantize(x, lut_q), imgs,
                     *view),
            "encq_pair": (
                lambda x: cuda_dct.encode_quantize(x, lut_q, layout="pair"),
                lambda x: torch_path.encode_quantize(x, lut_q,
                                                     layout="pair"), imgs,
                *view),
            "encq_as_written": (
                lambda x: cuda_dct.encode_quantize(x, lut_q,
                                                   layout="pair_as_written"),
                lambda x: torch_path.encode_quantize(
                    x, lut_q, layout="pair_as_written"), imgs, *view),
            "decq": (lambda r: cuda_dct.decode_quantize(r, lut_q, w, h),
                     lambda r: torch_path.decode_quantize(r, lut_q, w, h),
                     recs_q, *view),
            "decq_pair": (
                lambda r: cuda_dct.decode_quantize(r, lut_q, w, h, "pair"),
                lambda r: torch_path.decode_quantize(r, lut_q, w, h, "pair"),
                recs_p, *view),
            "enc_stereo": (
                lambda x: cuda_dct.encode_quantize_stereo(x, lut_q),
                lambda x: torch_path.encode_quantize_stereo(x, lut_q), imgs,
                *dual),
            "enc_stereo_planar": (
                lambda x: cuda_dct.encode_quantize_stereo(
                    x, lut_q, view_layout="planar"),
                lambda x: torch_path.encode_quantize_stereo(
                    x, lut_q, view_layout="planar"), imgs, *dual),
            "enc_stereo_native": (
                lambda x: cuda_dct.encode_quantize_stereo(
                    x, lut_q, view_layout="native"),
                lambda x: torch_path.encode_quantize_stereo(
                    x, lut_q, view_layout="native"), imgs, *native),
            "dec_stereo": (
                lambda r: cuda_dct.decode_quantize_stereo(r, lut_q, w, h),
                lambda r: torch_path.decode_quantize_stereo(r, lut_q, w, h),
                recs_s, *dual),
            "dec_stereo_planar": (
                lambda r: cuda_dct.decode_quantize_stereo(r, lut_q, w, h,
                                                          "planar"),
                lambda r: torch_path.decode_quantize_stereo(r, lut_q, w, h,
                                                            "planar"),
                recs_sp, *dual),
            "dec_stereo_native": (
                lambda r: cuda_dct.decode_quantize_stereo(r, lut_q, w, h,
                                                          "native"),
                lambda r: torch_path.decode_quantize_stereo(r, lut_q, w, h,
                                                            "native"),
                recs_n, *native),
            "enc32_rgb": (
                lambda x: cuda_dct.encode_quantize32_ycbcr(x, lut, chroma),
                lambda x: torch_path.encode_ycbcr32(x, lut, chroma), rgbs,
                *colour),
            "dec32_rgb": (
                lambda r: cuda_dct.decode_quantize32_ycbcr(r, lut, chroma, w,
                                                           h),
                lambda r: torch_path.decode_ycbcr32(r, lut, chroma, w, h),
                recs_c, *colour),
            "roundtrip32_rgb": (
                lambda x: cuda_dct.roundtrip_quantize32_ycbcr(x, lut, chroma),
                lambda x: torch_path.roundtrip_ycbcr32(x, lut, chroma), rgbs,
                *colour),
            "enc420_rgb": (
                lambda x: cuda_dct.encode_quantize32_ycbcr420(x, lut, chroma),
                lambda x: torch_path.encode_ycbcr420(x, lut, chroma), rgbs,
                *c420),
            "dec420_rgb": (
                lambda r: cuda_dct.decode_quantize32_ycbcr420(r, lut, chroma,
                                                              w, h),
                lambda r: torch_path.decode_ycbcr420(r, lut, chroma, w, h),
                recs_420, *c420),
            "tiles": (
                lambda v: cuda_dct.tiles_panels(v, tq, normalize=False,
                                                rounding="rne",
                                                orientation="fy"),
                lambda v: panel.forward_tiles(v, tq, normalize=False,
                                              orientation="fy",
                                              rounding="rne"), tviews,
                *tile),
            "detile": (
                lambda t: cuda_dct.detile_panels(t, tqi, normalize=False,
                                                 orientation="fy"),
                lambda t: panel.inverse_tiles(t, tqi, normalize=False,
                                              orientation="fy"), tiles,
                *tile),
        }
        for name, (kern, plain, inputs, n_bytes, n_px, c_us) in jobs.items():
            k_us = queued_ms(kern, inputs, reps, cycles_per_ms) * 1e3
            k_prof, k_names = profiled_us(kern, inputs)
            k_wall = wall_ms(kern, inputs, reps) * 1e3
            p_prof, p_names = profiled_us(plain, inputs)
            p_wall = wall_ms(plain, inputs, reps) * 1e3
            p_us = p_prof if p_prof is not None else p_wall
            # the kernel a job times: the longest KERNELS name it starts with
            kernel = max((k for k in KERNELS if name.startswith(k)), key=len)
            bound, _ = bound_ms(kernel, n_bytes, n_px)
            table.append({
                "kernel": name, "kernel_us": k_us,
                "shape": tile_label if name in ("tiles", "detile") else label,
                "kernel_profiler_us": k_prof, "kernel_wall_us": k_wall,
                "plain_us": p_us, "plain_estimator":
                    "profiler" if p_prof is not None else "wall",
                "plain_wall_us": p_wall, "copy_us": c_us,
                "bytes": n_bytes, "bound_us": bound * 1e3,
                "kernel_gbps": n_bytes / (k_us * 1e3),
                "frac_of_copy": c_us / k_us, "frac_of_bound": bound * 1e3 / k_us,
                "kernel_us_per_frame": k_us / frames, "frames": frames,
                "kernel_names": k_names, "plain_kernels": len(p_names)})
            if frames == 1:
                rows[name] = (k_us / 1e3, p_us / 1e3, c_us / 1e3, n_bytes,
                              n_px)
            log(f"  {name:17s} {table[-1]['shape']:18s} kernel {k_us:8.3f} us "
                f"(profiler {k_prof if k_prof is None else round(k_prof, 3)}"
                f", wall {k_wall:7.2f})  plain {p_us:9.2f} us "
                f"(wall {p_wall:8.2f})  copy {c_us:6.3f} us  "
                f"{n_bytes / (k_us * 1e3):7.1f} GB/s  "
                f"{c_us / k_us:.3f} of copy  {bound * 1e3 / k_us:.3f} of bound"
                f"  {k_us / frames:7.3f} us/frame")
    xs = [random_images(gen, 8, 128, 1) for _ in range(16)]
    k_us = queued_ms(cuda_dct.probe_trial, xs, reps, cycles_per_ms) * 1e3
    p_prof, _ = profiled_us(torch_path.probe_trial, xs)
    p_us = p_prof if p_prof is not None else \
        wall_ms(torch_path.probe_trial, xs, reps) * 1e3
    rows["probe"] = (k_us / 1e3, p_us / 1e3, None, 2 * 8 * 128, 8 * 128)
    log(f"  probe (8,128): kernel {k_us:.3f} us  plain {p_us:.3f} us")
    log("timing_table " + json.dumps(table))
    return rows


def bound_ms(name: str, n_bytes: int, n_px: int) -> tuple[float, str]:
    """Least time for the work of one call: each input byte read once and
    each output byte written once (``n_bytes``) over HBM's rate, or the
    transforms' f32 FMAs on ``n_px`` pixels over the CUDA cores' rate,
    whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = FMA_PER_PX[name] * n_px / PEAK_FMA_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def kernel_rows(launches, errs, times):
    """One entry per kernel: the 4K-view times of this run (the scalar
    layout for encq / decq and the interleaved form for the stereo
    kernels, the other layouts beside it), the bound, the share of a
    same-run copy, and the launches of its main path's run (``launches``:
    main path -> counts)."""
    rows = []
    for name, (source, replaces, path) in KERNELS.items():
        ms, plain, copy, n_bytes, n_px = times[name]
        bound, bound_by = bound_ms(name, n_bytes, n_px)
        row = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[path][name],
               "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
               "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
               "us": ms * 1e3, "gbps": n_bytes / (ms * 1e6),
               "frac_of_copy": None if copy is None else copy / ms,
               "frac_of_bound": bound / ms}
        for layout in ("pair", "as_written", "planar", "native"):
            if f"{name}_{layout}" in times:
                ms_l, plain_l, _, bytes_l, px_l = times[f"{name}_{layout}"]
                row[f"ms_{layout}"] = ms_l
                row[f"plain_ms_{layout}"] = plain_l
                row[f"bound_ms_{layout}"] = bound_ms(name, bytes_l, px_l)[0]
        rows.append(row)
    return rows


def log_ptxas(lines) -> None:
    """Registers, stack and spills per kernel instantiation from the
    ``ptxas -v`` lines of the build log, e.g. ``encq_kernel<1,2>``."""
    name = "?"
    for line in lines:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(enc420_rgb|dec420_rgb|enc32_rgb|dec32_rgb"
                          r"|roundtrip32_rgb|enc32|dec32"
                          r"|roundtrip32|probe|encq|decq|enc_stereo"
                          r"|dec_stereo|tiles|detile)_kernel"
                          r"(?:I((?:L[ib]\d+E)+)E)?", m.group(1))
            name = f"{k.group(1)}_kernel" if k else m.group(1)
            if k and k.group(2):
                name += "<" + ",".join(re.findall(r"\d+", k.group(2))) + ">"
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1

    log("phase 1: the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip())
    kind = torch.cuda.get_device_name(0)
    log(f"torch device: {kind}  count={torch.cuda.device_count()}  "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    log("phase 2: build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    log(f"  built {lib_path} in {time.perf_counter() - t0:.2f} s")
    with open(os.path.join(os.path.dirname(lib_path), "build.log")) as f:
        log_ptxas(f)
    log("  probe: " + capability.probe().banner)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device=DEV).manual_seed(args.seed)
    lut = default_quant_lut(50) * np.float32(255.0)
    errs: dict[str, int] = {}
    phase_compare(gen, lut, errs)
    # quality 100 is the BASELINE ladder's LUT; at 50 the DC term clips
    lut100 = default_quant_lut(100) * np.float32(255.0)
    phase_psnr(gen, lut100)
    counts = phase_main_path(gen, lut100)
    # enc-quant works in the 1/255 domain: the LUT is 255x cooler
    lut_q = default_quant_lut(50)
    phase_compare_encq(gen, lut_q, errs)
    counts_q = phase_main_path_encq(gen, lut_q)
    phase_compare_stereo(gen, lut_q, errs)
    counts_s = phase_main_path_stereo(gen, lut_q)
    # colour: the mode32 raw domain, the JPEG chroma table at quality 100
    chroma100 = BASE_CHROMA_QUANT_TABLE * np.float32(100 * 255)
    phase_compare_color(gen, lut100, chroma100, errs)
    counts_c = phase_main_path_color(gen, lut100, chroma100)
    phase_compare_color420(gen, lut100, chroma100, errs)
    counts_420 = phase_main_path_color420(gen, lut100, chroma100)
    luts = {"raw": lut100, "q": lut_q}
    identities = phase_compare_tiles(gen, luts, errs)
    counts_t = phase_main_path_tiles(gen, luts)
    compat_stats = phase_compat(gen, lut100, lut_q)
    phase_large_batch(gen, lut100, lut_q)
    times = phase_timing(gen, lut100, lut_q, chroma100, REPS)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    launches = {"mode32": counts, "enc-quant": counts_q, "stereo": counts_s,
                "colour": counts_c, "colour 4:2:0": counts_420,
                "tiles": counts_t}
    log("compat " + json.dumps(compat_stats))
    rows = kernel_rows(launches, errs, times)
    for row in rows:
        if row["name"] in ("tiles", "detile"):
            row["identity_mismatches"] = sum(
                n for k, n in identities.items()
                if ("detile(" in k) == (row["name"] == "detile"))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
