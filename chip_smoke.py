#!/usr/bin/env python3
"""Bring-up check of ``simd_dct_tpu_torch`` on one NVIDIA GPU.

Run from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py [--seed N]

Phases (any failure raises, and the script exits non-zero without the
result line):
  1. the card: nvidia-smi name and power limit, torch's device name;
  2. build the kernels from csrc/ with nvcc (one process per source, all
     started together), print build time and ptxas register use, stack
     frame and spills of every kernel instantiation, run the capability
     probe;
  3. each mode32 kernel against its plain PyTorch version on the same CUDA
     tensors (+-1 on at most 0.2% of bytes) at 4096x3840, 1088x1920,
     256x192, a batch of 8 frames of 1088x1920, every rounding mode and a
     strip range (strips outside it zero); the 256x192 encode also against
     an independent float64 NumPy model; the round trip also at 16x1984
     (its strips end in a short tile), with the launch plan of each
     geometry (the encode's, the decode's and the round trip's); the
     strip range's kept strips equal to the full-range encode's and its
     other bytes zero over an output preset to 0xAB;
  4. the fused mode32 round trip equals decode(encode(x)) byte for byte,
     and its PSNR on a smooth 4K view is within 0.1 dB of the plain
     version's;
  5. the mode32 main path through the public api, with every launch counter
     set to 0 just before: 4K encode, decode and round trip, and the
     64-frame 1088x1920 round trip of the BASELINE video ladder; every
     kernel of the path must have launched;
  6. the enc-quant kernels against their plain versions (+-1 on at most
     0.2% of bytes; the rne and clamp_first encodes byte for byte) at the
     same geometries plus 4096x3848 (scalar only, W % 16 == 8: the plain
     variant), with the launch plan of each: all three layouts, every
     rounding mode at 4K, strip ranges with and without legacy_range on
     2x512x3840 (strips of whole tiles) and 2x512x1920 (each strip ends in
     a tile of 16 blocks), one where pair_as_written spills into an
     excluded strip, each output allocated over bytes set to 0xAB (an
     unwritten byte shows); the tensor variant equal to the plain variant
     forced, encode and decode, at 4096x3840 and 8x1088x1920; and three
     exact identities on the card: pair == scalar permuted by the
     pair-cell map, pair_as_written == pair with every second half zeroed,
     decode(scalar) == decode(pair);
  7. the enc-quant main path through the public api with numpy inputs and
     no device (they must land on the card), counters set to 0 just
     before: 4K encode in the scalar and pair layouts, the decode of both,
     and a 64-frame 1088x1920 batch in one launch each way; round-trip PSNR
     on the smooth 4K view at quality 50 within 0.1 dB of the plain
     version's;
  8. the stereo kernels against their plain versions (+-1 on at most 0.2%
     of bytes) at 4096x3840, 1088x1920, 256x200 (W % 128 != 0: the plain
     variant, byte-wide records) and an 8-frame 1088x1920 batch, in the
     interleaved, planar and native view layouts, every rounding mode at
     4K; at 4096x3840 and 1088x1920 the tensor variant equals the plain
     variant forced on the same image (encode and decode, every layout),
     views 8 bytes off a 16-byte boundary (the plain variant the plan
     picks) equal the aligned image, and a shard's row range of both
     views, a view stride apart, through encode_stereo_view equals the
     same rows encoded whole, all byte for byte; strip ranges ([16, 16],
     [64, 191] and one that drops the last strip) and the 1096x1920 spill
     geometry; exact identities on the
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
      rows' copy of the three channels' top view); the launch plan of
      every strip-tile kernel (enc32_rgb, dec32_rgb, roundtrip32_rgb,
      enc420_rgb, dec420_rgb, tiles, detile, roundtrip32, the stereo
      kernels in each layout, encq / decq in each layout and enc32 /
      dec32: ``cuda_dct.color_plan``, ``cuda_dct.color420_plan``,
      ``cuda_dct.tiles_plan``, ``cuda_dct.detile_plan``,
      ``cuda_dct.roundtrip32_plan``, ``cuda_dct.stereo_plan``,
      ``cuda_dct.encq_plan`` / ``decq_plan``, ``cuda_dct.enc32_plan`` /
      ``dec32_plan``) beside its 4K
      time before its strip-tile
      design (``EARLIER_US``), its exact-arithmetic floor
      (``EXACT_OPS_PER_PX``) and the ptxas registers of the instantiation
      that ran;
  11. the YCbCr 4:4:4 colour kernels against their plain versions (+-1 on
      at most 0.2% of bytes) on (3, H, W) planar RGB at 4096x3840 (every
      rounding mode), 1088x1920, 256x192 (W % 128 != 0), 16x1984 (each
      strip ends in a short tile, in the encode, the decode and the round
      trip) and an 8-frame 1088x1920 batch, with the launch plan of each;
      the rne and clamp_first encodes equal the plain
      version byte for byte; the plain-load variant: a (3, 544, 1920) view
      8 bytes off a 16-byte boundary through encode32_rgb_view (every
      rounding);
      the fused round trip equals decode(encode(x)) byte
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
      and an 8-frame 1088x1920 batch, with the launch plan of each
      kernel; the Y segment of each 4:2:0 stream
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
      (enc-quant) and normalized + fy (stereo), every rounding mode, with
      the tile kernel's and the detile's launch plans of each geometry;
      and the
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
  17. the compat tier on the card: the three encodes at 1024x3840 (rne)
      and at 256x384 in every rounding, layout, strip range and view
      layout, and the three decodes, each byte-identical to the same call
      on CPU tensors and within +-1 on at most 0.2% of the fast kernels;
      the wall time and the CUDA kernels (profiler) of each 4K call;
  18. a batch of 65,536 frames of 16x64 (64 MB, one more than a launch
      takes) through encode_quantize32 / decode_quantize32,
      encode_quantize (scalar) and encode_quantize_stereo: each equals its
      two halves run apart, and the launch counters show 2 launches.
  19. the dist kernels against their plain versions on four shards of
      card 0: the plane gather (``ring_gather_kernel``) of the 4K dual
      view's stereo segments in the interleaved and native layouts, and
      over the 'chip' axis of a (2, 2) mesh with 16-byte and byte-wide
      rows, each replica equal to the plain ring and to a torch.cat byte for
      byte; the self-ring (``selfring_kernel``) equal to its plain version
      and ``remote_dma_selfring_smoke()`` True; an arrival that cannot come
      (the host expects one more) raises ``SimdDctError`` after its 0.05 s
      spin bound, from the next gather and from ``check_workspace``, and
      the gather after it works; a gather behind 200 ms of work on the last
      shard's card, with a 0.05 s bound, is exact and raises nothing;
  20. the dist main path, counters set to 0 just before: the 4096x3840
      dual view through the sharded mode32 encode and decode and the stereo
      encode with ``gather=True`` in both layouts with its decode; the
      (3, 4096, 3840) RGB through both colour pairs; the 64-frame 1088x1920
      ``roundtrip_quantize32_batch`` (BASELINE config 4); 8 frames of
      1088x1920 through the 2-D batch on the (2, 2) mesh; and the self-ring
      preflight.  Every kernel of the path launched (``ring_gather``
      once a card for each gather), and each result equals the unsharded
      api call on the card byte for byte.
  21. the compressed stream on the card, through ``container`` with numpy
      inputs and no device, counters set to 0 just before: .sdt containers
      of the 4096x3840 dual view in enc-quant, enc-quant-pair and
      enc-quant32 (its 2048x3840 top view), in enc-quant-stereo in each
      view layout, and of (3, 2048, 3840) planes in both colour modes,
      each with the plain, rle and sparse payloads; an 8x1088x1920
      enc-quant32 .sdtv of each payload through ``decode_video`` and
      ``decode_video_frame``.  Every mode's encode and decode kernel must
      have launched; each decode equals the api decode of the api's records
      byte for byte; each payload's ``decompress`` gives the records and
      ``decompress_to_device`` the same bytes; SDN1 by ``compress_dense``
      on the card's records equals the host split's stream, and the device
      histogram the native one.  Then the stage walls of the 4K enc-quant32
      stream (kernel, device histogram, device-to-host, host pack, unpack,
      host-to-device, decode; the histogram also by ``torch.bincount``,
      which it replaced; the rle, sparse and SDN1 routes; the
      container's encode and decode whole; median of ``STREAM_REPS``) and
      the compression ratio of each payload, beside the card's name and
      power limit.
  22. the serving surfaces on the card: the command line (``cli.main``
      in-process, every mode on a 4096x3840 dual view and its 3x4096x3840
      planar RGB, --runs 16 --quality 50 --decode, the pair and native
      layouts, --sharded 4 --device cuda:0 on mode32 and stereo: each dump
      equal to the api's records byte for byte, and each run's launches
      counted around its ``cli.main`` call: the encode and decode kernels
      of its mode, and the gather for sharded stereo, must have launched),
      then ``python -m simd_dct_tpu_torch.cli`` in processes of
      their own (every mode with --compress --to out.sdt, enc-quant32
      --accurate, --sharded 4 --device cuda:0) and ``python -m
      simd_dct_tpu_torch.container`` info and decode of out.sdt (equal to
      the api decode); the feed (``utils.feed``) on 32 frames of 4096x3840
      at depths 1, 2 and 4: the round trip, the compressed encode (plain
      and sparse) and the decode, each frame equal to the per-frame api
      call, frames a second over ``SERVE_PASSES`` passes in turns with a
      loop of api calls synchronised after each frame (and the ratio of
      each pair), bare pinned and pageable copies of the same bytes and
      the host stages, and one ``torch.profiler`` run of the round-trip
      and encode loops (device idle share, copy / kernel overlap); the rd
      sweep of enc-quant32 and enc-quant32-ycbcr420 at qualities 50, 100
      and 200 against the host's plain version (PSNR within 0.1 dB, rate
      within 0.2%), counters set to 0 just before the feed.  Every kernel
      of the modes that ran must have launched.
  23. the dist path across processes: ``--procs-worker`` processes of this
      script, one a rank (two on card 0, each given ``cuda:0``; with
      ``--cards 4`` four, one a card), bootstrapped by
      ``dist.initialize_distributed`` on a gloo group at 127.0.0.1 and a
      free port, killed after ``PROCS_LIMIT_S``.  Each rank builds the
      4096x3840 dual view and a 64-frame 1088x1920 batch from one seed,
      computes the unsharded api calls on its card, then, counters set to
      0 just before, the strip-sharded mode32 encode and decode, the
      stereo encode with ``gather=True`` in the interleaved and native
      layouts, and the frame-sharded ``roundtrip_quantize32_batch``: its
      shards equal the unsharded calls' rows and its gathered planes the
      whole call, byte for byte, the ranks' hashes agree, ``ring_gather``
      launched once per ``gather=True`` in each process and no collective
      of the process group ran.  Then a store round trip, the gather's
      call wall (``PROCS_REPS`` gathers) and its kernel's device time by
      torch.profiler (as many more), beside one process's gather of the
      same segments over as many shards of card 0 (profiler, queued
      events, wall); a gather the last rank skips: the others raise
      ``SimdDctError`` within the spin bound plus 1 s and every rank's
      next gather is exact; and rank 0, the store's host, exiting at
      once: every other rank's next gather raises ``SimdDctError`` within
      the spin bound plus 1 s;
  24. the NumPy golden tier with a card present: ``backend="numpy"`` on a
      256x1920 view (mode32, enc-quant scalar and pair, stereo; encode,
      decode, the round trip) within +-1 on at most 0.2% of bytes of the
      card's kernels, and under ``compat=True`` equal to the C++ oracle;
      a CUDA tensor under ``numpy`` raises naming ``.cpu()``; ``cli.main``
      with ``--max-simd none`` launches no kernel and dumps the golden's
      bytes; the golden's seconds a call.
  25. the BASELINE ladder and the usage examples on the card: ``python -m
      simd_dct_tpu_torch.bench.harness`` in a process of its own (exit 0,
      five lines with no error, config 1 bit-exact, config 3's gate passed
      at 0.1 dB on ``cuda_fused_color``), then each config in this
      process with the counters set to 0 just before (configs 2 and 4
      launch roundtrip32, config 3 roundtrip32_rgb, config 1 no kernel,
      config 5 enc32 on the card count and on four virtual shards of card
      0), then each config's kernel output on the config's own input at
      the ladder's shape against the plain version within +-1 on at most
      0.2% of bytes (roundtrip32 on config 2's (3, 2048, 3840) planes and
      config 4's (64, 1088, 1920) frames, roundtrip32_rgb on config 3's
      planes, the sharded encode of each config-5 image, which also
      launches enc32 once a shard and equals the one-call encode); each
      config's time an item (its line's ``ms_per_item``) beside a same-run
      device-to-device copy of a call's bytes and the card's name and
      power limit, where the time is queued device time (``timer``); each
      example (``encode_decode``, ``video_pipeline``,
      ``serving``, ``sharded``) as ``python -m
      simd_dct_tpu_torch.examples.<name> --device cuda`` and ``--device
      cpu``, the eight processes started together: both exit 0 and print
      the same lines, each PSNR within 0.1 dB; then each ``main()`` in this
      process (the card by default, the process's lines), counters set to
      0 just before: the encode and decode kernels of its modes, the fused
      round trip (serving) and the gather (sharded) must have launched.
Phase 10 runs before phase 22 (whose profiler sessions, run first, once
left phase 10's profiler without a self-ring kernel; where the profiler
records none, the self-ring's time is null, never its call's wall); it
also times the gather kernel on
the 4K stereo segments of four shards against four torch.cats (its
library call, by the same two estimators) and the bound, with the launch
plan (CTAs a rank, tile bytes, stages); the self-ring kernel against
torch.cat([x, x], 1), both by the profiler; and the 4-shard stereo
encode against the one-launch call.  Each phase logs its seconds.  The
line before the last is a JSON object with one entry per kernel (its
time, its bound, its share of the copy, its launches on its main path,
on phase 21's (``launches_stream``) and on phase 22's
(``launches_serve``), on phase 25's in-process runs of the harness's
configs (``launches_harness``) and of the examples (``launches_examples``)
and in each process of phase 23 (``launches_procs``, rank order), the
gather's row also its times across processes, the probe's row the card's
launch floor: a one-element elementwise op by the same two estimators);
the lines before it hold phase 21's stage walls and ratios, phase 22's
walls, rates and command-line rows, phase 24's golden seconds, phase 25's
lines (``{"ladder": ...}``) and phase 23's results (``{"procs": ...}``);
the last line is ``{"ok": true, "device": {...}}``.
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
from simd_dct_tpu_torch import container, dist, entropy
from simd_dct_tpu_torch.dist import collectives
from simd_dct_tpu_torch.core.dct import dct_basis_np
from simd_dct_tpu_torch.core.quantize import VR, default_quant_lut
from simd_dct_tpu_torch.dispatch import capability
from simd_dct_tpu_torch.kernels import _build, cuda_dct, panel, torch_path
from simd_dct_tpu_torch.layout import BASE_CHROMA_QUANT_TABLE
from simd_dct_tpu_torch.layout.reorder import stereo_interleaved_to_views
from simd_dct_tpu_torch.utils.debug import compare_backends
from simd_dct_tpu_torch.utils.metrics import psnr
from simd_dct_tpu_torch.utils.profiling import (queued_ms, sleep_cycles_per_ms,
                                               wall_ms)

DCT32 = "simd_dct_tpu_torch/csrc/dct32.cu"
ENCQ = "simd_dct_tpu_torch/csrc/encq.cu"
STEREO = "simd_dct_tpu_torch/csrc/stereo.cu"
COLOR = "simd_dct_tpu_torch/csrc/color32.cu"
COLOR420 = "simd_dct_tpu_torch/csrc/color420.cu"
TILES = "simd_dct_tpu_torch/csrc/tiles.cu"
COLLECTIVES = "simd_dct_tpu_torch/csrc/collectives.cu"
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
    "ring_gather": (COLLECTIVES, "simd_dct_tpu/dist/collectives.py:215",
                    "dist"),
    "selfring": (COLLECTIVES, "simd_dct_tpu/dist/collectives.py:310",
                 "dist"),
}
# (H, W, frames) of the dual-view images the comparisons run on
GEOMETRIES = [(4096, 3840, 1), (1088, 1920, 1), (256, 192, 1), (1088, 1920, 8)]
# 4:2:0 needs W % 128 == 0 and H % 32 == 0; at W = 384 (24 macroblocks a
# row) a CUDA block's 32 macroblocks cross a macroblock row
GEOMETRIES_420 = [(4096, 3840, 1), (1088, 1920, 1), (64, 384, 1),
                  (1088, 1920, 8)]
# colour: W = 1984 (248 blocks a strip) ends each strip in a tile of 8
# blocks where enc32_rgb and roundtrip32_rgb tile strips by 16
COLOR_GEOMETRIES = GEOMETRIES + [(16, 1984, 1)]
# stereo: W = 200 (BW = 25) takes the plain variant (byte-wide records);
# 4096x3840 and 1088x1920 take the tensor variant, and phase 8 runs the
# plain one on them too
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
# the plain versions' walls, logged beside their profiler times (which the
# rows use): a few milliseconds a call, so fewer repetitions
PLAIN_WALL_REPS = 5
# the redesigned kernels' 4K times before their redesign (queued events,
# PERF.md rows 12 to 14: the thread-per-(block, channel) design; rows 9
# and 10: the thread-per-block stereo design, interleaved; row 15: the
# thread-per-block 4:2:0 encode; row 16: the 4:2:0 decode of 32
# macroblocks a CUDA block; row 6: the tile inverse of a block a thread;
# rows 5 and 3: the tile kernel and the fused round trip of a block a thread;
# rows 7 and 8: the enc-quant encode and decode of a block a thread, scalar;
# rows 1 and 2: the mode32 encode and decode of a block a thread)
EARLIER_US = {"enc32_rgb": 52.84, "roundtrip32_rgb": 86.72,
              "dec32_rgb": 45.85, "enc420_rgb": 37.25,
              "dec420_rgb": 35.10, "enc_stereo": 26.76,
              "dec_stereo": 28.00, "detile": 14.65, "tiles": 14.86,
              "roundtrip32": 20.70, "encq": 14.59, "decq": 14.91,
              "enc32": 14.35, "dec32": 15.56}
# The exact-arithmetic floor of the colour tile kernels: the instructions a
# pixel position that their bytes require, issued at one instruction a lane
# a clock (132 SMs x 128 lanes at the 1980 MHz the card holds under them,
# color_variants.py).  A pixel position's three channels take: the exact
# u8 -> f32 (2 each), the mix (3 multiplies and 3 adds each), the
# matrix-form transforms (8 FMAs a pass and channel; the identities with
# the plain version and dec32_rgb fix every product and sum), the quantizer
# (multiply, 2 clamps, round; the encode's +127, the round trip's exact
# rint and dequant multiply), the round trip's bias, inverse mix, clamp and
# round (8 a channel) and packing (0.75); and the design's shared-memory
# traffic (3 input loads; 6 a crossing, one in the encode and three in the
# round trip; the encode's 3 record stores, the round trip's 3/8).
# The stereo tile kernels count per pixel of both views.  The encode: the
# exact u8 -> f32 (2), the 1/255 scale (1), the matrix-form transform (16
# FMAs: 8 a pass, fixed by the identities with the plain version, the tile
# records and the sharded path), the quantizer (multiply, 2 clamps, round,
# +127: 5), and the design's shared-memory traffic (input read 1, crossing
# 2, record staging 1): 28.  The decode: record read 1, exact (b - 127) 2,
# dequant multiply 1, 16 FMAs, times 255 1, 2 clamps, round 1, packing
# 0.75 and staging 1/8, crossing 2: 26.875.
# The colour decode, per pixel position and channel: the record byte read
# (1), the exact (b - 127) (2), the dequant multiply (1), the matrix-form
# idct2d (16 FMAs; roundtrip32_rgb == dec32_rgb(enc32_rgb) fixes them), the
# bias (1), the inverse mix, 2 clamps and the round (8), packing (0.75);
# then the crossing (6) and the pixel staging (3/8): 95.625.
# The 4:2:0 encode, per pixel position: the 2-byte loads (1.5 for 3
# bytes), the exact u8 -> f32 (6), the three mixes and their biases (18),
# the pool (2: 3 adds and a multiply per 4 pixels, each chroma); Y's
# transform (16), quantizer (5), crossing (2) and record staging (1); each
# chroma plane at a quarter of the pixels: the pooled store and load (2),
# the transform (16), the crossing (2), the quantizer (5) and the staging
# (1), 26 a chroma pixel: 64.5.
# The 4:2:0 decode, per pixel position: Y's record byte read (1), exact
# (b - 127) (2), dequant multiply (1), idct2d (16 FMAs), crossing (2) and
# bias (1); the inverse mix of the three channels (3 multiplies and 2
# adds each: 15), 2 clamps and the round each (9), packing (3 x 0.75) and
# the pixel staging (3/8); the chroma values' loads, one 16-byte load of
# each plane over 8 pixels (2/8); each chroma plane at a quarter of the
# pixels: record read (1), exact (2), dequant (1), idct2d (16), crossing
# (2), bias (1) and the 16-byte store into the chroma values (1/4),
# 23.25 a chroma pixel: 61.5.
# The tile inverse (timed raw: no times 255), per pixel: record read (1),
# exact (b - 127) (2), dequant multiply (1), idct2d (16 FMAs), crossing
# (2), 2 clamps and the round (3), packing (0.75) and staging (1/8):
# dec_stereo's count less its times 255, 25.875.
# The tile kernel (timed raw: no times 1/255), per pixel: the input read
# (1), the exact u8 -> f32 (2), the matrix-form transform (16 FMAs), the
# quantizer (multiply, 2 clamps, round, +127: 5), the crossing (2) and the
# Z staging (1): enc_stereo's count less its 1/255 scale, 27.
# The fused round trip, per pixel: its block's rows read as 8-byte words
# (1/8), the exact u8 -> f32 (2), dct2d (16 FMAs), the requantizer
# (multiply, 2 clamps, exact rint (2), dequant multiply: 6), idct2d (16
# FMAs), the pixel's 2 clamps and round (3), packing (0.75) and staging
# (1/8); no crossing (one thread a block): 44.
# The enc-quant encode counts as the stereo encode does, per pixel of the
# top view: the exact u8 -> f32 (2), the 1/255 scale (1), the matrix-form
# transform (16 FMAs, fixed by the identities with the plain version and
# the tile records), the quantizer (multiply, 2 clamps, round, +127: 5),
# the input read (1), the crossing (2) and the record staging (1): 28.  The
# decode as dec_stereo: record read (1), exact (b - 127) (2), dequant
# multiply (1), 16 FMAs, times 255 (1), 2 clamps and the round (3),
# packing (0.75), staging (1/8) and the crossing (2): 26.875.
# The mode32 encode and decode count as the tile kernel and the tile inverse
# (raw: no 1/255, no times 255): 27 and 25.875.  Their record staging is
# the same one byte store (or load) a coefficient, into padded 512-byte
# groups; the group bulk copies (4 a tile of 2,048 pixels, one thread) and
# the excluded strips' zero stores are not counted.
EXACT_OPS_PER_PX = {
    "enc32_rgb": 3 * (2 + 6 + 16 + 5) + 3 + 6 + 3,
    "dec32_rgb": 3 * (1 + 2 + 1 + 16 + 1 + 8 + 0.75) + 6 + 3 / 8,
    "roundtrip32_rgb": 3 * (2 + 6 + 32 + 6 + 1 + 8 + 0.75) + 3 + 18 + 3 / 8,
    "enc420_rgb": 1.5 + 6 + 18 + 2 + (16 + 5 + 2 + 1) + 2 * 26 / 4,
    "dec420_rgb": (1 + 2 + 1 + 16 + 2 + 1) + 15 + 9 + 3 * 0.75 + 3 / 8
                  + 2 / 8 + 2 * (1 + 2 + 1 + 16 + 2 + 1 + 1 / 4) / 4,
    "enc_stereo": 2 + 1 + 16 + 5 + 1 + 2 + 1,
    "dec_stereo": 1 + 2 + 1 + 16 + 1 + 2 + 1 + 0.75 + 1 / 8 + 2,
    "detile": 1 + 2 + 1 + 16 + 2 + 1 + 0.75 + 1 / 8 + 2,
    "tiles": 1 + 2 + 16 + 5 + 2 + 1,
    "roundtrip32": 1 / 8 + 2 + 16 + 6 + 16 + 3 + 0.75 + 1 / 8,
    "encq": 2 + 1 + 16 + 5 + 1 + 2 + 1,
    "decq": 1 + 2 + 1 + 16 + 1 + 2 + 1 + 0.75 + 1 / 8 + 2,
    "enc32": 1 + 2 + 16 + 5 + 2 + 1,
    "dec32": 1 + 2 + 1 + 16 + 2 + 1 + 0.75 + 1 / 8 + 2,
}
ISSUE_PER_S = 132 * 128 * 1.98e9
# ptxas -v of each kernel instantiation, from the build (phase 2)
PTXAS: dict[str, str] = {}
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
              "tiles": PASS_FMA_PER_PX, "detile": PASS_FMA_PER_PX,
              "ring_gather": 0, "selfring": 0}


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
        log(f"  enc32 {tag} plan: "
            f"{cuda_dct.mode32_launch_plan('enc32', img)._asdict()}")
        log(f"  dec32 {tag} plan: " + str(cuda_dct.mode32_launch_plan(
            "dec32", rec, size_x=w, size_y=h)._asdict()))
        fused = cuda_dct.roundtrip_quantize32(img, lut)
        composed = cuda_dct.decode_quantize32(
            cuda_dct.encode_quantize32(img, lut), lut, w, h)
        require(torch.equal(fused, composed),
                f"roundtrip32 {tag}: fused == composed byte for byte")
        log(f"  roundtrip32 {tag} plan: "
            f"{cuda_dct.roundtrip32_launch_plan(img)._asdict()}")
        plain_rt = torch_path.roundtrip_quantize32(img, lut)
        diff = (fused.to(torch.int16) - plain_rt.to(torch.int16)).abs()
        errs["roundtrip32"] = max(errs.get("roundtrip32", 0),
                                  int(diff.max()))
        log(f"  roundtrip32 {tag}: fused == composed; against plain "
            f"max_abs_diff={int(diff.max())} "
            f"mismatch_rate={float((diff > 0).double().mean()):.3e}")
    # W = 1984: each strip ends in a short round-trip tile
    img = random_images(gen, 16, 1984, 1)
    fused = cuda_dct.roundtrip_quantize32(img, lut)
    require(torch.equal(fused, cuda_dct.decode_quantize32(
        cuda_dct.encode_quantize32(img, lut), lut, 1984, 16)),
        "roundtrip32 16x1984: fused == composed byte for byte")
    agree("roundtrip32 1x16x1984", fused,
          torch_path.roundtrip_quantize32(img, lut), errs, "roundtrip32")
    log(f"  roundtrip32 1x16x1984 plan: "
        f"{cuda_dct.roundtrip32_launch_plan(img)._asdict()}")
    img = random_images(gen, 512, 3840, 1)
    agree("enc32 512x3840 strip range [64, 191]",
          cuda_dct.encode_quantize32(img, lut, 64, 191),
          torch_path.encode_quantize32(img, lut, 64, 191), errs, "enc32")
    recs = over_junk(cuda_dct.encode_quantize32, img, lut, 64,
                     191).view(32, -1)
    require(not recs[:4].any() and not recs[12:].any() and recs[4:12].any(),
            "strip range keeps strips 4..11 only")
    require(torch.equal(recs[4:12], cuda_dct.encode_quantize32(img, lut)
                        .view(32, -1)[4:12]),
            "the kept strips equal the full-range encode's")
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


def encq_exact(name, got, want, rounding, errs) -> None:
    """The rne and clamp_first encodes equal the plain version byte for
    byte; 'scalar' (a division by 255) within the +-1 contract."""
    if rounding == "scalar":
        agree(name, got, want, errs, "encq")
        return
    n = int((got != want).sum())
    log(f"  {name}: {n} mismatching bytes")
    require(n == 0, f"{name} equals the plain version byte for byte")
    errs["encq"] = max(errs.get("encq", 0), 0)


def over_junk(fn, *args, **kw):
    """fn's result, its output allocated over bytes just set to 0xAB (the
    caching allocator hands the same block back): an unwritten byte
    shows."""
    out = fn(*args, **kw)
    out.fill_(0xAB)
    del out
    return fn(*args, **kw)


def phase_compare_encq(gen, lut, errs):
    log("phase 6: enc-quant kernels against the plain version on the card")
    geoms = GEOMETRIES + [(4096, 3848, 1)]
    for h, w, frames in geoms:
        img = random_images(gen, h, w, frames)
        tag = f"{frames}x{h}x{w}"
        layouts = LAYOUTS if w % 16 == 0 else ("scalar",)
        roundings = ROUNDINGS if h == 4096 else ("rne",)
        for layout in layouts:
            log(f"  encq {tag} {layout} plan: " + str(
                cuda_dct.encq_launch_plan("encq", img, layout)._asdict()))
            for rounding in roundings:
                encq_exact(f"encq {tag} {layout} {rounding}",
                           cuda_dct.encode_quantize(img, lut,
                                                    rounding=rounding,
                                                    layout=layout),
                           torch_path.encode_quantize(img, lut,
                                                      rounding=rounding,
                                                      layout=layout),
                           rounding, errs)
        for layout in layouts[:2]:
            rec = torch_path.encode_quantize(img, lut, layout=layout)
            log(f"  decq {tag} {layout} plan: " + str(
                cuda_dct.encq_launch_plan("decq", rec, layout, size_x=w,
                                          size_y=h)._asdict()))
            agree(f"decq {tag} {layout} (same records)",
                  cuda_dct.decode_quantize(rec, lut, w, h, layout),
                  torch_path.decode_quantize(rec, lut, w, h, layout),
                  errs, "decq")
    # strips are 16 rows of the dual-view buffer apart (8 with legacy_range)
    ranges = [(64, 191, False), (0, 100, True), (16, 16, False),
              (200, 1 << 40, True)]
    # W = 3840: a strip is 15 whole tiles; W = 1920: 7 and one of 16 blocks,
    # so a spill leaves a whole tile or a short one
    for w in (3840, 1920):
        img = random_images(gen, 512, w, 2)
        for sy, ey, legacy in ranges:
            for layout in LAYOUTS:
                got = over_junk(cuda_dct.encode_quantize, img, lut, sy, ey,
                                layout=layout, legacy_range=legacy)
                want = torch_path.encode_quantize(img, lut, sy, ey,
                                                  layout=layout,
                                                  legacy_range=legacy)
                encq_exact(f"encq 2x512x{w} {layout} range [{sy}, {ey}] "
                           f"legacy={legacy}", got, want, "rne", errs)
                # the bytes the strip geometry leaves unwritten, spill
                # included
                written = sd._strip_byte_mask(
                    512, w, sy, ey, legacy_range=legacy,
                    pair_spill=layout == "pair_as_written")
                if written is not None:
                    skipped = torch.from_numpy(~written).to(DEV)
                    require(not got[:, skipped].any()
                            and not want[:, skipped].any(),
                            "bytes outside the strip range and its spill are "
                            "zero in kernel and plain version")
    # the tensor variant against the plain one forced on the same tensors
    for h, w, frames in [(4096, 3840, 1), (1088, 1920, 8)]:
        img = random_images(gen, h, w, frames)
        for layout in LAYOUTS:
            require(torch.equal(
                cuda_dct.encode_quantize(img, lut, layout=layout),
                cuda_dct._encode_quantize(img, lut, layout=layout,
                                          variant="plain")),
                f"encq {frames}x{h}x{w} {layout}: tensor == plain variant")
        for layout in LAYOUTS[:2]:
            rec = cuda_dct.encode_quantize(img, lut, layout=layout)
            require(torch.equal(
                cuda_dct.decode_quantize(rec, lut, w, h, layout),
                cuda_dct._decode_quantize(rec, lut, w, h, layout,
                                          variant="plain")),
                f"decq {frames}x{h}x{w} {layout}: tensor == plain variant")
        log(f"  {frames}x{h}x{w}: the tensor variants equal the plain ones "
            "forced, every layout, byte for byte")
    log("  variant launches: " + str({
        k: cuda_dct.VARIANT_LAUNCHES[k] for k in ("encq", "decq")}))
    img = random_images(gen, 512, 3840, 2)
    spilled = cuda_dct.encode_quantize(
        img, lut, 16, 16, layout="pair_as_written").view(2, 32, -1)
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


def check_stereo_variants(img, lut, tag):
    """The tensor variant the plan picks for an aligned image against the
    plain variant forced on it, byte for byte, in every layout and (at 4K)
    rounding, encode and decode; the plain variant the plan picks for the
    same views 8 bytes off a 16-byte boundary; and a shard's row range of
    both views, a view stride apart, through encode_stereo_view against the
    plain version."""
    h, w = img.shape
    roundings = ROUNDINGS if h == 4096 else ("rne",)
    for vl in VIEW_LAYOUTS:
        for rounding in roundings:
            plan = cuda_dct.stereo_launch_plan("enc_stereo", img, vl,
                                               rounding=rounding)
            require(plan.variant == "tensor", f"{tag}: the tensor variant")
            tensor = cuda_dct.encode_quantize_stereo(
                img, lut, rounding=rounding, view_layout=vl)
            plain = cuda_dct.encode_quantize_stereo(
                img, lut, rounding=rounding, view_layout=vl, variant="plain")
            require(torch.equal(tensor, plain),
                    f"enc_stereo {tag} {vl} {rounding}: tensor == plain")
        rec = cuda_dct.encode_quantize_stereo(img, lut, view_layout=vl)
        require(torch.equal(
            cuda_dct.decode_quantize_stereo(rec, lut, w, h, vl),
            cuda_dct.decode_quantize_stereo(rec, lut, w, h, vl,
                                            variant="plain")),
            f"dec_stereo {tag} {vl}: tensor == plain")
    flat = torch.empty(h * w + 64, dtype=torch.uint8, device=DEV)
    off = flat[8:8 + h * w].view(2, h // 2, w)
    off.copy_(img.view(2, h // 2, w))
    plan = cuda_dct._stereo_plan_of("enc_stereo", off, 1, h, w, "native",
                                    off.data_ptr(), 0, off.stride(0))
    require(plan.variant == "plain", "views 8 bytes off take the plain variant")
    for vl in VIEW_LAYOUTS:
        require(torch.equal(cuda_dct.encode_stereo_view(off, lut,
                                                        view_layout=vl),
                            cuda_dct.encode_quantize_stereo(img, lut,
                                                            view_layout=vl)),
                f"enc_stereo {tag} {vl}: views 8 bytes off == aligned")
    shard = img.view(2, h // 2, w)[:, 64:192]     # strips 8..23 of each view
    whole = shard.reshape(256, w)                 # a contiguous copy
    got = cuda_dct.encode_stereo_view(shard, lut)
    require(torch.equal(got, cuda_dct.encode_quantize_stereo(whole, lut)),
            f"enc_stereo {tag}: a shard's views (stride {shard.stride(0)}) "
            "== the same rows encoded whole")
    agree(f"enc_stereo {tag} shard views", got,
          torch_path.encode_quantize_stereo(whole, lut), {}, "enc_stereo")
    log(f"  {tag}: tensor == plain variant in every layout, encode and "
        "decode; views 8 bytes off (plain) == aligned; a shard's view "
        "stride == the rows encoded whole: exact")


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
        if frames == 1 and w % 128 == 0:
            check_stereo_variants(img, lut, tag)
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
    """The config-3 PSNR gate's input (``bench.harness._gate_planes``:
    three correlated channels of one smooth field) as the top view of a
    (3, 2*h2, w) dual view whose bottom view is zero."""
    from simd_dct_tpu_torch.bench.harness import _gate_planes
    top = _gate_planes(h2, w)
    return np.concatenate([top, np.zeros_like(top)], axis=1)


def enc32_rgb_exact(name, got, want, rounding, errs) -> None:
    """rne and clamp_first encodes equal the plain version byte for byte;
    scalar keeps the +-1 contract."""
    agree(name, got, want, errs, "enc32_rgb")
    if rounding != "scalar":
        n = int((got != want).sum())
        log(f"  {name}: {n} mismatches against the plain version")
        require(n == 0, f"{name} equals the plain version byte for byte")


def phase_compare_color(gen, luma, chroma, errs):
    log("phase 11: YCbCr 4:4:4 colour kernels against the plain version on "
        "the card")
    for h, w, frames in COLOR_GEOMETRIES:
        rgb = random_rgb(gen, h, w, frames)
        tag = f"{frames}x3x{h}x{w}"
        for kind in ("enc32_rgb", "roundtrip32_rgb"):
            log(f"  {kind} {tag} plan: "
                f"{cuda_dct.color_launch_plan(kind, rgb)._asdict()}")
        roundings = ROUNDINGS if h == 4096 else ("rne", "clamp_first")
        for rounding in roundings:
            enc32_rgb_exact(f"enc32_rgb {tag} {rounding}",
                            cuda_dct.encode_quantize32_ycbcr(
                                rgb, luma, chroma, rounding),
                            torch_path.encode_ycbcr32(rgb, luma, chroma,
                                                      rounding),
                            rounding, errs)
        rec = torch_path.encode_ycbcr32(rgb, luma, chroma)
        plan = cuda_dct.color_launch_plan("dec32_rgb", rec, size_x=w)
        log(f"  dec32_rgb {tag} plan: {plan._asdict()}")
        require(plan.tail_blocks == (8 if w % 128 else 16),
                f"dec32_rgb {tag}: strips end in tiles of "
                f"{plan.tail_blocks} blocks")
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
    # a (3, H2, W) view 8 bytes off a 16-byte boundary: the plain-load
    # variant of enc32_rgb, picked by the plan
    h, w = 1088, 1920
    flat = random_images(gen, 1, 3 * h * w + 64, 1).reshape(-1)
    view = flat[8:8 + 3 * h * w].view(3, h, w)[:, : h // 2]
    plan = cuda_dct._color_plan_of("enc32_rgb", view, view.data_ptr(), 1,
                                   h // 2, w, view.stride(0))
    log(f"  enc32_rgb 3x{h // 2}x{w} view at +8 bytes plan: "
        f"{plan._asdict()}")
    require(plan.variant == "plain", "a misaligned view takes plain loads")
    for rounding in ROUNDINGS:
        enc32_rgb_exact(f"enc32_rgb view at +8 bytes {rounding}",
                        cuda_dct.encode32_rgb_view(view, luma, chroma,
                                                   rounding),
                        torch_path.encode_ycbcr32_view(view, luma, chroma,
                                                       rounding),
                        rounding, errs)
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
        log(f"  enc420_rgb {tag} plan: "
            f"{cuda_dct.color420_launch_plan(rgb)._asdict()}")
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
        log(f"  dec420_rgb {tag} plan: "
            f"{cuda_dct.color420_launch_plan(rec, size_x=w)._asdict()}")
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
        shape = top.shape[:-2] + (h2 // 128, 128, w // 128, 128)
        log(f"  detile {tag} plan: "
            f"{cuda_dct.detile_launch_plan(top.view(shape))._asdict()}")
        log(f"  tiles {tag} plan: "
            f"{cuda_dct.tiles_launch_plan(top)._asdict()}")
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
    t_phase = time.perf_counter()
    img = random_images(gen, 4096, 3840, 1)
    stats = {}
    encodes = {
        "encode_quantize32": (sd.encode_quantize32, lut),
        "encode_quantize": (sd.encode_quantize, lut_q),
        "encode_quantize_stereo": (sd.encode_quantize_stereo, lut_q)}
    decodes = {"encode_quantize32": sd.decode_quantize32,
               "encode_quantize": sd.decode_quantize,
               "encode_quantize_stereo": sd.decode_quantize_stereo}
    # the card against the CPU on the top 1024 rows (the CPU's eager ops
    # at 4K took most of this phase), the walls at 4K
    part = img[:1024].contiguous()
    for name, (enc, l) in encodes.items():
        rec = compat_equal(f"{name} 1024x3840", enc, (part, l), {},
                           fast=enc(part, l))
        dec = decodes[name]
        compat_equal(f"{dec.__name__} 1024x3840", dec, (rec, l, 3840, 1024),
                     {}, fast=dec(rec, l, 3840, 1024))
        rec = enc(img, l, compat=True)
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
    log(f"  [the 4K part: {time.perf_counter() - t_phase:.2f} s]")
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


# -- the dist path: shards on one card and the plane gather ------------------

# the dist phases' four shards: all on card 0, or one a card (--cards 4)
DIST_DEVICES = [f"{DEV}:0"] * 4


def dist_meshes():
    """The four shards as one ring and as a (2, 2) mesh."""
    return (dist.make_mesh(4, devices=DIST_DEVICES),
            dist.make_mesh_2d((2, 2), devices=DIST_DEVICES))


def gather_equal(name: str, seg, mesh, errs: dict, **kw) -> None:
    """The gather kernel against its plain version (the ring) and against a
    torch.cat per rank, replica by replica: byte for byte."""
    got = collectives.gather_planes_remote(seg, mesh, **kw)
    ring = collectives.gather_planes_ring(seg, mesh, **kw)
    cat = collectives.gather_planes_allgather(seg, mesh, **kw)
    worst = max(int((a.to(torch.int16) - b.to(torch.int16)).abs().max())
                for a, b in zip(got.shards, ring.shards))
    errs["ring_gather"] = max(errs.get("ring_gather", 0), worst)
    same = all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(got.shards, ring.shards, cat.shards))
    log(f"  ring_gather {name}: replicas {len(got.shards)} of "
        f"{tuple(got.shards[0].shape)}, max_abs_diff={worst} exact={same}")
    require(same, f"ring_gather {name} == the ring and torch.cat, exactly")


def phase_compare_dist(gen, lut_q, errs):
    log("phase 19: the dist kernels against their plain versions on the "
        f"card (four shards on {DIST_DEVICES})")
    mesh, mesh2 = dist_meshes()
    img = random_images(gen, 4096, 3840, 1)
    for vl in ("native", "interleaved"):
        stereo = dist.encode_quantize_stereo_sharded(img, lut_q, mesh,
                                                     view_layout=vl)
        gather_equal(f"4K {vl} {tuple(stereo.shards[0].shape)}", stereo,
                     mesh, errs)
    # one ring per row of the (2, 2) mesh; a 16-byte row and a byte-wide one
    for shape in [(64, 68, 480), (64, 16, 15)]:
        seg = torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                            device=DEV)
        gather_equal(f"(2, 2) 'chip' {shape}", seg, mesh2, errs,
                     axis_name="chip")
    x = torch.randint(0, 256, (8, 8, 128), generator=gen, dtype=torch.uint8,
                      device=DEV)
    same = torch.equal(collectives.selfring(x), collectives.selfring_plain(x))
    errs["selfring"] = 0 if same else 255
    require(same, "selfring == its plain version, exactly")
    require(collectives.remote_dma_selfring_smoke() is True,
            "remote_dma_selfring_smoke() is True")
    log("  selfring (8, 8, 128) exact; remote_dma_selfring_smoke() True")
    seg = stereo        # the 4K interleaved segments
    # a hang becomes an error: the host expects one arrival more than will
    # come, so rank 0 spins out; the gather does not wait, so the next
    # gather on the mesh raises once the word shows it, and check_workspace
    # after waiting for the cards
    for how in ("the next gather", "check_workspace"):
        collectives.gather_planes_remote(seg, mesh)
        mesh._collective_workspace.arr[0] += 1
        t0 = time.perf_counter()
        try:
            collectives.gather_planes_remote(seg, mesh, timeout_s=0.05)
            if how == "the next gather":
                torch.cuda.synchronize()
                collectives.gather_planes_remote(seg, mesh)
            else:
                collectives.check_workspace(mesh)
            raised = None
        except sd.SimdDctError as e:
            raised = str(e)
        log(f"  an arrival that cannot come, reported by {how}: {raised!r} "
            f"after {time.perf_counter() - t0:.3f} s")
        require(raised is not None and mesh._collective_workspace is None,
                f"a timed-out spin raises SimdDctError from {how} and drops "
                "the workspace")
        gather_equal(f"4K interleaved after the error ({how}), a new "
                     "workspace", seg, mesh, errs)
    # a card whose stream is busy for 4 spin bounds: the other cards' streams
    # wait for it, not their kernels
    lag_ms = 200
    torch.cuda.synchronize()
    with torch.cuda.device(DIST_DEVICES[-1]):
        torch.cuda._sleep(int(lag_ms * sleep_cycles_per_ms()))
    got = collectives.gather_planes_remote(seg, mesh, timeout_s=0.05)
    collectives.check_workspace(mesh)
    require(all(torch.equal(r.cpu(), seg.full().cpu()) for r in got.shards),
            "a gather behind a busy card is exact")
    log(f"  a gather behind {lag_ms} ms of work on {DIST_DEVICES[-1]} with a "
        "0.05 s spin bound: no error, every replica exact")


def phase_main_path_dist(gen, lut, lut_q, luma, chroma):
    log(f"phase 20: the dist main path (four shards on {DIST_DEVICES}, and "
        "a (2, 2) mesh for the 2-D batch)")
    mesh, mesh2 = dist_meshes()
    img = random_images(gen, 4096, 3840, 1)
    rgb = random_rgb(gen, 4096, 3840, 1)
    video = random_images(gen, 1088, 1920, 64)
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    rec = dist.encode_quantize32_sharded(img, lut, mesh)
    pix = dist.decode_quantize32_sharded(rec, lut, 3840, 4096, mesh)
    planes = {vl: dist.encode_quantize_stereo_sharded(
        img, lut_q, mesh, gather=True, view_layout=vl)
        for vl in ("interleaved", "native")}
    views = {vl: dist.decode_quantize_stereo_sharded(
        planes[vl], lut_q, 3840, 4096, mesh, view_layout=vl)
        for vl in planes}
    crec = dist.encode_quantize32_ycbcr_sharded(rgb, luma, chroma, mesh)
    cpix = dist.decode_quantize32_ycbcr_sharded(crec, luma, chroma, 3840,
                                                4096, mesh)
    y420, c420 = dist.encode_quantize32_ycbcr420_sharded(rgb, luma, chroma,
                                                         mesh)
    pix420 = dist.decode_quantize32_ycbcr420_sharded(y420, c420, luma, chroma,
                                                     3840, 4096, mesh)
    vid = dist.roundtrip_quantize32_batch(video, lut, mesh)
    rec2d = dist.encode_quantize32_batch_2d(video[:8], lut, mesh2)
    smoke = collectives.remote_dma_selfring_smoke()
    torch.cuda.synchronize()
    counts = dict(cuda_dct.LAUNCHES)
    log(f"  launches: {counts}")
    for name in ("enc32", "dec32", "roundtrip32", "enc_stereo", "dec_stereo",
                 "enc32_rgb", "dec32_rgb", "enc420_rgb", "dec420_rgb",
                 "ring_gather", "selfring"):
        require(counts[name] > 0, f"{name} launched on the dist path")
    cards = len(set(DIST_DEVICES))
    require(counts["ring_gather"] == 2 * cards,
            "one gather launch per card for each gather=True")
    require(smoke is True, "remote_dma_selfring_smoke() is True")
    results = [rec, pix, *planes.values(), *views.values(), crec, cpix, y420,
               c420, pix420, vid, rec2d]
    require(all(t.device.type == DEV for r in results for t in r.shards),
            "every shard lies on the card")
    # every result equals the unsharded api call on the card, byte for byte
    s420 = torch.cat([y420.full().reshape(-1), c420.full().reshape(-1)])
    checks = {
        "encode_quantize32_sharded": (
            rec.full().reshape(-1), sd.encode_quantize32(img, lut)),
        "decode_quantize32_sharded": (
            pix.full(), sd.decode_quantize32(rec.full().reshape(-1), lut,
                                             3840, 4096)),
        "encode_quantize_stereo_sharded interleaved": (
            planes["interleaved"].full().reshape(-1),
            sd.encode_quantize_stereo(img, lut_q)),
        "encode_quantize_stereo_sharded native": (
            planes["native"].full(),
            sd.encode_quantize_stereo(img, lut_q, view_layout="native")),
        "decode_quantize_stereo_sharded interleaved": (
            views["interleaved"].full(),
            sd.decode_quantize_stereo(sd.encode_quantize_stereo(img, lut_q),
                                      lut_q, 3840, 4096)),
        "decode_quantize_stereo_sharded native": (
            views["native"].full(), views["interleaved"].full()),
        "encode_quantize32_ycbcr_sharded": (
            crec.full().reshape(3, -1),
            sd.encode_quantize32_ycbcr(rgb, luma, chroma)),
        "decode_quantize32_ycbcr_sharded": (
            cpix.full(), sd.decode_quantize32_ycbcr(
                crec.full().reshape(3, -1), luma, chroma, 3840, 4096)),
        "encode_quantize32_ycbcr420_sharded": (
            s420, sd.encode_quantize32_ycbcr420(rgb, luma, chroma)),
        "decode_quantize32_ycbcr420_sharded": (
            pix420.full(), sd.decode_quantize32_ycbcr420(s420, luma, chroma,
                                                         3840, 4096)),
        "roundtrip_quantize32_batch": (
            vid.full(), sd.roundtrip_quantize32(video, lut)),
        "encode_quantize32_batch_2d": (
            rec2d.full().reshape(8, -1), sd.encode_quantize32(video[:8], lut)),
    }
    for name, (got, want) in checks.items():
        same = got.shape == want.shape and torch.equal(got, want)
        log(f"  {name}: {tuple(got.shape)} == unsharded api: {same}")
        require(same, f"{name} equals the unsharded api byte for byte")
    for vl, g in planes.items():
        require(g.is_fully_replicated and all(
            torch.equal(r.to(g.shards[0].device), g.shards[0])
            for r in g.shards),
            f"gather=True ({vl}) leaves one identical replica per shard")
    return counts


# -- the dist path across processes (phase 23) --------------------------------

# a worker's time limit, the gathers each form is timed over, and the seed
# every rank draws the same images from
PROCS_LIMIT_S = 240
PROCS_REPS = 25
PROCS_SEED = 23


def procs_images(dev):
    """The same 4096x3840 dual view and 64-frame 1088x1920 batch on every
    rank (a generator of one seed on each rank's card)."""
    g = torch.Generator(device=dev).manual_seed(PROCS_SEED)
    img = torch.randint(0, 256, (4096, 3840), generator=g, dtype=torch.uint8,
                        device=dev)
    video = torch.randint(0, 256, (64, 1088, 1920), generator=g,
                          dtype=torch.uint8, device=dev)
    return img, video


def digest(t: torch.Tensor) -> str:
    import hashlib
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def procs_gather_times(mesh, seg, want) -> dict:
    """``PROCS_REPS`` gathers of the 4K interleaved segments: the call's
    wall and the host's phases (medians); then as many again under
    torch.profiler, for the kernel's device time (the mean over the
    launches it recorded, null where it recorded none: one session, no
    retry, so that every rank makes the same gathers); and the last
    result's exactness."""
    import torch.distributed as tdist
    from torch.profiler import ProfilerActivity, profile
    walls, host = [], []
    tdist.barrier()
    try:
        for _ in range(PROCS_REPS):
            t0 = time.perf_counter()
            out = collectives.gather_planes_remote(seg, mesh)
            walls.append((time.perf_counter() - t0) * 1e3)
            host.append(mesh._collective_workspace.last_host)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROCS_REPS):
                collectives.gather_planes_remote(seg, mesh)
            torch.cuda.synchronize()
        evts = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and "ring_gather" in e.key and e.count > 0]
        recorded = sum(e.count for e in evts)
        res = {"kernel_us": (sum(e.self_device_time_total for e in evts)
                             / recorded if recorded else None),
               "kernel_records": recorded,
               "wall_us": statistics.median(walls) * 1e3,
               "wall_us_max": max(walls) * 1e3,
               "host_us": {k: statistics.median(h[k] for h in host) * 1e6
                           for k in host[0]},
               "exact": torch.equal(out.full().reshape(-1), want),
               "plan": mesh._collective_workspace.last_plan._asdict()}
    except sd.SimdDctError as e:
        res = {"error": str(e)}
    return res


def procs_worker(rank: int, world: int, port: int, devices: list[str],
                 out_path: str) -> int:
    """One rank of phase 23 (``chip_smoke.py --procs-worker RANK ...``):
    bootstrap, the main path across processes, its checks, the gather's
    times, the skipped gather, and the store's host (rank 0) dying: rank 0
    writes its results as JSON in ``out_path`` and exits at once, every
    other rank's next gather must raise, and then it writes its own."""
    import datetime
    import torch.distributed as tdist
    res = {"rank": rank}
    ok = dist.initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}", num_processes=world,
        process_id=rank)
    require(ok and tdist.get_backend() == "gloo",
            "initialize_distributed: a gloo group")
    mesh = dist.make_mesh(world, devices=devices)
    dev = mesh.devices.flat[rank]
    torch.cuda.set_device(dev)
    res["device"] = str(dev)
    lut_q = default_quant_lut(50)
    lut = default_quant_lut(100) * np.float32(255.0)
    img, video = procs_images(dev)
    s_rows, f_rows = 256 // world, 64 // world
    want = {vl: sd.encode_quantize_stereo(img, lut_q, view_layout=vl)
            for vl in ("interleaved", "native")}
    rec_all = sd.encode_quantize32(img, lut).reshape(256, 8 * 3840)
    pix_all = sd.decode_quantize32(rec_all.reshape(-1), lut, 3840, 4096)
    vid_all = sd.roundtrip_quantize32(video, lut)
    torch.cuda.synchronize()
    # the group's collectives are counted: none may carry the card's bytes
    group_calls = {"n": 0}
    for name in ("all_gather", "all_gather_into_tensor", "broadcast",
                 "all_gather_object", "send", "recv", "all_reduce"):
        fn = getattr(tdist, name)

        def counted(*a, _fn=fn, **kw):
            group_calls["n"] += 1
            return _fn(*a, **kw)
        setattr(tdist, name, counted)
    tdist.barrier()
    cuda_dct.reset_launch_counts()
    t0 = time.perf_counter()
    rec = dist.encode_quantize32_sharded(img, lut, mesh)
    pix = dist.decode_quantize32_sharded(rec, lut, 3840, 4096, mesh)
    planes = {vl: dist.encode_quantize_stereo_sharded(
        img, lut_q, mesh, gather=True, view_layout=vl) for vl in want}
    vid = dist.roundtrip_quantize32_batch(video, lut, mesh)
    torch.cuda.synchronize()
    res["main_path_s"] = time.perf_counter() - t0
    counts = dict(cuda_dct.LAUNCHES)
    res["launches"] = counts
    res["group_calls"] = group_calls["n"]
    mine = slice(rank * s_rows, (rank + 1) * s_rows)
    checks = {
        "encode_quantize32_sharded": torch.equal(rec.shards[0],
                                                 rec_all[mine]),
        "decode_quantize32_sharded": torch.equal(
            pix.shards[0], pix_all[rank * 8 * s_rows:
                                   (rank + 1) * 8 * s_rows]),
        "roundtrip_quantize32_batch": torch.equal(
            vid.shards[0], vid_all[rank * f_rows:(rank + 1) * f_rows]),
    }
    for vl, g in planes.items():
        got = g.full()
        checks[f"stereo gather=True {vl}"] = torch.equal(
            got.reshape(want[vl].shape), want[vl])
    res["checks"] = checks
    res["hashes"] = {vl: digest(g.full()) for vl, g in planes.items()}
    res["ipc"] = dict(mesh._collective_workspace.stats)
    # a round trip to the group's store (rank 0's process serves it)
    kv = dist.mesh.store()
    tdist.barrier()
    t0 = time.perf_counter()
    for _ in range(100):
        kv.add(f"smoke/rt/{rank}", 0)
    res["store_round_trip_us"] = (time.perf_counter() - t0) * 1e4
    # the gather's times
    seg = dist.encode_quantize_stereo_sharded(img, lut_q, mesh)
    res["timing"] = procs_gather_times(mesh, seg, want["interleaved"])
    # a skipped gather: the last rank skips it; the others raise within the
    # spin bound plus 1 s; then every rank's next gather is exact
    tdist.barrier()
    skipper = world - 1
    if rank == skipper:
        kv.wait([f"smoke/skip/{r}" for r in range(world - 1)],
                datetime.timedelta(seconds=60))
        res["skip"] = {"skipped": True}
    else:
        t0 = time.perf_counter()
        try:
            collectives.gather_planes_remote(seg, mesh)
            raised = None
        except sd.SimdDctError as e:
            raised = str(e)
        res["skip"] = {"raised": raised,
                       "after_s": time.perf_counter() - t0}
        kv.set(f"smoke/skip/{rank}", b"1")
    fresh = collectives.gather_planes_remote(seg, mesh)
    res["skip"]["fresh_exact"] = torch.equal(fresh.full().reshape(-1),
                                             want["interleaved"])
    res["ipc_end"] = dict(mesh._collective_workspace.stats)
    tdist.barrier()
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)
        sys.stdout.flush()
        os._exit(0)         # the store's host dies, its group unfinished
    time.sleep(0.5)
    t0 = time.perf_counter()
    try:
        collectives.gather_planes_remote(seg, mesh)
        raised = None
    except sd.SimdDctError as e:
        raised = str(e)
    res["host_died"] = {"raised": raised,
                        "after_s": time.perf_counter() - t0}
    with open(out_path, "w") as f:
        json.dump(res, f)
    sys.stdout.flush()
    os._exit(0)             # the group cannot be torn down without rank 0


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_procs(world: int, devices: list[str]) -> list[dict]:
    """Phase 23's workers, one process a rank, killed at ``PROCS_LIMIT_S``;
    their results.  A worker that fails or runs out of time fails the
    phase."""
    import tempfile
    port = free_port()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--procs-worker",
             str(r), "--world", str(world), "--port", str(port),
             "--devices", ",".join(devices), "--out", outs[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        deadline = time.monotonic() + PROCS_LIMIT_S
        texts = []
        try:
            for p in procs:
                left = max(1.0, deadline - time.monotonic())
                try:
                    texts.append(p.communicate(timeout=left)[0])
                except subprocess.TimeoutExpired:
                    texts.append(None)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, (p, text) in enumerate(zip(procs, texts)):
            tail = "" if text is None else text[-3000:]
            log(f"  rank {r} exit {p.returncode}: {tail.strip()[-600:]}")
            require(text is not None,
                    f"worker {r} ended within {PROCS_LIMIT_S} s")
            require(p.returncode == 0, f"worker {r} exited 0:\n{tail}")
        results = []
        for path in outs:
            with open(path) as f:
                results.append(json.load(f))
    return results


def one_process_gather(lut_q, world: int, reps: int, cycles_per_ms) -> dict:
    """The same segments gathered by one process over ``world`` shards of
    card 0 (the gather of phase 10's kind): queued events, profiler and
    call wall."""
    mesh = dist.make_mesh(world, devices=[f"{DEV}:0"] * world)
    img, _ = procs_images(f"{DEV}:0")
    segs = [dist.encode_quantize_stereo_sharded(x, lut_q, mesh)
            for x in (img, img.flip(0), img.flip(1), img.flip(0, 1))]

    def kern(seg):
        return collectives.gather_planes_remote(seg, mesh)

    k_us = queued_ms(kern, segs, reps, cycles_per_ms) * 1e3
    k_prof, _ = profiled_us(kern, segs, match="ring_gather")
    k_wall = wall_ms(kern, segs, reps) * 1e3
    collectives.check_workspace(mesh)
    lib_us = queued_ms(four_cats, segs, reps, cycles_per_ms) * 1e3
    return {"shards": world, "shape": list(segs[0].shards[0].shape),
            "kernel_us": k_us, "kernel_profiler_us": k_prof,
            "wall_us": k_wall, "library_us": lib_us,
            "plan": mesh._collective_workspace.last_plan._asdict()}


def phase_procs(lut_q, devices: list[str]) -> tuple[dict, list[dict]]:
    world = len(devices)
    log(f"phase 23: the dist path across {world} processes ({devices}), a "
        "gloo group on 127.0.0.1")
    results = run_procs(world, devices)
    for r in results:
        log(f"  rank {r['rank']} on {r['device']}: checks {r['checks']}, "
            f"launches ring_gather {r['launches']['ring_gather']}, group "
            f"collectives {r['group_calls']}, IPC {r['ipc_end']}")
        log(f"  rank {r['rank']} gather times: {json.dumps(r['timing'])}")
        log(f"  rank {r['rank']} skipped gather: {r['skip']}")
        for name, ok in r["checks"].items():
            require(ok, f"rank {r['rank']}: {name} equals the unsharded api "
                    "call byte for byte")
        counts = r["launches"]
        require(counts["ring_gather"] == 2,
                f"rank {r['rank']}: one ring_gather launch per gather=True")
        for name in ("enc32", "dec32", "enc_stereo", "roundtrip32"):
            require(counts[name] > 0, f"rank {r['rank']}: {name} launched")
        require(r["group_calls"] == 0,
                "no collective of the process group moved the card's bytes")
        require("error" not in r["timing"] and r["timing"]["exact"],
                f"rank {r['rank']}: the timed gathers are exact")
        if r["rank"] != 0:
            died = r["host_died"]
            log(f"  rank {r['rank']} after the store's host died: {died}")
            require(died["raised"] is not None and "store" in died["raised"]
                    and died["after_s"] < collectives.SPIN_TIMEOUT_S + 1.0,
                    f"rank {r['rank']}: with rank 0 (the store's host) dead "
                    "a gather raises SimdDctError within the spin bound "
                    "plus 1 s")
        if r["skip"].get("skipped"):
            continue
        require(r["skip"]["raised"] is not None and r["skip"]["after_s"]
                < collectives.SPIN_TIMEOUT_S + 1.0,
                f"rank {r['rank']}: a skipped gather raises SimdDctError "
                "within the spin bound plus 1 s")
    for r in results:
        require(r["skip"]["fresh_exact"],
                f"rank {r['rank']}: the gather after the skipped one is "
                "exact")
    for vl in ("interleaved", "native"):
        require(len({r["hashes"][vl] for r in results}) == 1,
                f"every rank gathered the same {vl} bytes")
    one = one_process_gather(lut_q, world, REPS, sleep_cycles_per_ms())
    log(f"  one process, {world} shards of {DEV}:0, the same segments: "
        f"{json.dumps(one)}")
    summary = {"world": world, "devices": devices, "one_process": one,
               "ranks": results}
    return summary, results


# -- the golden tier with a card present (phase 24) ---------------------------

GOLDEN_H, GOLDEN_W = 256, 1920


def phase_golden(gen, lut, lut_q) -> dict:
    """backend="numpy" on a small view against the card's kernels (+-1 on at
    most 0.2% of bytes) and, under compat=True, against the C++ oracle
    exactly; a CUDA tensor under numpy raises; --max-simd none launches no
    kernel and dumps the golden's bytes."""
    import tempfile
    from simd_dct_tpu_torch import cli, native
    log(f"phase 24: the NumPy golden tier (backend='numpy') on a "
        f"{GOLDEN_H}x{GOLDEN_W} view with a card present")
    h, w = GOLDEN_H, GOLDEN_W
    view = random_images(gen, h, w, 1).cpu().numpy()
    errs, seconds = {}, {}

    def golden(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, backend="numpy", **kw)
        seconds[name] = time.perf_counter() - t0
        require(out.device.type == "cpu", f"{name}: a CPU tensor")
        return out

    cases = [("enc-quant32", sd.encode_quantize32, sd.decode_quantize32, lut,
              {}, native.encode_quantize32, native.decode_quantize32),
             ("enc-quant scalar", sd.encode_quantize, sd.decode_quantize,
              lut_q, {"layout": "scalar"}, native.encode_quantize,
              native.decode_quantize),
             ("enc-quant pair", sd.encode_quantize, sd.decode_quantize,
              lut_q, {"layout": "pair"}, native.encode_quantize,
              native.decode_quantize),
             ("stereo", sd.encode_quantize_stereo, sd.decode_quantize_stereo,
              lut_q, {}, native.encode_quantize_stereo,
              native.decode_quantize_stereo)]
    for name, enc, dec, lt, kw, n_enc, n_dec in cases:
        g = golden(f"{name} encode", enc, view, lt, **kw)
        k = enc(view, lt, **kw)
        require(k.device.type == DEV, f"{name}: the card's kernel ran")
        agree(f"golden {name} encode vs the card", k.cpu(), g, errs,
              f"{name} encode")
        gc = golden(f"{name} encode compat", enc, view, lt, compat=True,
                    **kw)
        same = np.array_equal(gc.numpy(), n_enc(view, lt, **kw))
        log(f"  golden {name} encode, compat=True == the C++ oracle: {same}")
        require(same, f"golden {name} compat encode == the oracle exactly")
        dkw = {"layout": kw["layout"]} if "layout" in kw else {}
        rec = k.cpu().numpy()
        gd = golden(f"{name} decode", dec, rec, lt, w, h, **dkw)
        agree(f"golden {name} decode vs the card", dec(rec, lt, w, h, **dkw)
              .cpu(), gd, errs, f"{name} decode")
        gdc = golden(f"{name} decode compat", dec, rec, lt, w, h,
                     compat=True, **dkw)
        same = np.array_equal(gdc.numpy(), n_dec(rec, lt, w, h, **dkw))
        require(same, f"golden {name} compat decode == the oracle exactly")
    rt = golden("roundtrip32", sd.roundtrip_quantize32, view, lut)
    agree("golden roundtrip32 vs the card", sd.roundtrip_quantize32(
        view, lut).cpu(), rt, errs, "roundtrip32")
    try:
        sd.encode_quantize32(torch.from_numpy(view).to(DEV), lut,
                             backend="numpy")
        raised = None
    except sd.NotSupportedError as e:
        raised = str(e)
    log(f"  a CUDA tensor under numpy: {raised!r}")
    require(raised is not None and ".cpu()" in raised,
            "a CUDA tensor under numpy raises NotSupportedError naming .cpu()")
    with tempfile.TemporaryDirectory() as tmp:
        raw, dump = os.path.join(tmp, "view.raw"), os.path.join(tmp, "out")
        view.tofile(raw)
        torch.cuda.synchronize()
        cuda_dct.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rc = cli.main([raw, str(w), str(h), "--runs", "1", "--quality",
                           "50", "--mode", "enc-quant32", "--max-simd",
                           "none", "--to", dump])
        finally:
            capability.set_max_backend("cuda")
        seconds["cli --max-simd none"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launched = sum(cuda_dct.LAUNCHES.values())
        got = np.fromfile(dump, np.uint8)
    want = sd.encode_quantize32(view, default_quant_lut(50)
                                * np.float32(255.0), backend="numpy")
    same = rc == 0 and np.array_equal(got, want.numpy())
    log(f"  cli --max-simd none: exit {rc}, kernels launched {launched}, "
        f"dump == the api's numpy result: {same}")
    require(same and launched == 0,
            "--max-simd none runs the golden, launches no kernel and dumps "
            "its bytes")
    log(f"  golden seconds a call ({h}x{w}): {json.dumps(seconds)}")
    return {"view": [h, w], "seconds": seconds, "max_abs_diff": errs}


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


# quality of each container mode: enc-quant and stereo work in the 1/255
# domain (50), mode32 and colour in the raw domain (100, the BASELINE ladder)
STREAM_QUALITY = {"enc-quant": 50.0, "enc-quant-pair": 50.0,
                  "enc-quant32": 100.0, "enc-quant-stereo": 50.0,
                  "enc-quant32-ycbcr": 100.0, "enc-quant32-ycbcr420": 100.0}
STREAM_PAYLOADS = {"plain": {}, "rle": {"rle": True},
                   "sparse": {"sparse": True}}
# the kernels behind the container: each mode's encode and decode
STREAM_KERNELS = ("enc32", "dec32", "encq", "decq", "enc_stereo",
                  "dec_stereo", "enc32_rgb", "dec32_rgb", "enc420_rgb",
                  "dec420_rgb")
STREAM_REPS = 9


def stream_records(image, mode: str, view_layout: str):
    """The api's records of one container mode and its decode of them, on
    the card (the reference the container must equal byte for byte)."""
    q = STREAM_QUALITY[mode]
    lut = default_quant_lut(q)
    luma, chroma = lut * np.float32(255.0), \
        (BASE_CHROMA_QUANT_TABLE * q * 255.0).astype(np.float32)
    if mode in ("enc-quant", "enc-quant-pair"):
        layout = "pair" if mode.endswith("pair") else "scalar"
        rec = sd.encode_quantize(image, lut, layout=layout)
        return rec, sd.decode_quantize(rec, lut, image.shape[-1],
                                       image.shape[-2], layout=layout)
    if mode == "enc-quant32":
        rec = sd.encode_quantize32(image, luma)
        return rec, sd.decode_quantize32(rec, luma, image.shape[-1],
                                         image.shape[-2])
    if mode == "enc-quant-stereo":
        rec = sd.encode_quantize_stereo(image, lut, view_layout=view_layout)
        return rec, sd.decode_quantize_stereo(rec, lut, image.shape[-1],
                                              image.shape[-2],
                                              view_layout=view_layout)
    if mode == "enc-quant32-ycbcr":
        rec = sd.encode_quantize32_ycbcr(image, luma, chroma)
        return rec, sd.decode_quantize32_ycbcr(rec, luma, chroma,
                                               image.shape[-1],
                                               image.shape[-2])
    rec = sd.encode_quantize32_ycbcr420(image, luma, chroma)
    return rec, sd.decode_quantize32_ycbcr420(rec, luma, chroma,
                                              image.shape[-1],
                                              image.shape[-2])


def check_payload(tag: str, payload: np.ndarray, rec: torch.Tensor) -> None:
    """The host decompress gives the records; the device route gives the
    host's bytes."""
    want = rec.reshape(-1)
    host = entropy.decompress(payload)
    require(np.array_equal(host, want.cpu().numpy()),
            f"{tag}: decompress == the api's records")
    dev = entropy.decompress_to_device(payload)
    require(dev.device.type == DEV and torch.equal(dev, want),
            f"{tag}: decompress_to_device == decompress")


def phase_compressed_stream(gen):
    log("phase 21: the compressed stream on the card (.sdt / .sdtv "
        "containers, numpy inputs, no device)")
    view = smooth_image(gen, 4096, 3840).cpu().numpy()
    # (3, 2048, 3840) planes of the gate input's smooth correlated field
    rgb = np.ascontiguousarray(gate_rgb(2048, 3840)[:, :2048])
    frames = torch.stack([smooth_image(gen, 1088, 1920)
                          for _ in range(8)]).cpu().numpy()
    cases = [("enc-quant", "interleaved", view),
             ("enc-quant-pair", "interleaved", view),
             ("enc-quant32", "interleaved", view)] + [
        ("enc-quant-stereo", vl, view) for vl in VIEW_LAYOUTS] + [
        ("enc-quant32-ycbcr", "interleaved", rgb),
        ("enc-quant32-ycbcr420", "interleaved", rgb)]
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    sdt = {}
    for mode, vl, image in cases:
        for name, kw in STREAM_PAYLOADS.items():
            blob = container.encode(image, mode,
                                    quality=STREAM_QUALITY[mode],
                                    view_layout=vl, **kw)
            sdt[mode, vl, name] = (blob, container.decode(blob))
    sdtv = {}
    for name, kw in STREAM_PAYLOADS.items():
        blob = container.encode_video(frames, "enc-quant32",
                                      quality=STREAM_QUALITY["enc-quant32"],
                                      **kw)
        sdtv[name] = (blob, container.decode_video(blob),
                      container.decode_video_frame(blob, 5))
    torch.cuda.synchronize()
    counts = dict(cuda_dct.LAUNCHES)
    log(f"  launches: {counts}")
    for name in STREAM_KERNELS:
        require(counts[name] > 0, f"{name} launched on the stream path")

    ratios = {}
    for mode, vl, image in cases:
        rec, ref = stream_records(torch.from_numpy(image).to(DEV), mode, vl)
        host = rec.reshape(-1).cpu().numpy()
        for name in STREAM_PAYLOADS:
            blob, out = sdt[mode, vl, name]
            tag = f"{mode} {vl} {name}"
            require(out.device.type == DEV and torch.equal(out, ref),
                    f"{tag}: container decode == api decode of the records")
            payload, meta = container.unpack(blob)
            require(meta.packed and meta.mode == mode, f"{tag}: header")
            check_payload(tag, payload, rec)
            ratios[f"{mode} {vl} {name}"] = host.size / payload.size
        dense = entropy.compress_dense(rec)
        require(np.array_equal(dense, entropy.compress_dense(host)),
                f"{mode} {vl}: the device split gives the host split's bytes")
        check_payload(f"{mode} {vl} dense", dense, rec)
        ratios[f"{mode} {vl} dense"] = host.size / dense.size
        require(np.array_equal(entropy.histogram(rec),
                               entropy.histogram(host, device=False)),
                f"{mode} {vl}: device histogram == native histogram")
        log(f"  {mode} {vl}: {host.size} record bytes, ratio plain "
            f"{ratios[f'{mode} {vl} plain']:.3f} rle "
            f"{ratios[f'{mode} {vl} rle']:.3f} sparse "
            f"{ratios[f'{mode} {vl} sparse']:.3f} dense (SDN1 "
            f"{dense[:4].tobytes() == b'SDN1'}) "
            f"{ratios[f'{mode} {vl} dense']:.3f}; decodes exact")
    rec, ref = stream_records(torch.from_numpy(frames).to(DEV),
                              "enc-quant32", "interleaved")
    for name, (blob, out, frame5) in sdtv.items():
        require(out.shape == (8, 544, 1920) and torch.equal(out, ref),
                f"sdtv {name}: decode_video == api decode of the records")
        require(torch.equal(frame5, ref[5]),
                f"sdtv {name}: decode_video_frame(5) == frame 5")
        ratios[f"sdtv {name}"] = rec.numel() / blob.size
    log(f"  8x1088x1920 .sdtv: ratio " + " ".join(
        f"{k[5:]} {v:.3f}" for k, v in ratios.items() if k[:4] == "sdtv")
        + "; decode_video and decode_video_frame exact")
    return counts, ratios


def stream_wall_ms(fn, reps: int = STREAM_REPS) -> float:
    """Median host wall of ``fn()`` up to a synchronise, in ms, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def stream_stages(gen, smi: str) -> dict:
    """Stage walls of the 4K enc-quant32 stream: each stage apart, then the
    container's encode and decode whole, for the plain, rle, sparse and
    SDN1 payloads."""
    lut = default_quant_lut(100) * np.float32(255.0)
    img = smooth_image(gen, 4096, 3840)
    rec = sd.encode_quantize32(img, lut)
    host = rec.cpu().numpy()
    lengths = entropy.build_lengths(entropy.histogram(rec))
    k = entropy.default_chunks(host.size)
    blobs = {"plain": entropy.compress(host, lengths, streams=k),
             "rle": entropy.compress(host, rle=True),
             "sparse": entropy.compress_sparse(rec),
             "dense": entropy.compress_dense(rec)}
    st = {
        "kernel": stream_wall_ms(lambda: sd.encode_quantize32(img, lut)),
        "device_histogram": stream_wall_ms(lambda: entropy.histogram(rec)),
        # the same 256 counts by torch.bincount, which entropy.histogram
        # ran before it took histogram_tensor's sort
        "device_histogram_bincount": stream_wall_ms(
            lambda: torch.bincount(rec.reshape(-1), minlength=256).cpu()),
        "device_to_host": stream_wall_ms(lambda: rec.cpu()),
        "host_pack": stream_wall_ms(
            lambda: entropy.compress(host, lengths, streams=k)),
        "unpack": stream_wall_ms(lambda: entropy.decompress(blobs["plain"])),
        "host_to_device": stream_wall_ms(
            lambda: torch.as_tensor(host, device=DEV)),
        "decode": stream_wall_ms(
            lambda: sd.decode_quantize32(rec, lut, 3840, 4096)),
        "rle_pack": stream_wall_ms(lambda: entropy.compress(host, rle=True)),
        "rle_unpack": stream_wall_ms(
            lambda: entropy.decompress(blobs["rle"])),
        "sparse_compress": stream_wall_ms(
            lambda: entropy.compress_sparse(rec)),
        "sparse_expand": stream_wall_ms(
            lambda: entropy.decompress_to_device(blobs["sparse"])),
        "dense_compress": stream_wall_ms(
            lambda: entropy.compress_dense(rec)),
        "dense_expand": stream_wall_ms(
            lambda: entropy.decompress_to_device(blobs["dense"])),
    }
    for name, kw in STREAM_PAYLOADS.items():
        blob = container.encode(img, "enc-quant32", quality=100.0, **kw)
        st[f"container_encode_{name}"] = stream_wall_ms(
            lambda: container.encode(img, "enc-quant32", quality=100.0, **kw))
        st[f"container_decode_{name}"] = stream_wall_ms(
            lambda: container.decode(blob))
    ratio = {name: host.size / b.size for name, b in blobs.items()}
    log(f"  4K enc-quant32 stream stages, ms (median of {STREAM_REPS} "
        f"walls), on {smi}: " + ", ".join(f"{n} {v:.4f}"
                                          for n, v in st.items()))
    log(f"  4K enc-quant32 compression ratio: " + ", ".join(
        f"{n} {v:.4f}" for n, v in ratio.items()) + f" ({k} chunks)")
    return {"card": smi, "ms": st, "ratio": ratio, "chunks": k}


# ---------------------------------------------------------------------------
# phase 22: the serving surfaces (cli, container command, feed, rd)
# ---------------------------------------------------------------------------

# the kernels of every mode the command line runs, the feed's and the
# sharded stereo path's gather
SERVE_KERNELS = ("enc32", "dec32", "roundtrip32", "encq", "decq",
                 "enc_stereo", "dec_stereo", "enc32_rgb", "dec32_rgb",
                 "enc420_rgb", "dec420_rgb", "ring_gather")
SERVE_FRAMES = 32
SERVE_PASSES = 5            # timed passes of each stream and of its loop
SERVE_DISTINCT = 8          # distinct frames, cycled (126 MB of host data)
SERVE_DEPTHS = (1, 2, 4)
SERVE_RD_QUALITIES = (50.0, 100.0, 200.0)
SERVE_H, SERVE_W = 4096, 3840
# each command-line mode's encode and decode kernels (``--decode``)
CLI_MODES = {"enc-quant": ("encq", "decq"),
             "enc-quant32": ("enc32", "dec32"),
             "enc-quant-stereo": ("enc_stereo", "dec_stereo"),
             "enc-quant32-ycbcr": ("enc32_rgb", "dec32_rgb"),
             "enc-quant32-ycbcr420": ("enc420_rgb", "dec420_rgb")}
# the kernels of the feed's streams and of the rd sweep's two modes
FEED_RD_KERNELS = ("enc32", "dec32", "roundtrip32", "enc420_rgb",
                   "dec420_rgb")


def run_modules(arg_lists, timeout=300) -> list[str]:
    """``python -m <args>`` for each argument list, all started together
    from the repository's root: each exit code must be 0; returns their
    standard outputs in order.  A process still running at ``timeout``
    seconds is killed."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", *args], cwd=root,
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for args in arg_lists]
    outs = []
    try:
        for args, proc in zip(arg_lists, procs):
            left = max(1.0, timeout - (time.perf_counter() - t0))
            out, err = proc.communicate(timeout=left)
            require(proc.returncode == 0,
                    f"python -m {' '.join(args[:1])} exits 0 "
                    f"(rc {proc.returncode}: {err[-2000:]})")
            log(f"  python -m {' '.join(os.path.basename(a) for a in args)}"
                f": {time.perf_counter() - t0:.2f} s")
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return outs


def run_module(args, timeout=300):
    """``python -m <args>`` from the repository's root: its exit code must
    be 0; returns its standard output."""
    return run_modules([args], timeout)[0]


def cli_rows(text: str) -> list[str]:
    """The statistics rows a command printed (codec | ...)."""
    return [ln.strip() for ln in text.splitlines()
            if " | " in ln and not ln.startswith("codec")]


def serve_api_records(mode, view, rgb, lut_q, layout="scalar",
                      view_layout="interleaved"):
    """The api's records for one command-line mode at quality 50, on the
    card, as host bytes."""
    if mode == "enc-quant":
        rec = sd.encode_quantize(view, lut_q, layout=layout)
    elif mode == "enc-quant32":
        rec = sd.encode_quantize32(view, lut_q * np.float32(255.0))
    elif mode == "enc-quant-stereo":
        rec = sd.encode_quantize_stereo(view, lut_q, view_layout=view_layout)
    else:
        chroma = BASE_CHROMA_QUANT_TABLE * 50.0 * 255.0
        fn = (sd.encode_quantize32_ycbcr420 if mode.endswith("420")
              else sd.encode_quantize32_ycbcr)
        rec = fn(rgb, lut_q * np.float32(255.0), chroma)
    return rec.reshape(-1).cpu().numpy()


def serve_cli(tmp, view, rgb, serve) -> dict:
    """The command line at 4096x3840: every mode in-process through
    ``cli.main`` (dumps against the api, the launch counts), then the
    ``python -m`` runs and the container command.  Returns the launches
    made inside the ``cli.main`` calls, each of which must launch its
    mode's kernels (and the gather, sharded stereo)."""
    import contextlib
    import io

    from simd_dct_tpu_torch import cli

    gray_path = os.path.join(tmp, "view.raw")
    rgb_path = os.path.join(tmp, "rgb.raw")
    view.tofile(gray_path)
    rgb.tofile(rgb_path)
    lut_q = default_quant_lut(50)
    view_d = torch.from_numpy(view).to(DEV)
    rgb_d = torch.from_numpy(rgb).to(DEV)
    geo = [str(SERVE_W), str(SERVE_H)]
    base = ["--runs", "16", "--quality", "50", "--decode"]
    cases = [(m, [], {}) for m in CLI_MODES] + [
        ("enc-quant", ["--layout", "pair"], {"layout": "pair"}),
        ("enc-quant-stereo", ["--stereo-layout", "native"],
         {"view_layout": "native"}),
        ("enc-quant32", ["--sharded", "4", "--device", "cuda:0"], {}),
        ("enc-quant-stereo", ["--sharded", "4", "--device", "cuda:0"], {})]
    rows = {}
    counts = dict.fromkeys(cuda_dct.LAUNCHES, 0)
    for k, (mode, extra, kw) in enumerate(cases):
        out = os.path.join(tmp, f"cli{k}.raw")
        text = io.StringIO()
        torch.cuda.synchronize()
        before = dict(cuda_dct.LAUNCHES)
        with contextlib.redirect_stdout(text):
            rc = cli.main([rgb_path, *geo, *base, "--mode", mode, *extra,
                           "--to", out])
        require(rc == 0, f"cli.main {mode} {extra} exits 0")
        torch.cuda.synchronize()
        ran = {n: cuda_dct.LAUNCHES[n] - before[n] for n in counts}
        want_kernels = CLI_MODES[mode] + (
            ("ring_gather",) if mode == "enc-quant-stereo"
            and "--sharded" in extra else ())
        for name in want_kernels:
            require(ran[name] > 0,
                    f"cli.main {mode} {extra} launched {name}")
        for name, n in ran.items():
            counts[name] += n
        want = serve_api_records(mode, view_d, rgb_d, lut_q, **kw)
        require(np.array_equal(np.fromfile(out, np.uint8), want),
                f"cli {mode} {extra}: dump == the api's records")
        rows[" ".join([mode, *extra])] = cli_rows(text.getvalue())
    log(f"  cli.main: {len(cases)} runs, every dump equal to the api's "
        f"records, each mode's kernels launched; launches {counts}")

    # the module entry points, each in a process of its own
    sdt = os.path.join(tmp, "out.sdt")
    text = run_module(["simd_dct_tpu_torch.cli", rgb_path, *geo, *base,
                       "--compress", "--to", sdt])
    rows["all modes --compress"] = cli_rows(text)
    text = run_module(["simd_dct_tpu_torch.cli", rgb_path, *geo, "--runs",
                       "16", "--quality", "50", "--mode", "enc-quant32",
                       "--accurate"])
    rows["enc-quant32 --accurate"] = cli_rows(text)
    require(any("(slope)" in r for r in rows["enc-quant32 --accurate"]),
            "--accurate prints the slope row")
    sharded = os.path.join(tmp, "sharded.raw")
    text = run_module(["simd_dct_tpu_torch.cli", rgb_path, *geo, *base,
                       "--mode", "enc-quant32", "--mode", "enc-quant-stereo",
                       "--sharded", "4", "--device", "cuda:0", "--to",
                       sharded])
    rows["sharded 4 on cuda:0"] = cli_rows(text)
    require(np.array_equal(
        np.fromfile(sharded, np.uint8),
        serve_api_records("enc-quant-stereo", view_d, rgb_d, lut_q)),
        "python -m cli --sharded 4: dump == the api's stereo records")
    info = run_module(["simd_dct_tpu_torch.container", "info", sdt])
    require(f"mode=enc-quant32-ycbcr420 size={SERVE_W}x{SERVE_H}" in info,
            f"container info names the last mode: {info.strip()}")
    dec = os.path.join(tmp, "out.dec")
    run_module(["simd_dct_tpu_torch.container", "decode", sdt, dec])
    luma = default_quant_lut(50) * np.float32(255.0)
    chroma = BASE_CHROMA_QUANT_TABLE * 50.0 * 255.0
    want = sd.decode_quantize32_ycbcr420(
        sd.encode_quantize32_ycbcr420(rgb_d, luma, chroma), luma, chroma,
        SERVE_W, SERVE_H).reshape(-1).cpu().numpy()
    blob = np.fromfile(sdt, np.uint8)
    require(np.array_equal(np.fromfile(dec, np.uint8), want),
            "python -m container decode out.sdt == the api decode")
    require(torch.equal(container.decode(blob).reshape(-1).cpu(),
                        torch.from_numpy(want)),
            "container.decode(out.sdt) == the api decode")
    for name, r in rows.items():
        for line in r:
            log(f"  cli [{name}] {line}")
    serve["cli_rows"] = rows
    return counts


def intervals_len(iv) -> float:
    return sum(b - a for a, b in iv)


def union(iv):
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def intersect(x, y):
    """Intersection of two sorted unions of intervals."""
    out, i, j = [], 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if a < b:
            out.append([a, b])
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return out


def trace_shares(path: str) -> dict | None:
    """Device idle share over the window annotated ``serve_window`` and the
    overlap of copies and kernels, from a Chrome trace of torch.profiler;
    None when it holds no device activity."""
    with open(path) as f:
        tr = json.load(f)
    evs = tr["traceEvents"] if isinstance(tr, dict) else tr
    win = [e for e in evs if e.get("name") == "serve_window"
           and e.get("cat") == "user_annotation"]
    evs = [e for e in evs if "dur" in e and "ts" in e]
    kern = [[e["ts"], e["ts"] + e["dur"]] for e in evs
            if e.get("cat") == "kernel"]
    copies = [e for e in evs if e.get("cat") == "gpu_memcpy"]
    if not win or not kern:
        return None
    w = [[win[0]["ts"], win[0]["ts"] + win[0]["dur"]]]
    span = w[0][1] - w[0][0]
    cp = [[e["ts"], e["ts"] + e["dur"]] for e in copies]
    h2d = union([[e["ts"], e["ts"] + e["dur"]] for e in copies
                 if "HtoD" in e.get("name", "")])
    d2h = union([[e["ts"], e["ts"] + e["dur"]] for e in copies
                 if "DtoH" in e.get("name", "")])
    other = [[e["ts"], e["ts"] + e["dur"]] for e in evs
             if e.get("cat") == "gpu_memset"]
    busy = intersect(union(kern + cp + other), w)
    k, c = intersect(union(kern), w), intersect(union(cp), w)
    return {"window_ms": span / 1e3,
            "idle_share": 1 - intervals_len(busy) / span,
            "kernel_share": intervals_len(k) / span,
            "copy_share": intervals_len(c) / span,
            "kernel_time_under_a_copy": (intervals_len(intersect(k, c))
                                         / max(intervals_len(k), 1e-9)),
            "h2d_time_under_a_d2h": (intervals_len(intersect(h2d, d2h))
                                     / max(intervals_len(h2d), 1e-9)),
            "kernels": len(kern), "copies": len(copies)}


def pass_rate(fn) -> tuple[float, float]:
    """(frames a second, the process's CPU ms a frame) of one pass of the
    stream ``fn()``, each result dropped as it comes (as a server that
    writes it out)."""
    torch.cuda.synchronize()
    c0, t0 = time.process_time(), time.perf_counter()
    n = sum(1 for _ in fn())
    torch.cuda.synchronize()
    return (n / (time.perf_counter() - t0),
            (time.process_time() - c0) / n * 1e3)


def stream_fps(fn, cpu_ms: dict, key: str,
               passes: int = SERVE_PASSES) -> float:
    """Median frames a second of ``passes`` runs of the stream ``fn()``;
    the median CPU ms a frame goes to ``cpu_ms[key]``."""
    runs = [pass_rate(fn) for _ in range(passes)]
    cpu_ms[key] = statistics.median(c for _, c in runs)
    return statistics.median(r for r, _ in runs)


def paired_fps(stream, loop, cpu_ms: dict, key: str,
               passes: int = SERVE_PASSES) -> tuple[float, float, float]:
    """The stream ``stream()`` and its synchronised loop ``loop()`` timed in
    turns, ``passes`` runs each (the stream first on even passes, the loop
    first on odd ones, so a drift of the shared host's speed falls on
    both): the median frames a second of each and the median of the
    passes' ratios stream / loop.  The stream's median CPU ms a frame goes
    to ``cpu_ms[key]``, the loop's to ``cpu_ms[key + "_sync_loop"]``."""
    runs = {stream: [], loop: []}
    for p in range(passes):
        for fn in ((stream, loop) if p % 2 == 0 else (loop, stream)):
            runs[fn].append(pass_rate(fn))
    cpu_ms[key] = statistics.median(c for _, c in runs[stream])
    cpu_ms[key + "_sync_loop"] = statistics.median(c for _, c in runs[loop])
    return (statistics.median(r for r, _ in runs[stream]),
            statistics.median(r for r, _ in runs[loop]),
            statistics.median(a[0] / b[0]
                              for a, b in zip(runs[stream], runs[loop])))


def pack_ms(prep, lengths) -> float:
    """Median ms of ``entropy.compress(prep(k), lengths)`` over the distinct
    frames, twice round; ``prep`` runs outside the wall."""
    walls = []
    for i in range(2 * SERVE_DISTINCT):
        src = prep(i % SERVE_DISTINCT)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        entropy.compress(src, lengths)
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def pack_beside_copy_ms(recs, frames, lengths, dst) -> float:
    """Median ms of a pack of each distinct frame's records while the next
    frame is copied into ``dst`` on the feed's staging thread, up to the
    end of both, twice round."""
    from simd_dct_tpu_torch.utils import feed
    worker = feed._staging_worker()
    walls = []
    for i in range(2 * SERVE_DISTINCT):
        k = i % SERVE_DISTINCT
        t0 = time.perf_counter()
        copying = worker.submit(np.copyto, dst,
                                frames[(k + 1) % SERVE_DISTINCT])
        entropy.compress(recs[k], lengths)
        copying.result()
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls) * 1e3


def loop_fps(fn, items) -> float:
    """Frames a second of ``fn`` on each item, synchronised at the end."""
    fn(items[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in items:
        fn(x)
    torch.cuda.synchronize()
    return len(items) / (time.perf_counter() - t0)


def host_stage_ms(stream, owner, attr) -> dict:
    """One pass of ``stream(2)`` with ``owner.attr`` timed on each call:
    the wall a frame and the time a frame spent in that host stage."""
    orig = getattr(owner, attr)
    spent = [0.0, 0]

    def timed_call(*a, **kw):
        t0 = time.perf_counter()
        try:
            return orig(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t0
            spent[1] += 1

    setattr(owner, attr, timed_call)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(list(stream(2)))
        wall = time.perf_counter() - t0
    finally:
        setattr(owner, attr, orig)
    return {"stage": f"{getattr(owner, '__name__', owner)}.{attr}",
            "wall_ms": wall / n * 1e3, "stage_ms": spent[0] / n * 1e3,
            "calls": spent[1], "frames": n}


def serve_feed(gen, lut, tmp, serve):
    """The feed on 32 frames of 4096x3840: each stream at each depth
    against the per-frame api calls, its frames a second beside a loop of
    api calls synchronised after each frame and bare copies of the same
    bytes, and one profiled run of the loop."""
    from simd_dct_tpu_torch.utils import feed

    distinct_d = [smooth_image(gen, SERVE_H, SERVE_W)
                  for _ in range(SERVE_DISTINCT)]
    distinct = [f.cpu().numpy() for f in distinct_d]
    frames = [distinct[i % SERVE_DISTINCT] for i in range(SERVE_FRAMES)]
    rt_ref = [sd.roundtrip_quantize32(f, lut).cpu().numpy()
              for f in distinct_d]
    rec_d = [sd.encode_quantize32(f, lut) for f in distinct_d]
    rec_ref = [r.reshape(-1).cpu().numpy() for r in rec_d]
    dec_ref = [sd.decode_quantize32(r, lut, SERVE_W, SERVE_H).cpu().numpy()
               for r in rec_d]
    blobs = {}

    def check(kind, outs):
        require(len(outs) == SERVE_FRAMES, f"{kind}: every frame came back")
        for i, out in enumerate(outs):
            k = i % SERVE_DISTINCT
            if kind == "roundtrip":
                ok = np.array_equal(out, rt_ref[k])
            elif kind.startswith("encode"):
                ok = np.array_equal(entropy.decompress(out), rec_ref[k])
            else:
                ok = np.array_equal(out, dec_ref[k])
            require(ok, f"{kind} frame {i} == the per-frame api call")

    streams = {
        "roundtrip": lambda d: feed.stream_roundtrip32(frames, lut, depth=d),
        "encode": lambda d: feed.stream_encode32_compressed(frames, lut,
                                                            depth=d),
        "encode_sparse": lambda d: feed.stream_encode32_compressed(
            frames, lut, depth=d, sparse=True),
        "decode": lambda d: feed.stream_decode32_compressed(
            blobs["encode"], lut, SERVE_W, SERVE_H, depth=d),
    }
    # the same work as loops of api calls, synchronised after each frame
    def sync_encode():
        """The stream's codec one frame at a time: the shared table, rebuilt
        when a frame holds a symbol it lacks (decided, as the feed does,
        from the frame's histogram before the pack)."""
        lengths = None
        for fr in frames:
            rec = sd.encode_quantize32(fr, lut)
            hist = entropy.histogram(rec)
            rec = rec.cpu().numpy()
            if lengths is None or hist[lengths == 0].any():
                lengths = entropy.build_lengths(hist)
            yield entropy.compress(rec, lengths)

    sync = {
        "roundtrip": lambda: (sd.roundtrip_quantize32(fr, lut).cpu().numpy()
                              for fr in frames),
        "encode": sync_encode,
        "encode_sparse": lambda: (entropy.compress_sparse(
            sd.encode_quantize32(fr, lut)) for fr in frames),
        "decode": lambda: (sd.decode_quantize32(
            entropy.decompress_to_device(b), lut, SERVE_W,
            SERVE_H).cpu().numpy() for b in blobs["encode"]),
    }
    fps, cpu_ms, ratio = {}, {}, {}
    for kind, stream in streams.items():
        # at each depth a checked pass, whose held results also fill
        # torch's page-locked cache, then the timed passes (steady state),
        # in turns with the synchronised loop
        for d in SERVE_DEPTHS:
            outs = list(stream(d))
            check(kind, outs)
            if kind.startswith("encode") and d == 2:
                blobs[kind] = outs
            outs = None
            if d == SERVE_DEPTHS[0]:
                check(f"{kind} synchronised loop", list(sync[kind]()))
            key = f"{kind}_depth{d}"
            fps[key], fps[f"{kind}_sync_loop_depth{d}"], ratio[key] = \
                paired_fps(lambda: stream(d), sync[kind], cpu_ms, key)
        fps[f"{kind}_sync_loop"] = statistics.median(
            fps[f"{kind}_sync_loop_depth{d}"] for d in SERVE_DEPTHS)
    # each frame packed with its own table (no shared table, no rebuild)
    own = lambda: feed.stream_encode32_compressed(frames, lut, depth=2,
                                                  shared_table=False)
    check("encode, own tables", list(own()))
    fps["encode_own_table_depth2"] = stream_fps(
        own, cpu_ms, "encode_own_table_depth2")
    sparse_dec = list(feed.stream_decode32_compressed(
        blobs["encode_sparse"], lut, SERVE_W, SERVE_H, depth=2))
    check("decode of the sparse streams", sparse_dec)
    del sparse_dec

    # the host's share of each stream at depth 2: the time spent in its
    # host stage (the staging copy, the coder), summed over the frames
    share = {}
    for kind, (owner, attr) in {
            "roundtrip": (feed._Staging, "fill"),
            "encode": (entropy, "compress"),
            "encode_sparse": (entropy, "compress_sparse"),
            "decode": (entropy, "decompress_to_device")}.items():
        share[kind] = host_stage_ms(streams[kind], owner, attr)
    # a table that covers every distinct frame's symbols
    lengths = entropy.build_lengths(
        sum(np.bincount(r, minlength=256) for r in rec_ref))

    # bare copies of the same bytes, and the host stages of the feed
    dev_in = torch.empty((SERVE_H, SERVE_W), dtype=torch.uint8, device=DEV)
    pinned = torch.empty((SERVE_H, SERVE_W), dtype=torch.uint8,
                         pin_memory=True)
    pinned.copy_(torch.from_numpy(frames[0]))
    top = torch.empty((SERVE_H // 2, SERVE_W), dtype=torch.uint8, device=DEV)
    pinned_top = torch.empty(top.shape, dtype=torch.uint8, pin_memory=True)
    rec_pinned = torch.empty(rec_ref[0].shape, dtype=torch.uint8,
                             pin_memory=True)
    fps["h2d_pinned_copy"] = loop_fps(
        lambda _: dev_in.copy_(pinned, non_blocking=True), frames)
    fps["h2d_pageable_copy"] = loop_fps(
        lambda fr: dev_in.copy_(torch.from_numpy(fr), non_blocking=True),
        frames)
    fps["d2h_pinned_copy_of_a_top_view"] = loop_fps(
        lambda _: pinned_top.copy_(top, non_blocking=True), frames)
    stage_ms = {
        "staging_torch_copy": 1e3 / loop_fps(
            lambda fr: pinned.copy_(torch.from_numpy(fr)), frames),
        "staging_numpy_copyto": 1e3 / loop_fps(
            lambda fr: np.copyto(pinned.numpy(), fr), frames),
        "host_pack": stream_wall_ms(
            lambda: entropy.compress(rec_ref[1], lengths)),
        # the same pack on each distinct frame's records in turn: as they
        # come from numpy, from a page-locked buffer just written by a
        # download, right after a staging copy by torch's threads, and
        # beside the encode streams' staging copy on its thread (the wall
        # of both)
        "host_pack_each_frame": pack_ms(lambda k: rec_ref[k], lengths),
        "host_pack_after_download": pack_ms(
            lambda k: rec_pinned.copy_(rec_d[k].reshape(-1)).numpy(),
            lengths),
        "host_pack_after_staging_copy": pack_ms(
            lambda k: (pinned.copy_(torch.from_numpy(frames[k])),
                       rec_ref[k])[1], lengths),
        "host_pack_beside_staging_copy": pack_beside_copy_ms(
            rec_ref, frames, lengths, pinned.numpy()),
        "host_unpack": stream_wall_ms(
            lambda: entropy.decompress(blobs["encode"][1])),
        "decompress_to_device": stream_wall_ms(
            lambda: entropy.decompress_to_device(blobs["encode"][1])),
        "sparse_compress": stream_wall_ms(
            lambda: entropy.compress_sparse(rec_d[1])),
    }
    for name in ("h2d_pinned_copy", "h2d_pageable_copy",
                 "d2h_pinned_copy_of_a_top_view"):
        stage_ms[name] = 1e3 / fps[name]
    del dev_in, pinned, top, pinned_top, rec_pinned

    # one profiled run of the loop: the device's idle share and the overlap
    trace = {}
    for kind in ("roundtrip", "encode"):
        from torch.profiler import ProfilerActivity, profile, record_function
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function("serve_window"):
                n = sum(1 for _ in streams[kind](2))
        require(n == SERVE_FRAMES, f"profiled {kind}: every frame came back")
        path = os.path.join(tmp, f"{kind}.trace.json")
        prof.export_chrome_trace(path)
        trace[kind] = trace_shares(path)
        log(f"  profiled {kind} stream, depth 2: {trace[kind]}")
    for kind in streams:
        log(f"  {kind}, medians of {SERVE_PASSES} passes of {SERVE_FRAMES} "
            "frames in turns with its synchronised api loop: frames/s at "
            "depth " + ", ".join(
                f"{d} {fps[f'{kind}_depth{d}']:.2f} (loop "
                f"{fps[f'{kind}_sync_loop_depth{d}']:.2f}, ratio "
                f"{ratio[f'{kind}_depth{d}']:.3f})" for d in SERVE_DEPTHS)
            + "; CPU ms a frame " + ", ".join(
                f"{cpu_ms[f'{kind}_depth{d}']:.2f} (loop "
                f"{cpu_ms[f'{kind}_depth{d}_sync_loop']:.2f})"
                for d in SERVE_DEPTHS))
    log(f"  encode with a table a frame, depth 2: "
        f"{fps['encode_own_table_depth2']:.2f} frames/s")
    log("  bare copies, frames/s: " + ", ".join(
        f"{k} {fps[k]:.2f}" for k in ("h2d_pinned_copy", "h2d_pageable_copy",
                                      "d2h_pinned_copy_of_a_top_view")))
    log("  stages, ms a frame: " + ", ".join(
        f"{k} {v:.4f}" for k, v in stage_ms.items()))
    log("  depth 2, ms a frame (wall / in the host stage): " + ", ".join(
        f"{k} {v['wall_ms']:.4f} / {v['stage_ms']:.4f} ({v['stage']}, "
        f"{v['calls']} calls for {v['frames']} frames)"
        for k, v in share.items()))
    serve.update({"fps": fps, "cpu_ms": cpu_ms, "stage_ms": stage_ms,
                  "fps_ratio_to_sync_loop": ratio,
                  "trace": trace,
                  "host_stage_share": share})


def serve_rd(view, rgb, serve):
    """rd_curve on the card against the same sweep on the host's plain
    version: PSNR within 0.1 dB, rate within 0.2% (the +-1 contract moves
    at most 0.2% of the record bytes by one)."""
    from simd_dct_tpu_torch.bench import rd
    points = {}
    for mode, img in (("enc-quant32", view), ("enc-quant32-ycbcr420", rgb)):
        card = rd.rd_curve(img, SERVE_RD_QUALITIES, mode=mode)
        host = rd.rd_curve(img, SERVE_RD_QUALITIES, mode=mode, device="cpu")
        for c, h in zip(card, host):
            require(abs(c.psnr_db - h.psnr_db) < 0.1,
                    f"rd {mode} q={c.quality}: PSNR within 0.1 dB")
            require(abs(c.bits_per_px - h.bits_per_px)
                    <= 0.002 * h.bits_per_px,
                    f"rd {mode} q={c.quality}: rate within 0.2%")
            log(f"  rd {mode} card {c.row()} | plain {h.row()}")
        points[mode] = [[c.quality, c.bits_per_px, c.psnr_db, h.bits_per_px,
                         h.psnr_db] for c, h in zip(card, host)]
    serve["rd"] = points


def phase_serve(gen, lut100):
    log("phase 22: the serving surfaces on the card (command line, "
        "container command, feed, rd sweep)")
    import tempfile
    serve = {}
    view = smooth_image(gen, SERVE_H, SERVE_W).cpu().numpy()
    rgb = np.clip(np.stack([view, view * 0.9 + 12, view * 0.8 + 25]), 0,
                  255).astype(np.uint8)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        cli_counts = serve_cli(tmp, view, rgb, serve)
        serve["cli_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        cuda_dct.reset_launch_counts()
        t0 = time.perf_counter()
        serve_feed(gen, lut100, tmp, serve)
        serve["feed_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        serve_rd(view, rgb, serve)
        serve["rd_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        feed_counts = dict(cuda_dct.LAUNCHES)
    log(f"  launches of the feed and the rd sweep: {feed_counts}")
    for name in FEED_RD_KERNELS:
        require(feed_counts[name] > 0,
                f"{name} launched by the feed and the rd sweep")
    counts = {n: cli_counts[n] + feed_counts[n] for n in feed_counts}
    for name in SERVE_KERNELS:
        require(counts[name] > 0, f"{name} launched on the serving path")
    return counts, serve


# ---------------------------------------------------------------------------
# phase 25: the BASELINE ladder (bench.harness) and the usage examples
# ---------------------------------------------------------------------------

# the kernels each harness config launches
LADDER = {
    "config1_lossless_roundtrip": (),
    "config2_4k_rgb_roundtrip": ("roundtrip32",),
    "config3_quantized_psnr": ("roundtrip32_rgb",),
    "config4_video_batch": ("roundtrip32",),
    "config5_sharded": ("enc32",),
}
# the virtual shards of card 0 config 5 also runs on
LADDER_SHARDS = 4
EXAMPLE_KERNELS = {
    "encode_decode": ("enc32", "dec32", "enc_stereo", "dec_stereo"),
    "video_pipeline": ("enc32", "dec32"),
    "serving": ("enc32", "dec32", "roundtrip32"),
    "sharded": ("enc32", "dec32", "enc_stereo", "dec_stereo", "ring_gather"),
}
DB_VALUE = re.compile(r"(\d+\.\d+) dB")


def copy_ms(n_bytes: int, cycles_per_ms: float) -> float:
    """ms of a device-to-device copy of n_bytes, queued over a rotation
    larger than the L2 cache."""
    pairs = [(torch.empty(n_bytes, dtype=torch.uint8, device=DEV),
              torch.empty(n_bytes, dtype=torch.uint8, device=DEV))
             for _ in range(max(2, -(-(64 << 20) // n_bytes)))]
    return queued_ms(copy_pair, pairs, REPS, cycles_per_ms)


def ladder_sharded(tag: str, kw: dict, errs: dict) -> None:
    """Config 5 on its own input and mesh: one sharded encode launches enc32
    once a shard, equals the one-call kernel encode byte for byte and the
    plain version within +-1."""
    from simd_dct_tpu_torch.bench import harness
    mesh = harness._config5_mesh(**kw)
    h, w = harness._config5_hw(mesh.size)
    img = harness._random_u8(harness._generator(5, DEV), (h, w), DEV)
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    rec = harness._sharded_encode(img, mesh).full()
    torch.cuda.synchronize()
    log(f"  {tag}: one sharded encode of {h}x{w}, {mesh.size} shards, "
        f"{cuda_dct.LAUNCHES['enc32']} enc32 launches")
    require(cuda_dct.LAUNCHES["enc32"] == mesh.size,
            "the sharded encode launches enc32 once a shard")
    rec = rec.to(DEV)
    require(torch.equal(rec, sd.encode_quantize32(
        img, harness._lut100()).reshape(rec.shape)),
        "the sharded encode equals the one-call encode")
    agree(f"{tag} enc32 {h}x{w} against the plain version", rec,
          torch_path.encode_quantize32(img, harness._lut100())
          .reshape(rec.shape), errs, "enc32")


def ladder_outputs(fn, tag: str, kw: dict, errs: dict) -> None:
    """Each config's kernel output on the config's own input at the
    ladder's shape, against the plain version (+-1 on at most 0.2%)."""
    from simd_dct_tpu_torch.bench import harness
    lut, chroma = harness._lut100(), harness._chroma100()
    if fn is harness.config2_4k_rgb_roundtrip:
        planes = harness._planar(harness._rgb_image(2, *harness.CONFIG2_HW),
                                 DEV)
        agree(f"{tag} roundtrip32 {tuple(planes.shape)}",
              harness._roundtrip_planes(planes),
              torch_path.roundtrip_quantize32(planes, lut), errs,
              "roundtrip32")
    elif fn is harness.config3_quantized_psnr:
        planes = harness._planar(harness._rgb_image(3, *harness.CONFIG3_HW),
                                 DEV)
        agree(f"{tag} roundtrip32_rgb {tuple(planes.shape)}",
              harness._color_roundtrip(planes),
              torch_path.roundtrip_ycbcr32(planes, lut, chroma), errs,
              "roundtrip32_rgb")
    elif fn is harness.config4_video_batch:
        frames = harness._random_u8(harness._generator(4, DEV),
                                    harness.CONFIG4_SHAPE, DEV)
        agree(f"{tag} roundtrip32 {tuple(frames.shape)}",
              harness._roundtrip_planes(frames),
              torch_path.roundtrip_quantize32(frames, lut), errs,
              "roundtrip32")
    elif fn is harness.config5_sharded:
        ladder_sharded(tag, kw, errs)


def ladder_config(fn, kw, kind: str, smi: str, cycles_per_ms: float,
                  counts: dict, errs: dict) -> dict:
    """One config in this process, counters set to 0 just before: its
    kernels must have launched; then its kernel output on its own input
    against the plain version; its time an item (the config's line) beside
    a same-run copy of a call's bytes, where the time is queued device
    time."""
    kernels = LADDER[fn.__name__]
    torch.cuda.synchronize()
    cuda_dct.reset_launch_counts()
    res = fn(**kw)
    torch.cuda.synchronize()
    ran = dict(cuda_dct.LAUNCHES)
    tag = f"{fn.__name__}({', '.join(f'{k}={v}' for k, v in kw.items())})"
    log(f"  {tag}: {json.dumps(res)}")
    log(f"  {tag} launches: { {k: n for k, n in ran.items() if n} }")
    require(res.get("device") == kind, f"{tag} ran on {kind}")
    require(not any(ran.values()) if not kernels
            else all(ran[k] > 0 for k in kernels),
            f"{tag} launched {kernels or 'no kernel'}")
    for k, n in ran.items():
        counts[k] += n
    ladder_outputs(fn, tag, kw, errs)
    if "ms_per_item" not in res:
        return {"config": tag, "result": res}
    item_ms = res["ms_per_item"]
    require(item_ms is not None, f"{tag} has a finite time")
    out = {"config": tag, "result": res, "ms_per_item": item_ms}
    if res["timer"] != "queued_events":
        # the host's wall over several cards: no same-run copy to set it by
        log(f"  {tag}: {item_ms:.4f} ms an item by {res['timer']} on {smi}")
        return out
    items = res["items_per_call"]
    c_ms = copy_ms(res["bytes_per_item"] * items, cycles_per_ms) / items
    log(f"  {tag}: {item_ms:.4f} ms an item, a device-to-device copy of "
        f"its bytes {c_ms:.4f} ms ({c_ms / item_ms:.3f} of copy) on {smi}")
    return {**out, "copy_ms_per_item": c_ms, "frac_of_copy": c_ms / item_ms}


def same_lines(card: list[str], host: list[str], what: str) -> None:
    """Equal lines, but each PSNR within 0.1 dB and the mesh's platform."""
    require(len(card) == len(host), f"{what}: as many lines on both")
    for a, b in zip(card, host):
        a = a.replace(" on cuda", " on cpu") if a.startswith("mesh:") else a
        require(DB_VALUE.sub("dB", a) == DB_VALUE.sub("dB", b),
                f"{what}: {a!r} == {b!r}")
        for x, y in zip(DB_VALUE.findall(a), DB_VALUE.findall(b)):
            require(abs(float(x) - float(y)) <= 0.1,
                    f"{what}: {a!r} within 0.1 dB of {b!r}")


def phase_ladder(kind: str, smi: str, errs: dict):
    """Phase 25: ``python -m simd_dct_tpu_torch.bench.harness`` in a process
    of its own, then each config in this process; each example as ``python
    -m ... --device cuda`` and ``--device cpu`` (all eight processes
    together), then each ``main`` in this process.  Returns the launches
    of the harness's and of the examples' in-process runs."""
    import contextlib
    import importlib
    import io

    from simd_dct_tpu_torch.bench import harness
    log("phase 25: the BASELINE ladder and the usage examples on the card")
    t0 = time.perf_counter()
    lines = [json.loads(ln) for ln in run_module(
        ["simd_dct_tpu_torch.bench.harness"], timeout=600).splitlines()
        if ln.startswith("{")]
    for ln in lines:
        log(f"  harness: {json.dumps(ln)}")
    require(len(lines) == 5 and not any("error" in ln for ln in lines),
            "the harness prints five lines with no error")
    require(lines[0]["bit_exact"] is True, "config 1 is bit-exact")
    require(lines[2]["pass"] is True and lines[2]["gate"]["tol_db"] == 0.1
            and lines[2]["tier"] == "cuda_fused_color",
            "config 3's gate passes at 0.1 dB on the fused colour kernel")
    cycles_per_ms = sleep_cycles_per_ms()
    counts_h = dict.fromkeys(cuda_dct.LAUNCHES, 0)
    runs = [(fn, {}) for fn in harness.ALL_CONFIGS] + [
        (harness.config5_sharded,
         {"devices": [f"{DEV}:0"] * LADDER_SHARDS})]
    ladder = [ladder_config(fn, kw, kind, smi, cycles_per_ms, counts_h, errs)
              for fn, kw in runs]
    t_harness = time.perf_counter() - t0

    t0 = time.perf_counter()
    names = list(EXAMPLE_KERNELS)
    outs = run_modules([[f"simd_dct_tpu_torch.examples.{n}", "--device", d]
                        for n in names for d in ("cuda", "cpu")])
    counts_e = dict.fromkeys(cuda_dct.LAUNCHES, 0)
    for i, name in enumerate(names):
        card, host = outs[2 * i].splitlines(), outs[2 * i + 1].splitlines()
        for ln in card:
            log(f"  {name} (cuda): {ln}")
        same_lines(card, host, f"{name} on the card and on the host")
        module = importlib.import_module(f"simd_dct_tpu_torch.examples.{name}")
        torch.cuda.synchronize()
        cuda_dct.reset_launch_counts()
        with contextlib.redirect_stdout(io.StringIO()):
            here = module.main([])
        torch.cuda.synchronize()
        ran = dict(cuda_dct.LAUNCHES)
        log(f"  {name} main() launches: { {k: n for k, n in ran.items() if n} }")
        require(here == card, f"{name}: main() prints the process's lines")
        for k in EXAMPLE_KERNELS[name]:
            require(ran[k] > 0, f"{name} launched {k}")
        for k, n in ran.items():
            counts_e[k] += n
    t_examples = time.perf_counter() - t0
    log(f"  phase 25: harness {t_harness:.2f} s, examples {t_examples:.2f} s")
    return counts_h, counts_e, {"harness": lines, "in_process": ladder,
                                "harness_s": t_harness,
                                "examples_s": t_examples}


def copy_pair(p):
    """Device-to-device copy of p[0] into p[1]: the same-run speed limit."""
    return p[1].copy_(p[0])


def profiled_us(fn, inputs, tries=3, match=None):
    """Device time per call (us) from torch.profiler: for each GPU activity
    it records (whose name holds ``match``, if given), its mean time times
    its launches per call (robust to dropped records).  (None, []) when
    ``tries`` profiles in a row record no such activity.  Also the names
    of the kernels it ran."""
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
                and e.count > 0 and e.self_device_time_total > 0
                and (match is None or match in e.key)]
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
            p_wall = wall_ms(plain, inputs, PLAIN_WALL_REPS) * 1e3
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
            if kernel in EARLIER_US:
                plan, inst = strip_tile_plan(kernel, name, inputs[0], h, w)
                floor_us = EXACT_OPS_PER_PX[kernel] * n_px / ISSUE_PER_S * 1e6
                table[-1].update(plan=plan._asdict(), floor_us=floor_us,
                                 ptxas=PTXAS.get(inst))
                log(f"  {name} plan {plan._asdict()}; earlier (4K) "
                    f"{EARLIER_US[kernel]} us; exact-arithmetic floor "
                    f"{floor_us:.2f} us ({EXACT_OPS_PER_PX[kernel]} "
                    "instructions a pixel position)")
                log(f"  {name} ptxas {inst}: {PTXAS.get(inst)}")
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
    # the card's launch floor: a one-element elementwise op, by the same
    # two estimators as the probe
    ones = [torch.zeros(1, dtype=torch.uint8, device=DEV) for _ in range(16)]
    rows["launch_floor"] = {
        "queued_us": queued_ms(lambda x: x.add(1), ones, reps,
                               cycles_per_ms) * 1e3,
        "profiler_us": profiled_us(lambda x: x.add(1), ones)[0],
        "probe_queued_us": k_us,
        "probe_profiler_us": profiled_us(cuda_dct.probe_trial, xs)[0]}
    log(f"  launch floor (one u8 element + 1): {rows['launch_floor']}")
    library = timing_dist(gen, lut_q, reps, cycles_per_ms, rows, table)
    log("timing_table " + json.dumps(table))
    return rows, library


def strip_tile_plan(kernel: str, name: str, x, h: int, w: int):
    """The launch plan of a strip-tile kernel's timed job ``name`` on its
    input ``x``, and the name of the (rne) instantiation that ran, as
    ``log_ptxas`` keys it."""
    if kernel in ("enc_stereo", "dec_stereo"):
        vl = name[len(kernel) + 1:] or "interleaved"
        plan = cuda_dct.stereo_launch_plan(kernel, x, vl, w, h)
        code = cuda_dct._VARIANT_CODE[plan.variant]
        return plan, (f"{kernel}_kernel<0,{code}>" if kernel == "enc_stereo"
                      else f"{kernel}_kernel<{code}>")
    if kernel == "enc420_rgb":
        return cuda_dct.color420_launch_plan(x), "enc420_rgb_kernel<0>"
    if kernel == "dec420_rgb":
        return (cuda_dct.color420_launch_plan(x, size_x=w),
                "dec420_rgb_kernel")
    if kernel == "detile":
        # the timed job: raw, fy
        return cuda_dct.detile_launch_plan(x), "detile_kernel<0,0>"
    if kernel == "tiles":
        # the timed job: rne, fy, raw
        return cuda_dct.tiles_launch_plan(x), "tiles_kernel<0,0,0>"
    if kernel == "roundtrip32":
        return cuda_dct.roundtrip32_launch_plan(x), "roundtrip32_kernel"
    if kernel in ("enc32", "dec32"):
        return (cuda_dct.mode32_launch_plan(kernel, x, size_x=w, size_y=h),
                "enc32_kernel<0>" if kernel == "enc32" else "dec32_kernel")
    if kernel in ("encq", "decq"):
        layout = {"": "scalar", "pair": "pair",
                  "as_written": "pair_as_written"}[name[len(kernel) + 1:]]
        plan = cuda_dct.encq_launch_plan(kernel, x, layout, size_x=w,
                                         size_y=h)
        code = (cuda_dct._LAYOUT_CODE[layout],
                cuda_dct._VARIANT_CODE[plan.variant])
        return plan, (f"encq_kernel<0,{code[0]},{code[1]}>"
                      if kernel == "encq"
                      else f"decq_kernel<{code[0]},{code[1]}>")
    if kernel == "dec32_rgb":
        return (cuda_dct.color_launch_plan(kernel, x, size_x=w),
                "dec32_rgb_kernel")
    plan = cuda_dct.color_launch_plan(kernel, x)
    if kernel == "enc32_rgb":
        code = cuda_dct._VARIANT_CODE[plan.variant]
        return plan, f"enc32_rgb_kernel<0,{code}>"
    return plan, f"{kernel}_kernel"


def four_cats(seg):
    """The library call for the gather in one process: a torch.cat of the
    ring's segments onto each of its ranks' devices."""
    return [torch.cat([s.to(x.device) for s in seg.shards], dim=1)
            for x in seg.shards]


def timing_dist(gen, lut_q, reps, cycles_per_ms, rows, table):
    """The gather kernel on the 4K dual view's stereo segments over four
    shards of card 0 (queued events, profiler beside), against four
    torch.cats and the bound; the self-ring call; and the 4-shard stereo
    encode against the one-launch call.  Adds rows; returns library ms."""
    mesh, _ = dist_meshes()
    imgs = [random_images(gen, 4096, 3840, 1) for _ in range(4)]
    segs = [dist.encode_quantize_stereo_sharded(x, lut_q, mesh) for x in imgs]
    n = len(segs[0].shards)
    seg_bytes = segs[0].shards[0].numel()
    n_bytes = n * seg_bytes + n * n * seg_bytes   # read once, write n times

    def kern(seg):
        return collectives.gather_planes_remote(seg, mesh)

    def plain(seg):
        return collectives.gather_planes_ring(seg, mesh)

    k_us = queued_ms(kern, segs, reps, cycles_per_ms) * 1e3
    collectives.check_workspace(mesh)
    k_prof, k_names = profiled_us(kern, segs, match="ring_gather")
    collectives.check_workspace(mesh)
    k_wall = wall_ms(kern, segs, reps) * 1e3
    collectives.check_workspace(mesh)
    lib_us = queued_ms(four_cats, segs, reps, cycles_per_ms) * 1e3
    lib_prof, _ = profiled_us(four_cats, segs)
    p_prof, _ = profiled_us(plain, segs)
    p_wall = wall_ms(plain, segs, PLAIN_WALL_REPS) * 1e3
    p_us = p_prof if p_prof is not None else p_wall
    bound, _ = bound_ms("ring_gather", n_bytes, 0)
    plan = mesh._collective_workspace.last_plan._asdict()
    rows["ring_gather"] = (k_us / 1e3, p_us / 1e3, None, n_bytes, 0)
    table.append({"kernel": "ring_gather", "kernel_us": k_us,
                  "shape": f"4 x {tuple(segs[0].shards[0].shape)}",
                  "kernel_profiler_us": k_prof, "kernel_wall_us": k_wall,
                  "plain_us": p_us, "plain_wall_us": p_wall,
                  "library_us": lib_us, "library_profiler_us": lib_prof,
                  "bytes": n_bytes, "bound_us": bound * 1e3,
                  "kernel_gbps": n_bytes / (k_us * 1e3),
                  "frac_of_bound": bound * 1e3 / k_us,
                  "kernel_names": k_names, "plan": plan})
    log(f"  ring_gather 4 x {tuple(segs[0].shards[0].shape)}: kernel "
        f"{k_us:.3f} us (profiler {k_prof}, wall {k_wall:.2f})  four "
        f"torch.cat {lib_us:.3f} us (profiler {lib_prof})  plain ring "
        f"{p_us:.2f} us (wall {p_wall:.2f})  bound {bound * 1e3:.3f} us  "
        f"{n_bytes / (k_us * 1e3):.1f} GB/s  {bound * 1e3 / k_us:.3f} of "
        f"bound  CTAs a rank {plan['blocks']}, tile {plan['tile']} bytes, "
        f"stages {plan['stages']}")
    # the self-ring: a check (a synchronisation) every call, so wall time;
    # the kernel and its library call by profiler, the same estimator
    xs = [torch.randint(0, 256, (8, 8, 128), generator=gen,
                        dtype=torch.uint8, device=DEV) for _ in range(4)]
    s_wall = wall_ms(collectives.selfring, xs, reps) * 1e3
    s_prof, s_names = profiled_us(collectives.selfring, xs, tries=8,
                                  match="selfring")
    s_plan = collectives._self_meshes[xs[0].device] \
        ._collective_workspace.last_plan._asdict()
    sp_prof, _ = profiled_us(collectives.selfring_plain, xs)
    sp_us = sp_prof if sp_prof is not None else \
        wall_ms(collectives.selfring_plain, xs, reps) * 1e3

    def cat2(x):
        return torch.cat([x, x], dim=1)

    s_lib_queued = queued_ms(cat2, xs, reps, cycles_per_ms) * 1e3
    s_lib_prof, _ = profiled_us(cat2, xs)
    # the call synchronises, so only the profiler times the kernel: where
    # it recorded none, the kernel's time is not measured (null), never
    # the call's wall
    s_lib = s_lib_prof if s_lib_prof is not None else s_lib_queued
    rows["selfring"] = (None if s_prof is None else s_prof / 1e3,
                        sp_us / 1e3, None, 3 * 8 * 8 * 128, 0)
    table.append({"kernel": "selfring", "shape": "(8, 8, 128)",
                  "kernel_profiler_us": s_prof, "kernel_wall_us": s_wall,
                  "plain_us": sp_us, "library_profiler_us": s_lib_prof,
                  "library_us": s_lib_queued, "kernel_names": s_names,
                  "plan": s_plan})
    log(f"  selfring (8, 8, 128): profiler {s_prof} us ({s_names}), call "
        f"wall {s_wall:.2f} us (a synchronisation each)  plain "
        f"{sp_us:.2f} us  torch.cat([x, x], 1) profiler {s_lib_prof} us "
        f"(queued events {s_lib_queued:.3f})  CTAs {s_plan['blocks']}, tile "
        f"{s_plan['tile']} bytes, stages {s_plan['stages']}")
    # four shards, a launch each, against one launch on the whole image
    sharded = queued_ms(lambda x: dist.encode_quantize_stereo_sharded(
        x, lut_q, mesh), imgs, reps, cycles_per_ms) * 1e3
    single = queued_ms(lambda x: cuda_dct.encode_quantize_stereo(x, lut_q),
                       imgs, reps, cycles_per_ms) * 1e3
    sh_wall = wall_ms(lambda x: dist.encode_quantize_stereo_sharded(
        x, lut_q, mesh), imgs, reps) * 1e3
    si_wall = wall_ms(lambda x: cuda_dct.encode_quantize_stereo(x, lut_q),
                      imgs, reps) * 1e3
    table.append({"kernel": "enc_stereo_4_shards", "kernel_us": sharded,
                  "single_us": single, "kernel_wall_us": sh_wall,
                  "single_wall_us": si_wall, "shape": "4096x3840 image"})
    log(f"  stereo encode of the 4K dual view: 4 shards {sharded:.3f} us "
        f"(wall {sh_wall:.2f}), one call {single:.3f} us (wall "
        f"{si_wall:.2f})")
    return {"ring_gather": lib_us / 1e3, "selfring": s_lib / 1e3}


def bound_ms(name: str, n_bytes: int, n_px: int) -> tuple[float, str]:
    """Least time for the work of one call: each input byte read once and
    each output byte written once (``n_bytes``) over HBM's rate, or the
    transforms' f32 FMAs on ``n_px`` pixels over the CUDA cores' rate,
    whichever is larger."""
    by_bytes = n_bytes / PEAK_BYTES_S * 1e3
    by_ops = FMA_PER_PX[name] * n_px / PEAK_FMA_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def kernel_rows(launches, errs, times, library):
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
               "bound_ms": bound, "bound_by": bound_by,
               "library_ms": library.get(name),
               # ms is None where the profiler recorded no kernel
               "us": None if ms is None else ms * 1e3,
               "gbps": None if ms is None else n_bytes / (ms * 1e6),
               "frac_of_copy": None if ms is None or copy is None
               else copy / ms,
               "frac_of_bound": None if ms is None else bound / ms}
        for layout in ("pair", "as_written", "planar", "native"):
            if f"{name}_{layout}" in times:
                ms_l, plain_l, _, bytes_l, px_l = times[f"{name}_{layout}"]
                row[f"ms_{layout}"] = ms_l
                row[f"plain_ms_{layout}"] = plain_l
                row[f"bound_ms_{layout}"] = bound_ms(name, bytes_l, px_l)[0]
        rows.append(row)
    return rows


def add_procs(rows, results, one) -> None:
    """Phase 23 in the kernels line: each kernel's launches in each process
    (``launches_procs``, rank order), and beside the gather's row its
    times across processes (rank 0's: the profiler's kernel time, the
    median wall) and the one process's gather of the same segments (the
    profiler's kernel time beside it, and its queued events)."""
    for row in rows:
        row["launches_procs"] = [r["launches"][row["name"]] for r in results]
        if row["name"] != "ring_gather":
            continue
        t = results[0]["timing"]
        row["procs"] = {k: t.get(k) for k in ("kernel_us", "wall_us",
                                              "error")}
        row["one_process"] = {k: one[k] for k in (
            "shards", "kernel_profiler_us", "kernel_us", "wall_us",
            "library_us")}


def log_ptxas(lines) -> None:
    """Registers, stack and spills per kernel instantiation from the
    ``ptxas -v`` lines of the build log, e.g. ``encq_kernel<1,2>``; kept in
    ``PTXAS`` for the timing phase."""
    name = "?"
    for line in lines:
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(enc420_rgb|dec420_rgb|enc32_rgb|dec32_rgb"
                          r"|roundtrip32_rgb|enc32|dec32"
                          r"|roundtrip32|probe|encq|decq|enc_stereo"
                          r"|dec_stereo|tiles|detile|ring_gather|selfring)"
                          r"_kernel"
                          r"(?:I((?:L[ib]\d+E)+)E)?", m.group(1))
            name = f"{k.group(1)}_kernel" if k else m.group(1)
            if k and k.group(2):
                name += "<" + ",".join(re.findall(r"\d+", k.group(2))) + ">"
        elif "registers" in line or "spill" in line:
            text = line.split(":", 1)[-1].strip()
            log(f"  ptxas {name}: {text}")
            PTXAS[name] = "; ".join(filter(None, (PTXAS.get(name), text)))


def main_cards(gen, kind, smi, t_start) -> int:
    """The dist phases with one shard on each of four cards: the gather's
    peer stores, its flags across cards and the sharded entry points; and
    phase 25's config 5 over the four cards."""
    require(torch.cuda.device_count() >= 4, "--cards 4 needs four cards")
    DIST_DEVICES[:] = [f"{DEV}:{i}" for i in range(4)]
    mesh = dist.make_mesh(4)
    require([str(d) for d in mesh.devices.flat] == DIST_DEVICES,
            "make_mesh(4) takes the four cards")
    lut100 = default_quant_lut(100) * np.float32(255.0)
    lut_q = default_quant_lut(50)
    chroma100 = BASE_CHROMA_QUANT_TABLE * np.float32(100 * 255)
    errs: dict[str, int] = {}
    timed(phase_compare_dist, gen, lut_q, errs)
    counts = timed(phase_main_path_dist, gen, lut100, lut_q, lut100,
                   chroma100)
    rows, table = {}, []
    library = timed(timing_dist, gen, lut_q, REPS, sleep_cycles_per_ms(),
                    rows, table)
    procs, procs_results = timed(phase_procs, lut_q, DIST_DEVICES)
    from simd_dct_tpu_torch.bench import harness
    counts_h = dict.fromkeys(cuda_dct.LAUNCHES, 0)
    ladder = timed(ladder_config, harness.config5_sharded, {}, kind, smi,
                   sleep_cycles_per_ms(), counts_h, errs)
    log(f"chip_smoke --cards 4: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"procs": procs}))
    log(json.dumps({"cards": DIST_DEVICES, "errs": errs, "launches": {
        k: counts[k] for k in ("ring_gather", "selfring")},
        "launches_procs": {k: [r["launches"][k] for r in procs_results]
                           for k in ("ring_gather", "enc32", "dec32",
                                     "enc_stereo", "roundtrip32")},
        "library_ms": library, "timing": table, "ladder": ladder}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def timed(phase, *args):
    """Run one phase and log its seconds."""
    t0 = time.perf_counter()
    out = phase(*args)
    log(f"  [{phase.__name__}: {time.perf_counter() - t0:.2f} s]")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: one dist shard on each of four cards, and only "
                    "the build, the dist phases and the harness's config 5")
    ap.add_argument("--procs-worker", type=int, default=None,
                    metavar="RANK", help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--devices", default="", help=argparse.SUPPRESS)
    ap.add_argument("--out", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if args.procs_worker is not None:
        return procs_worker(args.procs_worker, args.world, args.port,
                            args.devices.split(","), args.out)

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
    if args.cards == 4:
        return main_cards(gen, kind, smi.stdout.strip(), t_start)
    lut = default_quant_lut(50) * np.float32(255.0)
    errs: dict[str, int] = {}
    timed(phase_compare, gen, lut, errs)
    # quality 100 is the BASELINE ladder's LUT; at 50 the DC term clips
    lut100 = default_quant_lut(100) * np.float32(255.0)
    timed(phase_psnr, gen, lut100)
    counts = timed(phase_main_path, gen, lut100)
    # enc-quant works in the 1/255 domain: the LUT is 255x cooler
    lut_q = default_quant_lut(50)
    timed(phase_compare_encq, gen, lut_q, errs)
    counts_q = timed(phase_main_path_encq, gen, lut_q)
    timed(phase_compare_stereo, gen, lut_q, errs)
    counts_s = timed(phase_main_path_stereo, gen, lut_q)
    # colour: the mode32 raw domain, the JPEG chroma table at quality 100
    chroma100 = BASE_CHROMA_QUANT_TABLE * np.float32(100 * 255)
    timed(phase_compare_color, gen, lut100, chroma100, errs)
    counts_c = timed(phase_main_path_color, gen, lut100, chroma100)
    timed(phase_compare_color420, gen, lut100, chroma100, errs)
    counts_420 = timed(phase_main_path_color420, gen, lut100, chroma100)
    luts = {"raw": lut100, "q": lut_q}
    identities = timed(phase_compare_tiles, gen, luts, errs)
    counts_t = timed(phase_main_path_tiles, gen, luts)
    compat_stats = timed(phase_compat, gen, lut100, lut_q)
    timed(phase_large_batch, gen, lut100, lut_q)
    timed(phase_compare_dist, gen, lut_q, errs)
    counts_d = timed(phase_main_path_dist, gen, lut100, lut_q, lut100,
                     chroma100)
    procs, procs_results = timed(phase_procs, lut_q, [f"{DEV}:0"] * 2)
    golden = timed(phase_golden, gen, lut100, lut_q)
    counts_z, ratios = timed(phase_compressed_stream, gen)
    stages = timed(stream_stages, gen, smi.stdout.strip())
    # phase 22 after phase 10: where its profiler sessions came first,
    # phase 10's profiler recorded no self-ring kernel in two runs of five
    times, library = timed(phase_timing, gen, lut100, lut_q, chroma100, REPS)
    counts_serve, serve = timed(phase_serve, gen, lut100)
    counts_h, counts_e, ladder = timed(phase_ladder, kind, smi.stdout.strip(),
                                       errs)
    log(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    launches = {"mode32": counts, "enc-quant": counts_q, "stereo": counts_s,
                "colour": counts_c, "colour 4:2:0": counts_420,
                "tiles": counts_t, "dist": counts_d}
    log("compat " + json.dumps(compat_stats))
    log(json.dumps({"stream": {"stages": stages, "ratios": ratios}}))
    log(json.dumps({"serve": serve}))
    log(json.dumps({"golden": golden}))
    log(json.dumps({"ladder": ladder}))
    log(json.dumps({"procs": procs}))
    rows = kernel_rows(launches, errs, times, library)
    add_procs(rows, procs_results, procs["one_process"])
    for row in rows:
        # launches on phase 21's run of the compressed-stream path
        row["launches_stream"] = counts_z[row["name"]]
        # launches on phase 22's run of the serving surfaces
        row["launches_serve"] = counts_serve[row["name"]]
        # launches on phase 25's in-process runs of the harness's configs
        # and of the examples' main()
        row["launches_harness"] = counts_h[row["name"]]
        row["launches_examples"] = counts_e[row["name"]]
        if row["name"] == "probe":
            row["launch_floor"] = times["launch_floor"]
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
