"""Benchmark / encode command line mirroring the reference harness
(counterpart of ``simd_dct_tpu/cli.py``, with every flag of its parser).

Reference usage (src/main.cpp:106-119):

    simd_dct <raw_grayscale_image_file> <resolutionX> <resolutionY>
        --to <file>           store the last output
        --quality <0-100>     quantization quality level
        --runs <uint>         benchmark run count (default 128, max 1024)
        --cpu-core <n>        pin the host thread
        --max-simd <tier>     cap the backend tier (cuda / torch / numpy
                              natively; the reference's ISA names map onto
                              tiers: avx* -> cuda, sse* -> torch, none ->
                              numpy, the NumPy golden on the host)
        --mode <mode>         enc-quant / enc-quant32 / enc-quant-stereo
                              (+ enc-quant32-ycbcr and enc-quant32-ycbcr420:
                              3-plane colour, past the grayscale reference)
                              (repeatable; default: all supported)

    python -m simd_dct_tpu_torch.cli image.raw 3840 4096 --mode enc-quant32

The work runs on the card; ``--device cpu`` runs the plain version on the
host (``--device`` is the one flag the JAX package's command lacks: it
stands for its ``JAX_PLATFORMS``).  Without a card and without
``--device cpu`` the command exits with an error that names the option.
``--max-simd none`` (or ``numpy``) runs the NumPy golden, a host tier: the
work runs on the host with no ``--device``, a ``--device`` naming a card
exits with an error, ``--accurate`` takes direct walls, and the colour
modes, which have no golden, print a row saying so.

Differences from the reference, by design: the default quality is only
applied when --quality is passed (src/main.cpp:123,214 declare a default
of 50 that is never applied without the flag; reproduced faithfully), and
a --decode flag adds the inverse path.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

MAX_SIMD_TO_TIER = {
    # native tier names
    "cuda": "cuda", "torch": "torch", "numpy": "numpy",
    # reference ISA names (src/main.cpp:89-98) mapped onto tiers
    "avx512bw": "cuda", "avx512f": "cuda", "avx2": "cuda", "avx": "cuda",
    "sse4.2": "torch", "sse4.1": "torch", "ssse3": "torch", "sse3": "torch",
    "sse2": "torch",
    "none": "numpy",
}

MODES = ("enc-quant", "enc-quant32", "enc-quant-stereo",
         "enc-quant32-ycbcr", "enc-quant32-ycbcr420")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="simd_dct_tpu_torch",
        description="8x8 block DCT encode/decode benchmark on a CUDA card")
    p.add_argument("file", help="raw grayscale image file")
    p.add_argument("resolution_x", type=int)
    p.add_argument("resolution_y", type=int)
    p.add_argument("--to", dest="out_file", default=None,
                   help="store the last output in the specified file "
                        "(a .sdt extension writes the self-describing "
                        "container: mode + geometry + LUTs + records, "
                        "decodable via `python -m "
                        "simd_dct_tpu_torch.container decode`)")
    p.add_argument("--quality", type=float, default=None,
                   help="quantization quality level (scales the LUT)")
    p.add_argument("--runs", type=int, default=None,
                   help="benchmark run count (default 128, max 1024)")
    p.add_argument("--cpu-core", dest="cpu_core", type=int, default=None,
                   help="pin the host thread to a core (best-effort)")
    p.add_argument("--max-simd", dest="max_simd", default=None,
                   choices=sorted(MAX_SIMD_TO_TIER),
                   help="cap the backend tier")
    p.add_argument("--mode", action="append", dest="modes",
                   choices=MODES, default=None,
                   help="benchmark only the given mode(s); repeatable")
    p.add_argument("--decode", action="store_true",
                   help="also run the inverse path and report round-trip PSNR")
    p.add_argument("--accurate", action="store_true",
                   help="slope-based timing between batches of 4 and 20 "
                        "frames, each one batched call walled to a "
                        "synchronise (takes the per-call launch cost out "
                        "of the reading)")
    p.add_argument("--compress", action="store_true",
                   help="entropy-code each mode's records (histogram on the "
                        "card + native 4-stream Huffman) and report the "
                        "ratio; with --to, the compressed stream is "
                        "written instead of raw records")
    p.add_argument("--rle", action="store_true",
                   help="with --compress: run-length-code the dominant "
                        "byte before the Huffman pack (better ratio on "
                        "typical records)")
    p.add_argument("--sparse", action="store_true",
                   help="with --compress: drop all-127 64-byte blocks "
                        "on the card before the host pack (SDS1; dense "
                        "input falls back transparently)")
    p.add_argument("--stereo-layout",
                   choices=("interleaved", "planar", "native"),
                   default="interleaved",
                   help="enc-quant-stereo record layout: 'interleaved' "
                        "(reference byte stream), 'planar' (separate "
                        "views), 'native' (128-multiple padded plane "
                        "rows)")
    p.add_argument("--layout", choices=("scalar", "pair"),
                   default="scalar",
                   help="enc-quant byte layout: 'scalar' (block-"
                        "contiguous, the reference NoSimd kernel) or "
                        "'pair' (the SSE4.1 pair-cell layout)")
    p.add_argument("--start-y", type=int, default=0)
    p.add_argument("--end-y", type=int, default=None)
    p.add_argument("--sharded", type=int, default=None, metavar="N",
                   help="run enc-quant32/stereo strip-sharded over an "
                        "N-device mesh: the first N cards, or with "
                        "--device D, N shards on D")
    p.add_argument("--device", default=None,
                   help="where to run: the card by default ('cuda', "
                        "'cuda:1', ...); 'cpu' runs the plain version on "
                        "the host")
    return p


def _pin_cpu(core: int) -> None:
    try:
        os.sched_setaffinity(0, {core})
    except (AttributeError, OSError) as e:  # pragma: no cover
        print(f"warning: could not pin cpu core {core}: {e}")


def _host(x) -> np.ndarray:
    """A result (a tensor, or a ``Sharded`` value) as a host array."""
    from .dist import Sharded
    if isinstance(x, Sharded):
        x = x.full()
    return x.cpu().numpy()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import torch

    import simd_dct_tpu_torch as sd
    from .api import NotSupportedError
    from .bench.stats import (DEFAULT_RUN_COUNT, HEADER, MAX_RUN_COUNT,
                              time_fn)
    from .dispatch import probe, set_max_backend
    from .dispatch.capability import DeviceInfo, default_device
    from .utils.metrics import psnr

    golden = (args.max_simd is not None
              and MAX_SIMD_TO_TIER[args.max_simd] == "numpy")
    if golden and args.device is not None and \
            torch.device(args.device).type != "cpu":
        print(f"error: --max-simd {args.max_simd} runs the NumPy golden on "
              f"the host; it cannot run on --device {args.device}")
        return 1
    try:
        dev = default_device("cpu" if golden else args.device)
    except NotSupportedError:
        print("error: no CUDA device on this machine; pass --device cpu to "
              "run the plain version on the host")
        return 1
    on_card = dev.type == "cuda"

    if args.cpu_core is not None:
        _pin_cpu(args.cpu_core)

    try:
        data = np.fromfile(args.file, dtype=np.uint8)
    except OSError:
        print("Failed to read file.")
        return 1
    w, h = args.resolution_x, args.resolution_y
    if w <= 0 or h <= 0:
        print("Invalid Resolution Specified. Aborting.")
        return 1
    if data.size < w * h:
        print(f"File too small: {data.size} bytes for {w}x{h}.")
        return 1
    img = data[: w * h].reshape(h, w)
    # YCbCr mode input: 3*H*W bytes of planar RGB when provided, else the
    # grayscale image replicated onto all three planes.
    if data.size >= 3 * w * h:
        rgb_planes = data[: 3 * w * h].reshape(3, h, w)
    else:
        rgb_planes = np.broadcast_to(img, (3, h, w))

    runs = args.runs if args.runs is not None else DEFAULT_RUN_COUNT
    if runs < 1 or runs > MAX_RUN_COUNT:
        print("Invalid Parameter.")
        return 1

    if args.max_simd is not None:
        # strict, like the reference: a cap naming an ISA level the
        # machine doesn't have is an error, not a silent degrade
        # (src/main.cpp:283-438)
        try:
            set_max_backend(MAX_SIMD_TO_TIER[args.max_simd], strict=True)
        except NotSupportedError as e:
            print(f"error: {e}")
            return 1

    lut = sd.default_quant_lut(args.quality)

    info = probe() if on_card else DeviceInfo(
        platform="cpu", device_kind="cpu", num_devices=0,
        supports_cuda=False)
    print(f"device: {info.banner} (running on {dev})")
    print()

    def sync(_=None):
        if on_card:
            torch.cuda.synchronize(dev)

    modes = args.modes or list(MODES)
    end_y = args.end_y if args.end_y is not None else h
    imgj = torch.as_tensor(img, device=dev)
    last_output = None
    last_mode = None
    print(HEADER)

    def _slope_row(name, enc_batch, base, nbytes):
        """Per-image cost: the slope between batches of 4 and 20 frames,
        each batch one call walled to a synchronise."""
        walls = {}
        for bsz in (4, 20):
            xb = torch.stack([base] * bsz)
            enc_batch(xb)
            sync()
            best = 1e9
            for _ in range(max(3, min(runs, 16))):
                t0 = time.perf_counter()
                enc_batch(xb)
                sync()
                best = min(best, time.perf_counter() - t0)
            walls[bsz] = best
            del xb
        per_s = max((walls[20] - walls[4]) / 16, 1e-12)
        gbps = nbytes / per_s / 1e9
        print(f"{name + ' (slope)':<28} | {per_s / nbytes * 1e9:9.4f} ns/B | "
              f"{gbps:8.2f} GB/s per image")

    def run_mode(name, enc, dec, ref_for_psnr, enc_one=None,
                 enc_base=None, nbytes=None):
        nonlocal last_output, last_mode
        last_mode = name
        nbytes = img.size if nbytes is None else nbytes
        out = enc()
        sync()
        # the slope path times batched calls on the card; on the host
        # (the plain version) it takes direct walls
        if args.accurate and on_card and enc_one is not None:
            _slope_row(name, enc_one,
                       imgj if enc_base is None else enc_base, nbytes)
        else:
            stats = time_fn(name, enc, bytes_processed=nbytes, runs=runs,
                            sync=sync)
            print(stats.row())
        last_output = _host(out)
        if args.decode and dec is not None:
            rec = _host(dec(last_output))
            print(f"{name + ' round-trip':<28} | PSNR "
                  f"{psnr(ref_for_psnr, rec):6.2f} dB")
        if args.compress:
            from . import entropy as E
            records = out.full() if not isinstance(out, torch.Tensor) \
                else out
            t0 = time.perf_counter()
            blob = (E.compress_sparse(records, rle=args.rle)
                    if args.sparse
                    else E.compress_records(records, rle=args.rle))
            dt = time.perf_counter() - t0
            print(f"{name + ' entropy':<28} | "
                  f"{last_output.size / blob.size:6.2f}x ratio | "
                  f"{last_output.size / dt / 1e6:7.0f} MB/s pack")
            last_output = blob

    mesh = None
    if args.sharded is not None:
        from . import dist
        try:
            mesh = (dist.make_mesh(args.sharded) if on_card
                    and args.device is None
                    else dist.make_mesh(args.sharded,
                                        devices=[dev] * args.sharded))
        except ValueError as e:
            print(f"error: {e}")
            return 1
        print(f"sharded: {args.sharded}-device mesh "
              f"[{mesh.devices.flat[0].type}]")
        if (h // 2) % (8 * args.sharded):
            print("Invalid Parameter (H/2 must split into 8-row strips "
                  "across the mesh).")
            return 1

    if "enc-quant" in modes:
        if mesh is not None:
            print(f"{'enc-quant':<28} | no sharded path (strip-dp covers "
                  "enc-quant32/stereo); skipped")
        else:
            run_mode(
                "enc-quant",
                lambda: sd.encode_quantize(imgj, lut, args.start_y, end_y,
                                           layout=args.layout),
                lambda d: sd.decode_quantize(d, lut, w, h,
                                             layout=args.layout, device=dev),
                img[: h // 2],
                enc_one=lambda im: sd.encode_quantize(
                    im, lut, args.start_y, end_y, layout=args.layout))
    if "enc-quant32" in modes:
        if w % 64:
            print(f"{'enc-quant32':<28} | not supported (W % 64 != 0)")
        elif mesh is not None:
            from . import dist
            run_mode(
                "enc-quant32",
                lambda: dist.encode_quantize32_sharded(imgj, lut * 255.0,
                                                       mesh),
                lambda d: dist.decode_quantize32_sharded(
                    d.reshape(h // 16, 8 * w), lut * 255.0, w, h, mesh),
                img[: h // 2])
        else:
            run_mode(
                "enc-quant32",
                lambda: sd.encode_quantize32(imgj, lut * 255.0,
                                             args.start_y, end_y),
                lambda d: sd.decode_quantize32(d, lut * 255.0, w, h,
                                               device=dev),
                img[: h // 2],
                enc_one=lambda im: sd.encode_quantize32(
                    im, lut * 255.0, args.start_y, end_y))
    if "enc-quant-stereo" in modes:
        if mesh is not None:
            from . import dist
            run_mode(
                "enc-quant-stereo",
                lambda: dist.encode_quantize_stereo_sharded(imgj, lut, mesh,
                                                            gather=True),
                lambda d: dist.decode_quantize_stereo_sharded(
                    d.reshape(64, h // 16, w // 4), lut, w, h, mesh),
                img,
                nbytes=2 * img.size)   # both views in + H*W records out
        else:
            vl = args.stereo_layout
            run_mode(
                "enc-quant-stereo",
                lambda: sd.encode_quantize_stereo(imgj, lut, args.start_y,
                                                  end_y, view_layout=vl),
                lambda d: sd.decode_quantize_stereo(d, lut, w, h,
                                                    view_layout=vl,
                                                    device=dev),
                img,
                enc_one=lambda im: sd.encode_quantize_stereo(
                    im, lut, args.start_y, end_y, view_layout=vl),
                nbytes=2 * img.size)   # both views in + H*W records out

    # chroma follows the same quality convention as luma: unscaled when
    # --quality is omitted (matches Encoder.chroma_lut; the reference
    # applies quality only when the flag is passed, src/main.cpp:123,214)
    q = 1.0 if args.quality is None else args.quality
    chroma = sd.layout.BASE_CHROMA_QUANT_TABLE * q * 255.0
    for name, enc_fn, dec_fn, ok, why in (
            ("enc-quant32-ycbcr", sd.encode_quantize32_ycbcr,
             sd.decode_quantize32_ycbcr, w % 64 == 0, "W % 64 != 0"),
            ("enc-quant32-ycbcr420", sd.encode_quantize32_ycbcr420,
             sd.decode_quantize32_ycbcr420, w % 128 == 0 and h % 32 == 0,
             "needs W % 128 == 0 and H % 32 == 0")):
        if name not in modes:
            continue
        if golden:
            print(f"{name:<28} | not supported (no numpy tier)")
        elif not ok:
            print(f"{name:<28} | not supported ({why})")
        elif mesh is not None:
            print(f"{name:<28} | no sharded path; skipped")
        else:
            planesj = torch.as_tensor(np.ascontiguousarray(rgb_planes),
                                      device=dev)
            run_mode(
                name,
                lambda: enc_fn(planesj, lut * 255.0, chroma),
                lambda d: dec_fn(d, lut * 255.0, chroma, w, h, device=dev),
                np.asarray(rgb_planes)[:, : h // 2],
                enc_one=lambda pl3: enc_fn(pl3, lut * 255.0, chroma),
                enc_base=planesj,
                nbytes=3 * img.size)   # 3 planes per frame

    if args.out_file and last_output is not None:
        if args.out_file.endswith(".sdt") and last_mode is not None:
            # self-describing container for the LAST mode that actually
            # RAN ("store the last output", src/main.cpp:594-606;
            # requested-but-unsupported/skipped modes must not be picked)
            from . import container as C
            last = last_mode
            if last == "enc-quant" and args.layout == "pair":
                last = "enc-quant-pair"   # the container's mode string
                # carries the byte layout, so decode needs no side channel
            src = rgb_planes if last.startswith("enc-quant32-ycbcr") else img
            C.encode(np.ascontiguousarray(src), last,
                     quality=args.quality, compress=args.compress,
                     rle=args.rle, sparse=args.sparse,
                     start_y=args.start_y, end_y=args.end_y,
                     view_layout=(args.stereo_layout
                                  if last == "enc-quant-stereo"
                                  else "interleaved"),
                     device=dev).tofile(args.out_file)
        else:
            last_output.tofile(args.out_file)
    return 0


if __name__ == "__main__":
    sys.exit(main())
