"""BASELINE.json config ladder -- the full benchmark matrix (counterpart of
``simd_dct_tpu/bench/harness.py``).

Configs (BASELINE.md):
  1. 512x512 grayscale fp32 DCT+IDCT round-trip (lossless)
  2. 4K RGB planar per-channel round-trip
  3. quantized 4K RGB PSNR at JPEG-style luma/chroma tables + zigzag
  4. 64-frame 1080p-class batch, fused DCT/quant/IDCT, frames/s
  5. strip-sharded large-frame encode over every card (or the ``devices``
     given)

Each entry reports GB/s (logical u8 in+out), frames/s where applicable,
correctness (bit-exact / PSNR) and the device it ran on.  Every config runs
on the card unless the caller asks for the host (``device="cpu"``: the
plain PyTorch version, timed by the host's clock).  On the card a call's
time is ``utils.profiling.queued_ms``: CUDA events around calls queued
behind a device-side sleep, over a rotation of inputs larger than the L2
cache, median of ``REPS`` repetitions.  A timed line names its estimator
(``timer``) and carries ``ms_per_item``, ``bytes_per_item`` (the u8 bytes
an item reads; ``gbps`` counts them in and out) and ``items_per_call``.

    python -m simd_dct_tpu_torch.bench.harness [--device cuda|cpu]

prints one JSON line a config and exits 1 if any config raised.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ..dispatch.capability import default_device as _device
from ..utils.metrics import psnr as _psnr

REPS = 10                 # timed repetitions of a rotation on the card
HOST_REPS = 3             # ... on the host
ROTATION_BYTES = 64 << 20  # bytes a rotation reads: more than a 50 MB L2

# the full sizes of the public configs
CONFIG2_HW = (2048, 3840)        # one 4K RGB image: h, w
CONFIG3_HW = (2048, 3840)
CONFIG4_SHAPE = (64, 1088, 1920)  # frames, h, w
CONFIG5_W = 2048


def _smooth(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = (128 + 45 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
           + 30 * (xx / max(w - 1, 1)) + rng.normal(0, 3, (h, w)))
    return np.clip(img, 0, 255).astype(np.uint8)


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _lut100() -> np.ndarray:
    from ..core.quantize import default_quant_lut
    return default_quant_lut(100) * 255.0


def _chroma100() -> np.ndarray:
    from ..layout import BASE_CHROMA_QUANT_TABLE
    return BASE_CHROMA_QUANT_TABLE * 100 * 255.0


def _rotation(make, read_bytes: int, dev: torch.device) -> list:
    """Inputs for a timed rotation: on the card enough of them that a
    rotation reads more than the L2 holds; one on the host."""
    n = max(2, -(-ROTATION_BYTES // read_bytes)) if dev.type == "cuda" else 1
    return [make() for _ in range(n)]


def _random_u8(gen: torch.Generator, shape, dev: torch.device):
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device=dev)


def _generator(seed: int, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _seconds_per_call(fn, inputs, dev: torch.device, cards=(),
                      reps: int | None = None) -> tuple[float, str]:
    """Seconds a call of ``fn`` over the rotation ``inputs``, and the
    estimator's name.  On one card: ``queued_ms`` (``"queued_events"``).
    Across several cards: the host's clock around back-to-back rotations,
    each ended when every card is done, launch cost included
    (``"host_wall"``).  On the host: the host's clock (``"host_wall"``).
    Median of ``reps`` repetitions (default ``REPS`` on the card,
    ``HOST_REPS`` on the host)."""
    cards = sorted({str(c) for c in cards} | {str(dev)})
    if reps is None:
        reps = REPS if dev.type == "cuda" else HOST_REPS
    if dev.type == "cuda" and len(cards) == 1:
        from ..utils.profiling import queued_ms, sleep_cycles_per_ms
        with torch.cuda.device(dev):
            ms = queued_ms(fn, inputs, reps, sleep_cycles_per_ms())
        return ms / 1e3, "queued_events"

    def done():
        for c in cards:
            if c.startswith("cuda"):
                torch.cuda.synchronize(c)

    fn(inputs[0])
    done()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for x in inputs:
            fn(x)
        done()
        walls.append((time.perf_counter() - t0) / len(inputs))
    return statistics.median(walls), "host_wall"


def _gbps(n_bytes: int, seconds: float) -> float | None:
    """GB/s, or None where the estimate is not a positive finite time."""
    if not (np.isfinite(seconds) and seconds > 0):
        return None
    return round(n_bytes / seconds / 1e9, 2)


def _timed(name: str, gbps: float | None, dev: torch.device, per: float,
           timer: str, item_bytes: int, items: int, **fields) -> dict:
    """A timed config's line: ``per`` seconds an item by ``timer``, an
    item reading ``item_bytes``, ``items`` a call; ``measurement_noise``
    where the time is not finite."""
    res = {"config": name, "gbps": gbps, **fields,
           "device": _device_name(dev), "timer": timer,
           "ms_per_item": per * 1e3 if gbps is not None else None,
           "bytes_per_item": item_bytes, "items_per_call": items}
    if gbps is None:
        res["measurement_noise"] = True
    return res


# -- config 1 ------------------------------------------------------------------

def _lossless_roundtrip(x: torch.Tensor) -> torch.Tensor:
    """u8 (H, W) -> f32 DCT -> IDCT -> u8, on the tensor's device."""
    from ..core.dct import dct8x8, idct8x8
    from ..layout import blockize, unblockize
    b = blockize(x).to(torch.float32) / 255.0
    back = idct8x8(dct8x8(b)) * 255.0
    return unblockize(torch.clamp(torch.round(back), 0, 255)
                      .to(torch.uint8))


def config1_lossless_roundtrip(device=None):
    """512x512 fp32 DCT+IDCT: must be BIT-EXACT (BASELINE config 1)."""
    dev = _device(device)
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (512, 512), dtype=np.uint8)
    out = _lossless_roundtrip(torch.as_tensor(img, device=dev)).cpu().numpy()
    return {"config": "512x512 lossless round-trip",
            "bit_exact": bool(np.array_equal(out, img)),
            "device": _device_name(dev)}


# -- config 2 ------------------------------------------------------------------

def _rgb_image(seed: int, h: int, w: int) -> np.ndarray:
    """(h, w, 3) u8: three smooth planes drawn in turn from one seed."""
    rng = np.random.default_rng(seed)
    return np.stack([_smooth(rng, h, w) for _ in range(3)], axis=-1)


def _planar(rgb: np.ndarray, dev: torch.device) -> torch.Tensor:
    """(H, W, 3) u8 -> contiguous (3, H, W) planes on ``dev``."""
    return torch.as_tensor(np.ascontiguousarray(rgb.transpose(2, 0, 1)),
                           device=dev)


def _roundtrip_planes(planes: torch.Tensor) -> torch.Tensor:
    """(..., H, W) dual views -> the fused mode32 round trip of each TOP
    view, one call: (..., H/2, W).  The whole dual view goes in; a call on
    ``planes[..., :H/2, :]`` would round trip only its top H/4 rows."""
    from .. import api
    return api.roundtrip_quantize32(planes, _lut100())


def _config2(h: int, w: int, device=None) -> dict:
    from ..utils.profiling import hbm_peak_gbps
    dev = _device(device)
    rgb = _rgb_image(2, h, w)
    out = _roundtrip_planes(_planar(rgb, dev)).cpu().numpy()
    gen = _generator(2, dev)
    inputs = _rotation(lambda: _random_u8(gen, (3, h, w), dev),
                       3 * (h // 2) * w, dev)
    per, timer = _seconds_per_call(_roundtrip_planes, inputs, dev)
    per /= 3
    gbps = _gbps((h // 2) * w * 2, per)
    peak = hbm_peak_gbps(_device_name(dev))
    return _timed(
        "4K RGB planar round-trip", gbps, dev, per, timer, (h // 2) * w, 3,
        fraction_of_roofline=None if gbps is None or peak is None
        else round(gbps / peak, 4),
        psnr_db=round(_psnr(rgb[: h // 2].transpose(2, 0, 1), out), 2))


def config2_4k_rgb_roundtrip(device=None):
    """4K RGB planar deinterleave + per-channel fused mode32 round-trip:
    the three (2048, 3840) planes in one call (``roundtrip32_kernel``).
    ``fraction_of_roofline`` is against the card's device-memory peak
    (``utils.profiling.hbm_peak_gbps``), None where it is unknown."""
    return _config2(*CONFIG2_HW, device)


# -- the PSNR gate -------------------------------------------------------------

def _gate_planes(h2: int, w: int) -> np.ndarray:
    """(3, h2, w) u8: three correlated channels of one smooth field."""
    rng = np.random.default_rng(8)
    base = _smooth(rng, h2, w).astype(np.float32)
    return np.clip(np.stack([base, base * 0.9 + 12, base * 0.8 + 25]),
                   0, 255).astype(np.uint8)


def psnr_gate(h2: int = 1024, w: int = 3840, quality: float = 100.0,
              tol_db: float = 0.1, device=None) -> dict:
    """Fused-colour-pipeline PSNR as a GATE, not a report: the fused round
    trip (``api.roundtrip_quantize32_ycbcr``; on the card
    ``roundtrip32_rgb_kernel``) must be within ``tol_db`` of the composed
    plain version (``torch_path.encode_ycbcr32`` then ``decode_ycbcr32``)
    at the same tables on the same device.  Both are f32 with the same
    math, so any daylight is a regression.

    Synthetic RGB uses channel-correlated content (scaled copies of one
    smooth field) -- decorrelated channels cap PSNR ~34 dB regardless of
    correctness and would mask regressions."""
    from .. import api
    from ..core.quantize import default_quant_lut
    from ..kernels import torch_path
    from ..layout import BASE_CHROMA_QUANT_TABLE
    dev = _device(device)
    planes = _gate_planes(h2, w)
    luma = default_quant_lut(quality) * 255.0
    chroma = BASE_CHROMA_QUANT_TABLE * quality * 255.0
    top = torch.as_tensor(planes, device=dev)
    # the api round trips the top view of a dual view: the zero bottom
    # view is not read
    fused = api.roundtrip_quantize32_ycbcr(
        torch.cat([top, torch.zeros_like(top)], dim=1), luma, chroma)
    ref = torch_path.decode_ycbcr32(
        torch_path.encode_ycbcr32_view(top, luma, chroma), luma, chroma,
        w, 2 * h2)
    db = _psnr(planes, fused.cpu().numpy())
    ref_db = _psnr(planes, ref.cpu().numpy())
    return {"psnr_db": round(float(db), 2),
            "ref_psnr_db": round(float(ref_db), 2),
            "tol_db": tol_db, "pass": bool(db >= ref_db - tol_db)}


# -- config 3 ------------------------------------------------------------------

def _composed_zigzag(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) u8 RGB -> the TOP view's (H/2, W, 3) u8 RGB: YCbCr
    rounded to u8, per channel the plain mode32 encode, the records through
    zigzag order and back, the plain decode, the inverse mix."""
    from ..kernels import torch_path
    from ..layout import from_zigzag, rgb_to_ycbcr, to_zigzag, ycbcr_to_rgb
    h, w = rgb.shape[:2]
    ycc = rgb_to_ycbcr(rgb)
    chans = torch.clamp(torch.round(ycc), 0, 255).to(torch.uint8) \
        .permute(2, 0, 1)

    def one(pln, lut):
        rec = torch_path.encode_quantize32(pln, lut)
        # the entropy-coding-facing ordering of BASELINE config 3; mode32
        # records are (p, block)-major so zigzag acts on axis -2
        groups = rec.reshape(-1, 64, 8)
        zz = to_zigzag(groups.transpose(-1, -2))
        rec2 = from_zigzag(zz).transpose(-1, -2).reshape(rec.shape)
        return torch_path.decode_quantize32(rec2, lut, w, h)

    luma, chroma = _lut100(), _chroma100()
    ycc_out = torch.stack([one(chans[0], luma), one(chans[1], chroma),
                           one(chans[2], chroma)], dim=-1)
    return ycbcr_to_rgb(ycc_out.to(torch.float32))


def _color_roundtrip(planes: torch.Tensor) -> torch.Tensor:
    """(..., 3, H, W) planar RGB -> the fused colour round trip of the TOP
    view at quality 100: (..., 3, H/2, W)."""
    from .. import api
    return api.roundtrip_quantize32_ycbcr(planes, _lut100(), _chroma100())


def _config3(h: int, w: int, device=None) -> dict:
    dev = _device(device)
    rgb = _rgb_image(3, h, w)
    name = "4K RGB quantized (YCbCr luma/chroma) PSNR"
    if dev.type != "cuda":
        out = _composed_zigzag(torch.as_tensor(rgb, device=dev))
        return {"config": name,
                "psnr_db": round(_psnr(rgb[: h // 2], out.cpu().numpy()), 2),
                "device": _device_name(dev)}
    out3 = _color_roundtrip(_planar(rgb, dev)).cpu().numpy()
    gen = _generator(3, dev)
    inputs = _rotation(lambda: _random_u8(gen, (3, h, w), dev),
                       3 * (h // 2) * w, dev)
    per, timer = _seconds_per_call(_color_roundtrip, inputs, dev)
    gate = psnr_gate(h2=h // 2, w=w, device=dev)
    return _timed(
        name, _gbps(3 * (h // 2) * w * 2, per), dev, per, timer,
        3 * (h // 2) * w, 1,
        psnr_db=round(_psnr(rgb[: h // 2].transpose(2, 0, 1), out3), 2),
        tier="cuda_fused_color", gate=gate, **{"pass": gate["pass"]})


def config3_quantized_psnr(device=None):
    """Quantized 4K RGB with luma/chroma tables; PSNR report.

    On the card the whole YCbCr round trip runs in ONE fused kernel
    (``roundtrip32_rgb_kernel``: BT.601 mix + DCT + per-channel quant +
    inverse, coefficients never leave the chip), its speed is reported
    beside the PSNR, and ``psnr_gate`` holds it to the composed plain
    version at 0.1 dB.  On the host the plain version composes the same
    math per channel, rounds YCbCr to u8 and routes the records through
    zigzag ordering."""
    return _config3(*CONFIG3_HW, device)


# -- config 4 ------------------------------------------------------------------

def _config4(frames: int, h: int, w: int, device=None) -> dict:
    dev = _device(device)
    gen = _generator(4, dev)
    inputs = _rotation(lambda: _random_u8(gen, (frames, h, w), dev),
                       frames * (h // 2) * w, dev)
    per, timer = _seconds_per_call(_roundtrip_planes, inputs, dev)
    per /= frames
    gbps = _gbps((h // 2) * w * 2, per)
    return _timed(f"{frames}-frame 1080p fused round-trip (per frame)",
                  gbps, dev, per, timer, (h // 2) * w, frames,
                  frames_per_s=None if gbps is None else round(1.0 / per, 1))


def config4_video_batch(device=None):
    """Batched video: 64 frames of 1088x1920 through the fused round trip
    in one call, frames/s per card.  H2 = 544 is not a multiple of the
    round trip's 2-strip tiles (short tiles); 1080 itself violates the
    H % 16 dual-view contract, so 1088 is the nearest valid height."""
    return _config4(*CONFIG4_SHAPE, device)


# -- config 5 ------------------------------------------------------------------

def _sharded_encode(img: torch.Tensor, mesh):
    """The strip-sharded mode32 encode of ``img``'s top view at quality
    100: records split over the mesh, one launch a shard on the card."""
    from .. import dist
    return dist.encode_quantize32_sharded(img, _lut100(), mesh)


def _config5_mesh(device=None, devices=None):
    """Config 5's mesh: the ``devices`` given, else every card, else one
    shard on the host."""
    from .. import dist
    if devices is not None:
        return dist.make_mesh(len(devices), devices=devices)
    if _device(device).type == "cuda":
        return dist.make_mesh()
    return dist.make_mesh(1, devices=["cpu"])


def _config5_hw(shards: int) -> tuple[int, int]:
    """Config 5's image for ``shards`` shards: ten 256-row strip pairs a
    shard (the JAX ladder's larger height; strips divide evenly)."""
    return 2 * 256 * shards * 10, CONFIG5_W


def _config5(mesh, h: int, w: int, reps: int) -> dict:
    dev = mesh.devices.flat[0]
    gen = _generator(5, dev)
    inputs = _rotation(lambda: _random_u8(gen, (h, w), dev),
                       (h // 2) * w, dev)
    per, timer = _seconds_per_call(
        lambda x: _sharded_encode(x, mesh), inputs, dev,
        cards=list(mesh.devices.flat), reps=reps)
    return _timed(f"strip-sharded encode over {mesh.size} device(s)",
                  _gbps((h // 2) * w * 2, per), dev, per, timer,
                  (h // 2) * w, 1)


def config5_sharded(reps=8, device=None, devices=None):
    """Tile-sharded large-frame encode across the cards (or the
    ``devices`` given: ``["cuda:0"] * 4`` shards one card four ways), one
    shard a device.  The image is (5120 n, 2048) for n shards; the time is
    one call's, median of ``reps`` repetitions.  Over several cards it is
    the host's wall (``timer: "host_wall"``), not comparable with the
    queued device times of one card."""
    mesh = _config5_mesh(device, devices)
    return _config5(mesh, *_config5_hw(mesh.size), reps)


ALL_CONFIGS = [config1_lossless_roundtrip, config2_4k_rgb_roundtrip,
               config3_quantized_psnr, config4_video_batch, config5_sharded]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m simd_dct_tpu_torch.bench.harness",
        description="The BASELINE config ladder: one JSON line a config.")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu: the plain version on the "
                    "host")
    args = ap.parse_args([] if argv is None else argv)
    failed = 0
    for cfg in ALL_CONFIGS:
        try:
            print(json.dumps(cfg(device=args.device)), flush=True)
        except Exception as e:  # keep the ladder running; fail at the end
            failed += 1
            print(json.dumps({"config": cfg.__name__,
                              "error": str(e)[:200]}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
