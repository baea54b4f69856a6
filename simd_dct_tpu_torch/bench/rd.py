"""Rate-distortion sweep: quality -> (bits/px, PSNR) over the whole codec
(encode -> entropy pack for the rate; decode -> PSNR against the source
for the distortion).  Counterpart of ``simd_dct_tpu/bench/rd.py``.

Runs on the card unless the caller asks for the host (``device="cpu"``:
the plain version); rates and PSNR agree across the two up to the
documented +-1-byte contract.

    from simd_dct_tpu_torch.bench.rd import rd_curve
    rows = rd_curve(img, qualities=(50, 75, 100, 150, 200))

    python -m simd_dct_tpu_torch.bench.rd image.raw W H [--mode enc-quant32]
        [--qualities 50,75,100,150,200] [--rle] [--sparse] [--device cpu]
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class RDPoint:
    quality: float
    bits_per_px: float      # entropy-packed record bits per SOURCE pixel
    raw_bits_per_px: float  # unpacked record bits per source pixel
    psnr_db: float          # decode vs the pixels the mode covers
    rail_frac: float = 0.0  # record bytes clipped at the 0/255 rails:
    #                         nonzero means this point sits in the
    #                         clipping regime where PSNR bends
    #                         non-monotonically

    def row(self) -> str:
        rail = (f" | rail {self.rail_frac:.2%}" if self.rail_frac
                else "")
        return (f"q={self.quality:<6g} | {self.bits_per_px:6.3f} bpp "
                f"(raw {self.raw_bits_per_px:5.2f}) | "
                f"PSNR {self.psnr_db:6.2f} dB" + rail)


_MODES = ("enc-quant", "enc-quant-pair", "enc-quant32",
          "enc-quant-stereo", "enc-quant32-ycbcr", "enc-quant32-ycbcr420")


def _pipeline(mode: str, img: torch.Tensor, quality: float, backend):
    """(flat records tensor, decoded tensor, covered source pixels), all on
    the image's device."""
    from .. import api
    from ..core.quantize import default_quant_lut
    from ..layout.color import BASE_CHROMA_QUANT_TABLE

    lut = default_quant_lut(quality)
    h, w = img.shape[-2], img.shape[-1]
    kw = dict(backend=backend)
    if mode in ("enc-quant", "enc-quant-pair"):
        layout = "pair" if mode.endswith("pair") else "scalar"
        rec = api.encode_quantize(img, lut, layout=layout, **kw)
        dec = api.decode_quantize(rec, lut, w, h, layout=layout, **kw)
        src = img[: h // 2]
    elif mode == "enc-quant32":
        rec = api.encode_quantize32(img, lut * 255.0, **kw)
        dec = api.decode_quantize32(rec, lut * 255.0, w, h, **kw)
        src = img[: h // 2]
    elif mode == "enc-quant-stereo":
        rec = api.encode_quantize_stereo(img, lut, **kw)
        dec = api.decode_quantize_stereo(rec, lut, w, h, **kw)
        src = img
    else:
        chroma = BASE_CHROMA_QUANT_TABLE * quality * 255.0
        enc = (api.encode_quantize32_ycbcr420 if mode.endswith("420")
               else api.encode_quantize32_ycbcr)
        decf = (api.decode_quantize32_ycbcr420 if mode.endswith("420")
                else api.decode_quantize32_ycbcr)
        rec = enc(img, lut * 255.0, chroma, **kw)
        dec = decf(rec, lut * 255.0, chroma, w, h, **kw)
        src = img[:, : h // 2]
    return rec.reshape(-1), dec, src


def rd_curve(img, qualities=(50, 75, 100, 150, 200), *,
             mode: str = "enc-quant32", rle: bool = False,
             sparse: bool = False, backend: str | None = None,
             device=None):
    """Sweep ``qualities`` and return a list of :class:`RDPoint`.

    ``img``: (H, W) u8 (or (3, H, W) planar RGB for the ycbcr modes),
    reference dual-view geometry; a tensor stays on its device, other
    input goes to ``device`` (the card unless it names another).  Rate =
    entropy-packed record bytes (``rle`` / ``sparse`` select the stream
    format; the table from the histogram on the records' device) per
    SOURCE pixel the mode covers; distortion = PSNR of the decode against
    those pixels.

    Quality convention (reference quirk, src/main.cpp:214-217): the number
    MULTIPLIES the quant table, so a larger quality means coarser
    quantization, fewer bits and a lower PSNR.  Values well below ~50
    push coefficients into the record's +-127 clamp (clipping: PSNR
    collapses while the rate rises), so a useful sweep runs upward from
    ~50."""
    from .. import entropy
    from ..api import InvalidParameterError, _as_tensor
    from ..utils.metrics import psnr

    if mode not in _MODES:
        raise InvalidParameterError(
            f"mode must be one of {_MODES}, got {mode!r}")
    img = _as_tensor(img, device, "image")
    out = []
    for q in qualities:
        rec, dec, src = _pipeline(mode, img, float(q), backend)
        # RD curves report the ratio-optimal coding: the plain pack on
        # dense points (dense_fast trades ~20% of the ratio for pack
        # speed, which an RD sweep must not fold in quietly)
        packed = (entropy.compress_sparse(rec, rle=rle, dense_fast=False)
                  if sparse else entropy.compress_records(rec, rle=rle))
        npx = src.numel()
        flat = rec.cpu().numpy()
        out.append(RDPoint(
            quality=float(q),
            bits_per_px=8.0 * packed.size / npx,
            raw_bits_per_px=8.0 * flat.size / npx,
            psnr_db=float(psnr(dec.cpu().numpy(), src.cpu().numpy())),
            rail_frac=float(((flat == 0) | (flat == 255)).mean()),
        ))
    return out


def _main(argv=None) -> int:
    import argparse

    from ..api import NotSupportedError
    from ..dispatch.capability import default_device

    p = argparse.ArgumentParser(prog="simd_dct_tpu_torch.bench.rd")
    p.add_argument("file")
    p.add_argument("width", type=int)
    p.add_argument("height", type=int)
    p.add_argument("--mode", choices=_MODES, default="enc-quant32")
    p.add_argument("--qualities", default="50,75,100,150,200")
    p.add_argument("--rle", action="store_true")
    p.add_argument("--sparse", action="store_true")
    p.add_argument("--device", default=None,
                   help="where to run: the card by default; 'cpu' runs the "
                        "plain version on the host")
    args = p.parse_args(argv)
    try:
        dev = default_device(args.device)
    except NotSupportedError:
        print("error: no CUDA device on this machine; pass --device cpu "
              "to run the plain version on the host")
        return 1

    w, h = args.width, args.height
    data = np.fromfile(args.file, np.uint8)
    if args.mode.startswith("enc-quant32-ycbcr"):
        img = data[: 3 * h * w].reshape(3, h, w)
    else:
        img = data[: h * w].reshape(h, w)
    qs = [float(x) for x in args.qualities.split(",") if x]
    for pt in rd_curve(img, qs, mode=args.mode, rle=args.rle,
                       sparse=args.sparse, device=dev):
        print(pt.row())
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
