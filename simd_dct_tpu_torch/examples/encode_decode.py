"""Minimal encode -> decode walkthrough: mode32 records, the entropy-coded
``.sdt`` container and the native stereo layout.

    python -m simd_dct_tpu_torch.examples.encode_decode [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

import simd_dct_tpu_torch as sd
from simd_dct_tpu_torch.examples import Lines, check, device_arg
from simd_dct_tpu_torch.utils.metrics import psnr


def main(argv=None) -> list[str]:
    device = device_arg(argv, __doc__)
    out = Lines()
    # A smooth 512x512 test image (dual-view geometry: the top H/2 rows
    # are the view the non-stereo modes encode -- reference convention).
    H, W = 512, 512
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.clip(128 + 60 * np.sin(xx / 17) * np.cos(yy / 13),
                  0, 255).astype(np.uint8)

    # Functional api: mode32 (the coefficient-major layout) uses a
    # raw-domain LUT (255x the normalized table -- reference quirk).
    lut = sd.default_quant_lut(quality=100)
    records = sd.encode_quantize32(img, lut * 255.0, device=device)
    decoded = sd.decode_quantize32(records, lut * 255.0, W, H).cpu().numpy()
    out(f"mode32: {records.numel()} record bytes, "
        f"PSNR {psnr(decoded, img[:H // 2]):.2f} dB")

    # Config-bound facade (handles per-mode LUT conventions), plus the
    # entropy-coded pipeline and the self-describing .sdt container.
    enc = sd.Encoder(sd.EncoderConfig(quality=100, device=device))
    blob = enc.encode_container(img, "enc-quant32", rle=True)
    out(f"container: {blob.size} bytes "
        f"({img[:H // 2].size / blob.size:.1f}x vs raw records)")
    roundtrip = enc.decode_container(blob).cpu().numpy()
    check(np.array_equal(roundtrip, decoded),
          "container decode == direct decode")
    out("container decode == direct decode: ok")

    # Stereo mode with the native record layout: plane rows padded to a
    # 128-byte multiple, pad columns 127.
    nat = sd.api.encode_quantize_stereo(img, lut, view_layout="native",
                                        device=device)
    out(f"stereo native tensor: {tuple(nat.shape)} "
        f"(pad columns >= {W // 8} hold 127)")
    both = sd.api.decode_quantize_stereo(
        nat, lut, W, H, view_layout="native").cpu().numpy()
    out(f"stereo native round-trip: PSNR {psnr(both, img):.2f} dB")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
