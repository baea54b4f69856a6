"""Serving-shaped walkthrough: the sustained video pipeline with every
device/host split engaged.

The shape of a production loop on a card's host:
  ingest -> device encode (fused mode32) -> content-adaptive entropy
  (SDS1 sparse / SDN1/SDN2 dense ladder, split ON DEVICE for
  device-resident records) -> .sdtv container -> random-access or
  streaming decode with device-side expansion (parts upload, not full
  records).

    python -m simd_dct_tpu_torch.examples.serving [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np

import simd_dct_tpu_torch as sd
from simd_dct_tpu_torch import container, entropy
from simd_dct_tpu_torch.examples import Lines, check, device_arg
from simd_dct_tpu_torch.utils import feed


def main(argv=None) -> list[str]:
    device = device_arg(argv, __doc__)
    out = Lines()
    H, W = 256, 256      # dual-view buffer; the top H/2 rows are the view
    lut = sd.default_quant_lut(100) * 255.0

    # a short clip: smooth frames (sparse-friendly) with a dense outlier
    jj, ii = np.mgrid[0:H, 0:W]
    smooth = np.clip(128 + 70 * np.sin(jj / 13) * np.cos(ii / 17),
                     0, 255).astype(np.uint8)
    rng = np.random.default_rng(0)
    # every record block of the dense frame is significant: the SDN path
    dense = rng.integers(0, 256, (H, W), dtype=np.uint8)
    frames = np.stack([np.roll(smooth, 7 * k, axis=1) for k in range(3)]
                      + [dense])

    # 1) one-shot: batched encode -> per-frame sparse streams -> container
    clip = container.encode_video(frames, "enc-quant32", quality=100.0,
                                  sparse=True, device=device)
    meta = container.video_info(clip)
    out(f"clip: {meta.n_frames} frames, {clip.size} bytes "
        f"({frames[:, :H // 2].size / clip.size:.1f}x vs raw records)")

    # 2) random access: only frame k's payload is unpacked; on the card
    #    SDN/SDS payloads ship parts and expand there
    one = container.decode_video_frame(clip, 2, device=device)
    check(tuple(one.shape) == (H // 2, W), "random-access frame shape")
    out("random-access frame decode: ok")

    # 3) streaming: device encode of frame k+1 overlaps the host pack of
    #    frame k; the content-adaptive ladder picks SDS1 for the smooth
    #    frames and the SDN dense path for the outlier
    blobs = list(feed.stream_encode32_compressed(
        iter(list(frames)), lut, sparse=True, device=device))
    kinds = []
    for b in blobs:
        m = int(np.frombuffer(b[:4].tobytes(), np.uint32)[0])
        kinds.append({entropy._MAGICS: "SDS1", entropy._MAGICN: "SDN1",
                      entropy._MAGICN2: "SDN2"}.get(m, "plain"))
    out(f"per-frame stream formats: {kinds}")

    # 4) streaming decode: host unpack of blob k+1 overlaps the device
    #    decode of blob k; SDN/SDS streams expand on the device from parts
    outs = list(feed.stream_decode32_compressed(iter(blobs), lut, W, H,
                                                device=device))
    check(len(outs) == len(frames), "a decoded frame a stream")
    ref = sd.roundtrip_quantize32(frames[0], lut, device=device).cpu().numpy()
    check(np.abs(outs[0].astype(int) - ref.astype(int)).max() <= 2,
          "the streamed decode within 2 of the fused round trip")
    out(f"streamed {len(outs)} frames back through the device "
        "expansion: ok")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
