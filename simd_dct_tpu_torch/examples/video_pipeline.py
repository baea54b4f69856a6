"""Batched video codec: one encode call for N frames, per-frame random
access, streaming overlap.

    python -m simd_dct_tpu_torch.examples.video_pipeline [--device cuda|cpu]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

import simd_dct_tpu_torch as sd
from simd_dct_tpu_torch import container
from simd_dct_tpu_torch.examples import Lines, check, device_arg
from simd_dct_tpu_torch.utils.feed import (stream_decode32_compressed,
                                           stream_encode32_compressed)


def main(argv=None) -> list[str]:
    device = device_arg(argv, __doc__)
    out = Lines()
    H, W = 128, 256
    frames = np.stack([
        np.clip(128 + 60 * np.sin((np.mgrid[0:H, 0:W][1] + 3 * t) / 11),
                0, 255).astype(np.uint8)
        for t in range(8)])

    # .sdtv container: frames encode in ONE batched call; payloads are
    # per-frame (random access) with a shared Huffman table.
    clip = container.encode_video(frames, "enc-quant32", quality=50.0,
                                  device=device)
    meta = container.video_info(clip)
    out(f"clip: {meta.n_frames} frames {meta.size_x}x{meta.size_y}, "
        f"{clip.size} bytes ({frames[:, :H // 2].size / clip.size:.1f}x)")

    # only payload 5 is unpacked; the batch decodes in one call
    frame5 = container.decode_video_frame(clip, 5, device=device)
    batch = container.decode_video(clip, device=device)
    check(torch.equal(frame5, batch[5]),
          "random-access frame == batch decode")
    out("random-access frame == batch decode: ok")

    # Streaming form: the device encodes frame k+1 while the host Huffman-
    # packs frame k (bounded lookahead, constant memory).  sparse=True
    # drops all-127 64-byte blocks on the device first (SDS1) so the host
    # packs only significant content; the streams stay decodable by the
    # same entry.
    lut = sd.default_quant_lut(50) * 255.0
    blobs = list(stream_encode32_compressed(iter(frames), lut, sparse=True,
                                            device=device))
    out(f"streamed {len(blobs)} sparse-compressed frames, "
        f"{sum(b.size for b in blobs)} bytes total")

    # Streaming inverse: host unpack of blob k+1 overlaps the device
    # decode of blob k.
    outs = list(stream_decode32_compressed(iter(blobs), lut, W, H,
                                           device=device))
    check(all(o.shape == (H // 2, W) for o in outs), "decoded frame shapes")
    out(f"streamed {len(outs)} decoded frames back: ok")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
