"""Strip-sharded encode on a mesh of 8 shards of one device (virtual
shards: each position of the mesh is a shard of its own on the same card,
or on the host with ``--device cpu``).

    python -m simd_dct_tpu_torch.examples.sharded [--device cuda|cpu]

On several cards the same code shards over ``dist.make_mesh(n)`` (blocks
never cross 16-row boundaries, so strip sharding needs no collective; the
stereo planar gather, ``gather=True``, runs the plane ring all-gather
kernel on the card).
"""

from __future__ import annotations

import sys

import numpy as np

from simd_dct_tpu_torch import dist
from simd_dct_tpu_torch.core.quantize import default_quant_lut
from simd_dct_tpu_torch.dispatch.capability import default_device
from simd_dct_tpu_torch.examples import Lines, device_arg


def main(argv=None) -> list[str]:
    device = default_device(device_arg(argv, __doc__))
    out = Lines()
    mesh = dist.make_mesh(8, devices=[device] * 8)
    out(f"mesh: {mesh.shape} on {mesh.device_type}")

    lut = default_quant_lut(100)
    H, W = 16 * 8 * 8, 256        # 8 strips per shard
    img = np.clip(128 + 60 * np.sin(np.mgrid[0:H, 0:W][1] / 9),
                  0, 255).astype(np.uint8)

    rec = dist.encode_quantize32_sharded(img, lut * 255.0, mesh)
    dec = dist.decode_quantize32_sharded(rec, lut * 255.0, W, H, mesh)
    out(f"sharded mode32 encode+decode ok: {tuple(dec.full().shape)}")

    seg = dist.encode_quantize_stereo_sharded(img, lut, mesh, gather=True)
    out(f"stereo planar encode + all-gather ok: replicated="
        f"{seg.is_fully_replicated}")

    # Native stereo record layout: each shard's plane rows already sit at
    # a 128-byte multiple, so per-shard stores and any later gather copy
    # whole rows.
    nat = dist.encode_quantize_stereo_sharded(img, lut, mesh,
                                              view_layout="native")
    ndec = dist.decode_quantize_stereo_sharded(nat, lut, W, H, mesh,
                                               view_layout="native")
    out(f"stereo native sharded encode+decode ok: {tuple(nat.full().shape)}"
        f" -> {tuple(ndec.full().shape)}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
