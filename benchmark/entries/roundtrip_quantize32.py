"""``simd_dct_tpu_torch.roundtrip_quantize32``: a batch of dual-view buffers
in, their top views encoded in mode32 and decoded again out, the records
never stored."""

import numpy as np
import torch

from benchmark import inputs as _inputs
from benchmark import work as _work
from benchmark.reference import plain

CHUNK = 8       # buffers the reference takes at a time


def inputs(cfg: dict, wl: dict, seed: int, device) -> list[torch.Tensor]:
    """``wl["inputs"]`` batches of ``wl["batch"]`` seeded buffers: a frame
    on top, another below that the call never reads."""
    h, w = cfg["buffer"]
    return [_inputs.frames(_inputs.generator(seed, k, device), wl["batch"],
                           h, w, device) for k in range(wl["inputs"])]


def call(program, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    return program.roundtrip_quantize32(x, cfg["lut"])


def reference(x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    lut = np.asarray(cfg["lut"], np.float32)
    return torch.cat([plain.roundtrip32(x[lo:lo + CHUNK], lut, precision)
                      for lo in range(0, x.shape[0], CHUNK)])


def work(cfg: dict, wl: dict) -> _work.Work:
    h, w = cfg["buffer"]
    return _work.mode32_roundtrip(wl["batch"], h, w)
