"""``simd_dct_tpu_torch.encode_quantize_stereo``: a batch of dual views in,
their interleaved stereo records out (the upstream's ``enc-quant-stereo``)."""

import numpy as np
import torch

from benchmark import inputs as _inputs
from benchmark import work as _work
from benchmark.reference import plain

CHUNK = 2       # dual views the reference takes at a time


def inputs(cfg: dict, wl: dict, seed: int, device) -> list[torch.Tensor]:
    """``wl["inputs"]`` batches of ``wl["batch"]`` seeded dual views."""
    h, w = cfg["buffer"]
    return [_inputs.frames(_inputs.generator(seed, k, device), wl["batch"],
                           h, w, device) for k in range(wl["inputs"])]


def call(program, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    return program.encode_quantize_stereo(
        x, cfg["lut"], rounding=cfg["rounding"],
        view_layout=cfg["view_layout"])


def reference(x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    lut = np.asarray(cfg["lut"], np.float32)
    return torch.cat([plain.encode_stereo(x[lo:lo + CHUNK], lut, precision)
                      for lo in range(0, x.shape[0], CHUNK)])


def work(cfg: dict, wl: dict) -> _work.Work:
    h, w = cfg["buffer"]
    return _work.stereo_encode(wl["batch"], h, w)
