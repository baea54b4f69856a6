"""``simd_dct_tpu_torch.decode_quantize_stereo``: a batch of dual views'
interleaved stereo records in, the dual views out.  The records are the
benchmark's own: its plain encoder, run on the card on seeded views."""

import numpy as np
import torch

from benchmark import inputs as _inputs
from benchmark import work as _work
from benchmark.reference import plain

CHUNK = 2       # dual views the reference takes at a time


def inputs(cfg: dict, wl: dict, seed: int, device) -> list[torch.Tensor]:
    """``wl["inputs"]`` batches of the records of ``wl["batch"]`` seeded
    dual views."""
    h, w = cfg["buffer"]
    lut = np.asarray(cfg["lut"], np.float32)
    out = []
    for k in range(wl["inputs"]):
        views = _inputs.frames(_inputs.generator(seed, k, device),
                               wl["batch"], h, w, device)
        out.append(torch.cat([plain.encode_stereo(views[lo:lo + CHUNK], lut)
                              for lo in range(0, wl["batch"], CHUNK)]))
        del views
    return out


def call(program, x: torch.Tensor, cfg: dict) -> torch.Tensor:
    h, w = cfg["buffer"]
    return program.decode_quantize_stereo(x, cfg["lut"], w, h,
                                          view_layout=cfg["view_layout"])


def reference(x: torch.Tensor, cfg: dict, precision: str) -> torch.Tensor:
    h, w = cfg["buffer"]
    lut = np.asarray(cfg["lut"], np.float32)
    return torch.cat([plain.decode_stereo(x[lo:lo + CHUNK], lut, w, h,
                                          precision)
                      for lo in range(0, x.shape[0], CHUNK)])


def work(cfg: dict, wl: dict) -> _work.Work:
    h, w = cfg["buffer"]
    return _work.stereo_decode(wl["batch"], h, w)
