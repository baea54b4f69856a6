"""The benchmark's frozen reference against the program's plain version on
the CPU.  The reference itself imports nothing of the program."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import plain
from simd_dct_tpu_torch.core.quantize import BASE_QUANT_TABLE
from simd_dct_tpu_torch.kernels import torch_path as tp

LUT = BASE_QUANT_TABLE
LUT32 = BASE_QUANT_TABLE * np.float32(255.0)


def _frames(seed, n=2, h=64, w=128):
    g = torch.Generator().manual_seed(seed)
    smooth = torch.nn.functional.interpolate(
        torch.rand((n, 1, h // 16, w // 16), generator=g) * 255,
        size=(h, w), mode="bilinear", align_corners=False)[:, 0]
    noise = torch.randn((n, h, w), generator=g) * 6
    return (smooth + noise).round().clamp(0, 255).to(torch.uint8)


def _agree(a, b, worst=1, share=0.002):
    d = (a.to(torch.int16) - b.to(torch.int16)).abs()
    assert a.shape == b.shape
    assert int(d.max()) <= worst
    assert int(torch.count_nonzero(d)) <= share * d.numel()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stereo_encode_matches_plain_version(seed):
    img = _frames(seed)
    _agree(plain.encode_stereo(img, LUT), tp.encode_quantize_stereo(img, LUT))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stereo_decode_matches_plain_version(seed):
    rec = tp.encode_quantize_stereo(_frames(seed), LUT)
    _agree(plain.decode_stereo(rec, LUT, 128, 64),
           tp.decode_quantize_stereo(rec, LUT, 128, 64))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mode32_encode_matches_plain_version(seed):
    img = _frames(seed)
    _agree(plain.encode32(img, LUT32), tp.encode_quantize32(img, LUT32))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mode32_roundtrip_matches_plain_version(seed):
    img = _frames(seed)
    _agree(plain.roundtrip32(img, LUT32), tp.roundtrip_quantize32(img, LUT32))


def test_tf32_control_departs_from_float32():
    img = _frames(5, n=4)
    a = plain.encode_stereo(img, LUT, "float32")
    b = plain.encode_stereo(img, LUT, "tf32")
    assert int(torch.count_nonzero(a != b)) > 0.01 * a.numel()


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 3 * 2**-11,
                      -1.0 - 3 * 2**-11, 255.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0, 1.0 + 2**-9,
                         -1.0 - 2**-9, 255.0])
    assert torch.equal(plain._tf32(x), want)


def test_reference_imports_nothing_of_the_program():
    for path in (Path(plain.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert name.split(".")[0] in ("__future__", "contextlib",
                                              "numpy", "torch"), (path, name)


def test_unknown_precision_is_refused():
    with pytest.raises(ValueError):
        plain.encode32(_frames(0), LUT32, "bf16")
