"""The CUDA kernels against the plain version, on the card.

Marked ``cuda``; every test skips where ``torch.cuda.is_available()`` is
false.  The test configuration of this directory imports jax, which the
machine with the card does not have, so run these there with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports no jax.
"""

import numpy as np
import pytest
import torch

from simd_dct_tpu_torch import api as sd
from simd_dct_tpu_torch.core.quantize import default_quant_lut
from simd_dct_tpu_torch.kernels import cuda_dct as K
from simd_dct_tpu_torch.kernels import torch_path as TP
from simd_dct_tpu_torch.utils.debug import compare_backends

pytestmark = pytest.mark.cuda

LUT = default_quant_lut(50) * np.float32(255.0)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.Generator(device="cuda").manual_seed(0)


def _img(gen, *shape):
    return torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8,
                         device="cuda")


def _ok(a, b):
    rep = compare_backends({"kernel": a, "plain": b})["kernel-vs-plain"]
    assert rep["ok"], rep


@pytest.mark.parametrize("shape", [(256, 192), (272, 64), (3, 1088, 1920)])
@pytest.mark.parametrize("rounding", ["rne", "scalar", "clamp_first"])
def test_enc32_against_plain(gen, shape, rounding):
    img = _img(gen, *shape)
    _ok(K.encode_quantize32(img, LUT, rounding=rounding),
        TP.encode_quantize32(img, LUT, rounding=rounding))


def test_enc32_strip_range_and_int32_clamp(gen):
    img = _img(gen, 512, 128)
    _ok(K.encode_quantize32(img, LUT, 64, 1 << 40),
        TP.encode_quantize32(img, LUT, 64, 1 << 40))
    _ok(K.encode_quantize32(img, LUT, -(1 << 40), 63),
        TP.encode_quantize32(img, LUT, -(1 << 40), 63))


@pytest.mark.parametrize("shape", [(256, 192), (2, 1088, 1920)])
def test_dec32_and_roundtrip(gen, shape):
    img = _img(gen, *shape)
    h, w = shape[-2:]
    rec = TP.encode_quantize32(img, LUT)
    _ok(K.decode_quantize32(rec, LUT, w, h), TP.decode_quantize32(rec, LUT, w, h))
    fused = K.roundtrip_quantize32(img, LUT)
    composed = K.decode_quantize32(K.encode_quantize32(img, LUT), LUT, w, h)
    assert torch.equal(fused, composed)


def test_api_launches_kernels(gen):
    img = _img(gen, 2, 256, 128)
    K.reset_launch_counts()
    rec = sd.encode_quantize32(img, LUT)
    sd.decode_quantize32(rec, LUT, 128, 256)
    sd.roundtrip_quantize32(img, LUT)
    torch.cuda.synchronize()
    assert K.LAUNCHES["enc32"] == K.LAUNCHES["dec32"] == 1
    assert K.LAUNCHES["roundtrip32"] == 1


def test_wrappers_reject_misaligned(gen):
    flat = _img(gen, 256 * 128 + 1)
    with pytest.raises(ValueError):
        K.encode_quantize32(flat[1:].view(256, 128), LUT)
    rec = sd.encode_quantize32(flat[1:].view(256, 128), LUT)   # api realigns
    _ok(rec, TP.encode_quantize32(flat[1:].view(256, 128), LUT))
