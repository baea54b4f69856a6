"""The port's rate-distortion sweep (``bench.rd``), zigzag order
(``layout.zigzag``) and 1-D DCT (``core.dct8`` / ``idct8``) against the
JAX package's, on the CPU.

Inputs: a seeded smooth 64x128 view and 3x64x256 planar RGB of correlated
channels (4:2:0 needs W % 128 == 0 and H % 32 == 0).  The JAX sweep runs
its ``xla`` tier once per mode, in a module-scoped fixture; the port its
plain version (``device="cpu"``).  Tolerances:
  * PSNR of each point: within 0.1 dB (``test_torch_mode32.py``'s
    round-trip tolerance); raw bits per pixel: exact;
  * packed bits per pixel: no larger than the JAX package's -- the one
    known difference of the coders is the port's stored pre-check, which
    may write a smaller pack where the JAX package's fixed slack stores
    (ROADMAP Queue 3 (c));
  * the zigzag permutation, its take and round trip: exact;
  * dct8 / idct8 on unit-variance input: 1e-5 absolute against the JAX
    functions (both f32 at full precision).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simd_dct_tpu import core as JCORE
from simd_dct_tpu.bench import rd as JRD
from simd_dct_tpu.layout import zigzag as JZ
from simd_dct_tpu_torch import core
from simd_dct_tpu_torch import layout
from simd_dct_tpu_torch.bench import rd

REPO = Path(__file__).resolve().parents[1]
QUALITIES = (50.0, 100.0)
MODES = ("enc-quant32", "enc-quant32-ycbcr420")


def _field(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return 128 + 60 * np.sin(xx / 11) * np.cos(yy / 7)


def _image(mode):
    if mode.startswith("enc-quant32-ycbcr"):
        f = _field(64, 256)
        return np.stack([np.clip(f * s, 0, 255)
                         for s in (1.0, 0.8, 0.6)]).astype(np.uint8)
    return np.clip(_field(64, 128), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_curves():
    return {m: JRD.rd_curve(_image(m), QUALITIES, mode=m, backend="xla")
            for m in MODES}


@pytest.mark.parametrize("mode", MODES)
def test_rd_curve_against_jax(jax_curves, mode):
    port = rd.rd_curve(_image(mode), QUALITIES, mode=mode, device="cpu")
    assert len(port) == len(QUALITIES)
    for p, j in zip(port, jax_curves[mode]):
        assert p.quality == j.quality
        assert abs(p.psnr_db - j.psnr_db) < 0.1, (p, j)
        assert p.raw_bits_per_px == j.raw_bits_per_px
        assert p.bits_per_px <= j.bits_per_px, (p, j)
        assert abs(p.rail_frac - j.rail_frac) <= 0.002
        assert p.row().split("|")[0] == j.row().split("|")[0]


@pytest.mark.parametrize("mode", rd._MODES)
def test_rd_curve_every_mode(mode):
    """Every mode sweeps; coarser quantization never costs more bits."""
    img = _image(mode)
    if mode == "enc-quant32-ycbcr":
        img = img[:, :, :128]
    pts = rd.rd_curve(img, (100.0, 200.0), mode=mode, device="cpu")
    assert pts[0].bits_per_px >= pts[1].bits_per_px
    assert all(np.isfinite(p.psnr_db) for p in pts)
    sparse = rd.rd_curve(img, (100.0,), mode=mode, sparse=True, rle=True,
                         device="cpu")
    assert sparse[0].psnr_db == pts[0].psnr_db


def test_rd_bad_mode():
    from simd_dct_tpu_torch.api import InvalidParameterError
    with pytest.raises(InvalidParameterError):
        rd.rd_curve(_image("enc-quant32"), (50,), mode="nope", device="cpu")


def _run_module(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.run([sys.executable, "-m", *args], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_python_m_rd(tmp_path):
    path = tmp_path / "img.raw"
    _image("enc-quant32").tofile(path)
    proc = _run_module("simd_dct_tpu_torch.bench.rd", str(path), "128", "64",
                       "--qualities", "50,100", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    want = rd.rd_curve(_image("enc-quant32"), QUALITIES, device="cpu")
    assert lines == [p.row() for p in want]
    if not torch.cuda.is_available():
        proc = _run_module("simd_dct_tpu_torch.bench.rd", str(path), "128",
                           "64")
        assert proc.returncode != 0 and "--device cpu" in proc.stdout


# ---------------------------------------------------------------------------
# zigzag
# ---------------------------------------------------------------------------

def test_zigzag_order_equals_jax():
    assert np.array_equal(layout.zigzag_order(), JZ.zigzag_order())
    assert np.array_equal(layout.zigzag_inverse_order(),
                          JZ.zigzag_inverse_order())
    assert layout.zigzag_order()[:6].tolist() == [0, 1, 8, 16, 9, 2]


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_to_from_zigzag(dtype):
    rng = np.random.default_rng(3)
    x = (rng.integers(0, 256, (5, 3, 64)) if dtype == np.uint8
         else rng.standard_normal((5, 3, 64))).astype(dtype)
    t = torch.from_numpy(x)
    z = layout.to_zigzag(t)
    assert np.array_equal(z.numpy(), np.asarray(JZ.to_zigzag(x)))
    assert torch.equal(layout.from_zigzag(z), t)
    assert np.array_equal(layout.from_zigzag(t).numpy(),
                          np.asarray(JZ.from_zigzag(x)))


# ---------------------------------------------------------------------------
# dct8 / idct8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("axis", [-1, 0, 1])
def test_dct8_idct8_against_jax(axis):
    rng = np.random.default_rng(7 + axis)
    shape = [4, 6, 5]
    shape[axis] = 8
    x = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x)
    fwd = core.dct8(t, axis=axis)
    assert np.allclose(fwd.numpy(), np.asarray(JCORE.dct8(x, axis=axis)),
                       rtol=0, atol=1e-5)
    inv = core.idct8(t, axis=axis)
    assert np.allclose(inv.numpy(), np.asarray(JCORE.idct8(x, axis=axis)),
                       rtol=0, atol=1e-5)
    assert np.allclose(core.idct8(fwd, axis=axis).numpy(), x, rtol=0,
                       atol=1e-5)
