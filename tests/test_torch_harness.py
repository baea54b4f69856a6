"""The port's BASELINE config ladder (``simd_dct_tpu_torch.bench.harness``)
against the JAX package's (``simd_dct_tpu/bench/harness.py``), on the CPU.

Each config's computation runs at a small geometry through the port's
plain version (``device="cpu"``) and through the JAX config's non-Pallas
branch (``kernels/xla_path.py``, ``kernels/color32.py``'s composed tier,
``dist`` on a mesh of 2 of the 8 CPU devices) on the same numpy inputs.
Tolerances:
  * ``_smooth``, the inputs of every config: byte for byte;
  * config 1: bit-exact in both packages;
  * the gate's composed reference: within 0.01 dB of the JAX composed
    tier's PSNR (the same f32 math in two frameworks);
  * the u8 outputs of configs 2, 3 (fused), 4 and 5: at most +-1 on at
    most 0.2% of bytes -- the ``compare_backends`` contract;
  * config 3's composed route (YCbCr rounded to u8, each plane through the
    mode32 round trip and zigzag, then the inverse mix): at most 3 on at
    most 0.6% of the RGB bytes -- the contract on each decoded YCbCr
    plane carried through the inverse mix (|dR| <= |dY| + 1.402 |dCr|
    plus the rounding), and each RGB byte reads up to three planes.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simd_dct_tpu import dist as JD
from simd_dct_tpu import layout as JL
from simd_dct_tpu.bench import harness as JH
from simd_dct_tpu.core.quantize import default_quant_lut
from simd_dct_tpu.kernels import color32 as JC
from simd_dct_tpu.kernels import xla_path as X
from simd_dct_tpu_torch import dist as TD
from simd_dct_tpu_torch.bench import harness as H
from simd_dct_tpu_torch.utils.debug import compare_backends
from simd_dct_tpu_torch.utils.metrics import psnr

CPU = torch.device("cpu")
LUT = default_quant_lut(100) * 255.0
CHROMA = JL.BASE_CHROMA_QUANT_TABLE * 100 * 255.0


def _contract(got, want):
    rep = compare_backends({"port": np.asarray(got),
                            "jax": np.asarray(want)})["port-vs-jax"]
    assert rep["ok"], rep


@pytest.mark.parametrize("seed", range(1, 9))
def test_smooth_equals_jax(seed):
    a = H._smooth(np.random.default_rng(seed), 48, 80)
    b = JH._smooth(np.random.default_rng(seed), 48, 80)
    np.testing.assert_array_equal(a, b)


def test_config1_bit_exact_in_both():
    assert H.config1_lossless_roundtrip(device="cpu")["bit_exact"]
    assert JH.config1_lossless_roundtrip()["bit_exact"]


def test_psnr_gate_against_jax_composed_tier():
    gate = H.psnr_gate(h2=128, w=512, device="cpu")
    planes = H._gate_planes(128, 512)
    pj = jnp.asarray(planes)
    ref = np.asarray(JC.decode_ycbcr_xla(
        JC.encode_ycbcr_xla(pj, jnp.asarray(LUT), jnp.asarray(CHROMA)),
        jnp.asarray(LUT), jnp.asarray(CHROMA)))
    assert abs(gate["ref_psnr_db"] - psnr(planes, ref)) <= 0.01, gate
    assert gate["pass"], gate
    assert gate["psnr_db"] > 36.0, gate
    assert set(gate) == {"psnr_db", "ref_psnr_db", "tol_db", "pass"}
    # the comparison is not vacuous: past the fused leg's daylight it fails
    assert not H.psnr_gate(h2=128, w=512, tol_db=-1.0,
                           device="cpu")["pass"]


def _jax_roundtrip32(view, h, w):
    """JAX config 2's non-Pallas ``one``: the bare view's encode, sized
    for the dual view it came from."""
    rec = X.encode32_view(jnp.asarray(view), jnp.asarray(LUT),
                          "rne").reshape(-1)
    return np.asarray(X.decode_quantize32(rec, jnp.asarray(LUT), w, h))


def test_config2_planes_against_jax():
    h, w = 128, 256
    rgb = H._rgb_image(2, h, w)
    rng = np.random.default_rng(2)
    np.testing.assert_array_equal(
        rgb, np.stack([JH._smooth(rng, h, w) for _ in range(3)], axis=-1))
    planes = np.ascontiguousarray(rgb.transpose(2, 0, 1))
    out = H._roundtrip_planes(H._planar(rgb, CPU)).numpy()
    assert out.shape == (3, h // 2, w)
    want = np.stack([_jax_roundtrip32(p[: h // 2], h, w) for p in planes])
    _contract(out, want)


def _jax_composed_zigzag(rgb):
    """JAX config 3's non-Pallas route on (H, W, 3) RGB."""
    h, w = rgb.shape[:2]
    ycc = JL.rgb_to_ycbcr(jnp.asarray(rgb))
    chans = jnp.clip(jnp.rint(ycc), 0, 255).astype(jnp.uint8) \
        .transpose(2, 0, 1)

    def one(pln, lut):
        rec = X.encode_quantize32(pln, jnp.asarray(lut), 0, 1 << 30, "rne")
        groups = rec.reshape(-1, 64, 8)
        zz = JL.to_zigzag(jnp.swapaxes(groups, -1, -2))
        rec2 = jnp.swapaxes(JL.from_zigzag(zz), -1, -2).reshape(rec.shape)
        return X.decode_quantize32(rec2, jnp.asarray(lut), w, h)

    ycc_out = jnp.stack([one(chans[0], LUT), one(chans[1], CHROMA),
                         one(chans[2], CHROMA)], axis=-1)
    return np.asarray(JL.ycbcr_to_rgb(ycc_out.astype(jnp.float32)))


def test_config3_composed_against_jax():
    h, w = 128, 256
    rgb = H._rgb_image(3, h, w)
    out = H._composed_zigzag(torch.as_tensor(rgb)).numpy()
    want = _jax_composed_zigzag(rgb)
    assert out.shape == want.shape == (h // 2, w, 3)
    diff = np.abs(out.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 3 and (diff > 0).mean() <= 0.006, \
        (diff.max(), (diff > 0).mean())


def test_config3_fused_against_jax():
    h, w = 128, 256
    rgb = H._rgb_image(3, h, w)
    out = H._color_roundtrip(H._planar(rgb, CPU)).numpy()
    top = jnp.asarray(np.ascontiguousarray(rgb[: h // 2].transpose(2, 0, 1)))
    want = np.asarray(JC.decode_ycbcr_xla(
        JC.encode_ycbcr_xla(top, jnp.asarray(LUT), jnp.asarray(CHROMA)),
        jnp.asarray(LUT), jnp.asarray(CHROMA)))
    _contract(out, want)


def test_config4_frames_against_jax():
    h, w = 64, 128
    frames = np.random.default_rng(4).integers(0, 256, (2, h, w), np.uint8)
    out = H._roundtrip_planes(torch.as_tensor(frames)).numpy()
    want = np.stack([np.asarray(X.decode_quantize32(
        X.encode_quantize32(jnp.asarray(f), jnp.asarray(LUT), 0, 1 << 30,
                            "rne"), jnp.asarray(LUT), w, h))
        for f in frames])
    _contract(out, want)


def test_config5_shards_against_jax():
    h, w = 2 * 256 * 2, 256
    img = np.random.default_rng(5).integers(0, 256, (h, w), np.uint8)
    mesh = TD.make_mesh(2, devices=["cpu"] * 2)
    out = H._sharded_encode(torch.as_tensor(img), mesh)
    assert len(out.shards) == 2
    jmesh = JD.make_mesh(2)
    want = jax.jit(lambda x: JD.encode_quantize32_sharded(
        x, LUT, jmesh))(jnp.asarray(img))
    _contract(out.full().numpy().reshape(-1), np.asarray(want).reshape(-1))


# the keys of each JAX config's line (simd_dct_tpu/bench/harness.py), the
# host branch's for config 3
JAX_KEYS = {
    "config2": {"config", "gbps", "fraction_of_roofline", "psnr_db"},
    "config3": {"config", "psnr_db"},
    "config4": {"config", "gbps", "frames_per_s"},
    "config5": {"config", "gbps"},
}


def test_config_lines_on_the_host():
    mesh = TD.make_mesh(2, devices=["cpu"] * 2)
    lines = {"config2": H._config2(64, 128, "cpu"),
             "config3": H._config3(64, 128, "cpu"),
             "config4": H._config4(2, 64, 128, "cpu"),
             "config5": H._config5(mesh, 1024, 256, 1)}
    # the u8 bytes an item reads (one plane of the top view) and items a
    # call; config 3's host route is untimed, as the JAX one
    sizes = {"config2": (32 * 128, 3), "config4": (32 * 128, 2),
             "config5": (512 * 256, 1)}
    for name, line in lines.items():
        assert JAX_KEYS[name] <= set(line), (name, line)
        assert line["device"] == "cpu"
        json.dumps(line)
        if name not in sizes:
            assert "timer" not in line
            continue
        assert line["timer"] == "host_wall"
        assert (line["bytes_per_item"], line["items_per_call"]) == \
            sizes[name], (name, line)
        # gbps counts an item's bytes in and out
        assert line["ms_per_item"] > 0
        assert line["gbps"] == round(
            2 * line["bytes_per_item"] / (line["ms_per_item"] / 1e3) / 1e9,
            2), (name, line)
    # a host rate is no device's: no roofline fraction without a spec
    assert lines["config2"]["fraction_of_roofline"] is None
    assert lines["config2"]["psnr_db"] > 30.0
    assert lines["config3"]["psnr_db"] > 30.0
    assert lines["config5"]["config"].endswith("over 2 device(s)")


def test_config5_sizes_and_mesh():
    assert H._config5_hw(1) == (5120, 2048)
    assert H._config5_hw(4) == (20480, 2048)
    mesh = H._config5_mesh(device="cpu")
    assert mesh.size == 1 and str(mesh.devices.flat[0]) == "cpu"
    assert H._config5_mesh(devices=["cpu"] * 3).size == 3


def _run_main(monkeypatch, configs):
    monkeypatch.setattr(H, "ALL_CONFIGS", configs)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = H.main(["--device", "cpu"])
    return rc, [json.loads(line) for line in buf.getvalue().splitlines()]


def test_main_exits_1_when_a_config_raises(monkeypatch):
    def good(device=None):
        return {"config": "good", "device": device}

    def bad(device=None):
        raise RuntimeError("boom")

    rc, lines = _run_main(monkeypatch, [bad, good])
    assert rc == 1
    assert lines == [{"config": "bad", "error": "boom"},
                     {"config": "good", "device": "cpu"}]
    rc, lines = _run_main(monkeypatch, [good])
    assert rc == 0 and lines == [{"config": "good", "device": "cpu"}]


def test_main_without_argv_ignores_the_host_programs_flags(monkeypatch):
    # a bare main() must not parse sys.argv (here pytest's own flags)
    monkeypatch.setattr("sys.argv", ["pytest", "-q", "--no-such-flag"])
    monkeypatch.setattr(H, "ALL_CONFIGS",
                        [lambda device=None: {"config": "c", "device": device}])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert H.main() == 0
    assert json.loads(buf.getvalue()) == {"config": "c", "device": None}
