"""The port's command lines (``simd_dct_tpu_torch.cli`` and
``container._main``) against the JAX package's, on the CPU.

Inputs: seeded raw files, a 64x128 grayscale image, 3x64x128 planar RGB
and 3x64x256 planar RGB for 4:2:0.  Each JAX command runs once, in a
module-scoped fixture; the port runs the same flags with ``--device cpu``
(its plain version).  Tolerances:
  * record dumps, decompressed streams and container decodes against the
    JAX package's: at most +-1, on at most 0.2% of bytes -- the
    ``compare_backends`` contract of ``test_torch_mode32.py``,
    ``test_torch_enc_quant.py``, ``test_torch_stereo.py``,
    ``test_torch_color.py`` and ``test_torch_color420.py``;
  * dumps against the port's own api call with the same flags, the
    sharded dump against the unsharded one, the tier map and the error
    paths: exact.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import simd_dct_tpu as J
from simd_dct_tpu import cli as JCLI
from simd_dct_tpu import container as JC
from simd_dct_tpu import entropy as JE
import simd_dct_tpu_torch as T
from simd_dct_tpu_torch import cli
from simd_dct_tpu_torch import container as C
from simd_dct_tpu_torch import entropy as E
from simd_dct_tpu_torch.dispatch import get_max_backend, set_max_backend
from simd_dct_tpu_torch.utils.debug import compare_backends

REPO = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
H, W = 64, 128

# case -> (input file, width, flags); every case dumps with --to
CASES = {
    "enc-quant": ("gray", W, ["--mode", "enc-quant", "--quality", "50"]),
    "enc-quant-pair": ("gray", W, ["--mode", "enc-quant", "--quality", "50",
                                   "--layout", "pair"]),
    "enc-quant-noquality": ("gray", W, ["--mode", "enc-quant"]),
    "enc-quant32": ("gray", W, ["--mode", "enc-quant32", "--quality", "50"]),
    "enc-quant-stereo": ("gray", W, ["--mode", "enc-quant-stereo",
                                     "--quality", "50"]),
    "stereo-planar": ("gray", W, ["--mode", "enc-quant-stereo", "--quality",
                                  "50", "--stereo-layout", "planar"]),
    "stereo-native": ("gray", W, ["--mode", "enc-quant-stereo", "--quality",
                                  "50", "--stereo-layout", "native"]),
    "enc-quant32-ycbcr": ("rgb", W, ["--mode", "enc-quant32-ycbcr",
                                     "--quality", "100"]),
    "enc-quant32-ycbcr420": ("rgb420", 256, ["--mode",
                                             "enc-quant32-ycbcr420",
                                             "--quality", "100"]),
    "compress": ("gray", W, ["--mode", "enc-quant32", "--quality", "50",
                             "--compress"]),
    "rle": ("gray", W, ["--mode", "enc-quant32", "--quality", "50",
                        "--compress", "--rle"]),
    "sparse": ("gray", W, ["--mode", "enc-quant32", "--quality", "50",
                           "--compress", "--sparse"]),
}
STREAM_CASES = ("compress", "rle", "sparse")
# case -> flags; every case writes a .sdt container
SDT_CASES = {
    "enc-quant32": ("gray", W, ["--mode", "enc-quant32", "--quality", "50",
                                "--compress"]),
    "enc-quant-pair": ("gray", W, ["--mode", "enc-quant", "--layout", "pair",
                                   "--quality", "50"]),
    "stereo-native": ("gray", W, ["--mode", "enc-quant-stereo", "--quality",
                                  "50", "--stereo-layout", "native",
                                  "--compress", "--sparse"]),
    "enc-quant32-ycbcr420": ("rgb420", 256, ["--mode",
                                             "enc-quant32-ycbcr420",
                                             "--quality", "100",
                                             "--compress", "--rle"]),
}


def _contract(a, b):
    report = compare_backends({"a": np.asarray(a).reshape(-1),
                               "b": np.asarray(b).reshape(-1)})
    assert all(v["ok"] for v in report.values()), report


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(0xC11)
    yy, xx = np.mgrid[0:H, 0:256]
    field = 128 + 60 * np.sin(xx / 11) * np.cos(yy / 7)
    data = {
        "gray": rng.integers(0, 256, (H, W), dtype=np.uint8),
        # three correlated smooth channels (colour PSNR needs them)
        "rgb": np.stack([np.clip(field[:, :W] * s, 0, 255)
                         for s in (1.0, 0.8, 0.6)]).astype(np.uint8),
        "rgb420": np.stack([np.clip(field * s, 0, 255)
                            for s in (1.0, 0.8, 0.6)]).astype(np.uint8),
    }
    paths = {}
    for name, arr in data.items():
        paths[name] = d / f"{name}.raw"
        arr.tofile(paths[name])
    return d, paths, data


def _argv(paths, src, width, flags, out):
    return [str(paths[src]), str(width), str(H), "--runs", "1", *flags,
            "--to", str(out)]


@pytest.fixture(scope="module")
def jax_runs(files):
    """One JAX command per case: the dumps and the .sdt containers."""
    d, paths, _ = files
    dumps, sdts = {}, {}
    for case, (src, width, flags) in CASES.items():
        out = d / f"jax-{case}.raw"
        assert JCLI.main(_argv(paths, src, width, flags, out)) == 0
        dumps[case] = np.fromfile(out, np.uint8)
    for case, (src, width, flags) in SDT_CASES.items():
        out = d / f"jax-{case}.sdt"
        assert JCLI.main(_argv(paths, src, width, flags, out)) == 0
        sdts[case] = np.fromfile(out, np.uint8)
    return dumps, sdts


def _port(files, case, table, suffix):
    d, paths, _ = files
    src, width, flags = table[case]
    out = d / f"port-{case}{suffix}"
    assert cli.main(_argv(paths, src, width, flags, out) + CPU) == 0
    return np.fromfile(out, np.uint8)


def _api_records(case, data):
    """The port api's records for a case's flags."""
    lut = T.default_quant_lut(None if case.endswith("noquality") else
                              (100.0 if "ycbcr" in case else 50.0))
    if case.startswith("enc-quant32-ycbcr"):
        src = data["rgb420" if case.endswith("420") else "rgb"]
        chroma = T.layout.BASE_CHROMA_QUANT_TABLE * 100.0 * 255.0
        fn = (T.encode_quantize32_ycbcr420 if case.endswith("420")
              else T.encode_quantize32_ycbcr)
        return fn(src, lut * 255.0, chroma, device="cpu")
    img = data["gray"]
    if case.startswith("enc-quant32") or case in STREAM_CASES:
        return T.encode_quantize32(img, lut * 255.0, device="cpu")
    if case.startswith("stereo") or case == "enc-quant-stereo":
        vl = case.split("-")[1] if case.startswith("stereo") else \
            "interleaved"
        return T.encode_quantize_stereo(img, lut, view_layout=vl,
                                        device="cpu")
    layout = "pair" if case.endswith("pair") else "scalar"
    return T.encode_quantize(img, lut, layout=layout, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_dump_against_jax_and_api(files, jax_runs, case):
    got = _port(files, case, CASES, ".raw")
    want_api = _api_records(case, files[2]).numpy().reshape(-1)
    if case in STREAM_CASES:
        # the stream decodes to the api's records; the JAX stream to the
        # JAX records, which the port's hold to the contract
        assert np.array_equal(E.decompress(got), want_api)
        assert np.array_equal(JE.decompress(got), want_api)
        _contract(JE.decompress(jax_runs[0][case]), want_api)
        magic = got[:4].tobytes()
        assert magic == jax_runs[0][case][:4].tobytes(), magic
    else:
        assert np.array_equal(got, want_api)
        _contract(got, jax_runs[0][case])


def test_quality_only_applied_with_flag(files, jax_runs):
    """src/main.cpp:123,214: the declared default 50 is never applied
    unless --quality is passed, in both packages."""
    a = _port(files, "enc-quant-noquality", CASES, ".raw")
    b = _port(files, "enc-quant", CASES, ".raw")
    assert not np.array_equal(a, b)
    assert not np.array_equal(jax_runs[0]["enc-quant-noquality"],
                              jax_runs[0]["enc-quant"])


@pytest.mark.parametrize("case", list(SDT_CASES))
def test_sdt_decodes_in_both_packages(files, jax_runs, case):
    port_blob = _port(files, case, SDT_CASES, ".sdt")
    jax_blob = jax_runs[1][case]
    pm, jm = C.info(port_blob), JC.info(jax_blob)
    assert (pm.mode, pm.size_x, pm.size_y, pm.packed, pm.stereo_native) == \
        (jm.mode, jm.size_x, jm.size_y, jm.packed, jm.stereo_native)
    port_own = C.decode(port_blob, device="cpu").numpy()
    jax_own = np.asarray(JC.decode(jax_blob))
    # each package reads the other's container
    _contract(C.decode(jax_blob, device="cpu").numpy(), jax_own)
    _contract(np.asarray(JC.decode(port_blob)), port_own)
    _contract(port_own, jax_own)


def test_max_simd_tier_map_follows_the_jax_map():
    jax_to_port = {"pallas": "cuda", "xla": "torch", "numpy": "numpy"}
    want = {k: jax_to_port[v] for k, v in JCLI.MAX_SIMD_TO_TIER.items()
            if k not in jax_to_port}
    got = {k: v for k, v in cli.MAX_SIMD_TO_TIER.items()
           if k not in ("cuda", "torch", "numpy")}
    assert got == want
    assert cli.MAX_SIMD_TO_TIER["numpy"] == "numpy"
    assert cli.MODES == JCLI.MODES


def test_max_simd_none_caps_to_the_plain_version(files, capsys):
    """--max-simd none caps to the NumPy golden tier (the JAX map's "numpy";
    the port's plain version took its place before that tier was ported)."""
    _, paths, _ = files
    try:
        assert cli.main([str(paths["gray"]), "128", "64", "--runs", "1",
                         "--mode", "enc-quant", "--max-simd", "none",
                         *CPU]) == 0
        assert get_max_backend() == "numpy"
    finally:
        set_max_backend("cuda")


def test_max_simd_strict_unavailable(files, capsys):
    """A cap naming a tier this machine lacks is an error, and leaves the
    cap as it was (src/main.cpp:283-438)."""
    if torch.cuda.is_available():
        pytest.skip("the cuda tier is available on this machine")
    _, paths, _ = files
    rc = cli.main([str(paths["gray"]), "128", "64", "--runs", "1",
                   "--mode", "enc-quant", "--max-simd", "avx2", *CPU])
    assert rc == 1
    assert "not supported" in capsys.readouterr().out
    assert get_max_backend() == "cuda"


@pytest.mark.parametrize("runs", ["0", "99999"])
def test_bad_runs(files, runs):
    _, paths, _ = files
    assert cli.main([str(paths["gray"]), "128", "64", "--runs", runs,
                     *CPU]) == 1


def test_missing_file(tmp_path):
    assert cli.main([str(tmp_path / "nope.raw"), "8", "8", *CPU]) == 1


def test_quant32_width_guard(tmp_path, capsys):
    p = tmp_path / "img.raw"
    np.zeros((16, 24), np.uint8).tofile(p)
    rc = cli.main([str(p), "24", "16", "--runs", "1", "--mode",
                   "enc-quant32", *CPU])
    assert rc == 0
    assert "not supported" in capsys.readouterr().out


@pytest.mark.parametrize("mode", ["enc-quant32", "enc-quant-stereo"])
def test_sharded_dump_equals_unsharded(files, capsys, mode):
    d, paths, data = files
    out = d / f"sharded-{mode}.raw"
    rc = cli.main([str(paths["gray"]), "128", "64", "--runs", "1",
                   "--quality", "50", "--mode", mode, "--sharded", "4",
                   "--decode", "--to", str(out), *CPU])
    assert rc == 0
    text = capsys.readouterr().out
    assert "4-device mesh [cpu]" in text and "PSNR" in text
    lut = T.default_quant_lut(50)
    want = (T.encode_quantize32(data["gray"], lut * 255.0, device="cpu")
            if mode == "enc-quant32" else
            T.encode_quantize_stereo(data["gray"], lut, device="cpu"))
    assert np.array_equal(np.fromfile(out, np.uint8),
                          want.numpy().reshape(-1))


def test_sharded_bad_geometry(files):
    _, paths, _ = files
    assert cli.main([str(paths["gray"]), "128", "64", "--runs", "1",
                     "--mode", "enc-quant32", "--sharded", "5", *CPU]) == 1


def test_sharded_needs_the_cards(files, capsys):
    """Without --device, --sharded N takes N cards and fails when there
    are fewer (never virtual CPU shards)."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, paths, _ = files
    rc = cli.main([str(paths["gray"]), "128", "64", "--runs", "1",
                   "--mode", "enc-quant32", "--sharded", "4"])
    assert rc == 1
    assert "--device cpu" in capsys.readouterr().out


def test_accurate_on_the_host_takes_direct_walls(files, capsys):
    _, paths, _ = files
    rc = cli.main([str(paths["gray"]), "128", "64", "--runs", "2",
                   "--mode", "enc-quant32", "--quality", "50", "--accurate",
                   "--decode", *CPU])
    assert rc == 0
    text = capsys.readouterr().out
    assert "(slope)" not in text and "GB/s (min)" in text
    assert "PSNR" in text


def test_container_main_info_and_decode(files, jax_runs, capsys):
    d, _, _ = files
    blob = jax_runs[1]["enc-quant32"]
    path = d / "main.sdt"
    blob.tofile(path)
    assert C._main(["info", str(path)]) == 0
    port_info = capsys.readouterr().out
    assert JC._main(["info", str(path)]) == 0
    assert port_info == capsys.readouterr().out
    out = d / "main.raw"
    assert C._main(["decode", str(path), str(out), *CPU]) == 0
    assert np.array_equal(np.fromfile(out, np.uint8),
                          C.decode(blob, device="cpu").numpy().reshape(-1))
    video = C.encode_video(np.stack([files[2]["gray"]] * 2), "enc-quant32",
                           quality=50.0, device="cpu")
    vpath = d / "main.sdtv"
    video.tofile(vpath)
    assert C._main(["info", str(vpath)]) == 0
    assert "video mode=enc-quant32 size=128x64 frames=2" in \
        capsys.readouterr().out
    assert C._main(["decode", str(vpath), str(out), *CPU]) == 0
    assert np.array_equal(
        np.fromfile(out, np.uint8),
        C.decode_video(video, device="cpu").numpy().reshape(-1))


def test_no_card_errors_name_the_cpu_option(files, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    d, paths, _ = files
    assert cli.main([str(paths["gray"]), "128", "64", "--runs", "1"]) == 1
    assert "--device cpu" in capsys.readouterr().out
    blob = d / "nocard.sdt"
    C.encode(files[2]["gray"], "enc-quant32", device="cpu").tofile(blob)
    assert C._main(["decode", str(blob), str(d / "nocard.raw")]) == 1
    assert "--device cpu" in capsys.readouterr().out


def test_python_m_runs_the_command(files):
    """``python -m simd_dct_tpu_torch.cli`` is the entry point users run."""
    d, paths, data = files
    out = d / "m.raw"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.run(
        [sys.executable, "-m", "simd_dct_tpu_torch.cli", str(paths["gray"]),
         "128", "64", "--runs", "1", "--mode", "enc-quant32", "--quality",
         "50", "--to", str(out), *CPU],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "enc-quant32" in proc.stdout
    want = T.encode_quantize32(data["gray"], T.default_quant_lut(50) * 255.0,
                               device="cpu")
    assert np.array_equal(np.fromfile(out, np.uint8),
                          want.numpy().reshape(-1))
