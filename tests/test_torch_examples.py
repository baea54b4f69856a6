"""The port's usage examples (``simd_dct_tpu_torch.examples``) against the
JAX package's (``examples/``), on the CPU.

Each JAX example runs in this process by ``runpy.run_path`` with its
standard output captured (``tests/conftest.py`` gives JAX the 8 virtual CPU
devices ``sharded.py`` needs); the port's runs as ``main(["--device",
"cpu"])``, which returns the lines it printed.  Both build the same images
with the same numpy calls.  Tolerances:
  * every line equal, shapes, byte counts, ratios, stream formats and "ok"
    lines included, but the numbers followed by "dB";
  * each PSNR within 0.1 dB (the round-trip tolerance of
    ``tests/test_torch_mode32.py``);
  * the mesh line: the same axis sizes on the same platform (JAX prints
    its mesh shape as an ``OrderedDict``, the port as a ``dict``).
No line differs by the stored-escape pre-check (ROADMAP Queue 3): each
container and stream here is the same size in both packages.
"""

import ast
import contextlib
import io
import re
import runpy
from pathlib import Path

import pytest

from simd_dct_tpu_torch.examples import (encode_decode, serving, sharded,
                                         video_pipeline)

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = {"encode_decode": encode_decode, "video_pipeline": video_pipeline,
            "serving": serving, "sharded": sharded}
DB = re.compile(r"(\d+\.\d+) dB")
MESH = re.compile(r"^mesh: (?:OrderedDict\()?(\{.*\})\)? on (\w+)$")


def _jax_lines(name: str) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(REPO / "examples" / f"{name}.py"),
                       run_name="__main__")
    return buf.getvalue().splitlines()


def _same_line(port: str, jax: str) -> None:
    mp, mj = MESH.match(port), MESH.match(jax)
    if mj:
        assert mp, (port, jax)
        assert ast.literal_eval(mp.group(1)) == ast.literal_eval(mj.group(1))
        assert mp.group(2) == mj.group(2)
        return
    assert DB.sub("dB", port) == DB.sub("dB", jax), (port, jax)
    for a, b in zip(DB.findall(port), DB.findall(jax), strict=True):
        assert abs(float(a) - float(b)) <= 0.1, (port, jax)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_lines_equal_jax(name, capsys):
    port = EXAMPLES[name].main(["--device", "cpu"])
    assert capsys.readouterr().out.splitlines() == port
    jax = _jax_lines(name)
    assert len(port) == len(jax), (port, jax)
    for p, j in zip(port, jax):
        _same_line(p, j)


def test_device_arg_without_argv_ignores_the_host_programs_flags(
        monkeypatch):
    # a bare main() must not parse sys.argv (here pytest's own flags)
    from simd_dct_tpu_torch.examples import device_arg
    monkeypatch.setattr("sys.argv", ["pytest", "-q", "--no-such-flag"])
    assert device_arg(None, "doc") is None
    assert device_arg(["--device", "cpu"], "doc") == "cpu"
