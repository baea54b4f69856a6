"""Run the remote-DMA gathers of tests/test_dist.py in child processes.

Under load, the Pallas TPU interpreter's remote DMAs in
`simd_dct_tpu.dist.collectives.gather_planes_remote` can race: a host
callback raises `KeyError: ('any', 101, d, 0)` for a neighbour's output
buffer that is not allocated yet, and the other fake devices then spin in
`dma_wait` for ever.  A wedged test would hold its xdist worker, and the
whole run, until an outer clock cuts it.  So each test named in `FENCED`
runs in a child pytest of its own, which is aborted at `_LIMIT_S` seconds;
the test then fails with the stack of every thread of the child.

pytest imports this file before `tests/conftest.py`, which must set
`XLA_FLAGS` before JAX starts: import neither JAX nor torch here.
"""

import os
import re
import resource
import signal
import subprocess
import sys
from pathlib import Path

import pytest

FENCED = (
    "tests/test_dist.py::test_remote_copy_gather",
    "tests/test_dist.py::test_remote_gather_composition",
    "tests/test_dist.py::test_remote_gather_2d_mesh",
    "tests/test_dist.py::test_remote_gather_with_compute_kernel",
)
_LIMIT_S = 90
_ROOT = Path(__file__).resolve().parent
_CHILD_ENV = "_SIMD_DCT_TPU_FENCED_CHILD"
_TAIL_CHARS = 16_000
# The final line of a `-q` run, e.g. "1 passed, 2 warnings in 12.34s".
_SUMMARY = re.compile(r"^(\d+ \w+(?:, \d+ \w+)*) in [\d.]+s", re.M)


def run_fenced(nodeid, limit_s=_LIMIT_S):
    """Run one test in a child pytest; fail unless it alone passes in `limit_s` s.

    The child runs in the rootdir, so it loads the same conftests and fakes
    the same CPU devices.  `-X faulthandler` and `-s` keep a stack dump on
    the child's own stderr from its first instruction on; at the limit the
    child gets SIGABRT, which makes faulthandler write every thread's stack
    before it dies, and then its process group is killed.
    """
    cmd = [sys.executable, "-X", "faulthandler", "-m", "pytest", nodeid,
           "-q", "-s", "-p", "no:cacheprovider", "-p", "no:xdist",
           "-p", "no:randomly"]
    proc = subprocess.Popen(
        cmd, cwd=_ROOT, env=dict(os.environ, **{_CHILD_ENV: "1"}),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    # No core file from the abort at the limit.
    resource.prlimit(proc.pid, resource.RLIMIT_CORE, (0, 0))
    timed_out = False
    try:
        out = proc.communicate(timeout=limit_s)[0]
    except subprocess.TimeoutExpired:
        timed_out = True
        proc.send_signal(signal.SIGABRT)
        try:
            out = proc.communicate(timeout=5)[0]
        except subprocess.TimeoutExpired:
            out = None
    finally:
        # Past the limit, or when this process is interrupted.
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
    if out is None:
        out = proc.communicate()[0]
    tail = out.decode(errors="replace")[-_TAIL_CHARS:]
    if timed_out:
        pytest.fail(f"{nodeid} did not finish in its limit of {limit_s} s; "
                    f"the child was aborted. Its output ends:\n{tail}",
                    pytrace=False)
    if proc.returncode != 0:
        pytest.fail(f"{nodeid} exited {proc.returncode} in its child. "
                    f"Its output ends:\n{tail}", pytrace=False)
    summary = _SUMMARY.findall(tail)
    if not summary or re.sub(r", \d+ warnings?", "", summary[-1]) != "1 passed":
        pytest.fail(f"{nodeid}: the child's summary is not '1 passed'. "
                    f"Its output ends:\n{tail}", pytrace=False)


@pytest.hookimpl(tryfirst=True)
def pytest_pyfunc_call(pyfuncitem):
    if pyfuncitem.nodeid in FENCED and _CHILD_ENV not in os.environ:
        run_fenced(pyfuncitem.nodeid)
        return True
