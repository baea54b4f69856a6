"""The root conftest's fence: a test run in a child pytest with a limit."""

import importlib.util
import re
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest

_ROOT = Path(__file__).resolve().parents[1]
# `conftest` is tests/conftest.py's module name: load the root one apart.
_spec = importlib.util.spec_from_file_location("root_conftest",
                                               _ROOT / "conftest.py")
fence = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fence)

SLEEPER = "tests/_fence_sleeper.py::"


@pytest.fixture(scope="module")
def verdicts():
    """Each sleeper test's failure message (None on a pass) and seconds.

    The four children run at once, to keep this file short.
    """
    def verdict(name, limit_s):
        t0 = time.monotonic()
        try:
            fence.run_fenced(SLEEPER + name, limit_s)
            msg = None
        except pytest.fail.Exception as e:
            msg = str(e)
        return msg, time.monotonic() - t0

    with ThreadPoolExecutor(4) as pool:
        futures = {name: pool.submit(verdict, name, limit_s)
                   for name, limit_s in (("test_passes", 60),
                                         ("test_fails", 60),
                                         ("test_skips", 60),
                                         ("test_sleeps", 2))}
        return {name: f.result() for name, f in futures.items()}


def test_fenced_pass_passes(verdicts):
    assert verdicts["test_passes"][0] is None


def test_fenced_failure_fails_with_its_assertion(verdicts):
    msg = verdicts["test_fails"][0]
    assert msg is not None and "the sleeper's own failure" in msg


def test_fenced_skip_fails_as_no_pass(verdicts):
    msg = verdicts["test_skips"][0]
    assert msg is not None and "summary is not '1 passed'" in msg


def test_fenced_sleep_fails_at_its_limit_with_stacks(verdicts):
    msg, seconds = verdicts["test_sleeps"]
    assert seconds < 5
    assert "limit of 2 s" in msg
    assert "most recent call first" in msg


def test_fenced_names_are_tests_of_test_dist():
    src = (_ROOT / "tests" / "test_dist.py").read_text()
    assert len(set(fence.FENCED)) == 4
    for nodeid in fence.FENCED:
        path, name = nodeid.split("::")
        assert path == "tests/test_dist.py"
        assert re.search(rf"^def {name}\(", src, re.M), name
