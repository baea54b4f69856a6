"""Tests for tests/test_fence.py to run in a child pytest, one at a time.

The name keeps pytest's `test_*.py` pattern from collecting this file.
"""

import time

import pytest


def test_passes():
    pass


def test_fails():
    assert 40 + 2 == 41, "the sleeper's own failure"


def test_skips():
    pytest.skip("a skip is not a pass")


def test_sleeps():
    time.sleep(60)
