"""The run's limits of tests/run_limits.py: a test that runs past the time
limit fails by name with the limit in its message, and the tests after it
still run, both in one process and under pytest-xdist; and every test it
marks `slow` exists.

Each inner session runs in a subprocess: a process has one ITIMER_REAL and
one faulthandler timer, which the outer test's own limit is using."""

import ast
import pathlib

import pytest

from tests.run_limits import SLOW

pytest_plugins = ["pytester"]

REPO = pathlib.Path(__file__).resolve().parents[1]

INNER_CONFTEST = """
import tests.run_limits as limits

pytest_plugins = ["tests.run_limits"]
limits.TEST_LIMIT_S = 1
"""

INNER_TESTS = """
import time

import pytest


def test_sleeps_past_the_limit():
    time.sleep(30)


@pytest.mark.slow
def test_slow_has_no_limit():
    time.sleep(1.5)


def test_after_it_still_runs():
    assert True
"""


@pytest.mark.parametrize("args", [(), ("-p", "xdist", "-n", "2", "--dist", "loadfile")],
                         ids=["in_process", "xdist"])
def test_limit_fails_the_test_and_the_run_goes_on(pytester, monkeypatch, args):
    monkeypatch.setenv("PYTHONPATH", str(REPO))
    pytester.makeconftest(INNER_CONFTEST)
    pytester.makepyfile(test_inner=INNER_TESTS)
    result = pytester.runpytest_subprocess("-p", "no:randomly", "-p", "no:cacheprovider", *args,
                                           timeout=120)
    result.assert_outcomes(passed=2, failed=1)
    result.stdout.fnmatch_lines(
        ["*test_inner.py::test_sleeps_past_the_limit ran past the 1 s limit*"])


def test_slow_tests_exist():
    """A renamed or moved test would fall out of SLOW unseen and take its
    minutes in the default run again."""
    for nodeid in SLOW:
        path, name = nodeid.split("::")
        tree = ast.parse((REPO / path).read_text())
        assert name in {f.name for f in tree.body if isinstance(f, ast.FunctionDef)}, nodeid
