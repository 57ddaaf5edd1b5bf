"""Limits on a test run: each process's share of the CPUs, a time limit on
every test, the tests left out of the default run as `slow`, and XLA's
optimizations off for the files whose time is compiling integer code.

A pytest plugin, loaded by the repository's root conftest.py.

Under pytest-xdist every worker would otherwise size its thread pools
(PyTorch's and numpy's OpenMP and BLAS pools, XLA's CPU pool) to the whole
host, and the workers together oversubscribe it; so each process takes the
CPUs it may use divided by the number of workers. The pools read their size
when torch and jax start, so it is set when this module is imported, before
any conftest imports them.

Each test's set-up and call together get TEST_LIMIT_S seconds; a test that
runs past it fails with its node id, and the run goes on. A hang in native
code, where the alarm cannot interrupt it, dumps every thread's stack
BACKSTOP_S seconds later and ends the process (xdist then replaces the
worker). Tests marked `slow` are left out of the default run
(`-m 'not slow'`), run with `-m slow`, and have no limit.
"""

import faulthandler
import io
import os
import signal
import sys
import time

import pytest

TEST_LIMIT_S = 600
# the native-code backstop fires this long after the limit
BACKSTOP_S = 60

# Tests of the JAX package that take many minutes on the CPU. Their files
# are kept as they are, so they get the `slow` marker here; the two gated
# by HEHUB_SLOW=1 also need that variable to run.
SLOW = (
    "tests/test_bootstrap.py::test_full_bootstrap_1024",
    "tests/test_bootstrap.py::test_full_bootstrap_batched",
    "tests/test_bootstrap.py::test_compiled_bootstrapper_matches_eager",
    "tests/test_bootstrap.py::test_compiled_split_matches_monolithic",
    "tests/test_parallel.py::test_batch_sharded_bootstrap",
)


def cpu_share():
    """CPUs this process may use (its affinity, capped by a cgroup quota)
    divided by the xdist worker count; at least 1."""
    cpus = len(os.sched_getaffinity(0))
    try:
        with open("/sys/fs/cgroup/cpu.max") as f:
            quota, period = f.read().split()
        if quota != "max":
            cpus = min(cpus, max(1, int(quota) // int(period)))
    except (OSError, ValueError):
        pass
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cpus // workers)


SHARE = cpu_share()
os.environ["OMP_NUM_THREADS"] = str(SHARE)
_flags = os.environ.get("XLA_FLAGS", "")
if SHARE == 1 and "xla_cpu_multi_thread_eigen" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_cpu_multi_thread_eigen=false").strip()


# Test files whose time is mostly eager JAX compiles (a primitive compiles
# anew at every shape it meets) and whose results are integer arithmetic,
# checked bitwise or, for CKKS decodes, to a tolerance far above rounding:
# XLA's optimizations are off while their tests run, which makes each
# compile about a third cheaper and changes no integer bit. The floating
# point tests (test_df64.py, the codecs) keep the optimized compile.
NO_OPT = {
    "test_bgv.py", "test_bootstrap.py", "test_hybrid_ks.py", "test_pallas.py",
    "test_parallel.py", "test_poly_eval.py", "test_tfhe.py",
    "test_torch_bgv.py", "test_torch_parallel.py",
}


@pytest.hookimpl(wrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if item.path.name not in NO_OPT:
        return (yield)
    import jax

    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    try:
        return (yield)
    finally:
        jax.config.update("jax_disable_most_optimizations", before)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # before `-m` selects
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


_DEADLINE = pytest.StashKey[float]()
_STDERR = pytest.StashKey[int]()


def pytest_configure(config):
    # the backstop writes to the terminal's stderr, not the test's capture:
    # pytest does not capture during configuration
    try:
        fd = sys.stderr.fileno()
    except (AttributeError, ValueError, io.UnsupportedOperation):
        fd = sys.__stderr__.fileno()
    config.stash[_STDERR] = os.dup(fd)


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR])


def _limited(item):
    return item.get_closest_marker("slow") is None


def _arm(item, seconds):
    def on_alarm(signum, frame):
        pytest.fail(f"{item.nodeid} ran past the {TEST_LIMIT_S} s limit of tests/run_limits.py")

    signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, max(seconds, 1e-3))


def _disarm():
    signal.setitimer(signal.ITIMER_REAL, 0)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    if not _limited(item):
        return (yield)
    item.stash[_DEADLINE] = time.monotonic() + TEST_LIMIT_S
    faulthandler.dump_traceback_later(TEST_LIMIT_S + BACKSTOP_S, exit=True,
                                      file=item.config.stash[_STDERR])
    _arm(item, TEST_LIMIT_S)
    try:
        return (yield)
    finally:
        _disarm()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if not _limited(item):
        return (yield)
    _arm(item, item.stash[_DEADLINE] - time.monotonic())
    try:
        return (yield)
    finally:
        _disarm()


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item):
    try:
        return (yield)
    finally:
        if _limited(item):
            faulthandler.cancel_dump_traceback_later()
