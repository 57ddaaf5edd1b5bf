"""The control (the reference in the program's place, a precision below)
runs through the harness and its own judgement comes out not correct at a
tiny ring; the reference at full precision in the same place comes out
correct."""

import time

import pytest

from hebench import harness
from hebench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _run(root, workload, seed, control):
    return harness.run(workload, seed, 0.3, False, time.perf_counter(), root=root,
                       device="cpu", control=control)


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_control_fails(root, workload):
    res = _run(root, workload, 2**31 + 5, "below")
    assert not res["correct"], res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_exact_reference_in_the_programs_place_passes(root, workload):
    res = _run(root, workload, 2**31 + 6, "exact")
    assert res["correct"] and res["failed"] == 0, res["checks"]
