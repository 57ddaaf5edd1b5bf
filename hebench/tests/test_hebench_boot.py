"""The boot cell (kind ckks_boot) at a tiny ring on the CPU: its control
(the reference's refresh with every modular product rounded to float64)
reads not correct and the exact reference in the program's place reads
correct; so does the control above the reference's rings (the program with
its plan diagonals in float32), by the slots' error alone; a step that returns its input, a dropped limb and limbs 2 .. l-1
off by one each read `correct` false; the readers of its per-layer metrics
read the stage markers and return None on windows of other kinds; the
least time's diagonal offsets are the program's plans'."""

import time

import pytest

from hebench import bounds_boot, harness, traffic
from hebench.tests import tiny, tiny_boot
from hebench.trace import Traced
from hehub_tpu_torch.circuits import bootstrap as bs
from hehub_tpu_torch.models import ckks

CELL = "boot65536.refresh_b1"
SEED = 2**31 + 77
READERS = ("refresh_roofline.boot", "lt_ms_per_refresh.boot", "evalmod_ms_per_refresh.boot",
           "launches_per_refresh.boot")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    assert tiny_boot.CONFIG in tiny.TINY
    return tiny.make_root(tmp_path_factory.mktemp("tiny"))


def _run(root, control=None):
    return harness.run(CELL, SEED, 0.3, False, time.perf_counter(), root=root, device="cpu",
                       control=control)


@pytest.mark.parametrize("control", ["below", "exact"])
def test_control(root, control):
    res = _run(root, control)
    assert res["correct"] == (control == "exact"), res["checks"]


def test_float32_plans_read_not_correct(root, monkeypatch):
    load = traffic.load_kind

    def above_the_reference(*args):
        kind = load(*args)
        kind.REFERENCE_MAX_N = tiny_boot.N // 2
        return kind

    monkeypatch.setattr(traffic, "load_kind", above_the_reference)
    res = _run(root, "below")
    checks = res["checks"]
    assert not res["correct"]
    assert checks["boot_err"]["value"] > checks["boot_err"]["limit"]
    assert checks["residue_mismatch"]["value"] == checks["limb_shortfall"]["value"] == 0


def _with(ct, fn):
    return ckks.CkksCt(ct.c0.with_data(fn(ct.c0.data)), ct.c1.with_data(fn(ct.c1.data)),
                       ct.scaling_factor)


def _upper(x):
    y = x.clone()
    y[..., 2:, :] += 1
    return y


@pytest.mark.parametrize("fault", ["unchanged", "dropped_limb", "upper_limbs"])
def test_faults_read_not_correct(root, monkeypatch, fault):
    call = bs.CompiledBootstrapper.__call__
    faults = {
        "unchanged": lambda self, ct: ct,
        "dropped_limb": lambda self, ct: ckks.mod_drop(None, call(self, ct), 1),
        "upper_limbs": lambda self, ct: _with(call(self, ct), _upper),
    }
    monkeypatch.setattr(bs.CompiledBootstrapper, "__call__", faults[fault])
    res = _run(root)
    checks = res["checks"]
    assert not res["correct"]
    if fault == "dropped_limb":  # it still decrypts: only the limb count sees it
        assert checks["limb_shortfall"]["value"] == 1
        assert checks["boot_err"]["value"] <= checks["boot_err"]["limit"]
    if fault == "upper_limbs":  # only the limb-by-limb check sees it
        assert checks["residue_mismatch"]["value"] > 0
        assert checks["boot_err"]["value"] <= checks["boot_err"]["limit"]


def _reading(kind, spans, units, steps):
    traced = Traced(2.0, spans, [], 0.0, 2e6)
    return harness.Reading(tiny_boot.full_config(), {"kind": kind}, traced,
                           [("refresh", 20)] * steps, units, {}, {}, [])


def _refresh_spans(t0):
    """One refresh's device activities: markers and a kernel of 1 ms in
    each stage, 2 ms in c2s."""
    out, t = [], t0
    for stage, work in (("sse_in", 1), ("mod_raise", 1), ("sse_out", 1), ("c2s", 2),
                        ("evalmod", 1), ("evalmod", 1), ("s2c", 1), ("done", 0)):
        out.append((t, t + 1, f"void (anonymous namespace)::boot_mark_{stage}()"))
        t += 1
        if work:
            out.append((t, t + 1000 * work, "void some_kernel<int>()"))
            t += 1000 * work
    return out, t


def test_readers_split_by_markers_and_skip_other_kinds():
    bench = tiny.REPO / "hebench"
    a, t = _refresh_spans(0.0)
    b, _ = _refresh_spans(t + 500)
    r = _reading("ckks_boot", a + b, 2, 2)
    got = {m: harness.load_metric(bench, m).read(r) for m in READERS}
    assert got["lt_ms_per_refresh.boot"] == pytest.approx(3.0)
    assert got["evalmod_ms_per_refresh.boot"] == pytest.approx(2.0)
    assert got["launches_per_refresh.boot"] == 7
    assert 0 < got["refresh_roofline.boot"] <= 100
    # a lost marker: the split reads nothing
    lost = [sp for sp in a + b if "boot_mark_s2c" not in sp[2]][:len(a) + len(b) - 1]
    assert harness.load_metric(bench, READERS[1]).read(_reading("ckks_boot", lost, 2, 2)) is None
    for kind in ("ckks_ks", "ckks_codec"):
        other = _reading(kind, [(0.0, 5.0, "void some_kernel<int>()")], 64, 1)
        for m in READERS:
            assert harness.load_metric(bench, m).read(other) is None


@pytest.mark.parametrize("n, lt_stages", [(4096, 3), (65536, 4)])
def test_least_time_offsets_are_the_plans(n, lt_stages):
    c2s_r, _, s2c_r, _ = bs._merged_chain_matrices(n, lt_stages)
    groups = bounds_boot.group_offsets(n, lt_stages)
    s = n // 2
    for M, offs in zip(s2c_r, groups):
        assert set(bs._nonzero_diagonals(M).tolist()) == offs
    for M, offs in zip(c2s_r, reversed(groups)):
        assert set(bs._nonzero_diagonals(M).tolist()) == {(-o) % s for o in offs}
