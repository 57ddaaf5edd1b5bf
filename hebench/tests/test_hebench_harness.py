"""The harness: the percentile, discovery by name (a configuration, a mix,
a request kind and a metric added as new files only), the guard against
JAX loaded at any point of a run, and a CPU rehearsal of every cell of
BENCHMARK.json at a tiny ring through the same code."""

import json
import sys
import time

import pytest
import torch

from hebench import harness, traffic
from hebench.tests import tiny

SEED = 2**31 + 977  # more than 32 signed bits hold


def test_p95_over_all_requests():
    assert harness.p95([float(v) for v in range(1, 101)]) == 95.0
    assert harness.p95([float(v) for v in range(20, 0, -1)]) == 19.0
    assert harness.p95([3.0]) == 3.0


def test_metric_lists_by_cell():
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    names = [m["name"] for m in harness._for_cell(spec["end_to_end"], "std128.ks_b64")]
    assert names == ["ct_ops_per_s", "peak_device_gb", "setup_s"]
    names = [m["name"] for m in harness._for_cell(spec["per_layer"], "deep65536.codec_b8")]
    assert all(n.endswith(".req") for n in names) and len(names) == 4


def test_every_name_is_found():
    spec = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    bench = tiny.REPO / "hebench"
    for c in spec["configs"]:
        assert harness.load_json(tiny.REPO / c["file"])["n"] > 0
    for w in spec["workloads"]:
        mix = harness.load_json(bench / "traffic" / f"{w['traffic']}.json")
        kind = traffic.load_kind(bench, mix["kind"])
        assert callable(kind.control) and issubclass(kind.Cell, traffic.Cell)
        assert harness.load_json(bench / "limits" / f"{w['name']}.json")
    for m in spec["per_layer"]:
        assert callable(harness.load_metric(bench, m["name"]).read)


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_cell_rehearsal_on_the_cpu(tmp_path, workload):
    root = tiny.make_root(tmp_path)
    res = harness.run(workload, SEED, 0.5, False, time.perf_counter(), root=root, device="cpu")
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == set(harness.e2e_names(json.loads(
        (root / "BENCHMARK.json").read_text()), workload))
    assert list(res)[-1] == "checks"


def test_added_config_mix_and_metric_run_from_new_files(tmp_path):
    root = tiny.make_root(tmp_path)
    bench = root / "hebench"
    cfg = json.loads((bench / "configs" / "ckks_std128_n16384.json").read_text())
    cfg.update(n=512, chain_primes=3, special_primes=1, alpha=1)
    (bench / "configs" / "dummy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "ks_dummy.json").write_text(json.dumps(
        {"kind": "ckks_ks", "batch": 2, "ops": {"rotate": 1}, "rotate_steps": [3],
         "levels": [2, "top"], "sample_outputs": 2}))
    (bench / "limits" / "dummy.ks_dummy.json").write_text(json.dumps(
        {"mult_err": 2.0**-5, "rotate_err": 2.0**-5, "residue_mismatch": 0}))
    (bench / "metrics" / "steps_seen.py").write_text("def read(r):\n    return r.steps\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy", "source": "none", "file": "hebench/configs/dummy.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy.ks_dummy", "config": "dummy",
                              "traffic": "ks_dummy", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                              "source": "program_counter", "layer": "scheme",
                              "moves": "ct_ops_per_s", "workloads": ["dummy.ks_dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    res = harness.run("dummy.ks_dummy", SEED, 0.3, False, time.perf_counter(), root=root,
                      device="cpu")
    assert res["correct"] and res["attempted"] > 0 and res["metrics"]["setup_s"]["value"] > 0
    reader = harness.load_metric(bench, "steps_seen")
    assert reader.read(harness.Reading({}, {}, None, [("rotate", 2)] * 3, 6, {}, {}, [])) == 3


# a request kind of its own, as a later cell would add it: one step adds a
# pool batch to itself; the judgement decrypts the sum against 2 z
DOUBLE_KIND = '''
import numpy as np

from hebench.schemes.ckks import CkksCell, answer
from hebench.traffic import check, sync

SCHEME = "ckks"


class Cell(CkksCell):
    def setup(self):
        self.sk = self._sk()
        self.z = np.random.default_rng([self.seed, 9]).uniform(-1, 1, (self.batch, self.n // 2))
        self.ct = self._encrypt(self.z, self.L)

    def _add(self, ct):
        from hehub_tpu_torch.models import ckks

        return ckks.add(self.ctx, ct, ct)

    def step(self):
        self.out = self._add(self.ct)
        sync(self.device)
        self.work.append(("add", self.L))
        return self.batch, 0.0

    def judge(self):
        c0, c1, scale = answer(self.out)
        got = self.reference().decrypt_slots(c0, c1, scale)
        return {"add_err": check([float(np.abs(got - 2 * self.z).max())],
                                 self.limits["add_err"])}


def control(cell, exact=False):
    cell._add = lambda ct: ct
'''


def _add_cell(root, name, kind, limits):
    (root / "hebench" / "traffic" / f"{name}.json").write_text(json.dumps(
        {"kind": kind, "batch": 2}))
    (root / "hebench" / "limits" / f"std128.{name}.json").write_text(json.dumps(limits))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": f"std128.{name}", "config": "ckks_std128_n16384",
                              "traffic": name, "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return spec


def test_added_kind_runs_from_new_files(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "hebench" / "kinds" / "ckks_double.py").write_text(DOUBLE_KIND)
    _add_cell(root, "double_b2", "ckks_double", {"add_err": 2.0**-10})
    res = harness.run("std128.double_b2", SEED, 0.2, False, time.perf_counter(), root=root,
                      device="cpu")
    assert res["correct"] and res["attempted"] > 0 and res["checks"]["add_err"]["value"] < 1e-5
    res = harness.run("std128.double_b2", SEED, 0.2, False, time.perf_counter(), root=root,
                      device="cpu", control="below")
    assert not res["correct"]


def test_jax_loaded_by_a_metric_reader_gives_no_result(tmp_path):
    root = tiny.make_root(tmp_path)
    (root / "hebench" / "metrics" / "loads_jax.py").write_text(
        "import sys\nimport types\n\nsys.modules.setdefault('jax', types.ModuleType('jax'))\n\n\n"
        "def read(r):\n    return 1.0\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "loads_jax", "unit": "x", "better": "higher",
                              "source": "program_counter", "layer": "scheme",
                              "moves": "ct_ops_per_s", "workloads": ["std128.ks_b64"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert "jax" not in sys.modules
    try:
        with pytest.raises(harness.ForbiddenModules, match="jax"):
            harness.run("std128.ks_b64", SEED, 0.3, True, time.perf_counter(), root=root,
                        device="cpu")
    finally:
        sys.modules.pop("jax", None)


def test_cli_refuses_without_a_card(monkeypatch, capsys):
    from hebench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "std128.ks_b64", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.cuda
def test_a_short_traced_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    res = harness.run("std128.ks_b64", SEED, 2.0, True, time.perf_counter())
    assert res["correct"]
    for name, m in res["metrics"].items():
        if name.startswith(("op_roofline", "extprod_roofline", "ntt_roofline")):
            assert 0 < m["value"] <= 100
