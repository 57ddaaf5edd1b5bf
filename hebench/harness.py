"""One run of one cell: set-up, a measured window, the per-layer readings of
a traced window, the judgement of the sampled answers, one result line.

Everything a cell needs is found by name under the benchmark's folder:
the configuration's file (BENCHMARK.json's `configs`), the traffic mix
`traffic/<mix>.json` and the request kind it names, `kinds/<kind>.py`
(hebench/traffic.py), the limits of the numbers compared
`limits/<workload>.json`, and each per-layer metric's reader
`metrics/<metric>.py`, a module whose `read(reading)` returns the number,
or None where the window holds nothing for it to read.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import statistics
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from hebench import traffic
from hebench.trace import Traced, activity_class, traced_window

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hehub_tpu")
TRACE_SECONDS = 10.0  # the traced part of a --trace 1 run's window, at most


@dataclasses.dataclass
class Reading:
    """What a per-layer metric reads: the cell, the traced window, the work
    done in it, the program's launch counters over it, and the host
    seconds to enqueue each request of the untraced part."""

    config: dict
    mix: dict
    traced: Traced
    work: List[tuple]
    units: int
    launches: Dict[str, int]
    launch_rows: Dict[str, Dict[int, int]]
    host_enqueue_s: List[float]

    @property
    def steps(self) -> int:
        return len(self.work)

    @staticmethod
    def classify(name: str) -> str:
        return activity_class(name)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_metric(bench_dir: Path, name: str):
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hebench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def p95(values: List[float]) -> float:
    """The 95th percentile by nearest rank: the value that 95 % of the
    values are at or below."""
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def _for_cell(metrics: List[dict], workload: str) -> List[dict]:
    return [m for m in metrics if workload in m.get("workloads", [workload])]


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class ForbiddenModules(RuntimeError):
    """The run loaded JAX or the JAX package: it gives no result."""


class Window:
    """Steps of a cell for a stated time: the seconds it took (ending in the
    last step's device sync), ciphertext ops, and each step's latency and
    host enqueue time."""

    def __init__(self, cell, seconds: float):
        self.units, self.latency, self.enqueue = 0, [], []
        t0 = time.perf_counter()
        while True:
            s = time.perf_counter()
            units, enq = cell.step()
            t = time.perf_counter()
            self.units += units
            self.latency.append(t - s)
            self.enqueue.append(enq)
            if t - t0 >= seconds:
                break
        self.seconds = t - t0


def _counters():
    from hehub_tpu_torch import kernels

    return dict(kernels.LAUNCHES), {k: dict(v) for k, v in kernels.LAUNCH_ROWS.items()}


def _delta(before, after):
    launches = {k: after[0][k] - before[0].get(k, 0) for k in after[0]}
    rows = {k: {r: c - before[1].get(k, {}).get(r, 0) for r, c in v.items()
                if c - before[1].get(k, {}).get(r, 0)} for k, v in after[1].items()}
    return launches, rows


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        root: Path = ROOT, device: str = "cuda", control: Optional[str] = None) -> dict:
    """The result of one run, as the line that run.py prints. `control`
    ("below" or "exact") puts the kind's control in the program's place
    (hebench/control.py). Raises ForbiddenModules where the process holds
    JAX or the JAX package once everything has run."""
    spec = load_json(root / "BENCHMARK.json")
    bench_dir = root / spec["paths"][0]
    wl = next(w for w in spec["workloads"] if w["name"] == workload)
    cfg_entry = next(c for c in spec["configs"] if c["name"] == wl["config"])
    config = load_json(root / cfg_entry["file"])
    mix = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    limits = load_json(bench_dir / "limits" / f"{workload}.json")
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    cell = traffic.make_cell(bench_dir, config, mix, limits, seed, device, control)
    cell.setup()
    setup_s = time.perf_counter() - t_start
    print(f"set-up {setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in cell.phases.items()),
          file=sys.stderr)

    reading = None
    if trace:
        traced_s = min(seconds, TRACE_SECONDS)
        plain = Window(cell, seconds - traced_s) if seconds > traced_s else None
        first = len(cell.work)
        before = _counters()
        box = {}
        traced = traced_window(lambda: box.setdefault("w", Window(cell, traced_s)), on_card)
        tw = box["w"]
        launches, rows = _delta(before, _counters())
        reading = Reading(config, mix, traced, cell.work[first:], tw.units, launches, rows,
                          (plain or tw).enqueue)
        window = tw
    else:
        window = Window(cell, seconds)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    cell.release()
    checks = cell.judge()

    requests = len(window.latency)
    print(f"window {window.seconds:.3f} s, {requests} requests, {window.units} ciphertext ops; "
          f"request latency median {statistics.median(window.latency) * 1e3:.3f} ms, "
          f"p95 {p95(window.latency) * 1e3:.3f} ms over {requests}", file=sys.stderr)
    metrics = {}
    if trace:
        for m in _for_cell(spec["per_layer"], workload):
            value = load_metric(bench_dir, m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = dict(
            ct_ops_per_s=window.units / window.seconds,
            requests_per_s=requests / window.seconds,
            request_p95_ms=p95(window.latency) * 1e3,
            peak_device_gb=peak / 1e9,
            setup_s=setup_s,
        )
        for m in _for_cell(spec["end_to_end"], workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    # the last step: the window, the judgement and the readers have run
    found = forbidden_modules()
    if found:
        raise ForbiddenModules(f"modules the benchmark must not load: {found}")
    result = {
        "correct": all(c.ok for c in checks.values()),
        "attempted": window.units if "ct_ops_per_s" in e2e_names(spec, workload) else requests,
        "failed": sum(c.failed for c in checks.values()),
        "metrics": metrics,
        "device": device_info(peak, reading),
    }
    if reading is not None:
        result["breakdown"] = reading.traced.breakdown()
    result["checks"] = {k: {"value": c.value, "limit": c.limit} for k, c in checks.items()}
    for k, c in checks.items():
        print(f"check {k} {c.value!r} limit {c.limit!r} (answers {c.count}, failed {c.failed})",
              file=sys.stderr)
    return result


def e2e_names(spec: dict, workload: str) -> List[str]:
    return [m["name"] for m in _for_cell(spec["end_to_end"], workload)]


def device_info(peak: int, reading: Optional[Reading]) -> dict:
    if not torch.cuda.is_available():
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": peak}
    if reading is not None:
        info["busy_s"] = reading.traced.busy_s
        info["window_s"] = reading.traced.wall_s
    return info
