"""The one traffic generator. A mix (hebench/traffic/<mix>.json) is data:
its "kind" names a request kind, hebench/kinds/<kind>.py, found by name as
the metric readers are, and the rest are that kind's parameters (batch,
levels, op weights, rotation steps, sample size ...).

A kind module defines
  SCHEME              the configuration's "scheme" it serves;
  Cell                its cell (a subclass of `Cell` below): set-up from
                      the configuration and the seed, one request a
                      `step()` of a closed loop, a seeded sample of the
                      answers, and their judgement after the window by the
                      plain reference of the scheme
                      (hebench/reference/<scheme>.py);
  control(cell, exact)  puts that reference in the program's place in the
                      cell, at the precision below the configuration's
                      (exact=True: at full precision, which has to pass).
A later cell of another kind adds a kind file and data files, and edits
none that are here.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def level_of(spec, top: int) -> int:
    """A mix's level: a number of chain limbs, or "top" for all of them."""
    return top if spec == "top" else int(spec)


@dataclasses.dataclass
class Check:
    """A number compared with its limit over the `count` answers judged (0
    where none was due); `failed` counts the answers over the limit,
    missing or of the wrong shape."""

    value: float
    limit: float
    failed: int = 0
    count: int = 0

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.value)) and self.value <= self.limit and self.failed == 0


def check(errors: List[float], limit: float, bad_shapes: int = 0) -> Check:
    """The widest of `errors` against `limit`."""
    return Check(max(errors, default=0.0), limit,
                 sum(not e <= limit for e in errors) + bad_shapes, len(errors))


class Reservoir:
    """A uniform seeded sample of at most `size` of the items offered."""

    def __init__(self, size: int, rng: np.random.Generator):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def wants(self) -> Optional[int]:
        """The slot the next item goes to, or None to pass it by."""
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(None)
            return len(self.items) - 1
        j = int(self.rng.integers(self.seen))
        return j if j < self.size else None


class Cell:
    """Set-up, one request a `step()`, and the judgement of the sample.
    `step()` ends in a device sync and returns (ciphertext ops completed,
    host seconds from its start to its last call returning), and adds a
    descriptor of its work to `work`. `judge()` returns the numbers
    compared, by name; each has its limit in `limits`."""

    # what the judgement does not need: keys, pools, the program's tables
    HELD: tuple = ()

    def __init__(self, config: dict, mix: dict, limits: Dict[str, float], seed: int, device):
        self.config, self.mix, self.limits, self.seed = config, mix, limits, seed
        self.device = torch.device(device)
        self.ref = importlib.import_module(f"hebench.reference.{config['scheme']}")
        self.phases: Dict[str, float] = {}  # set-up seconds by part, for the log
        self.work: List[tuple] = []
        self.bad_shapes = 0

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        sync(self.device)
        self.phases[name] = time.perf_counter() - t0

    def setup(self) -> None:
        raise NotImplementedError

    def step(self):
        raise NotImplementedError

    def judge(self) -> Dict[str, Check]:
        raise NotImplementedError

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in self.HELD:
            if hasattr(self, name):
                setattr(self, name, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def load_kind(bench_dir: Path, kind: str):
    """The module hebench/kinds/<kind>.py of the benchmark at `bench_dir`."""
    path = bench_dir / "kinds" / f"{kind}.py"
    spec = importlib.util.spec_from_file_location(f"hebench_kind_{kind}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_cell(bench_dir: Path, config: dict, mix: dict, limits: Dict[str, float], seed: int,
              device, control: Optional[str] = None) -> Cell:
    """The cell of the mix's kind; with `control` ("below" or "exact") the
    kind's control in place of the program."""
    kind = load_kind(bench_dir, mix["kind"])
    if config["scheme"] != kind.SCHEME:
        raise ValueError(f"kind {mix['kind']} serves {kind.SCHEME}, not {config['scheme']}")
    cell = kind.Cell(config, mix, limits, seed, device)
    if control is not None:
        kind.control(cell, exact=control == "exact")
    return cell
