"""A benchmark root at tiny rings for the CPU: the cells of BENCHMARK.json
with each configuration cut to a small n (and a few limbs), written as new
files beside copies of the real traffic mixes, request kinds, limits and
metric readers, so that the same harness runs them on the CPU with the
program's plain kernels."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
TINY = {
    "ckks_std128_n16384": dict(n=512, chain_primes=4, special_primes=2, alpha=2),
    "ckks_deep_n65536": dict(n=512, chain_primes=6, special_primes=4, alpha=4),
}
# the real cells' limits hold at n=512 too, but the tiny rings
# are not the cells: these are wide enough for any sound run there
TINY_LIMITS = {"mult_err": 2.0**-5, "rotate_err": 2.0**-5, "encrypt_err": 2.0**-10,
               "decode_gap": 1e-9, "residue_mismatch": 0}


def make_root(tmp: Path) -> Path:
    """A root under `tmp` holding BENCHMARK.json and hebench/ with the tiny
    configurations; returns it."""
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = tmp / "hebench"
    for sub in ("traffic", "kinds", "metrics", "configs", "limits"):
        (bench / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("traffic", "kinds", "metrics"):
        for f in (REPO / "hebench" / sub).iterdir():
            if f.is_file():
                shutil.copy(f, bench / sub / f.name)
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg.update(TINY[c["name"]], max_log_qp=10_000)
        (bench / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
        c["file"] = f"hebench/configs/{c['name']}.json"
    for w in spec["workloads"]:
        lim = json.loads((REPO / "hebench" / "limits" / f"{w['name']}.json").read_text())
        lim = {k: TINY_LIMITS[k] for k in lim}
        (bench / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
