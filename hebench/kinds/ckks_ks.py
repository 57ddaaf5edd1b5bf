"""Request kind `ckks_ks`: key switching under load. One step is one batch
of `batch` ciphertexts through one op of `ops` ("mult": mult + relinearize
+ rescale of two operands; "rotate": rotate by a step of `rotate_steps`),
at a level of `levels` (chain limbs; "top" for all), every level and op in
each round in a seeded low-discrepancy order, so that any run's work has
one mix. Set-up makes the relinearisation key, a rotation key a step, and
one pool batch of `batch` + 1 ciphertexts a level; a mult's operands are
its rows [0, B) and [1, B + 1).

The judgement: a seeded sample of `sample_outputs` answer rows and the
first top-level answer of each op, every limb, decrypted by the reference
against a·b or roll(a, step) (`mult_err`, `rotate_err`: the widest slot
error) and checked limb by limb (`residue_mismatch`)."""

from __future__ import annotations

import time
from typing import Dict

import numpy as np

from hebench.schemes.ckks import CkksCell, answer
from hebench.traffic import Check, Reservoir, check, level_of, sync

SCHEME = "ckks"
OPS = ("mult", "rotate")


def _row_views(ct, lo: int, hi: int):
    from hehub_tpu_torch.models import ckks

    return ckks.CkksCt(ct.c0.with_data(ct.c0.data[lo:hi]), ct.c1.with_data(ct.c1.data[lo:hi]),
                       ct.scaling_factor)


class Cell(CkksCell):
    def setup(self) -> None:
        from hehub_tpu_torch.rlwe import keys as keys_mod

        mix, B = self.mix, self.batch
        self.steps = [int(s) for s in mix["rotate_steps"]]
        with self.phase("keys"):
            self.sk = self._sk()
            self.rlk = keys_mod.relin_key(self.ctx, self.sk, self.gen, alpha=self.alpha)
            self.rks = {s: keys_mod.rot_key(self.ctx, self.sk, s, self.gen, alpha=self.alpha)
                        for s in self.steps}
        lo, hi = level_of(mix["levels"][0], self.L), level_of(mix["levels"][1], self.L)
        self.levels = list(range(lo, hi + 1))
        self.views = {}
        with self.phase("inputs"):
            for lv in self.levels:
                ct = self._encrypt(self.messages(lv), lv)
                self.views[lv] = (_row_views(ct, 0, B), _row_views(ct, 1, B + 1))
        order = np.argsort((np.arange(len(self.levels)) * 0.6180339887498949
                            + self.rng.random()) % 1.0)
        ops = [op for op, w in sorted(mix["ops"].items()) for _ in range(int(w))]
        self.round = [(op, self.levels[i]) for i in order for op in ops]
        self.step_order = [self.steps[i] for i in self.rng.permutation(len(self.steps))]
        self.pos = self.rot_count = 0
        self.sample = Reservoir(mix["sample_outputs"], np.random.default_rng([self.seed, 2]))
        self.rows = self.host_rows(mix["sample_outputs"] + len(OPS))
        self.forced = {}
        # warm-up: every level through each op, every step once
        with self.phase("warm_up"):
            for i, lv in enumerate(self.levels):
                self._run("mult", lv, 0)
                self._run("rotate", lv, self.steps[i % len(self.steps)])
            for s in self.steps:
                self._run("rotate", self.levels[-1], s)

    def messages(self, level: int) -> np.ndarray:
        return np.random.default_rng([self.seed, 3, level]).uniform(
            -1, 1, (self.batch + 1, self.n // 2))

    def _run(self, op: str, level: int, step: int):
        from hehub_tpu_torch.models import ckks

        a, b = self.views[level]
        if op == "mult":
            return ckks.rescale(self.ctx, ckks.mult(self.ctx, a, b, self.rlk))
        return ckks.rotate(self.ctx, a, self.rks[step], step)

    def step(self):
        op, level = self.round[self.pos % len(self.round)]
        self.pos += 1
        step = 0
        if op == "rotate":
            step = self.step_order[self.rot_count % len(self.step_order)]
            self.rot_count += 1
        t0 = time.perf_counter()
        out = self._run(op, level, step)
        t1 = time.perf_counter()
        if answer(out)[0].shape[0] != self.batch:
            self.bad_shapes += 1
        # the sample, and the first top-level answer of each op
        slot = self.sample.wants()
        first_top = level == self.levels[-1] and op not in self.forced
        if slot is not None or first_top:
            row = int(self.rng.integers(self.batch))
            buf = self.rows[self.mix["sample_outputs"] + OPS.index(op) if first_top else slot]
            item = (op, level, step, row, *self.keep(buf, out, row))
            if slot is not None:
                self.sample.items[slot] = item
            if first_top:
                self.forced[op] = item
        sync(self.device)
        self.work.append((op, level))
        return self.batch, t1 - t0

    def judge(self) -> Dict[str, Check]:
        r = self.reference()
        errs = {op: [] for op in OPS}
        answers, missing = [], 0
        for op, level, step, row, c0, c1, scale in (
                [i for i in self.sample.items if i is not None] + list(self.forced.values())):
            if c0 is None:  # the answer never came
                errs[op].append(float("inf"))
                missing += 1
                continue
            c0, c1 = c0.to(self.device), c1.to(self.device)
            answers.append((c0, c1))
            z = self.messages(level)
            want = z[row] * z[row + 1] if op == "mult" else np.roll(z[row], step)
            errs[op].append(float(np.abs(r.decrypt_slots(c0, c1, scale) - want).max()))
        out = {name: check(errs[op], self.limits[name], self.bad_shapes)
               for op, name in (("mult", "mult_err"), ("rotate", "rotate_err"))}
        out["residue_mismatch"] = self.residues(r, answers, missing)
        return out


def control(cell: Cell, exact: bool = False) -> None:
    """The reference in the program's place for the timed ops (warm-up
    and window): every modular product rounded to float64 (53 bits of the
    60 a product of two 30-bit residues needs), or exact. Its keys come
    from the same secret; the inputs are the cell's pool."""
    prog = cell.reference(float64_products=not exact)
    keys = {}

    def key(step: int):
        if step not in keys:
            keys[step] = prog.relin_key(cell.gen) if step == 0 else prog.rot_key(step, cell.gen)
        return keys[step]

    def run(op: str, level: int, step: int):
        a, b = cell.views[level]
        x, y = answer(a)[:2], answer(b)[:2]
        if op == "mult":
            o0, o1 = prog.mult(x, y, key(0))
            return o0, o1, a.scaling_factor * b.scaling_factor / cell.chain[level - 1]
        o0, o1 = prog.rotate(x, key(step), step)
        return o0, o1, a.scaling_factor

    cell._run = run
