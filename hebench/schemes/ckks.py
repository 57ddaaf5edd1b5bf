"""The program's CKKS, set up for a cell: its parameters from the
configuration (checked against the primes the reference works out), the
seed's ternary secret, and the host copies of sampled answers that the
reference judges after the window."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from hebench.traffic import Cell, Check


def answer(out) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """(c0, c1, scale) of a ciphertext: the program's CkksCt, or the
    control's triple."""
    if isinstance(out, tuple):
        return out
    return out.c0.data, out.c1.data, out.scaling_factor


class CkksCell(Cell):
    """A CKKS cell: `params`, `ctx`, the secret `tern` (its coefficients, as
    both sides get them), the program's generator `gen`, a seeded NumPy
    `rng`, and pinned host rows for the sample."""

    HELD = ("sk", "rlk", "rks", "views", "ctx")

    def __init__(self, config: dict, mix: dict, limits: Dict[str, float], seed: int, device):
        from hehub_tpu_torch.core.context import create_ckks_params, make_context

        t0 = time.perf_counter()
        super().__init__(config, mix, limits, seed, device)
        self.n, self.L = config["n"], config["chain_primes"]
        self.K, self.alpha = config["special_primes"], config["alpha"]
        self.scale = 2.0 ** config["scaling_bits"]
        self.batch = mix.get("batch", 1)
        self.params = create_ckks_params(self.n, config["scaling_bits"], num_levels=self.L,
                                         use_security_budget=False, num_special=self.K)
        self.chain, self.special = self.ref.chain_and_special(self.n, self.L, self.K,
                                                              config["prime_bits"])
        if list(self.params.moduli) != self.chain or list(self.params.special_mods) != self.special:
            raise RuntimeError("the program's primes are not the configuration's")
        log_qp = sum(np.log2(self.chain + self.special))
        if log_qp > config["max_log_qp"]:
            raise RuntimeError(f"log2 QP = {log_qp:.1f} over the stated {config['max_log_qp']}")
        self.ctx = make_context(self.params)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.rng = np.random.default_rng([seed, 1])
        self.tern = torch.randint(-1, 2, (self.n,), generator=self.gen,
                                  device=self.device).to(torch.int8)
        self.phases["context"] = time.perf_counter() - t0

    def _sk(self):
        from hehub_tpu_torch.rlwe import rlwe as rlwe_mod

        return rlwe_mod.sk_from_coeffs(self.ctx, self.tern)

    def _encrypt(self, z: np.ndarray, level: int):
        """Slots [B, n/2] encoded and encrypted at `level` limbs by the program."""
        from hehub_tpu_torch.models import ckks

        pt = ckks.encode(z, self.params, level=self.L - level, device=self.device)
        return ckks.encrypt(self.ctx, pt, self.sk, self.gen)

    def reference(self, float64_products: bool = False):
        return self.ref.Ckks(self.n, self.chain, self.special, self.alpha, self.tern,
                             self.device, float64_products)

    def host_rows(self, count: int) -> torch.Tensor:
        """`count` host buffers [2, L, n] of one ciphertext row each, pinned
        on the card so that a sampled answer's copy is asynchronous."""
        return torch.empty((count, 2, self.L, self.n), dtype=torch.int64,
                           pin_memory=self.device.type == "cuda")

    @staticmethod
    def keep(buf: torch.Tensor, out, row: int) -> tuple:
        """Row `row` of an answer, every limb, copied into `buf` ([2, L, n])
        behind the step's work: (c0, c1, scale), or (None, None, scale)
        where the answer lacks the row. The step's sync ends the copy."""
        c0, c1, scale = answer(out)
        if row >= c0.shape[0]:
            return None, None, scale
        k = c0.shape[-2]
        buf[0, :k].copy_(c0[row], non_blocking=True)
        buf[1, :k].copy_(c1[row], non_blocking=True)
        return buf[0, :k], buf[1, :k], scale

    def residues(self, r, answers: List[tuple], missing: int) -> Check:
        """Every limb of every answer judged exactly: the residues of
        c0 + c1 s on limbs 2 .. l-1 that differ from the integer that limbs
        0 and 1 give. `value` counts them (limit 0); `failed` counts the
        answers with any, and those that never came."""
        bad = [r.residue_mismatches(c0.to(self.device), c1.to(self.device))
               for c0, c1 in answers]
        return Check(float(sum(bad)), self.limits["residue_mismatch"],
                     sum(b > 0 for b in bad) + missing, len(answers))
