"""Request kind `ckks_boot`: CKKS bootstrapping under load. One step
refreshes `batch` exhausted ciphertexts (one chain limb at the
configuration's input scale, n/2 real slots uniform in [-1, 1]), cycled
from `inputs` made in set-up, through the program's
CompiledBootstrapper(split=True) with sparse-secret encapsulation; a
refreshed ciphertext counts one op.

Set-up: the configuration's primes (checked against those the reference
works out, and log QP against its bound), the seed's secret of weight
`secret_weight` and ephemeral secret of weight `ephemeral_weight` (both
sides get their coefficients), the keys (relinearisation, conjugation, one
rotation key a step of the factored transforms, the two SSE keys), the
inputs, the compiled refresh (discovery, plans, capture) and one warm
refresh.

The judgement: a seeded sample of `sample_outputs` refreshed ciphertexts,
every limb, decrypted by the reference under the secret against the
input's slots (`boot_err`: the widest slot error), checked limb by limb
(`residue_mismatch`), and their chain limbs against the configuration's
`refreshed_limbs` (`limb_shortfall`: the limbs missing, summed)."""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch

from hebench.schemes.ckks import CkksCell, answer
from hebench.traffic import Cell as BaseCell
from hebench.traffic import Check, Reservoir, check, sync

SCHEME = "ckks_boot"
# the largest ring at which the reference's dense transforms run (the
# control); they take s^2 complex entries a matrix
REFERENCE_MAX_N = 1024


class Cell(BaseCell):
    HELD = ("sk", "keys", "booter", "refresh", "inputs", "ctx", "ref_keys")

    def __init__(self, config: dict, mix: dict, limits: Dict[str, float], seed: int, device):
        from hehub_tpu_torch.circuits import bootstrap as bs
        from hehub_tpu_torch.core.context import make_context

        t0 = time.perf_counter()
        super().__init__(config, mix, limits, seed, device)
        c = config
        self.n, self.L = c["n"], c["chain_primes"]
        self.K, self.alpha = c["special_primes"], c["alpha"]
        self.scale = 2.0 ** c["scaling_bits"]
        self.batch = mix.get("batch", 1)
        params = bs.make_boot_params(self.n, self.L, num_special=self.K)
        self.chain, self.special = self.ref.chain_and_special(self.n, self.L, self.K,
                                                              c["prime_bits"])
        if list(params.moduli) != self.chain or list(params.special_mods) != self.special:
            raise RuntimeError("the program's primes are not the configuration's")
        log_qp = sum(np.log2(self.chain + self.special))
        if log_qp > c["max_log_qp"]:
            raise RuntimeError(f"log2 QP = {log_qp:.1f} over the stated {c['max_log_qp']}")
        # the working scale: the chain's two smallest primes (configuration)
        self.delta = float(self.chain[-1] * self.chain[-2])
        self.params = dataclasses.replace(params, initial_scaling_factor=self.delta)
        self.ctx = make_context(self.params)
        secrets = np.random.default_rng([seed, 1])
        self.tern = torch.from_numpy(self.ref.sparse_ternary(self.n, c["secret_weight"], secrets))
        self.eph = torch.from_numpy(self.ref.sparse_ternary(self.n, c["ephemeral_weight"],
                                                            secrets))
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        self.rng = np.random.default_rng([seed, 2])
        self.phases["context"] = time.perf_counter() - t0

    def setup(self) -> None:
        from hehub_tpu_torch.models import ckks
        from hehub_tpu_torch.rlwe import rlwe as rlwe_mod

        mix, B = self.mix, self.batch
        with self.phase("inputs"):
            self.sk = rlwe_mod.sk_from_coeffs(self.ctx, self.tern.to(self.device))
            rng = np.random.default_rng([self.seed, 6])
            self.plain = [rng.uniform(-1, 1, (B, self.n // 2)) for _ in range(mix["inputs"])]
            self.inputs = [ckks.encrypt(self.ctx, ckks.encode(z, self.params,
                                                              scaling_factor=self.scale,
                                                              level=self.L - 1,
                                                              device=self.device),
                                        self.sk, self.gen) for z in self.plain]
        self._make_program()
        self.i = 0
        self.sample = Reservoir(mix["sample_outputs"], np.random.default_rng([self.seed, 3]))
        self.rows = torch.empty((mix["sample_outputs"], 2, self.L, self.n), dtype=torch.int64,
                                pin_memory=self.device.type == "cuda")
        with self.phase("warm_up"):
            self._refresh(self.inputs[0])

    def _make_program(self) -> None:
        """The keys and the compiled refresh."""
        from hehub_tpu_torch.circuits import bootstrap as bs
        from hehub_tpu_torch.rlwe import keys as keys_mod
        from hehub_tpu_torch.rlwe import rlwe as rlwe_mod

        c, ctx, gen, a = self.config, self.ctx, self.gen, self.alpha
        with self.phase("keys"):
            sk_eph = rlwe_mod.sk_from_coeffs(ctx, self.eph.to(self.device))
            sse = keys_mod.sse_keys(ctx, self.sk, sk_eph, gen, alpha=a)
            steps = bs.bootstrap_rotation_steps(self.params, c["lt_stages"])
            self.keys = dict(
                sse=sse, rlk=keys_mod.relin_key(ctx, self.sk, gen, alpha=a),
                conj=keys_mod.conj_key(ctx, self.sk, gen, alpha=a),
                rot={st: keys_mod.rot_key(ctx, self.sk, st, gen, alpha=a) for st in steps})
        with self.phase("plans_and_capture"):
            k = self.keys
            self.booter = bs.Bootstrapper(
                ctx, self.params, k["rlk"], k["rot"], k["conj"], k_bound=c["k_bound"],
                degree=c["evalmod_degree"], arcsine=c["arcsine_degree"] or False,
                double_angle=c["double_angle"], lt_stages=c["lt_stages"], sse=k["sse"])
            self.refresh = bs.CompiledBootstrapper(self.booter, self.inputs[0], split=True)

    def _refresh(self, ct):
        return self.refresh(ct)

    def step(self):
        k = self.i % len(self.inputs)
        self.i += 1
        t0 = time.perf_counter()
        out = self._refresh(self.inputs[k])
        t1 = time.perf_counter()
        c0 = answer(out)[0]
        if c0.shape[0] != self.batch:
            self.bad_shapes += 1
        slot = self.sample.wants()
        if slot is not None:
            row = int(self.rng.integers(self.batch))
            self.sample.items[slot] = (k, row, *CkksCell.keep(self.rows[slot], out, row))
        sync(self.device)
        self.work.append(("refresh", c0.shape[-2]))
        return self.batch, t1 - t0

    def reference(self, float64_products: bool = False):
        return self.ref.CkksBoot(self.n, self.chain, self.special, self.alpha, self.tern,
                                 self.eph, self.device, float64_products)

    def judge(self) -> Dict[str, Check]:
        r = self.reference()
        errs, answers, missing, short, shorts = [], [], 0, 0, 0
        for k, row, c0, c1, scale in (i for i in self.sample.items if i is not None):
            if c0 is None:  # the answer never came
                errs.append(float("inf"))
                missing += 1
                continue
            c0, c1 = c0.to(self.device), c1.to(self.device)
            answers.append((c0, c1))
            errs.append(float(np.abs(r.decrypt_slots(c0, c1, scale) - self.plain[k][row]).max()))
            lack = max(0, self.config["refreshed_limbs"] - c0.shape[-2])
            short += lack
            shorts += lack > 0
        return {"boot_err": check(errs, self.limits["boot_err"], self.bad_shapes),
                "residue_mismatch": CkksCell.residues(self, r, answers, missing),
                "limb_shortfall": Check(float(short), self.limits["limb_shortfall"],
                                        shorts + missing, len(errs))}


def control(cell: Cell, exact: bool = False) -> None:
    """The reference's refresh in the program's place (its keys in set-up,
    then every refresh): its own keys from the same secrets, its dense
    transforms and Chebyshev fit; every modular product rounded to float64
    (53 bits of the 60 a product of two 30-bit residues needs), or exact.
    The inputs are the cell's. Only at rings where the dense transforms fit
    (REFERENCE_MAX_N); above them the control below is float32_plans, and
    there is no exact one."""
    if cell.n > REFERENCE_MAX_N:
        if exact:
            raise ValueError(f"the reference's dense refresh runs at n <= {REFERENCE_MAX_N}, "
                             f"not {cell.n}")
        float32_plans(cell)
        return
    prog = cell.reference(float64_products=not exact)
    c = cell.config

    def make():
        with cell.phase("keys"):
            cell.ref_keys = prog.boot_keys(cell.gen, prog.rotation_steps())

    def refresh(ct):
        c0, c1, _ = answer(ct)
        return prog.refresh((c0, c1), cell.scale, cell.ref_keys, c["k_bound"],
                            c["evalmod_degree"], cell.delta)

    cell._make_program, cell._refresh = make, refresh


def float32_plans(cell: Cell) -> None:
    """The program's refresh with the linear transforms a precision below
    the configuration's: every plan diagonal rounded to float32 (complex64)
    before it is encoded, where the program encodes the float64 diagonals.
    Everything else is the program's, so it runs at the cell's own size."""
    from hehub_tpu_torch.circuits import bootstrap as bs

    make = cell._make_program

    def make_float32():
        diagonal = bs._diagonal

        def rounded(M, k):
            return diagonal(M, k).astype(np.complex64).astype(np.complex128)

        bs._diagonal = rounded  # the plans are all encoded in discovery
        try:
            make()
        finally:
            bs._diagonal = diagonal

    cell._make_program = make_float32
