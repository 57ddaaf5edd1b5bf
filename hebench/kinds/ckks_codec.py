"""Request kind `ckks_codec`: the client's side. One request encodes and
encrypts `batch` vectors of real slots uniform in [-1, 1] at
`encrypt_level` limbs, then decrypts and decodes `batch` ciphertexts at
`decrypt_level` limbs (made in set-up) into host arrays; the inputs cycle
through `inputs` of each, made from the seed.

The judgement, over a seeded sample of `sample_outputs` requests: one
seeded row of the encryption, every limb, decrypted by the reference
against its slots (`encrypt_err`) and checked limb by limb
(`residue_mismatch`); the whole decoded batch against the reference's
decryption and float64 decode of the same ciphertexts (`decode_gap`)."""

from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np
import torch

from hebench.schemes.ckks import CkksCell, answer
from hebench.traffic import Check, Reservoir, check, level_of, sync

SCHEME = "ckks"


class Cell(CkksCell):
    def setup(self) -> None:
        B, slots = self.batch, self.n // 2
        self.top = level_of(self.mix["encrypt_level"], self.L)
        self.dec_level = level_of(self.mix["decrypt_level"], self.L)
        rng = np.random.default_rng([self.seed, 6])
        self.plain = [rng.uniform(-1, 1, (B, slots)) for _ in range(self.mix["inputs"])]
        with self.phase("keys"):
            self.sk = self._sk()
        with self.phase("inputs"):
            self.results = [self._encrypt(rng.uniform(-1, 1, (B, slots)), self.dec_level)
                            for _ in range(self.mix["inputs"])]
        self.i = 0
        self.sample = Reservoir(self.mix["sample_outputs"], np.random.default_rng([self.seed, 2]))
        self.rows = self.host_rows(self.mix["sample_outputs"])
        with self.phase("warm_up"):
            for k in range(2):
                self._request(k)

    def _decrypt_decode(self, ct) -> np.ndarray:
        from hehub_tpu_torch.models import ckks

        return ckks.decode(ckks.decrypt(self.ctx, ct, self.sk), self.params)

    def _request(self, k: int):
        ct = self._encrypt(self.plain[k], self.top)
        slots = self._decrypt_decode(self.results[k])
        return ct, slots, time.perf_counter()

    def step(self):
        k = self.i % len(self.plain)
        self.i += 1
        t0 = time.perf_counter()
        ct, slots, t1 = self._request(k)
        if answer(ct)[0].shape[0] != self.batch or slots.shape[0] != self.batch:
            self.bad_shapes += 1
        slot = self.sample.wants()
        if slot is not None:
            row = int(self.rng.integers(self.batch))
            self.sample.items[slot] = (k, row, *self.keep(self.rows[slot], ct, row), slots)
        sync(self.device)
        self.work.append(("codec", self.top))
        return self.batch, t1 - t0

    def judge(self) -> Dict[str, Check]:
        r = self.reference()
        want_dec = {}
        enc, gap, answers, missing = [], [], [], 0
        for k, row, c0, c1, scale, slots in self.sample.items:
            if c0 is None:
                enc.append(float("inf"))
                missing += 1
            else:
                c0, c1 = c0.to(self.device), c1.to(self.device)
                answers.append((c0, c1))
                enc.append(float(np.abs(r.decrypt_slots(c0, c1, scale) - self.plain[k][row]).max()))
            if k not in want_dec:
                want_dec[k] = r.decrypt_slots(*answer(self.results[k]))
            same = slots.shape == want_dec[k].shape
            gap.append(float(np.abs(slots - want_dec[k]).max()) if same else float("inf"))
        return {"encrypt_err": check(enc, self.limits["encrypt_err"], self.bad_shapes),
                "decode_gap": check(gap, self.limits["decode_gap"], self.bad_shapes),
                "residue_mismatch": self.residues(r, answers, missing)}


def _slots_t(coeffs: torch.Tensor, n: int, ref) -> np.ndarray:
    """The reference's slots_from_coeffs in the coefficients' precision, on
    their device."""
    cdt = torch.complex64 if coeffs.dtype == torch.float32 else torch.complex128
    j = torch.arange(n, device=coeffs.device)
    twist = torch.exp(1j * math.pi * j.to(torch.float64) / n).to(cdt)
    e = torch.from_numpy(ref.slot_exponents(n)).to(coeffs.device)
    return (n * torch.fft.ifft(coeffs.to(cdt) * twist, dim=-1))[..., (e - 1) // 2].cpu().numpy()


def control(cell: Cell, exact: bool = False) -> None:
    """The reference in the program's place for the whole codec (set-up's
    encryptions too): encode's FFT and rounding, and decode's FFT, in
    float32 for the configuration's float64 (or float64, exact);
    encryption and decryption exact."""
    r, ref, n = cell.reference(), cell.ref, cell.n
    dt = torch.float64 if exact else torch.float32
    cdt = torch.complex128 if exact else torch.complex64
    e = torch.from_numpy(ref.slot_exponents(n)).to(cell.device)
    j = torch.arange(n, device=cell.device, dtype=torch.float64)
    twist = torch.exp(-1j * math.pi * j / n).to(cdt)

    def encrypt(z: np.ndarray, level: int):
        vals = torch.zeros((z.shape[0], n), dtype=cdt, device=cell.device)
        zt = torch.from_numpy(z).to(cell.device).to(cdt)
        vals[:, (e - 1) // 2] = zt
        vals[:, (2 * n - e - 1) // 2] = zt.conj()
        coeffs = (torch.fft.fft(vals, dim=-1) / n * twist).real
        m = torch.round(coeffs.to(dt) * cell.scale).to(torch.int64)
        ids = list(range(level))
        q = r.ring.q(ids)
        mt = r.ring.ntt(r.ring.lift(m, ids), ids)
        c1 = r._uniform(cell.gen, (z.shape[0],), ids)
        c0 = (mt + r._noise(cell.gen, (z.shape[0],), ids) - r.ring.mulmod(c1, r.s[:level], q)) % q
        return c0, c1, cell.scale

    def decrypt_decode(ct) -> np.ndarray:
        c0, c1, scale = answer(ct)
        x = torch.from_numpy(r.decrypt_coeffs(c0, c1)).to(cell.device).to(dt) / scale
        return _slots_t(x, n, ref)

    cell._encrypt, cell._decrypt_decode = encrypt, decrypt_decode
