"""Plain CKKS bootstrapping in PyTorch and NumPy: the reference of the boot
cells (scheme "ckks_boot").

It builds on the plain CKKS of `ckks.py` (primes, NTT, codec, keys, key
switching, decryption) and imports nothing of the program. It adds what a
refresh needs: a sparse ternary secret of stated weight, the two keys of
sparse-secret encapsulation (SSE), conjugation, plaintext products, and the
refresh itself, worked out here from the published method:

  1. SSE in: the exhausted ciphertext (one limb, q0) switched from the
     secret s to the ephemeral secret s' by a key over q0 and the special
     primes only;
  2. ModRaise: its coefficients, centred mod q0, read over every chain
     prime, so it decrypts under s' to t = m + q0 I with |I| small (the
     weight of s'); times 2^RAISE_BITS (exact), so that the key switches
     after it meet the message well above their noise; then SSE out:
     switched back to s over every limb;
  3. CoeffToSlot: the slots of t/q0 mapped to two ciphertexts whose real
     slots are the coefficients t_j/q0 (j < n/2) and t_(j+n/2)/q0, by the
     diagonal method (baby steps, giant steps) on the dense matrices of
     this module's own codec;
  4. EvalMod on each: sin(2 pi u)/(2 pi) on [-K-1/2, K+1/2] as a Chebyshev
     interpolant of the stated degree (numpy's chebinterpolate), every
     T_k by T_2k = 2 T_k^2 - 1 and T_2k+1 = 2 T_k T_k+1 - T_1, then the
     arcsine cubic w + (2 pi)^2/6 w^3;
  5. SlotToCoeff: the slots z' = W_lo r + W_hi im, the diagonal method
     again, read at the scale that gives the input's message.

Scales are tracked exactly as floats; a ciphertext-ciphertext product drops
the two top limbs (the two-limb working scale), a constant or diagonal
product is encoded at the scale that lands its rescaled result where it is
wanted. The dense transforms take s^2 complex entries and about 2 sqrt(s)
rotation keys: for small rings (the tests and the control at a tiny ring).
`float64_products=True` rounds every modular product to float64, as in
ckks.py: the control.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .ckks import Ckks, _bitrev, chain_and_special, coeffs_from_slots, slots_from_coeffs

__all__ = ["CkksBoot", "chain_and_special", "conjugate_positions", "sparse_ternary"]

Ct = Tuple[torch.Tensor, torch.Tensor]


def sparse_ternary(n: int, weight: int, rng: np.random.Generator) -> np.ndarray:
    """A ternary secret [n] (int8) with exactly `weight` coefficients +-1 at
    uniform positions, uniform signs."""
    out = np.zeros(n, np.int8)
    pos = rng.choice(n, size=weight, replace=False)
    out[pos] = rng.integers(0, 2, size=weight) * 2 - 1
    return out


def conjugate_positions(n: int) -> np.ndarray:
    """Gather positions of the conjugation X -> X^(2n-1) on NTT values:
    out[j] = in[src[j]]."""
    brv = _bitrev(n)
    e = 2 * brv + 1
    return brv[((e * (2 * n - 1)) % (2 * n) - 1) // 2]


# the raised ciphertext's integer factor: its message then sits at
# 2^RAISE_BITS times the input's scale, above the key switches' noise
RAISE_BITS = 16


def _bsgs(s: int) -> int:
    return 1 << ((s.bit_length() - 1) // 2)


class CkksBoot(Ckks):
    """Ckks with the secret `sk` (any weight) and the ephemeral secret `eph`
    of sparse-secret encapsulation, both coefficients [n]."""

    def __init__(self, n: int, chain: Sequence[int], special: Sequence[int], alpha: int,
                 sk: torch.Tensor, eph: torch.Tensor, device, float64_products: bool = False):
        super().__init__(n, chain, special, alpha, sk, device, float64_products)
        self.s_eph = self.ring.ntt(self.ring.lift(eph.to(self.device), self.all), self.all)
        self.slots = n // 2
        self.q0 = self.chain[0]

    # -- keys -------------------------------------------------------------

    def _key(self, src: torch.Tensor, under: torch.Tensor, gen, limbs: List[int]):
        """Key from the secret with NTT values `src` to the one with `under`
        ([M, n] over every limb), made over `limbs` (chain limbs, then the
        special primes) and zero at every other limb: rows g of (b, a),
        b = -a under + e + B_g src."""
        r = self.ring
        chain = [j for j in limbs if j < len(self.chain)]
        groups = [chain[g:g + self.alpha] for g in range(0, len(chain), self.alpha)]
        P = math.prod(self.special)
        q = r.q(limbs)
        basis = torch.zeros(len(groups), len(limbs), 1, dtype=torch.int64, device=self.device)
        for g, grp in enumerate(groups):
            for j in grp:
                basis[g, limbs.index(j), 0] = P % self.chain[j]
        a = self._uniform(gen, (len(groups),), limbs)
        b = (self._noise(gen, (len(groups),), limbs) - r.mulmod(a, under[limbs], q)
             + r.mulmod(basis.expand(-1, -1, self.n), src[limbs], q)) % q
        at = torch.tensor(limbs, device=self.device)
        full = lambda x: torch.zeros((len(groups), len(self.all), self.n), dtype=torch.int64,  # noqa: E731
                                     device=self.device).index_copy_(1, at, x)
        return full(b), full(a)

    def conj_key(self, gen):
        src = torch.from_numpy(conjugate_positions(self.n)).to(self.device)
        return self.switch_key(self.s[:, src], gen)

    def sse_keys(self, gen):
        """(s -> s' over q0 and the special primes only, s' -> s over every
        limb)."""
        return (self._key(self.s, self.s_eph, gen, [0] + self.sp),
                self._key(self.s_eph, self.s, gen, self.all))

    def boot_keys(self, gen, steps: Sequence[int]):
        """Every key a refresh needs: relinearisation, conjugation, a
        rotation key a step of `steps`, and the two SSE keys."""
        return dict(rlk=self.relin_key(gen), conj=self.conj_key(gen),
                    rot={st: self.rot_key(st, gen) for st in steps}, sse=self.sse_keys(gen))

    # -- ciphertext arithmetic (c0, c1) over the first l chain limbs -------

    def _q(self, x: Ct) -> torch.Tensor:
        return self.ring.q(list(range(x[0].shape[-2])))

    def add(self, x: Ct, y: Ct) -> Ct:
        q = self._q(x)
        return (x[0] + y[0]) % q, (x[1] + y[1]) % q

    def sub(self, x: Ct, y: Ct) -> Ct:
        q = self._q(x)
        return (x[0] - y[0]) % q, (x[1] - y[1]) % q

    def drop(self, x: Ct, level: int) -> Ct:
        """Limbs past `level` dropped (no division: the value stays)."""
        return x[0][..., :level, :], x[1][..., :level, :]

    def switch(self, x: Ct, key) -> Ct:
        """The ciphertext under the key's target secret."""
        level, q = x[0].shape[-2], self._q(x)
        k0, k1 = self.key_switch(x[1] % q, key, level)
        return (x[0] + k0) % q, k1

    def conjugate(self, x: Ct, ck) -> Ct:
        src = torch.from_numpy(conjugate_positions(self.n)).to(self.device)
        level, q = x[0].shape[-2], self._q(x)
        k0, k1 = self.key_switch(x[1][..., src] % q, ck, level)
        return (x[0][..., src] + k0) % q, k1

    def rot(self, x: Ct, rks, step: int) -> Ct:
        step %= self.slots
        return x if step == 0 else self.rotate(x, rks[step], step)

    def encode(self, z, scale: float, level: int) -> torch.Tensor:
        """Slots [n/2] (or one value in every slot) at `scale` -> NTT values
        [level, n]."""
        z = np.broadcast_to(np.asarray(z, np.complex128), (self.slots,))
        c = np.rint(coeffs_from_slots(z, self.n) * scale)
        if np.abs(c).max() >= 2.0**62:
            raise ValueError("an encoded coefficient passes 2^62")
        ids = list(range(level))
        m = torch.from_numpy(c.astype(np.int64)).to(self.device)
        return self.ring.ntt(self.ring.lift(m, ids), ids)

    def mult_plain(self, x: Ct, pt: torch.Tensor) -> Ct:
        q = self._q(x)
        return self.ring.mulmod(x[0] % q, pt, q), self.ring.mulmod(x[1] % q, pt, q)

    def rescale_by(self, x: Ct, k: int) -> Ct:
        for _ in range(k):
            x = self.rescale(*x)
        return x

    def _landing(self, level: int, drops: int) -> float:
        """The product of the `drops` top limbs at `level`."""
        return float(math.prod(self.chain[level - drops:level]))

    def times_const(self, x: Ct, scale: float, value: float, target: float) -> Ct:
        """x (at `scale`) times a constant, landing at scale `target` after
        dropping two limbs."""
        level = x[0].shape[-2]
        pt = self.encode(value, target * self._landing(level, 2) / scale, level)
        return self.rescale_by(self.mult_plain(x, pt), 2)

    def product(self, x: Ct, y: Ct, rlk) -> Ct:
        """Tensor product and relinearisation at the lower level, no
        rescale."""
        level = min(x[0].shape[-2], y[0].shape[-2])
        x, y = self.drop(x, level), self.drop(y, level)
        q = self._q(x)
        mm = self.ring.mulmod
        x0, x1, y0, y1 = (t % q for t in (*x, *y))
        d0, d1, d2 = mm(x0, y0, q), (mm(x0, y1, q) + mm(x1, y0, q)) % q, mm(x1, y1, q)
        k0, k1 = self.key_switch(d2, rlk, level)
        return (d0 + k0) % q, (d1 + k1) % q

    # -- the refresh -----------------------------------------------------

    def transform_matrices(self):
        """(E, F, G, H, W_lo, W_hi) of this module's codec: slots z = W t =
        W_lo t_lo + W_hi t_hi for real coefficients t, and t_lo = E z + F
        conj(z), t_hi = G z + H conj(z)."""
        s, n = self.slots, self.n
        W = slots_from_coeffs(np.eye(n), self.n).T  # [s, n]: column j the slots of X^j
        Minv = np.linalg.inv(np.vstack([W, np.conj(W)]))
        return Minv[:s, :s], Minv[:s, s:], Minv[s:, :s], Minv[s:, s:], W[:, :s], W[:, s:]

    def rotation_steps(self) -> List[int]:
        """The steps (mod n/2) the diagonal method's baby and giant
        rotations take."""
        s = self.slots
        B = _bsgs(s)
        return sorted({(-b) % s for b in range(1, B)} | {(-g * B) % s for g in range(1, s // B)})

    def linear(self, pairs, scale: float, target: float, rks) -> Ct:
        """Sum over (M, x) of M applied to the slots of x (all at `scale`,
        one level), by baby steps and giant steps over M's wrapped
        diagonals, landing at `target` after dropping one limb."""
        s, B = self.slots, _bsgs(self.slots)
        level = pairs[0][1][0].shape[-2]
        pt_scale = target * self._landing(level, 1) / scale
        idx = np.arange(s)
        babies = [{b: self.rot(x, rks, -b) for b in range(B)} for _, x in pairs]
        acc = None
        for g in range(s // B):
            inner = None
            for (M, _), rotated in zip(pairs, babies):
                for b in range(B):
                    diag = np.roll(M[idx, (idx + g * B + b) % s], g * B)
                    if not np.any(diag):
                        continue
                    term = self.mult_plain(rotated[b], self.encode(diag, pt_scale, level))
                    inner = term if inner is None else self.add(inner, term)
            if inner is not None:
                inner = self.rot(inner, rks, -g * B)
                acc = inner if acc is None else self.add(acc, inner)
        return self.rescale_by(acc, 1)

    def chebyshev(self, x: Ct, scale: float, coeffs: np.ndarray, half_width: float,
                  target: float, rlk) -> Ct:
        """sum c_k T_k(u / half_width) of the slots u of x, landing at
        `target`."""
        delta = target
        y = self.times_const(x, scale, 1.0 / half_width, delta)
        T = {1: (y, delta)}

        def build(k):
            if k in T:
                return T[k]
            i, j = (k + 1) // 2, k // 2
            (a, sa), (b, sb) = build(i), build(j)
            prod = self.product(a, b, rlk)
            prod = self.add(prod, prod)
            if i == j:  # 2 T_i^2 - 1, the constant after the rescale
                level = prod[0].shape[-2]
                sc = sa * sb / self._landing(level, 2)
                out = self.rescale_by(prod, 2)
                out = ((out[0] - self.encode(1.0, sc, level - 2)) % self._q(out), out[1])
            else:  # 2 T_i T_j - T_1, T_1 brought to the product's scale
                level = prod[0].shape[-2]
                t1, s1 = T[1]
                lift = self.mult_plain(self.drop(t1, level),
                                       self.encode(1.0, sa * sb / s1, level))
                sc = sa * sb / self._landing(level, 2)
                out = self.rescale_by(self.sub(prod, lift), 2)
            T[k] = (out, sc)
            return T[k]

        terms = [k for k in range(1, len(coeffs)) if coeffs[k] != 0.0]
        for k in terms:
            build(k)
        level = min(T[k][0][0].shape[-2] for k in terms)
        acc = None
        for k in terms:
            t, sc = T[k]
            pt = self.encode(coeffs[k], delta * self._landing(level, 2) / sc, level)
            term = self.mult_plain(self.drop(t, level), pt)
            acc = term if acc is None else self.add(acc, term)
        out = self.rescale_by(acc, 2)
        const = self.encode(coeffs[0], delta, level - 2)
        return (out[0] + const) % self._q(out), out[1]

    def eval_mod(self, x: Ct, scale: float, k_bound: int, degree: int, rlk,
                 delta: float) -> Tuple[Ct, float]:
        """u -> u mod 1 for u = m/q0 + I, |I| <= k_bound: the sine
        interpolant and the arcsine cubic; lands at `delta`."""
        r = k_bound + 0.5
        coeffs = np.polynomial.chebyshev.chebinterpolate(
            lambda y: np.sin(2 * np.pi * r * y) / (2 * np.pi), degree)
        coeffs = np.where(np.abs(coeffs) > 1e-14 * np.abs(coeffs).max(), coeffs, 0.0)
        w = self.chebyshev(x, scale, coeffs, r, delta, rlk)
        # w + a3 w^3 = w (1 + a3 w^2), a3 w^2 read from w^2 at scale / a3
        sq = self.product(w, w, rlk)
        level = sq[0].shape[-2]
        g_scale = delta * delta / self._landing(level, 2) / ((2 * np.pi) ** 2 / 6.0)
        g = self.rescale_by(sq, 2)
        g = ((g[0] + self.encode(1.0, g_scale, level - 2)) % self._q(g), g[1])
        out = self.product(w, g, rlk)
        out_scale = delta * g_scale / self._landing(out[0].shape[-2], 2)
        return self.rescale_by(out, 2), out_scale

    def refresh(self, x: Ct, scale_in: float, keys, k_bound: int, degree: int,
                delta: float) -> Tuple[torch.Tensor, torch.Tensor, float]:
        """The refresh of (c0, c1) at one limb and scale `scale_in`: (c0, c1,
        scale) over the limbs left, reading the same slots."""
        to_eph, from_eph = keys["sse"]
        x = self.switch(x, to_eph)
        r, ids = self.ring, list(range(len(self.chain)))
        q0 = self.q0
        raised = []
        for c in x:
            t = r.intt(c[..., :1, :] % r.q([0]), [0])[..., 0, :]
            t = torch.where(t > q0 // 2, t - q0, t) << RAISE_BITS
            raised.append(r.ntt(r.lift(t, ids), ids))
        x = self.switch(tuple(raised), from_eph)
        scale = float(q0) * 2.0**RAISE_BITS
        E, F, G, H, W_lo, W_hi = self.transform_matrices()
        xc = self.conjugate(x, keys["conj"])
        re = self.linear([(E, x), (F, xc)], scale, delta, keys["rot"])
        im = self.linear([(G, x), (H, xc)], scale, delta, keys["rot"])
        w_re, s_re = self.eval_mod(re, delta, k_bound, degree, keys["rlk"], delta)
        w_im, s_im = self.eval_mod(im, delta, k_bound, degree, keys["rlk"], delta)
        level = min(w_re[0].shape[-2], w_im[0].shape[-2])
        out = self.add(self.linear([(W_lo, self.drop(w_re, level))], s_re, delta, keys["rot"]),
                       self.linear([(W_hi, self.drop(w_im, level))], s_im, delta, keys["rot"]))
        return out[0], out[1], delta * scale_in / q0
