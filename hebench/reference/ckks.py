"""Plain CKKS in PyTorch and NumPy: the benchmark's reference.

It judges what the program produced and, put in the program's place, is
the control. It imports nothing of the program: the primes, the NTT tables,
the codec's slot order and the keys are worked out here from the published
rules, which the configuration files name.

Conventions (those of HEhub and of the package under test, which the
reference has to read):
  * primes: the 30-bit primes q = 1 (mod 2n), from the largest down; the
    first `special` of them are the key-switching primes P, the next
    `chain` the ciphertext chain q_0, q_1, ...;
  * psi = g^((q-1)/2n) with g the smallest generator of Z_q^*; a polynomial
    in NTT form holds p(psi^(2 brv(j) + 1)) at position j (brv: bit
    reversal of log2 n bits); a ciphertext (c0, c1) is in NTT form, its
    residues in [0, 2q) (lazy), and decrypts as c0 + c1 s;
  * slot i of a plaintext p is p(zeta^(3^i mod 2n)), zeta = exp(i pi / n);
    rotating by `step` moves slot i to slot i + step.

Every modular product goes through `Ring.mulmod`. `float64_products=True`
rounds each product to float64 before it is reduced: 53 bits of a product
that needs 60, the precision below the configuration's exact 30-bit
residue arithmetic. That is the control.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

SIGMA = 3.2  # rounded normal noise, clamped to 6 sigma
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def ntt_primes(n: int, count: int, bits: int = 30) -> List[int]:
    """The `count` largest primes q < 2^bits with q = 1 (mod 2n)."""
    out, q = [], (1 << bits) - ((1 << bits) - 1) % (2 * n)
    while len(out) < count:
        if q < 1 << (bits - 1):
            raise ValueError(f"not enough {bits}-bit NTT primes for n={n}")
        if q < 1 << bits and is_prime(q):
            out.append(q)
        q -= 2 * n
    return out


def chain_and_special(n: int, chain: int, special: int, bits: int = 30):
    primes = ntt_primes(n, chain + special, bits)
    return primes[special:], primes[:special]


def _smallest_generator(q: int) -> int:
    phi, f, factors = q - 1, 2, []
    m = phi
    while f * f <= m:
        if m % f == 0:
            factors.append(f)
            while m % f == 0:
                m //= f
        f += 1
    if m > 1:
        factors.append(m)
    g = 2
    while any(pow(g, phi // p, q) == 1 for p in factors):
        g += 1
    return g


def _bitrev(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


def _powers(w: int, q: int, n: int) -> np.ndarray:
    """w^0 .. w^(n-1) mod q, by doubling blocks (numpy int64, exact)."""
    out = np.ones(n, np.int64)
    filled, step = 1, w
    while filled < n:
        take = min(filled, n - filled)
        out[filled:filled + take] = out[:take] * step % q
        filled += take
        step = step * step % q
    return out


class Ring:
    """Z_q[X]/(X^n + 1) for each prime of `moduli`, on `device`. Tensors are
    int64 [..., L, n] with L = len(limbs) rows of the limbs' moduli."""

    def __init__(self, n: int, moduli: Sequence[int], device, float64_products: bool = False):
        self.n = n
        self.moduli = [int(q) for q in moduli]
        self.device = torch.device(device)
        self.float64_products = float64_products
        brv = _bitrev(n)
        fwd, inv, n_inv = [], [], []
        for q in self.moduli:
            psi = pow(_smallest_generator(q), (q - 1) // (2 * n), q)
            fwd.append(_powers(psi, q, n)[brv])
            inv.append(_powers(pow(psi, -1, q), q, n)[brv])
            n_inv.append(pow(n, -1, q))
        as_t = lambda a: torch.tensor(np.array(a), dtype=torch.int64, device=self.device)  # noqa: E731
        self._q = as_t(self.moduli)
        self._fwd, self._inv, self._n_inv = as_t(fwd), as_t(inv), as_t(n_inv)

    def q(self, limbs: Sequence[int]) -> torch.Tensor:
        """[L, 1] moduli of `limbs`."""
        return self._q[list(limbs)][:, None]

    def mulmod(self, a: torch.Tensor, b, q: torch.Tensor) -> torch.Tensor:
        if self.float64_products:
            prod = torch.as_tensor(a).double() * torch.as_tensor(b).double()
            return torch.remainder(prod, q.double()).round().long() % q
        return a * b % q

    def ntt(self, x: torch.Tensor, limbs: Sequence[int]) -> torch.Tensor:
        """Natural-order coefficients [..., L, n] in [0, q) -> values in
        bit-reversed order (Cooley-Tukey), in [0, q)."""
        n, lead = self.n, x.shape[:-1]
        q = self.q(limbs)[..., None]
        tw = self._fwd[list(limbs)]
        for s in range(n.bit_length() - 1):
            m = 1 << s
            x = x.reshape(*lead, m, 2, n >> (s + 1))
            lo, hi = x[..., 0, :], x[..., 1, :]
            wh = self.mulmod(hi, tw[:, m:2 * m, None], q)
            x = torch.stack([(lo + wh) % q, (lo - wh) % q], dim=-2).reshape(*lead, n)
        return x

    def intt(self, x: torch.Tensor, limbs: Sequence[int]) -> torch.Tensor:
        """Bit-reversed values [..., L, n] -> natural-order coefficients in
        [0, q) (Gentleman-Sande, then n^-1)."""
        n, lead = self.n, x.shape[:-1]
        q = self.q(limbs)[..., None]
        tw = self._inv[list(limbs)]
        for s in range(n.bit_length() - 1):
            h = n >> (s + 1)
            x = x.reshape(*lead, h, 2, 1 << s)
            lo, hi = x[..., 0, :], x[..., 1, :]
            x = torch.stack([(lo + hi) % q, self.mulmod((lo - hi) % q, tw[:, h:2 * h, None], q)],
                            dim=-2).reshape(*lead, n)
        return self.mulmod(x, self._n_inv[list(limbs)][:, None], self.q(limbs))

    def lift(self, small: torch.Tensor, limbs: Sequence[int]) -> torch.Tensor:
        """Signed integers [..., n] -> residues [..., L, n] in [0, q)."""
        return small[..., None, :].to(torch.int64) % self.q(limbs)


# ---------------------------------------------------------------------------
# The codec: slots <-> real coefficients, in float64 (NumPy)
# ---------------------------------------------------------------------------


def slot_exponents(n: int) -> np.ndarray:
    """e_i = 3^i mod 2n, i < n/2: slot i is p(zeta^e_i)."""
    return _powers(3, 2 * n, n // 2)


def coeffs_from_slots(z: np.ndarray, n: int) -> np.ndarray:
    """Complex slots [..., n/2] -> real coefficients [..., n] of the
    polynomial that takes them (float64)."""
    e = slot_exponents(n)
    vals = np.zeros((*z.shape[:-1], n), np.complex128)
    vals[..., (e - 1) // 2] = z
    vals[..., (2 * n - e - 1) // 2] = np.conjugate(z)
    # vals_k = p(zeta^(2k+1)) = n ifft(c_j zeta^j)_k
    twist = np.exp(-1j * np.pi * np.arange(n) / n)
    return (np.fft.fft(vals, axis=-1) / n * twist).real


def slots_from_coeffs(c: np.ndarray, n: int) -> np.ndarray:
    """Real coefficients [..., n] -> complex slots [..., n/2]."""
    e = slot_exponents(n)
    twist = np.exp(1j * np.pi * np.arange(n) / n)
    return (n * np.fft.ifft(c * twist, axis=-1))[..., (e - 1) // 2]


def cycle_positions(n: int, step: int) -> np.ndarray:
    """Gather positions of the rotation by `step` on NTT values: out[j] =
    in[src[j]], from p'(X) = p(X^(t^-1)), t = 3^step."""
    brv = _bitrev(n)
    t_inv = pow(pow(3, step, 2 * n), -1, 2 * n)
    e = 2 * brv + 1
    return brv[((e * t_inv) % (2 * n) - 1) // 2]


# ---------------------------------------------------------------------------
# The scheme
# ---------------------------------------------------------------------------


class Ckks:
    """CKKS over `chain` + `special` primes at ring degree n with hybrid key
    switching (`alpha` chain limbs a digit), on `device`. `sk` is the
    ternary secret's coefficients [n] (any integer dtype), the one the
    benchmark hands to the program too. Limb index j < len(chain) is q_j;
    the special primes follow."""

    def __init__(self, n: int, chain: Sequence[int], special: Sequence[int], alpha: int,
                 sk: torch.Tensor, device, float64_products: bool = False):
        self.n, self.alpha = n, alpha
        self.chain, self.special = list(chain), list(special)
        self.ring = Ring(n, self.chain + self.special, device, float64_products)
        self.device = self.ring.device
        self.sp = list(range(len(self.chain), len(self.chain) + len(self.special)))
        self.all = list(range(len(self.chain))) + self.sp
        self.s = self.ring.ntt(self.ring.lift(sk.to(self.device), self.all), self.all)

    # -- decryption -------------------------------------------------------

    def _decrypted(self, c0: torch.Tensor, c1: torch.Tensor, k: int) -> torch.Tensor:
        """The natural-order coefficients [..., k, n] in [0, q) of c0 + c1 s
        over the first k chain limbs."""
        r, ids = self.ring, list(range(k))
        q = r.q(ids)
        pt = (c0[..., :k, :] % q + r.mulmod(c1[..., :k, :] % q, self.s[:k], q)) % q
        return r.intt(pt, ids)

    def _garner(self, x: torch.Tensor) -> torch.Tensor:
        """The centred integer (int64) that limbs 0 and 1 of x give (limb 0
        alone where x has one), exact below 2^62."""
        q0 = self.chain[0]
        value, Q = x[..., 0, :], q0
        if x.shape[-2] > 1:
            q1 = self.chain[1]
            t = (x[..., 1, :] - value) % q1 * pow(q0, -1, q1) % q1
            value, Q = value + q0 * t, q0 * q1
        return torch.where(value > Q // 2, value - Q, value)

    def decrypt_coeffs(self, c0: torch.Tensor, c1: torch.Tensor, limbs: int = 2) -> np.ndarray:
        """The centred coefficients [..., n] (float64) of c0 + c1 s over the
        first `limbs` (at most 2) chain primes (Garner)."""
        x = self._decrypted(c0, c1, min(limbs, 2, c0.shape[-2]))
        return self._garner(x).cpu().numpy().astype(np.float64)

    def residue_mismatches(self, c0: torch.Tensor, c1: torch.Tensor) -> int:
        """How many residues of c0 + c1 s on limbs 2 .. l-1 differ from the
        integer that limbs 0 and 1 give: 0 where every limb decrypts to the
        one small integer a sound ciphertext holds."""
        k = c0.shape[-2]
        if k <= 2:
            return 0
        x = self._decrypted(c0, c1, k)
        value = self._garner(x)[..., None, :]
        return int((x[..., 2:, :] != value % self.ring.q(list(range(2, k)))).sum())

    def decrypt_slots(self, c0, c1, scale: float, limbs: int = 2) -> np.ndarray:
        return slots_from_coeffs(self.decrypt_coeffs(c0, c1, limbs) / scale, self.n)

    # -- encryption and keys (the reference in the program's place) ------

    def _uniform(self, gen, shape, limbs) -> torch.Tensor:
        q = self.ring.q(limbs)
        u = torch.randint(0, 1 << 62, (*shape, len(limbs), self.n), generator=gen,
                          device=self.device)
        return u % q

    def _noise(self, gen, shape, limbs) -> torch.Tensor:
        e = torch.randn((*shape, self.n), generator=gen, device=self.device, dtype=torch.float64)
        e = torch.clamp(torch.round(e * SIGMA), -6 * SIGMA, 6 * SIGMA).to(torch.int64)
        return self.ring.ntt(self.ring.lift(e, limbs), limbs)

    def encrypt(self, z: np.ndarray, level: int, scale: float, gen) -> Tuple[torch.Tensor, ...]:
        """Slots [B, <= n/2] -> (c0, c1) [B, level, n] at `scale`."""
        r, ids = self.ring, list(range(level))
        slots = np.zeros((z.shape[0], self.n // 2), np.complex128)
        slots[:, :z.shape[-1]] = z
        m = torch.from_numpy(np.rint(coeffs_from_slots(slots, self.n) * scale).astype(np.int64))
        m = r.ntt(r.lift(m.to(self.device), ids), ids)
        q = r.q(ids)
        c1 = self._uniform(gen, (z.shape[0],), ids)
        c0 = (m + self._noise(gen, (z.shape[0],), ids) - r.mulmod(c1, self.s[:level], q)) % q
        return c0, c1

    def _groups(self, level: int) -> List[List[int]]:
        return [list(range(g, min(g + self.alpha, level))) for g in range(0, level, self.alpha)]

    def switch_key(self, src: torch.Tensor, gen) -> Tuple[torch.Tensor, torch.Tensor]:
        """Key from s' (NTT values over every limb, [M, n]) to s: rows g of
        (b, a), b = -a s + e + B_g s', B_g = P mod the primes of digit group
        g and 0 elsewhere."""
        r, ids = self.ring, self.all
        q = r.q(ids)
        P = math.prod(self.special)
        groups = self._groups(len(self.chain))
        basis = torch.zeros(len(groups), len(ids), 1, dtype=torch.int64, device=self.device)
        for g, grp in enumerate(groups):
            for j in grp:
                basis[g, j, 0] = P % self.chain[j]
        a = self._uniform(gen, (len(groups),), ids)
        b = (self._noise(gen, (len(groups),), ids) - r.mulmod(a, self.s, q)
             + r.mulmod(basis.expand(-1, -1, self.n), src, q)) % q
        return b, a

    def relin_key(self, gen):
        return self.switch_key(self.ring.mulmod(self.s, self.s, self.ring.q(self.all)), gen)

    def rot_key(self, step: int, gen):
        src = torch.from_numpy(cycle_positions(self.n, step)).to(self.device)
        return self.switch_key(self.s[:, src], gen)

    def _div_last(self, x: torch.Tensor, limbs: List[int]) -> torch.Tensor:
        """x / q_last, rounded, NTT values over `limbs` -> over limbs[:-1]."""
        r = self.ring
        last, rest = limbs[-1:], limbs[:-1]
        ql = self.ring.moduli[last[0]]
        t = r.intt(x[..., -1:, :] % r.q(last), last)[..., 0, :]
        t = torch.where(t > ql // 2, t - ql, t)
        q = r.q(rest)
        inv = torch.tensor([pow(ql, -1, r.moduli[j]) for j in rest], dtype=torch.int64,
                           device=self.device)[:, None]
        diff = (x[..., :-1, :] - r.ntt(r.lift(t, rest), rest)) % q
        return r.mulmod(diff, inv, q)

    def key_switch(self, d: torch.Tensor, key, level: int):
        """d (NTT values [B, level, n]) under the key's source -> (k0, k1)
        [B, level, n] under s: digits by base conversion of each group,
        inner product over the chain limbs and the special primes, then the
        division by each special prime."""
        r = self.ring
        ext = list(range(level)) + self.sp
        q_ext = r.q(ext)
        coeffs = r.intt(d % r.q(list(range(level))), list(range(level)))
        b, a = key
        kb, ka = b[:, ext], a[:, ext]
        acc0 = acc1 = 0
        for g, grp in enumerate(self._groups(level)):
            Qg = math.prod(self.chain[j] for j in grp)
            digit = 0
            for j in grp:
                qj = self.chain[j]
                hat = Qg // qj
                y = r.mulmod(coeffs[:, j:j + 1, :], pow(hat, -1, qj), r.q([j]))  # [B, 1, n]
                y = torch.where(y > qj // 2, y - qj, y)  # balanced digits: less noise
                hat_ext = torch.tensor([hat % m for m in r.q(ext)[:, 0].tolist()],
                                       dtype=torch.int64, device=self.device)[:, None]
                digit = (digit + r.mulmod(y, hat_ext, q_ext)) % q_ext
            digit = r.ntt(digit, ext)
            acc0 = (acc0 + r.mulmod(digit, kb[g], q_ext)) % q_ext
            acc1 = (acc1 + r.mulmod(digit, ka[g], q_ext)) % q_ext
        for _ in self.sp:
            acc0, acc1 = self._div_last(acc0, ext), self._div_last(acc1, ext)
            ext = ext[:-1]
        return acc0, acc1

    def rescale(self, c0, c1):
        ids = list(range(c0.shape[-2]))
        return self._div_last(c0, ids), self._div_last(c1, ids)

    def mult(self, x, y, rlk):
        """Tensor product, relinearisation and rescale of (c0, c1) pairs."""
        level = x[0].shape[-2]
        q = self.ring.q(list(range(level)))
        x0, x1, y0, y1 = (t % q for t in (*x, *y))
        mm = self.ring.mulmod
        d0, d1, d2 = mm(x0, y0, q), (mm(x0, y1, q) + mm(x1, y0, q)) % q, mm(x1, y1, q)
        k0, k1 = self.key_switch(d2, rlk, level)
        return self.rescale((d0 + k0) % q, (d1 + k1) % q)

    def rotate(self, x, rk, step: int):
        level = x[0].shape[-2]
        q = self.ring.q(list(range(level)))
        src = torch.from_numpy(cycle_positions(self.n, step)).to(self.device)
        r0, r1 = x[0][..., src] % q, x[1][..., src] % q
        k0, k1 = self.key_switch(r1, rk, level)
        return (r0 + k0) % q, k1

