"""Host-side exact number theory in Python ints and numpy (port of
hehub_tpu/utils/hostmath.py): NTT-prime generation, factorization, roots of
unity, modular inverses and Shoup companions, the 64-bit host mulmod and
NTT of big plaintext moduli, and exact CRT helpers.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np

_MR_BASES_64 = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin, exact for all n < 2^64."""
    if n < 2:
        return False
    for p in _MR_BASES_64:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES_64:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


@functools.lru_cache(maxsize=None)
def gen_ntt_primes(bits: int, count: int, n: int) -> Tuple[int, ...]:
    """`count` distinct primes q ≡ 1 (mod 2n) with 2^(bits-1) <= q < 2^bits,
    searching downward from 2^bits."""
    if bits > 31:
        raise ValueError(f"limbs are uint32; moduli must be < 2^31 (got {bits} bits)")
    step = 2 * n
    primes: List[int] = []
    q = (1 << bits) - ((1 << bits) - 1) % step
    lo = 1 << (bits - 1)
    while len(primes) < count and q > lo:
        if is_prime(q):
            primes.append(q)
        q -= step
    if len(primes) < count:
        raise ValueError(f"not enough {bits}-bit NTT primes for n={n}")
    return tuple(primes)


def _pollard_rho(n: int) -> int:
    """A nontrivial factor of composite n (Brent's variant)."""
    if n % 2 == 0:
        return 2
    import math
    import random

    rnd = random.Random(0xC0FFEE ^ n)
    while True:
        y, c, m = rnd.randrange(1, n), rnd.randrange(1, n), 128
        g, r, q = 1, 1, 1
        while g == 1:
            x = y
            for _ in range(r):
                y = (y * y + c) % n
            k = 0
            while k < r and g == 1:
                ys = y
                for _ in range(min(m, r - k)):
                    y = (y * y + c) % n
                    q = q * abs(x - y) % n
                g = math.gcd(q, n)
                k += m
            r <<= 1
        if g == n:
            g = 1
            while g == 1:
                ys = (ys * ys + c) % n
                g = math.gcd(abs(x - ys), n)
        if g != n:
            return g


@functools.lru_cache(maxsize=None)
def factorize(n: int) -> Tuple[Tuple[int, int], ...]:
    """Prime factorization of n as sorted ((p, e), ...) pairs. Exact for any
    64-bit n (trial division for small factors, Pollard rho beyond)."""
    if n < 2:
        return ()
    factors = {}
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47):
        while n % p == 0:
            factors[p] = factors.get(p, 0) + 1
            n //= p
    stack = [n] if n > 1 else []
    while stack:
        m = stack.pop()
        if m == 1:
            continue
        if is_prime(m):
            factors[m] = factors.get(m, 0) + 1
            continue
        d = _pollard_rho(m)
        stack += [d, m // d]
    return tuple(sorted(factors.items()))


def coprime_factors(n: int) -> Tuple[int, ...]:
    """n as a product of pairwise-coprime prime powers p^e (CRT basis)."""
    return tuple(p**e for p, e in factorize(n))


# mulmod_u64's Barrett quotient needs >= 64-bit mantissas: with 80-bit
# extended longdouble (x86) the quotient error stays within the +-3t folds
# below; where longdouble == float64 (aarch64, MSVC) the error for t near
# 2^62 reaches ~2^10 and would silently corrupt every big-t BGV path, so
# fall back to an exact 32-bit-split path there.
_LONGDOUBLE_OK = np.finfo(np.longdouble).nmant >= 63


def mulmod_u64(a, b, t: int):
    """Vectorized (a * b) mod t for uint64 numpy arrays with a, b, t < 2^62.

    Barrett via 80-bit longdouble: q ≈ floor(a·b/t) with error <= ~2, then
    the remainder is recovered exactly in wrapping uint64 arithmetic and
    corrected. Used only on host paths (big plaintext moduli). Platforms
    without extended-precision longdouble use an exact split-multiply
    fallback (see _LONGDOUBLE_OK)."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    tt = np.uint64(t)
    if not _LONGDOUBLE_OK:
        return _mulmod_u64_split(a, b, t)
    q = (a.astype(np.longdouble) * b.astype(np.longdouble) / np.longdouble(t))
    q = q.astype(np.uint64)  # trunc; off by at most ~2 either way
    with np.errstate(over="ignore"):
        r = a * b - q * tt  # exact mod 2^64; true r in (-3t, 3t)
    # fold the (-3t, 0) wraparound branch and the (t, 3t) branch back
    for _ in range(3):
        r = np.where(r >= np.uint64(1) << np.uint64(63), r + tt, r)
    for _ in range(3):
        r = np.where(r >= tt, r - tt, r)
    return r


def _mulmod_u64_split(a, b, t: int):
    """Exact (a * b) mod t with no float involved, for hosts whose
    longdouble is only 53-bit (aarch64, MSVC): Python-int arithmetic on
    object arrays — slow but exact, and only ever taken on such hosts."""
    res = (np.asarray(a, np.uint64).astype(object)
           * np.asarray(b, np.uint64).astype(object)) % int(t)
    return res.astype(np.uint64)


def ntt_host_u64(values, t: int, n: int, inverse: bool = False):
    """Negacyclic NTT/INTT mod a big prime t (t ≡ 1 mod 2n, t < 2^62) on the
    host, matching the device kernels' no-bitrev value order (ops/ntt.py):
    forward DIT emits bit-reversed order, inverse DIF consumes it.

    Role of the reference's u64/u128 NTT for large plain moduli
    (ntt.cpp:145-222 supports primes <= 59 bits); vectorized numpy with
    longdouble-Barrett mulmods, used for SIMD packing when t exceeds the
    30-bit device lanes."""
    x = np.ascontiguousarray(np.asarray(values, np.uint64)).copy()
    logn = n.bit_length() - 1
    psi = negacyclic_psi(t, n)
    if inverse:
        psi = modinv(psi, t)
    # twiddle table in bit-reversed-power layout (≙ context._psi_power_table)
    powers = np.empty(n, dtype=np.uint64)
    acc = 1
    for j in range(n):
        powers[j] = acc
        acc = acc * psi % t
    rev = np.zeros(n, np.int64)
    idx = np.arange(n)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    tw = powers[rev]
    lead = x.shape[:-1]
    if not inverse:
        for s in range(logn):
            m = 1 << s
            gap = n >> (s + 1)
            y = x.reshape(*lead, m, 2, gap)
            lo, hi = y[..., 0, :].copy(), y[..., 1, :]
            w = tw[m : 2 * m][:, None]
            wh = mulmod_u64(hi, np.broadcast_to(w, hi.shape), t)
            y[..., 0, :] = (lo + wh) % np.uint64(t)
            y[..., 1, :] = (lo + np.uint64(t) - wh) % np.uint64(t)
            x = y.reshape(*lead, n)
    else:
        for s in range(logn):
            h = n >> (s + 1)
            y = x.reshape(*lead, h, 2, 1 << s)
            lo, hi = y[..., 0, :].copy(), y[..., 1, :].copy()
            y[..., 0, :] = (lo + hi) % np.uint64(t)
            w = tw[h : 2 * h][:, None]
            y[..., 1, :] = mulmod_u64(
                (lo + np.uint64(t) - hi) % np.uint64(t),
                np.broadcast_to(w, hi.shape), t,
            )
            x = y.reshape(*lead, n)
        n_inv = modinv(n, t)
        x = mulmod_u64(x, np.broadcast_to(np.uint64(n_inv), x.shape), t)
    return x


def _factorize(n: int) -> List[int]:
    fs = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fs.append(n)
    return fs


@functools.lru_cache(maxsize=None)
def primitive_root(q: int) -> int:
    """Smallest generator of Z_q^* (q prime)."""
    phi = q - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
        g += 1


@functools.lru_cache(maxsize=None)
def root_of_unity(q: int, order: int) -> int:
    """A primitive `order`-th root of unity mod prime q (order | q-1)."""
    if (q - 1) % order != 0:
        raise ValueError(f"{order} does not divide {q}-1")
    w = pow(primitive_root(q), (q - 1) // order, q)
    if pow(w, order, q) != 1 or pow(w, order // 2, q) == 1:
        raise ArithmeticError(f"no primitive {order}-th root of unity mod {q}")
    return w


def negacyclic_psi(q: int, n: int) -> int:
    """Primitive 2n-th root ψ mod q with ψ^n ≡ -1 (mod q)."""
    psi = root_of_unity(q, 2 * n)
    if pow(psi, n, q) != q - 1:
        raise ArithmeticError(f"{psi} is not a negacyclic root mod {q}")
    return psi


def modinv(x: int, q: int) -> int:
    return pow(x, -1, q)


def shoup(w: int, q: int) -> int:
    """Shoup companion floor(w * 2^32 / q) for a constant w < q < 2^31."""
    if not 0 <= w < q:
        raise ValueError(f"shoup constant must be strictly reduced: {w} vs {q}")
    return (w << 32) // q


def shoup_pair_arrays(ws: Sequence[int], qs: Sequence[int]):
    """(w, w_shoup) as int64 numpy arrays for per-limb constants."""
    ws = [int(w) % int(q) for w, q in zip(ws, qs)]
    sh = [shoup(w, q) for w, q in zip(ws, qs)]
    return np.asarray(ws, dtype=np.int64), np.asarray(sh, dtype=np.int64)


def crt_compose(residues: Sequence[Sequence[int]], moduli: Sequence[int]) -> List[int]:
    """Exact CRT composition: residues[k][i] mod moduli[k] -> integers in [0, Q).

    Host oracle of the exact compose paths and of the tests.
    """
    Q = 1
    for m in moduli:
        Q *= int(m)
    punctured = [Q // int(m) for m in moduli]
    garners = [modinv(p % int(m), int(m)) for p, m in zip(punctured, moduli)]
    n = len(residues[0])
    out = []
    for i in range(n):
        acc = 0
        for k, m in enumerate(moduli):
            acc += int(residues[k][i]) * garners[k] % int(m) * punctured[k]
        out.append(acc % Q)
    return out


def to_signed(x: int, Q: int) -> int:
    """Map [0, Q) to the centered representative in [-Q/2, Q/2)."""
    return x - Q if x >= (Q + 1) // 2 else x


def decompose_rns(values: Sequence[int], moduli: Sequence[int]) -> np.ndarray:
    """Integers -> RNS residue matrix [L, n] (uint32). Negative values allowed."""
    out = np.empty((len(moduli), len(values)), dtype=np.uint32)
    for k, m in enumerate(moduli):
        out[k] = np.asarray([int(v) % int(m) for v in values], dtype=np.uint32)
    return out
