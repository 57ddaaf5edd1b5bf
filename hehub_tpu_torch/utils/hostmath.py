"""Host-side exact number theory in Python ints and numpy (port of the parts
of hehub_tpu/utils/hostmath.py that the CKKS main path needs): NTT-prime
generation, roots of unity, modular inverses and Shoup companions.
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
