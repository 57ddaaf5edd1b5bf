"""The least time of one CKKS refresh on the card, from the configuration's
shapes alone, at the peaks and work counts of hebench/bounds.py, so that it
reads the same whatever implements the refresh.

A refresh at ring n, L chain primes, K special primes, digits of `alpha`
limbs, transforms in `lt_stages` factored stages, `refreshed_limbs` left:

  * SSE in: one key switch at 1 limb; ModRaise: the INTT of one limb and
    the NTT of L, both halves; SSE out: one key switch at L limbs;
  * CoeffToSlot: stages at L, L-1, ... limbs; each stage of each of the
    two chains applies a plan by baby steps and giant steps over its
    wrapped diagonals (the offsets sum e_i 2^(a+i), e_i in {-1, 0, 1}, of
    its butterflies): the input's key-switch digits once (hoisted), each
    baby its inner product and ModDown, each diagonal a plaintext product
    (the plaintext read once), each giant a key switch without ModDown
    and one ModDown for their sum, then a rescale; the first stage's
    babies serve both chains; then two conjugations;
  * EvalMod, twice: the affine map and every term of the Chebyshev sum a
    plaintext product, every product of the Chebyshev basis (babies,
    giants, one for each giant node of the baby-step giant-step tree) and
    of the arcsine cubic a mult (bounds.op_least_s), all at the lowest
    level EvalMod reaches (refreshed_limbs + lt_stages), so a lower bound;
  * SlotToCoeff: stages down to refreshed_limbs, each chain on its own.

Each piece is bounded by the larger of its bytes and its operations; the
refresh's least time is their sum.
"""

from __future__ import annotations

import math
from typing import List, Set, Tuple

from hebench import bounds


def group_offsets(n: int, lt_stages: int) -> List[Set[int]]:
    """The wrapped diagonal offsets (mod n/2) of each group of butterflies,
    in application order: d = log2(n/2) stages of half-widths 1, 2, ..
    merged into lt_stages near-equal groups."""
    s = n // 2
    d = s.bit_length() - 1
    k = min(lt_stages, d)
    cut = [round(j * d / k) for j in range(k + 1)]
    out = []
    for j in range(k):
        offs = {0}
        for t in range(cut[j], cut[j + 1]):
            offs = {(o + e * (1 << t)) % s for o in offs for e in (-1, 0, 1)}
        out.append(offs)
    return out


def _bsgs(offsets: Set[int], s: int) -> Tuple[int, int, int]:
    """(diagonals, baby rotations, giant rotations) of a plan with these
    offsets."""
    B = 1 << ((s.bit_length() - 1) // 2)
    return (len(offsets), len({o % B for o in offsets} - {0}),
            len({o // B for o in offsets} - {0}))


def _ks_parts(n: int, level: int, special: int, alpha: int) -> Tuple[float, float, float]:
    """Least times of a key switch's three parts at `level`: the digits
    (INTT, base conversion, digit NTTs; the input read), the inner product
    (the key read once), ModDown (both halves)."""
    L_ext, D = level + special, math.ceil(level / alpha)
    digits = bounds.ntt_ops(level, n, inverse=True)
    for a in (min(alpha, level - g) for g in range(0, level, alpha)):
        digits += n * (a * bounds.MULMOD_OPS + a * (L_ext - a) * bounds.MAC_OPS)
        digits += bounds.ntt_ops(L_ext - a, n)
    inner = n * 2 * D * L_ext * bounds.MAC_OPS
    down = 2 * (bounds.ntt_ops(special, n, inverse=True)
                + n * (special * bounds.MULMOD_OPS + special * level * bounds.MAC_OPS)
                + bounds.ntt_ops(level, n) + n * level * (bounds.ADD_OPS + bounds.MULMOD_OPS))
    res = bounds.RESIDUE_BYTES
    return (bounds.least_s(level * n * res, digits),
            bounds.least_s(D * 2 * L_ext * n * res, inner),
            bounds.least_s(2 * level * n * res, down))


def _key_switch_s(n, level, special, alpha) -> float:
    return sum(_ks_parts(n, level, special, alpha))


def _pt_product_s(n: int, level: int) -> float:
    """A plaintext product and sum into an accumulator, both halves: the
    plaintext and the ciphertext read, the sum written."""
    cells = level * n
    return bounds.least_s(3 * cells * bounds.RESIDUE_BYTES,
                          2 * cells * (bounds.MULMOD_OPS + bounds.ADD_OPS))


def _plan_s(n, level, special, alpha, offsets, hoist: bool) -> float:
    """One plan applied at `level`: hoisted digits (when `hoist`), babies,
    diagonal products, giants, ModDown of their sum, rescale."""
    digits, inner, down = _ks_parts(n, level, special, alpha)
    diags, babies, giants = _bsgs(offsets, n // 2)
    return ((digits if hoist else 0.0) + babies * (inner + down)
            + diags * _pt_product_s(n, level) + giants * (digits + inner) + down
            + bounds.least_s(4 * level * n * bounds.RESIDUE_BYTES,
                             bounds.rescale_ops(n, level)))


def _evalmod_mults(degree: int, arcsine: int) -> int:
    """Ciphertext products of one EvalMod: the Chebyshev basis of the
    baby-step giant-step split (babies T_2 .. T_(B-1), giants T_B, T_2B ..),
    one a giant node of the tree, and the arcsine's (2 for the cubic, one
    more for each further odd degree)."""
    B = 1 << max((degree.bit_length() + 1) // 2, 1)
    while B > 2 and B * B > 4 * (degree + 1):
        B //= 2
    giants = max(0, math.floor(math.log2(degree / B)) + 1) if degree >= B else 0
    nodes = math.ceil((degree + 1) / B) - 1
    return max(0, B - 2) + giants + nodes + (arcsine - 1 if arcsine else 0)


def refresh_least_s(c: dict) -> float:
    """The least time of one refresh of one ciphertext under configuration
    `c` (the keys n, chain_primes, special_primes, alpha, lt_stages,
    evalmod_degree, arcsine_degree, refreshed_limbs)."""
    n, L, K, a = c["n"], c["chain_primes"], c["special_primes"], c["alpha"]
    k, out = c["lt_stages"], c["refreshed_limbs"]
    groups = group_offsets(n, k)
    t = _key_switch_s(n, 1, K, a) + _key_switch_s(n, L, K, a)
    t += bounds.least_s(2 * (L + 1) * n * bounds.RESIDUE_BYTES,
                        2 * (bounds.ntt_ops(1, n, inverse=True) + bounds.ntt_ops(L, n)))
    c2s = [{(-o) % (n // 2) for o in g} for g in reversed(groups)]  # adjoints, last group first
    for j, offs in enumerate(c2s):
        level = L - j
        t += 2 * _plan_s(n, level, K, a, offs, hoist=True)
        if j == 0:  # the two chains' first plans share the input's babies
            digits, inner, down = _ks_parts(n, level, K, a)
            t -= digits + _bsgs(offs, n // 2)[1] * (inner + down)
    t += 2 * _key_switch_s(n, L - len(c2s), K, a)
    low = out + len(groups)
    mult = bounds.op_least_s("mult", n, low, K, a, 1)
    t += 2 * (_evalmod_mults(c["evalmod_degree"], c["arcsine_degree"]) * mult
              + (c["evalmod_degree"] + 2) * _pt_product_s(n, low))
    for j, offs in enumerate(groups):
        t += 2 * _plan_s(n, low - j, K, a, offs, hoist=True)
    return t
