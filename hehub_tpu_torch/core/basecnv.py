"""RNS base manipulation (port of hehub_tpu/core/basecnv.py): signed
single-limb lifts, the exact divide-by-last-limb with rounding behind CKKS
rescale, BGV modulus switching and the special-prime drop, the general
k -> m base conversion behind hybrid key switching, the base-2^22 digit
interchange formats of encode (unsigned digits from the host codec,
balanced digits from the device codec), the Garner mixed-radix conversion
of decode and BGV decrypt, and the host-exact compose paths.
All device steps are exact integer algorithms, elementwise with per-limb
host constants.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from hehub_tpu_torch.core.context import Context
from hehub_tpu_torch.core.rns import COEFF, NTT, RnsPoly, shoup_constants
from hehub_tpu_torch.ops import modarith as ma
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.utils import hostmath as hm


def lift_signed_single(ctx: Context, coeffs, src_mod: int, dst_ids: Tuple[int, ...]) -> RnsPoly:
    """Signed lift of strict residues mod t (t below every target modulus)
    into the limbs `dst_ids`: values >= t/2 are taken as negative.
    coeffs: [..., n] int64 in [0, t)."""
    t = int(src_mod)
    if t >= min(ctx.moduli_of(dst_ids)):
        raise ValueError("signed single lift requires t < every target modulus")
    q = ctx.device_rows("q", dst_ids, coeffs.device)
    x = coeffs[..., None, :]
    return RnsPoly(torch.where(x < t // 2, x, x + q - t), COEFF, dst_ids)


@functools.lru_cache(maxsize=None)
def _div_last_constants(ctx: Context, ids: Tuple[int, ...], device: str,
                        plain_modulus: Optional[int], restore_plain_scale: bool):
    """Device constants of div_last_rounded for the limbs `ids`, each [L-1, 1]:
    (corr, w1, w1_sh, w, w_sh, t_w, t_w_sh), the last two None without a
    plain modulus. w is q_last^{-1} mod q_j, times (q_last mod t) when the
    plain scale is restored; t_w is t mod q_j."""
    q_last = ctx.mod_list[ids[-1]]
    rem_ids = ids[:-1]
    rem_mods = ctx.moduli_of(rem_ids)
    corr = np.asarray([(qj - q_last % qj) % qj for qj in rem_mods], np.int64)[:, None]
    w1, w1_sh = shoup_constants(ctx, 1, rem_ids, device)
    scal = [hm.modinv(q_last % qj, qj) for qj in rem_mods]
    t_w = t_w_sh = None
    if plain_modulus is not None:
        if restore_plain_scale:
            scal = [s * (q_last % plain_modulus) % qj for s, qj in zip(scal, rem_mods)]
        t_w, t_w_sh = shoup_constants(ctx, plain_modulus, rem_ids, device)
    w, w_sh = shoup_constants(ctx, scal, rem_ids, device)
    return torch.from_numpy(corr).to(device), w1, w1_sh, w, w_sh, t_w, t_w_sh


def div_last_rounded(ctx: Context, poly: RnsPoly, plain_modulus: Optional[int] = None,
                     restore_plain_scale: bool = True) -> RnsPoly:
    """Exactly divide an NTT-form polynomial by its last RNS limb q_last with
    rounding, dropping that limb.

    plain_modulus=None: the CKKS flavour, out ≡ round(x / q_last) mod q_j.

    plain_modulus=t: the BGV flavour, which divides by q_last while keeping
    the value mod t through the t^{-1} mod q_last correction, then (for a
    standalone modulus switch) restores the plaintext scale with
    (q_last mod t). restore_plain_scale=False is the special-prime drop
    inside BGV relinearization, whose key-switched value is already
    q_last-scaled (u ≡ p·d2·s² + t·E): dividing by p alone gives d2·s² mod
    t exactly."""
    if poly.form != NTT:
        raise ValueError("div_last_rounded expects NTT form")
    if poly.limb_count < 2:
        raise ValueError("cannot drop the only limb")
    ids = poly.limb_ids
    last_id = ids[-1]
    rem_ids = ids[:-1]
    q_last = ctx.mod_list[last_id]
    rem_mods = ctx.moduli_of(rem_ids)
    dev = poly.data.device
    corr, w1, w1_sh, w, w_sh, t_w, t_w_sh = _div_last_constants(
        ctx, ids, str(dev), plain_modulus, restore_plain_scale)

    # 1. last limb back to coefficients, strict (BGV: times t^{-1} mod q_last)
    last = nttmod.intt(ctx, poly.data[..., -1:, :], (last_id,))
    v = ma.reduce_strict(last, q_last)
    if plain_modulus is not None:
        inv_t = hm.modinv(plain_modulus % q_last, q_last)
        v = ma.reduce_strict(ma.shoup_mul_lazy(v, inv_t, hm.shoup(inv_t, q_last), q_last), q_last)

    # 2. centered remainder under each remaining limb: [0, 2 q_j)
    q = ctx.device_rows("q", rem_ids, dev)
    if q_last < 2 * min(rem_mods):
        # uniform-width chains: v < q_last < 2 q_j, one subtract suffices
        r = ma.reduce_strict(v, q)
    else:
        # mixed-width chains: q_last may dwarf a remaining limb — take
        # v mod q_j by a Shoup multiply by 1 (valid for ANY uint32 input)
        r = ma.reduce_strict(ma.shoup_mul_lazy(v, w1, w1_sh, q), q)
    r = r + torch.where(v >= q_last // 2, corr, 0)

    # 3. back to NTT under the remaining limbs (BGV: times t)
    r_ntt = nttmod.ntt(ctx, r, rem_ids)
    if plain_modulus is not None:
        r_ntt = ma.shoup_mul_lazy(r_ntt, t_w, t_w_sh, q)

    # 4. (x - r) * q_last^{-1} [* (q_last mod t)] per limb
    diff = ma.sub_lazy(poly.data[..., :-1, :], r_ntt, ctx.device_rows("two_q", rem_ids, dev))
    return RnsPoly(ma.shoup_mul_lazy(diff, w, w_sh, q), NTT, rem_ids)


def div_last_rounded_pair(ctx: Context, a: RnsPoly, b: RnsPoly,
                          plain_modulus: Optional[int] = None,
                          restore_plain_scale: bool = True) -> Tuple[RnsPoly, RnsPoly]:
    """div_last_rounded on both ciphertext halves in one stacked call: the
    INTT/NTT kernels see twice the rows and half the launches."""
    if a.limb_ids != b.limb_ids or a.form != b.form:
        raise ValueError("pair must share limbs and form")
    out = div_last_rounded(ctx, RnsPoly(torch.stack([a.data, b.data]), a.form, a.limb_ids),
                           plain_modulus, restore_plain_scale)
    return (
        RnsPoly(out.data[0], out.form, out.limb_ids),
        RnsPoly(out.data[1], out.form, out.limb_ids),
    )


# ---------------------------------------------------------------------------
# General k -> m base conversion
# ---------------------------------------------------------------------------


def base_convert(ctx: Context, poly: RnsPoly, dst_ids: Tuple[int, ...],
                 signed: bool = True) -> RnsPoly:
    """Fast base conversion of a coeff-form poly over its limbs (product Q)
    into lazy residues over `dst_ids` of the same integer x ∈ [0, Q), taken
    signed (centered: x - Q when x >= Q/2) or unsigned.

    With y_i = x_i · (Q/q_i)^{-1} mod q_i, out_j = Σ_i y_i·(Q/q_i mod p_j)
    − v·(Q mod p_j), where v = floor (unsigned) or round (signed) of
    Σ_i y_i/q_i, summed in 0.32 fixed point with a uint32 carry chain, as
    in the reference, whose wraparound is reproduced with `& 0xFFFFFFFF`."""
    if poly.form != COEFF:
        raise ValueError("base_convert expects coeff form")
    if not dst_ids:
        raise ValueError("base_convert needs at least one destination limb")
    src_ids = poly.limb_ids
    src_mods = ctx.moduli_of(src_ids)
    dst_mods = ctx.moduli_of(dst_ids)
    dev = poly.data.device
    Q = 1
    for q in src_mods:
        Q *= int(q)

    # 1. y_i = x_i * qhat_inv_i mod q_i, strict
    w, w_sh = shoup_constants(ctx, [hm.modinv((Q // q) % q, q) for q in src_mods], src_ids, dev)
    q_src = ctx.device_rows("q", src_ids, dev)
    y = ma.reduce_strict(ma.shoup_mul_lazy(poly.data, w, w_sh, q_src), q_src)  # [..., k, n]

    # 2. v from z_i ≈ y_i·2^32/q_i: the carries out of the uint32 sum
    c = [(1 << 64) // q for q in src_mods]
    c_hi = torch.tensor([ci >> 32 for ci in c], dtype=torch.int64, device=dev)[:, None]
    c_lo = torch.tensor([ci & ma.MASK32 for ci in c], dtype=torch.int64, device=dev)[:, None]
    z = (y * c_hi + ma.mul_hi(y, c_lo)) & ma.MASK32
    lo = torch.zeros_like(z[..., 0, :])
    carries = torch.zeros_like(lo)
    for i in range(len(src_mods)):
        lo_new = (lo + z[..., i, :]) & ma.MASK32
        carries = carries + (lo_new < z[..., i, :]).to(torch.int64)
        lo = lo_new
    v = carries + (lo >= 1 << 31).to(torch.int64) if signed else carries

    # 3. out_j = Σ_i y_i·(Q/q_i mod p_j) − v·(Q mod p_j), lazy in [0, 2p_j),
    #    for all destination limbs at once: terms [..., m, k, n]
    qhat = [[(Q // q) % p for q in src_mods] for p in dst_mods]
    wq = torch.tensor(qhat, dtype=torch.int64, device=dev)[..., None]
    wq_sh = torch.tensor([[hm.shoup(x, p) for x in row] for row, p in zip(qhat, dst_mods)],
                         dtype=torch.int64, device=dev)[..., None]
    q_dst = ctx.device_rows("q", dst_ids, dev)
    two_p = ctx.device_rows("two_q", dst_ids, dev)
    terms = ma.shoup_mul_lazy(y[..., None, :, :], wq, wq_sh, q_dst[..., None])
    acc = ma.reduce_add_lazy(terms, -2, two_p)
    wQ, wQ_sh = shoup_constants(ctx, [Q % p for p in dst_mods], dst_ids, dev)
    corr = ma.shoup_mul_lazy(v[..., None, :], wQ, wQ_sh, q_dst)
    return RnsPoly(ma.sub_lazy(acc, corr, two_p), COEFF, tuple(dst_ids))


# ---------------------------------------------------------------------------
# Digit-form integers: the host -> device interchange format of encode
# ---------------------------------------------------------------------------

DIGIT_BITS = 22
NUM_DIGITS = 3  # 3 x 22-bit digits cover |value| < 2^62


def digitize_signed(ix: np.ndarray):
    """Exact base-2^22 digit split of int64 values, |ix| < 2^62. Returns
    (digits uint32 [..., 3, n], neg uint32 [..., n]) as host numpy."""
    ix = np.asarray(ix, np.int64)
    if np.abs(ix).max(initial=0) >= (1 << 62):
        raise ValueError("digitize_signed requires |values| < 2^62")
    neg = (ix < 0).astype(np.uint32)
    ax = np.abs(ix).astype(np.uint64)
    mask = np.uint64((1 << DIGIT_BITS) - 1)
    digits = np.empty((*ix.shape[:-1], NUM_DIGITS, ix.shape[-1]), np.uint32)
    for i in range(NUM_DIGITS):
        digits[..., i, :] = ((ax >> np.uint64(DIGIT_BITS * i)) & mask).astype(np.uint32)
    return digits, neg


def decompose_digits(ctx: Context, digits, neg, ids: Tuple[int, ...]) -> RnsPoly:
    """Residue decomposition of digitized signed integers on the digits'
    device: lazy r_j = ±(d0 + d1·2^22 + d2·2^44) mod q_j.
    digits: int64 [..., 3, n]; neg: int64 [..., n] (nonzero = negative)."""
    dev = digits.device
    mods = ctx.moduli_of(ids)
    q = ctx.device_rows("q", ids, dev)
    two_q = ctx.device_rows("two_q", ids, dev)
    r = digits[..., 0:1, :]  # [..., 1, n] < 2^22
    for i in range(1, NUM_DIGITS):
        w, w_sh = shoup_constants(ctx, [(1 << (DIGIT_BITS * i)) % m for m in mods], ids, dev)
        term = ma.shoup_mul_lazy(digits[..., i : i + 1, :], w, w_sh, q)
        r = ma.add_lazy(r, term, two_q)
    r = torch.where(neg[..., None, :] != 0, ma.neg_lazy(r, two_q), r)
    return RnsPoly(r, COEFF, ids)


def decompose_balanced(ctx: Context, digits: torch.Tensor, ids: Tuple[int, ...]) -> RnsPoly:
    """Residue decomposition of balanced base-2^22 digits on the digits'
    device: lazy r_j = (d0 + d1·2^22 + d2·2^44) mod q_j, each d_i an integer
    in (-2^22, 2^22) (ops.fft.balanced_digits). digits: int [..., 3, n].

    Bias trick of the reference: with C = 2^22, each biased digit d_i + C
    lies in [1, 2^23), a valid lazy input, and Σ (d_i + C)·2^{22i} = value
    + OFF with OFF = C·(1 + 2^22 + 2^44), which one per-limb addition of
    −OFF mod q_j removes."""
    dev = digits.device
    mods = ctx.moduli_of(ids)
    q = ctx.device_rows("q", ids, dev)
    two_q = ctx.device_rows("two_q", ids, dev)
    C = 1 << DIGIT_BITS
    biased = digits.to(torch.int64) + C
    r = biased[..., 0:1, :]  # [..., 1, n] < 2^23
    for i in range(1, NUM_DIGITS):
        w, w_sh = shoup_constants(ctx, [(1 << (DIGIT_BITS * i)) % m for m in mods], ids, dev)
        r = ma.add_lazy(r, ma.shoup_mul_lazy(biased[..., i : i + 1, :], w, w_sh, q), two_q)
    return RnsPoly(ma.add_lazy(r, _balanced_offset(ctx, ids, str(dev)), two_q), COEFF, ids)


@functools.lru_cache(maxsize=None)
def _balanced_offset(ctx: Context, ids: Tuple[int, ...], device: str) -> torch.Tensor:
    """−OFF mod q_j [L, 1] on `device` for decompose_balanced, with OFF =
    2^22·(1 + 2^22 + 2^44) the bias of its three digits."""
    off = (1 << DIGIT_BITS) * (1 + (1 << DIGIT_BITS) + (1 << (2 * DIGIT_BITS)))
    return torch.tensor([(-off) % m for m in ctx.moduli_of(ids)], dtype=torch.int64,
                        device=device)[:, None]


def to_mixed_radix(ctx: Context, data, limb_ids: Tuple[int, ...], k: int):
    """Garner conversion on the data's device: strict residues of x under
    the first k limbs -> mixed-radix digits [..., k, n] with
    x = Σ_j y_j · ∏_{m<j} q_m (mod ∏q). `data`: [..., L, n] lazy, L >= k."""
    ids = limb_ids[:k]
    mods = [int(m) for m in ctx.moduli_of(ids)]
    x = ma.reduce_strict(data[..., :k, :], ctx.device_rows("q", ids, data.device))
    ys = [x[..., 0, :]]
    for i in range(1, k):
        qi = mods[i]
        two_qi = 2 * qi
        if mods[0] < 2 * qi:
            # uniform-width chains: y_0 < q_0 < 2·q_i, a valid lazy input
            acc = ys[0]
        else:
            # mixed-width chains: route y_0 through a Shoup multiply by 1
            acc = ma.shoup_mul_lazy(ys[0], 1, hm.shoup(1, qi), qi)
        for j in range(1, i):
            w = 1
            for m in mods[:j]:
                w = w * m % qi
            term = ma.shoup_mul_lazy(ys[j], w, hm.shoup(w, qi), qi)
            acc = ma.add_lazy(acc, term, two_qi)
        diff = ma.sub_lazy(x[..., i, :], acc, two_qi)
        w_inv = 1
        for m in mods[:i]:
            w_inv = w_inv * m % qi
        w_inv = hm.modinv(w_inv, qi)
        y_i = ma.shoup_mul_lazy(diff, w_inv, hm.shoup(w_inv, qi), qi)
        ys.append(ma.reduce_strict(y_i, qi))
    return torch.stack(ys, dim=-2)


# ---------------------------------------------------------------------------
# Host-side exact compose/convert (the k -> 1 and oracle paths)
# ---------------------------------------------------------------------------


def compose_to_int(coeffs: np.ndarray, moduli) -> list:
    """Host CRT compose of strict residues [L, n] -> centered Python ints."""
    vals = hm.crt_compose([np.asarray(c) for c in coeffs], list(moduli))
    Q = 1
    for m in moduli:
        Q *= int(m)
    return [hm.to_signed(x, Q) for x in vals]


def convert_to_single_host(coeffs: np.ndarray, moduli, new_modulus: int) -> np.ndarray:
    """Host-exact k -> 1 base conversion with signed lift of strict
    residues [L, n], in the host C++ runtime."""
    from hehub_tpu_torch.native import loader

    return loader.compose_mod(np.asarray(coeffs), list(moduli), new_modulus)


def convert_to_single_host_plain(coeffs: np.ndarray, moduli, new_modulus: int) -> np.ndarray:
    """The Python-int twin of convert_to_single_host."""
    ints = compose_to_int(coeffs, moduli)
    return np.asarray([x % new_modulus for x in ints], dtype=np.uint32)
