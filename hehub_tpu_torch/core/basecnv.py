"""RNS base manipulation (port of hehub_tpu/core/basecnv.py): signed
single-limb lifts, the exact divide-by-last-limb with rounding behind CKKS
rescale, BGV modulus switching and the special-prime drop (and the
constant table of ModDown, its kernels for every dropped limb at once), the
general k -> m base conversion behind hybrid key switching (and the constant
tables of ModUp, its kernel for every digit group at once), the
base-2^22 digit interchange formats of encode (unsigned digits from the
host codec, balanced digits from the device codec), the Garner
mixed-radix conversion of decode and BGV decrypt, and the host-exact
compose paths.
All device steps are exact integer algorithms, elementwise with per-limb
host constants.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from hehub_tpu_torch import kernels
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
    """div_last_rounded on both ciphertext halves: div_last_rounded_many by
    one limb."""
    return div_last_rounded_many(ctx, a, b, 1, plain_modulus, restore_plain_scale)


# divisions by one limb that div_last_rounded_many ran as the plain loop on
# a CUDA tensor (the BGV flavour; the CKKS flavour runs ModDown there)
PLAIN_DIVISIONS_ON_CARD = 0


def div_last_rounded_many(ctx: Context, a: RnsPoly, b: RnsPoly, count: int,
                          plain_modulus: Optional[int] = None,
                          restore_plain_scale: bool = True) -> Tuple[RnsPoly, RnsPoly]:
    """Both ciphertext halves divided by their last `count` limbs, one limb
    after the other from the top, each as div_last_rounded divides: bitwise
    `count` such divisions of each half. A CUDA tensor in the CKKS flavour
    (plain_modulus None) runs ModDown (csrc/basecnv.cu): K2, the lift, K1
    and the apply, one chain for up to kernels.MODDOWN_MAX_COUNT limbs, its
    plain twin moddown_plain; the BGV flavour and CPU tensors run the loop
    of div_last_rounded on both halves stacked, whose INTT/NTT kernels see
    twice the rows and half the launches."""
    global PLAIN_DIVISIONS_ON_CARD
    if a.limb_ids != b.limb_ids or a.form != b.form or a.data.shape != b.data.shape:
        raise ValueError("pair must share limbs, form and shape")
    if not 0 <= count < a.limb_count:
        raise ValueError(f"cannot drop {count} of {a.limb_count} limbs")
    if a.data.is_cuda and plain_modulus is None:
        if a.form != NTT:
            raise ValueError("div_last_rounded expects NTT form")
        while count:
            step = min(count, kernels.MODDOWN_MAX_COUNT)
            a, b = _moddown_card(ctx, a, b, step)
            count -= step
        return a, b
    if a.data.is_cuda:
        PLAIN_DIVISIONS_ON_CARD += count
    for _ in range(count):
        out = div_last_rounded(ctx, RnsPoly(torch.stack([a.data, b.data]), a.form, a.limb_ids),
                               plain_modulus, restore_plain_scale)
        a, b = (RnsPoly(out.data[h], out.form, out.limb_ids) for h in range(2))
    return a, b


@functools.lru_cache(maxsize=None)
def moddown_tables(ctx: Context, ids: Tuple[int, ...], count: int, device: str) -> torch.Tensor:
    """The constants of ModDown (csrc/basecnv.cu), the division by the last
    `count` limbs of `ids` one after the other from the top, as int32 bits
    of uint32 words [len(ids), 1 + count, 4] on `device`, made once per
    (limbs, count, device): per limb i (q_i, 2 q_i, floor(2^32 / q_i) — the
    Shoup word of 1 — and 0); then per step k (k = 0 drops the last limb, k
    = 1 the one below it ...) while limb i lies below the limb e the step
    drops, (q_i - q_e mod q_i) mod q_i, q_e^-1 mod q_i and its Shoup word,
    and 1 where the step takes div_last_rounded's uniform-width branch (q_e
    below twice every limb it keeps), zeros after."""
    mods = [int(m) for m in ctx.moduli_of(ids)]
    tab = np.zeros((len(mods), 1 + count, 4), np.uint64)
    for i, q in enumerate(mods):
        tab[i, 0, :3] = (q, 2 * q, hm.shoup(1, q))
    for k in range(count):
        e = len(mods) - 1 - k
        q_e = mods[e]
        uniform = int(q_e < 2 * min(mods[:e]))
        for i, q in enumerate(mods[:e]):
            w = hm.modinv(q_e % q, q)
            tab[i, 1 + k] = ((q - q_e % q) % q, w, hm.shoup(w, q), uniform)
    return torch.from_numpy(tab.astype(np.uint32).view(np.int32)).to(device)


def _moddown_card(ctx: Context, a: RnsPoly, b: RnsPoly, count: int) -> Tuple[RnsPoly, RnsPoly]:
    """ModDown on CUDA tensors, count <= kernels.MODDOWN_MAX_COUNT: K2 on the
    dropped limbs of both halves (copied to int32 beside each other), the
    lift, K1 on its remainders, the apply."""
    ids = a.limb_ids
    *batch, limbs, n = a.data.shape
    L = limbs - count
    dev = a.data.device
    tab = moddown_tables(ctx, ids, count, str(dev))
    x0, x1 = (h.data.reshape(-1, limbs, n).contiguous() for h in (a, b))
    R = x0.shape[0]
    low = torch.empty((2, R, count, n), dtype=torch.int32, device=dev)
    low[0].copy_(x0[:, L:])
    low[1].copy_(x1[:, L:])
    low = nttmod.transform_bits(low, nttmod.limb_rows(ctx, ids[L:]), inverse=True)
    r_hat = nttmod.transform_bits(kernels.moddown_lift(low.view(2 * R, count, n), tab, L),
                                  nttmod.limb_rows(ctx, ids[:L]))
    out = kernels.moddown_apply(x0, x1, r_hat, tab).view(2, *batch, L, n)
    return RnsPoly(out[0], NTT, ids[:L]), RnsPoly(out[1], NTT, ids[:L])


def _centred(v, lim, st, half):
    """div_last_rounded's step 2 on v (the strict coefficients of the limb a
    step drops, half = floor(q_e / 2)) under limbs of records lim [..., 4,
    1] (q, 2q, the Shoup word of 1) at a step of records st [..., 4, 1]:
    v mod q, then the correction where v >= half."""
    q = lim[..., 0, :]
    if int(st[..., 3, :].reshape(-1)[0]):
        m = ma.reduce_strict(v, q)
    else:
        m = ma.reduce_strict(ma.shoup_mul_lazy(v, 1, lim[..., 2, :], q), q)
    return m + torch.where(v >= half, st[..., 0, :], 0)


def moddown_plain(ctx: Context, a: RnsPoly, b: RnsPoly, count: int) -> Tuple[RnsPoly, RnsPoly]:
    """ModDown's plain twin: the kernels' arithmetic in PyTorch, reading
    their table (moddown_tables), with the transforms of ops.ntt on the
    data's device (K1/K2 on the card). Both halves divided by their last
    `count` limbs (count <= kernels.MODDOWN_MAX_COUNT): bitwise `count`
    div_last_rounded_pair calls."""
    ids = a.limb_ids
    L = len(ids) - count
    t = nttmod.from_u32_bits(moddown_tables(ctx, ids, count, str(a.data.device)))[..., None]
    lim, st = t[:, 0], t[:, 1:]  # [L + count, 4, 1], [L + count, count, 4, 1]
    low = nttmod.intt(ctx, torch.stack([a.data[..., L:, :], b.data[..., L:, :]]), ids[L:])
    # u[p]: the dropped limb p from the top (limb L + count - 1 - p), strict;
    # step k drops u[k], then moves every lower one in coefficient form
    top = [L + count - 1 - p for p in range(count)]
    u = [ma.reduce_strict(low[..., i - L, :], lim[i, 0]) for i in top]
    half = [lim[i, 0] >> 1 for i in top]
    for k in range(count):
        for p in range(k + 1, count):
            i = top[p]
            r = _centred(u[k], lim[i], st[i, k], half[k])
            diff = ma.sub_lazy(u[p], r, lim[i, 1])
            u[p] = ma.reduce_strict(ma.shoup_mul_lazy(diff, st[i, k, 1], st[i, k, 2], lim[i, 0]),
                                    lim[i, 0])
    r = torch.stack([_centred(u[k][..., None, :], lim[:L], st[:L, k], half[k])
                     for k in range(count)], dim=-3)  # [2, *batch, count, L, n]
    r_hat = nttmod.ntt(ctx, r, ids[:L])
    x = torch.stack([a.data[..., :L, :], b.data[..., :L, :]])
    for k in range(count):
        x = ma.shoup_mul_lazy(ma.sub_lazy(x, r_hat[..., k, :, :], lim[:L, 1]), st[:L, k, 1],
                              st[:L, k, 2], lim[:L, 0])
    return RnsPoly(x[0], NTT, ids[:L]), RnsPoly(x[1], NTT, ids[:L])


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


@functools.lru_cache(maxsize=None)
def modup_tables(ctx: Context, src_ids: Tuple[int, ...], dst_ids: Tuple[int, ...], alpha: int,
                 device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The constants of ModUp (csrc/basecnv.cu): base_convert(signed=True) of
    each group of `alpha` consecutive limbs of `src_ids` (the last group
    ragged) into `dst_ids`, as int32 bits of uint32 words on `device`, made
    once per (limbs, alpha, device):
      src [l, 8]: per source limb i of its group (product Q), (Q/q_i)^-1
        mod q_i and its Shoup word, q_i, then c_hi, c_lo of c = floor(2^64 /
        q_i), three words of padding;
      dst [D, L_ext, 4 + 2 alpha rounded up to a multiple of 4]: per (group,
        destination limb p_j), p_j, 2 p_j, Q mod p_j and its Shoup word, then
        Q/q_i mod p_j and its Shoup word per member i of the group, zeros
        after the last."""
    src_mods, dst_mods = ctx.moduli_of(src_ids), ctx.moduli_of(dst_ids)
    groups = [src_mods[g:g + alpha] for g in range(0, len(src_mods), alpha)]
    src = np.zeros((len(src_mods), 8), np.uint64)
    dst = np.zeros((len(groups), len(dst_mods), 4 + 2 * alpha + (-2 * alpha) % 4), np.uint64)
    for g, mods in enumerate(groups):
        Q = 1
        for q in mods:
            Q *= int(q)
        for m, q in enumerate(mods):
            inv = hm.modinv((Q // q) % q, q)
            c = (1 << 64) // q
            src[g * alpha + m, :5] = (inv, hm.shoup(inv, q), q, c >> 32, c & ma.MASK32)
        for j, p in enumerate(dst_mods):
            dst[g, j, :4] = (p, 2 * p, Q % p, hm.shoup(Q % p, p))
            for m, q in enumerate(mods):
                dst[g, j, 4 + 2 * m:6 + 2 * m] = ((Q // q) % p, hm.shoup((Q // q) % p, p))
    return tuple(torch.from_numpy(t.astype(np.uint32).view(np.int32)).to(device)
                 for t in (src, dst))


def modup_plain(src_tab: torch.Tensor, dst_tab: torch.Tensor, x: torch.Tensor,
                alpha: int) -> torch.Tensor:
    """ModUp's plain twin: the kernel's arithmetic in PyTorch, reading its
    tables (modup_tables). x: strict coefficient-form source limbs [..., l,
    n] (int64); returns the digits [..., D, L_ext, n] (int64, lazy in [0,
    2 p_j)), digit g bitwise base_convert(signed=True) of group g."""
    s = nttmod.from_u32_bits(src_tab)[..., None]  # [l, 8, 1]
    t = nttmod.from_u32_bits(dst_tab)[..., None]  # [D, L_ext, W, 1]
    l = x.shape[-2]
    digits = []
    for g in range(t.shape[0]):
        sg = s[g * alpha:min(l, (g + 1) * alpha)]
        k = sg.shape[0]
        q = sg[:, 2]
        y = ma.reduce_strict(ma.shoup_mul_lazy(x[..., g * alpha:g * alpha + k, :], sg[:, 0],
                                               sg[:, 1], q), q)
        z = (y * sg[:, 3] + ma.mul_hi(y, sg[:, 4])) & ma.MASK32
        lo = torch.zeros_like(z[..., 0, :])
        v = torch.zeros_like(lo)
        for i in range(k):
            lo_new = (lo + z[..., i, :]) & ma.MASK32
            v = v + (lo_new < z[..., i, :]).to(torch.int64)
            lo = lo_new
        v = v + (lo >= 1 << 31).to(torch.int64)
        p, two_p, wQ, wQ_sh = (t[g, :, c] for c in range(4))  # [L_ext, 1]
        w = t[g, :, 4:4 + 2 * k:2].movedim(1, 0)  # [k, L_ext, 1]
        w_sh = t[g, :, 5:5 + 2 * k:2].movedim(1, 0)
        terms = ma.shoup_mul_lazy(y[..., :, None, :], w, w_sh, p)  # [..., k, L_ext, n]
        acc = ma.reduce_add_lazy(terms, -3, two_p)
        corr = ma.shoup_mul_lazy(v[..., None, :], wQ, wQ_sh, p)
        digits.append(ma.sub_lazy(acc, corr, two_p))
    return torch.stack(digits, dim=-3)


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
