"""BGV: exact-arithmetic SIMD homomorphic encryption over Z_t (port of
hehub_tpu/models/bgv.py).

Ciphertexts are pairs of NTT-form RnsPoly on their device; relinearization
is the external product (K3 at alpha=1, K4 at alpha>1) plus the BGV
special-prime drop. Any plaintext modulus t in [2, 2^58) coprime to the
chain works. Z_t values live in digit form (3 x 22-bit digits + sign,
core/basecnv.digitize_signed), made on the host and moved to the
ciphertext's device, where basecnv.decompose_digits lifts them exactly
into the ciphertext basis. SIMD packing runs one negacyclic NTT per prime
factor of t: factors below 2^29 through ops.ntt.ntt_single/intt_single
(K1/K2 on the card), larger ones through the host u64 NTT. Exact
decryption is a Garner conversion on the device and a fold of its digits
mod each factor of t on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from hehub_tpu_torch.core import basecnv, rns
from hehub_tpu_torch.core.context import BgvParams, Context
from hehub_tpu_torch.core.rns import NTT, RnsPoly
from hehub_tpu_torch.ops import modarith as ma
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from hehub_tpu_torch.utils import hostmath as hm


class BgvPt(NamedTuple):
    """Coeff-form polynomial over Z_t in signed digit form, host numpy: the
    coefficient value is (−1)^neg · Σ_i digits[i]·2^22i, centered in
    (−t/2, t/2]."""

    digits: np.ndarray  # uint32 [..., 3, n]
    neg: np.ndarray  # uint32 [..., n]
    plain_modulus: int

    @property
    def data(self) -> np.ndarray:
        """Strict residues in [0, t), uint64 [..., n]."""
        t = np.uint64(self.plain_modulus)
        d = np.asarray(self.digits, np.uint64)
        v = sum(d[..., i, :] << np.uint64(basecnv.DIGIT_BITS * i)
                for i in range(basecnv.NUM_DIGITS))
        return np.where(np.asarray(self.neg) != 0, (t - v) % t, v)


class BgvCt(NamedTuple):
    c0: RnsPoly
    c1: RnsPoly
    plain_modulus: int

    @property
    def limb_ids(self):
        return self.c0.limb_ids


class BgvQuadCt(NamedTuple):
    c0: RnsPoly
    c1: RnsPoly
    c2: RnsPoly
    plain_modulus: int


def _check_t(a, b):
    if a.plain_modulus != b.plain_modulus:
        raise ValueError("plain moduli mismatch")


def pt_from_values(ctx: Context, values) -> BgvPt:
    """BgvPt from strict residues mod t (coefficient encoding): centered,
    then digitized exactly."""
    t = ctx.params.plain_modulus
    vals = np.asarray(values, np.uint64)
    if (vals >= t).any():
        raise ValueError(f"values must be Z_t elements, t={t}")
    signed = np.where(vals > t // 2, vals.astype(np.int64) - t, vals.astype(np.int64))
    digits, neg = basecnv.digitize_signed(signed)
    return BgvPt(digits, neg, t)


# ---------------------------------------------------------------------------
# SIMD packing (extended to composite t by CRT over its prime factors)
# ---------------------------------------------------------------------------


def _factor_transform(ctx: Context, f: int, table, vals: np.ndarray, device,
                      inverse: bool) -> np.ndarray:
    """The negacyclic NTT (or its inverse) of strict residues mod the factor
    f, [..., n] uint64 -> strict uint64: through K1/K2 (ntt_single /
    intt_single on `device`) where f has tables, else the host u64 NTT."""
    if table is None:
        return hm.ntt_host_u64(vals, f, ctx.params.dimension, inverse=inverse)
    x = torch.from_numpy(vals.astype(np.int64)).to(device)
    out = (nttmod.intt_single if inverse else nttmod.ntt_single)(table, x)
    return ma.reduce_strict(out, f).cpu().numpy().astype(np.uint64)


def _factor_intt(ctx: Context, f: int, table, vals: np.ndarray, device="cuda") -> np.ndarray:
    return _factor_transform(ctx, f, table, vals, device, inverse=True)


def _factor_ntt(ctx: Context, f: int, table, vals: np.ndarray, device="cuda") -> np.ndarray:
    return _factor_transform(ctx, f, table, vals, device, inverse=False)


def _crt_compose_u64(residues, factors) -> np.ndarray:
    """Garner compose residue arrays mod pairwise-coprime factors into
    values mod ∏factors < 2^58, exactly (vectorized uint64; products via
    hostmath.mulmod_u64)."""
    x = residues[0].astype(np.uint64)
    prod = int(factors[0])
    for r, f in zip(residues[1:], factors[1:]):
        f = int(f)
        inv = hm.modinv(prod % f, f)
        diff = (r.astype(np.uint64) + np.uint64(f) - x % np.uint64(f)) % np.uint64(f)
        y = hm.mulmod_u64(diff, np.broadcast_to(np.uint64(inv), diff.shape), f)
        x = x + y * np.uint64(prod)
        prod *= f
    return x


def _simd_tables(ctx: Context):
    params = ctx.params
    if not isinstance(params, BgvParams) or not params.simd_capable:
        raise ValueError(
            "SIMD packing needs every prime factor of t to be ≡ 1 mod 2n "
            "(use pt_from_values for coefficient encoding)"
        )
    return params.plain_factors, ctx.plain_fact_tables


def simd_encode(ctx: Context, data, device="cuda") -> BgvPt:
    """Pack Z_t slots: per prime factor of t, an inverse NTT mod that factor
    (on `device`, the card unless the caller asks for the CPU); the
    factor-residue coefficients CRT-compose back to Z_t."""
    t = ctx.params.plain_modulus
    n = ctx.params.dimension
    factors, tables = _simd_tables(ctx)
    data = np.asarray(data, dtype=np.uint64)
    if (data >= t).any():
        raise ValueError(f"data must be Z_t elements, t={t}")
    if data.shape[-1] > n:
        raise ValueError(f"cannot encode {data.shape[-1]} data into {n} slots")
    vals = np.zeros((*data.shape[:-1], n), dtype=np.uint64)
    vals[..., : data.shape[-1]] = data
    per_factor = [_factor_intt(ctx, f, tab, vals % np.uint64(f), device)
                  for f, tab in zip(factors, tables)]
    return pt_from_values(ctx, _crt_compose_u64(per_factor, factors))


def simd_decode(ctx: Context, pt: BgvPt, count: Optional[int] = None,
                device="cuda") -> np.ndarray:
    """The Z_t slots of a plaintext: per prime factor of t, a forward NTT
    (on `device`), then the CRT composition."""
    factors, tables = _simd_tables(ctx)
    vals = pt.data  # uint64 [..., n] strict mod t
    per_factor = [_factor_ntt(ctx, f, tab, vals % np.uint64(f), device)
                  for f, tab in zip(factors, tables)]
    out = _crt_compose_u64(per_factor, factors)
    return out[..., : count or out.shape[-1]]


# ---------------------------------------------------------------------------
# Encrypt / decrypt
# ---------------------------------------------------------------------------


def _pt_under_ct(ctx: Context, pt: BgvPt, ids, device) -> RnsPoly:
    """The plaintext's digits moved to `device`, lifted exactly into the
    limbs `ids` and NTT'd."""
    digits = torch.from_numpy(np.asarray(pt.digits, np.int64)).to(device)
    neg = torch.from_numpy(np.asarray(pt.neg, np.int64)).to(device)
    return rns.to_ntt(ctx, basecnv.decompose_digits(ctx, digits, neg, ids))


def encrypt(ctx: Context, pt: BgvPt, sk: rlwe_mod.RlweSk, gen: torch.Generator,
            **dbg) -> BgvCt:
    """Noise lifted by t, on the generator's device; the plaintext is
    signed-lifted into the ciphertext chain by the exact digit
    decomposition (valid for ANY t < 2^58)."""
    t = pt.plain_modulus
    ids = tuple(range(len(ctx.params.moduli)))
    batch = pt.digits.shape[:-2]
    c0, c1 = rlwe_mod.rlwe_sample(ctx, sk, gen, ids, batch_shape=batch, noise_scale=t, **dbg)
    c0 = rns.add(ctx, c0, _pt_under_ct(ctx, pt, ids, gen.device))
    return BgvCt(c0, c1, t)


def decrypt(ctx: Context, ct: BgvCt, sk: rlwe_mod.RlweSk) -> BgvPt:
    """Exact decryption for any t: decrypt core and Garner mixed radix over
    all limbs on the ciphertext's device, then a host fold of the digits
    mod each factor of t (no bignums)."""
    poly = rlwe_mod.decrypt_core(ctx, rlwe_mod.RlweCt(ct.c0, ct.c1), sk)
    ids = poly.limb_ids
    mods = [int(m) for m in ctx.moduli_of(ids)]
    digits = basecnv.to_mixed_radix(ctx, poly.data, ids, len(ids)).cpu().numpy()
    # sign of the centered value: decryption-valid plaintexts satisfy
    # |m + t·e| << Q/2, so the top Garner digit is near 0 or near q_top
    neg = digits[..., -1, :] > mods[-1] // 2
    # fold mod each coprime factor of t, then CRT-compose (all exact)
    factors = ctx.params.plain_factors
    per_factor = []
    for f in factors:
        acc = np.zeros(digits.shape[:-2] + digits.shape[-1:], np.uint64)
        w = 1
        for j, qj in enumerate(mods):
            wj = w % f
            if wj:
                acc = (acc + hm.mulmod_u64(digits[..., j, :].astype(np.uint64),
                                           np.broadcast_to(np.uint64(wj), acc.shape), f)
                       ) % np.uint64(f)
            w *= qj
        corr = w % f  # Q mod f
        acc = np.where(neg, (acc + np.uint64(f - corr)) % np.uint64(f), acc)
        per_factor.append(acc)
    return pt_from_values(ctx, _crt_compose_u64(per_factor, factors))


def decrypt_device(ctx: Context, ct: BgvCt, sk: rlwe_mod.RlweSk) -> BgvPt:
    """Fast decryption for t < 2^29: valid while the decryption noise
    |m + t·e| stays below q_0/2, where limb 0's signed residue mod t is
    exact; the rest is one elementwise pass on the ciphertext's device."""
    t = ct.plain_modulus
    if t >= (1 << 29):
        return decrypt(ctx, ct, sk)
    poly = rlwe_mod.decrypt_core(ctx, rlwe_mod.RlweCt(ct.c0, ct.c1), sk)
    q0 = ctx.mod_list[poly.limb_ids[0]]
    v = poly.data[..., 0, :]
    signed_mod_t = torch.where(v < q0 // 2, v % t, (v + (t - q0 % t)) % t)
    return pt_from_values(ctx, signed_mod_t.cpu().numpy().astype(np.uint64))


# ---------------------------------------------------------------------------
# Homomorphic ops
# ---------------------------------------------------------------------------


def add(ctx, a: BgvCt, b: BgvCt) -> BgvCt:
    _check_t(a, b)
    return BgvCt(rns.add(ctx, a.c0, b.c0), rns.add(ctx, a.c1, b.c1), a.plain_modulus)


def sub(ctx, a: BgvCt, b: BgvCt) -> BgvCt:
    _check_t(a, b)
    return BgvCt(rns.sub(ctx, a.c0, b.c0), rns.sub(ctx, a.c1, b.c1), a.plain_modulus)


def add_plain(ctx, ct: BgvCt, pt: BgvPt) -> BgvCt:
    _check_t(ct, pt)
    p = _pt_under_ct(ctx, pt, ct.limb_ids, ct.c0.data.device)
    return BgvCt(rns.add(ctx, ct.c0, p), ct.c1, ct.plain_modulus)


def sub_plain(ctx, ct: BgvCt, pt: BgvPt) -> BgvCt:
    _check_t(ct, pt)
    p = _pt_under_ct(ctx, pt, ct.limb_ids, ct.c0.data.device)
    return BgvCt(rns.sub(ctx, ct.c0, p), ct.c1, ct.plain_modulus)


def mult_plain(ctx, ct: BgvCt, pt: BgvPt) -> BgvCt:
    _check_t(ct, pt)
    p = _pt_under_ct(ctx, pt, ct.limb_ids, ct.c0.data.device)
    return BgvCt(rns.mul(ctx, ct.c0, p), rns.mul(ctx, ct.c1, p), ct.plain_modulus)


def mult_low_level(ctx, ct1: BgvCt, ct2: BgvCt) -> BgvQuadCt:
    """Tensor product to 3 components."""
    _check_t(ct1, ct2)
    ids = ct1.limb_ids
    dev = ct1.c0.data.device
    rows = lambda nm: ctx.device_rows(nm, ids, dev)  # noqa: E731
    q, two_q, neg_qinv = rows("q"), rows("two_q"), rows("neg_qinv")
    r, r_sh = rows("r_mod_q"), rows("r_shoup")
    b0 = ma.shoup_mul_lazy(ct2.c0.data, r, r_sh, q)
    b1 = ma.shoup_mul_lazy(ct2.c1.data, r, r_sh, q)
    a0, a1 = ct1.c0.data, ct1.c1.data
    p0 = ma.mont_mul_lazy(a0, b0, q, neg_qinv)
    p1 = ma.add_lazy(ma.mont_mul_lazy(a0, b1, q, neg_qinv),
                     ma.mont_mul_lazy(a1, b0, q, neg_qinv), two_q)
    p2 = ma.mont_mul_lazy(a1, b1, q, neg_qinv)
    mk = lambda d: RnsPoly(d, NTT, ids)  # noqa: E731
    return BgvQuadCt(mk(p0), mk(p1), mk(p2), ct1.plain_modulus)


def relinearize(ctx, quad: BgvQuadCt, rlk: rgsw_mod.RgswCt) -> BgvCt:
    """External product on c2, the BGV special-prime drop, and the add.
    `rlk` must be made with noise_scale=t (BGV keys carry t-multiple
    noise)."""
    t = quad.plain_modulus
    rlk_l = rlk.at_level(quad.c2.limb_count, ctx.num_special)
    d0, d1 = rgsw_mod.ext_prod(ctx, quad.c2, rlk_l)
    # the key-switched value is already special-prime-scaled: divide without
    # the (p mod t) plaintext-scale restore (basecnv.div_last_rounded)
    for _ in range(ctx.num_special):
        d0, d1 = basecnv.div_last_rounded_pair(ctx, d0, d1, plain_modulus=t,
                                               restore_plain_scale=False)
    return BgvCt(rns.add(ctx, d0, quad.c0), rns.add(ctx, d1, quad.c1), t)


def mult(ctx, ct1: BgvCt, ct2: BgvCt, rlk: rgsw_mod.RgswCt) -> BgvCt:
    """End-to-end ciphertext-ciphertext multiply."""
    return relinearize(ctx, mult_low_level(ctx, ct1, ct2), rlk)


def mod_switch(ctx, ct: BgvCt, dropping_primes: int = 1,
               restore_plain_scale: bool = True) -> BgvCt:
    """Drop trailing primes, dividing while keeping the value mod t
    (several primes by iteration).

    Each division leaves the plaintext times q_last^{-1} mod t, which the
    reference's switch restores by multiplying the ciphertext by
    (q_last mod t): that multiplies the noise by up to t as well, and on a
    last limb of 30 bits it overflows (examples/bgv_example.py's chain:
    2^22.6 becomes 2^38.1, above q_0/2). restore_plain_scale=False leaves
    the factor on the plaintext instead, for the caller to multiply the
    decrypted values by `plain_scale_dropped(ctx, ct, dropping_primes)`
    mod t."""
    c0, c1, t = ct.c0, ct.c1, ct.plain_modulus
    for _ in range(dropping_primes):
        c0, c1 = basecnv.div_last_rounded_pair(ctx, c0, c1, plain_modulus=t,
                                               restore_plain_scale=restore_plain_scale)
    return BgvCt(c0, c1, t)


def plain_scale_dropped(ctx, ct: BgvCt, dropping_primes: int = 1) -> int:
    """Π (q_last mod t) over the primes that mod_switch(ct, dropping_primes)
    drops: the factor mod t that restore_plain_scale=False leaves for the
    decrypted plaintext."""
    t = ct.plain_modulus
    scale = 1
    for lid in ct.limb_ids[len(ct.limb_ids) - dropping_primes:]:
        scale = scale * (ctx.mod_list[lid] % t) % t
    return scale
