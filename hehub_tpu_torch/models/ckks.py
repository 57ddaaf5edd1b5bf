"""CKKS: approximate-complex SIMD homomorphic encryption (port of
hehub_tpu/models/ckks.py: the host codec and the ciphertext operations).

Encoding runs the float64 host codec of the JAX package: one n/2-point FFT
per batch (the X^{n/2} = √−1 identity) and an exact base-2^22 digit split
on the host, then the residue decomposition on the device. Decoding runs
the Garner mixed-radix conversion on the device, copies the K digit rows
to the host, and evaluates them in float64 before the inverse slot FFT.
The JAX package also has a double-float32 device codec (Pallas kernel K5);
it is not ported yet (ROADMAP.md, slice 2).

Ciphertext operations take the Context and run where the ciphertext's
tensors lie: on a CUDA device through the NTT, INTT and external-product
kernels, on the CPU through their plain versions.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from hehub_tpu_torch.core import basecnv, galois, rns
from hehub_tpu_torch.core.context import CkksParams, Context, make_context
from hehub_tpu_torch.core.rns import COEFF, NTT, RnsPoly
from hehub_tpu_torch.ops import modarith as ma
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod

SCALE_EPS = 2.0**-40


@dataclasses.dataclass(frozen=True, eq=False)
class CkksPt:
    poly: RnsPoly
    scaling_factor: float


@dataclasses.dataclass(frozen=True, eq=False)
class CkksCt:
    c0: RnsPoly
    c1: RnsPoly
    scaling_factor: float

    @property
    def limb_ids(self):
        return self.c0.limb_ids

    @property
    def level(self):
        return self.c0.limb_count


@dataclasses.dataclass(frozen=True, eq=False)
class CkksQuadCt:
    """3-component ciphertext before relinearization."""

    c0: RnsPoly
    c1: RnsPoly
    c2: RnsPoly
    scaling_factor: float


def _check_scale(a, b):
    if abs(a.scaling_factor - b.scaling_factor) > SCALE_EPS * max(a.scaling_factor, 1.0):
        raise ValueError(f"scaling factors mismatch: {a.scaling_factor} vs {b.scaling_factor}")


# ---------------------------------------------------------------------------
# Host codec (float64)
# ---------------------------------------------------------------------------


try:  # scipy's pocketfft threads across batched rows with workers=-1
    from scipy.fft import fft as _sfft, ifft as _sifft

    def _fft(a, axis=-1):
        return _sfft(a, axis=axis, workers=-1)

    def _ifft(a, axis=-1):
        return _sifft(a, axis=axis, workers=-1)

except ImportError:  # pragma: no cover
    _fft, _ifft = np.fft.fft, np.fft.ifft


@functools.lru_cache(maxsize=None)
def _half_transform_tables(n: int):
    """Tables of the half-size encode/decode transform: p = A + B·X^{n/2}
    is one complex vector u = a + i·b, and conjugating the odd slots puts
    every evaluation point on a root of X^{n/2} = i, so encode is one
    n/2-point FFT. Returns (invj, j, tw_enc, tw_dec)."""
    half = n // 2
    j = np.empty(half, np.int64)
    t = 1
    for i in range(half):
        j[i] = (t - 1) // 4
        t = t * (2 * n - 3) % (2 * n)
    invj = np.empty(half, np.int64)
    invj[j] = np.arange(half)
    tw_enc = np.exp(-1j * np.pi * np.arange(half) / n) / half
    tw_dec = half * np.exp(1j * np.pi * np.arange(half) / n)
    return invj, j, tw_enc, tw_dec


def _pad_slots(data: np.ndarray, n: int) -> np.ndarray:
    half = n // 2
    if data.shape[-1] < half:
        padded = np.zeros((*data.shape[:-1], half), dtype=np.complex128)
        padded[..., : data.shape[-1]] = data
        data = padded
    return data


def _coeffs_from_slots(data: np.ndarray, n: int) -> np.ndarray:
    """Complex slot values [..., k] -> real negacyclic coefficients [..., n]
    (float64), batched over leading dims."""
    data = _pad_slots(data, n)
    invj, _, tw_enc, _ = _half_transform_tables(n)
    y = data.copy()
    np.conjugate(y[..., 1::2], out=y[..., 1::2])
    u = _fft(y[..., invj], axis=-1) * tw_enc
    return np.concatenate([u.real, u.imag], axis=-1)


def _slots_to_read(coeffs: np.ndarray, n: int, count: int) -> np.ndarray:
    """Real negacyclic coefficients [..., n] -> the first `count` complex
    slots: the exact inverse of _coeffs_from_slots."""
    half = n // 2
    _, j, _, tw_dec = _half_transform_tables(n)
    u = coeffs[..., :half] + 1j * coeffs[..., half:]
    y = _ifft(u * tw_dec, axis=-1)[..., j[:count]]
    np.conjugate(y[..., 1::2], out=y[..., 1::2])
    return y


def _digitize(coeffs: np.ndarray):
    """Exact base-2^22 digit split of integer-valued float64 coefficients
    (rint and the int64 conversion are exact for |c| < 2^62)."""
    x = np.rint(coeffs)
    if np.abs(x).max(initial=0.0) >= float(1 << 62):
        raise ValueError("encoded coefficients exceed 2^62; lower the scaling factor")
    return basecnv.digitize_signed(x.astype(np.int64))


def _encode_host(data: np.ndarray, n: int, scale: float):
    """Host half of encode: slot FFT + twist + scale + digit split ->
    (digits uint32 [..., 3, n], neg uint32 [..., n])."""
    return _digitize(_coeffs_from_slots(data, n) * scale)


def _decode_host(coeffs: np.ndarray, n: int, scale: float, count: int):
    """Host half of decode: 1/scale + twist + slot iFFT -> complex slots."""
    return _slots_to_read(coeffs / scale, n, count)


def encode(data, params: CkksParams, scaling_factor: Optional[float] = None,
           level: int = 0, *, device) -> CkksPt:
    """SIMD-encode up to n/2 complex numbers per row of `data` ([..., slots])
    into a plaintext [..., L, n] on `device`. `level`=k drops the last k
    limbs. Coefficient magnitudes up to 2^62 are exact."""
    ctx = make_context(params)
    n = params.dimension
    scale = scaling_factor or params.initial_scaling_factor
    data = np.atleast_1d(np.asarray(data, dtype=np.complex128))
    if data.shape[-1] > n // 2:
        raise ValueError(f"can encode at most {n // 2} slots")
    ids = tuple(range(len(params.moduli) - level))
    digits, neg = _encode_host(data, n, scale)
    poly = basecnv.decompose_digits(
        ctx,
        torch.from_numpy(digits.astype(np.int64)).to(device),
        torch.from_numpy(neg.astype(np.int64)).to(device),
        ids,
    )
    return CkksPt(poly, float(scale))


def decode_limb_count(scale: float, limbs: Tuple[int, ...], moduli,
                      max_magnitude: float = 2.0**8) -> int:
    """Smallest K with ∏_{j<K} q_j above 2·scale·max|z| with 2^12 slack;
    `decode` checks the bound with a sentinel limb and re-decodes over the
    full chain when it does not hold."""
    need = math.log2(max(scale, 1.0)) + math.log2(max(max_magnitude, 1.0)) + 13.0
    acc = 0.0
    for k, q in enumerate(moduli):
        acc += math.log2(q)
        if acc >= need:
            return k + 1
    return len(moduli)


def _mixed_radix_to_float(digits: np.ndarray, mods, split_top: bool = False):
    """Centered float64 value of Garner digits [..., K, n] via a balanced-
    digit carry pass. split_top=True: the last digit row is an overflow
    sentinel, returned as (value, balanced top digits)."""
    K = digits.shape[-2]
    d = digits.astype(np.int64)
    carry = np.zeros(d.shape[:-2] + d.shape[-1:], np.int64)
    out = np.zeros(d.shape[:-2] + d.shape[-1:], np.float64)
    top = None
    weight = 1.0
    for j in range(K):
        q = int(mods[j])
        dj = d[..., j, :] + carry
        carry = (dj > q // 2).astype(np.int64)
        bal = dj - carry * q
        if split_top and j == K - 1:
            top = bal
        else:
            out += bal.astype(np.float64) * weight
            weight *= float(q)
    # a final carry out of the top digit is the mod-∏q wrap: drop it
    return (out, top) if split_top else out


def _garner(ctx: Context, poly: RnsPoly, k: int) -> np.ndarray:
    return basecnv.to_mixed_radix(ctx, poly.data, poly.limb_ids, k).cpu().numpy()


def decode(pt: CkksPt, params: CkksParams, count: Optional[int] = None,
           limbs: Optional[int] = None) -> np.ndarray:
    """Complex slots [..., count] of a coeff-form plaintext. Garner digits
    over the first K limbs on the device (K from the scaling factor, or
    `limbs`), float64 evaluation and slot FFT on the host; one extra limb
    serves as an overflow sentinel, and a nonzero sentinel re-decodes over
    the full chain."""
    ctx = make_context(params)
    n = params.dimension
    count = count or n // 2
    poly = pt.poly
    if poly.form != COEFF:
        raise ValueError("decode expects coeff form")
    mods = ctx.moduli_of(poly.limb_ids)
    K = min(limbs or decode_limb_count(pt.scaling_factor, poly.limb_ids, mods), len(mods))
    if limbs is None and K < len(mods):
        coeffs, top = _mixed_radix_to_float(_garner(ctx, poly, K + 1), mods[: K + 1],
                                            split_top=True)
        if np.any(top):
            coeffs = _mixed_radix_to_float(_garner(ctx, poly, len(mods)), mods)
    else:
        coeffs = _mixed_radix_to_float(_garner(ctx, poly, K), mods[:K])
    return _decode_host(coeffs, n, pt.scaling_factor, count)


# ---------------------------------------------------------------------------
# Encrypt / decrypt and homomorphic arithmetic
# ---------------------------------------------------------------------------


def encrypt(ctx: Context, pt: CkksPt, sk: rlwe_mod.RlweSk, gen: torch.Generator,
            **dbg) -> CkksCt:
    ct = rlwe_mod.encrypt_core(ctx, pt.poly, sk, gen, **dbg)
    return CkksCt(ct.c0, ct.c1, pt.scaling_factor)


def decrypt(ctx: Context, ct: CkksCt, sk: rlwe_mod.RlweSk) -> CkksPt:
    pt = rlwe_mod.decrypt_core(ctx, rlwe_mod.RlweCt(ct.c0, ct.c1), sk)
    return CkksPt(pt, ct.scaling_factor)


def add(ctx, ct1: CkksCt, ct2: CkksCt) -> CkksCt:
    _check_scale(ct1, ct2)
    return CkksCt(rns.add(ctx, ct1.c0, ct2.c0), rns.add(ctx, ct1.c1, ct2.c1),
                  ct1.scaling_factor)


def sub(ctx, ct1: CkksCt, ct2: CkksCt) -> CkksCt:
    _check_scale(ct1, ct2)
    return CkksCt(rns.sub(ctx, ct1.c0, ct2.c0), rns.sub(ctx, ct1.c1, ct2.c1),
                  ct1.scaling_factor)


def _pt_ntt(ctx, pt: CkksPt) -> RnsPoly:
    return rns.to_ntt(ctx, pt.poly) if pt.poly.form == COEFF else pt.poly


def add_plain(ctx, ct: CkksCt, pt: CkksPt) -> CkksCt:
    _check_scale(ct, pt)
    out = rlwe_mod.add_plain_core(ctx, rlwe_mod.RlweCt(ct.c0, ct.c1), _pt_ntt(ctx, pt))
    return CkksCt(out.c0, out.c1, ct.scaling_factor)


def sub_plain(ctx, ct: CkksCt, pt: CkksPt) -> CkksCt:
    _check_scale(ct, pt)
    out = rlwe_mod.sub_plain_core(ctx, rlwe_mod.RlweCt(ct.c0, ct.c1), _pt_ntt(ctx, pt))
    return CkksCt(out.c0, out.c1, ct.scaling_factor)


def mult_plain(ctx, ct: CkksCt, pt: CkksPt) -> CkksCt:
    out = rlwe_mod.mult_plain_core(ctx, rlwe_mod.RlweCt(ct.c0, ct.c1), _pt_ntt(ctx, pt))
    return CkksCt(out.c0, out.c1, ct.scaling_factor * pt.scaling_factor)


def mult_low_level(ctx, ct1: CkksCt, ct2: CkksCt) -> CkksQuadCt:
    """Tensor product to 3 components: ct2 is scaled into the Montgomery
    domain once, then the 4 cross products are single Montgomery multiplies."""
    ids = ct1.limb_ids
    dev = ct1.c0.data.device
    q, two_q, neg_qinv, r, r_sh = (
        ctx.device_rows(nm, ids, dev) for nm in ("q", "two_q", "neg_qinv", "r_mod_q", "r_shoup")
    )
    b0 = ma.shoup_mul_lazy(ct2.c0.data, r, r_sh, q)
    b1 = ma.shoup_mul_lazy(ct2.c1.data, r, r_sh, q)
    a0, a1 = ct1.c0.data, ct1.c1.data
    p0 = ma.mont_mul_lazy(a0, b0, q, neg_qinv)
    p1 = ma.add_lazy(
        ma.mont_mul_lazy(a0, b1, q, neg_qinv), ma.mont_mul_lazy(a1, b0, q, neg_qinv), two_q
    )
    p2 = ma.mont_mul_lazy(a1, b1, q, neg_qinv)
    return CkksQuadCt(RnsPoly(p0, NTT, ids), RnsPoly(p1, NTT, ids), RnsPoly(p2, NTT, ids),
                      ct1.scaling_factor * ct2.scaling_factor)


def _key_switch(ctx, poly: RnsPoly, ksk: rgsw_mod.RgswCt):
    """ext_prod under the key restricted to the poly's level, then the
    special-prime division(s)."""
    d0, d1 = rgsw_mod.ext_prod(ctx, poly, ksk.at_level(poly.limb_count, ctx.num_special))
    for _ in range(ctx.num_special):
        d0, d1 = basecnv.div_last_rounded_pair(ctx, d0, d1)
    return d0, d1


def relinearize(ctx, quad: CkksQuadCt, rlk: rgsw_mod.RgswCt) -> CkksCt:
    """ext_prod on c2 + special-prime rescale + add."""
    d0, d1 = _key_switch(ctx, quad.c2, rlk)
    return CkksCt(rns.add(ctx, d0, quad.c0), rns.add(ctx, d1, quad.c1), quad.scaling_factor)


def mult(ctx, ct1: CkksCt, ct2: CkksCt, rlk: rgsw_mod.RgswCt) -> CkksCt:
    return relinearize(ctx, mult_low_level(ctx, ct1, ct2), rlk)


def rescale(ctx, ct: CkksCt, dropping_primes: int = 1) -> CkksCt:
    """Drop trailing ciphertext primes with exact rounding, dividing the
    scaling factor."""
    c0, c1, scale = ct.c0, ct.c1, ct.scaling_factor
    for _ in range(dropping_primes):
        q_last = ctx.mod_list[c0.limb_ids[-1]]
        c0, c1 = basecnv.div_last_rounded_pair(ctx, c0, c1)
        scale /= q_last
    return CkksCt(c0, c1, scale)


def mod_drop(ctx, ct: CkksCt, count: int = 1) -> CkksCt:
    """Drop limbs WITHOUT dividing (level alignment)."""
    return CkksCt(
        RnsPoly(ct.c0.data[..., :-count, :], ct.c0.form, ct.c0.limb_ids[:-count]),
        RnsPoly(ct.c1.data[..., :-count, :], ct.c1.form, ct.c1.limb_ids[:-count]),
        ct.scaling_factor,
    )


def conjugate(ctx, ct: CkksCt, ck: rgsw_mod.RgswCt) -> CkksCt:
    i0, i1 = galois.involution(ct.c0), galois.involution(ct.c1)
    d0, d1 = _key_switch(ctx, i1, ck)
    return CkksCt(rns.add(ctx, d0, i0), d1, ct.scaling_factor)


def rotate(ctx, ct: CkksCt, rk: rgsw_mod.RgswCt, step: int) -> CkksCt:
    """Slot rotation (slot i moves to slot i+step): Galois gather + key
    switch."""
    r0, r1 = galois.cycle(ct.c0, step), galois.cycle(ct.c1, step)
    d0, d1 = _key_switch(ctx, r1, rk)
    return CkksCt(rns.add(ctx, d0, r0), d1, ct.scaling_factor)
