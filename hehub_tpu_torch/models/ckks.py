"""CKKS: approximate-complex SIMD homomorphic encryption (port of
hehub_tpu/models/ckks.py: the two codecs and the ciphertext operations).

Both codecs rest on one n/2-point FFT per row (the X^{n/2} = √−1 identity
of _half_transform_tables). The device codec, taken by default for a CUDA
device (config.use_device_codec), runs it all on the card: encode gathers
the slots into the FFT's bit-reversed order, runs the FP64 FFT (kernel K5,
ops/fft.py), twists, scales, splits into balanced base-2^22 digits and
decomposes them into residues; decode runs the Garner conversion, the
balanced carry pass and the float64 evaluation there, then the FFT, and
copies the slots to the host once. It keeps the reference's gates (the
coefficient bound of its double-float32 FFT); outside them, and on the CPU,
the float64 host codec runs: FFT and exact digit split on the host, the
residue work on the device.

Ciphertext operations take the Context and run where the ciphertext's
tensors lie: on a CUDA device through the NTT, INTT and external-product
kernels, on the CPU through their plain versions. Beside the main path:
the scalar codec, rescale_auto / rescale_to (flexible scales),
rotate_accumulate (one special-prime division for a sum of rotations) and
hoisted_rotations (one digit decomposition for many rotations).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from hehub_tpu_torch import config
from hehub_tpu_torch.core import basecnv, galois, rns
from hehub_tpu_torch.core.context import CkksParams, Context, make_context
from hehub_tpu_torch.core.rns import COEFF, NTT, RnsPoly
from hehub_tpu_torch.native import loader
from hehub_tpu_torch.ops import fft as fftmod
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
    (rint and the int64 conversion are exact for |c| < 2^62), in one pass
    of the host C++ runtime: (digits uint32 [..., 3, n], neg uint32
    [..., n])."""
    return loader.digitize(np.ascontiguousarray(coeffs))


def _digitize_plain(coeffs: np.ndarray):
    """The numpy twin of _digitize."""
    x = np.rint(coeffs)
    if np.abs(x).max(initial=0.0) >= float(1 << 62):
        raise ValueError("encoded coefficients exceed 2^62; lower the scaling factor")
    return basecnv.digitize_signed(x.astype(np.int64))


def _encode_host(data: np.ndarray, n: int, scale: float):
    """Host half of encode: slot FFT + twist + scale + digit split ->
    (digits uint32 [..., 3, n], neg uint32 [..., n]); everything around the
    FFT is two passes of the host C++ runtime (gather and conjugation in;
    twist, rint and split out)."""
    invj, _, tw_enc, _ = _half_transform_tables(n)
    u = _fft(loader.encode_pre(_pad_slots(data, n), invj), axis=-1)
    return loader.encode_post(u, tw_enc, scale)


def _encode_host_plain(data: np.ndarray, n: int, scale: float):
    """The numpy twin of _encode_host."""
    return _digitize_plain(_coeffs_from_slots(data, n) * scale)


def _decode_host(coeffs: np.ndarray, n: int, scale: float, count: int):
    """Host half of decode: 1/scale + twist + slot iFFT -> complex slots,
    the passes around the iFFT in the host C++ runtime."""
    _, j, _, tw_dec = _half_transform_tables(n)
    vals = _ifft(loader.decode_pre(coeffs, tw_dec, scale), axis=-1)
    return loader.decode_post(vals, j, count)


def _decode_host_plain(coeffs: np.ndarray, n: int, scale: float, count: int):
    """The numpy twin of _decode_host."""
    return _slots_to_read(coeffs / scale, n, count)


# ---------------------------------------------------------------------------
# Device codec (FP64 FFT kernel K5)
# ---------------------------------------------------------------------------

# The reference's gates on its device codec, kept as they are: encode when
# every coefficient scale·max|z| is at most 2^43, decode when the scale is
# at most 2^43 and the value spans at most 3 limbs.
DEVICE_COEFF_BOUND = 2.0**43
DEVICE_DECODE_MAX_LIMBS = 3


@functools.lru_cache(maxsize=None)
def _enc_tables(n: int, device: str):
    """(perm, sign, tw_re, tw_im) on `device`: the gather of the slots into
    the FFT's bit-reversed input order, the sign of the imaginary parts
    (the odd slots are conjugated), and the twist ζ^{-k}/(n/2)."""
    invj, _, tw_enc, _ = _half_transform_tables(n)
    perm = invj[fftmod.bitrev_perm(n // 2)]
    sign = np.where(perm % 2 == 1, -1.0, 1.0)
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (perm, sign, tw_enc.real, tw_enc.imag))


@functools.lru_cache(maxsize=None)
def _dec_tables(n: int, count: int, device: str):
    """(br, tw_re, tw_im, out, odd_sign) on `device`: ifft(x) =
    conj(fft(conj(x)))/m, so the twist (n/2)·ζ^k is conjugated, divided by
    m = n/2 and gathered into bit-reversed order; `out` gathers the first
    `count` slots, and `odd_sign` gives their imaginary parts the sign of
    conj(...) with the odd slots conjugated once more."""
    half = n // 2
    _, j, _, tw_dec = _half_transform_tables(n)
    br = fftmod.bitrev_perm(half)
    t_br = np.conjugate(tw_dec)[br] / half
    odd_sign = np.where(np.arange(count) % 2 == 1, 1.0, -1.0)
    return tuple(torch.from_numpy(np.ascontiguousarray(t)).to(device)
                 for t in (br, t_br.real, t_br.imag, j[:count], odd_sign))


def _encode_device(ctx: Context, ids: Tuple[int, ...], data: np.ndarray, scale: float,
                   device) -> RnsPoly:
    """Slots [..., n/2] (complex128, host) -> coeff-form residues [..., L, n]
    on `device`: the host only copies the slots to the device."""
    n = ctx.params.dimension
    perm, sign, tw_re, tw_im = _enc_tables(n, str(torch.device(device)))
    z = torch.view_as_real(torch.from_numpy(data).to(device))
    ur, ui = fftmod.fft(z[..., 0][..., perm], z[..., 1][..., perm] * sign, n // 2)
    vr = (ur * tw_re - ui * tw_im) * scale
    vi = (ur * tw_im + ui * tw_re) * scale
    digits = fftmod.balanced_digits(torch.cat([vr, vi], dim=-1))
    return basecnv.decompose_balanced(ctx, digits, ids)


def _decode_device(ctx: Context, ids: Tuple[int, ...], data: torch.Tensor, scale: float,
                   k: int, count: int, probe: bool) -> Optional[np.ndarray]:
    """Residues [..., L, n] -> the first `count` complex slots (host
    complex128), all on the data's device but the final copy. With probe,
    the digit row k is the overflow sentinel: None when it is nonzero
    (the caller then decodes over the full chain on the host)."""
    n = ctx.params.dimension
    half = n // 2
    mods = ctx.moduli_of(ids)
    digits = basecnv.to_mixed_radix(ctx, data, ids, k + 1 if probe else k)
    # balanced carry pass and Σ bal_j·∏_{m<j} q_m, as _mixed_radix_to_float
    carry = torch.zeros_like(digits[..., 0, :])
    value = torch.zeros(carry.shape, dtype=torch.float64, device=data.device)
    weight = 1.0
    for j in range(digits.shape[-2]):
        q = int(mods[j])
        dj = digits[..., j, :] + carry
        carry = (dj > q // 2).to(torch.int64)
        bal = dj - carry * q
        if j == k:
            if bool(bal.any()):
                return None
        else:
            value = value + bal.to(torch.float64) * weight
            weight *= float(q)
    br, tw_re, tw_im, out, odd_sign = _dec_tables(n, count, str(data.device))
    # times 1/scale, as the reference does: PyTorch on the card turns a
    # division by a scalar into this product, on the CPU it does not
    inv_scale = 1.0 / scale
    ur = (value[..., :half] * inv_scale)[..., br]
    ui = -(value[..., half:] * inv_scale)[..., br]
    vr, vi = fftmod.fft(ur * tw_re - ui * tw_im, ur * tw_im + ui * tw_re, half)
    slots = torch.stack([vr[..., out], vi[..., out] * odd_sign], dim=-1)
    return torch.view_as_complex(slots).cpu().numpy()


def device_encode_selected(max_abs: float, scale: float, device) -> bool:
    """Does `encode` take the device codec for slots of magnitude at most
    `max_abs` at `scale` on `device`?"""
    return (config.device_codec_selected(device)
            and scale * max(max_abs, 1.0) <= DEVICE_COEFF_BOUND)


def encode(data, params: CkksParams, scaling_factor: Optional[float] = None,
           level: int = 0, *, device="cuda") -> CkksPt:
    """SIMD-encode up to n/2 complex numbers per row of `data` ([..., slots])
    into a plaintext [..., L, n] on `device`. `level`=k drops the last k
    limbs. The device codec runs when selected (config.use_device_codec)
    and every coefficient is at most DEVICE_COEFF_BOUND; the float64 host
    codec otherwise, exact for coefficient magnitudes up to 2^62."""
    ctx = make_context(params)
    n = params.dimension
    scale = scaling_factor or params.initial_scaling_factor
    data = np.atleast_1d(np.asarray(data, dtype=np.complex128))
    if data.shape[-1] > n // 2:
        raise ValueError(f"can encode at most {n // 2} slots")
    ids = tuple(range(len(params.moduli) - level))
    if device_encode_selected(float(np.abs(data).max(initial=0.0)), scale, device):
        return CkksPt(_encode_device(ctx, ids, _pad_slots(data, n), scale, device), float(scale))
    digits, neg = _encode_host(data, n, scale)
    poly = basecnv.decompose_digits(
        ctx,
        torch.from_numpy(digits.astype(np.int64)).to(device),
        torch.from_numpy(neg.astype(np.int64)).to(device),
        ids,
    )
    return CkksPt(poly, float(scale))


def encode_scalar(value, params: CkksParams, scaling_factor: Optional[float] = None,
                  level: int = 0, *, device="cuda") -> CkksPt:
    """One number replicated into every slot; decode_scalar averages the
    slots back."""
    return encode(np.full(params.dimension // 2, complex(value)), params, scaling_factor, level,
                  device=device)


def decode_scalar(pt: CkksPt, params: CkksParams, limbs: Optional[int] = None) -> complex:
    """The mean of all slots: the inverse of encode_scalar."""
    return complex(np.mean(decode(pt, params, limbs=limbs), axis=-1))


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
    digit carry pass, in one pass of the host C++ runtime. split_top=True:
    the last digit row is an overflow sentinel, returned as (value,
    balanced top digits), the digits None when they are all zero."""
    return loader.mixed_radix(digits, mods, split_top)


def _mixed_radix_to_float_plain(digits: np.ndarray, mods, split_top: bool = False):
    """The numpy twin of _mixed_radix_to_float (its top digits are an
    array, zero or not)."""
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
    """Complex slots [..., count] of a coeff-form plaintext, from the value
    over the first K limbs (K from the scaling factor, or `limbs`); one
    extra limb serves as an overflow sentinel, and a nonzero sentinel
    re-decodes over the full chain on the host. The device codec runs when
    selected (config.use_device_codec), K <= DEVICE_DECODE_MAX_LIMBS and the
    scale is at most DEVICE_COEFF_BOUND; otherwise the Garner digits go to
    the host for the float64 evaluation and slot FFT."""
    ctx = make_context(params)
    n = params.dimension
    count = count or n // 2
    poly = pt.poly
    if poly.form != COEFF:
        raise ValueError("decode expects coeff form")
    mods = ctx.moduli_of(poly.limb_ids)
    K = min(limbs or decode_limb_count(pt.scaling_factor, poly.limb_ids, mods), len(mods))
    probe = limbs is None and K < len(mods)
    if (config.device_codec_selected(poly.data.device) and K <= DEVICE_DECODE_MAX_LIMBS
            and pt.scaling_factor <= DEVICE_COEFF_BOUND):
        slots = _decode_device(ctx, poly.limb_ids, poly.data, pt.scaling_factor, K, count, probe)
        if slots is not None:
            return slots
        coeffs = _mixed_radix_to_float(_garner(ctx, poly, len(mods)), mods)
    elif probe:
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
    """Tensor product to 3 components (ops.modarith.tensor_product: one
    kernel on the card)."""
    ids = ct1.limb_ids
    dev = ct1.c0.data.device
    consts = (ctx.device_rows(nm, ids, dev) for nm in ("q", "two_q", "neg_qinv", "r_mod_q",
                                                       "r_shoup"))
    p = ma.tensor_product(ct1.c0.data, ct1.c1.data, ct2.c0.data, ct2.c1.data, *consts)
    return CkksQuadCt(*(RnsPoly(d, NTT, ids) for d in p), ct1.scaling_factor * ct2.scaling_factor)


def _div_special(ctx, d0: RnsPoly, d1: RnsPoly):
    """Both halves from the extended limbs back to the ciphertext limbs:
    the special-prime division(s), with rounding."""
    return basecnv.div_last_rounded_many(ctx, d0, d1, ctx.num_special)


def _key_switch(ctx, poly: RnsPoly, ksk: rgsw_mod.RgswCt):
    """ext_prod under the key restricted to the poly's level, then the
    special-prime division(s)."""
    return _div_special(ctx, *rgsw_mod.ext_prod(ctx, poly, ksk.at_level(poly.limb_count,
                                                                         ctx.num_special)))


def relinearize(ctx, quad: CkksQuadCt, rlk: rgsw_mod.RgswCt) -> CkksCt:
    """ext_prod on c2 + special-prime rescale + add."""
    d0, d1 = _key_switch(ctx, quad.c2, rlk)
    return CkksCt(rns.add(ctx, d0, quad.c0), rns.add(ctx, d1, quad.c1), quad.scaling_factor)


def mult(ctx, ct1: CkksCt, ct2: CkksCt, rlk: rgsw_mod.RgswCt) -> CkksCt:
    return relinearize(ctx, mult_low_level(ctx, ct1, ct2), rlk)


def rescale(ctx, ct: CkksCt, dropping_primes: int = 1) -> CkksCt:
    """Drop trailing ciphertext primes with exact rounding, dividing the
    scaling factor."""
    ids = ct.c0.limb_ids
    c0, c1 = basecnv.div_last_rounded_many(ctx, ct.c0, ct.c1, dropping_primes)
    scale = ct.scaling_factor
    for i in reversed(ids[len(ids) - dropping_primes:]):
        scale /= ctx.mod_list[i]
    return CkksCt(c0, c1, scale)


def rescale_auto(ctx, ct: CkksCt, min_scale: Optional[float] = None) -> CkksCt:
    """Drop as many trailing primes as keep the scaling factor at least
    `min_scale` (default: the initial scaling factor); with limbs that do
    not divide the scale it drifts within [min_scale, min_scale·q)."""
    if min_scale is None:
        min_scale = ctx.params.initial_scaling_factor
    scale = ct.scaling_factor
    drops = 0
    level = ct.c0.limb_count
    while drops < level - 1:
        q_last = ctx.mod_list[ct.c0.limb_ids[level - 1 - drops]]
        if scale / q_last < min_scale:
            break
        scale /= q_last
        drops += 1
    return rescale(ctx, ct, drops) if drops else ct


def rescale_to(ctx, ct: CkksCt, target: float) -> CkksCt:
    """Drop the number of trailing primes that brings the scaling factor
    closest to `target` in log distance."""
    level = ct.c0.limb_count
    best_k, best_d = 0, abs(math.log2(ct.scaling_factor / target))
    cur = ct.scaling_factor
    for k in range(1, level):
        cur /= ctx.mod_list[ct.c0.limb_ids[level - k]]
        d = abs(math.log2(cur / target))
        if d < best_d:
            best_k, best_d = k, d
        elif cur < target:
            break
    return rescale(ctx, ct, best_k) if best_k else ct


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


def switch_key(ctx, ct: CkksCt, ksk: rgsw_mod.RgswCt) -> CkksCt:
    """The ciphertext under the key's target secret: the key switch of c1,
    plus c0. The key may cover only the ciphertext's limbs and the special
    primes (keys.ksk_gen's `chain_limbs`)."""
    d0, d1 = _key_switch(ctx, ct.c1, ksk)
    return CkksCt(rns.add(ctx, d0, ct.c0), d1, ct.scaling_factor)


def rotate(ctx, ct: CkksCt, rk: rgsw_mod.RgswCt, step: int) -> CkksCt:
    """Slot rotation (slot i moves to slot i+step): Galois gather + key
    switch."""
    r0, r1 = galois.cycle(ct.c0, step), galois.cycle(ct.c1, step)
    d0, d1 = _key_switch(ctx, r1, rk)
    return CkksCt(rns.add(ctx, d0, r0), d1, ct.scaling_factor)


def rotate_accumulate(ctx, terms: Sequence[Tuple[CkksCt, int]],
                      rot_keys: Dict[int, rgsw_mod.RgswCt]) -> CkksCt:
    """Σ_g rotate(ct_g, step_g) with one special-prime division: every
    nonzero-step term is key-switched into the extended basis, the sum is
    divided once, and the step-0 terms are added after. The terms share
    limbs and scaling factor."""
    if not terms:
        raise ValueError("rotate_accumulate needs at least one term")
    level = terms[0][0].c0.limb_count
    scale = terms[0][0].scaling_factor
    ext0 = ext1 = None  # accumulated key-switch halves, extended basis
    base0 = base1 = None  # step-0 terms and rotated c0 parts, ciphertext limbs
    for ct, step in terms:
        if abs(ct.scaling_factor - scale) > 1e-6 * scale:
            raise ValueError("rotate_accumulate terms must share the scale")
        if step % ct.c1.dimension == 0:
            base0 = ct.c0 if base0 is None else rns.add(ctx, base0, ct.c0)
            base1 = ct.c1 if base1 is None else rns.add(ctx, base1, ct.c1)
            continue
        r0, r1 = galois.cycle(ct.c0, step), galois.cycle(ct.c1, step)
        d = rgsw_mod.ext_prod(ctx, r1, rot_keys[step].at_level(level, ctx.num_special))
        ext0 = d.c0 if ext0 is None else rns.add(ctx, ext0, d.c0)
        ext1 = d.c1 if ext1 is None else rns.add(ctx, ext1, d.c1)
        base0 = r0 if base0 is None else rns.add(ctx, base0, r0)
    if ext0 is None:
        return CkksCt(base0, base1, scale)
    ext0, ext1 = _div_special(ctx, ext0, ext1)
    c0 = ext0 if base0 is None else rns.add(ctx, ext0, base0)
    c1 = ext1 if base1 is None else rns.add(ctx, ext1, base1)
    return CkksCt(c0, c1, scale)


def hoisted_rotations(ctx, ct: CkksCt, rot_keys: Dict[int, rgsw_mod.RgswCt],
                      steps: Sequence[int]) -> Dict[int, CkksCt]:
    """Rotations of one ciphertext by each of `steps`, sharing one key-switch
    digit decomposition (ks_digits: on the card the digit NTTs are one K1
    launch on [..., D, L_ext, n]). A rotation acts on NTT values as a
    gather, so the gathered digits are a digit vector of cycle(c1); each
    step then takes the gather, the Montgomery contraction against its key
    (ks_contract, plain PyTorch on either device) and the special-prime
    division. Not bitwise equal to rotate(): the gathered digits are other
    residue representatives, with the same noise."""
    out: Dict[int, CkksCt] = {}
    steps = list(steps)
    if not steps:
        return out
    level = ct.c1.limb_count
    digits = rgsw_mod.ks_digits(ctx, ct.c1, rot_keys[steps[0]].at_level(level, ctx.num_special))
    for st in steps:
        k = rot_keys[st].at_level(level, ctx.num_special)
        rgsw_mod.count_key_switch()
        d0, d1 = _div_special(ctx, *rgsw_mod.ks_contract(ctx, galois.cycle_values(digits, st), k))
        out[st] = CkksCt(rns.add(ctx, d0, galois.cycle(ct.c0, st)), d1, ct.scaling_factor)
    return out
