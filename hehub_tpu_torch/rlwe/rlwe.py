"""RLWE primitives (port of hehub_tpu/rlwe/rlwe.py).

A ciphertext is a pair of RnsPoly in NTT (value) form. A secret key is a
ternary polynomial kept as its coefficients and as strict NTT residues with
Shoup companions over every context limb, so each c1·s product is one
Shoup multiply against key constants.

The debug "no-noise" modes (zero c1, zero e) are runtime booleans.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from hehub_tpu_torch.core import rns, sampling
from hehub_tpu_torch.core.context import Context
from hehub_tpu_torch.core.rns import NTT, RnsPoly
from hehub_tpu_torch.ops import modarith as ma


class RlweCt(NamedTuple):
    """(c0, c1), both NTT form."""

    c0: RnsPoly
    c1: RnsPoly

    @property
    def limb_ids(self):
        return self.c0.limb_ids


@dataclasses.dataclass(frozen=True, eq=False)
class RlweSk:
    """Ternary secret key. `coeffs`: int8 [n]; `ntt`/`ntt_sh`: int64 [M, n]
    strict NTT residues + Shoup companions over all context limbs, on the
    key's device."""

    coeffs: torch.Tensor
    ntt: torch.Tensor
    ntt_sh: torch.Tensor

    def rows(self, limb_ids: Tuple[int, ...]):
        idx = torch.as_tensor(limb_ids, dtype=torch.long, device=self.ntt.device)
        return self.ntt.index_select(0, idx), self.ntt_sh.index_select(0, idx)


def sk_from_coeffs(ctx: Context, tern: torch.Tensor) -> RlweSk:
    """Secret key from ternary coefficients [n] (int8, on the key's device):
    NTT residues and Shoup companions over every context limb."""
    all_ids = tuple(range(len(ctx.mod_list)))
    poly = sampling.lift_signed_small(tern, ctx, all_ids)
    sk_ntt = rns.reduce_strict(ctx, rns.to_ntt(ctx, RnsPoly(poly, rns.COEFF, all_ids))).data
    qs = ctx.device_rows("q", all_ids, tern.device)
    return RlweSk(coeffs=tern, ntt=sk_ntt, ntt_sh=(sk_ntt << 32) // qs)


def keygen(ctx: Context, gen: torch.Generator, hamming_weight: Optional[int] = None) -> RlweSk:
    """Sample a ternary secret on the generator's device and precompute its
    NTT/Shoup tables. `hamming_weight`: a SPARSE ternary secret with exactly
    that many nonzero (±1) coefficients."""
    n = ctx.params.dimension
    dev = gen.device
    if hamming_weight is None:
        tern = torch.randint(-1, 2, (n,), generator=gen, device=dev)
    else:
        h = int(hamming_weight)
        if not 0 < h <= n:
            raise ValueError(f"hamming weight {h} out of range (0, {n}]")
        pos = torch.randperm(n, generator=gen, device=dev)[:h]
        signs = torch.randint(0, 2, (h,), generator=gen, device=dev) * 2 - 1
        tern = torch.zeros(n, dtype=torch.int64, device=dev)
        tern[pos] = signs
    return sk_from_coeffs(ctx, tern.to(torch.int8))


def mul_by_sk(ctx: Context, poly: RnsPoly, sk: RlweSk) -> RnsPoly:
    """poly * sk on NTT values via a key-constant Shoup multiply."""
    if poly.form != NTT:
        raise ValueError("expected NTT form")
    w, w_sh = sk.rows(poly.limb_ids)
    q = ctx.device_rows("q", poly.limb_ids, poly.data.device)
    return poly.with_data(ma.shoup_mul_lazy(poly.data, w, w_sh, q))


def rlwe_sample(
    ctx: Context,
    sk: RlweSk,
    gen: torch.Generator,
    limb_ids: Tuple[int, ...],
    batch_shape=(),
    noise_scale: Optional[int] = None,
    debug_zero_c1: bool = False,
    debug_zero_e: bool = False,
) -> RlweCt:
    """Fresh encryption of zero: (c0, c1) = (e - c1*s, c1). `noise_scale`
    multiplies both halves by a constant: the BGV noise lift by t."""
    dev = gen.device
    if debug_zero_c1:
        c1 = sampling.zero_poly(ctx, limb_ids, dev, batch_shape)
    else:
        c1 = sampling.uniform_poly(ctx, gen, limb_ids, batch_shape, form=NTT)
    if debug_zero_e:
        e = sampling.zero_poly(ctx, limb_ids, dev, batch_shape)
    else:
        e = sampling.gaussian_poly(ctx, gen, limb_ids, batch_shape)
    c0 = rns.sub(ctx, e, mul_by_sk(ctx, c1, sk))
    if noise_scale is not None and noise_scale != 1:
        c0 = rns.mul_scalar(ctx, c0, noise_scale)
        c1 = rns.mul_scalar(ctx, c1, noise_scale)
    return RlweCt(c0, c1)


def encrypt_core(ctx: Context, pt: RnsPoly, sk: RlweSk, gen: torch.Generator, **dbg) -> RlweCt:
    """Encrypt a coeff-form plaintext."""
    if pt.form != rns.COEFF:
        raise ValueError("plaintext must be in coeff form")
    pt_ntt = rns.to_ntt(ctx, pt)
    c0, c1 = rlwe_sample(ctx, sk, gen, pt.limb_ids, pt.batch_shape, **dbg)
    return RlweCt(rns.add(ctx, c0, pt_ntt), c1)


def decrypt_core(ctx: Context, ct: RlweCt, sk: RlweSk) -> RnsPoly:
    """pt = c0 + c1*s, back to coeff form, strict."""
    pt = rns.add(ctx, ct.c0, mul_by_sk(ctx, ct.c1, sk))
    return rns.reduce_strict(ctx, rns.to_coeff(ctx, pt))


def add(ctx, a: RlweCt, b: RlweCt) -> RlweCt:
    return RlweCt(rns.add(ctx, a.c0, b.c0), rns.add(ctx, a.c1, b.c1))


def sub(ctx, a: RlweCt, b: RlweCt) -> RlweCt:
    return RlweCt(rns.sub(ctx, a.c0, b.c0), rns.sub(ctx, a.c1, b.c1))


def add_plain_core(ctx, ct: RlweCt, pt_ntt: RnsPoly) -> RlweCt:
    return RlweCt(rns.add(ctx, ct.c0, pt_ntt), ct.c1)


def sub_plain_core(ctx, ct: RlweCt, pt_ntt: RnsPoly) -> RlweCt:
    return RlweCt(rns.sub(ctx, ct.c0, pt_ntt), ct.c1)


def mult_plain_core(ctx, ct: RlweCt, pt_ntt: RnsPoly) -> RlweCt:
    return RlweCt(rns.mul(ctx, ct.c0, pt_ntt), rns.mul(ctx, ct.c1, pt_ntt))
