"""Homomorphic polynomial evaluation and level and scale management for CKKS
(port of hehub_tpu/circuits/poly_eval.py), and the non-polynomial
functions built on it: inverse (Newton) and sign (iterated cubic).

Scale discipline: with 30-bit primes and a 28-bit scaling factor the scale
drifts after every rescale (Δ' = Δ²/q_last), so terms that are added are
brought to one scale by plaintext coefficients encoded at compensating
scales s_i = S_target / scale(x^i). Every plaintext is encoded on the
ciphertext's device. Multiplicative depth for degree d is ceil(log2 d).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np

from hehub_tpu_torch.core import rns
from hehub_tpu_torch.core.context import CkksParams, Context
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod


def _constant(params: CkksParams, value: float, scale: float, limb_count: int,
              ct: ckks.CkksCt, consts=None) -> ckks.CkksPt:
    """`value` in every slot at `scale`, over the first `limb_count` limbs,
    on the device of `ct`: taken from `consts` (a memo of constant
    plaintexts, circuits/bootstrap.ConstantPlaintexts) when given, else
    encoded anew."""
    if consts is not None:
        return consts(value, scale, limb_count, ct.c0.data.device)
    return ckks.encode(np.full(params.dimension // 2, value), params, scaling_factor=scale,
                       level=len(params.moduli) - limb_count, device=ct.c0.data.device)


def align_level(ctx: Context, ct: ckks.CkksCt, limb_count: int) -> ckks.CkksCt:
    """Drop limbs (without dividing) until ct has `limb_count` limbs."""
    extra = ct.c0.limb_count - limb_count
    if extra < 0:
        raise ValueError(f"cannot raise level: {ct.c0.limb_count} < {limb_count}")
    return ckks.mod_drop(ctx, ct, extra) if extra else ct


def mult_aligned(ctx: Context, a: ckks.CkksCt, b: ckks.CkksCt,
                 rlk: rgsw_mod.RgswCt) -> ckks.CkksCt:
    """ct-ct multiply at the lower of the two levels, then rescale."""
    lvl = min(a.c0.limb_count, b.c0.limb_count)
    prod = ckks.mult(ctx, align_level(ctx, a, lvl), align_level(ctx, b, lvl), rlk)
    return ckks.rescale(ctx, prod)


def power_basis(ctx: Context, ct: ckks.CkksCt, degree: int,
                rlk: rgsw_mod.RgswCt) -> Dict[int, ckks.CkksCt]:
    """x^1..x^degree: x^(2k) = (x^k)², x^(2k+1) = x^(2k)·x, each product
    rescaled once."""
    if degree < 1:
        raise ValueError("degree must be >= 1")
    powers: Dict[int, ckks.CkksCt] = {1: ct}
    for i in range(2, degree + 1):
        if i % 2 == 0:
            powers[i] = mult_aligned(ctx, powers[i // 2], powers[i // 2], rlk)
        else:
            powers[i] = mult_aligned(ctx, powers[i - 1], powers[1], rlk)
    return powers


def poly_eval(ctx: Context, params: CkksParams, ct: ckks.CkksCt, coeffs: Sequence[float],
              rlk: rgsw_mod.RgswCt, consts=None) -> ckks.CkksCt:
    """p(x) = coeffs[0] + coeffs[1]·x + ...: every term c_i·x^i at the
    level of the deepest power and at the common scale Δ·q_drop, so that
    the adds are exact and the closing rescale lands at Δ. `consts`: as
    _constant's."""
    coeffs = list(coeffs)
    if len(coeffs) < 2:
        raise ValueError("need degree >= 1 (use add_plain for constants)")
    d = len(coeffs) - 1
    while d > 1 and coeffs[d] == 0.0:
        d -= 1
    powers = power_basis(ctx, ct, d, rlk)
    lvl = min(p.c0.limb_count for p in powers.values())
    target = params.initial_scaling_factor * ctx.mod_list[lvl - 1]

    acc = None
    for i in range(1, d + 1):
        if coeffs[i] == 0.0:
            continue
        p_i = align_level(ctx, powers[i], lvl)
        pt = _constant(params, coeffs[i], target / p_i.scaling_factor, lvl, ct, consts)
        term = ckks.mult_plain(ctx, p_i, pt)
        acc = term if acc is None else ckks.add(ctx, acc, term)
    if coeffs[0] != 0.0:
        acc = ckks.add_plain(ctx, acc, _constant(params, coeffs[0], target, lvl, ct, consts))
    return ckks.rescale(ctx, acc)


def rebase_scale(ctx: Context, params: CkksParams, ct: ckks.CkksCt,
                 target: float = None) -> ckks.CkksCt:
    """Bring a drifted scaling factor back to `target` (default Δ) at the
    cost of one level: multiply by 1 encoded at target·q_drop/scale, then
    rescale."""
    target = target or params.initial_scaling_factor
    s = target * ctx.mod_list[ct.c0.limb_ids[-1]] / ct.scaling_factor
    if s < 1.0:
        raise ValueError(f"cannot rebase: compensating scale {s} < 1 (scale already high)")
    return ckks.rescale(ctx, ckks.mult_plain(ctx, ct, _constant(params, 1.0, s,
                                                                ct.c0.limb_count, ct)))


def inverse(ctx: Context, params: CkksParams, ct: ckks.CkksCt, rlk: rgsw_mod.RgswCt,
            iterations: int = 3, initial: float = 1.0) -> ckks.CkksCt:
    """1/x for x in (0, 2) by Newton's iteration y <- y·(2 - x·y) from
    y0 = `initial`: one level for the first (affine) step, then three a
    step (two ct-ct products and a scale rebase)."""
    y = None
    for _ in range(iterations):
        if y is None:
            y = poly_eval(ctx, params, ct, [2.0 * initial, -initial * initial], rlk)
            continue
        lvl = min(ct.c0.limb_count, y.c0.limb_count)
        xy = mult_aligned(ctx, align_level(ctx, ct, lvl), y, rlk)
        t = ckks.sub_plain(ctx, xy, _constant(params, 2.0, xy.scaling_factor,
                                              xy.c0.limb_count, ct))  # x·y - 2
        y = mult_aligned(ctx, y, t, rlk)
        y = ckks.CkksCt(rns.neg(ctx, y.c0), rns.neg(ctx, y.c1), y.scaling_factor)
        y = rebase_scale(ctx, params, y)
    return y


def sign(ctx: Context, params: CkksParams, ct: ckks.CkksCt, rlk: rgsw_mod.RgswCt,
         iterations: int = 2) -> ckks.CkksCt:
    """Smooth sign(x) for x in [-1, 1]: f(y) = 1.5 y - 0.5 y³ iterated, two
    levels a pass."""
    y = ct
    for _ in range(iterations):
        y = poly_eval(ctx, params, y, [0.0, 1.5, 0.0, -0.5], rlk)
    return y
