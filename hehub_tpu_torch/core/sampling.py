"""Random polynomial sampling from an explicit torch.Generator (port of
hehub_tpu/core/sampling.py).

Every sampler draws on the generator's device and returns tensors there.
The distributions are the JAX package's: uniform ternary {-1, 0, 1};
residues uniform in [0, q_j) per limb; rounded normal noise with σ = 3.2,
clamped to |e| <= 6σ. torch's generator and JAX's PRNG give different
numbers from the same seed, so tests compare distributions, or hand both
packages the same numpy-made values.
"""

from __future__ import annotations

from typing import Tuple

import torch

from hehub_tpu_torch.core import rns
from hehub_tpu_torch.core.rns import COEFF, NTT, RnsPoly

SIGMA = 3.2


def lift_signed_small(ints, ctx, limb_ids):
    """Small signed integers [..., n] -> lazy residues [..., L, n]."""
    q = ctx.device_rows("q", limb_ids, ints.device)
    x = ints[..., None, :].to(torch.int64)
    return torch.where(x < 0, x + q, x)


def ternary_poly(ctx, gen: torch.Generator, limb_ids: Tuple[int, ...], batch_shape=(),
                 form=NTT) -> RnsPoly:
    """Uniform ternary {-1, 0, 1} polynomial, NTT'd by default."""
    n = ctx.params.dimension
    t = torch.randint(-1, 2, (*batch_shape, n), generator=gen, device=gen.device)
    poly = RnsPoly(lift_signed_small(t, ctx, limb_ids), COEFF, limb_ids)
    return rns.to_ntt(ctx, poly) if form == NTT else poly


def uniform_poly(ctx, gen: torch.Generator, limb_ids: Tuple[int, ...], batch_shape=(),
                 form=NTT) -> RnsPoly:
    """Residues uniform in [0, q_k) per limb."""
    n = ctx.params.dimension
    limbs = [
        torch.randint(0, q, (*batch_shape, n), generator=gen, device=gen.device)
        for q in ctx.moduli_of(limb_ids)
    ]
    return RnsPoly(torch.stack(limbs, dim=-2), form, limb_ids)


def gaussian_poly(ctx, gen: torch.Generator, limb_ids: Tuple[int, ...], batch_shape=(),
                  std_dev: float = SIGMA, form=NTT) -> RnsPoly:
    """Rounded-normal noise, |e| <= 6σ."""
    n = ctx.params.dimension
    g = torch.randn((*batch_shape, n), generator=gen, device=gen.device) * std_dev
    g = torch.clamp(torch.round(g), -6.0 * std_dev, 6.0 * std_dev).to(torch.int64)
    poly = RnsPoly(lift_signed_small(g, ctx, limb_ids), COEFF, limb_ids)
    return rns.to_ntt(ctx, poly) if form == NTT else poly


def zero_poly(ctx, limb_ids: Tuple[int, ...], device, batch_shape=(), form=NTT) -> RnsPoly:
    """The all-zero polynomial; used by the no-noise debug modes."""
    return rns.zeros(ctx, limb_ids, device, batch_shape, form)
