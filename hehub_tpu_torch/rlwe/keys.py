"""Key-switching key generation: relinearization, conjugation and rotation
keys (port of hehub_tpu/rlwe/keys.py).

A key-switching key from source key s' to key s is the RGSW encryption of
s' under s over the RNS base extended by the special prime(s) P, with one
digit row per group of `alpha` ciphertext limbs: basis B_g ≡ P (mod every
q_j of group g), ≡ 0 (mod the other limbs and P). alpha=1 is the per-limb
basis; alpha>1 is hybrid key switching and needs alpha special primes. The
source-key transforms (s², cycled s, conjugated s) act on the key's NTT
values.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from hehub_tpu_torch.core import galois
from hehub_tpu_torch.core.context import Context
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod


def _ext_ids(ctx: Context) -> Tuple[int, ...]:
    if not ctx.special_indices:
        raise ValueError("context has no special modulus for key switching")
    return tuple(range(len(ctx.params.moduli))) + ctx.special_indices


def _basis_rows(ctx: Context, alpha: int) -> List[List[int]]:
    """Row g, column j: B_g mod m_j over the extended base, one row per
    group of `alpha` ciphertext limbs."""
    P = 1
    for p in ctx.params.special_mods:
        P *= int(p)
    ext_mods = ctx.moduli_of(_ext_ids(ctx))
    return [
        [P % int(m) if g0 <= j < g0 + alpha else 0 for j, m in enumerate(ext_mods)]
        for g0 in range(0, len(ctx.params.moduli), alpha)
    ]


def ksk_gen(ctx: Context, src_ntt: torch.Tensor, sk: rlwe_mod.RlweSk, gen: torch.Generator,
            alpha: int = 1, **dbg) -> rgsw_mod.RgswCt:
    """KSK(s' -> s): RGSW(s') under s. `src_ntt`: [L_ext, n] strict NTT
    values of s' over the extended limbs; `alpha`: ciphertext limbs per
    decomposition digit, at most the number of special primes."""
    ids_ext = _ext_ids(ctx)
    if not 1 <= alpha <= ctx.num_special:
        raise ValueError(f"alpha={alpha} needs at least {alpha} special primes "
                         f"(have {ctx.num_special})")
    return rgsw_mod.rgsw_encrypt_rns(ctx, src_ntt, sk, gen, ids_ext, _basis_rows(ctx, alpha),
                                     alpha, **dbg)


def relin_key(ctx: Context, sk: rlwe_mod.RlweSk, gen: torch.Generator, alpha: int = 1,
              **dbg) -> rgsw_mod.RgswCt:
    """KSK(s² -> s)."""
    qs = ctx.device_rows("q", tuple(range(len(ctx.mod_list))), sk.ntt.device)
    return ksk_gen(ctx, sk.ntt * sk.ntt % qs, sk, gen, alpha=alpha, **dbg)


def conj_key(ctx: Context, sk: rlwe_mod.RlweSk, gen: torch.Generator, alpha: int = 1,
             **dbg) -> rgsw_mod.RgswCt:
    """KSK(involution(s) -> s); the involution reverses NTT values."""
    return ksk_gen(ctx, torch.flip(sk.ntt, dims=(-1,)), sk, gen, alpha=alpha, **dbg)


def rot_key(ctx: Context, sk: rlwe_mod.RlweSk, step: int, gen: torch.Generator,
            alpha: int = 1, **dbg) -> rgsw_mod.RgswCt:
    """KSK(cycle(s, step) -> s)."""
    n = ctx.params.dimension
    idx = torch.from_numpy(galois.cycle_indices(n, step % n).astype("int64"))
    return ksk_gen(ctx, sk.ntt[:, idx.to(sk.ntt.device)], sk, gen, alpha=alpha, **dbg)
