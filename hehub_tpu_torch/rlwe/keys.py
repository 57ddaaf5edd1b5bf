"""Key-switching key generation: relinearization, conjugation and rotation
keys (port of hehub_tpu/rlwe/keys.py).

A key-switching key from source key s' to key s is the RGSW encryption of
s' under s over the RNS base extended by the special prime(s) P, with one
digit row per group of `alpha` ciphertext limbs: basis B_g ≡ P (mod every
q_j of group g), ≡ 0 (mod the other limbs and P). alpha=1 is the per-limb
basis; alpha>1 is hybrid key switching and needs alpha special primes, and
on the card at most kernels.MODUP_MAX_ALPHA (16), the largest digit group
ModUp (csrc/basecnv.cu) takes. The source-key transforms (s², cycled s,
conjugated s) act on the key's NTT values. A key may be made over the
first chain limbs and P only (ksk_gen's `chain_limbs`): sse_keys' key to
the bootstrap's sparse ephemeral secret lives on q0 and P alone.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.core import galois
from hehub_tpu_torch.core.context import Context
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod


def _ext_ids(ctx: Context) -> Tuple[int, ...]:
    if not ctx.special_indices:
        raise ValueError("context has no special modulus for key switching")
    return tuple(range(len(ctx.params.moduli))) + ctx.special_indices


def _basis_rows(ctx: Context, alpha: int,
                ids_ext: Optional[Tuple[int, ...]] = None) -> List[List[int]]:
    """Row g, column j: B_g mod the modulus of ids_ext[j] (default: the whole
    extended base), one row per group of `alpha` of the chain limbs among
    ids_ext (the special primes last)."""
    ids_ext = _ext_ids(ctx) if ids_ext is None else ids_ext
    P = 1
    for p in ctx.params.special_mods:
        P *= int(p)
    chain = len(ids_ext) - ctx.num_special
    ext_mods = ctx.moduli_of(ids_ext)
    return [
        [P % int(m) if g0 <= j < g0 + alpha else 0 for j, m in enumerate(ext_mods)]
        for g0 in range(0, chain, alpha)
    ]


def ksk_gen(ctx: Context, src_ntt: torch.Tensor, sk: rlwe_mod.RlweSk, gen: torch.Generator,
            alpha: int = 1, chain_limbs: Optional[int] = None, **dbg) -> rgsw_mod.RgswCt:
    """KSK(s' -> s): RGSW(s') under s. `src_ntt`: [L_ext, n] strict NTT
    values of s' over the extended limbs; `alpha`: ciphertext limbs per
    decomposition digit, at most the number of special primes, and for a
    key made on the card at most kernels.MODUP_MAX_ALPHA (its key switch's
    ModUp takes no larger group). `chain_limbs`: the key over the first
    `chain_limbs` chain limbs and the special primes only (default: every
    chain limb), for ciphertexts of at most that many limbs; it has no
    residue at any other limb, and src_ntt holds those limbs."""
    ids_ext = _ext_ids(ctx)
    if chain_limbs is not None:
        if not 1 <= chain_limbs <= len(ctx.params.moduli):
            raise ValueError(f"chain_limbs={chain_limbs} out of [1, {len(ctx.params.moduli)}]")
        ids_ext = ids_ext[:chain_limbs] + ctx.special_indices
    if not 1 <= alpha <= ctx.num_special:
        raise ValueError(f"alpha={alpha} needs at least {alpha} special primes "
                         f"(have {ctx.num_special})")
    if sk.ntt.is_cuda and alpha > kernels.MODUP_MAX_ALPHA:
        raise ValueError(f"alpha={alpha} on the card: ModUp takes digit groups of at most "
                         f"{kernels.MODUP_MAX_ALPHA} limbs")
    return rgsw_mod.rgsw_encrypt_rns(ctx, src_ntt, sk, gen, ids_ext,
                                     _basis_rows(ctx, alpha, ids_ext), alpha, **dbg)


def relin_key(ctx: Context, sk: rlwe_mod.RlweSk, gen: torch.Generator, alpha: int = 1,
              **dbg) -> rgsw_mod.RgswCt:
    """KSK(s² -> s); `alpha` as ksk_gen takes it."""
    qs = ctx.device_rows("q", tuple(range(len(ctx.mod_list))), sk.ntt.device)
    return ksk_gen(ctx, sk.ntt * sk.ntt % qs, sk, gen, alpha=alpha, **dbg)


def conj_key(ctx: Context, sk: rlwe_mod.RlweSk, gen: torch.Generator, alpha: int = 1,
             **dbg) -> rgsw_mod.RgswCt:
    """KSK(involution(s) -> s); the involution reverses NTT values; `alpha`
    as ksk_gen takes it."""
    return ksk_gen(ctx, torch.flip(sk.ntt, dims=(-1,)), sk, gen, alpha=alpha, **dbg)


def rot_key(ctx: Context, sk: rlwe_mod.RlweSk, step: int, gen: torch.Generator,
            alpha: int = 1, **dbg) -> rgsw_mod.RgswCt:
    """KSK(cycle(s, step) -> s); `alpha` as ksk_gen takes it."""
    n = ctx.params.dimension
    idx = torch.from_numpy(galois.cycle_indices(n, step % n).astype("int64"))
    return ksk_gen(ctx, sk.ntt[:, idx.to(sk.ntt.device)], sk, gen, alpha=alpha, **dbg)


def sse_keys(ctx: Context, sk: rlwe_mod.RlweSk, sk_eph: rlwe_mod.RlweSk, gen: torch.Generator,
             alpha: int = 1) -> Tuple[rgsw_mod.RgswCt, rgsw_mod.RgswCt]:
    """The two keys of sparse-secret encapsulation around the bootstrap's
    ModRaise: KSK(s -> s_eph) over q0 and the special primes only, for the
    exhausted ciphertext at one limb (s_eph is sparse: a key of it at the
    full modulus would expose it), and KSK(s_eph -> s) over every limb, for
    the raised ciphertext. `alpha` as ksk_gen takes it."""
    ids = _ext_ids(ctx)[:1] + ctx.special_indices
    rows = sk.ntt.index_select(0, torch.as_tensor(ids, device=sk.ntt.device))
    to_eph = ksk_gen(ctx, rows, sk_eph, gen, alpha=alpha, chain_limbs=1)
    return to_eph, ksk_gen(ctx, sk_eph.ntt, sk, gen, alpha=alpha)
