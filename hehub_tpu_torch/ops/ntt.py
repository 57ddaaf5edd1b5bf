"""Negacyclic NTT/INTT over RNS residue tensors (port of
hehub_tpu/ops/ntt.py).

Forward is Cooley-Tukey DIT taking natural-order coefficients to
bit-reversed-order values; inverse is Gentleman-Sande DIF taking them back,
with n^-1 folded into the last stage. No bit-reversal pass anywhere. Lazy
arithmetic: inputs and outputs in [0, 2q).

`ntt_fwd` / `ntt_inv` are the plain PyTorch stage chains, one butterfly
stage per reshape [..., blocks, 2, gap]; they are bitwise equal to the JAX
twins (whose transposed tail stages are a TPU layout, not different math).
The context wrappers `ntt` / `intt` launch the CUDA kernels K1 / K2
(csrc/ntt.cu) for a CUDA tensor and run the plain chains for a CPU tensor.

Above kernels.NTT_SUB_N = 32768 the kernels split each row into sub-rows
of NTT_SUB_N and take Context's tables regrouped for them
(context.sub_row_tables); `ntt_fwd_split` / `ntt_inv_split` are that split
in plain PyTorch, bitwise equal to the full chains (the tests hold them
so).
"""

from __future__ import annotations

from typing import Tuple

import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.core.context import sub_table
from hehub_tpu_torch.ops import modarith as ma


def ntt_fwd(data, tw, tw_sh, q, two_q):
    """Forward negacyclic NTT.

    data: [..., L, n] int64 coefficients (natural order), lazy [0, 2q).
    tw/tw_sh: [L, n] twiddle tables (ψ^bitrev powers + Shoup companions).
    q/two_q: [L, 1]. Returns values in bit-reversed order, lazy [0, 2q)."""
    return _fwd_stages(data, tw, tw_sh, q, two_q, range(data.shape[-1].bit_length() - 1))


def _fwd_stages(data, tw, tw_sh, q, two_q, stages):
    """The forward chain's stages `stages` (a range of stage numbers)."""
    n = data.shape[-1]
    lead = data.shape[:-1]
    q3, two_q3 = q[..., None], two_q[..., None]
    x = data
    for s in stages:
        m = 1 << s
        x = x.reshape(*lead, m, 2, n >> (s + 1))
        lo, hi = x[..., 0, :], x[..., 1, :]
        wh = ma.shoup_mul_lazy(hi, tw[:, m : 2 * m, None], tw_sh[:, m : 2 * m, None], q3)
        x = torch.stack(
            [ma.add_lazy(lo, wh, two_q3), ma.sub_lazy(lo, wh, two_q3)], dim=-2
        ).reshape(*lead, n)
    return x


def ntt_inv(data, tw, tw_sh, q, two_q, tw_last, tw_last_sh, n_inv, n_inv_sh):
    """Inverse negacyclic NTT (bit-reversed values -> natural coefficients).
    tw_last/n_inv ([L, 1]) carry the folded n^-1 of the final stage.
    Output lazy [0, 2q)."""
    return _inv_stages(data, tw, tw_sh, q, two_q, (tw_last, tw_last_sh, n_inv, n_inv_sh),
                       range(data.shape[-1].bit_length() - 1))


def _inv_stages(data, tw, tw_sh, q, two_q, last, stages):
    """The inverse chain's stages `stages`; the last stage of the chain
    folds n^-1 with `last` = (tw_last, tw_last_sh, n_inv, n_inv_sh), or, for
    `last` None (a sub-row's chain), is an ordinary stage under tw[1]."""
    n = data.shape[-1]
    lead = data.shape[:-1]
    q3, two_q3 = q[..., None], two_q[..., None]
    x = data
    for s in stages:
        h = n >> (s + 1)  # number of blocks
        x = x.reshape(*lead, h, 2, 1 << s)
        lo, hi = x[..., 0, :], x[..., 1, :]
        s_sum = lo + two_q3 - hi  # in [0, 4q), a valid Shoup input
        if h == 1 and last is not None:
            tw_last, tw_last_sh, n_inv, n_inv_sh = last
            w, w_sh = tw_last[..., None], tw_last_sh[..., None]
            new_lo = ma.shoup_mul_lazy(lo + hi, n_inv[..., None], n_inv_sh[..., None], q3)
        else:
            w, w_sh = tw[:, h : 2 * h, None], tw_sh[:, h : 2 * h, None]
            new_lo = ma.add_lazy(lo, hi, two_q3)
        new_hi = ma.shoup_mul_lazy(s_sum, w, w_sh, q3)
        x = torch.stack([new_lo, new_hi], dim=-2).reshape(*lead, n)
    return x


def _split(n: int) -> int:
    """log2 of the sub-rows of NTT_SUB_N in a row of n > NTT_SUB_N."""
    if n <= kernels.NTT_SUB_N:
        raise ValueError(f"rows of n = {n} are not split (NTT_SUB_N = {kernels.NTT_SUB_N})")
    return (n // kernels.NTT_SUB_N).bit_length() - 1


def _per_sub_row(c, k):
    """A per-limb [L, 1] constant for the [L 2^k, NTT_SUB_N] sub-rows."""
    return c.repeat_interleave(1 << k, dim=0)


def _compact_prefix(tw_sub, k):
    """Entries [0, 2^(k+1)) of each limb's compact table, [L, 2^(k+1)], from
    its 2^k regrouped rows (context.sub_row_tables): entry 0 of the rows,
    then their entry 1."""
    rows = tw_sub.reshape(-1, 1 << k, tw_sub.shape[-1])
    return torch.cat([rows[:, :, 0], rows[:, :, 1]], dim=-1)


def ntt_fwd_split(data, tw_sub, tw_sub_sh, q, two_q):
    """ntt_fwd of rows of n > NTT_SUB_N as K1 splits them, from the tables
    regrouped for sub-rows of NTT_SUB_N alone (tw_sub/tw_sub_sh [L 2^k,
    NTT_SUB_N], FWD_SPLIT_TABLES): the first k stages of the chain, which
    pair whole sub-rows, under the compact entries the regrouped rows hold,
    then each sub-row's chain of length NTT_SUB_N under its own row.
    Bitwise equal to ntt_fwd."""
    n, L = data.shape[-1], data.shape[-2]
    k = _split(n)
    x = _fwd_stages(data, _compact_prefix(tw_sub, k), _compact_prefix(tw_sub_sh, k), q, two_q,
                    range(k))
    x = x.reshape(*data.shape[:-2], L << k, kernels.NTT_SUB_N)
    x = ntt_fwd(x, tw_sub, tw_sub_sh, _per_sub_row(q, k), _per_sub_row(two_q, k))
    return x.reshape(data.shape)


def ntt_inv_split(data, tw_sub, tw_sub_sh, q, two_q, tw_last, tw_last_sh, n_inv, n_inv_sh):
    """ntt_inv of rows of n > NTT_SUB_N as K2 splits them, from the
    regrouped tables alone (INV_SPLIT_TABLES): each sub-row's chain of
    length NTT_SUB_N under its own row, its last stage not folded, then the
    last k stages of the chain, which pair whole sub-rows, under the compact
    entries the regrouped rows hold, the last folding n^-1. Bitwise equal
    to ntt_inv."""
    n, L = data.shape[-1], data.shape[-2]
    k = _split(n)
    sub_logn = kernels.NTT_SUB_N.bit_length() - 1
    x = data.reshape(*data.shape[:-2], L << k, kernels.NTT_SUB_N)
    x = _inv_stages(x, tw_sub, tw_sub_sh, _per_sub_row(q, k), _per_sub_row(two_q, k), None,
                    range(sub_logn))
    return _inv_stages(x.reshape(data.shape), _compact_prefix(tw_sub, k),
                       _compact_prefix(tw_sub_sh, k), q, two_q,
                       (tw_last, tw_last_sh, n_inv, n_inv_sh), range(sub_logn, sub_logn + k))


# ---------------------------------------------------------------------------
# Context-level wrappers
# ---------------------------------------------------------------------------

FWD_TABLES = ("tw_fwd", "tw_fwd_sh", "q", "two_q")
INV_TABLES = (
    "tw_inv", "tw_inv_sh", "q", "two_q",
    "tw_inv_last", "tw_inv_last_sh", "n_inv", "n_inv_sh",
)
# K3 / K4's tables (the extended limbs')
EXT_TABLES = ("tw_fwd", "tw_fwd_sh", "q", "two_q", "neg_qinv")


def _split_tables(names, sub_n):
    """`names` with the twiddle tables regrouped for sub-rows of sub_n."""
    return tuple(sub_table(nm, sub_n) for nm in names[:2]) + names[2:]


# the tables of K1 / K2 launches above kernels.NTT_SUB_N, of K3 / K4 ones
# above kernels.EXT_SUB_N
FWD_SPLIT_TABLES = _split_tables(FWD_TABLES, kernels.NTT_SUB_N)
INV_SPLIT_TABLES = _split_tables(INV_TABLES, kernels.NTT_SUB_N)
EXT_SPLIT_TABLES = _split_tables(EXT_TABLES, kernels.EXT_SUB_N)


def to_u32_bits(data: torch.Tensor) -> torch.Tensor:
    """int64 residues in [0, 2^32) -> contiguous int32 holding the same bits."""
    return data.to(torch.int32).contiguous()


def from_u32_bits(data: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 residues in [0, 2^32)."""
    return data.to(torch.int64) & ma.MASK32


def _transform(data, rows, names, split_names, plain, kernel):
    """K1/K2 (`kernel`) for a CUDA tensor, the plain chain for a CPU one;
    `rows(name, device, dtype)` gives the tables `names`, or `split_names`
    for a kernel's rows above kernels.NTT_SUB_N."""
    dev = data.device
    if dev.type == "cuda":
        if data.shape[-1] > kernels.NTT_SUB_N:
            names = split_names
        return from_u32_bits(kernel(to_u32_bits(data), *(rows(nm, dev, torch.int32)
                                                         for nm in names)))
    if dev.type != "cpu":
        raise ValueError(f"no NTT for tensors on {dev}")
    return plain(data, *(rows(nm, dev, torch.int64) for nm in names))


def _limb_rows(ctx, limb_ids):
    return lambda nm, dev, dtype: ctx.device_rows(nm, limb_ids, dev, dtype)


def ntt(ctx, data, limb_ids: Tuple[int, ...]):
    """Forward NTT of [..., L, n] under the context limbs `limb_ids`: the
    K1 kernel for a CUDA tensor, the plain chain for a CPU tensor."""
    return _transform(data, _limb_rows(ctx, limb_ids), FWD_TABLES, FWD_SPLIT_TABLES, ntt_fwd,
                      kernels.ntt_fwd)


def intt(ctx, data, limb_ids: Tuple[int, ...]):
    """Inverse NTT of [..., L, n] under the context limbs `limb_ids`: the
    K2 kernel for a CUDA tensor, the plain chain for a CPU tensor."""
    return _transform(data, _limb_rows(ctx, limb_ids), INV_TABLES, INV_SPLIT_TABLES, ntt_inv,
                      kernels.ntt_inv)


def ntt_single(tables, data):
    """Forward NTT of [..., n] under one ModulusTables (a modulus outside
    the context's limbs, e.g. a factor of the BGV plain modulus): K1 on
    [..., 1, n] with the tables as its one limb for a CUDA tensor, the
    plain chain for a CPU tensor."""
    out = _transform(data[..., None, :], tables.device_row, FWD_TABLES, FWD_SPLIT_TABLES, ntt_fwd,
                     kernels.ntt_fwd)
    return out[..., 0, :]


def intt_single(tables, data):
    """Inverse NTT of [..., n] under one ModulusTables: K2 or the plain
    chain, as ntt_single."""
    out = _transform(data[..., None, :], tables.device_row, INV_TABLES, INV_SPLIT_TABLES, ntt_inv,
                     kernels.ntt_inv)
    return out[..., 0, :]
