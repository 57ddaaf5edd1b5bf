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

Above kernels.MAX_ROW_N = 131072, the longest row one K1/K2 launch takes,
the first k = log2(n / MAX_ROW_N) forward stages (the last k inverse ones)
pair whole parts of MAX_ROW_N: they run through the stage kernel
(`ntt_stage`, csrc/ntt.cu; plain twin `ntt_stage_plain`) with the halves of
each block in place, and between them each part is an ordinary row of
MAX_ROW_N under its regrouped table row, for one K1 / K2 launch (K2 not
folding n^-1, which the last stage does). `ntt_fwd_staged` /
`ntt_inv_staged` run that schedule in plain PyTorch (the CPU tests hold it
bitwise against the full chains); the CUDA path is the same code on the
kernels.
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


def ntt_inv_split(data, tw_sub, tw_sub_sh, q, two_q, tw_last=None, tw_last_sh=None, n_inv=None,
                  n_inv_sh=None):
    """ntt_inv of rows of n > NTT_SUB_N as K2 splits them, from the
    regrouped tables alone (INV_SPLIT_TABLES): each sub-row's chain of
    length NTT_SUB_N under its own row, its last stage not folded, then the
    last k stages of the chain, which pair whole sub-rows, under the compact
    entries the regrouped rows hold, the last folding n^-1 (with the four
    last-stage constants; without them an ordinary stage, as K2 runs a part
    of a longer row). Bitwise equal to ntt_inv (to the chain without the
    fold)."""
    last = None if n_inv is None else (tw_last, tw_last_sh, n_inv, n_inv_sh)
    n, L = data.shape[-1], data.shape[-2]
    k = _split(n)
    sub_logn = kernels.NTT_SUB_N.bit_length() - 1
    x = data.reshape(*data.shape[:-2], L << k, kernels.NTT_SUB_N)
    x = _inv_stages(x, tw_sub, tw_sub_sh, _per_sub_row(q, k), _per_sub_row(two_q, k), None,
                    range(sub_logn))
    return _inv_stages(x.reshape(data.shape), _compact_prefix(tw_sub, k),
                       _compact_prefix(tw_sub_sh, k), q, two_q, last, range(sub_logn, sub_logn + k))


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


def table_dtype(device) -> torch.dtype:
    """The dtype the tables take beside data on `device`: the kernels' int32
    bits on the card, the plain chains' int64 on the CPU."""
    return torch.int32 if torch.device(device).type == "cuda" else torch.int64


# ---------------------------------------------------------------------------
# The stage between parts of a row (the stage kernel and its plain twin)
# ---------------------------------------------------------------------------


def ntt_stage_plain(lo, hi, w, w_sh, q, two_q, inverse=False, n_inv=None, n_inv_sh=None):
    """One radix-2 stage on the pairs (lo, hi) [..., L, B, m] int64, block b
    of limb l under w[l, b] (w/w_sh [L, B]): forward (Cooley-Tukey, as
    ntt_fwd's stages) lo + hi w, lo - hi w; inverse (Gentleman-Sande, as
    ntt_inv's) lo + hi, (lo + 2q - hi) w, or, with n_inv/n_inv_sh [L, 1],
    (lo + hi) n^-1 for the first (a chain's last stage). Returns [..., L,
    B, 2, m]: lo' then hi' in each block. The stage kernel's plain twin."""
    q3, two_q3 = q[..., None], two_q[..., None]
    w3, w3_sh = w[..., None], w_sh[..., None]
    if not inverse:
        wh = ma.shoup_mul_lazy(hi, w3, w3_sh, q3)
        pair = (ma.add_lazy(lo, wh, two_q3), ma.sub_lazy(lo, wh, two_q3))
    else:
        new_lo = (ma.add_lazy(lo, hi, two_q3) if n_inv is None
                  else ma.shoup_mul_lazy(lo + hi, n_inv[..., None], n_inv_sh[..., None], q3))
        pair = (new_lo, ma.shoup_mul_lazy(lo + two_q3 - hi, w3, w3_sh, q3))
    return torch.stack(pair, dim=-2)


def ntt_stage(lo, hi, w, w_sh, q, two_q, inverse=False, n_inv=None, n_inv_sh=None, keep=None):
    """ntt_stage_plain on int64 data: the stage kernel for CUDA tensors (the
    tables then int32 bits, table_dtype), the plain twin for CPU ones. With
    keep 0 or 1 only lo' or hi' is returned, [..., L, B, m] (a rank that
    holds one half of a row)."""
    dev = lo.device
    if dev.type == "cuda":
        out = kernels.ntt_stage(to_u32_bits(lo), to_u32_bits(hi), w, w_sh, q, two_q, inverse,
                                n_inv, n_inv_sh, keep)
        return from_u32_bits(out)
    if dev.type != "cpu":
        raise ValueError(f"no NTT stage for tensors on {dev}")
    out = ntt_stage_plain(lo, hi, w, w_sh, q, two_q, inverse, n_inv, n_inv_sh)
    return out if keep is None else out[..., keep, :]


# ---------------------------------------------------------------------------
# Transforms under a table provider, and the context-level wrappers
# ---------------------------------------------------------------------------


def _part_count(n: int) -> int:
    """log2 of the parts of kernels.MAX_ROW_N in a row of n > MAX_ROW_N."""
    return (n // kernels.MAX_ROW_N).bit_length() - 1


def _part_table(name: str) -> str:
    """The twiddle table `name` regrouped for parts of MAX_ROW_N, each part's
    row regrouped for sub-rows of NTT_SUB_N: the table of K1 / K2 on the
    parts."""
    return sub_table(sub_table(name, kernels.MAX_ROW_N), kernels.NTT_SUB_N)


def fwd_cross_stages(x, k: int, tw, tw_sh, q, two_q, on_card: bool):
    """The first k stages of the forward chain on x [..., L, n] (tables
    [L, >= 2^k] and [L, 1] beside it), the ones that pair whole parts of
    n / 2^k: stage s on 2^s blocks of each row, block b of limb l under
    tw[l, 2^s + b]. on_card: the stage kernel on the halves of each block
    in place (x contiguous int32 bits), returning x; else ntt_stage_plain on
    int64, returning a new tensor: the same operations in the same order.
    ops.ntt's transforms and rlwe.rgsw's key switch above kernels.MAX_ROW_N
    both run these stages here."""
    *lead, L, n = x.shape
    for s in range(k):
        b = 1 << s
        v = x.reshape(*lead, L, b, 2, n // (2 * b))
        args = (v[..., 0, :], v[..., 1, :], tw[:, b:2 * b], tw_sh[:, b:2 * b], q, two_q)
        if on_card:
            kernels.ntt_stage(*args, in_place=True)
        else:
            x = ntt_stage_plain(*args).reshape(*lead, L, n)
    return x


def _staged(x, rows, inverse: bool, fold: bool, on_card: bool):
    """The transform of x [..., L, n], n > kernels.MAX_ROW_N, by parts: the
    k forward stages that pair whole parts, through the stage kernel on the
    halves of each block in place (fwd_cross_stages), then K1 on the 2^k
    parts of each row under their regrouped table rows (_part_table); the
    inverse mirrors it (the stage kernel out of place), K2 not
    folding n^-1 on the parts, then the stage kernel, block b of the stage
    with 2^t blocks under tw[l, 2^t + b], the last (one block) folding
    n^-1 with `fold`. on_card: the kernels on int32 bits; else their plain
    twins on int64 (ntt_stage_plain, ntt_fwd_split, ntt_inv_split), the
    same operations in the same order."""
    dev = x.device
    dt = torch.int32 if on_card else torch.int64
    *lead, L, n = x.shape
    k = _part_count(n)
    base = "tw_inv" if inverse else "tw_fwd"
    tw, tw_sh, q, two_q = (rows(nm, dev, dt) for nm in (base, base + "_sh", "q", "two_q"))
    part_tw, part_tw_sh = (rows(_part_table(nm), dev, dt) for nm in (base, base + "_sh"))
    part_q, part_two_q = _per_sub_row(q, k), _per_sub_row(two_q, k)
    stage = kernels.ntt_stage if on_card else ntt_stage_plain

    def run_stage(blocks, w, w_sh, last=(None, None)):
        v = x.reshape(*lead, L, blocks, 2, n // (2 * blocks))
        return stage(v[..., 0, :], v[..., 1, :], w, w_sh, q, two_q, inverse,
                     *last).reshape(*lead, L, n)

    if not inverse:
        x = fwd_cross_stages(x, k, tw, tw_sh, q, two_q, on_card)
        parts = x.reshape(*lead, L << k, kernels.MAX_ROW_N)
        part = kernels.ntt_fwd if on_card else ntt_fwd_split
        return part(parts, part_tw, part_tw_sh, part_q, part_two_q).reshape(*lead, L, n)
    parts = x.reshape(*lead, L << k, kernels.MAX_ROW_N)
    part = kernels.ntt_inv if on_card else ntt_inv_split
    x = part(parts, part_tw, part_tw_sh, part_q, part_two_q).reshape(*lead, L, n)
    for t in reversed(range(k)):
        b = 1 << t
        if t == 0 and fold:
            x = run_stage(1, rows("tw_inv_last", dev, dt), rows("tw_inv_last_sh", dev, dt),
                          (rows("n_inv", dev, dt), rows("n_inv_sh", dev, dt)))
        else:
            x = run_stage(b, tw[:, b:2 * b], tw_sh[:, b:2 * b])
    return x


def ntt_fwd_staged(data, rows):
    """ntt_fwd of int64 rows of n > kernels.MAX_ROW_N as the card runs them
    (_staged), on the plain twins, under the tables `rows` serves."""
    return _staged(data, rows, False, True, on_card=False)


def ntt_inv_staged(data, rows, fold: bool = True):
    """ntt_inv (without folding n^-1: the chain's last stage ordinary) of
    int64 rows of n > kernels.MAX_ROW_N as the card runs them, on the plain
    twins."""
    return _staged(data, rows, True, fold, on_card=False)


def transform(data, rows, inverse: bool = False, fold: bool = True):
    """The forward (inverse) NTT of [..., L, n] under the tables that
    `rows(name, device, dtype)` gives for its L rows (as Context.device_rows
    for some limbs, ModulusTables.device_row, TableRows.device_rows):
    K1 / K2 for a CUDA tensor, through the stage kernel and parts of
    kernels.MAX_ROW_N above that length (up to kernels.MAX_N), the plain
    chain for a CPU tensor. fold=False: the inverse chain's last stage does
    not fold n^-1 (an ordinary stage under tw[1]), as the part of a longer
    row that parallel/ntt_sharded.py gives a rank needs."""
    dev = data.device
    n = data.shape[-1]
    if dev.type == "cuda":
        return from_u32_bits(transform_bits(to_u32_bits(data), rows, inverse, fold))
    if dev.type != "cpu":
        raise ValueError(f"no NTT for tensors on {dev}")
    if not inverse:
        return ntt_fwd(data, *(rows(nm, dev, torch.int64) for nm in FWD_TABLES))
    tw, tw_sh, q, two_q, *last = (rows(nm, dev, torch.int64)
                                  for nm in (INV_TABLES if fold else INV_TABLES[:4]))
    return _inv_stages(data, tw, tw_sh, q, two_q, last or None, range(n.bit_length() - 1))


def transform_bits(x, rows, inverse: bool = False, fold: bool = True):
    """transform on the card, on and to the kernels' int32 bits: x [..., L,
    n] contiguous int32 (lazy residues; above kernels.MAX_ROW_N the forward
    transform runs its first stages on x in place)."""
    dev = x.device
    n = x.shape[-1]
    if n > kernels.MAX_N:
        raise ValueError(f"the NTT on the card takes n up to {kernels.MAX_N}, got {n}")
    if n > kernels.MAX_ROW_N:
        return _staged(x, rows, inverse, fold, on_card=True)
    names = INV_TABLES if inverse else FWD_TABLES
    if n > kernels.NTT_SUB_N:
        names = _split_tables(names, kernels.NTT_SUB_N)
    if inverse and not fold:
        names = names[:4]
    kernel = kernels.ntt_inv if inverse else kernels.ntt_fwd
    return kernel(x, *(rows(nm, dev, torch.int32) for nm in names))


def limb_rows(ctx, limb_ids):
    """The table provider of transform for the context limbs `limb_ids`."""
    return lambda nm, dev, dtype: ctx.device_rows(nm, limb_ids, dev, dtype)


def ntt(ctx, data, limb_ids: Tuple[int, ...]):
    """Forward NTT of [..., L, n] under the context limbs `limb_ids`: the
    K1 kernel for a CUDA tensor (with the stage kernel above
    kernels.MAX_ROW_N), the plain chain for a CPU tensor."""
    return transform(data, limb_rows(ctx, limb_ids))


def intt(ctx, data, limb_ids: Tuple[int, ...]):
    """Inverse NTT of [..., L, n] under the context limbs `limb_ids`: the
    K2 kernel for a CUDA tensor (with the stage kernel above
    kernels.MAX_ROW_N), the plain chain for a CPU tensor."""
    return transform(data, limb_rows(ctx, limb_ids), inverse=True)


def ntt_single(tables, data):
    """Forward NTT of [..., n] under one ModulusTables (a modulus outside
    the context's limbs, e.g. a factor of the BGV plain modulus): K1 on
    [..., 1, n] with the tables as its one limb for a CUDA tensor, the
    plain chain for a CPU tensor."""
    return transform(data[..., None, :], tables.device_row)[..., 0, :]


def intt_single(tables, data):
    """Inverse NTT of [..., n] under one ModulusTables: K2 or the plain
    chain, as ntt_single."""
    return transform(data[..., None, :], tables.device_row, inverse=True)[..., 0, :]
