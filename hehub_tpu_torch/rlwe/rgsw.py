"""RGSW ciphertexts and the RNS external product — the key-switching engine
(port of hehub_tpu/rlwe/rgsw.py).

Layout: a key-switching RGSW ciphertext is one int64 tensor
[rows, 2, L_ext, n] of NTT values in the Montgomery domain (pre-scaled by
R = 2^32), so the external product's inner products are Montgomery
multiplies and lazy adds. Row g encrypts s'·B_g with B_g ≡ P (mod the q_j
of digit group g) and ≡ 0 elsewhere. alpha=1 digits are the raw residues
of each limb; alpha>1 (hybrid key switching) digits are the signed base
conversion of each group of alpha limbs into every extended limb.

`ks_digits` + `ks_contract` are the plain PyTorch external product.
`ext_prod` launches the fused CUDA kernel K3 (alpha=1) or K4 (alpha>1),
both in csrc/extprod.cu, for a CUDA tensor (at alpha>1 on the digits that
ModUp, csrc/basecnv.cu, makes in one launch) and runs the plain pair for a
CPU tensor. `ext_prod_strict` is its second half, from the strict
coefficient-form source limbs, for any destination limbs of the key: a
rank of parallel/mesh.py's limb mesh gathers the source limbs and computes
only its own destination limbs (and the special primes).

Above kernels.MAX_ROW_N (up to kernels.MAX_N) one K3/K4 launch cannot take
a row: the first k = log2(n / MAX_ROW_N) stages of each digit NTT pair
whole parts of MAX_ROW_N. `ext_prod_parts` then builds the digits
[R, D, L_ext, n] in device memory (int32 bits, in chunks of R), runs those
k stages through the stage kernel in place (ops.ntt.fwd_cross_stages), and
launches K4 on virtual limbs: each part of each destination limb is a row
of MAX_ROW_N under its regrouped table row, so digits, key and output are
views [.., L_ext 2^k, MAX_ROW_N] of the same memory. At alpha=1 too: after
the cross stages a digit differs across destination limbs, which K3's
[R, l, n] digits cannot carry, and K4 runs K3's block program on K4's
strides. Its plain twin (on_card=False) runs the same operations in the
same order: ntt_stage_plain, the parts' forward chains, the Montgomery
contraction in digit order.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.core import basecnv, rns
from hehub_tpu_torch.core.context import Context, sub_table
from hehub_tpu_torch.core.rns import COEFF, NTT, RnsPoly
from hehub_tpu_torch.ops import modarith as ma
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from hehub_tpu_torch.utils import hostmath as hm

# key switches since import: external products (ext_prod_strict) and the
# contractions of hoisted rotations (count_key_switch), a batch counting one
KEY_SWITCHES = 0


def count_key_switch() -> None:
    global KEY_SWITCHES
    KEY_SWITCHES += 1


@dataclasses.dataclass(frozen=True, eq=False)
class RgswCt:
    """data: [rows, 2, L_ext, n] int64 Montgomery-domain NTT values.
    limb_ids: context limb indices of the L_ext axis (ct limbs + specials).
    alpha: ciphertext limbs per decomposition digit (row)."""

    data: torch.Tensor
    limb_ids: Tuple[int, ...]
    alpha: int = 1

    def __post_init__(self):
        object.__setattr__(self, "limb_ids", tuple(self.limb_ids))

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    def at_level(self, level: int, num_special: int) -> "RgswCt":
        """Restrict to the digits covering the first `level` ct limbs and
        the limbs {0..level-1} ∪ specials. At the key's own level this is a
        view, not a copy."""
        d_rows = -(-level // self.alpha)
        sp = len(self.limb_ids) - num_special
        if level == sp:
            d = self.data[:d_rows]
        else:
            d = torch.cat(
                [self.data[:d_rows, :, :level], self.data[:d_rows, :, sp:]], dim=2
            )
        return RgswCt(d, self.limb_ids[:level] + self.limb_ids[sp:], self.alpha)


def rgsw_encrypt_rns(
    ctx: Context,
    pt_ntt: torch.Tensor,
    sk: rlwe_mod.RlweSk,
    gen: torch.Generator,
    limb_ids_ext: Tuple[int, ...],
    basis_rows: Sequence[Sequence[int]],
    alpha: int = 1,
    **dbg,
) -> RgswCt:
    """RGSW encryption with per-row basis vectors: row g is an RLWE(0)
    sample over the extended limbs plus pt·basis_rows[g][j] folded into
    c0's limb j. `pt_ntt`: [len(ids_ext), n] strict values on the
    generator's device. Output is in the Montgomery domain."""
    dev = gen.device
    mods = ctx.moduli_of(limb_ids_ext)
    k_rows = len(basis_rows)
    ws = [[int(basis_rows[g][j]) % q for j, q in enumerate(mods)] for g in range(k_rows)]
    w = torch.tensor(ws, dtype=torch.int64)[:, :, None].to(dev)
    w_sh = torch.tensor(
        [[hm.shoup(x, q) for x, q in zip(row, mods)] for row in ws], dtype=torch.int64
    )[:, :, None].to(dev)
    ct = rlwe_mod.rlwe_sample(ctx, sk, gen, limb_ids_ext, (k_rows,), **dbg)
    q = ctx.device_rows("q", limb_ids_ext, dev)
    two_q = ctx.device_rows("two_q", limb_ids_ext, dev)
    # pt·B_g folded into c0 (rows with w = 0 contribute exactly 0)
    row_add = ma.reduce_strict(ma.shoup_mul_lazy(pt_ntt[None], w, w_sh, q), q)
    c0d = ma.add_lazy(ct.c0.data, row_add, two_q)
    data = torch.stack([c0d, ct.c1.data], dim=1)  # [rows, 2, L_ext, n]
    # Montgomery domain: multiply everything by R = 2^32 mod q
    data = ma.shoup_mul_lazy(
        data,
        ctx.device_rows("r_mod_q", limb_ids_ext, dev),
        ctx.device_rows("r_shoup", limb_ids_ext, dev),
        q,
    )
    return RgswCt(data, limb_ids_ext, alpha)


def _digit_groups(l: int, alpha: int):
    return [tuple(range(g, min(g + alpha, l))) for g in range(0, l, alpha)]


def _check_ext(poly: RnsPoly, rgsw: RgswCt) -> None:
    if poly.form != NTT:
        raise ValueError("ext_prod expects NTT form")
    l = poly.limb_count
    if rgsw.limb_ids[:l] != poly.limb_ids or len(rgsw.limb_ids) - l < 1:
        raise ValueError(f"rgsw limbs {rgsw.limb_ids} do not extend poly limbs {poly.limb_ids}")
    groups = len(_digit_groups(l, rgsw.alpha))
    if groups > rgsw.rows:
        raise ValueError(f"key has {rgsw.rows} digit rows but level {l} at "
                         f"alpha={rgsw.alpha} needs {groups}")


def _coeff_digits(ctx: Context, d: RnsPoly, rgsw: RgswCt,
                  dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """Key-switch digits of the strict coefficient-form `d` [..., l, n]
    (every source limb) under the key's destination limbs, coefficient
    form: [..., D, L_ext, n] in `dtype` (int64 residues, or the kernels'
    int32 bits made directly, never from a whole int64 copy). alpha=1: the
    strict coefficients of each limb, broadcast across the destination
    limbs (a strict digit < q_i < 2^30 <= 2 q_j is a valid lazy input under
    every 30-bit q_j); alpha>1: the signed base conversion of each limb
    group, lazy in [0, 2 q_j): for a CUDA tensor ModUp, one launch for
    every group (kernels.modup), else base_convert per group, each written
    into its digit row as it is made."""
    *batch, l, n = d.data.shape
    L_ext = len(rgsw.limb_ids)
    if rgsw.alpha == 1:
        return d.data.to(dtype)[..., :, None, :].expand(*batch, l, L_ext, n).contiguous()
    if d.data.is_cuda:
        tabs = basecnv.modup_tables(ctx, d.limb_ids, rgsw.limb_ids, rgsw.alpha,
                                    str(d.data.device))
        out = kernels.modup(d.data.reshape(-1, l, n).contiguous(), *tabs, rgsw.alpha)
        out = out.view(*batch, *out.shape[1:])
        return out if dtype == torch.int32 else nttmod.from_u32_bits(out)
    groups = _digit_groups(l, rgsw.alpha)
    out = torch.empty((*batch, len(groups), L_ext, n), dtype=dtype, device=d.data.device)
    for g, grp in enumerate(groups):
        out[..., g, :, :] = basecnv.base_convert(ctx, rns.take_limbs(d, grp), rgsw.limb_ids,
                                                 signed=True).data
    return out


def _strict_digits(ctx: Context, d: RnsPoly, rgsw: RgswCt) -> torch.Tensor:
    """_coeff_digits in NTT form: [..., D, L_ext, n] (on the card the
    digits go to K1 as the int32 bits they are made in)."""
    dt = nttmod.table_dtype(d.data.device)
    return nttmod.ntt(ctx, _coeff_digits(ctx, d, rgsw, dt), rgsw.limb_ids)


def ks_digits(ctx: Context, poly: RnsPoly, rgsw: RgswCt) -> torch.Tensor:
    """Key-switch digit decomposition of `poly` in NTT form over the
    extended limbs: [..., D, L_ext, n] (_strict_digits)."""
    _check_ext(poly, rgsw)
    return _strict_digits(ctx, rns.reduce_strict(ctx, rns.to_coeff(ctx, poly)), rgsw)


def _contract(digits: torch.Tensor, key: torch.Tensor, q, two_q, neg_qinv):
    """Montgomery contraction of NTT-form digits [..., D, L, n] against key
    rows [>= D, 2, L, n] under per-limb q/two_q/neg_qinv [L, 1], accumulated
    in digit order: (c0, c1) [..., L, n]."""
    halves = []
    for half in range(2):
        acc = None
        for g in range(digits.shape[-3]):
            prod = ma.mont_mul_lazy(digits[..., g, :, :], key[g, half], q, neg_qinv)
            acc = prod if acc is None else ma.add_lazy(acc, prod, two_q)
        halves.append(acc)
    return halves


def ks_contract(ctx: Context, digits: torch.Tensor, rgsw: RgswCt) -> rlwe_mod.RlweCt:
    """Montgomery contraction of NTT-form digits [..., D, L_ext, n] against
    the key rows, accumulated in digit order."""
    ids_ext = rgsw.limb_ids
    dev = digits.device
    c0, c1 = _contract(digits, rgsw.data, *(ctx.device_rows(nm, ids_ext, dev)
                                            for nm in ("q", "two_q", "neg_qinv")))
    return rlwe_mod.RlweCt(RnsPoly(c0, NTT, ids_ext), RnsPoly(c1, NTT, ids_ext))


def ext_prod(ctx: Context, poly: RnsPoly, rgsw: RgswCt) -> rlwe_mod.RlweCt:
    """External product: poly (NTT form over ct limbs) times the RGSW rows,
    an RLWE ciphertext over poly limbs + specials, NTT form.

    A CUDA tensor goes through a fused kernel that keeps the digit NTTs out
    of device memory: K3 at alpha=1 takes the strict coefficient digits
    [R, l, n]; K4 at alpha>1 takes the base-converted coefficient digits
    [R, D, L_ext, n]; both read the key in place through its strides and
    give c0 and c1 as [R, L_ext, n]. A CPU tensor goes through
    ks_contract(ks_digits(...)); both are bitwise equal."""
    _check_ext(poly, rgsw)
    return ext_prod_strict(ctx, rns.reduce_strict(ctx, rns.to_coeff(ctx, poly)), rgsw)


def ext_prod_strict(ctx: Context, d: RnsPoly, rgsw: RgswCt) -> rlwe_mod.RlweCt:
    """The external product of the strict coefficient-form source limbs `d`
    (every limb the key's digit rows cover) with the key rows, over the
    key's limb_ids: any destination limbs, each computed as ext_prod
    computes it (so a subset gives those limbs of ext_prod's result,
    bitwise). K3 / K4 for a CUDA tensor, ks_contract of the plain digits
    for a CPU tensor."""
    if d.form != COEFF:
        raise ValueError("ext_prod_strict expects strict coefficient-form source limbs")
    groups = len(_digit_groups(d.limb_count, rgsw.alpha))
    if groups > rgsw.rows:
        raise ValueError(f"key has {rgsw.rows} digit rows but {d.limb_count} source limbs at "
                         f"alpha={rgsw.alpha} need {groups}")
    dev = d.data.device
    count_key_switch()
    if dev.type != "cuda":
        if dev.type != "cpu":
            raise ValueError(f"no ext_prod for tensors on {dev}")
        return ks_contract(ctx, _strict_digits(ctx, d, rgsw), rgsw)
    ids_ext = rgsw.limb_ids
    l, n = d.limb_count, d.dimension
    batch = d.batch_shape
    if n > kernels.MAX_ROW_N:
        if n > kernels.MAX_N:
            raise ValueError(f"the external product on the card takes n up to {kernels.MAX_N}, "
                             f"got {n}")
        return ext_prod_parts(ctx, d, rgsw, kernels.MAX_ROW_N, on_card=True)
    names = nttmod.EXT_SPLIT_TABLES if n > kernels.EXT_SUB_N else nttmod.EXT_TABLES
    tabs = [ctx.device_rows(nm, ids_ext, dev, torch.int32) for nm in names]
    if rgsw.alpha == 1:
        out = kernels.ext_prod(nttmod.to_u32_bits(d.data.reshape(-1, l, n)),
                               nttmod.to_u32_bits(rgsw.data[:l]), *tabs)
    else:
        digits = _coeff_digits(ctx, d, rgsw, torch.int32)
        D = digits.shape[-3]
        out = kernels.ext_prod_conv(digits.reshape(-1, D, len(ids_ext), n),
                                    nttmod.to_u32_bits(rgsw.data[:D]), *tabs)
    out = nttmod.from_u32_bits(out).reshape(2, *batch, len(ids_ext), n)
    return rlwe_mod.RlweCt(RnsPoly(out[0], NTT, ids_ext), RnsPoly(out[1], NTT, ids_ext))


# the most bytes of int32 digits [R, D, L_ext, n] one chunk of ext_prod_parts
# holds in device memory (a chunk is at least one row of R)
DIGIT_CHUNK_BYTES = 4 << 30


def _key_parts(key: torch.Tensor, k: int, part: int) -> torch.Tensor:
    """The key rows [D, 2, L_ext, n] viewed as [D, 2, L_ext 2^k, part]: part
    p of limb j as virtual limb j 2^k + p. A view, never a copy: the limb
    axis must lie at stride n and the last at stride 1."""
    D, two, L_ext, n = key.shape
    if key.stride(3) != 1 or key.stride(2) != n:
        raise ValueError(f"the key's rows must lie at stride n = {n} on its limb axis (and 1 "
                         f"on its last) to be viewed by parts; got strides {key.stride()}")
    return key.view(D, two, L_ext << k, part)


def parts_route(ctx: Context, ids_ext: Tuple[int, ...], n: int, part: int, device,
                on_card: bool):
    """The tables of the external product by parts of `part` over the
    destination limbs ids_ext: (k = log2(n / part), the cross stages'
    tw_fwd/tw_fwd_sh/q/two_q [L_ext, .], the virtual limbs' (each part of
    each limb, L_ext 2^k of them) tw_fwd/tw_fwd_sh regrouped for rows of
    `part` (sub_table; on_card regrouped again for K4's sub-rows of
    kernels.EXT_SUB_N) and q/two_q/neg_qinv repeated per part). On the card
    int32 bits, else int64."""
    dt = torch.int32 if on_card else torch.int64
    rows = lambda nm: ctx.device_rows(nm, ids_ext, device, dt)  # noqa: E731
    k = (n // part).bit_length() - 1
    part_names = [sub_table(nm, part) for nm in nttmod.EXT_TABLES[:2]]
    if on_card and part > kernels.EXT_SUB_N:
        part_names = [sub_table(nm, kernels.EXT_SUB_N) for nm in part_names]
    part_tabs = tuple(map(rows, part_names)) + tuple(
        rows(nm).repeat_interleave(1 << k, dim=0) for nm in nttmod.EXT_TABLES[2:])
    return k, tuple(map(rows, nttmod.FWD_TABLES)), part_tabs


def ext_prod_digits(digits: torch.Tensor, key: torch.Tensor, route, on_card: bool):
    """The external product by parts of lazy coefficient-form digits [R, D,
    L_ext, n] (contiguous) with key rows [>= D, 2, L_ext, n] under `route`
    (parts_route): the k forward stages that pair whole parts
    (ops.ntt.fwd_cross_stages), then each part of each limb a virtual limb:
    on_card, K4 (kernels.ext_prod_conv) on int32 bits, the cross stages in
    place in `digits`; else the parts' plain forward chain (ops.ntt.ntt_fwd)
    and the Montgomery contraction in digit order on int64. Returns [2, R,
    L_ext, n] in the digits' dtype."""
    k, cross, part_tabs = route
    R, D, L_ext, n = digits.shape
    part = n >> k
    key = _key_parts(key[:D], k, part)
    digits = nttmod.fwd_cross_stages(digits.view(R * D, L_ext, n), k, *cross, on_card)
    digits = digits.view(R, D, L_ext << k, part)
    if on_card:
        out = kernels.ext_prod_conv(digits, key, *part_tabs)
    else:
        digits = nttmod.ntt_fwd(digits, *part_tabs[:4])
        out = torch.stack(_contract(digits, key, *part_tabs[2:]))
    return out.view(2, R, L_ext, n)


def ext_prod_parts(ctx: Context, d: RnsPoly, rgsw: RgswCt, part: int,
                   on_card: bool) -> rlwe_mod.RlweCt:
    """ext_prod_strict by parts of `part` (a power of two < n): for each
    chunk of the R = prod(batch) rows (digits under DIGIT_CHUNK_BYTES), the
    digits [Rc, D, L_ext, n] (_coeff_digits), then ext_prod_digits: on_card
    the stage kernel and K4 on int32 bits, else their plain twins on int64.
    Bitwise equal to ks_contract(_strict_digits(...)) either way."""
    ids_ext = rgsw.limb_ids
    l, n = d.limb_count, d.dimension
    L_ext = len(ids_ext)
    dev = d.data.device
    route = parts_route(ctx, ids_ext, n, part, dev, on_card)
    D = len(_digit_groups(l, rgsw.alpha))
    key = nttmod.to_u32_bits(rgsw.data[:D]) if on_card else rgsw.data[:D]
    src = d.data.reshape(-1, l, n)
    chunk = max(1, DIGIT_CHUNK_BYTES // (D * L_ext * n * 4))
    dt = torch.int32 if on_card else torch.int64
    outs = [ext_prod_digits(_coeff_digits(ctx, RnsPoly(src[r0:r0 + chunk], COEFF, d.limb_ids),
                                          rgsw, dt), key, route, on_card)
            for r0 in range(0, src.shape[0], chunk)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    if on_card:
        out = nttmod.from_u32_bits(out)
    out = out.reshape(2, *d.batch_shape, L_ext, n)
    return rlwe_mod.RlweCt(RnsPoly(out[0], NTT, ids_ext), RnsPoly(out[1], NTT, ids_ext))
