"""One polynomial's NTT spread across the ranks of a mesh axis (port of
hehub_tpu/parallel/ntt_sharded.py).

Each of the D ranks holds a contiguous n/D slice of every row in natural
coefficient order. The first log2(D) forward stages pair values that lie
on different ranks: rank d swaps its slice with rank d ^ dist (one isend
and one irecv in a batch, mesh.exchange: the counterpart of the
reference's ppermute), runs the stage on the pair through the stage kernel
(ops.ntt.ntt_stage) and keeps the lo half (bit dist of d clear) or the hi
half. After them the rank's slice is an ordinary row of n/D under its own
table row (context.sub_row_tables regrouped for parts of n/D, row d), and
the remaining stages are K1 on it (ops.ntt.transform). The inverse mirrors
it: K2 on the slice without folding n^-1, then the log2(D) cross stages,
the last folding n^-1. In every cross stage a rank's slice lies in one
block of the stage, so its pairs share one twiddle per limb. Outputs are
bitwise equal to ops.ntt.ntt / intt, and so to hehub_tpu's (the reference
holds its sharded transform so, ntt_sharded.py:15-16).

The reference's [G, B] lane layout (B = 128) is a TPU tiling and is not
carried over; its plan's checks (_plan) are, for the same inputs.
"""

from __future__ import annotations

from typing import Tuple

from hehub_tpu_torch.core.context import TableRows, sub_table
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.parallel import mesh as pmesh

# the reference's lane width, which bounds the devices its plan takes
B = 128


def _plan(n: int, D: int):
    """(log2 n, log2 D), raising where the reference's plan raises."""
    logn = n.bit_length() - 1
    G = n // B
    Gd = G // D
    if Gd < 1 or D & (D - 1):
        raise ValueError(f"need a power-of-two device count <= {G}")
    s_tail = min(B.bit_length() - 1, logn)
    s_head = logn - s_tail
    s_cross = D.bit_length() - 1
    if s_cross > s_head:
        raise ValueError(f"too many devices for n={n}: {D} > {2**s_head}")
    return logn, s_cross


def _part_tables(ctx, limb_ids: Tuple[int, ...], D: int, d: int) -> TableRows:
    """The tables of rank d's slice as a row of n/D: row d of each limb's
    tables regrouped for parts of n/D (forward and inverse), and q, 2q."""
    m = ctx.params.dimension // D
    host = {nm: ctx.rows(sub_table(nm, m), limb_ids)[d::D]
            for nm in ("tw_fwd", "tw_fwd_sh", "tw_inv", "tw_inv_sh")}
    return TableRows(q=ctx.rows("q", limb_ids), two_q=ctx.rows("two_q", limb_ids), **host)


def _cross_columns(ctx, limb_ids, D: int, d: int, inverse: bool, device):
    """[(w, w_sh, n_inv, n_inv_sh)] of each cross stage in order: [L, 1]
    columns of the context's tables on `device` (ops.ntt.table_dtype),
    n_inv and n_inv_sh None but in the inverse's last. Forward cross stage
    c is the chain's stage c, whose block d >> (s_cross - c) holds rank d's
    slice, under tw_fwd[2^c + that block]; inverse cross stage c is the
    chain's stage log2(n/D) + c, with D >> (c + 1) blocks, rank d's slice
    in block d >> (c + 1), under tw_inv[(D >> (c + 1)) + that block], the
    last folding n^-1 (tw_inv_last, n_inv)."""
    dt = nttmod.table_dtype(device)
    rows = lambda nm: ctx.device_rows(nm, limb_ids, device, dt)  # noqa: E731
    s_cross = D.bit_length() - 1
    out = []
    for c in range(s_cross):
        if not inverse:
            at = (1 << c) + (d >> (s_cross - c))
            out.append((rows("tw_fwd")[:, at:at + 1], rows("tw_fwd_sh")[:, at:at + 1], None, None))
        elif c == s_cross - 1:
            out.append(tuple(rows(nm) for nm in
                             ("tw_inv_last", "tw_inv_last_sh", "n_inv", "n_inv_sh")))
        else:
            at = (D >> (c + 1)) + (d >> (c + 1))
            out.append((rows("tw_inv")[:, at:at + 1], rows("tw_inv_sh")[:, at:at + 1], None, None))
    return out, rows("q"), rows("two_q")


def make_sharded_ntt(ctx, limb_ids: Tuple[int, ...], mesh, axis: str, inverse: bool = False):
    """Returns fn(x) for this rank of the mesh axis `axis` (D ranks): x is
    its slice [..., L, n/D] (int64 residues, lazy [0, 2q), on the rank's
    mesh.rank_device()) of rows [..., L, n] in
    natural order (forward) or bit-reversed values (inverse), and fn(x) its
    slice of ops.ntt.ntt (intt) of the rows, bitwise. Every rank of the
    axis calls fn at the same time."""
    n = ctx.params.dimension
    D = pmesh.axis_size(mesh, axis)
    _, s_cross = _plan(n, D)
    if D < 2:
        raise ValueError("intra-transform sharding needs >= 2 devices")
    limb_ids = tuple(limb_ids)
    device = pmesh.rank_device()
    d = pmesh.axis_index(mesh, axis)
    part = _part_tables(ctx, limb_ids, D, d)
    cross, q, two_q = _cross_columns(ctx, limb_ids, D, d, inverse, device)

    def cross_stage(x, c, dist):
        other = pmesh.exchange(mesh, x, pmesh.axis_peer(mesh, axis, d ^ dist))
        is_hi = bool(d & dist)
        lo, hi = (other, x) if is_hi else (x, other)
        w, w_sh, n_inv, n_inv_sh = cross[c]
        out = nttmod.ntt_stage(lo[..., None, :], hi[..., None, :], w, w_sh, q, two_q, inverse,
                               n_inv, n_inv_sh, keep=int(is_hi))
        return out[..., 0, :]

    def run(x):
        if x.device != device:
            raise ValueError(f"this sharded NTT was made for {device}, got a tensor on {x.device}")
        if not inverse:
            for c in range(s_cross):
                x = cross_stage(x, c, D >> (c + 1))
            return nttmod.transform(x, part.device_rows)
        x = nttmod.transform(x, part.device_rows, inverse=True, fold=False)
        for c in range(s_cross):
            x = cross_stage(x, c, 1 << c)
        return x

    return run


def shard_rows(x, mesh, axis: str):
    """This rank's slice [..., L, n/D] of rows [..., L, n] on the axis."""
    D = pmesh.axis_size(mesh, axis)
    m = x.shape[-1] // D
    d = pmesh.axis_index(mesh, axis)
    return x[..., d * m:(d + 1) * m]

