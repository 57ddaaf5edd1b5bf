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
"""

from __future__ import annotations

from typing import Tuple

import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.ops import modarith as ma


def ntt_fwd(data, tw, tw_sh, q, two_q):
    """Forward negacyclic NTT.

    data: [..., L, n] int64 coefficients (natural order), lazy [0, 2q).
    tw/tw_sh: [L, n] twiddle tables (ψ^bitrev powers + Shoup companions).
    q/two_q: [L, 1]. Returns values in bit-reversed order, lazy [0, 2q)."""
    n = data.shape[-1]
    logn = n.bit_length() - 1
    lead = data.shape[:-1]
    q3, two_q3 = q[..., None], two_q[..., None]
    x = data
    for s in range(logn):
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
    n = data.shape[-1]
    logn = n.bit_length() - 1
    lead = data.shape[:-1]
    q3, two_q3 = q[..., None], two_q[..., None]
    x = data
    for s in range(logn):
        h = n >> (s + 1)  # number of blocks
        x = x.reshape(*lead, h, 2, 1 << s)
        lo, hi = x[..., 0, :], x[..., 1, :]
        s_sum = lo + two_q3 - hi  # in [0, 4q), a valid Shoup input
        if h == 1:
            w, w_sh = tw_last[..., None], tw_last_sh[..., None]
            new_lo = ma.shoup_mul_lazy(lo + hi, n_inv[..., None], n_inv_sh[..., None], q3)
        else:
            w, w_sh = tw[:, h : 2 * h, None], tw_sh[:, h : 2 * h, None]
            new_lo = ma.add_lazy(lo, hi, two_q3)
        new_hi = ma.shoup_mul_lazy(s_sum, w, w_sh, q3)
        x = torch.stack([new_lo, new_hi], dim=-2).reshape(*lead, n)
    return x


# ---------------------------------------------------------------------------
# Context-level wrappers
# ---------------------------------------------------------------------------

FWD_TABLES = ("tw_fwd", "tw_fwd_sh", "q", "two_q")
INV_TABLES = (
    "tw_inv", "tw_inv_sh", "q", "two_q",
    "tw_inv_last", "tw_inv_last_sh", "n_inv", "n_inv_sh",
)


def to_u32_bits(data: torch.Tensor) -> torch.Tensor:
    """int64 residues in [0, 2^32) -> contiguous int32 holding the same bits."""
    return data.to(torch.int32).contiguous()


def from_u32_bits(data: torch.Tensor) -> torch.Tensor:
    """int32 bits -> int64 residues in [0, 2^32)."""
    return data.to(torch.int64) & ma.MASK32


def _transform(data, rows, names, plain, kernel):
    """K1/K2 (`kernel`) for a CUDA tensor, the plain chain for a CPU one;
    `rows(name, device, dtype)` gives the tables."""
    dev = data.device
    if dev.type == "cuda":
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
    return _transform(data, _limb_rows(ctx, limb_ids), FWD_TABLES, ntt_fwd, kernels.ntt_fwd)


def intt(ctx, data, limb_ids: Tuple[int, ...]):
    """Inverse NTT of [..., L, n] under the context limbs `limb_ids`: the
    K2 kernel for a CUDA tensor, the plain chain for a CPU tensor."""
    return _transform(data, _limb_rows(ctx, limb_ids), INV_TABLES, ntt_inv, kernels.ntt_inv)


def ntt_single(tables, data):
    """Forward NTT of [..., n] under one ModulusTables (a modulus outside
    the context's limbs, e.g. a factor of the BGV plain modulus): K1 on
    [..., 1, n] with the tables as its one limb for a CUDA tensor, the
    plain chain for a CPU tensor."""
    out = _transform(data[..., None, :], tables.device_row, FWD_TABLES, ntt_fwd, kernels.ntt_fwd)
    return out[..., 0, :]


def intt_single(tables, data):
    """Inverse NTT of [..., n] under one ModulusTables: K2 or the plain
    chain, as ntt_single."""
    out = _transform(data[..., None, :], tables.device_row, INV_TABLES, ntt_inv, kernels.ntt_inv)
    return out[..., 0, :]
