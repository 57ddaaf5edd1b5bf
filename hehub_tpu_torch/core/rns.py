"""RnsPoly: the dense RNS polynomial (port of hehub_tpu/core/rns.py).

data: int64 [..., L, n] holding uint32 residues lazy in [0, 2q), with
leading batch dims. `form` ('coeff' | 'ntt') tags the representation;
`limb_ids` are static indices into the Context's modulus axis, so level
changes are slices.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from hehub_tpu_torch.ops import modarith as ma
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.utils import hostmath as hm

COEFF = "coeff"
NTT = "ntt"


@dataclasses.dataclass(frozen=True, eq=False)
class RnsPoly:
    data: torch.Tensor
    form: str
    limb_ids: Tuple[int, ...]

    def __post_init__(self):
        object.__setattr__(self, "limb_ids", tuple(self.limb_ids))

    @property
    def dimension(self) -> int:
        return self.data.shape[-1]

    @property
    def limb_count(self) -> int:
        return len(self.limb_ids)

    @property
    def batch_shape(self):
        return tuple(self.data.shape[:-2])

    def with_data(self, data, form=None) -> "RnsPoly":
        return RnsPoly(data, form or self.form, self.limb_ids)

    def __repr__(self):
        return (
            f"RnsPoly(shape={tuple(self.data.shape)}, form={self.form}, "
            f"limbs={self.limb_ids}, device={self.data.device})"
        )


def _check(a: RnsPoly, b: RnsPoly, form=None):
    if a.limb_ids != b.limb_ids:
        raise ValueError(f"limb mismatch: {a.limb_ids} vs {b.limb_ids}")
    if a.form != b.form:
        raise ValueError(f"representation mismatch: {a.form} vs {b.form}")
    if form is not None and a.form != form:
        raise ValueError(f"expected {form} form, got {a.form}")


def _rows(ctx, name, a: RnsPoly):
    return ctx.device_rows(name, a.limb_ids, a.data.device)


def add(ctx, a: RnsPoly, b: RnsPoly) -> RnsPoly:
    _check(a, b)
    return a.with_data(ma.add_lazy(a.data, b.data, _rows(ctx, "two_q", a)))


def sub(ctx, a: RnsPoly, b: RnsPoly) -> RnsPoly:
    _check(a, b)
    return a.with_data(ma.sub_lazy(a.data, b.data, _rows(ctx, "two_q", a)))


def neg(ctx, a: RnsPoly) -> RnsPoly:
    return a.with_data(ma.neg_lazy(a.data, _rows(ctx, "two_q", a)))


def mul(ctx, a: RnsPoly, b: RnsPoly) -> RnsPoly:
    """Pointwise product; requires NTT (value) form."""
    _check(a, b, form=NTT)
    out = ma.mul_mod_lazy(
        a.data,
        b.data,
        _rows(ctx, "q", a),
        _rows(ctx, "neg_qinv", a),
        _rows(ctx, "r_mod_q", a),
        _rows(ctx, "r_shoup", a),
    )
    return a.with_data(out)


def shoup_constants(ctx, scalars, limb_ids, device):
    """Per-limb host constants (one int per limb, or one int for all) ->
    (w, w_shoup) [L, 1] int64 tensors on `device`, made once per (scalars,
    limbs, device) and shared by every caller, which only reads them: a
    call copies nothing to the device after the first."""
    if isinstance(scalars, (int, np.integer)):
        scalars = [int(scalars)] * len(limb_ids)
    return _shoup_constants(ctx, tuple(int(x) for x in scalars), tuple(limb_ids),
                            str(torch.device(device)))


@functools.lru_cache(maxsize=None)
def _shoup_constants(ctx, scalars: Tuple[int, ...], limb_ids: Tuple[int, ...], device: str):
    w, w_sh = hm.shoup_pair_arrays(list(scalars), ctx.moduli_of(limb_ids))
    return (
        torch.from_numpy(w[:, None]).to(device),
        torch.from_numpy(w_sh[:, None]).to(device),
    )


def mul_scalar(ctx, a: RnsPoly, scalars) -> RnsPoly:
    """Multiply by per-limb host constants (python ints: one per limb, or a
    single int)."""
    w, w_sh = shoup_constants(ctx, scalars, a.limb_ids, a.data.device)
    return a.with_data(ma.shoup_mul_lazy(a.data, w, w_sh, _rows(ctx, "q", a)))


def reduce_strict(ctx, a: RnsPoly) -> RnsPoly:
    return a.with_data(ma.reduce_strict(a.data, _rows(ctx, "q", a)))


def to_ntt(ctx, a: RnsPoly) -> RnsPoly:
    if a.form != COEFF:
        raise ValueError("to_ntt expects coeff form")
    return RnsPoly(nttmod.ntt(ctx, a.data, a.limb_ids), NTT, a.limb_ids)


def to_coeff(ctx, a: RnsPoly) -> RnsPoly:
    if a.form != NTT:
        raise ValueError("to_coeff expects ntt form")
    return RnsPoly(nttmod.intt(ctx, a.data, a.limb_ids), COEFF, a.limb_ids)


def take_limbs(a: RnsPoly, positions: Tuple[int, ...]) -> RnsPoly:
    """Select limb rows by position within this poly."""
    idx = torch.as_tensor(positions, dtype=torch.long, device=a.data.device)
    ids = tuple(a.limb_ids[p] for p in positions)
    return RnsPoly(a.data.index_select(-2, idx), a.form, ids)


def drop_last_limb(a: RnsPoly) -> RnsPoly:
    return RnsPoly(a.data[..., :-1, :], a.form, a.limb_ids[:-1])


def concat_limbs(a: RnsPoly, b: RnsPoly) -> RnsPoly:
    """a's limbs followed by b's (the same form and batch shape)."""
    if a.form != b.form:
        raise ValueError("form mismatch")
    return RnsPoly(torch.cat([a.data, b.data], dim=-2), a.form, a.limb_ids + b.limb_ids)


def zeros(ctx, limb_ids: Tuple[int, ...], device, batch_shape=(), form=COEFF) -> RnsPoly:
    n = ctx.params.dimension
    data = torch.zeros((*batch_shape, len(limb_ids), n), dtype=torch.int64, device=device)
    return RnsPoly(data, form, limb_ids)
