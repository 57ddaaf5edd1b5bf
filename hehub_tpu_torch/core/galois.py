"""Galois automorphisms as gathers on NTT values (port of
hehub_tpu/core/galois.py).

Slot j of the NTT holds the polynomial's value at ψ^(2·bitrev(j)+1). The
automorphism X -> X^t moves the value at exponent e to exponent e·t mod 2n,
with t = 3^step for slot rotations and t = -1 for conjugation, which in
this layout is the index reversal out[j] = in[n-1-j].
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from hehub_tpu_torch.core.rns import NTT, RnsPoly


def _bitrev_vec(idx: np.ndarray, logn: int) -> np.ndarray:
    out = np.zeros_like(idx)
    for b in range(logn):
        out |= ((idx >> b) & 1) << (logn - 1 - b)
    return out


@functools.lru_cache(maxsize=None)
def cycle_indices(n: int, step: int) -> np.ndarray:
    """Gather indices g with out[j] = in[g[j]] for the rotation by `step`
    (host numpy, int32)."""
    logn = n.bit_length() - 1
    t = pow(3, step, 2 * n)
    t_inv = pow(t, -1, 2 * n)
    j = np.arange(n, dtype=np.int64)
    e = 2 * _bitrev_vec(j, logn) + 1  # exponent of slot j
    src_e = (e * t_inv) % (2 * n)
    src = _bitrev_vec((src_e - 1) // 2, logn)
    src = src.astype(np.int32)
    src.setflags(write=False)
    return src


@functools.lru_cache(maxsize=None)
def _cycle_index_tensor(n: int, step: int, device: str) -> torch.Tensor:
    return torch.from_numpy(cycle_indices(n, step).astype(np.int64)).to(device)


def cycle_values(data: torch.Tensor, step: int) -> torch.Tensor:
    """The rotation's gather on the last axis of NTT values [..., n]."""
    n = data.shape[-1]
    return data.index_select(-1, _cycle_index_tensor(n, step % n, str(data.device)))


def cycle(poly: RnsPoly, step: int) -> RnsPoly:
    """Slot rotation: an O(n) gather of NTT values."""
    if poly.form != NTT:
        raise ValueError("cycle expects NTT (value) form")
    return poly.with_data(cycle_values(poly.data, step))


def involution(poly: RnsPoly) -> RnsPoly:
    """Conjugation: index reversal of NTT values."""
    if poly.form != NTT:
        raise ValueError("involution expects NTT (value) form")
    return poly.with_data(torch.flip(poly.data, dims=(-1,)))
