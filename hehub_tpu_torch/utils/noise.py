"""Noise and modulus-budget observability (port of hehub_tpu/utils/noise.py).

Given the secret key (a debugging and operations tool), measure how much
modulus headroom a ciphertext has left before decryption wraps, the BGV
invariant noise, and the CKKS slot error. The decryption runs on the
ciphertext's device (rlwe.decrypt_core); the CRT composition of its
residues into integers runs on the host in Python integers
(basecnv.compose_to_int), as in the reference. Unlike the reference,
modulus_headroom_bits also takes a modulus Q above 2^1024.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from hehub_tpu_torch.core import basecnv
from hehub_tpu_torch.core.context import Context
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod


def _decrypt_centered(ctx: Context, ct_pair, sk) -> Tuple[list, int]:
    poly = rlwe_mod.decrypt_core(ctx, rlwe_mod.RlweCt(*ct_pair), sk)
    resid = poly.data.cpu().numpy()
    mods = ctx.moduli_of(poly.limb_ids)
    flat = resid.reshape(-1, len(mods), resid.shape[-1])
    Q = math.prod(int(m) for m in mods)
    vals = []
    for b in range(flat.shape[0]):
        vals.extend(basecnv.compose_to_int(flat[b], mods))
    return vals, Q


def _log2_half(Q: int) -> float:
    """log2(Q / 2) as the reference computes it, through a float; where Q / 2
    is above the float range (Q above 2^1024: 35 or more 30-bit limbs) the
    reference raises OverflowError, and this takes log2(Q) - 1, math.log2
    being exact on integers of any size."""
    try:
        return math.log2(Q / 2)
    except OverflowError:
        return math.log2(Q) - 1


def modulus_headroom_bits(ctx: Context, ct_pair, sk) -> float:
    """log2(Q/2) - log2(max |c0 + c1 s|): bits of room before wraparound.
    <= 0 means the ciphertext no longer decrypts correctly."""
    vals, Q = _decrypt_centered(ctx, ct_pair, sk)
    peak = max((abs(v) for v in vals), default=1)
    return _log2_half(Q) - math.log2(max(peak, 1))


def bgv_invariant_noise_bits(ctx: Context, ct, sk) -> float:
    """log2 |e| of the BGV invariant v = m + t*e (excludes the message)."""
    vals, _ = _decrypt_centered(ctx, (ct.c0, ct.c1), sk)
    t = ct.plain_modulus
    peak = 0
    for v in vals:
        m = v % t
        if m > t // 2:
            m -= t
        peak = max(peak, abs((v - m) // t))
    return math.log2(max(peak, 1))


def ckks_error_bits(ctx: Context, ct, sk, expected: np.ndarray, params) -> float:
    """log2 of the max slot error against the expected cleartext values."""
    got = ckks.decode(ckks.decrypt(ctx, ct, sk), params, count=len(expected))
    err = np.abs(got - np.asarray(expected)).max()
    return math.log2(max(err, 2.0**-60))
