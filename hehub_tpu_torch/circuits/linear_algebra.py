"""Homomorphic linear algebra: the product of a plaintext matrix and an
encrypted vector by the rotation-diagonal method (port of
hehub_tpu/circuits/linear_algebra.py).

Every diagonal is encoded on the ciphertext's device; the narrow path takes
all its rotations of the input from one hoisted digit decomposition
(ckks.hoisted_rotations)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from hehub_tpu_torch.core.context import CkksParams, Context
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod


def mv_mul_requiring_steps(slot_count: int, matrix_width: int):
    """The rotation steps a narrow matrix-vector product needs keys for."""
    steps = []
    for step in range(1, matrix_width):
        steps.append(step)
        steps.append(step + slot_count - matrix_width)
    return steps


def matrix_vector_mul(ctx: Context, params: CkksParams, mat: np.ndarray, ct_vec: ckks.CkksCt,
                      rot_keys: Dict[int, rgsw_mod.RgswCt]) -> ckks.CkksCt:
    """mat [height, width] (real or complex, height <= slots) times the
    encrypted vector: Σ_i diag_i · rot_i(vec), one closing rescale.

    rot_keys: step -> rotation key, covering mv_mul_requiring_steps(slots,
    width) for a narrow matrix (width <= slots / 2), or {1} for width ==
    slots, whose rotations run as a chain of rotate-by-1."""
    n = params.dimension
    slots = n // 2
    mat = np.asarray(mat)
    height, width = mat.shape
    if height > slots:
        raise ValueError("matrix too tall for one ciphertext")
    if width > slots:
        raise ValueError("matrix too wide; choose larger parameters")
    if slots // 2 < width < slots:
        raise ValueError("matrix width must equal the slot count or be <= half of it")

    full_width = width == slots
    level = len(params.moduli) - ct_vec.level
    scale = ct_vec.scaling_factor
    device = ct_vec.c0.data.device
    rotated = {}
    if not full_width and width > 1:
        rotated = ckks.hoisted_rotations(ctx, ct_vec, rot_keys,
                                         mv_mul_requiring_steps(slots, width))

    ct_rotating = ct_vec
    acc = None
    rows = np.arange(height)
    for i in range(width):
        diag = np.zeros(slots, dtype=np.complex128)
        diag[:height] = mat[rows, (rows + width - i) % width]
        pt = ckks.encode(diag, params, scaling_factor=scale, level=level, device=device)
        term = ckks.mult_plain(ctx, ct_rotating, pt)
        acc = term if acc is None else ckks.add(ctx, acc, term)
        if i != width - 1:
            if full_width:
                ct_rotating = ckks.rotate(ctx, ct_rotating, rot_keys[1], 1)
            else:
                s = i + 1
                ct_rotating = ckks.add(ctx, rotated[s], rotated[s + slots - width])
    return ckks.rescale(ctx, acc)
