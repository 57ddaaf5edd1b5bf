"""Frozen peaks and work counts: the least time the card could take.

A least time is the larger of bytes over the memory rate and operations
over the peak rate. The counts are of the reference algorithm's work, from
the shapes alone, so that they read the same whatever implements it.

Peaks of one NVIDIA H100 SXM at its 700 W limit: HBM3 3.35 TB/s and FP64
34 TFLOP/s outside the tensor cores (NVIDIA's data sheet); INT32 16.7 T
operations/s, derived (132 SMs x 64 INT32 lanes x 1.98 GHz boost, the
Hopper white paper's lane count), not a data-sheet figure.

Operations per element, uint32 lanes, as the program's CUDA sources count
them (csrc/modarith.cuh): a forward Shoup butterfly 11 (shoup_mul_lazy 4,
add_lazy 3, sub_lazy 4), an inverse one 9 and 11 in its last stage (n^-1
folded in), a Montgomery multiply-accumulate 10, a modular product 7; an
FP64 complex butterfly is 10 flops (4 products, 6 sums). Residues are 4
bytes, FFT values 8 bytes a real part.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
FP64_FLOPS_PER_S = 34e12
RESIDUE_BYTES = 4
FWD_BUTTERFLY_OPS = 11
INV_BUTTERFLY_OPS = 9
INV_LAST_BUTTERFLY_OPS = 11
MAC_OPS = 10
MULMOD_OPS = 7
ADD_OPS = 3
FFT_BUTTERFLY_FLOPS = 10


def least_s(nbytes: float, ops: float, ops_per_s: float = INT32_OPS_PER_S) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def ntt_ops(rows: int, n: int, inverse: bool = False) -> int:
    """uint32 operations of `rows` NTTs of length n: log2 n stages of n/2
    butterflies."""
    stages = n.bit_length() - 1
    per_row = ((stages - 1) * INV_BUTTERFLY_OPS + INV_LAST_BUTTERFLY_OPS if inverse
               else stages * FWD_BUTTERFLY_OPS)
    return rows * (n // 2) * per_row


def ntt_launch_s(rows: int, n: int, inverse: bool = False) -> float:
    """One K1 (or K2) launch on `rows` rows of n: each residue read and
    written once."""
    return least_s(2 * rows * n * RESIDUE_BYTES, ntt_ops(rows, n, inverse))


def ext_prod_launch_s(R: int, D: int, L_ext: int, n: int) -> float:
    """One K4 launch: R ciphertexts' D converted digits over L_ext limbs in
    coefficient form, NTT'd and contracted with the key (D x 2 x L_ext
    rows) into 2 x L_ext rows per ciphertext; digits, key and output each
    read or written once."""
    nbytes = (R * D * L_ext + D * 2 * L_ext + R * 2 * L_ext) * n * RESIDUE_BYTES
    ops = ntt_ops(R * D * L_ext, n) + R * D * L_ext * n * 2 * MAC_OPS
    return least_s(nbytes, ops)


def fft_launch_s(rows: int, m: int) -> float:
    """One K5 launch on `rows` complex rows of m: real and imaginary parts
    in and out, the twiddles once."""
    nbytes = (4 * rows * m + 2 * m) * 8
    flops = rows * (m // 2) * (m.bit_length() - 1) * FFT_BUTTERFLY_FLOPS
    return least_s(nbytes, flops, FP64_FLOPS_PER_S)


def key_switch_ops(n: int, level: int, special: int, alpha: int) -> int:
    """Operations of one hybrid key switch of one polynomial at `level`
    chain limbs: INTT of the input; each digit group's base conversion into
    the other limbs (a modular product a source limb, a multiply-accumulate
    a source and destination limb) and their NTT; the inner product
    (2 x D x L_ext multiply-accumulates); then, for both halves, the INTT of
    the special limbs, their conversion into the chain limbs, its NTT, and
    the subtraction and the product by P^-1 (ModDown)."""
    L_ext = level + special
    D = math.ceil(level / alpha)
    ops = ntt_ops(level, n, inverse=True)
    for a in (min(alpha, level - g) for g in range(0, level, alpha)):
        ops += n * (a * MULMOD_OPS + a * (L_ext - a) * MAC_OPS) + ntt_ops(L_ext - a, n)
    ops += n * 2 * D * L_ext * MAC_OPS
    ops += 2 * (ntt_ops(special, n, inverse=True)
                + n * (special * MULMOD_OPS + special * level * MAC_OPS)
                + ntt_ops(level, n) + n * level * (ADD_OPS + MULMOD_OPS))
    return ops


def rescale_ops(n: int, level: int) -> int:
    """Operations of one rescale of a ciphertext at `level` limbs: for both
    halves, the INTT of the last limb, its lift into the others (a sum),
    their NTT, the subtraction and the product by q_last^-1."""
    rest = level - 1
    return 2 * (ntt_ops(1, n, inverse=True) + ntt_ops(rest, n)
                + n * rest * (2 * ADD_OPS + MULMOD_OPS))


def op_least_s(op: str, n: int, level: int, special: int, alpha: int, batch: int) -> float:
    """Least time of one batch of `op` on ciphertexts of `level` chain
    limbs. 'mult': the tensor product (4 products and a sum a residue),
    relinearisation (a key switch of the third part, 2 sums) and rescale;
    reads two ciphertexts, writes one of level - 1 limbs. 'rotate': the
    automorphism (a gather), a key switch of the second half and a sum;
    reads and writes one ciphertext. The key is read once a batch."""
    cells = level * n
    key = math.ceil(level / alpha) * 2 * (level + special) * n
    ops = key_switch_ops(n, level, special, alpha)
    if op == "mult":
        ops += rescale_ops(n, level) + cells * (4 * MULMOD_OPS + 3 * ADD_OPS)
        residues = 2 * 2 * cells + 2 * (level - 1) * n
    elif op == "rotate":
        ops += cells * ADD_OPS
        residues = 2 * cells + 2 * cells
    else:
        raise ValueError(f"no work count for op {op!r}")
    return least_s((batch * residues + key) * RESIDUE_BYTES, batch * ops)
