"""Batched lazy modular arithmetic over uint32 residues carried in int64
(port of hehub_tpu/ops/modarith.py).

Residues are `torch.int64` tensors holding values in [0, 2^32): torch on the
CPU has no uint32 add, shift or compare. Every function returns exactly the
uint32 value its JAX twin returns, bit for bit:

  * a product of two 32-bit values can reach 2^64 and overflow int64, so no
    such product is ever formed. `mul_hi` and `_mul_lo` split one operand
    into 16-bit halves; every intermediate stays below 2^49;
  * where the JAX code relies on uint32 wraparound (Shoup's x*w - hi*q,
    Montgomery's lo*neg_qinv, the `+ two_q -` of sub/neg) the result is
    masked with `& 0xFFFFFFFF`.

The CUDA kernels use the same operations on native uint32_t
(csrc/modarith.cuh). Shapes broadcast; per-limb constants are [..., L, 1]
against data [..., L, n]. `tensor_product`, a ciphertext product's chain,
launches its kernel (csrc/modarith.cu) for CUDA tensors.
"""

from __future__ import annotations

import torch

from hehub_tpu_torch import kernels

MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF


def mul_hi(a, b):
    """High 32 bits of the 64-bit product of two uint32 values."""
    return (a * (b >> 16) + ((a * (b & _MASK16)) >> 16)) >> 16


def _mul_lo(a, b):
    """Low 32 bits of the product of two uint32 values (uint32 `a * b`)."""
    return (((a * (b >> 16)) & _MASK16) << 16) + a * (b & _MASK16) & MASK32


def mul_wide(a, b):
    """(hi, lo) of the 64-bit product of two uint32 values."""
    return mul_hi(a, b), _mul_lo(a, b)


def _fold(t, bound):
    """t - (t >= bound ? bound : 0)."""
    return t - torch.where(t >= bound, bound, 0)


def add_lazy(a, b, two_q):
    """(a + b) keeping the lazy range: inputs [0, 2q) -> output [0, 2q)."""
    return _fold((a + b) & MASK32, two_q)


def sub_lazy(a, b, two_q):
    """(a - b) mod 2q-lazily: inputs [0, 2q) -> output [0, 2q)."""
    return _fold((a + two_q - b) & MASK32, two_q)


def neg_lazy(a, two_q):
    """(-a): input [0, 2q) -> output [0, 2q)."""
    return _fold((two_q - a) & MASK32, two_q)


def reduce_strict(a, q):
    """[0, 2q) -> [0, q)."""
    return _fold(a, q)


def shoup_mul_lazy(x, w, w_shoup, q):
    """x * w mod q for a constant w < q with w_shoup = floor(w * 2^32 / q).
    Valid for ANY uint32 x; output in [0, 2q). x*w and hi*q are below 2^62."""
    hi = mul_hi(x, w_shoup)
    return (x * w - hi * q) & MASK32


def mont_mul_lazy(a, b, q, neg_qinv):
    """Montgomery product a * b * 2^-32 mod q, inputs and output in [0, 2q);
    neg_qinv = (-q)^-1 mod 2^32."""
    hi, lo = mul_wide(a, b)
    m = _mul_lo(lo, neg_qinv)
    return (hi + mul_hi(m, q) + (lo != 0).to(lo.dtype)) & MASK32


def mul_mod_lazy(a, b, q, neg_qinv, r_mod_q, r_shoup):
    """Dynamic x dynamic product a*b mod q, output [0, 2q): one Shoup scale
    of b into the Montgomery domain, then one Montgomery multiply."""
    return mont_mul_lazy(a, shoup_mul_lazy(b, r_mod_q, r_shoup, q), q, neg_qinv)


def reduce_add_lazy(x, axis: int, two_q):
    """Tree-sum along `axis` with a lazy reduction after every pairwise add,
    the same pairing order as the JAX twin."""
    x = torch.movedim(x, axis, 0)
    k = x.shape[0]
    while k > 1:
        half = k // 2
        s = add_lazy(x[:half], x[half : 2 * half], two_q)
        if k % 2:
            s = torch.cat([s, x[2 * half : 2 * half + 1]], dim=0)
        x = s
        k = x.shape[0]
    return x[0]


def to_mont(a, q, neg_qinv, r2_mod_q):
    """a -> a * 2^32 mod q (Montgomery domain), via montmul(a, R^2)."""
    return mont_mul_lazy(a, r2_mod_q, q, neg_qinv)


def from_mont(a, q, neg_qinv):
    """a * 2^32 -> a mod q, via montmul(a, 1). Output [0, 2q)."""
    m = _mul_lo(a, neg_qinv)
    return (mul_hi(m, q) + (a != 0).to(a.dtype)) & MASK32


def tensor_product_plain(a0, a1, b0, b1, q, two_q, neg_qinv, r_mod_q, r_shoup):
    """The tensor product of the ciphertexts (a0, a1) and (b0, b1) to its
    three halves: b scaled into the Montgomery domain once, then the four
    cross products are single Montgomery multiplies. Returns (p0, p1, p2)
    = (a0 b0, a0 b1 + a1 b0, a1 b1), lazy in [0, 2q)."""
    b0 = shoup_mul_lazy(b0, r_mod_q, r_shoup, q)
    b1 = shoup_mul_lazy(b1, r_mod_q, r_shoup, q)
    p0 = mont_mul_lazy(a0, b0, q, neg_qinv)
    p1 = add_lazy(mont_mul_lazy(a0, b1, q, neg_qinv), mont_mul_lazy(a1, b0, q, neg_qinv), two_q)
    p2 = mont_mul_lazy(a1, b1, q, neg_qinv)
    return p0, p1, p2


def tensor_product(a0, a1, b0, b1, q, two_q, neg_qinv, r_mod_q, r_shoup):
    """tensor_product_plain; CUDA tensors launch its kernel
    (kernels.tensor_product, the operands broadcast to one shape first)."""
    if not a0.is_cuda:
        return tensor_product_plain(a0, a1, b0, b1, q, two_q, neg_qinv, r_mod_q, r_shoup)
    a0, a1, b0, b1 = torch.broadcast_tensors(a0, a1, b0, b1)
    return kernels.tensor_product(a0, a1, b0, b1, q, two_q, neg_qinv, r_mod_q, r_shoup)
