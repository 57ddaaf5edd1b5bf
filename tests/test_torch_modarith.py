"""hehub_tpu_torch.ops.modarith against hehub_tpu.ops.modarith: every
operation bitwise on random lazy residues and on the edge values 0, q-1,
2q-1 (and 2^32-1 for Shoup's any-uint32 domain); mul_hi against Python
ints."""

import numpy as np
import pytest
import torch

from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.ops import modarith as tma
from tests.torch_support import Reference

jnp = Reference("jax.numpy")
jcx = Reference("hehub_tpu.core.context")
jma = Reference("hehub_tpu.ops.modarith")

RNG = np.random.default_rng(7)
# the port's tables, bitwise the reference's (tests/test_torch_context.py)
CTX = tctx.make_context(tctx.create_ckks_params(1024, 28, 2, use_security_budget=False))
LIMB = 0
Q = int(CTX.q[LIMB, 0])
CONST = {nm: int(getattr(CTX, nm)[LIMB, 0])
         for nm in ("q", "two_q", "neg_qinv", "r_mod_q", "r_shoup", "r2_mod_q")}


def _lazy(size):
    """Lazy residues in [0, 2q) with the edge values up front."""
    edge = np.asarray([0, 1, Q - 1, Q, 2 * Q - 1], np.uint32)
    return np.concatenate([edge, RNG.integers(0, 2 * Q, size).astype(np.uint32)])


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(jax_out, torch_out):
    np.testing.assert_array_equal(np.asarray(jax_out), torch_out.numpy().astype(np.uint32))


def test_mul_hi_and_wide_against_python_ints():
    a = np.concatenate([[0, 1, 0xFFFFFFFF, 0xFFFFFFFF, 1 << 31],
                        RNG.integers(0, 1 << 32, 4000)]).astype(np.uint64)
    b = np.concatenate([[0xFFFFFFFF, 0xFFFFFFFF, 0xFFFFFFFF, 1, 1 << 31],
                        RNG.integers(0, 1 << 32, 4000)]).astype(np.uint64)
    hi, lo = tma.mul_wide(_t(a), _t(b))
    exact = [int(x) * int(y) for x, y in zip(a, b)]
    assert hi.tolist() == [p >> 32 for p in exact]
    assert lo.tolist() == [p & 0xFFFFFFFF for p in exact]
    _same(jma.mul_hi(a.astype(np.uint32), b.astype(np.uint32)), hi)


@pytest.mark.parametrize("op", ["add_lazy", "sub_lazy", "mont_mul_lazy", "mul_mod_lazy"])
def test_binary_ops_bitwise(op):
    a, b = _lazy(4000), _lazy(4000)[::-1].copy()
    args = {
        "add_lazy": (CONST["two_q"],),
        "sub_lazy": (CONST["two_q"],),
        "mont_mul_lazy": (CONST["q"], CONST["neg_qinv"]),
        "mul_mod_lazy": (CONST["q"], CONST["neg_qinv"], CONST["r_mod_q"], CONST["r_shoup"]),
    }[op]
    want = getattr(jma, op)(jnp.asarray(a), jnp.asarray(b), *(np.uint32(c) for c in args))
    _same(want, getattr(tma, op)(_t(a), _t(b), *args))


@pytest.mark.parametrize("op", ["neg_lazy", "reduce_strict", "to_mont", "from_mont"])
def test_unary_ops_bitwise(op):
    a = _lazy(4000)
    args = {
        "neg_lazy": (CONST["two_q"],),
        "reduce_strict": (CONST["q"],),
        "to_mont": (CONST["q"], CONST["neg_qinv"], CONST["r2_mod_q"]),
        "from_mont": (CONST["q"], CONST["neg_qinv"]),
    }[op]
    want = getattr(jma, op)(jnp.asarray(a), *(np.uint32(c) for c in args))
    _same(want, getattr(tma, op)(_t(a), *args))


def test_shoup_mul_any_uint32():
    x = np.concatenate([[0, Q - 1, 2 * Q - 1, 4 * Q - 1, 0xFFFFFFFF, 1 << 31],
                        RNG.integers(0, 1 << 32, 4000)]).astype(np.uint32)
    w = int(RNG.integers(0, Q))
    w_sh = (w << 32) // Q
    got = tma.shoup_mul_lazy(_t(x), w, w_sh, Q)
    _same(jma.shoup_mul_lazy(jnp.asarray(x), np.uint32(w), np.uint32(w_sh), np.uint32(Q)), got)
    assert bool((got < 2 * Q).all())
    np.testing.assert_array_equal(got.numpy() % Q, x.astype(np.int64) * w % Q)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_reduce_add_lazy_bitwise(k):
    x = np.stack([_lazy(500) for _ in range(k)], axis=1)  # [505, k]
    want = jma.reduce_add_lazy(jnp.asarray(x), 1, np.uint32(CONST["two_q"]))
    _same(want, tma.reduce_add_lazy(_t(x), 1, CONST["two_q"]))


@pytest.mark.parametrize(
    "op", ["add", "sub", "neg", "mul", "mul_scalar", "reduce_strict", "take_limbs", "drop_last_limb"]
)
def test_rns_ops_bitwise(op):
    """hehub_tpu_torch.core.rns against hehub_tpu.core.rns, over limbs (2, 0, 1)."""
    from hehub_tpu.core import rns as jrns
    from hehub_tpu_torch.core import rns as trns

    ids = (2, 0, 1)
    tc = CTX
    jc = jcx.make_context(jcx.create_ckks_params(1024, 28, 2, use_security_budget=False))
    two_q = 2 * CTX.q[list(ids)].astype(np.int64)
    a = (RNG.integers(0, 1 << 62, (2, 3, 1024)) % two_q).astype(np.uint32)
    b = (RNG.integers(0, 1 << 62, (2, 3, 1024)) % two_q).astype(np.uint32)
    ja, jb = jrns.RnsPoly(jnp.asarray(a), jrns.NTT, ids), jrns.RnsPoly(jnp.asarray(b), jrns.NTT, ids)
    ta, tb = trns.RnsPoly(_t(a), trns.NTT, ids), trns.RnsPoly(_t(b), trns.NTT, ids)
    scalars = [5, 1 << 40, Q - 1]
    want, got = {
        "add": lambda: (jrns.add(jc, ja, jb), trns.add(tc, ta, tb)),
        "sub": lambda: (jrns.sub(jc, ja, jb), trns.sub(tc, ta, tb)),
        "neg": lambda: (jrns.neg(jc, ja), trns.neg(tc, ta)),
        "mul": lambda: (jrns.mul(jc, ja, jb), trns.mul(tc, ta, tb)),
        "mul_scalar": lambda: (jrns.mul_scalar(jc, ja, scalars), trns.mul_scalar(tc, ta, scalars)),
        "reduce_strict": lambda: (jrns.reduce_strict(jc, ja), trns.reduce_strict(tc, ta)),
        "take_limbs": lambda: (jrns.take_limbs(ja, (2, 0)), trns.take_limbs(ta, (2, 0))),
        "drop_last_limb": lambda: (jrns.drop_last_limb(ja), trns.drop_last_limb(ta)),
    }[op]()
    assert got.limb_ids == want.limb_ids and got.form == want.form
    _same(want.data, got.data)
