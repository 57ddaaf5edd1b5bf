"""The circuits of hehub_tpu_torch (circuits/linear_algebra.py,
circuits/poly_eval.py) against hehub_tpu's, at the n=256, 10-level
parameters of tests/test_poly_eval.py: the same ciphertexts (encrypted by
the port, handed to hehub_tpu as numpy arrays) and the same keys (made by
hehub_tpu, carried over with `convert`) give bitwise equal ciphertexts,
scaling factors and limbs; and each result decodes within the reference
tests' own bounds.

hehub_tpu runs its heavy operations jitted (torch_support.jit_reference_ops),
which gives the same bits in a fraction of the eager compile time."""

import types

import jax
import numpy as np
import pytest
import torch

from hehub_tpu.circuits import linear_algebra as jla
from hehub_tpu.circuits import poly_eval as jpe
from hehub_tpu.core import rns as jrns
from hehub_tpu.core.context import create_ckks_params as j_create_params
from hehub_tpu.core.context import make_context as j_make_context
from hehub_tpu.models import ckks as jckks
from hehub_tpu.rlwe import keys as jkeys
from hehub_tpu.rlwe import rlwe as jrlwe
from hehub_tpu_torch import convert
from hehub_tpu_torch.circuits import linear_algebra as tla
from hehub_tpu_torch.circuits import poly_eval as tpe
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.rlwe import rlwe as trlwe
from tests.torch_support import as_numpy, jit_reference_ops

N = 256
SLOTS = N // 2
LEVELS = 10
MV = 8  # the narrow matrices: 8 x 8


@pytest.fixture(scope="module")
def env():
    """Both packages' parameters, contexts, secret key (the port's keygen,
    handed over as numpy), relinearization key and the narrow product's
    rotation keys (hehub_tpu's, carried over)."""
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_ops(mp)
        params = tctx.create_ckks_params(N, 28, LEVELS, use_security_budget=False)
        jparams = j_create_params(N, 28, LEVELS, use_security_budget=False)
        assert params.moduli == jparams.moduli and params.special_mod == jparams.special_mod
        ctx, jctx = tctx.make_context(params), j_make_context(jparams)
        gen = torch.Generator().manual_seed(11)
        sk = trlwe.keygen(ctx, gen)
        jsk = jrlwe.RlweSk(sk.coeffs.numpy(), as_numpy(sk.ntt), as_numpy(sk.ntt_sh))
        jrlk = jkeys.relin_key(jctx, jsk, jax.random.key(1))
        steps = sorted(set(jla.mv_mul_requiring_steps(SLOTS, MV)))
        jrks = {s: jkeys.rot_key(jctx, jsk, s, jax.random.key(100 + s)) for s in steps}
        to_port = lambda k: convert.rgsw_from_numpy(  # noqa: E731
            np.asarray(k.data), k.limb_ids, k.alpha, device="cpu")
        yield types.SimpleNamespace(
            params=params, jparams=jparams, ctx=ctx, jctx=jctx, sk=sk, gen=gen,
            rlk=to_port(jrlk), jrlk=jrlk, rks={s: to_port(k) for s, k in jrks.items()},
            jrks=jrks)


def _encrypt(env, values):
    """The port's encryption of `values` [..., slots] and the same
    ciphertext as a hehub_tpu CkksCt."""
    ct = tckks.encrypt(env.ctx, tckks.encode(values, env.params, device="cpu"), env.sk, env.gen)
    jpoly = lambda p: jrns.RnsPoly(jax.numpy.asarray(as_numpy(p.data)), p.form,  # noqa: E731
                                   p.limb_ids)
    return ct, jckks.CkksCt(jpoly(ct.c0), jpoly(ct.c1), ct.scaling_factor)


def _assert_same(got, want):
    assert got.limb_ids == want.c0.limb_ids
    assert got.scaling_factor == want.scaling_factor
    np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want.c0.data))
    np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want.c1.data))


def _decode(env, ct):
    return tckks.decode(tckks.decrypt(env.ctx, ct, env.sk), env.params)


def test_requiring_steps():
    for slots, width in ((64, 4), (SLOTS, MV), (8192, 64)):
        assert tla.mv_mul_requiring_steps(slots, width) == jla.mv_mul_requiring_steps(slots, width)


@pytest.mark.parametrize("batch", [(), (3,)], ids=["narrow", "batched"])
def test_matrix_vector_mul(env, batch):
    """The narrow (hoisted) diagonal-method product, one ciphertext and a
    batch of three: bitwise, and within 2^-7 (tests/test_linalg.py) of
    numpy's product, 2^-6 batched."""
    rng = np.random.default_rng(5 + len(batch))
    mat = rng.uniform(-1, 1, (MV, MV))
    vec = np.zeros((*batch, SLOTS))
    vec[..., :MV] = rng.uniform(-1, 1, (*batch, MV))
    ct, jct = _encrypt(env, vec)
    got = tla.matrix_vector_mul(env.ctx, env.params, mat, ct, env.rks)
    _assert_same(got, jla.matrix_vector_mul(env.jctx, env.jparams, mat, jct, env.jrks))
    np.testing.assert_allclose(_decode(env, got)[..., :MV].real, vec[..., :MV] @ mat.T,
                               atol=2**-7 if not batch else 2**-6)


def test_power_basis(env):
    v = np.random.default_rng(0).uniform(-1, 1, SLOTS)
    ct, jct = _encrypt(env, v)
    got = tpe.power_basis(env.ctx, ct, 5, env.rlk)
    want = jpe.power_basis(env.jctx, jct, 5, env.jrlk)
    assert sorted(got) == sorted(want) == [1, 2, 3, 4, 5]
    for i in range(2, 6):
        _assert_same(got[i], want[i])
        np.testing.assert_allclose(_decode(env, got[i]).real, v**i, atol=2e-3)


@pytest.mark.parametrize("coeffs,atol", [([0.25, -1.0, 0.5, 2.0], 5e-3),
                                         ([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, -0.5], 1e-2)],
                         ids=["cubic", "degree7"])
def test_poly_eval(env, coeffs, atol):
    v = np.random.default_rng(len(coeffs)).uniform(-1, 1, SLOTS)
    ct, jct = _encrypt(env, v)
    got = tpe.poly_eval(env.ctx, env.params, ct, coeffs, env.rlk)
    _assert_same(got, jpe.poly_eval(env.jctx, env.jparams, jct, coeffs, env.jrlk))
    assert got.scaling_factor == env.params.initial_scaling_factor
    np.testing.assert_allclose(_decode(env, got).real, np.polynomial.polynomial.polyval(v, coeffs),
                               atol=atol)


def test_inverse(env):
    v = np.random.default_rng(3).uniform(0.6, 1.4, SLOTS)
    ct, jct = _encrypt(env, v)
    got = tpe.inverse(env.ctx, env.params, ct, env.rlk, iterations=3)
    _assert_same(got, jpe.inverse(env.jctx, env.jparams, jct, env.jrlk, iterations=3))
    np.testing.assert_allclose(_decode(env, got).real, 1.0 / v, rtol=3e-2)


def test_sign(env):
    rng = np.random.default_rng(4)
    v = np.concatenate([rng.uniform(0.6, 1, SLOTS // 2), rng.uniform(-1, -0.6, SLOTS // 2)])
    ct, jct = _encrypt(env, v)
    got = tpe.sign(env.ctx, env.params, ct, env.rlk, iterations=2)
    _assert_same(got, jpe.sign(env.jctx, env.jparams, jct, env.jrlk, iterations=2))
    assert np.all(np.abs(_decode(env, got).real - np.sign(v)) < 0.15)


def test_rebase_scale_and_align_level_guards(env):
    ct, jct = _encrypt(env, np.ones(SLOTS))
    low = tckks.mod_drop(env.ctx, ct, 2)
    with pytest.raises(ValueError):
        tpe.align_level(env.ctx, low, ct.c0.limb_count)
    with pytest.raises(ValueError):
        jpe.align_level(env.jctx, jckks.mod_drop(env.jctx, jct, 2), jct.c0.limb_count)
    assert tpe.align_level(env.ctx, ct, ct.c0.limb_count) is ct
    # a scale already far above Δ·q_drop cannot be rebased down by a plaintext
    high = tckks.CkksCt(ct.c0, ct.c1, ct.scaling_factor * 2.0**40)
    with pytest.raises(ValueError):
        tpe.rebase_scale(env.ctx, env.params, high)
