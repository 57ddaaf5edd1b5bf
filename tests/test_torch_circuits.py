"""The circuits of hehub_tpu_torch (circuits/linear_algebra.py,
circuits/poly_eval.py) against hehub_tpu's, at the n=256, 10-level
parameters of tests/test_poly_eval.py: the same ciphertexts (encrypted by
the port, handed to hehub_tpu as numpy arrays) and the same keys (made by
hehub_tpu, carried over with `convert`) give bitwise equal ciphertexts,
scaling factors and limbs; and each result decodes within the reference
tests' own bounds.

hehub_tpu runs its heavy operations jitted (torch_support.jit_reference_ops),
which gives the same bits in a fraction of the eager compile time. On the
card, the circuits with keys made there, at alpha=2, at n=256 and n=16384,
against numpy and bitwise against the same circuits on the CPU."""

import types

import numpy as np
import pytest
import torch

from hehub_tpu_torch import config, convert, kernels
from hehub_tpu_torch.circuits import linear_algebra as tla
from hehub_tpu_torch.circuits import poly_eval as tpe
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.rlwe import keys as tkeys
from hehub_tpu_torch.rlwe import rlwe as trlwe
from tests.torch_support import (Reference, as_numpy, cuda_device,  # noqa: F401
                                 jit_reference_ops, to_device)

jax = Reference("jax")
jla = Reference("hehub_tpu.circuits.linear_algebra")
jpe = Reference("hehub_tpu.circuits.poly_eval")
jrns = Reference("hehub_tpu.core.rns")
jcx = Reference("hehub_tpu.core.context")
jckks = Reference("hehub_tpu.models.ckks")
jkeys = Reference("hehub_tpu.rlwe.keys")
jrlwe = Reference("hehub_tpu.rlwe.rlwe")

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
        jparams = jcx.create_ckks_params(N, 28, LEVELS, use_security_budget=False)
        assert params.moduli == jparams.moduli and params.special_mod == jparams.special_mod
        ctx, jctx = tctx.make_context(params), jcx.make_context(jparams)
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


ACC_STEPS = (0, 2, 5)


def _circuits(ctx, params, cts, rlk, rks):
    """The circuits on the card, each a ciphertext: matrix_vector_mul
    (hoisted rotations), sign, inverse, rotate_accumulate."""
    return dict(
        matrix_vector_mul=tla.matrix_vector_mul(ctx, params, cts["mat"], cts["vec"], rks),
        sign=tpe.sign(ctx, params, cts["sign"], rlk, iterations=2),
        inverse=tpe.inverse(ctx, params, cts["inverse"], rlk, iterations=3),
        rotate_accumulate=tckks.rotate_accumulate(ctx, list(zip(cts["acc"], ACC_STEPS)), rks))


@pytest.mark.cuda
@pytest.mark.parametrize("n,levels,mv,mv_bound",
                         [(N, LEVELS, MV, 2.0**-6), (16384, 12, 64, 2.0**-7)])
def test_circuits_on_card_are_cpu(cuda_device, monkeypatch, n, levels, mv, mv_bound):  # noqa: F811
    """The circuits at alpha=2, a batch of 2, keys made on the card: at
    n=256 on 10 + 2 limbs with an 8 x 8 matrix, and on std128.ks_b64's
    n=16384, 12 + 2 limbs, with a 64 x 64 matrix (126 rotation keys).
    Decoded within the reference tests' bounds (tests/test_linalg.py,
    tests/test_poly_eval.py, tests/test_ckks.py), K1, K2, ModUp, K4 and K5
    launched, and the same circuits on the CPU (the device codec's plain
    version for the encodes inside them) bitwise the card's ciphertexts,
    scales and limbs."""
    params = tctx.create_ckks_params(n, 28, levels, use_security_budget=False, num_special=2)
    ctx = tctx.make_context(params)
    slots = n // 2
    rng = np.random.default_rng(21)
    vec = np.zeros((2, slots))
    vec[:, :mv] = rng.uniform(-1, 1, (2, mv))
    inputs = dict(mat=rng.uniform(-1, 1, (mv, mv)), vec=vec,
                  sign=rng.uniform(0.6, 1, (2, slots)) * rng.choice([-1.0, 1.0], (2, slots)),
                  inverse=rng.uniform(0.6, 1.4, (2, slots)),
                  acc=[rng.uniform(-1, 1, (2, slots)) for _ in ACC_STEPS])
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    kernels.reset_launch_counts()
    sk = trlwe.keygen(ctx, gen)
    rlk = tkeys.relin_key(ctx, sk, gen, alpha=2)
    steps = sorted(set(tla.mv_mul_requiring_steps(slots, mv)) | set(ACC_STEPS) - {0})
    rks = {s: tkeys.rot_key(ctx, sk, s, gen, alpha=2) for s in steps}
    enc = lambda v: tckks.encrypt(ctx, tckks.encode(v, params, device=cuda_device), sk, gen)  # noqa: E731
    cts = dict(mat=inputs["mat"], vec=enc(vec), sign=enc(inputs["sign"]),
               inverse=enc(inputs["inverse"]), acc=[enc(v) for v in inputs["acc"]])
    outs = _circuits(ctx, params, cts, rlk, rks)
    dec = {k: tckks.decode(tckks.decrypt(ctx, ct, sk), params) for k, ct in outs.items()}
    torch.cuda.synchronize()
    for kind in ("ntt_fwd", "ntt_inv", "modup", "ext_prod_conv", "fft"):
        assert kernels.LAUNCHES[kind] > 0, kind
    assert np.abs(dec["matrix_vector_mul"][:, :mv].real - vec[:, :mv] @ inputs["mat"].T).max() \
        <= mv_bound
    assert np.abs(dec["sign"].real - np.sign(inputs["sign"])).max() < 0.15
    np.testing.assert_allclose(dec["inverse"].real, 1.0 / inputs["inverse"], rtol=3e-2)
    want = sum(np.roll(v, s, axis=-1) for v, s in zip(inputs["acc"], ACC_STEPS))
    assert np.abs(dec["rotate_accumulate"] - want).max() <= 2.0**-8

    monkeypatch.setattr(config, "use_device_codec", True)
    cpu = _circuits(ctx, params, to_device(cts, "cpu"), *to_device((rlk, rks), "cpu"))
    for name, got in outs.items():
        want = cpu[name]
        assert got.c0.limb_ids == want.c0.limb_ids, name
        assert got.scaling_factor == want.scaling_factor, name
        assert torch.equal(got.c0.data.cpu(), want.c0.data), name
        assert torch.equal(got.c1.data.cpu(), want.c1.data), name
