"""The CKKS level, scale and rotation helpers of hehub_tpu_torch against
hehub_tpu, at n=256 as tests/test_ckks.py and tests/test_core.py run them:
rns.concat_limbs, create_ckks_params_from_bit_lengths (the same primes and
the same guards), the scalar codec, rescale_auto / rescale_to,
rotate_accumulate and hoisted_rotations (alpha=1, alpha=2 and a dropped
level), and the mixed-width mult + rescale_auto of tests/test_core.py:219,
which runs the port's mixed-width base-conversion branches. The same
ciphertexts (encrypted by the port, handed to hehub_tpu as numpy) and the
same keys (made by hehub_tpu, carried over with `convert`) give bitwise
equal results.

hehub_tpu runs its heavy operations jitted (torch_support.jit_reference_ops)."""

import types

import jax
import numpy as np
import pytest
import torch

from hehub_tpu.core import context as jcx
from hehub_tpu.core import rns as jrns
from hehub_tpu.models import ckks as jckks
from hehub_tpu.rlwe import keys as jkeys
from hehub_tpu.rlwe import rlwe as jrlwe
from hehub_tpu_torch import convert
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core import rns as trns
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.rlwe import rlwe as trlwe
from tests.torch_support import as_numpy, jit_reference_ops

N = 256
SLOTS = N // 2
RNG = np.random.default_rng(31)
STEPS = (1, 3, N // 4)  # hoisted rotations, as tests/test_ckks.py


def _rand(shape):
    return RNG.uniform(-1, 1, shape) + 1j * RNG.uniform(-1, 1, shape)


def _setup(params, jparams, seed, alpha=1, steps=(), relin=False):
    """Contexts, the port's secret key (handed to hehub_tpu as numpy) and
    hehub_tpu's rotation keys for `steps` and relinearization key, with
    their port copies."""
    ctx, jctx = tctx.make_context(params), jcx.make_context(jparams)
    assert ctx.mod_list == jctx.mod_list
    gen = torch.Generator().manual_seed(seed)
    sk = trlwe.keygen(ctx, gen)
    jsk = jrlwe.RlweSk(sk.coeffs.numpy(), as_numpy(sk.ntt), as_numpy(sk.ntt_sh))
    jrks = {s: jkeys.rot_key(jctx, jsk, s, jax.random.key(seed + s), alpha=alpha) for s in steps}
    jrlk = jkeys.relin_key(jctx, jsk, jax.random.key(seed), alpha=alpha) if relin else None
    port = lambda k: convert.rgsw_from_numpy(  # noqa: E731
        np.asarray(k.data), k.limb_ids, k.alpha, device="cpu")
    return types.SimpleNamespace(
        params=params, jparams=jparams, ctx=ctx, jctx=jctx, sk=sk, gen=gen,
        rks={s: port(k) for s, k in jrks.items()}, jrks=jrks, jrlk=jrlk,
        rlk=port(jrlk) if relin else None)


@pytest.fixture(scope="module")
def env():
    """Three configurations: tests/test_ckks.py's 3 + 1 limbs (alpha=1),
    4 + 2 limbs with alpha=2 keys, and tests/test_core.py:225's mixed-width
    chain [30, 28, 26, 24] + 30 at a 2^24 scale."""
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_ops(mp)
        base = dict(scaling_bits=28, num_levels=3, use_security_budget=False)
        hybrid = dict(scaling_bits=28, num_levels=4, use_security_budget=False, num_special=2)
        mixed = dict(special_mod_bits=30, initial_scaling_factor=2.0**24,
                     use_security_budget=False)
        yield types.SimpleNamespace(
            base=_setup(tctx.create_ckks_params(N, **base), jcx.create_ckks_params(N, **base), 300,
                        steps=STEPS + (2, 5)),
            hybrid=_setup(tctx.create_ckks_params(N, **hybrid),
                          jcx.create_ckks_params(N, **hybrid), 400, alpha=2, steps=STEPS),
            mixed=_setup(
                tctx.create_ckks_params_from_bit_lengths(N, [30, 28, 26, 24], **mixed),
                jcx.create_ckks_params_from_bit_lengths(N, [30, 28, 26, 24], **mixed), 500,
                relin=True))


def _encrypt(cfg, values):
    ct = tckks.encrypt(cfg.ctx, tckks.encode(values, cfg.params, device="cpu"), cfg.sk, cfg.gen)
    return ct, jckks.CkksCt(_jpoly(ct.c0), _jpoly(ct.c1), ct.scaling_factor)


def _jpoly(p):
    return jrns.RnsPoly(jax.numpy.asarray(as_numpy(p.data)), p.form, p.limb_ids)


def _assert_same(got, want):
    assert got.limb_ids == want.c0.limb_ids
    assert got.scaling_factor == want.scaling_factor
    np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want.c0.data))
    np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want.c1.data))


def _decode(cfg, ct):
    return tckks.decode(tckks.decrypt(cfg.ctx, ct, cfg.sk), cfg.params)


def test_concat_limbs():
    a = trns.RnsPoly(torch.from_numpy(RNG.integers(0, 1 << 30, (2, 2, 8))), "ntt", (0, 1))
    b = trns.RnsPoly(torch.from_numpy(RNG.integers(0, 1 << 30, (2, 1, 8))), "ntt", (4,))
    got = trns.concat_limbs(a, b)
    want = jrns.concat_limbs(_jpoly(a), _jpoly(b))
    assert got.limb_ids == want.limb_ids == (0, 1, 4) and got.form == want.form
    np.testing.assert_array_equal(as_numpy(got.data), np.asarray(want.data))
    with pytest.raises(ValueError):
        trns.concat_limbs(a, trns.RnsPoly(b.data, "coeff", b.limb_ids))


@pytest.mark.parametrize("args,kwargs", [
    ((256, [30, 25, 25, 23]), dict(special_mod_bits=30, use_security_budget=False)),
    ((256, [30, 28, 26, 24]), dict(special_mod_bits=30, initial_scaling_factor=2.0**24,
                                   use_security_budget=False)),
    ((1024, [24, 23]), dict(special_mod_bits=(23, 24), use_security_budget=False)),
    ((16384, [30] * 12), dict(special_mod_bits=[30, 30])),
], ids=["widths", "mixed", "two-specials", "budget"])
def test_bit_length_params_pick_the_reference_primes(args, kwargs):
    got = tctx.create_ckks_params_from_bit_lengths(*args, **kwargs)
    want = jcx.create_ckks_params_from_bit_lengths(*args, **kwargs)
    assert got.moduli == want.moduli and got.special_mods == want.special_mods
    assert got.special_mod == want.special_mod
    assert got.initial_scaling_factor == want.initial_scaling_factor
    assert got.dimension == want.dimension


@pytest.mark.parametrize("args,kwargs", [
    ((1024, [30, 30, 30]), {}),  # 4 x 30 bits above the 27-bit budget of n=1024
    ((256, [36, 30]), dict(use_security_budget=False)),  # above the uint32 limbs
    ((256, [22]), dict(use_security_budget=False)),  # below the digit planes
    ((256, []), dict(use_security_budget=False)),
    ((512, [30]), {}),  # no standard budget
], ids=["budget", "wide", "narrow", "empty", "no-budget"])
def test_bit_length_params_guards(args, kwargs):
    with pytest.raises(ValueError):
        jcx.create_ckks_params_from_bit_lengths(*args, **kwargs)
    with pytest.raises(ValueError):
        tctx.create_ckks_params_from_bit_lengths(*args, **kwargs)


def test_scalar_codec(env):
    cfg = env.base
    pt = tckks.encode_scalar(0.375, cfg.params, device="cpu")
    jpt = jckks.encode_scalar(0.375, cfg.jparams)
    np.testing.assert_array_equal(as_numpy(pt.poly.data), np.asarray(jpt.poly.data))
    assert tckks.decode_scalar(pt, cfg.params) == jckks.decode_scalar(jpt, cfg.jparams)
    assert abs(tckks.decode_scalar(pt, cfg.params) - 0.375) < 1e-8
    low = tckks.encode_scalar(-1.5, cfg.params, 2.0**30, level=1, device="cpu")
    jlow = jckks.encode_scalar(-1.5, cfg.jparams, 2.0**30, level=1)
    np.testing.assert_array_equal(as_numpy(low.poly.data), np.asarray(jlow.poly.data))
    ct = tckks.encrypt(cfg.ctx, pt, cfg.sk, cfg.gen)
    got = tckks.decode_scalar(tckks.decrypt(cfg.ctx, ct, cfg.sk), cfg.params)
    assert abs(got - 0.375) < 2**-14  # averaging n/2 slots shrinks the fresh noise


def test_mixed_width_mult_rescale_auto_and_rescale_to(env):
    """tests/test_core.py:219-239 in both packages: a product at 2^48 over
    [30, 28, 26, 24] limbs; rescale_auto drops the 24-bit limb (2^48 / q3
    >= 2^24 > 2^48 / (q3 q2)), rescale_to(2^24) the same one, and
    rescale_to(2^24 q2) none; all bitwise, and the product decodes within
    2e-4."""
    cfg = env.mixed
    va, vb = RNG.uniform(-1, 1, SLOTS), RNG.uniform(-1, 1, SLOTS)
    (ca, jca), (cb, jcb) = _encrypt(cfg, va), _encrypt(cfg, vb)
    prod = tckks.mult(cfg.ctx, ca, cb, cfg.rlk)
    jprod = jckks.mult(cfg.jctx, jca, jcb, cfg.jrlk)
    _assert_same(prod, jprod)
    auto = tckks.rescale_auto(cfg.ctx, prod)
    _assert_same(auto, jckks.rescale_auto(cfg.jctx, jprod))
    assert auto.limb_ids == (0, 1, 2)
    np.testing.assert_allclose(_decode(cfg, auto).real, va * vb, atol=2e-4)
    to = tckks.rescale_to(cfg.ctx, prod, 2.0**24)
    _assert_same(to, jckks.rescale_to(cfg.jctx, jprod, 2.0**24))
    # a floor above the scale drops nothing; a target far above it neither
    assert tckks.rescale_auto(cfg.ctx, prod, min_scale=2.0**47) is prod
    assert tckks.rescale_to(cfg.ctx, prod, 2.0**60) is prod
    one = tckks.rescale_to(cfg.ctx, prod, 2.0**24 * cfg.params.moduli[2])
    _assert_same(one, jckks.rescale_to(cfg.jctx, jprod, 2.0**24 * cfg.params.moduli[2]))


def test_rotate_accumulate(env):
    cfg = env.base
    datas = [_rand(SLOTS) for _ in range(3)]
    pairs = [_encrypt(cfg, d) for d in datas]
    steps = (0, 2, 5)
    got = tckks.rotate_accumulate(cfg.ctx, [(c, s) for (c, _), s in zip(pairs, steps)], cfg.rks)
    _assert_same(got, jckks.rotate_accumulate(
        cfg.jctx, [(j, s) for (_, j), s in zip(pairs, steps)], cfg.jrks))
    want = sum(np.roll(d, s) for d, s in zip(datas, steps))
    np.testing.assert_allclose(_decode(cfg, got), want, atol=2**-8)
    # all steps 0: the plain sum, no key switch
    got0 = tckks.rotate_accumulate(cfg.ctx, [(c, 0) for c, _ in pairs], {})
    _assert_same(got0, jckks.rotate_accumulate(cfg.jctx, [(j, 0) for _, j in pairs], {}))
    np.testing.assert_allclose(_decode(cfg, got0), sum(datas), atol=2**-8)
    with pytest.raises(ValueError):
        tckks.rotate_accumulate(cfg.ctx, [], {})
    c0 = pairs[0][0]
    with pytest.raises(ValueError):
        tckks.rotate_accumulate(cfg.ctx, [(c0, 0), (tckks.CkksCt(c0.c0, c0.c1, 2.0), 0)], {})


@pytest.mark.parametrize("which,drop", [("base", 0), ("base", 1), ("hybrid", 0), ("hybrid", 1)],
                         ids=["alpha1", "alpha1-dropped", "alpha2", "alpha2-dropped"])
def test_hoisted_rotations(env, which, drop):
    """One digit decomposition for three rotations, bitwise against
    hehub_tpu's hoisted_rotations (not against rotate: other residue
    representatives), and within 2^-9 of np.roll; a dropped level slices
    the keys (at_level), at alpha=2 cutting a digit group."""
    cfg = getattr(env, which)
    data = _rand(SLOTS)
    ct, jct = _encrypt(cfg, data)
    if drop:
        ct, jct = tckks.mod_drop(cfg.ctx, ct, drop), jckks.mod_drop(cfg.jctx, jct, drop)
    got = tckks.hoisted_rotations(cfg.ctx, ct, cfg.rks, STEPS)
    want = jckks.hoisted_rotations(cfg.jctx, jct, cfg.jrks, STEPS)
    assert list(got) == list(want) == list(STEPS)
    for step in STEPS:
        _assert_same(got[step], want[step])
        np.testing.assert_allclose(_decode(cfg, got[step]), np.roll(data, step), atol=2**-9)
    assert tckks.hoisted_rotations(cfg.ctx, ct, cfg.rks, []) == {}
