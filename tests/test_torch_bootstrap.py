"""CKKS bootstrapping of hehub_tpu_torch (circuits/bootstrap.py,
circuits/boot_artifact.py) against hehub_tpu's, at n=128 on one parameter
set, make_boot_params(128, 20, two_limb_scale=False): the matrices, the
rotation steps, the Chebyshev helpers and the parameters (numpy, equal);
mod_raise, a linear transform of a random matrix, the dense
coeff_to_slot/slot_to_coeff, eval_mod at degree 15 (plain, double angle,
arcsine), cheb_eval of 1 + T_4 and one whole factored refresh, each on the
same ciphertexts and keys (made by hehub_tpu, carried over with `convert`),
bitwise in ciphertexts, limbs and scale. Then the port's own
CompiledBootstrapper (monolithic, split) and boot_artifact round trip
against the eager refresh, bitwise. On the card: the captured refresh
bitwise equal to the eager one at n=128 and n=1024, mod_raise bitwise equal
to the CPU's, and no host synchronisation in a warm eager refresh.

hehub_tpu runs its heavy operations jitted (torch_support.jit_reference_ops,
for the whole module, from the `env` fixture); every stage test enters at
a level the whole refresh goes through, and the whole refresh comes after
them, so it reuses the functions that they compiled. JAX is imported
inside the fixtures that use it, so the card tests also run where JAX is
not installed."""

import os
import pathlib
import types

import numpy as np
import pytest
import torch

from hehub_tpu_torch import convert
from hehub_tpu_torch.circuits import boot_artifact
from hehub_tpu_torch.circuits import bootstrap as bs
from hehub_tpu_torch.core.context import make_context
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from tests.torch_support import as_numpy, cuda_device, jit_reference_ops  # noqa: F401

N = 128
SLOTS = N // 2
LEVELS = 20
LT_STAGES = 2
DEGREE = 31
K_BOUND = 5
D_IN = 2.0**22
CPU = "cpu"
# the level (limbs) at which the refresh's EvalMod starts: 20 limbs, minus
# the two factored C2S stages
EVALMOD_LIMBS = LEVELS - LT_STAGES


def _params():
    return bs.make_boot_params(N, LEVELS, two_limb_scale=False)


@pytest.fixture(scope="module")
def env():
    """Both packages' parameters and contexts; hehub_tpu's sparse secret
    (h=8), relinearization key, conjugation key and the rotation keys of the
    dense and the factored transforms, and the port's copies of them."""
    import jax

    from hehub_tpu.circuits import bootstrap as jbs
    from hehub_tpu.core.context import make_context as j_make_context
    from hehub_tpu.rlwe import keys as jkeys
    from hehub_tpu.rlwe import rlwe as jrlwe

    # XLA's CPU optimizations off for the module: the jitted reference
    # operations are integer arithmetic, whose bits do not depend on them,
    # and compiling them takes half the time
    no_opt = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_ops(mp)
        params, jparams = _params(), jbs.make_boot_params(N, LEVELS, two_limb_scale=False)
        ctx, jctx = make_context(params), j_make_context(jparams)
        jsk = jrlwe.keygen(jctx, jax.random.key(0), hamming_weight=8)
        jrlk = jkeys.relin_key(jctx, jsk, jax.random.key(1))
        steps = sorted(set(jbs.bootstrap_rotation_steps(jparams))
                       | set(jbs.bootstrap_rotation_steps(jparams, LT_STAGES)))
        jrks = {st: jkeys.rot_key(jctx, jsk, st, jax.random.key(100 + st)) for st in steps}
        jck = jkeys.conj_key(jctx, jsk, jax.random.key(5))
        to_port = lambda k: convert.rgsw_from_numpy(  # noqa: E731
            np.asarray(k.data), k.limb_ids, k.alpha, device=CPU)
        sk = convert.sk_from_numpy(jsk.coeffs, np.asarray(jsk.ntt), np.asarray(jsk.ntt_sh),
                                   device=CPU)
        yield types.SimpleNamespace(
            jbs=jbs, params=params, jparams=jparams, ctx=ctx, jctx=jctx, sk=sk,
            gen=torch.Generator().manual_seed(13), rlk=to_port(jrlk), jrlk=jrlk,
            rks={st: to_port(k) for st, k in jrks.items()}, jrks=jrks, ck=to_port(jck), jck=jck)
    jax.config.update("jax_disable_most_optimizations", no_opt)


def _encrypt(env, values, scale=None, limbs=LEVELS):
    """The port's encryption of `values` at `limbs` limbs and the same
    ciphertext as a hehub_tpu CkksCt."""
    import jax

    from hehub_tpu.core import rns as jrns
    from hehub_tpu.models import ckks as jckks

    pt = ckks.encode(values, env.params, scaling_factor=scale, level=LEVELS - limbs, device=CPU)
    ct = ckks.encrypt(env.ctx, pt, env.sk, env.gen)
    jpoly = lambda p: jrns.RnsPoly(jax.numpy.asarray(as_numpy(p.data)), p.form,  # noqa: E731
                                   p.limb_ids)
    return ct, jckks.CkksCt(jpoly(ct.c0), jpoly(ct.c1), ct.scaling_factor)


def _assert_same(got, want):
    assert got.c0.limb_ids == want.c0.limb_ids
    assert got.scaling_factor == want.scaling_factor
    np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want.c0.data))
    np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want.c1.data))


def _decode(env, ct):
    return ckks.decode(ckks.decrypt(env.ctx, ct, env.sk), env.params)


@pytest.fixture(scope="module")
def refresh(env):
    """An exhausted ciphertext in both packages, and the port's factored
    refresh of it (lt_stages=2, degree 31) with its Bootstrapper."""
    v = np.random.default_rng(3).uniform(-1, 1, SLOTS)
    ct, jct = _encrypt(env, v, D_IN, limbs=1)
    mk = lambda: bs.Bootstrapper(env.ctx, env.params, env.rlk, env.rks, env.ck,  # noqa: E731
                                 k_bound=K_BOUND, degree=DEGREE, lt_stages=LT_STAGES)
    booter = mk()
    return types.SimpleNamespace(ct=ct, jct=jct, v=v, booter=booter, out=booter(ct),
                                 make_booter=mk)


# ---------------------------------------------------------------------------
# numpy parts
# ---------------------------------------------------------------------------


def test_matrices(env):
    jbs = env.jbs
    np.testing.assert_array_equal(bs._decode_matrix(N), jbs._decode_matrix(N))
    for got, want in zip(bs._c2s_s2c_matrices(N), jbs._c2s_s2c_matrices(N)):
        np.testing.assert_array_equal(got, want)
    (ms, rev, e), (jms, jrev, je) = bs._butterfly_factors(N), jbs._butterfly_factors(N)
    for got, want in zip(ms + (rev, e), jms + (jrev, je)):
        np.testing.assert_array_equal(got, want)
    for k in (1, 2, 3):
        for got, want in zip(bs._merged_chain_matrices(N, k), jbs._merged_chain_matrices(N, k)):
            assert len(got) == len(want) == k
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("lt_stages", [0, 1, 2, 3])
@pytest.mark.parametrize("n", [128, 256])
def test_rotation_steps(env, n, lt_stages):
    params = bs.make_boot_params(n, 8)
    want = env.jbs.bootstrap_rotation_steps(env.jbs.make_boot_params(n, 8), lt_stages)
    assert bs.bootstrap_rotation_steps(params, lt_stages) == want
    assert bs.linear_transform_steps(n // 2) == env.jbs.linear_transform_steps(n // 2)
    assert bs._bsgs_split(n // 2) == env.jbs._bsgs_split(n // 2)


def test_chebyshev_helpers(env):
    jbs = env.jbs
    for fn, a, b, deg in ((lambda x: np.sin(2 * np.pi * x) / (2 * np.pi), -5.5, 5.5, 63),
                          (lambda x: np.cos(2 * np.pi * (x - 0.25) / 2), -1.5, 1.5, 15)):
        np.testing.assert_array_equal(bs.chebyshev_coeffs(fn, a, b, deg),
                                      jbs.chebyshev_coeffs(fn, a, b, deg))
    c = list(np.random.default_rng(4).uniform(-1, 1, 12))
    for m in (6, 8, 11):
        assert bs._cheb_divmod(c, m) == jbs._cheb_divmod(c, m)
    with pytest.raises(ValueError):
        bs._cheb_divmod(c, 5)
    assert bs._eff_deg([1.0, 2.0, 0.0, 0.0]) == jbs._eff_deg([1.0, 2.0, 0.0, 0.0]) == 1
    assert (bs._ARCSINE_C3, bs._ARCSINE_C5, bs._ARCSINE_C7) == (
        jbs._ARCSINE_C3, jbs._ARCSINE_C5, jbs._ARCSINE_C7)


@pytest.mark.parametrize("args", [(128, 20, 1, False), (128, 16, 1, True), (1024, 28, 2, True),
                                  (4096, 28, 3, True), (256, 3, 1, True), (256, 1, 1, False)],
                         ids=["n128", "n128-two-limb", "n1024", "bench-n4096", "few-levels",
                              "one-level"])
def test_make_boot_params(env, args):
    n, levels, special, two_limb = args
    got = bs.make_boot_params(n, levels, num_special=special, two_limb_scale=two_limb)
    want = env.jbs.make_boot_params(n, levels, num_special=special, two_limb_scale=two_limb)
    assert got.moduli == want.moduli and got.special_mod == want.special_mod
    assert got.initial_scaling_factor == want.initial_scaling_factor
    assert got.dimension == want.dimension == n


# ---------------------------------------------------------------------------
# homomorphic stages, bitwise against hehub_tpu
# ---------------------------------------------------------------------------


def test_mod_raise(env, refresh):
    got = bs.mod_raise(env.ctx, refresh.ct)
    want = env.jbs.mod_raise(env.jctx, refresh.jct)
    assert got.c0.limb_count == LEVELS and got.scaling_factor == float(env.ctx.mod_list[0])
    _assert_same(got, want)


def test_linear_transform_random_matrix(env):
    rng = np.random.default_rng(1)
    z = rng.uniform(-1, 1, SLOTS) + 1j * rng.uniform(-1, 1, SLOTS)
    M = rng.uniform(-1, 1, (SLOTS, SLOTS)) + 1j * rng.uniform(-1, 1, (SLOTS, SLOTS))
    ct, jct = _encrypt(env, z)
    got = bs.linear_transform(env.ctx, env.params, M, ct, env.rks)
    want = env.jbs.linear_transform(env.jctx, env.jparams, M, jct, env.jrks)
    _assert_same(got, want)
    np.testing.assert_allclose(_decode(env, got), M @ z, atol=1e-3)


def test_coeff_to_slot_and_back(env, refresh):
    """The dense module-level coeff_to_slot on the mod-raised ciphertext and
    slot_to_coeff of its two halves."""
    raised = bs.mod_raise(env.ctx, refresh.ct)
    jraised = env.jbs.mod_raise(env.jctx, refresh.jct)
    got = bs.coeff_to_slot(env.ctx, env.params, raised, env.rks, env.ck)
    want = env.jbs.coeff_to_slot(env.jctx, env.jparams, jraised, env.jrks, env.jck)
    for g, w in zip(got, want):
        _assert_same(g, w)
    back = bs.slot_to_coeff(env.ctx, env.params, *got, env.rks)
    _assert_same(back, env.jbs.slot_to_coeff(env.jctx, env.jparams, *want, env.jrks))
    np.testing.assert_allclose(_decode(env, back), _decode(env, raised), atol=1e-2)


@pytest.mark.parametrize("variant", [dict(), dict(double_angle=1), dict(arcsine=True)],
                         ids=["plain", "double-angle", "arcsine"])
def test_eval_mod(env, variant):
    """Degree 15 on I + frac (k_bound=1) at the refresh's EvalMod level."""
    rng = np.random.default_rng(3)
    frac = rng.uniform(-1e-3, 1e-3, SLOTS)
    ct, jct = _encrypt(env, rng.integers(-1, 2, SLOTS).astype(float) + frac,
                       limbs=EVALMOD_LIMBS)
    got = bs.eval_mod(env.ctx, env.params, ct, env.rlk, 1, 15, **variant)
    want = env.jbs.eval_mod(env.jctx, env.jparams, jct, env.jrlk, 1, 15, **variant)
    _assert_same(got, want)
    if not variant:  # tests/test_bootstrap.py::test_eval_mod_small_degree's bound
        np.testing.assert_allclose(_decode(env, got).real, frac, atol=3e-4)


def test_cheb_eval_constant_remainder(env):
    x = np.random.default_rng(7).uniform(-1, 1, SLOTS)
    ct, jct = _encrypt(env, x, limbs=EVALMOD_LIMBS)
    coeffs = [1.0, 0.0, 0.0, 0.0, 0.5]
    got = bs.cheb_eval(env.ctx, env.params, ct, coeffs, env.rlk)
    want = env.jbs.cheb_eval(env.jctx, env.jparams, jct, coeffs, env.jrlk)
    _assert_same(got, want)
    np.testing.assert_allclose(_decode(env, got).real,
                               np.polynomial.chebyshev.chebval(x, coeffs), atol=1e-4)


def test_full_refresh(env, refresh):
    """One whole factored refresh: the same ciphertexts, limbs and scale,
    and the same plans (plaintexts bitwise)."""
    jbooter = env.jbs.Bootstrapper(env.jctx, env.jparams, env.jrlk, env.jrks, env.jck,
                                   k_bound=K_BOUND, degree=DEGREE, lt_stages=LT_STAGES)
    _assert_same(refresh.out, jbooter(refresh.jct))
    assert refresh.out.c0.limb_count >= 3
    assert sorted(refresh.booter._plans) == sorted(jbooter._plans)
    for key, plan in refresh.booter._plans.items():
        jplan = jbooter._plans[key]
        assert sorted(plan.pts) == sorted(jplan.pts) and plan.pt_scale == jplan.pt_scale
        for gb, pt in plan.pts.items():
            np.testing.assert_array_equal(as_numpy(pt.data), np.asarray(jplan.pts[gb].data))
    # a second refresh reuses every plan
    n_plans = len(refresh.booter._plans)
    again = refresh.booter(refresh.ct)
    assert len(refresh.booter._plans) == n_plans
    assert torch.equal(again.c0.data, refresh.out.c0.data)


# ---------------------------------------------------------------------------
# the port's compiled refresh and its artifact (no JAX counterpart here)
# ---------------------------------------------------------------------------


def _same_ct(got, want):
    return (got.c0.limb_ids == want.c0.limb_ids and got.scaling_factor == want.scaling_factor
            and torch.equal(got.c0.data, want.c0.data) and torch.equal(got.c1.data, want.c1.data))


def test_compiled_matches_eager(env, refresh):
    """Monolithic and split CompiledBootstrapper (on the CPU: the stage
    functions run eagerly) against the eager refresh, bitwise; the split
    one has four stages and one EvalMod stage for both halves. The first
    is built on a fresh Bootstrapper, so its discovery records every plan."""
    mono = bs.CompiledBootstrapper(refresh.make_booter(), refresh.ct)
    assert set(mono.timings) == {"discovery", "materialize", "capture"}
    assert mono.timings["materialize"] > 0.0
    assert _same_ct(mono(refresh.ct), refresh.out)
    with pytest.raises(ValueError):
        mono.stage_fns()
    split = bs.CompiledBootstrapper(refresh.booter, refresh.ct, split=True)
    assert len(split.stage_fns()) == 4
    assert split.stage_fns()[1][1] is split.stage_fns()[2][1]
    assert _same_ct(split(refresh.ct), refresh.out)
    with pytest.raises(ValueError):
        split(ckks.CkksCt(refresh.ct.c0, refresh.ct.c1, 2.0 * refresh.ct.scaling_factor))


def test_strict_bootstrapper_raises_on_a_new_plan(env, refresh):
    """During capture a plan or a constant that discovery did not make is a
    fault, not an encode."""
    booter = refresh.make_booter()
    booter._strict = True
    with pytest.raises(RuntimeError, match="not discovered"):
        booter(refresh.ct)
    booter._consts.frozen = True
    with pytest.raises(RuntimeError, match="not encoded before capture"):
        booter._consts(1.0, 2.0**20, 3, CPU)


def test_boot_artifact_round_trip(env, refresh):
    split = bs.CompiledBootstrapper(refresh.booter, refresh.ct, split=True)
    cache = pathlib.Path(__file__).resolve().parents[1] / ".boot_cache"
    cache.mkdir(exist_ok=True)
    path = cache / f"test_torch_bootstrap_{os.getpid()}.pt"
    try:
        boot_artifact.save(split, str(path))
        loaded = boot_artifact.load(str(path), device=CPU)
    finally:
        path.unlink(missing_ok=True)
    assert len(loaded.stage_fns()) == 4
    assert loaded.timings["materialize"] < 1.0  # nothing was encoded
    assert _same_ct(loaded(refresh.ct), refresh.out)
    with pytest.raises(ValueError):
        boot_artifact.save(bs.CompiledBootstrapper(refresh.booter, refresh.ct), str(path))


# ---------------------------------------------------------------------------
# on the card (no JAX)
# ---------------------------------------------------------------------------


def _card_setup(dev, n, levels, two_limb, special, lt_stages, degree, d_in, arcsine, seed=0):
    params = bs.make_boot_params(n, levels, num_special=special, two_limb_scale=two_limb)
    ctx = make_context(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    sk = rlwe_mod.keygen(ctx, gen, hamming_weight=8)
    rlk = keys_mod.relin_key(ctx, sk, gen)
    rks = {st: keys_mod.rot_key(ctx, sk, st, gen)
           for st in bs.bootstrap_rotation_steps(params, lt_stages)}
    ck = keys_mod.conj_key(ctx, sk, gen)
    v = np.random.default_rng(3).uniform(-1, 1, n // 2)
    pt = ckks.encode(v, params, scaling_factor=d_in, level=levels - 1, device=dev)
    ct = ckks.encrypt(ctx, pt, sk, gen)
    booter = bs.Bootstrapper(ctx, params, rlk, rks, ck, k_bound=5, degree=degree,
                             arcsine=arcsine, lt_stages=lt_stages)
    return types.SimpleNamespace(params=params, ctx=ctx, sk=sk, v=v, ct=ct, booter=booter)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 1024])
def test_captured_refresh_is_eager_on_card(cuda_device, n):
    """n=128: this file's parameters, split; n=1024: the recipe of
    tests/test_bootstrap.py::test_full_bootstrap_1024 (28 limbs of 30 bits
    and 2 special primes, Δ ≈ 2^60, Δ_in = 2^26, degree 63, arcsine), dense
    transforms, monolithic, decoded within that test's 1e-5."""
    if n == 128:
        s = _card_setup(cuda_device, n, LEVELS, False, 1, LT_STAGES, DEGREE, D_IN, False)
    else:
        s = _card_setup(cuda_device, n, 28, True, 2, 0, 63, 2.0**26, True)
    eager = s.booter(s.ct)
    captured = bs.CompiledBootstrapper(s.booter, s.ct, split=n == 128)
    for _ in range(2):  # a replay leaves the next one unchanged
        assert _same_ct(captured(s.ct), eager)
    if n == 1024:
        got = ckks.decode(ckks.decrypt(s.ctx, eager, s.sk), s.params).real
        assert np.abs(got - s.v).max() < 1e-5


@pytest.mark.cuda
def test_mod_raise_on_card_is_cpu(cuda_device):
    params = bs.make_boot_params(1024, 28, num_special=2)
    ctx = make_context(params)
    rng = np.random.default_rng(5)
    q0 = ctx.mod_list[0]
    halves = [rng.integers(0, 2 * q0, (3, 1, 1024)) for _ in range(2)]
    ct = convert.ct_from_numpy(*halves, (0,), 2.0**26, device=cuda_device)
    got = bs.mod_raise(ctx, ct)
    want = bs.mod_raise(ctx, convert.ct_from_numpy(*halves, (0,), 2.0**26, device=CPU))
    assert got.c0.limb_ids == want.c0.limb_ids == tuple(range(28))
    assert torch.equal(got.c0.data.cpu(), want.c0.data)
    assert torch.equal(got.c1.data.cpu(), want.c1.data)


@pytest.mark.cuda
def test_warm_eager_refresh_does_not_synchronise(cuda_device):
    """After one refresh every plan and constant plaintext is made, and the
    next refresh copies nothing from the host and waits on nothing: what
    CUDA graph capture needs."""
    s = _card_setup(cuda_device, N, LEVELS, False, 1, LT_STAGES, DEGREE, D_IN, False)
    s.booter(s.ct)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s.booter(s.ct)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
