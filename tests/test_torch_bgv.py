"""BGV of hehub_tpu_torch against hehub_tpu, at tests/test_bgv.py's sizes
(n=256, 3+1 limbs, alpha=1) and tests/test_hybrid_ks.py's alpha=2 case
(4+2 limbs): the host number theory on random inputs; ntt_single /
intt_single, both BGV flavours of the special-prime division and the
signed single lift on random residues; SIMD packing under a 17-bit, a
45-bit prime, a composite and a non-NTT t; then encryption, exact and
device decryption and every homomorphic op on ciphertexts and keys made by
hehub_tpu, carried over with `convert` — all bitwise; and a round trip on
the port's own keys and sampling. On the card, ntt_single / intt_single
through K1/K2 bitwise against their plain chains.

hehub_tpu runs its NTTs, external products and divisions jitted
(torch_support.jit_reference_ops). JAX is imported inside the tests that
use it, so the card tests also run where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

from hehub_tpu_torch import convert
from hehub_tpu_torch.core import basecnv as tbc
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core import rns as trns
from hehub_tpu_torch.models import bgv as tbgv
from hehub_tpu_torch.ops import ntt as tn
from hehub_tpu_torch.rlwe import keys as tkeys
from hehub_tpu_torch.rlwe import rlwe as trlwe
from hehub_tpu_torch.utils import hostmath as thm
from tests.torch_support import as_numpy, cuda_device, jit_reference_ops, lazy_residues  # noqa: F401

N = 256
T_BIG = 35184358850561  # the reference's 45-bit prime, ≡ 1 mod 2n for n <= 1024
CPU = "cpu"


def _t_composite():
    t1, t2 = thm.gen_ntt_primes(17, 2, N)[:2]
    return t1 * t2


# plain moduli of each kind, with the levels of tests/test_bgv.py
T_CASES = {
    "17-bit": (None, 3),
    "45-bit prime": (T_BIG, 4),
    "composite": (_t_composite(), 4),
    "non-NTT": (1 << 16, 3),
}


@pytest.fixture(scope="module")
def jit_ref():
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_ops(mp)
        yield


@functools.lru_cache(maxsize=None)
def _setup(kind, num_special=1, levels=None):
    """Both packages' params and contexts for a plain-modulus kind, the
    port's secret key and hehub_tpu's twin of it (handed over as numpy)."""
    from hehub_tpu.core.context import create_bgv_params
    from hehub_tpu.core.context import make_context as j_make_context
    from hehub_tpu.rlwe import rlwe as jrlwe

    t, lv = T_CASES[kind]
    kw = dict(num_levels=levels or lv, num_special=num_special, plain_modulus=t,
              use_security_budget=False)
    params, jparams = tctx.create_bgv_params(N, **kw), create_bgv_params(N, **kw)
    assert (params.moduli, params.special_mod, params.plain_modulus) == (
        jparams.moduli, jparams.special_mod, jparams.plain_modulus)
    ctx, jctx = tctx.make_context(params), j_make_context(jparams)
    sk = trlwe.keygen(ctx, torch.Generator().manual_seed(len(kind) + num_special))
    jsk = jrlwe.RlweSk(sk.coeffs.numpy(), as_numpy(sk.ntt), as_numpy(sk.ntt_sh))
    return params, ctx, sk, jctx, jsk


@functools.lru_cache(maxsize=None)
def _jax_rlk(kind, num_special=1, alpha=1, levels=None):
    """hehub_tpu's relinearization key (noise_scale=t), carried over."""
    import jax

    from hehub_tpu.rlwe import keys as jkeys

    params, _, _, jctx, jsk = _setup(kind, num_special, levels)
    jrlk = jkeys.relin_key(jctx, jsk, jax.random.key(46), alpha=alpha,
                           noise_scale=params.plain_modulus)
    return jrlk, convert.rgsw_from_numpy(np.asarray(jrlk.data), jrlk.limb_ids, alpha, device=CPU)


def _slots(t, seed, shape=(N,)):
    return np.random.default_rng(seed).integers(0, t, shape, dtype=np.uint64)


def _jax_ct(kind, seed, data, num_special=1, levels=None):
    """hehub_tpu's encryption of the slots `data` (or of the coefficients,
    for a t without SIMD packing), and the port's twin of it."""
    import jax

    from hehub_tpu.models import bgv as jbgv

    params, _, _, jctx, jsk = _setup(kind, num_special, levels)
    pt = (jbgv.simd_encode(jctx, data) if params.simd_capable
          else jbgv.pt_from_values(jctx, data))
    jct = jbgv.encrypt(jctx, pt, jsk, jax.random.key(seed))
    return jct, _ct_to_port(jct)


def _ct_to_port(jct):
    return convert.bgv_ct_from_numpy(np.asarray(jct.c0.data), np.asarray(jct.c1.data),
                                     jct.c0.limb_ids, jct.plain_modulus, device=CPU)


def _pt_to_port(jpt):
    return convert.bgv_pt_from_numpy(np.asarray(jpt.digits), np.asarray(jpt.neg),
                                     jpt.plain_modulus)


def _assert_ct_equal(got, want):
    assert got.limb_ids == want.c0.limb_ids and got.plain_modulus == want.plain_modulus
    for g, w in zip(got[:-1], want[:-1]):
        assert g.form == w.form
        np.testing.assert_array_equal(as_numpy(g.data), np.asarray(w.data))


def _assert_pt_equal(got, want):
    np.testing.assert_array_equal(got.digits, np.asarray(want.digits))
    np.testing.assert_array_equal(got.neg, np.asarray(want.neg))
    assert got.plain_modulus == want.plain_modulus


# ---------------------------------------------------------------------------
# Host number theory
# ---------------------------------------------------------------------------


def test_factorize_and_coprime_factors():
    from hehub_tpu.utils import hostmath as jhm

    rng = np.random.default_rng(1)
    primes = [2, 3, 65537, 125441, T_BIG, 1073479681, 4294967291]
    cases = [int(x) for x in rng.integers(2, 1 << 62, 12)]
    cases += [p * q for p in primes for q in primes if p * q < 1 << 63]
    cases += [(1 << 16), 3 ** 20, 65537 ** 2 * 12, 1]
    for n in cases:
        assert thm.factorize(n) == jhm.factorize(n), n
        assert thm.coprime_factors(n) == jhm.coprime_factors(n), n
        prod = 1
        for p, e in thm.factorize(n):
            assert thm.is_prime(p)
            prod *= p ** e
        assert prod == max(n, 1)


@pytest.mark.parametrize("bits", [17, 30, 45, 58, 62])
def test_mulmod_u64(bits):
    from hehub_tpu.utils import hostmath as jhm

    rng = np.random.default_rng(bits)
    t = int(rng.integers(1 << (bits - 1), (1 << bits) - 1)) if bits < 62 else (1 << 62) - 57
    a = rng.integers(0, t, 4000, dtype=np.uint64)
    b = rng.integers(0, t, 4000, dtype=np.uint64)
    exact = np.asarray([int(x) * int(y) % t for x, y in zip(a, b)], np.uint64)
    np.testing.assert_array_equal(thm.mulmod_u64(a, b, t), exact)
    np.testing.assert_array_equal(thm._mulmod_u64_split(a, b, t), exact)
    np.testing.assert_array_equal(thm.mulmod_u64(a, b, t), jhm.mulmod_u64(a, b, t))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("t", [65537, T_BIG])
def test_ntt_host_u64(t, inverse):
    from hehub_tpu.utils import hostmath as jhm

    x = np.random.default_rng(2).integers(0, t, (3, N), dtype=np.uint64)
    got = thm.ntt_host_u64(x, t, N, inverse=inverse)
    np.testing.assert_array_equal(got, jhm.ntt_host_u64(x, t, N, inverse=inverse))
    np.testing.assert_array_equal(thm.ntt_host_u64(got, t, N, inverse=not inverse), x)


def test_crt_helpers():
    from hehub_tpu.core import basecnv as jbc
    from hehub_tpu.utils import hostmath as jhm

    mods = list(thm.gen_ntt_primes(30, 3, N))
    Q = mods[0] * mods[1] * mods[2]
    rng = np.random.default_rng(3)
    vals = [int(v) for v in rng.integers(-(1 << 62), 1 << 62, 40)] + [0, -1, Q // 2, -(Q // 2)]
    res = thm.decompose_rns(vals, mods)
    np.testing.assert_array_equal(res, jhm.decompose_rns(vals, mods))
    composed = thm.crt_compose(res, mods)
    assert composed == jhm.crt_compose(res, mods)
    assert [thm.to_signed(x, Q) for x in composed] == vals
    assert tbc.compose_to_int(res, mods) == vals
    np.testing.assert_array_equal(tbc.convert_to_single_host(res, mods, 65537),
                                  jbc.convert_to_single_host(res, mods, 65537))


def test_bgv_params_and_factor_tables():
    from hehub_tpu.core.context import create_bgv_params

    for kind in T_CASES:
        params, ctx, _, jctx, _ = _setup(kind)
        assert params.plain_factors == create_bgv_params(
            N, num_levels=T_CASES[kind][1], plain_modulus=params.plain_modulus,
            use_security_budget=False).plain_factors
        assert params.simd_capable == (kind != "non-NTT")
        assert len(ctx.plain_fact_tables) == len(jctx.plain_fact_tables)
        for mine, ref in zip(ctx.plain_fact_tables, jctx.plain_fact_tables):
            assert (mine is None) == (ref is None)
            if mine is not None:
                for nm in ("q", "two_q", "tw_fwd", "tw_fwd_sh", "tw_inv", "tw_inv_sh",
                           "tw_inv_last", "tw_inv_last_sh", "n_inv", "n_inv_sh"):
                    np.testing.assert_array_equal(getattr(mine, nm), getattr(ref, nm))
    # the full-budget configuration of chip_smoke.py: t = 65537 packs at n=16384
    full = tctx.create_bgv_params(16384, plain_bits=17, num_levels=12, num_special=2)
    assert full.plain_modulus == 65537 and full.simd_capable
    with pytest.raises(ValueError, match="budget"):
        tctx.create_bgv_params(16384, num_levels=13, num_special=2)
    with pytest.raises(ValueError, match="coprime"):
        tctx.BgvParams(dimension=N, moduli=params.moduli, plain_modulus=params.moduli[0] * 3)


# ---------------------------------------------------------------------------
# The plain-modulus NTTs, the BGV division and the single lift
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("t", [65537, 125441])
def test_ntt_single_bitwise(t, inverse):
    from hehub_tpu.core.context import ModulusTables as JTables
    from hehub_tpu.ops import ntt as jntt

    import jax

    tabs, jtabs = tctx.ModulusTables(t, N), JTables(t, N)
    x = (np.random.default_rng(t).integers(0, 2 * t, (3, 2, N))).astype(np.uint32)
    fn, jfn = (tn.intt_single, jntt.intt_single) if inverse else (tn.ntt_single, jntt.ntt_single)
    got = fn(tabs, torch.from_numpy(x.astype(np.int64)))
    np.testing.assert_array_equal(as_numpy(got), np.asarray(jax.jit(lambda d: jfn(jtabs, d))(x)))
    # the transforms invert each other mod t
    back = (tn.ntt_single if inverse else tn.intt_single)(tabs, got)
    np.testing.assert_array_equal(as_numpy(back) % t, x % t)


@pytest.mark.parametrize("restore", [True, False])
@pytest.mark.parametrize("kind", ["17-bit", "45-bit prime"])
def test_div_last_rounded_pair_bgv(kind, restore):
    from hehub_tpu.core import basecnv as jbc
    from hehub_tpu.core import rns as jrns

    params, ctx, _, jctx, _ = _setup(kind)
    ids = tuple(range(len(ctx.mod_list)))
    x = lazy_residues(np.random.default_rng(4), (2, 3), ctx.moduli_of(ids), N)
    t = params.plain_modulus
    import jax

    ja, jb = jax.jit(lambda x0, x1: jbc.div_last_rounded_pair(
        jctx, jrns.RnsPoly(x0, jrns.NTT, ids), jrns.RnsPoly(x1, jrns.NTT, ids), t, restore))(
            x[0], x[1])
    a, b = tbc.div_last_rounded_pair(
        ctx, *(convert.poly_from_numpy(x[i], trns.NTT, ids, device=CPU) for i in range(2)),
        plain_modulus=t, restore_plain_scale=restore)
    for got, want in ((a, ja), (b, jb)):
        assert got.limb_ids == want.limb_ids == ids[:-1]
        np.testing.assert_array_equal(as_numpy(got.data), np.asarray(want.data))


def test_lift_signed_single():
    from hehub_tpu.core import basecnv as jbc

    _, ctx, _, jctx, _ = _setup("17-bit")
    ids = (0, 2, 3)
    t = 65537
    x = np.random.default_rng(5).integers(0, t, (2, N)).astype(np.uint32)
    got = tbc.lift_signed_single(ctx, torch.from_numpy(x.astype(np.int64)), t, ids)
    want = jbc.lift_signed_single(jctx, x, t, ids)
    assert got.limb_ids == want.limb_ids and got.form == want.form
    np.testing.assert_array_equal(as_numpy(got.data), np.asarray(want.data))
    with pytest.raises(ValueError):
        tbc.lift_signed_single(ctx, torch.from_numpy(x.astype(np.int64)), ctx.mod_list[0], ids)


# ---------------------------------------------------------------------------
# Packing, encryption, decryption
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(T_CASES))
def test_simd_encode_decode(kind):
    from hehub_tpu.models import bgv as jbgv

    params, ctx, _, jctx, _ = _setup(kind)
    t = params.plain_modulus
    data = _slots(t, 6, (2, N))
    want = jbgv.pt_from_values(jctx, data)
    _assert_pt_equal(tbgv.pt_from_values(ctx, data), want)
    np.testing.assert_array_equal(tbgv.pt_from_values(ctx, data).data, data)
    if not params.simd_capable:
        with pytest.raises(ValueError, match="SIMD"):
            tbgv.simd_encode(ctx, data, device=CPU)
        return
    pt = tbgv.simd_encode(ctx, data[..., : N - 5], device=CPU)
    _assert_pt_equal(pt, jbgv.simd_encode(jctx, data[..., : N - 5]))
    np.testing.assert_array_equal(tbgv.simd_decode(ctx, pt, N - 5, device=CPU),
                                  data[..., : N - 5])
    np.testing.assert_array_equal(tbgv.simd_decode(ctx, pt, device=CPU),
                                  jbgv.simd_decode(jctx, _pt_to_jax(pt)))


def _pt_to_jax(pt):
    from hehub_tpu.models import bgv as jbgv

    return jbgv.BgvPt(pt.digits, pt.neg, pt.plain_modulus)


def test_encrypt_debug_modes(jit_ref):
    import jax

    from hehub_tpu.models import bgv as jbgv

    params, ctx, sk, jctx, jsk = _setup("17-bit")
    data = _slots(params.plain_modulus, 7, (2, N))
    pt = tbgv.simd_encode(ctx, data, device=CPU)
    gen = torch.Generator().manual_seed(7)
    # no c1, no noise: deterministic, bitwise the reference's
    got = tbgv.encrypt(ctx, pt, sk, gen, debug_zero_c1=True, debug_zero_e=True)
    want = jbgv.encrypt(jctx, _pt_to_jax(pt), jsk, jax.random.key(7), debug_zero_c1=True,
                        debug_zero_e=True)
    _assert_ct_equal(got, want)
    assert not got.c1.data.any()
    # each flag alone: both packages decrypt the port's ciphertext exactly
    for flags in (dict(debug_zero_e=True), dict(debug_zero_c1=True)):
        ct = tbgv.encrypt(ctx, pt, sk, gen, **flags)
        jct = jbgv.BgvCt(*(type(want.c0)(as_numpy(p.data), p.form, p.limb_ids)
                           for p in (ct.c0, ct.c1)), ct.plain_modulus)
        _assert_pt_equal(tbgv.decrypt(ctx, ct, sk), jbgv.decrypt(jctx, jct, jsk))
        np.testing.assert_array_equal(
            tbgv.simd_decode(ctx, tbgv.decrypt(ctx, ct, sk), device=CPU), data)


@pytest.mark.parametrize("kind", list(T_CASES))
def test_decrypt_jax_ciphertexts(kind, jit_ref):
    from hehub_tpu.models import bgv as jbgv

    params, ctx, sk, jctx, jsk = _setup(kind)
    data = _slots(params.plain_modulus, 8, (2, N))
    jct, ct = _jax_ct(kind, 8, data)
    want = jbgv.decrypt(jctx, jct, jsk)
    _assert_pt_equal(tbgv.decrypt(ctx, ct, sk), want)
    _assert_pt_equal(tbgv.decrypt_device(ctx, ct, sk), jbgv.decrypt_device(jctx, jct, jsk))
    got = tbgv.decrypt(ctx, ct, sk)
    if params.simd_capable:
        np.testing.assert_array_equal(tbgv.simd_decode(ctx, got, device=CPU), data)
    else:
        np.testing.assert_array_equal(got.data, data)


# ---------------------------------------------------------------------------
# Homomorphic ops on the reference's ciphertexts and keys
# ---------------------------------------------------------------------------


def test_add_sub_and_plain_ops_bitwise(jit_ref):
    from hehub_tpu.models import bgv as jbgv

    params, ctx, sk, jctx, jsk = _setup("17-bit")
    t = params.plain_modulus
    a, b = _slots(t, 9, (2, N)), _slots(t, 10, (2, N))
    (ja, ca), (jb, cb) = _jax_ct("17-bit", 9, a), _jax_ct("17-bit", 10, b)
    jpb = jbgv.simd_encode(jctx, b)
    pb = _pt_to_port(jpb)
    for name, want_slots in (("add_plain", (a + b) % t),
                             ("sub_plain", (a.astype(np.int64) - b.astype(np.int64)) % t),
                             ("mult_plain", a * b % t)):
        got = getattr(tbgv, name)(ctx, ca, pb)
        _assert_ct_equal(got, getattr(jbgv, name)(jctx, ja, jpb))
        np.testing.assert_array_equal(
            tbgv.simd_decode(ctx, tbgv.decrypt(ctx, got, sk), device=CPU), want_slots)
    for name, want_slots in (("add", (a + b) % t),
                             ("sub", (a.astype(np.int64) - b.astype(np.int64)) % t)):
        got = getattr(tbgv, name)(ctx, ca, cb)
        _assert_ct_equal(got, getattr(jbgv, name)(jctx, ja, jb))
        np.testing.assert_array_equal(
            tbgv.simd_decode(ctx, tbgv.decrypt(ctx, got, sk), device=CPU), want_slots)


@pytest.mark.parametrize("kind,num_special,alpha,levels", [
    ("17-bit", 1, 1, None),
    ("composite", 1, 1, None),
    ("17-bit", 2, 2, 4),
])
def test_mult_relin_mod_switch_bitwise(kind, num_special, alpha, levels, jit_ref):
    """mult_low_level, relinearize, mult and mod_switch on the reference's
    ciphertexts and key: tests/test_bgv.py's alpha=1 cases and
    tests/test_hybrid_ks.py's alpha=2 case at 4+2 limbs."""
    from hehub_tpu.models import bgv as jbgv

    params, ctx, sk, jctx, jsk = _setup(kind, num_special, levels)
    t = params.plain_modulus
    jrlk, rlk = _jax_rlk(kind, num_special, alpha, levels)
    a, b = _slots(t, 11, (2, N)), _slots(t, 12, (2, N))
    (ja, ca), (jb, cb) = (_jax_ct(kind, s, v, num_special, levels)
                          for s, v in ((11, a), (12, b)))
    quad, jquad = tbgv.mult_low_level(ctx, ca, cb), jbgv.mult_low_level(jctx, ja, jb)
    for g, w in zip(quad[:3], jquad[:3]):
        np.testing.assert_array_equal(as_numpy(g.data), np.asarray(w.data))
    relin = tbgv.relinearize(ctx, quad, rlk)
    _assert_ct_equal(relin, jbgv.relinearize(jctx, jquad, jrlk))
    prod, jprod = tbgv.mult(ctx, ca, cb, rlk), jbgv.mult(jctx, ja, jb, jrlk)
    _assert_ct_equal(prod, jprod)
    switched = tbgv.mod_switch(ctx, prod)
    _assert_ct_equal(switched, jbgv.mod_switch(jctx, jprod))
    assert switched.c0.limb_count == prod.c0.limb_count - 1
    want = np.asarray(a.astype(object) * b.astype(object) % t, np.uint64)
    for ct in (prod, switched):
        np.testing.assert_array_equal(
            tbgv.simd_decode(ctx, tbgv.decrypt(ctx, ct, sk), device=CPU), want)


def test_port_keys_round_trip():
    """The port's own keygen, relinearization key and sampling: encrypt,
    add, mult_plain, mult + relin, mod_switch and both decryptions give
    numpy's slots mod t, under t = 65537 and the composite t."""
    for kind in ("17-bit", "composite"):
        params, ctx, _, _, _ = _setup(kind)
        t = params.plain_modulus
        gen = torch.Generator().manual_seed(13)
        sk = trlwe.keygen(ctx, gen)
        rlk = tkeys.relin_key(ctx, sk, gen, noise_scale=t)
        a, b = _slots(t, 14, (3, N)), _slots(t, 15, (3, N))
        ca, cb = (tbgv.encrypt(ctx, tbgv.simd_encode(ctx, v, device=CPU), sk, gen)
                  for v in (a, b))
        dec = lambda ct: tbgv.simd_decode(ctx, tbgv.decrypt(ctx, ct, sk), device=CPU)  # noqa: E731
        prod = np.asarray(a.astype(object) * b.astype(object) % t, np.uint64)
        np.testing.assert_array_equal(dec(ca), a)
        np.testing.assert_array_equal(dec(tbgv.add(ctx, ca, cb)), (a + b) % t)
        np.testing.assert_array_equal(
            dec(tbgv.mult_plain(ctx, ca, tbgv.simd_encode(ctx, b, device=CPU))), prod)
        np.testing.assert_array_equal(dec(tbgv.mod_switch(ctx, tbgv.mult(ctx, ca, cb, rlk))),
                                      prod)
        if t < 1 << 29:
            np.testing.assert_array_equal(
                tbgv.simd_decode(ctx, tbgv.decrypt_device(ctx, ca, sk), device=CPU), a)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("t,n", [(65537, 256), (65537, 16384), (125441, 256)])
def test_ntt_single_on_card(cuda_device, t, n):  # noqa: F811
    """ntt_single / intt_single under a plain-modulus factor's tables: K1/K2
    on [rows, 1, n] bitwise against the plain chains."""
    from hehub_tpu_torch import kernels

    tabs = tctx.ModulusTables(t, n)
    x = torch.from_numpy(np.random.default_rng(n).integers(0, 2 * t, (64, n))).to(cuda_device)
    for fn, kind in ((tn.ntt_single, "ntt_fwd"), (tn.intt_single, "ntt_inv")):
        before = kernels.LAUNCHES[kind]
        got = fn(tabs, x)
        assert kernels.LAUNCHES[kind] == before + 1
        want = fn(tabs, x.cpu())
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
