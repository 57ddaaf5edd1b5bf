"""Hybrid key switching (digit grouping alpha > 1) of hehub_tpu_torch
against hehub_tpu, mirroring tests/test_hybrid_ks.py: basecnv.base_convert
bitwise, alpha=2 keys made by hehub_tpu and carried over with `convert`,
then ext_prod, mult + relin + rescale, rotate(3), conjugate and a level
that cuts a digit group, all bitwise; the port's own alpha=2 keys; ModUp's
packed constant table (basecnv.modup_tables), through its plain twin
basecnv.modup_plain, bitwise base_convert at alpha 2, 3, 4 and every
ragged last group, built once; ModDown's plain twin basecnv.moddown_plain
bitwise count successive div_last_rounded_pair calls and hehub_tpu's
division repeated; and, on the card, the kernel K4 bitwise
against its plain version at every n it takes, and ModUp (kernels.modup)
bitwise the plain base_convert per group at both benchmark cells' shapes,
a ring below 1024 and n = 262144 by parts, ext_prod_strict against the
CPU, one ModUp launch per CKKS mult and no base_convert on the card, and
a key made on the card refused above ModUp's largest digit group;
ModDown's kernels bitwise moddown_plain at the cells' shapes, in a CUDA
graph, and no plain division on the card through the CKKS operations.

JAX is imported inside the tests that use it, so the card test also runs
where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

from hehub_tpu_torch import convert, kernels
from hehub_tpu_torch.core import basecnv as tbc
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core import rns as trns
from hehub_tpu_torch.ops import ntt as tn
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.rlwe import keys as tkeys
from hehub_tpu_torch.rlwe import rgsw as trgsw
from hehub_tpu_torch.rlwe import rlwe as trlwe
from hehub_tpu_torch.utils import hostmath as hm
from tests.torch_support import (  # noqa: F401
    as_numpy, cuda_device, ext_prod_case, lazy_residues, plain_ext_prod_conv, to_device)

RNG = np.random.default_rng(17)
N = 256
LEVELS = 4
PARAMS = dict(scaling_bits=28, num_levels=LEVELS, use_security_budget=False, num_special=2)


def _port():
    params = tctx.create_ckks_params(N, **PARAMS)
    return params, tctx.make_context(params)


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """hehub_tpu params, context, secret key and alpha=2 relin, rotation(3)
    and conjugation keys, 4 + 2 limbs. The secret key is the port's, handed
    over as numpy (hehub_tpu's keygen runs its NTT eagerly, which costs
    seconds); the key-switching keys are hehub_tpu's."""
    import jax

    from hehub_tpu.core.context import create_ckks_params, make_context
    from hehub_tpu.rlwe import keys, rlwe

    params = create_ckks_params(N, **PARAMS)
    ctx = make_context(params)
    tsk = trlwe.keygen(_port()[1], torch.Generator().manual_seed(0))
    sk = rlwe.RlweSk(tsk.coeffs.numpy(), as_numpy(tsk.ntt), as_numpy(tsk.ntt_sh))
    return (params, ctx, sk, keys.relin_key(ctx, sk, jax.random.key(1), alpha=2),
            keys.rot_key(ctx, sk, 3, jax.random.key(2), alpha=2),
            keys.conj_key(ctx, sk, jax.random.key(3), alpha=2))


def _key_to_port(k):
    return convert.rgsw_from_numpy(np.asarray(k.data), k.limb_ids, k.alpha, device="cpu")


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("src", [(0, 1), (1, 2, 3)])
def test_base_convert_bitwise(src, signed):
    import jax

    from hehub_tpu.core import basecnv as jbc
    from hehub_tpu.core import rns as jrns

    jctx = _jax_setup()[1]
    _, ctx = _port()
    dst = tuple(range(LEVELS)) + ctx.special_indices
    x = (RNG.integers(0, 1 << 62, (2, len(src), N))
         % np.asarray(ctx.moduli_of(src), np.int64)[:, None]).astype(np.uint32)
    want = jax.jit(lambda d: jbc.base_convert(
        jctx, jrns.RnsPoly(d, jrns.COEFF, src), dst, signed=signed).data)(x)
    got = tbc.base_convert(ctx, convert.poly_from_numpy(x, trns.COEFF, src, device="cpu"), dst,
                           signed=signed)
    assert got.limb_ids == dst and got.form == trns.COEFF
    np.testing.assert_array_equal(as_numpy(got.data), np.asarray(want))


def test_basis_rows_match():
    from hehub_tpu.rlwe import keys as jkeys

    jctx = _jax_setup()[1]
    _, ctx = _port()
    for alpha in (1, 2):
        assert tkeys._basis_rows(ctx, alpha) == jkeys._basis_rows(jctx, alpha)


def test_ext_prod_alpha2_bitwise():
    import jax

    from hehub_tpu.core import rns as jrns
    from hehub_tpu.rlwe import rgsw as jrgsw

    _, jctx, _, jrlk, _, _ = _jax_setup()
    ids = tuple(range(LEVELS))
    x = lazy_residues(RNG, (2,), jctx.moduli_of(ids), N)

    @jax.jit
    def jax_ext_prod(d):
        out = jrgsw.ext_prod(jctx, jrns.RnsPoly(d, jrns.NTT, ids), jrlk)
        return out.c0.data, out.c1.data

    want0, want1 = jax_ext_prod(x)
    _, ctx = _port()
    rlk = _key_to_port(jrlk)
    assert rlk.alpha == 2 and rlk.rows == 2
    got = trgsw.ext_prod(ctx, convert.poly_from_numpy(x, trns.NTT, ids, device="cpu"), rlk)
    np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want0))
    np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want1))


@functools.lru_cache(maxsize=None)
def _ops_both():
    """The same alpha=2 operations on the same JAX-encrypted inputs in both
    packages: {op: ((jax c0, jax c1), port ciphertext)}, plus the slots.
    Each JAX operation is its own jit: one jit of the whole chain compiles
    slower than the three."""
    import jax

    from hehub_tpu.models import ckks as jckks

    jparams, jctx, jsk, jrlk, jrk, jck = _jax_setup()
    a = RNG.uniform(-1, 1, (2, N // 2))
    b = RNG.uniform(-1, 1, (2, N // 2))
    encrypt = jax.jit(lambda pt, key: jckks.encrypt(jctx, pt, jsk, key))
    ca = encrypt(jckks.encode(a, jparams), jax.random.key(4))
    cb = encrypt(jckks.encode(b, jparams), jax.random.key(5))

    def ops(ckks, ctx, jit, ca, cb, rlk, rk, cjk):
        prod = jit(lambda x, y: ckks.rescale(ctx, ckks.mult(ctx, x, y, rlk)))(ca, cb)
        return dict(
            mult=prod,  # at level 4, both digit groups full
            rotate_level3=jit(lambda x: ckks.rotate(ctx, x, rk, 3))(prod),  # group 2 is cut
            conjugate=jit(lambda x: ckks.conjugate(ctx, x, cjk))(ca),
        )

    want = ops(jckks, jctx, jax.jit, ca, cb, jrlk, jrk, jck)
    to_port = lambda ct: convert.ct_from_numpy(  # noqa: E731
        np.asarray(ct.c0.data), np.asarray(ct.c1.data), ct.c0.limb_ids, ct.scaling_factor,
        device="cpu")
    got = ops(tckks, _port()[1], lambda f: f, to_port(ca), to_port(cb), _key_to_port(jrlk),
              _key_to_port(jrk), _key_to_port(jck))
    return {k: ((want[k].c0.data, want[k].c1.data), got[k]) for k in want}, a, b


@pytest.mark.parametrize("op", ["mult", "rotate_level3", "conjugate"])
def test_ckks_ops_alpha2_bitwise(op):
    results, a, b = _ops_both()
    (want0, want1), got = results[op]
    np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want0))
    np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want1))
    # and the result decrypts, under the carried-over key, to what it should
    jsk = _jax_setup()[2]
    params, ctx = _port()
    sk = convert.sk_from_numpy(jsk.coeffs, jsk.ntt, jsk.ntt_sh, device="cpu")
    out = tckks.decode(tckks.decrypt(ctx, got, sk), params)
    expect = dict(mult=a * b, rotate_level3=np.roll(a * b, 3, axis=-1), conjugate=a)[op]
    np.testing.assert_allclose(out, expect, atol=2**-9)


def test_port_keys_alpha2_round_trip():
    """Keys made by the port at alpha=2 (torch.Generator) relinearize and
    rotate: mult + rescale and rotate(1) decode to a*b and its roll."""
    params, ctx = _port()
    gen = torch.Generator().manual_seed(21)
    sk = trlwe.keygen(ctx, gen)
    rlk = tkeys.relin_key(ctx, sk, gen, alpha=2)
    rk = tkeys.rot_key(ctx, sk, 1, gen, alpha=2)
    assert rlk.rows == 2 and rlk.alpha == 2
    a = RNG.uniform(-1, 1, (2, N // 2))
    b = RNG.uniform(-1, 1, (2, N // 2))
    ca = tckks.encrypt(ctx, tckks.encode(a, params, device="cpu"), sk, gen)
    cb = tckks.encrypt(ctx, tckks.encode(b, params, device="cpu"), sk, gen)
    prod = tckks.rescale(ctx, tckks.mult(ctx, ca, cb, rlk))
    out = tckks.decode(tckks.decrypt(ctx, tckks.rotate(ctx, prod, rk, 1), sk), params)
    np.testing.assert_allclose(out, np.roll(a * b, 1, axis=-1), atol=2**-8)


@pytest.mark.parametrize("num_special,alpha", [(1, 2), (2, 3)])
def test_ksk_gen_alpha_above_specials_raises(num_special, alpha):
    params = tctx.create_ckks_params(N, 28, 3, use_security_budget=False,
                                     num_special=num_special)
    ctx = tctx.make_context(params)
    gen = torch.Generator().manual_seed(4)
    sk = trlwe.keygen(ctx, gen)
    with pytest.raises(ValueError, match="special primes"):
        tkeys.relin_key(ctx, sk, gen, alpha=alpha)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 64])
@pytest.mark.parametrize("logn", range(3, 16))
def test_ext_prod_conv_kernel_matches_plain_on_card(cuda_device, logn, rows):  # noqa: F811
    """K4 at every n it takes (n = 8 .. 512 several rows a block), R = 1, 3,
    64, D = 3 digit groups and L_ext = 7 (5 + 2 limbs): bitwise equal to its
    plain version (plain forward NTT of the converted digits, ks_contract)
    on the same card; and, at R = 3, the
    alpha=2 ext_prod on the card (base conversion, then K4) bitwise equal to
    the plain path on the CPU."""
    n = 1 << logn
    ctx, ids_ext, tabs, _, conv, key = ext_prod_case(n, 5, 2, rows, cuda_device, logn)
    before = kernels.LAUNCHES["ext_prod_conv"]
    got = tn.from_u32_bits(kernels.ext_prod_conv(tn.to_u32_bits(conv), tn.to_u32_bits(key),
                                                 *tabs))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ext_prod_conv"] == before + 1
    want0, want1 = plain_ext_prod_conv(ctx, ids_ext, conv, key)
    assert torch.equal(got[0], want0) and torch.equal(got[1], want1)
    if rows != 3:
        return
    gen = torch.Generator().manual_seed(6)
    rlk = tkeys.relin_key(ctx, trlwe.keygen(ctx, gen), gen, alpha=2)
    ids = tuple(range(5))  # 3 digit groups, the last one cut
    x = torch.from_numpy(lazy_residues(RNG, (rows,), ctx.moduli_of(ids), n).astype(np.int64))
    want = trgsw.ext_prod(ctx, trns.RnsPoly(x, trns.NTT, ids), rlk)
    rlk_d = trgsw.RgswCt(rlk.data.to(cuda_device), rlk.limb_ids, rlk.alpha)
    got = trgsw.ext_prod(ctx, trns.RnsPoly(x.to(cuda_device), trns.NTT, ids), rlk_d)
    assert torch.equal(got.c0.data.cpu(), want.c0.data)
    assert torch.equal(got.c1.data.cpu(), want.c1.data)


# ---------------------------------------------------------------------------
# ModUp: the packed constant table and the kernel
# ---------------------------------------------------------------------------

MODUP_N = 64


@functools.lru_cache(maxsize=None)
def _modup_ctx(n, levels, num_special):
    return tctx.make_context(tctx.create_ckks_params(
        n, 28, levels, use_security_budget=False, num_special=num_special))


def _strict(rng, batch_shape, ctx, ids, n):
    """Strict coefficient-form residues [*batch_shape, l, n] (int64)."""
    return torch.from_numpy(np.stack(
        [rng.integers(0, q, (*batch_shape, n)) for q in ctx.moduli_of(ids)], axis=-2))


@pytest.mark.parametrize("alpha,l", [(2, 4), (2, 5), (3, 6), (3, 7), (3, 8), (4, 8), (4, 9),
                                     (4, 10), (4, 11)])
def test_modup_plain_matches_base_convert(alpha, l):
    """The kernel's arithmetic on its packed table (modup_plain) gives, for
    every digit group (the last 1 .. alpha limbs), bitwise what
    base_convert(signed=True) gives into every limb (the group's own
    included), batch [2, 3]."""
    ctx = _modup_ctx(MODUP_N, 11, 4)
    ids = tuple(range(l))
    ids_ext = ids + ctx.special_indices
    x = _strict(np.random.default_rng(alpha * 16 + l), (2, 3), ctx, ids, MODUP_N)
    src_tab, dst_tab = tbc.modup_tables(ctx, ids, ids_ext, alpha, "cpu")
    groups = trgsw._digit_groups(l, alpha)
    assert src_tab.dtype == dst_tab.dtype == torch.int32 and src_tab.shape == (l, 8)
    assert dst_tab.shape == (len(groups), len(ids_ext), 4 + 2 * alpha + (-2 * alpha) % 4)
    got = tbc.modup_plain(src_tab, dst_tab, x, alpha)
    assert got.shape == (2, 3, len(groups), len(ids_ext), MODUP_N)
    for g, grp in enumerate(groups):
        want = tbc.base_convert(ctx, trns.take_limbs(trns.RnsPoly(x, trns.COEFF, ids), grp),
                                ids_ext, signed=True)
        assert torch.equal(got[..., g, :, :], want.data)


def test_modup_tables_built_once():
    """One table per (source limbs, destination limbs, alpha, device): a
    second key switch's lookup hits the cache and gets the same tensors."""
    ctx = _modup_ctx(MODUP_N, 11, 4)
    ids = tuple(range(7))
    ids_ext = ids + ctx.special_indices
    tbc.modup_tables.cache_clear()
    first = tbc.modup_tables(ctx, ids, ids_ext, 3, "cpu")
    again = tbc.modup_tables(ctx, ids, ids_ext, 3, "cpu")
    info = tbc.modup_tables.cache_info()
    assert info.misses == 1 and info.hits == 1
    assert all(a is b for a, b in zip(first, again))


# the benchmark cells' digit shapes (std128: 12 + 2 limbs at alpha=2; deep:
# 54 + 4 at alpha=4) and a ring below 1024
MODUP_CARD_CASES = [(16384, 2, l) for l in (1, 2, 3, 12)] + [
    (65536, 4, l) for l in (2, 5, 53, 54)] + [(256, 3, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 8, 64])
@pytest.mark.parametrize("n,alpha,l", MODUP_CARD_CASES)
def test_modup_kernel_matches_plain_on_card(cuda_device, n, alpha, l, R):  # noqa: F811
    """ModUp's digits [R, D, l + alpha, n] (int32 bits, one launch) bitwise
    the plain _coeff_digits loop (base_convert of each group, on the same
    card, 8 rows at a time)."""
    ctx = _modup_ctx(n, max(l, 12), alpha)
    ids = tuple(range(l))
    key = trgsw.RgswCt(torch.empty(0), ids + ctx.special_indices, alpha)
    d = trns.RnsPoly(_strict(np.random.default_rng(n + l + R), (R,), ctx, ids, n).to(cuda_device),
                     trns.COEFF, ids)
    before = kernels.LAUNCHES["modup"]
    got = trgsw._coeff_digits(ctx, d, key, torch.int32)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["modup"] == before + 1
    groups = trgsw._digit_groups(l, alpha)
    assert got.dtype == torch.int32 and got.shape == (R, len(groups), len(key.limb_ids), n)
    for r0 in range(0, R, 8):
        rows = trns.RnsPoly(d.data[r0:r0 + 8], trns.COEFF, ids)
        for g, grp in enumerate(groups):
            want = tbc.base_convert(ctx, trns.take_limbs(rows, grp), key.limb_ids, signed=True)
            assert torch.equal(tn.from_u32_bits(got[r0:r0 + 8, g]), want.data), (r0, g)


def _random_key(rng, ctx, ids_ext, alpha, l, n):
    key = lazy_residues(rng, (-(-l // alpha), 2), ctx.moduli_of(ids_ext), n)
    return convert.rgsw_from_numpy(key, ids_ext, alpha, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("n,alpha,l,R", [(16384, 2, 12, 8), (65536, 4, 54, 1)])
def test_ext_prod_strict_with_modup_on_card(cuda_device, n, alpha, l, R):  # noqa: F811
    """ext_prod_strict on the card (ModUp, then K4) at the benchmark cells'
    top levels, bitwise ks_contract(_strict_digits(...)) on the CPU (the
    plain base_convert per group)."""
    ctx = _modup_ctx(n, l, alpha)
    ids = tuple(range(l))
    rng = np.random.default_rng(n + l)
    key = _random_key(rng, ctx, ids + ctx.special_indices, alpha, l, n)
    d = trns.RnsPoly(_strict(rng, (R,), ctx, ids, n), trns.COEFF, ids)
    before = dict(kernels.LAUNCHES)
    got = trgsw.ext_prod_strict(ctx, trns.RnsPoly(d.data.to(cuda_device), trns.COEFF, ids),
                                trgsw.RgswCt(key.data.to(cuda_device), key.limb_ids, alpha))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["modup"] == before["modup"] + 1
    assert kernels.LAUNCHES["ext_prod_conv"] == before["ext_prod_conv"] + 1
    want = trgsw.ks_contract(ctx, trgsw._strict_digits(ctx, d, key), key)
    assert torch.equal(got.c0.data.cpu(), want.c0.data)
    assert torch.equal(got.c1.data.cpu(), want.c1.data)


@pytest.mark.cuda
def test_modup_by_parts_in_chunks_on_card(cuda_device, monkeypatch):  # noqa: F811
    """At n = 262144 (the stage kernel, then K4 on parts), digits made a
    chunk of one row at a time: one ModUp launch a chunk, and the result
    bitwise ks_contract(_strict_digits(...)) on the CPU; 5 + 2 limbs at
    alpha=2, 3 rows."""
    n, l, alpha, R = 262144, 5, 2, 3
    ctx = _modup_ctx(n, l, alpha)
    ids = tuple(range(l))
    rng = np.random.default_rng(7)
    key = _random_key(rng, ctx, ids + ctx.special_indices, alpha, l, n)
    d = trns.RnsPoly(_strict(rng, (R,), ctx, ids, n), trns.COEFF, ids)
    monkeypatch.setattr(trgsw, "DIGIT_CHUNK_BYTES", 1)
    before = kernels.LAUNCHES["modup"]
    got = trgsw.ext_prod_strict(ctx, trns.RnsPoly(d.data.to(cuda_device), trns.COEFF, ids),
                                trgsw.RgswCt(key.data.to(cuda_device), key.limb_ids, alpha))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["modup"] == before + R
    want = trgsw.ks_contract(ctx, trgsw._strict_digits(ctx, d, key), key)
    assert torch.equal(got.c0.data.cpu(), want.c0.data)
    assert torch.equal(got.c1.data.cpu(), want.c1.data)


@pytest.mark.cuda
def test_ckks_mult_launches_one_modup_on_card(cuda_device, monkeypatch):  # noqa: F811
    """One CKKS mult (+ relinearize) at alpha=2 on the card launches ModUp
    exactly once and never reaches the plain base_convert with a CUDA
    tensor; a second mult builds no table."""
    params, ctx = _port()
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    sk = trlwe.keygen(ctx, gen)
    rlk = tkeys.relin_key(ctx, sk, gen, alpha=2)
    a, b = (tckks.encrypt(ctx, tckks.encode(RNG.uniform(-1, 1, (2, N // 2)), params,
                                            device=cuda_device), sk, gen) for _ in range(2))
    on_card = []
    plain = tbc.base_convert

    def counted(ctx, poly, *args, **kw):
        on_card.append(poly.data.is_cuda)
        return plain(ctx, poly, *args, **kw)

    monkeypatch.setattr(tbc, "base_convert", counted)
    before = kernels.LAUNCHES["modup"]
    tckks.mult(ctx, a, b, rlk)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["modup"] == before + 1
    misses = tbc.modup_tables.cache_info().misses
    tckks.mult(ctx, a, b, rlk)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["modup"] == before + 2
    assert tbc.modup_tables.cache_info().misses == misses
    assert not any(on_card)


@pytest.mark.cuda
def test_ksk_gen_alpha_above_modup_raises_on_card(cuda_device):  # noqa: F811
    """A key made on the card takes alpha up to kernels.MODUP_MAX_ALPHA, the
    largest digit group ModUp takes: one above raises at key generation,
    not in a later key switch."""
    alpha = kernels.MODUP_MAX_ALPHA + 1
    ctx = tctx.make_context(tctx.create_ckks_params(N, 28, 3, use_security_budget=False,
                                                    num_special=alpha))
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    sk = trlwe.keygen(ctx, gen)
    with pytest.raises(ValueError, match="ModUp"):
        tkeys.relin_key(ctx, sk, gen, alpha=alpha)


# ---------------------------------------------------------------------------
# ModDown: the division by several dropped limbs, its plain twin and kernels
# ---------------------------------------------------------------------------

MODDOWN_N = 64


@functools.lru_cache(maxsize=None)
def _moddown_chain(n, count, mixed, chain=3):
    """Moduli of `chain` kept limbs and `count` dropped ones at ring n.
    mixed: kept limbs of 30 and 24 bits and, above them, a 24-bit dropped
    limb under 30-bit ones, so that dropping a 30-bit limb takes
    div_last_rounded's mixed-width branch (q_e >= 2 min q_j) under the kept
    limbs and in the walk over the lower dropped ones, and dropping the
    24-bit one the uniform-width branch; else every limb of 30 bits."""
    p30 = list(hm.gen_ntt_primes(30, chain + count, n))
    if not mixed:
        return tuple(p30)
    p24 = list(hm.gen_ntt_primes(24, 2, n))
    kept = [p30[0], p24[0]] + p30[1:chain - 1]
    dropped = [p24[1]] + p30[chain - 1:chain - 2 + count] if count > 1 else [p30[chain - 1]]
    return tuple(kept + dropped)


def _moddown_ctx(mods, n):
    return tctx.make_context(tctx.CkksParams(dimension=n, moduli=mods,
                                             special_mod=hm.gen_ntt_primes(29, 1, n)[0]))


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)])
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_moddown_plain_matches_division_loop(count, mixed, batch):
    """ModDown's plain twin on its packed table, K2 and K1's plain chains
    around it, divides both halves by their last `count` limbs bitwise as
    `count` successive div_last_rounded_pair calls do (the loop the CPU
    and the BGV flavour keep), through both branches of the centred
    remainder; at batch (3,) also bitwise hehub_tpu's division repeated."""
    mods = _moddown_chain(MODDOWN_N, count, mixed)
    ctx = _moddown_ctx(mods, MODDOWN_N)
    ids = tuple(range(len(mods)))
    rng = np.random.default_rng(31 * count + 7 * mixed + len(batch))
    a, b = (lazy_residues(rng, batch, mods, MODDOWN_N) for _ in range(2))
    pa, pb = (convert.poly_from_numpy(x, trns.NTT, ids, device="cpu") for x in (a, b))
    tab = tbc.moddown_tables(ctx, ids, count, "cpu")
    assert tab.dtype == torch.int32 and tab.shape == (len(ids), 1 + count, 4)
    got0, got1 = tbc.moddown_plain(ctx, pa, pb, count)
    want0, want1 = pa, pb
    for _ in range(count):
        want0, want1 = tbc.div_last_rounded_pair(ctx, want0, want1)
    assert got0.limb_ids == want0.limb_ids == ids[:-count]
    assert got0.data.shape == (*batch, len(ids) - count, MODDOWN_N)
    assert torch.equal(got0.data, want0.data) and torch.equal(got1.data, want1.data)
    if batch != (3,):
        return
    import jax

    from hehub_tpu.core import basecnv as jbc
    from hehub_tpu.core import context as jcx
    from hehub_tpu.core import rns as jrns

    jctx = jcx.make_context(jcx.CkksParams(dimension=MODDOWN_N, moduli=mods,
                                           special_mod=hm.gen_ntt_primes(29, 1, MODDOWN_N)[0]))

    @jax.jit
    def jax_div(x, y):
        c0, c1 = jrns.RnsPoly(x, jrns.NTT, ids), jrns.RnsPoly(y, jrns.NTT, ids)
        for _ in range(count):
            c0, c1 = jbc.div_last_rounded_pair(jctx, c0, c1)
        return c0.data, c1.data

    jax0, jax1 = jax_div(a, b)
    np.testing.assert_array_equal(as_numpy(got0.data), np.asarray(jax0))
    np.testing.assert_array_equal(as_numpy(got1.data), np.asarray(jax1))


def _pair_on_card(ctx, ids, batch, n, dev, seed):
    """Two lazy NTT-form halves [*batch, len(ids), n] made on the card."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    two_q = 2 * torch.tensor(ctx.moduli_of(ids), dtype=torch.int64, device=dev)[:, None]
    return tuple(trns.RnsPoly(torch.randint(0, 1 << 62, (*batch, len(ids), n), generator=gen,
                                            device=dev) % two_q, trns.NTT, ids)
                 for _ in range(2))


# (n, kept limbs, dropped limbs, batch, mixed widths): std128's top level
# (12 + 2, R = 64), deep65536's (54 + 4, R = 8), a rescale of each (one
# limb), the boot set's key switch at its top level (47 + 4, batch 1), a
# mixed-width chain, a ring below 1024, and n = 262144 (K1 and K2 by parts)
MODDOWN_CARD_CASES = [
    (16384, 12, 2, (64,), False), (65536, 54, 4, (8,), False), (16384, 11, 1, (64,), False),
    (65536, 53, 1, (8,), False), (65536, 47, 4, (1,), False), (16384, 6, 3, (2, 3), True),
    (256, 4, 8, (), False), (262144, 5, 2, (2,), False)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,L,count,batch,mixed", MODDOWN_CARD_CASES)
def test_moddown_kernels_match_plain_on_card(cuda_device, n, L, count, batch, mixed):  # noqa: F811
    """div_last_rounded_many on the card (K2, ModDown's lift, K1, its
    apply: one launch each) bitwise moddown_plain on the same card, with no
    division by the plain loop."""
    mods = (_moddown_chain(n, count, True, L) if mixed
            else tuple(hm.gen_ntt_primes(30, L + count, n)))
    ctx = _moddown_ctx(mods, n)
    ids = tuple(range(L + count))
    a, b = _pair_on_card(ctx, ids, batch, n, cuda_device, n + L + count)
    before, plain_before = dict(kernels.LAUNCHES), tbc.PLAIN_DIVISIONS_ON_CARD
    got0, got1 = tbc.div_last_rounded_many(ctx, a, b, count)
    torch.cuda.synchronize()
    for kind in ("moddown_lift", "moddown_apply"):
        assert kernels.LAUNCHES[kind] == before[kind] + 1
    if n <= kernels.MAX_ROW_N:
        for kind in ("ntt_fwd", "ntt_inv"):
            assert kernels.LAUNCHES[kind] == before[kind] + 1
    assert tbc.PLAIN_DIVISIONS_ON_CARD == plain_before
    want0, want1 = tbc.moddown_plain(ctx, a, b, count)
    assert got0.limb_ids == want0.limb_ids == ids[:L]
    assert torch.equal(got0.data, want0.data) and torch.equal(got1.data, want1.data)


@pytest.mark.cuda
def test_moddown_in_cuda_graph_on_card(cuda_device):  # noqa: F811
    """ModDown captured in a CUDA graph (its table built by an eager call
    before) replays bitwise the eager division on new inputs."""
    n, L, count, batch = 16384, 12, 2, (8,)
    ctx = _moddown_ctx(tuple(hm.gen_ntt_primes(30, L + count, n)), n)
    ids = tuple(range(L + count))
    a, b = _pair_on_card(ctx, ids, batch, n, cuda_device, 1)
    tbc.div_last_rounded_many(ctx, a, b, count)
    static = [a.data.clone(), b.data.clone()]
    side = torch.cuda.Stream(cuda_device)
    side.wait_stream(torch.cuda.current_stream(cuda_device))
    with torch.cuda.stream(side):
        tbc.div_last_rounded_many(ctx, *(trns.RnsPoly(x, trns.NTT, ids) for x in static), count)
    torch.cuda.current_stream(cuda_device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tbc.div_last_rounded_many(ctx, *(trns.RnsPoly(x, trns.NTT, ids) for x in static),
                                        count)
    for seed in (2, 3):
        c, d = _pair_on_card(ctx, ids, batch, n, cuda_device, seed)
        static[0].copy_(c.data)
        static[1].copy_(d.data)
        graph.replay()
        want = tbc.div_last_rounded_many(ctx, c, d, count)
        torch.cuda.synchronize()
        assert torch.equal(out[0].data, want[0].data) and torch.equal(out[1].data, want[1].data)


@pytest.mark.cuda
def test_ckks_ops_divide_without_plain_loop_on_card(cuda_device):  # noqa: F811
    """mult (+ relinearize), rotate, rescale and hoisted_rotations at
    alpha=2 on the card run every division through ModDown (the plain-loop
    counter stays 0), and give bitwise the CPU's results (the loop there)."""
    params, ctx = _port()
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    sk = trlwe.keygen(ctx, gen)
    rlk = tkeys.relin_key(ctx, sk, gen, alpha=2)
    rks = {s: tkeys.rot_key(ctx, sk, s, gen, alpha=2) for s in (1, 3)}
    a, b = (tckks.encrypt(ctx, tckks.encode(RNG.uniform(-1, 1, (2, N // 2)), params,
                                            device=cuda_device), sk, gen) for _ in range(2))

    def ops(a, b, rlk, rks):
        prod = tckks.mult(ctx, a, b, rlk)
        hoisted = tckks.hoisted_rotations(ctx, a, rks, sorted(rks))
        return [tckks.rescale(ctx, prod), tckks.rotate(ctx, a, rks[1], 1), *hoisted.values()]

    plain_before, lifts = tbc.PLAIN_DIVISIONS_ON_CARD, kernels.LAUNCHES["moddown_lift"]
    card = ops(a, b, rlk, rks)
    torch.cuda.synchronize()
    assert tbc.PLAIN_DIVISIONS_ON_CARD == plain_before
    assert kernels.LAUNCHES["moddown_lift"] == lifts + 5
    cpu = ops(*to_device((a, b, rlk, rks), "cpu"))
    for got, want in zip(card, cpu):
        assert got.c0.limb_ids == want.c0.limb_ids and got.scaling_factor == want.scaling_factor
        assert torch.equal(got.c0.data.cpu(), want.c0.data)
        assert torch.equal(got.c1.data.cpu(), want.c1.data)
