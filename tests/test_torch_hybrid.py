"""Hybrid key switching (digit grouping alpha > 1) of hehub_tpu_torch
against hehub_tpu, mirroring tests/test_hybrid_ks.py: basecnv.base_convert
bitwise, alpha=2 keys made by hehub_tpu and carried over with `convert`,
then ext_prod, mult + relin + rescale, rotate(3), conjugate and a level
that cuts a digit group, all bitwise; the port's own alpha=2 keys; and, on
the card, the kernel K4 bitwise against its plain version at every n it
takes.

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
from tests.torch_support import (  # noqa: F401
    as_numpy, cuda_device, ext_prod_case, lazy_residues, plain_ext_prod_conv)

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
