"""hehub_tpu_torch.rlwe.rgsw and core.basecnv against hehub_tpu, given the
same JAX-made secret and relinearization keys (carried over by
hehub_tpu_torch.convert): ext_prod and div_last_rounded_pair bitwise,
RgswCt.at_level, and — on the card — the fused external-product kernel K3
bitwise against its plain version, at every n it takes, and the alpha=1
ext_prod on the card bitwise against the plain path on the CPU.

The JAX package is imported inside the tests that use it, so the card test
also runs where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

from hehub_tpu_torch import convert, kernels
from hehub_tpu_torch.core import basecnv as tbc
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core import rns as trns
from hehub_tpu_torch.ops import modarith as tma
from hehub_tpu_torch.ops import ntt as tn
from hehub_tpu_torch.rlwe import keys as tkeys
from hehub_tpu_torch.rlwe import rgsw as trgsw
from hehub_tpu_torch.rlwe import rlwe as trlwe
from tests.torch_support import (  # noqa: F401
    as_numpy, cuda_device, ext_prod_case, lazy_residues, plain_ext_prod_conv)

RNG = np.random.default_rng(5)
N = 256
LEVELS = 3


@functools.lru_cache(maxsize=None)
def _jax_setup():
    """hehub_tpu context, secret key and relin key at N with LEVELS+1 limbs."""
    import jax

    from hehub_tpu.core.context import create_ckks_params, make_context
    from hehub_tpu.rlwe import keys, rlwe

    ctx = make_context(create_ckks_params(N, 28, LEVELS, use_security_budget=False))
    sk = rlwe.keygen(ctx, jax.random.key(0))
    return ctx, sk, keys.relin_key(ctx, sk, jax.random.key(1))


def _port_ctx():
    return tctx.make_context(tctx.create_ckks_params(N, 28, LEVELS, use_security_budget=False))


@pytest.mark.parametrize("level", [LEVELS, LEVELS - 1])
def test_ext_prod_bitwise(level):
    import jax

    from hehub_tpu.core import rns as jrns
    from hehub_tpu.rlwe import rgsw as jrgsw

    jctx, _, jrlk = _jax_setup()
    ids = tuple(range(level))
    x = lazy_residues(RNG, (2,), jctx.moduli_of(ids), N)

    @jax.jit
    def jax_ext_prod(d):
        k = jrlk.at_level(level, jctx.num_special)
        out = jrgsw.ext_prod(jctx, jrns.RnsPoly(d, jrns.NTT, ids), k)
        return out.c0.data, out.c1.data

    want0, want1 = jax_ext_prod(x)
    ctx = _port_ctx()
    rlk = convert.rgsw_from_numpy(np.asarray(jrlk.data), jrlk.limb_ids, jrlk.alpha,
                                  device="cpu")
    poly = convert.poly_from_numpy(x, trns.NTT, ids, device="cpu")
    got = trgsw.ext_prod(ctx, poly, rlk.at_level(level, ctx.num_special))
    assert got.c0.limb_ids == ids + ctx.special_indices
    np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want0))
    np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want1))


def test_div_last_rounded_pair_bitwise():
    import jax

    from hehub_tpu.core import basecnv as jbc
    from hehub_tpu.core import rns as jrns

    jctx, _, _ = _jax_setup()
    ids = tuple(range(LEVELS)) + jctx.special_indices
    a = lazy_residues(RNG, (2,), jctx.moduli_of(ids), N)
    b = lazy_residues(RNG, (2,), jctx.moduli_of(ids), N)

    @jax.jit
    def jax_div(a, b):
        mk = lambda d: jrns.RnsPoly(d, jrns.NTT, ids)  # noqa: E731
        c0, c1 = jbc.div_last_rounded_pair(jctx, mk(a), mk(b))
        return c0.data, c1.data

    want0, want1 = jax_div(a, b)
    ctx = _port_ctx()
    got0, got1 = tbc.div_last_rounded_pair(
        ctx, convert.poly_from_numpy(a, trns.NTT, ids, device="cpu"),
        convert.poly_from_numpy(b, trns.NTT, ids, device="cpu")
    )
    assert got0.limb_ids == ids[:-1]
    np.testing.assert_array_equal(as_numpy(got0.data), np.asarray(want0))
    np.testing.assert_array_equal(as_numpy(got1.data), np.asarray(want1))


@pytest.mark.parametrize("level", [LEVELS, 1])
def test_at_level_matches(level):
    jctx, _, jrlk = _jax_setup()
    rlk = convert.rgsw_from_numpy(np.asarray(jrlk.data), jrlk.limb_ids, device="cpu")
    got = rlk.at_level(level, jctx.num_special)
    want = jrlk.at_level(level, jctx.num_special)
    assert got.limb_ids == want.limb_ids and got.rows == want.rows
    np.testing.assert_array_equal(as_numpy(got.data), np.asarray(want.data))


def test_relin_key_from_torch_keygen_decrypts_to_noise():
    """A key made by the port has the JAX layout and is in the Montgomery
    domain: undoing R = 2^32 and decrypting row g leaves s²·B_g + e with
    |e| <= 6σ."""
    ctx = _port_ctx()
    gen = torch.Generator().manual_seed(3)
    sk = trlwe.keygen(ctx, gen)
    rlk = tkeys.relin_key(ctx, sk, gen)
    ids_ext = tuple(range(LEVELS)) + ctx.special_indices
    assert tuple(rlk.data.shape) == (LEVELS, 2, LEVELS + 1, N) and rlk.limb_ids == ids_ext
    q = ctx.device_rows("q", ids_ext, "cpu")
    plain = tma.from_mont(rlk.data, q, ctx.device_rows("neg_qinv", ids_ext, "cpu")) % q
    s = sk.ntt[list(ids_ext)]
    p_special = ctx.mod_list[ctx.special_indices[0]]
    for g in range(LEVELS):
        basis = torch.zeros((LEVELS + 1, 1), dtype=torch.int64)
        basis[g] = p_special % ctx.mod_list[g]
        v = (plain[g, 0] + plain[g, 1] * s - (s * s % q) * basis) % q
        e = trns.reduce_strict(ctx, trns.to_coeff(ctx, trns.RnsPoly(v, trns.NTT, ids_ext))).data
        e = torch.where(e > q // 2, e - q, e)
        assert int(e.abs().max()) <= 19
        assert torch.equal(e, e[:1].expand_as(e))  # the same small integers in every limb


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 64])
@pytest.mark.parametrize("logn", range(3, 16))
def test_ext_prod_kernel_matches_plain_on_card(cuda_device, logn, rows):  # noqa: F811
    """K3 at every n it takes (n = 8 .. 512 several rows a block), R = 1, 3,
    64 and L_ext = 5 (4 + 1 limbs): bitwise equal to its plain version (each
    strict digit broadcast over the extended limbs, plain forward NTT,
    ks_contract) on the same card; and,
    at R = 3, the alpha=1 ext_prod on the card (digits, int32 conversion and
    a keygen-made relin key read through its strides) bitwise equal to the
    plain path on the CPU."""
    n = 1 << logn
    ctx, ids_ext, tabs, digits, _, key = ext_prod_case(n, 4, 1, rows, cuda_device, logn)
    before = kernels.LAUNCHES["ext_prod"]
    got = tn.from_u32_bits(kernels.ext_prod(tn.to_u32_bits(digits), tn.to_u32_bits(key), *tabs))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ext_prod"] == before + 1
    tiled = digits[:, :, None, :].expand(rows, 4, len(ids_ext), n).contiguous()
    want0, want1 = plain_ext_prod_conv(ctx, ids_ext, tiled, key)
    assert torch.equal(got[0], want0) and torch.equal(got[1], want1)
    if rows != 3:
        return
    gen = torch.Generator().manual_seed(6)
    rlk = tkeys.relin_key(ctx, trlwe.keygen(ctx, gen), gen)
    ids = tuple(range(4))
    x = torch.from_numpy(lazy_residues(RNG, (rows,), ctx.moduli_of(ids), n).astype(np.int64))
    want = trgsw.ext_prod(ctx, trns.RnsPoly(x, trns.NTT, ids), rlk)
    rlk_d = trgsw.RgswCt(rlk.data.to(cuda_device), rlk.limb_ids)
    before = kernels.LAUNCHES["ext_prod"]
    got = trgsw.ext_prod(ctx, trns.RnsPoly(x.to(cuda_device), trns.NTT, ids), rlk_d)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ext_prod"] == before + 1
    assert torch.equal(got.c0.data.cpu(), want.c0.data)
    assert torch.equal(got.c1.data.cpu(), want.c1.data)


def test_mixed_width_division_and_garner_bitwise():
    """A 24-bit limb under 30-bit ones takes the mixed-width branches of
    div_last_rounded (q_last >= 2 q_j) and to_mixed_radix (q_0 >= 2 q_i)."""
    import jax

    from hehub_tpu.core import basecnv as jbc
    from hehub_tpu.core import context as jcx
    from hehub_tpu.core import rns as jrns
    from hehub_tpu_torch.utils import hostmath as hm

    p30 = hm.gen_ntt_primes(30, 2, N)
    moduli, special = (p30[1], hm.gen_ntt_primes(24, 1, N)[0]), p30[0]
    jctx = jcx.make_context(jcx.CkksParams(dimension=N, moduli=moduli, special_mod=special))
    ctx = tctx.make_context(tctx.CkksParams(dimension=N, moduli=moduli, special_mod=special))
    ids = (0, 1, 2)
    a = lazy_residues(RNG, (2,), jctx.moduli_of(ids), N)
    b = lazy_residues(RNG, (2,), jctx.moduli_of(ids), N)

    @jax.jit
    def jax_ref(a, b):
        mk = lambda d: jrns.RnsPoly(d, jrns.NTT, ids)  # noqa: E731
        c0, c1 = jbc.div_last_rounded_pair(jctx, mk(a), mk(b))
        return c0.data, c1.data, jbc.to_mixed_radix(jctx, a, ids, 2)

    want0, want1, want_digits = jax_ref(a, b)
    got0, got1 = tbc.div_last_rounded_pair(
        ctx, convert.poly_from_numpy(a, trns.NTT, ids, device="cpu"),
        convert.poly_from_numpy(b, trns.NTT, ids, device="cpu")
    )
    np.testing.assert_array_equal(as_numpy(got0.data), np.asarray(want0))
    np.testing.assert_array_equal(as_numpy(got1.data), np.asarray(want1))
    digits = tbc.to_mixed_radix(ctx, torch.from_numpy(a.astype(np.int64)), ids, 2)
    np.testing.assert_array_equal(as_numpy(digits), np.asarray(want_digits))
