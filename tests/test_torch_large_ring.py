"""Rings above n = 32768 (65536 and 131072) in hehub_tpu_torch: the split
that the CUDA kernels K1 and K2 make of such rows (sub-rows of 32768 under
Context's regrouped tables) emulated in plain PyTorch, and the cross
stages of csrc/ntt.cuh (fwd_cross for K1 and for K3/K4's sub-rows of
16384, inv_cross for K2) with the plain butterflies,
each bitwise against the plain full chains; the port's plain ntt, intt and
ext_prod (alpha 1 and 2) against hehub_tpu at n = 65536; and, on the card,
K1-K5 bitwise against their plain versions at both rings (K5 at m = 32768
and 65536).

The JAX package is imported inside the tests that use it, so the card
tests also run where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core import rns as trns
from hehub_tpu_torch.ops import fft as tfft
from hehub_tpu_torch.ops import modarith as ma
from hehub_tpu_torch.ops import ntt as tn
from hehub_tpu_torch.rlwe import rgsw as trgsw
from tests.torch_support import (  # noqa: F401
    as_numpy, cuda_device, ext_prod_case, jit_reference_ops, lazy_residues, plain_ext_prod_conv)

RINGS = (65536, 131072)
IDS = (0, 1, 2)


@functools.lru_cache(maxsize=None)
def _ctx(n, levels=3, num_special=1):
    return tctx.make_context(tctx.create_ckks_params(
        n, 28, levels, use_security_budget=False, num_special=num_special))


def _case(n, seed, device="cpu", batch=2):
    """(context, x [batch, 3, n] lazy residues, rows(name) of IDS on
    `device`)."""
    ctx = _ctx(n)
    x = lazy_residues(np.random.default_rng(seed), (batch,), ctx.moduli_of(IDS), n)
    rows = lambda nm, dtype=torch.int64: ctx.device_rows(nm, IDS, device, dtype)  # noqa: E731
    return ctx, torch.from_numpy(x.astype(np.int64)).to(device), rows


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", RINGS)
def test_split_emulation_is_bitwise_full_chain(n, inverse):
    """ntt_fwd_split / ntt_inv_split (k cross stages + sub-rows of 32768,
    from the regrouped tables alone) equal the plain full chains on
    [2, 3, n]."""
    _, x, rows = _case(n, n + inverse)
    if inverse:
        want = tn.ntt_inv(x, *map(rows, tn.INV_TABLES))
        got = tn.ntt_inv_split(x, *map(rows, tn.INV_SPLIT_TABLES))
    else:
        want = tn.ntt_fwd(x, *map(rows, tn.FWD_TABLES))
        got = tn.ntt_fwd_split(x, *map(rows, tn.FWD_SPLIT_TABLES))
    assert torch.equal(got, want)


def test_regrouped_tables():
    """sub_row_tables: row l 2^k + j holds tw[l, 2^k m + j m + i] at m + i
    and tw[l, j] at 0, so that a limb's rows hold tw[l, :2^(k+1)] too; the
    identity for rows no longer than the sub-rows; Context and ModulusTables
    hand out the same rows under sub_table names."""
    tw = np.arange(3 * 16, dtype=np.uint32).reshape(3, 16)
    sub = tctx.sub_row_tables(tw, 4)
    assert sub.shape == (12, 4)
    for l in range(3):
        for j in range(4):
            assert [sub[4 * l + j, m + i] for m in (1, 2) for i in range(m)] == \
                [tw[l, 4 * m + j * m + i] for m in (1, 2) for i in range(m)]
            assert sub[4 * l + j, 0] == tw[l, j]  # the cross stages' twiddles
    np.testing.assert_array_equal(
        tn._compact_prefix(torch.from_numpy(sub.astype(np.int64)), 2).numpy(), tw[:, :8])
    np.testing.assert_array_equal(tctx.sub_row_tables(tw, 16), tw)
    ctx = _ctx(RINGS[0])
    for sub_n in (kernels.NTT_SUB_N, kernels.EXT_SUB_N):
        name = tctx.sub_table("tw_inv_sh", sub_n)
        got = ctx.device_rows(name, (1, 2), "cpu", torch.int32)
        parts = RINGS[0] // sub_n
        assert got.shape == (2 * parts, sub_n)
        one = tctx.ModulusTables(ctx.mod_list[2], RINGS[0]).device_row(name, "cpu", torch.int32)
        assert torch.equal(one, got[parts:])


def _parts(x, S):
    P = x.shape[-1] >> S
    return [x[..., u * P:(u + 1) * P] for u in range(1 << S)]


def _cross_twiddle(sub, parts, at):
    """hh::cross_twiddle of csrc/ntt.cuh: entry `at` < 2 parts of each
    limb's compact table, [L, 1], read from its `parts` regrouped rows of
    sub [L parts, sub_n]."""
    rows = sub.reshape(-1, parts, sub.shape[-1])
    return rows[:, at, 0:1] if at < parts else rows[:, at - parts, 1:2]


def _fwd_cross(x, sub, sub_sh, parts, q, two_q, S, g):
    """hh::fwd_cross of csrc/ntt.cuh on every column of x [..., L, n] cut
    into 2^S parts, with the plain butterflies and the twiddles read as the
    kernels read them: part g's values after the first S stages."""
    y = _parts(x, S)
    for s in range(S):
        half, upper = 1 << (S - 1 - s), (g >> (S - 1 - s)) & 1
        at = (1 << s) + (g >> (S - s))
        w, w_sh = _cross_twiddle(sub, parts, at), _cross_twiddle(sub_sh, parts, at)
        for u in range(half):
            wh = ma.shoup_mul_lazy(y[u + half], w, w_sh, q)
            y[u] = (ma.sub_lazy if upper else ma.add_lazy)(y[u], wh, two_q)
    return y[0]


def _inv_cross(x, sub, sub_sh, parts, q, two_q, w_last, w_last_sh, n_inv, n_inv_sh, S):
    """hh::inv_cross of csrc/ntt.cuh on every column of x cut into 2^S
    parts, the twiddles read as K2 reads them: the chain's last S stages,
    the last folding n^-1."""
    y, U = _parts(x, S), 1 << S
    for s in range(S):
        t, blocks = 1 << s, U >> (s + 1)
        for i in range(blocks):
            for jj in range(t):
                lo, hi = 2 * t * i + jj, 2 * t * i + jj + t
                a, b = y[lo], y[hi]
                if s == S - 1:
                    y[lo] = ma.shoup_mul_lazy(a + b, n_inv, n_inv_sh, q)
                    y[hi] = ma.shoup_mul_lazy(a + two_q - b, w_last, w_last_sh, q)
                else:
                    w = _cross_twiddle(sub, parts, blocks + i)
                    w_sh = _cross_twiddle(sub_sh, parts, blocks + i)
                    y[lo] = ma.add_lazy(a, b, two_q)
                    y[hi] = ma.shoup_mul_lazy(a + two_q - b, w, w_sh, q)
    return torch.cat(y, dim=-1)


@pytest.mark.parametrize("n", RINGS)
def test_cross_stages_schedule_is_bitwise_plain(n):
    """The cross stages as K1 (2^(k+1) half sub-rows of NTT_SUB_N, each
    block keeping its own branch), K3/K4 (sub-rows of EXT_SUB_N) and K2 (the
    last k + 1 stages on columns of the half sub-rows) compute them, with
    the plain butterflies and their twiddles read from the regrouped tables
    as the kernels read them: equal to the plain chain's stages, every
    part."""
    _, x, rows = _case(n, 7 * n)
    fwd = list(map(rows, tn.FWD_TABLES))
    for split, sub_n, extra in ((tn.EXT_SPLIT_TABLES, kernels.EXT_SUB_N, 0),  # K3/K4
                                (tn.FWD_SPLIT_TABLES, kernels.NTT_SUB_N, 1)):  # K1
        parts = n // sub_n
        S = parts.bit_length() - 1 + extra
        sub, sub_sh, q, two_q = map(rows, split[:4])
        want = _parts(tn._fwd_stages(x, *fwd, range(S)), S)
        for g in range(1 << S):
            assert torch.equal(_fwd_cross(x, sub, sub_sh, parts, q, two_q, S, g), want[g])
    inv = list(map(rows, tn.INV_TABLES))
    parts = n // kernels.NTT_SUB_N
    logn, S = n.bit_length() - 1, parts.bit_length()
    before = tn._inv_stages(x, *inv[:4], None, range(logn - S))
    want = tn._inv_stages(before, *inv[:4], tuple(inv[4:]), range(logn - S, logn))
    split = list(map(rows, tn.INV_SPLIT_TABLES))
    assert torch.equal(_inv_cross(before, split[0], split[1], parts, *split[2:], S), want)


@pytest.fixture(scope="module")
def jit_ref():
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_ops(mp)
        yield


@pytest.mark.parametrize("inverse", [False, True])
def test_plain_ntt_matches_reference_at_65536(inverse, jit_ref):
    """The port's plain ntt / intt (the CPU side of K1 / K2) equal
    hehub_tpu's on one row of 2 + 2 limbs at n = 65536."""
    from hehub_tpu.core.context import create_ckks_params, make_context
    from hehub_tpu.ops import ntt as jn

    n, ids = RINGS[0], (0, 1, 2, 3)
    ctx = _ctx(n, 2, 2)
    jctx = make_context(create_ckks_params(n, 28, 2, use_security_budget=False, num_special=2))
    x = lazy_residues(np.random.default_rng(3 + inverse), (1,), ctx.moduli_of(ids), n)
    got = (tn.intt if inverse else tn.ntt)(ctx, torch.from_numpy(x.astype(np.int64)), ids)
    want = (jn.intt if inverse else jn.ntt)(jctx, x, ids)
    np.testing.assert_array_equal(as_numpy(got), np.asarray(want))


@pytest.mark.parametrize("alpha", [1, 2])
def test_plain_ext_prod_matches_reference_at_65536(alpha, jit_ref):
    """The port's plain ext_prod (the CPU side of K3 at alpha=1, K4 at
    alpha=2) equals hehub_tpu's on one row of 2 + 2 limbs at n = 65536,
    under the same random Montgomery-domain key rows."""
    from hehub_tpu.core import rns as jrns
    from hehub_tpu.core.context import create_ckks_params, make_context
    from hehub_tpu.rlwe import rgsw as jrgsw

    n, ids = RINGS[0], (0, 1)
    ctx = _ctx(n, 2, 2)
    jctx = make_context(create_ckks_params(n, 28, 2, use_security_budget=False, num_special=2))
    ids_ext = ids + ctx.special_indices
    rng = np.random.default_rng(40 + alpha)
    x = lazy_residues(rng, (1,), ctx.moduli_of(ids), n)
    key = lazy_residues(rng, (-(-len(ids) // alpha), 2), ctx.moduli_of(ids_ext), n)
    want = jrgsw.ext_prod(jctx, jrns.RnsPoly(x, jrns.NTT, ids),
                          jrgsw.RgswCt(key, ids_ext, alpha))
    got = trgsw.ext_prod(ctx, trns.RnsPoly(torch.from_numpy(x.astype(np.int64)), trns.NTT, ids),
                         trgsw.RgswCt(torch.from_numpy(key.astype(np.int64)), ids_ext, alpha))
    np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want.c0.data))
    np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want.c1.data))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("n", RINGS)
def test_ntt_kernels_match_plain_on_card(cuda_device, n, rows):  # noqa: F811
    """K1 and K2 on [rows, 3, n] bitwise against the plain chains on the
    card, through the context wrappers (which pass the regrouped tables),
    one launch each, and the round trip equal mod q."""
    ctx, x, rows_of = _case(n, rows, cuda_device, rows)
    before = dict(kernels.LAUNCHES)
    fwd, inv = tn.ntt(ctx, x, IDS), tn.intt(ctx, x, IDS)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ntt_fwd"] == before["ntt_fwd"] + 1
    assert kernels.LAUNCHES["ntt_inv"] == before["ntt_inv"] + 1
    assert torch.equal(fwd, tn.ntt_fwd(x, *map(rows_of, tn.FWD_TABLES)))
    assert torch.equal(inv, tn.ntt_inv(x, *map(rows_of, tn.INV_TABLES)))
    q = rows_of("q")
    assert torch.equal(tn.intt(ctx, fwd, IDS) % q, x % q)


@pytest.mark.cuda
@pytest.mark.parametrize("n", RINGS)
def test_ext_prod_kernels_match_plain_on_card(cuda_device, n):  # noqa: F811
    """K3 (alpha=1) and K4 (converted digits) at R = 3, l = 3 (2 digit
    groups for K4), L_ext = 5, bitwise against their plain versions on the
    card."""
    ctx, ids_ext, tabs, strict, conv, key = ext_prod_case(n, 3, 2, 3, cuda_device, n)
    k3 = tn.from_u32_bits(kernels.ext_prod(tn.to_u32_bits(strict), tn.to_u32_bits(key), *tabs))
    k4 = tn.from_u32_bits(kernels.ext_prod_conv(tn.to_u32_bits(conv), tn.to_u32_bits(key), *tabs))
    torch.cuda.synchronize()
    R, l = strict.shape[:2]
    tiled = strict[:, :, None, :].expand(R, l, len(ids_ext), n).contiguous()
    for got, digits in ((k3, tiled), (k4, conv)):
        want0, want1 = plain_ext_prod_conv(ctx, ids_ext, digits, key)
        assert torch.equal(got[0], want0) and torch.equal(got[1], want1)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [32768, 65536])
def test_fft_kernel_matches_plain_on_card(cuda_device, m):  # noqa: F811
    """K5 on [3, m] (clusters of 4 and 8 blocks) bitwise against fft_plain."""
    gen = torch.Generator(device=cuda_device).manual_seed(m)
    re, im = (torch.rand((3, m), generator=gen, device=cuda_device, dtype=torch.float64) - 0.5
              for _ in range(2))
    got = tfft.fft(re, im, m)
    want = tfft.fft_plain(re, im, m)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
