"""Key switching and the device codec above n = 131072 in hehub_tpu_torch:
the routes by parts that the card takes there, held on the CPU by their
plain twins.

(a) rlwe.rgsw.ext_prod_parts (the digits in memory, the k forward stages
    that pair whole parts, then K4 on each part as a virtual limb) on its
    plain twin, bitwise against ks_contract(ks_digits(...)) at n = 512 and
    1024 on parts of 256, alpha 1 and 2, batch 2, also in chunks of one
    row; ops.ntt.fwd_cross_stages against the forward chain's first stages;
(b) ops.fft.fft_parts (K5 on parts, then one launch of the stage kernel F
    a stage) on its plain twin, bitwise against fft_plain and within the
    codec tests' bound of numpy complex128; F's item schedule with the
    plain butterfly, bitwise fft_stage_plain;
(c) at n = 262144 against hehub_tpu on the CPU: rgsw.ext_prod at 1+1 limbs
    (alpha=1) and 2+2 limbs (alpha=2), batch 1, keys handed over through
    convert.rgsw_from_numpy, bitwise, and the plain split route beside it;
    ckks.encode / decode with the device codec's plain version
    (config.use_device_codec = True) against hehub_tpu's codec;
(d) on the card (`cuda` marker): the split routes through the kernels
    bitwise their plain twins at n = 262144, 524288 and 2^23, and a
    ValueError above kernels.MAX_N (CKKS mult and rotate at n = 262144 on
    the card: tests/test_torch_ckks.py).

JAX is imported inside the tests that use it, so the card tests also run
where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

from hehub_tpu_torch import config as tconfig
from hehub_tpu_torch import convert, kernels
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core import rns as trns
from hehub_tpu_torch.core.rns import COEFF, NTT, RnsPoly
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.ops import fft as tfft
from hehub_tpu_torch.ops import ntt as tn
from hehub_tpu_torch.rlwe import rgsw as trgsw
from hehub_tpu_torch.utils import hostmath as hm
from tests.torch_support import as_numpy, cuda_device, lazy_residues  # noqa: F401

BIG_N = 262144
# the codec tests' bounds (tests/test_torch_codec.py): the FFT against numpy
# complex128, relative to max |X|; encode within one unit of the host
# codec's residues; decode within 1e-9 of it
FFT_REL_ERR = 1e-13
DECODE_ERR = 1e-9
# the encode + decode round trip: rounding n coefficients to integers at
# scale Δ moves a slot by about sqrt(n) / Δ (1.9e-6 at n = 262144, Δ = 2^28)
ROUND_TRIP_ERR = 8 * np.sqrt(262144) / 2.0**28


@functools.lru_cache(maxsize=None)
def _ctx(n, levels, num_special, scaling_bits=28):
    return tctx.make_context(tctx.create_ckks_params(
        n, scaling_bits, levels, use_security_budget=False, num_special=num_special))


def _scaling_bits(levels):
    """A scale that `levels` 30-bit limbs hold (create_ckks_params: 29
    bits a limb for the scale and 11 of headroom)."""
    return min(28, 29 * levels - 11)


def _ks_case(n, levels, num_special, alpha, batch, seed, device="cpu"):
    """(ctx, strict source limbs d [batch, l, n] COEFF, key RgswCt of random
    lazy Montgomery-domain rows over l + specials) on `device`."""
    ctx = _ctx(n, levels, num_special)
    ids = tuple(range(levels))
    ids_ext = ids + ctx.special_indices
    rng = np.random.default_rng(seed)
    strict = np.stack([rng.integers(0, q, (batch, n)) for q in ctx.moduli_of(ids)], axis=1)
    key = lazy_residues(rng, (-(-levels // alpha), 2), ctx.moduli_of(ids_ext), n)
    d = RnsPoly(torch.from_numpy(strict).to(device), COEFF, ids)
    return ctx, d, convert.rgsw_from_numpy(key, ids_ext, alpha, device=device)


def _same(a, b):
    return torch.equal(a.c0.data, b.c0.data) and torch.equal(a.c1.data, b.c1.data)


# ---------------------------------------------------------------------------
# (a) the external product by parts, plain twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("alpha", [1, 2])
@pytest.mark.parametrize("n,part", [(512, 256), (1024, 256)])
def test_ext_prod_parts_is_bitwise_unsplit(n, part, alpha):
    """The plain split route (k = 1 and 2 cross stages, the parts as
    virtual limbs) equals the unsplit plain external product, 4 + 2 limbs,
    batch 2."""
    ctx, d, key = _ks_case(n, 4, 2, alpha, 2, n + alpha)
    want = trgsw.ks_contract(ctx, trgsw._strict_digits(ctx, d, key), key)
    assert _same(trgsw.ext_prod_parts(ctx, d, key, part, on_card=False), want)


@pytest.mark.parametrize("alpha", [1, 2])
def test_ext_prod_parts_in_chunks(alpha, monkeypatch):
    """Digits made a chunk of rows at a time (here one row of [2, 3] a
    chunk) give the same result as one chunk."""
    ctx, d, key = _ks_case(1024, 4, 2, alpha, 6, 7 + alpha)
    d = RnsPoly(d.data.reshape(2, 3, 4, 1024), COEFF, d.limb_ids)
    whole = trgsw.ext_prod_parts(ctx, d, key, 512, on_card=False)
    monkeypatch.setattr(trgsw, "DIGIT_CHUNK_BYTES", 1)
    chunked = trgsw.ext_prod_parts(ctx, d, key, 512, on_card=False)
    assert _same(chunked, whole) and chunked.c0.data.shape == (2, 3, 6, 1024)
    want = trgsw.ks_contract(ctx, trgsw._strict_digits(ctx, d, key), key)
    assert _same(whole, want)


def test_fwd_cross_stages_are_the_chains_first_stages():
    """ops.ntt.fwd_cross_stages (plain) is the forward chain's first k
    stages, for k = 1, 2, 3."""
    ctx = _ctx(1024, 3, 1)
    ids = (0, 1, 2)
    x = torch.from_numpy(lazy_residues(np.random.default_rng(5), (2,), ctx.moduli_of(ids), 1024)
                         .astype(np.int64))
    tabs = [ctx.device_rows(nm, ids, "cpu") for nm in tn.FWD_TABLES]
    for k in (1, 2, 3):
        assert torch.equal(tn.fwd_cross_stages(x, k, *tabs, on_card=False),
                           tn._fwd_stages(x, *tabs, range(k)))


# ---------------------------------------------------------------------------
# (b) the FFT by parts, plain twin, and F's schedule
# ---------------------------------------------------------------------------


def _fft_rows(rows, m, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (rows, m)) + 1j * rng.uniform(-1, 1, (rows, m))
    xb = x[..., tfft.bitrev_perm(m)]
    return x, torch.from_numpy(xb.real.copy()), torch.from_numpy(xb.imag.copy())


@pytest.mark.parametrize("m,part,rows", [(1024, 128, 3), (131072, 65536, 1)])
def test_fft_parts_is_bitwise_plain(m, part, rows):
    """fft_parts' plain twin (the DFT of each part of `part`, then the
    stages of span part .. m/2) equals fft_plain bitwise, and numpy's DFT
    within the codec tests' bound."""
    x, re, im = _fft_rows(rows, m, m)
    got = tfft.fft_parts(re, im, m, part, on_card=False)
    want = tfft.fft_plain(re, im, m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    exact = np.fft.fft(x, axis=-1)
    err = np.abs(got[0].numpy() + 1j * got[1].numpy() - exact).max()
    assert err / np.abs(exact).max() < FFT_REL_ERR


@pytest.mark.parametrize("m,t", [(1024, 2), (1024, 128), (1024, 512)])
def test_fft_stage_kernel_schedule_is_bitwise_plain(m, t):
    """csrc/fft.cu's F schedule: item k takes the butterflies (j, j + 1),
    j = 2k mod t, of block 2k / t of the rows taken end to end (lo = 2t
    block + j, hi = lo + t, twiddle tw[t - 1 + j]); every value is written
    once and the result is fft_stage_plain's, bitwise."""
    _, re, im = _fft_rows(3, m, t)
    tw_re, tw_im = (torch.from_numpy(a.copy()) for a in tfft.fft_tables(m))
    want = tfft.fft_stage_plain(re, im, t, tw_re, tw_im)
    fr, fi = re.reshape(-1).clone(), im.reshape(-1).clone()
    pair = 2 * torch.arange(fr.numel() // 4)
    j = pair & (t - 1)
    lo = torch.cat([((pair >> (t.bit_length() - 1)) << t.bit_length()) + j + e for e in (0, 1)])
    jj = torch.cat([j, j + 1])
    hi = lo + t
    assert torch.equal(torch.cat([lo, hi]).sort().values, torch.arange(fr.numel()))
    ar, ai, br, bi = fr[lo], fi[lo], fr[hi], fi[hi]
    wr, wi = tw_re[t - 1 + jj], tw_im[t - 1 + jj]
    bwr, bwi = br * wr - bi * wi, br * wi + bi * wr
    fr[lo], fi[lo], fr[hi], fi[hi] = ar + bwr, ai + bwi, ar - bwr, ai - bwi
    assert torch.equal(fr.view(re.shape), want[0]) and torch.equal(fi.view(im.shape), want[1])


# ---------------------------------------------------------------------------
# (c) n = 262144 against hehub_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("levels,alpha", [(1, 1), (2, 2)])
def test_ext_prod_matches_reference_at_262144(levels, alpha):
    """rgsw.ext_prod at n = 262144 on `levels` + `levels` limbs (alpha 1:
    K3's CPU side, alpha 2: K4's), batch 1, under the same random key rows
    handed over as numpy, bitwise hehub_tpu's (its XLA chains, jitted); the
    split route's plain twin on parts of 131072 gives the same bits."""
    import jax

    from hehub_tpu.core import rns as jrns
    from hehub_tpu.core.context import create_ckks_params, make_context
    from hehub_tpu.rlwe import rgsw as jrgsw

    bits = _scaling_bits(levels)
    ctx = _ctx(BIG_N, levels, levels, bits)
    jctx = make_context(create_ckks_params(BIG_N, bits, levels, use_security_budget=False,
                                           num_special=levels))
    ids = tuple(range(levels))
    ids_ext = ids + ctx.special_indices
    rng = np.random.default_rng(50 + alpha)
    x = lazy_residues(rng, (1,), ctx.moduli_of(ids), BIG_N)
    key = lazy_residues(rng, (-(-levels // alpha), 2), ctx.moduli_of(ids_ext), BIG_N)
    want = jax.jit(lambda xd, kd: jrgsw.ext_prod(
        jctx, jrns.RnsPoly(xd, jrns.NTT, ids), jrgsw.RgswCt(kd, ids_ext, alpha)))(x, key)
    tkey = convert.rgsw_from_numpy(key, ids_ext, alpha, device="cpu")
    poly = RnsPoly(torch.from_numpy(x.astype(np.int64)), NTT, ids)
    got = trgsw.ext_prod(ctx, poly, tkey)
    np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want.c0.data))
    np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want.c1.data))
    d = trns.reduce_strict(ctx, trns.to_coeff(ctx, poly))
    split = trgsw.ext_prod_parts(ctx, d, tkey, kernels.MAX_ROW_N, on_card=False)
    assert _same(split, got)


@pytest.fixture
def device_codec_forced():
    old = tconfig.use_device_codec
    tconfig.use_device_codec = True
    yield
    tconfig.use_device_codec = old


def test_device_codec_matches_reference_at_262144(device_codec_forced):
    """ckks.encode / decode at n = 262144 (the FFT's m = 131072) through the
    device codec's plain version against hehub_tpu's codec on 2 + 1 limbs:
    encode within one unit of its residues, decode within 1e-9 of its
    slots, and the round trip within ROUND_TRIP_ERR."""
    from hehub_tpu.core.context import create_ckks_params
    from hehub_tpu.models import ckks as jckks

    params = _ctx(BIG_N, 2, 1).params
    jparams = create_ckks_params(BIG_N, 28, 2, use_security_budget=False, num_special=1)
    assert jparams.moduli == params.moduli
    rng = np.random.default_rng(9)
    v = rng.uniform(-1, 1, BIG_N // 2) + 1j * rng.uniform(-1, 1, BIG_N // 2)
    pt = tckks.encode(v, params, device="cpu")
    jpt = jckks.encode(v, jparams)
    want = np.asarray(jpt.poly.data).astype(np.int64)
    mods = np.asarray(params.moduli, np.int64)[:, None]
    diff = (as_numpy(pt.poly.data).astype(np.int64) - want) % mods
    assert np.minimum(diff, mods - diff).max() <= 1
    back = tckks.decode(tckks.CkksPt(convert.poly_from_numpy(want, COEFF, jpt.poly.limb_ids,
                                                              device="cpu"), jpt.scaling_factor),
                        params)
    assert np.abs(back - jckks.decode(jpt, jparams)).max() < DECODE_ERR
    assert np.abs(tckks.decode(pt, params) - v).max() < ROUND_TRIP_ERR


# ---------------------------------------------------------------------------
# (d) on the card
# ---------------------------------------------------------------------------


def _top_case(n, R, l, device):
    """Strict digits and key rows at a ring with too few NTT primes for
    distinct limbs (n = 2^23 has one): every limb the one prime."""
    q = hm.gen_ntt_primes(30, 1, n)[0]
    ctx = tctx.make_context(tctx.RlweParams(dimension=n, moduli=(q,)))
    g = torch.Generator(device=device).manual_seed(n)
    d = RnsPoly(torch.randint(0, q, (R, l, n), generator=g, device=device), COEFF, (0,) * l)
    key = torch.randint(0, 2 * q, (l, 2, l + 1, n), generator=g, device=device)
    return ctx, d, trgsw.RgswCt(key, (0,) * (l + 1))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [262144, 524288, 1 << 23])
def test_ext_prod_parts_on_card_bitwise_plain(cuda_device, n):  # noqa: F811
    """ext_prod_strict on the card (the stage kernel, then K4 on parts of
    131072) bitwise its plain twin, at alpha=1 (and alpha=2 below 2^23),
    with K4 and the stage kernel launched and K3 not."""
    cases = []
    if n < 1 << 23:
        for alpha in (1, 2):
            ctx, d, key = _ks_case(n, 3, 2, alpha, 2, n + alpha, cuda_device)
            cases.append((ctx, d, key))
    else:
        cases.append(_top_case(n, 1, 2, cuda_device))
    for ctx, d, key in cases:
        before = dict(kernels.LAUNCHES)
        got = trgsw.ext_prod_strict(ctx, d, key)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["ext_prod_conv"] > before["ext_prod_conv"]
        assert kernels.LAUNCHES["ntt_stage"] > before["ntt_stage"]
        assert kernels.LAUNCHES["ext_prod"] == before["ext_prod"]
        want = trgsw.ext_prod_parts(ctx, d, key, kernels.MAX_ROW_N, on_card=False)
        assert _same(got, want)
        del got, want
        torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("m", [131072, 262144, 1 << 22])
def test_fft_parts_on_card_bitwise_plain(cuda_device, m):  # noqa: F811
    """ops.fft.fft above one K5 launch (K5 on parts of 65536, then F)
    bitwise fft_plain on the card, one K5 launch and log2(m / 65536) F
    launches."""
    g = torch.Generator(device=cuda_device).manual_seed(m)
    re, im = (torch.rand((2, m), generator=g, device=cuda_device, dtype=torch.float64) - 0.5
              for _ in range(2))
    before = dict(kernels.LAUNCHES)
    got = tfft.fft(re, im, m)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fft"] == before["fft"] + 1
    stages = (m // kernels.MAX_FFT_M).bit_length() - 1
    assert kernels.LAUNCHES["fft_stage"] == before["fft_stage"] + stages
    want = tfft.fft_plain(re, im, m)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_above_max_n_raises(cuda_device):  # noqa: F811
    """Above kernels.MAX_N the external product and the FFT raise
    ValueError on the card (no tables exist there)."""
    n = 2 * kernels.MAX_N
    ctx = _ctx(1024, 2, 1)
    d = RnsPoly(torch.zeros((1, 1, n), dtype=torch.int64, device=cuda_device), COEFF, (0,))
    key = trgsw.RgswCt(torch.zeros((1, 2, 2, 1), dtype=torch.int64,
                                   device=cuda_device).expand(1, 2, 2, n), (0, 1))
    with pytest.raises(ValueError):
        trgsw.ext_prod_strict(ctx, d, key)
    re = torch.zeros((1, n // 2), dtype=torch.float64, device=cuda_device)
    with pytest.raises(ValueError):
        tfft.fft(re, re, n // 2)
