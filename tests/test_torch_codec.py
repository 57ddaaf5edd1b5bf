"""The CKKS device codec of hehub_tpu_torch against numpy and hehub_tpu:

(a) the FP64 FFT's plain stage chain against numpy complex128, K5's
    schedules (rows split over a cluster; short rows several to a block)
    applied with the plain butterfly, and the balanced digit split, on
    their own;
(b) basecnv.decompose_balanced bitwise against hehub_tpu's;
(c) the device codec, forced on the CPU (config.use_device_codec = True),
    against hehub_tpu's float64 host codec (the reference's own df64 codec
    on XLA:CPU is only float32-accurate, so the FFT is held to numpy);
(d) on the card: the kernel K5 bitwise against the plain chain at every m
    it takes (m = 4 .. 256 on its several-rows-a-block instantiations), and
    the device codec against the host codec.

JAX is imported inside the tests that use it, so the card tests also run
where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

from hehub_tpu_torch import config as tconfig
from hehub_tpu_torch import convert, kernels
from hehub_tpu_torch.core import basecnv as tbc
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core.rns import COEFF
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.ops import fft as tfft
from hehub_tpu_torch.rlwe import rlwe as trlwe
from tests.torch_support import as_numpy, cuda_device  # noqa: F401

RNG = np.random.default_rng(11)
N = 1024


def _complex_rows(rows, m, rng=RNG):
    return rng.uniform(-1, 1, (rows, m)) + 1j * rng.uniform(-1, 1, (rows, m))


def _fft_inputs(x):
    """Bit-reversed real and imaginary planes of complex rows x [..., m]."""
    xb = x[..., tfft.bitrev_perm(x.shape[-1])]
    return torch.from_numpy(xb.real.copy()), torch.from_numpy(xb.imag.copy())


@pytest.mark.parametrize("m", [512, 4096])
def test_fft_plain_against_numpy(m):
    x = _complex_rows(3, m)
    re, im = tfft.fft_plain(*_fft_inputs(x), m)
    exact = np.fft.fft(x, axis=-1)
    got = re.numpy() + 1j * im.numpy()
    assert np.abs(got - exact).max() / np.abs(exact).max() < 1e-13
    # the dispatcher takes the plain chain for CPU tensors
    re2, im2 = tfft.fft(*_fft_inputs(x), m)
    assert torch.equal(re2, re) and torch.equal(im2, im)


# values a thread in csrc/fft.cu: its register groups take three index bits
K5_ELEMS_LOG = 3


def _reg_index(tid, e, b):
    """hh::reg_index of csrc/reglayout.cuh: value e of thread tid in the
    register group on index bits [b, b + 3)."""
    return ((tid >> b) << (b + K5_ELEMS_LOG)) | (e << b) | (tid & ((1 << b) - 1))


def _butterfly(ar, ai, br, bi, wr, wi):
    bwr = br * wr - bi * wi
    bwi = br * wi + bi * wr
    return ar + bwr, ai + bwi, ar - bwr, ai - bwi


def _k5_schedule(re, im, tw_re, tw_im):
    """csrc/fft.cu's schedule with the plain butterfly: each half of a row
    (one block of the cluster) runs stages 0 .. log m - 2 in register groups
    at bits B = 0, 3, 6, ... (where 3 does not divide log m - 1, a last
    group ends at bit log m - 2 and runs only the bits not done yet), stage
    B + sb taking twiddle 2^(B + sb) - 1 + (tid mod 2^B) + (e mod 2^sb)·2^B;
    then the last stage pairs j with j + m/2 under twiddle m/2 - 1 + j."""
    rows, m = re.shape
    Q = m // 2
    P = Q.bit_length() - 1
    vr, vi = re.reshape(rows, 2, Q).clone(), im.reshape(rows, 2, Q).clone()
    tid = torch.arange(Q >> K5_ELEMS_LOG)[:, None]
    B, lo = 0, 0
    while True:
        idx = _reg_index(tid, torch.arange(1 << K5_ELEMS_LOG)[None, :], B)  # [threads, 8]
        gr, gi = vr[..., idx], vi[..., idx]
        low = tid[:, 0] & ((1 << B) - 1)
        for sb in range(lo, K5_ELEMS_LOG):
            h = 1 << sb
            for jl in range(h):
                t = (1 << (B + sb)) - 1 + low + (jl << B)
                for i in range(jl, 1 << K5_ELEMS_LOG, 2 * h):
                    gr[..., i], gi[..., i], gr[..., i + h], gi[..., i + h] = _butterfly(
                        gr[..., i], gi[..., i], gr[..., i + h], gi[..., i + h], tw_re[t], tw_im[t])
        vr[..., idx], vi[..., idx] = gr, gi
        done = B + K5_ELEMS_LOG
        if done >= P:
            break
        B = done if done + K5_ELEMS_LOG <= P else P - K5_ELEMS_LOG
        lo = done - B
    t = Q - 1 + torch.arange(Q)
    ar, ai, br, bi = _butterfly(vr[:, 0], vi[:, 0], vr[:, 1], vi[:, 1], tw_re[t], tw_im[t])
    return torch.cat([ar, br], dim=-1), torch.cat([ai, bi], dim=-1)


@pytest.mark.parametrize("m", [512, 16384])
def test_fft_pass_split_is_bitwise_plain(m):
    """K5's split of the log m stages over the two blocks of a row's cluster
    and their register groups, with its layouts and twiddle indices, applied
    with the plain butterfly: bitwise fft_plain's result (at m = 512 the last
    register group is partial, at 16384 too, on other bits)."""
    x = _complex_rows(3, m, np.random.default_rng(m))
    re, im = _fft_inputs(x)
    tw_re, tw_im = (torch.from_numpy(t.copy()) for t in tfft.fft_tables(m))
    got_re, got_im = _k5_schedule(re, im, tw_re, tw_im)
    want_re, want_im = tfft.fft_plain(re, im, m)
    assert torch.equal(got_re, want_re) and torch.equal(got_im, want_im)
    assert torch.equal(torch.signbit(got_re), torch.signbit(want_re))


# csrc/fft.cu's fft_small_kernel (m <= 256): values and threads of a block
SMALL_FFT_VALUES, SMALL_FFT_THREADS = 1024, 256


@pytest.mark.parametrize("m,rows", [(4, 300), (32, 5), (256, 6)])
def test_fft_small_row_schedule_is_bitwise_plain(m, rows):
    """K5's m <= 256 schedule: the rows packed 1024 / m to a block (the last
    block padded), each stage's thread tid taking butterfly j = tid mod m/2
    of the block rows tid / (m/2) + k 512 / m, k < 2, under twiddle
    2^s - 1 + (j mod 2^s), applied with the plain butterfly: every stage
    covers each block's values once, and the result is bitwise fft_plain's."""
    x = _complex_rows(rows, m, np.random.default_rng(m))
    re, im = _fft_inputs(x)
    tw_re, tw_im = (torch.from_numpy(t.copy()) for t in tfft.fft_tables(m))
    logm, per_block = m.bit_length() - 1, SMALL_FFT_VALUES // m
    blocks = -(-rows // per_block)
    planes = []
    for plane in (re, im):
        buf = torch.zeros(blocks * SMALL_FFT_VALUES, dtype=torch.float64)
        buf[: rows * m] = plane.reshape(-1)
        planes.append(buf.view(blocks, SMALL_FFT_VALUES))
    vr, vi = planes
    tid = torch.arange(SMALL_FFT_THREADS)[:, None]
    rb = (tid >> (logm - 1)) + torch.arange(2)[None, :] * (SMALL_FFT_THREADS >> (logm - 1))
    j = tid & (m // 2 - 1)
    for s in range(logm):
        t = 1 << s
        lo = (rb << logm) + 2 * t * (j >> s) + (j & (t - 1))
        hi = lo + t
        assert torch.equal(torch.cat([lo.flatten(), hi.flatten()]).sort().values,
                           torch.arange(SMALL_FFT_VALUES))
        w = t - 1 + (j & (t - 1))
        ar, ai, br, bi = _butterfly(vr[:, lo], vi[:, lo], vr[:, hi], vi[:, hi], tw_re[w], tw_im[w])
        vr, vi = vr.clone(), vi.clone()
        vr[:, lo], vi[:, lo], vr[:, hi], vi[:, hi] = ar, ai, br, bi
    want_re, want_im = tfft.fft_plain(re, im, m)
    assert torch.equal(vr.reshape(-1)[: rows * m].view(rows, m), want_re)
    assert torch.equal(vi.reshape(-1)[: rows * m].view(rows, m), want_im)


def test_balanced_digits_recompose_exactly():
    v = RNG.uniform(-(2.0**45), 2.0**45, (2, 4096))
    v[0, :8] = [0.5, -0.5, 1.5, -2.5, 2.0**44 + 0.5, -(2.0**44) - 0.5, 2.0**45 - 1, 0.0]
    d = tfft.balanced_digits(torch.from_numpy(v)).numpy().astype(np.int64)
    assert d.shape == (2, 3, 4096)
    assert np.abs(d).max() <= 1 << 21
    recomposed = d[:, 0] + (d[:, 1] << 22) + (d[:, 2] << 44)
    np.testing.assert_array_equal(recomposed, np.rint(v).astype(np.int64))


def test_decompose_balanced_bitwise():
    import jax

    from hehub_tpu.core import basecnv as jbc
    from hehub_tpu.core import context as jcx

    params = dict(scaling_bits=28, num_levels=3, use_security_budget=False)
    jctx = jcx.make_context(jcx.create_ckks_params(N, **params))
    ctx = tctx.make_context(tctx.create_ckks_params(N, **params))
    ids = (0, 1, 2)
    digits = RNG.integers(-(1 << 22) + 1, 1 << 22, (2, 3, N)).astype(np.int32)
    want = jax.jit(lambda d: jbc.decompose_balanced(jctx, d, ids).data)(digits)
    got = tbc.decompose_balanced(ctx, torch.from_numpy(digits), ids)
    assert got.form == COEFF and got.limb_ids == ids
    np.testing.assert_array_equal(as_numpy(got.data), np.asarray(want))


@pytest.fixture
def device_codec_forced():
    old = tconfig.use_device_codec
    tconfig.use_device_codec = True
    yield
    tconfig.use_device_codec = old


@functools.lru_cache(maxsize=None)
def _params(levels=3, scale_bits=28):
    """(hehub_tpu params, port params) with the same primes: `levels`
    limbs, one of them the special prime, as tests/test_df64.py's _setup."""
    from hehub_tpu.core import context as jcx

    kw = dict(scaling_bits=scale_bits, num_levels=levels - 1, use_security_budget=False)
    return jcx.create_ckks_params(N, **kw), tctx.create_ckks_params(N, **kw)


def _pt_to_port(jpt):
    poly = convert.poly_from_numpy(np.asarray(jpt.poly.data), COEFF, jpt.poly.limb_ids,
                                   device="cpu")
    return tckks.CkksPt(poly, jpt.scaling_factor)


def test_device_encode_matches_host(device_codec_forced):
    from hehub_tpu.models import ckks as jckks

    jparams, params = _params()
    v = _complex_rows(2, N // 2)
    pt = tckks.encode(v, params, device="cpu")
    want = np.asarray(jckks.encode(v, jparams).poly.data).astype(np.int64)
    mods = np.asarray(params.moduli, np.int64)[:, None]
    diff = (as_numpy(pt.poly.data).astype(np.int64) - want) % mods
    assert np.minimum(diff, mods - diff).max() <= 1
    assert np.abs(tckks.decode(pt, params) - v).max() < 1e-6


def test_device_decode_matches_host(device_codec_forced):
    from hehub_tpu.models import ckks as jckks

    jparams, params = _params()
    v = _complex_rows(2, N // 2)
    jpt = jckks.encode(v, jparams)
    got = tckks.decode(_pt_to_port(jpt), params)
    assert np.abs(got - jckks.decode(jpt, jparams)).max() < 1e-9
    # fewer slots than n/2: the output gather takes the first `count`
    part = tckks.decode(_pt_to_port(jpt), params, count=5)
    np.testing.assert_array_equal(part, got[:, :5])


def test_device_round_trip_through_encryption(device_codec_forced):
    _, params = _params()
    ctx = tctx.make_context(params)
    gen = torch.Generator().manual_seed(7)
    sk = trlwe.keygen(ctx, gen)
    v = RNG.uniform(-1, 1, N // 2)
    ct = tckks.encrypt(ctx, tckks.encode(v, params, device="cpu"), sk, gen)
    got = np.real(tckks.decode(tckks.decrypt(ctx, ct, sk), params))
    assert np.abs(got - v).max() < 1e-4


@pytest.mark.parametrize("constant,fires", [(False, False), (True, True)])
def test_device_decode_overflow_sentinel(device_codec_forced, monkeypatch, constant, fires):
    """Decode reads K = 2 limbs at scale 2^28 and checks a third. Slots of
    |z| ~ 2^12 stay within the K limbs (the sentinel stays quiet, as it does
    in tests/test_df64.py::test_device_decode_overflow_probe); slots all
    near 2^32 give a constant coefficient near 2^60, beyond the 2-limb
    range: the sentinel fires and decode runs again over the full chain on
    the host (the encode of such slots takes the host codec)."""
    _, params = _params(levels=4)
    if constant:
        v = 2.0**32 + RNG.uniform(-1, 1, N // 2)
    else:
        v = RNG.uniform(-1, 1, N // 2) * 2.0**12
    pt = tckks.encode(v, params, scaling_factor=2.0**28, device="cpu")
    fired = []
    device_decode = tckks._decode_device

    def spy(*args):
        out = device_decode(*args)
        fired.append(out is None)
        return out

    monkeypatch.setattr(tckks, "_decode_device", spy)
    got = np.real(tckks.decode(pt, params))
    assert fired == [fires]
    assert np.abs(got - v).max() < 1e-3


def test_large_scale_takes_host_codec(device_codec_forced):
    """Scale 2^48 exceeds the device codec's coefficient bound: encode takes
    the float64 host codec, bitwise equal to hehub_tpu's, and decode too."""
    from hehub_tpu.models import ckks as jckks

    jparams, params = _params(levels=4, scale_bits=48)
    v = RNG.uniform(-1, 1, N // 2)
    jpt = jckks.encode(v, jparams, scaling_factor=2.0**48)
    pt = tckks.encode(v, params, scaling_factor=2.0**48, device="cpu")
    np.testing.assert_array_equal(as_numpy(pt.poly.data), np.asarray(jpt.poly.data))
    got = tckks.decode(pt, params)
    np.testing.assert_allclose(got, jckks.decode(jpt, jparams), rtol=0, atol=1e-12)
    assert np.abs(got - v).max() < 1e-9


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 3, 64, 130])
@pytest.mark.parametrize("m", [1 << logm for logm in range(2, 15)])
def test_fft_kernel_matches_plain_on_card(cuda_device, m, rows):  # noqa: F811
    x = _complex_rows(rows, m, np.random.default_rng(m + rows))
    want_re, want_im = tfft.fft_plain(*_fft_inputs(x), m)
    re, im = (t.to(cuda_device) for t in _fft_inputs(x))
    before = kernels.LAUNCHES["fft"]
    got_re, got_im = tfft.fft(re, im, m)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fft"] == before + 1
    assert torch.equal(got_re.cpu(), want_re) and torch.equal(got_im.cpu(), want_im)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 4096])
def test_device_codec_on_card_against_host(cuda_device, n):  # noqa: F811
    params = tctx.create_ckks_params(n, 28, 3, use_security_budget=False)
    v = _complex_rows(2, n // 2)
    before = kernels.LAUNCHES["fft"]
    pt = tckks.encode(v, params, device=cuda_device)
    host = tckks.encode(v, params, device="cpu")
    mods = torch.tensor(params.moduli, dtype=torch.int64)[:, None]
    diff = (pt.poly.data.cpu() - host.poly.data) % mods
    assert int(torch.minimum(diff, mods - diff).max()) <= 1
    got = tckks.decode(pt, params)
    assert kernels.LAUNCHES["fft"] == before + 2
    assert np.abs(got - tckks.decode(host, params)).max() < 1e-9
