"""The port's host C++ runtime (hehub_tpu_torch.native.loader over its own
csrc/host/hehub_native.cpp) against hehub_tpu.native.loader and against the
port's numpy twins, bitwise, on seeded inputs at n=1024 and n=16384; the
host codec against hehub_tpu's; and a failed build raising. JAX is imported
inside the tests."""

import numpy as np
import pytest
import torch

from hehub_tpu_torch.core import basecnv as tbc
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.native import loader
from hehub_tpu_torch.ops import ntt as tn
from hehub_tpu_torch.utils import hostmath as thm

NS = (1024, 16384)
MODS = (1073643521, 1073479681, 1072496641, 1071513601)


@pytest.fixture(scope="module")
def jloader():
    from hehub_tpu.native import loader as jl

    assert jl.available(), "hehub_tpu's host runtime did not build: nothing to hold the port against"
    return jl


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif want is None:
        assert got is None
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", NS)
def test_digitize(jloader, n):
    rng = np.random.default_rng(n)
    c = rng.uniform(-(2.0**55), 2.0**55, (3, n))
    c[0, :6] = [0.5, -0.5, 1.5, 2.5, -2.5, 2.0**61]
    got = loader.digitize(c)
    _same(got, jloader.digitize(c))
    _same(got, tckks._digitize_plain(c))
    _same(tckks._digitize(c), got)
    for big in (2.0**62, -(2.0**62)):
        with pytest.raises(ValueError):
            loader.digitize(np.array([big]))


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("split_top", [False, True])
def test_mixed_radix(jloader, n, split_top):
    rng = np.random.default_rng(n + split_top)
    dg = rng.integers(0, MODS[0], (2, 4, n)).astype(np.uint32)
    small = dg.copy()
    small[..., -1, :] = 0  # an all-zero sentinel row: the runtime's None
    small[..., -2, :] = 0
    for d in (dg, small):
        got = loader.mixed_radix(d, MODS, split_top)
        _same(got, jloader.mixed_radix(d, MODS, split_top))
        plain = tckks._mixed_radix_to_float_plain(d, MODS, split_top)
        if split_top:
            _same(got[0], plain[0])
            if got[1] is None:
                assert not plain[1].any()
            else:
                _same(got[1], plain[1])
        else:
            _same(got, plain)
    assert loader.mixed_radix(small, MODS, True)[1] is None


@pytest.mark.parametrize("n", NS)
def test_codec_passes(jloader, n):
    """encode_pre/post and decode_pre/post against the reference's runtime
    and against numpy written pass for pass (real products, no FMA)."""
    rng = np.random.default_rng(n + 7)
    half = n // 2
    invj, j, tw_enc, tw_dec = tckks._half_transform_tables(n)
    data = rng.uniform(-1, 1, (2, half)) + 1j * rng.uniform(-1, 1, (2, half))

    pre = loader.encode_pre(data, invj)
    _same(pre, jloader.encode_pre(data, invj))
    want = data.copy()
    np.conjugate(want[..., 1::2], out=want[..., 1::2])
    _same(pre, want[..., invj])

    u = np.fft.fft(pre, axis=-1)
    scale = 2.0**40
    post = loader.encode_post(u, tw_enc, scale)
    _same(post, jloader.encode_post(u, tw_enc, scale))
    a, b, c, d = u.real, u.imag, tw_enc.real, tw_enc.imag
    coeffs = np.concatenate([(a * c - b * d) * scale, (a * d + b * c) * scale], axis=-1)
    _same(post, tckks._digitize_plain(coeffs))
    with pytest.raises(ValueError):
        loader.encode_post(u, tw_enc, 2.0**70)

    coeffs = np.round(rng.uniform(-(2.0**40), 2.0**40, (2, n)))
    dpre = loader.decode_pre(coeffs, tw_dec, 2.0**28)
    _same(dpre, jloader.decode_pre(coeffs, tw_dec, 2.0**28))
    a, b = coeffs[..., :half] / 2.0**28, coeffs[..., half:] / 2.0**28
    c, d = tw_dec.real, tw_dec.imag
    _same(dpre, (a * c - b * d) + 1j * (a * d + b * c))

    vals = np.fft.ifft(dpre, axis=-1)
    for count in (half, 7):
        dpost = loader.decode_post(vals, j, count)
        _same(dpost, jloader.decode_post(vals, j, count))
        want = vals[..., j[:count]]
        np.conjugate(want[..., 1::2], out=want[..., 1::2])
        _same(dpost, want)


@pytest.mark.parametrize("n", NS)
def test_compose_and_decompose(jloader, n):
    rng = np.random.default_rng(n + 11)
    mods = list(thm.gen_ntt_primes(30, 4, n))
    res = np.stack([rng.integers(0, q, n, dtype=np.uint64).astype(np.uint32) for q in mods])
    for t in (65537, 257, mods[0]):
        got = loader.compose_mod(res, mods, t)
        _same(got, jloader.compose_mod(res, mods, t))
        _same(got, tbc.convert_to_single_host_plain(res, mods, t))
    got = loader.compose_double(res, mods)
    _same(got, jloader.compose_double(res, mods))
    np.testing.assert_allclose(got, [float(x) for x in tbc.compose_to_int(res, mods)],
                               rtol=1e-15)
    signed = rng.integers(-(1 << 62), 1 << 62, (3, n))
    got = loader.decompose_i64(signed, mods)
    _same(got, jloader.decompose_i64(signed, mods))
    _same(got, np.stack([thm.decompose_rns([int(v) for v in row], mods) for row in signed])
          .astype(np.uint32))


@pytest.mark.parametrize("n", NS)
def test_ntt_and_primes(jloader, n):
    q = thm.gen_ntt_primes(30, 1, n)[0]
    tabs = tctx.ModulusTables(q, n)
    x = np.random.default_rng(n + 13).integers(0, q, n, dtype=np.uint64).astype(np.uint32)
    v = loader.ntt_fwd(x, q, tabs.tw_fwd)
    _same(v, jloader.ntt_fwd(x, q, tabs.tw_fwd))
    plain = tn.ntt_single(tabs, torch.from_numpy(x.astype(np.int64))[None]).numpy()[0]
    _same(v, (plain % q).astype(np.uint32))
    n_inv = thm.modinv(n, q)
    back = loader.ntt_inv(v, q, tabs.tw_inv, n_inv)
    _same(back, jloader.ntt_inv(v, q, tabs.tw_inv, n_inv))
    _same(back, x)
    got = np.empty(4, np.uint64)
    assert loader._lib().hh_gen_ntt_primes(30, 4, np.uint64(n), got) == 4
    assert tuple(int(p) for p in got) == thm.gen_ntt_primes(30, 4, n)
    for p in (2, 3, 4, 561, q, 2**31 - 1, 10**18 + 9, 10**18 + 7):
        assert loader.is_prime(p) == thm.is_prime(p) == jloader.is_prime(p)


@pytest.mark.parametrize("n", NS)
def test_host_codec_against_jax(jloader, n):
    """The port's host encode/decode (the runtime around scipy's FFT) equal
    hehub_tpu's bitwise; the numpy twins equal for encode and within 1e-13
    for decode, as hehub_tpu's own runtime and fallback are
    (tests/test_ckks.py)."""
    from hehub_tpu.models import ckks as jckks

    rng = np.random.default_rng(n + 17)
    half = n // 2
    scale = 2.0**28
    data = rng.uniform(-1, 1, (2, half)) + 1j * rng.uniform(-1, 1, (2, half))
    for slots in (data, data[..., :5]):
        got = tckks._encode_host(slots, n, scale)
        _same(got, jckks._encode_host(slots, n, scale))
        _same(got, tckks._encode_host_plain(slots, n, scale))
    coeffs = np.round(rng.uniform(-(2.0**40), 2.0**40, (2, n)))
    for count in (half, 7):
        got = tckks._decode_host(coeffs, n, scale, count)
        _same(got, jckks._decode_host(coeffs, n, scale, count))
        np.testing.assert_allclose(got, tckks._decode_host_plain(coeffs, n, scale, count),
                                   rtol=1e-13)


def test_failed_build_raises(monkeypatch, tmp_path):
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" int hh_is_prime_u64(unsigned long long n) { return n +; }\n')
    monkeypatch.setattr(loader, "_SRC", broken)
    monkeypatch.setattr(loader, "_BUILD", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        loader.build()
    assert not list((tmp_path / "build").rglob("*.so"))
