"""TFHE of hehub_tpu_torch against hehub_tpu at tests/test_tfhe.py's PAR
(N = 256, m = 32): the monomial tables, the monomial multiply, the gadget
decomposition and the modulus switch to 2N on random inputs; blind
rotation, sample extraction, the key switch (against both of the
reference's forms), the functional bootstraps and the NAND gate on
ciphertexts and keys made by hehub_tpu (noiseless and noisy), carried over
with `convert` — all bitwise; a NAND truth table on the port's own keys;
and the security estimates of tests/test_security.py against
hehub_tpu.utils.security. On the card, one CMUX step, the monomial tables
and the key switch bitwise against the CPU.

hehub_tpu runs its NTTs jitted (torch_support.jit_reference_ops). JAX is
imported inside the tests that use it, so the card tests also run where
JAX is not installed."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from hehub_tpu_torch import convert
from hehub_tpu_torch.models import tfhe as ttfhe
from hehub_tpu_torch.utils import security as tsec
from tests.torch_support import as_numpy, cuda_device, jit_reference_ops  # noqa: F401

PAR = ttfhe.TfheParams(rlwe_dimension=256, lwe_dimension=32, decomp_bits=6, decomp_levels=5,
                       ks_decomp_bits=10, ks_levels=3)
N, M, Q = PAR.rlwe_dimension, PAR.lwe_dimension, PAR.q
BATCH = 4
CPU = "cpu"


@pytest.fixture(scope="module")
def jit_ref():
    with pytest.MonkeyPatch.context() as mp:
        jit_reference_ops(mp)
        yield


def _jpar(params=PAR):
    from hehub_tpu.models import tfhe as jtfhe

    return jtfhe.TfheParams(**dataclasses.asdict(params))


@functools.lru_cache(maxsize=None)
def _keys(noisy: bool):
    """hehub_tpu's keys at PAR (tests/test_tfhe.py's seeds) and the port's
    twin of them."""
    import jax

    from hehub_tpu.models import tfhe as jtfhe

    jk = jtfhe.keygen(_jpar(), jax.random.key(71 if noisy else 70), debug_zero_e=not noisy)
    sk = convert.sk_from_numpy(jk.rlwe_sk.coeffs, np.asarray(jk.rlwe_sk.ntt),
                               np.asarray(jk.rlwe_sk.ntt_sh), device=CPU)
    return jk, convert.tfhe_keys_from_numpy(jk.lwe_s, sk, np.asarray(jk.bsk), jk.ksk_a, jk.ksk_b,
                                            device=CPU)


def _jax_ct(msgs, jk, seed, noise_std=None):
    """hehub_tpu's LWE encryption of `msgs`, and the port's twin of it."""
    import jax

    from hehub_tpu.models import tfhe as jtfhe

    jct = jtfhe.lwe_encrypt(_jpar(), np.asarray(msgs, np.uint32), jk.lwe_s, jax.random.key(seed),
                            noise_std=noise_std)
    return jct, convert.lwe_ct_from_numpy(np.asarray(jct.a), np.asarray(jct.b), device=CPU)


def _assert_lwe_equal(got, want):
    np.testing.assert_array_equal(as_numpy(got.a), np.asarray(want.a))
    np.testing.assert_array_equal(as_numpy(got.b), np.asarray(want.b))


def _random_lwe(seed, shape=(BATCH,), m=M):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, Q, (*shape, m)).astype(np.uint32)
    b = rng.integers(0, Q, shape).astype(np.uint32)
    return a, b


# ---------------------------------------------------------------------------
# Security estimates (tests/test_security.py)
# ---------------------------------------------------------------------------


def test_security_anchors_and_presets():
    from hehub_tpu.models import tfhe as jtfhe
    from hehub_tpu.utils import security as jsec

    close = lambda a, b: a == pytest.approx(b, rel=1e-12)  # noqa: E731
    assert tsec.HESTD_TERNARY_CLASSICAL == jsec.HESTD_TERNARY_CLASSICAL
    for n, logqs in tsec.HESTD_TERNARY_CLASSICAL.items():
        for logq, lam in zip(logqs, (128, 192, 256)):
            got = tsec.rlwe_budget_security_bits(n, logq)
            assert close(got, jsec.rlwe_budget_security_bits(n, logq))
            assert got == pytest.approx(lam, abs=1e-6)
    for n, q, sigma in ((742, 2.0**64, 2.0**46.1), (630, 2.0**32, 2.0**17), (1024, 2.0**30, 3.2),
                        (2048, 2.0**30, 3.2), (1024, 2.0**30, 2.0**10), (700, 2.0**30, 2.0**40),
                        (100000, 2.0**60, 3.2), (300, 2.0**20, 3.2)):
        assert close(tsec.ternary_lwe_security_bits(n, q, sigma),
                     jsec.ternary_lwe_security_bits(n, q, sigma))
    for mine, ref in ((ttfhe.PRESET_GATE_128, jtfhe.PRESET_GATE_128),
                      (ttfhe.PRESET_TOY, jtfhe.PRESET_TOY), (PAR, _jpar())):
        assert mine.q == ref.q
        assert close(mine.security_bits(), ref.security_bits())
        assert close(ttfhe.lwe_security_bits(mine.lwe_dimension, mine.q, mine.lwe_noise_std),
                     jtfhe.lwe_security_bits(ref.lwe_dimension, ref.q, ref.lwe_noise_std))
    assert ttfhe.PRESET_GATE_128.security_bits() == pytest.approx(141.1, abs=0.5)
    assert ttfhe.PRESET_TOY.security_bits() < 64


# ---------------------------------------------------------------------------
# Blind-rotation machinery on random inputs
# ---------------------------------------------------------------------------


def test_monomial_tables_equal_reference():
    from hehub_tpu.models import tfhe as jtfhe

    got = ttfhe._monomial_tables(PAR, CPU)
    for g, w in zip(got, jtfhe._monomial_tables(_jpar())):
        np.testing.assert_array_equal(as_numpy(g), np.asarray(w))


def test_negacyclic_monomial_mul():
    from hehub_tpu.models import tfhe as jtfhe

    rng = np.random.default_rng(1)
    coeffs = rng.integers(0, 2 * Q, (BATCH, 2, N)).astype(np.uint32)
    k = np.asarray([0, 5, N + 7, 2 * N - 1], np.uint32)
    got = ttfhe._negacyclic_monomial_mul(torch.from_numpy(coeffs.astype(np.int64)), k, N, 2 * Q)
    want = jtfhe._negacyclic_monomial_mul(coeffs, k, N, np.uint32(2 * Q))
    np.testing.assert_array_equal(as_numpy(got), np.asarray(want))


def test_gadget_decompose_and_mod_switch():
    from hehub_tpu.models import tfhe as jtfhe

    rng = np.random.default_rng(2)
    x = np.concatenate([rng.integers(0, Q, 200), [0, 1, Q - 1, Q // 2, Q // 4095]]).astype(
        np.uint32)
    xt = torch.from_numpy(x.astype(np.int64))
    np.testing.assert_array_equal(
        as_numpy(ttfhe._gadget_decompose(xt, PAR.decomp_bits, PAR.decomp_levels)),
        np.asarray(jtfhe._gadget_decompose(x, PAR.decomp_bits, PAR.decomp_levels)))
    for params in (PAR, ttfhe.PRESET_GATE_128):
        got = ttfhe._mod_switch_2n(params, xt % params.q)
        want = jtfhe._mod_switch_2n(_jpar(params), x % np.uint32(params.q))
        np.testing.assert_array_equal(as_numpy(got), np.asarray(want))


# ---------------------------------------------------------------------------
# LWE layer and key switch
# ---------------------------------------------------------------------------


def test_lwe_layer(jit_ref):
    from hehub_tpu.models import tfhe as jtfhe

    jk, keys = _keys(True)
    msgs = np.asarray([0, Q // 4, Q // 2, 3 * Q // 4], np.uint32)
    jct, ct = _jax_ct(msgs, jk, 1)
    for name in ("lwe_phase", "lwe_decrypt_bit"):
        np.testing.assert_array_equal(as_numpy(getattr(ttfhe, name)(PAR, ct, keys.lwe_s)),
                                      np.asarray(getattr(jtfhe, name)(_jpar(), jct, jk.lwe_s)))
    # the port's encryption: without noise, b = m - <a,s> exactly
    gen = torch.Generator().manual_seed(1)
    ct0 = ttfhe.lwe_encrypt(PAR, msgs, keys.lwe_s, gen, noise_std=0.0)
    dot = (as_numpy(ct0.a).astype(np.int64) * np.asarray(jk.lwe_s, np.int64)).sum(-1) % Q
    np.testing.assert_array_equal(as_numpy(ct0.b), (msgs.astype(np.int64) - dot) % Q)
    np.testing.assert_array_equal(as_numpy(ttfhe.lwe_phase(PAR, ct0, keys.lwe_s)), msgs)
    noisy = ttfhe.lwe_encrypt(PAR, msgs, keys.lwe_s, gen)
    err = (as_numpy(ttfhe.lwe_phase(PAR, noisy, keys.lwe_s)).astype(np.int64) - msgs) % Q
    assert (np.minimum(err, Q - err) < 64).all()


def _random_ks_keys(params, seed):
    """Random key-switch key material for `params`, as both packages hold
    it (the reference's with its Shoup companions)."""
    from hehub_tpu.models import tfhe as jtfhe

    rng = np.random.default_rng(seed)
    Nk, kl, m = params.rlwe_dimension, params.ks_levels, params.lwe_dimension
    ksk_a = rng.integers(0, Q, (Nk, kl, m)).astype(np.uint32)
    ksk_b = rng.integers(0, Q, (Nk, kl)).astype(np.uint32)
    sh = lambda x: ((x.astype(np.uint64) << np.uint64(32)) // np.uint64(Q)).astype(np.uint32)  # noqa: E731
    jk = jtfhe.TfheKeys(None, None, None, ksk_a, sh(ksk_a), ksk_b, sh(ksk_b))
    keys = ttfhe.TfheKeys(None, None, None, torch.from_numpy(ksk_a.astype(np.int64)),
                          torch.from_numpy(ksk_b.astype(np.int64)))
    return jk, keys


@pytest.mark.parametrize("form", ["elementwise", "int8 planes", "7-bit key planes"])
def test_key_switch_matches_both_reference_forms(form):
    """The float64 product against the reference's elementwise Shoup form
    (ks_decomp_bits 10 > 7) and its int8 planes (5 <= 7); and the port's
    own plane split, forced to 7-bit key planes, against the latter."""
    import jax

    from hehub_tpu.models import tfhe as jtfhe

    params = PAR if form == "elementwise" else dataclasses.replace(
        PAR, ks_decomp_bits=5, ks_levels=6)
    jk, keys = _random_ks_keys(params, 3)
    a, b = _random_lwe(4, (9,), params.rlwe_dimension)
    ct = convert.lwe_ct_from_numpy(a, b, device=CPU)
    jfn = jtfhe.key_switch if form == "elementwise" else jtfhe._key_switch_mxu
    want = jax.jit(lambda x, y: jfn(_jpar(params), jtfhe.LweCt(x, y), jk))(a, b)
    if form == "7-bit key planes":
        got = ttfhe._key_switch_planes(params, ct, keys, 7)
    else:
        got = ttfhe.key_switch(params, ct, keys)
        assert ttfhe._ks_plane_bits(params) == Q.bit_length()  # one plane holds the key
    _assert_lwe_equal(got, want)


# ---------------------------------------------------------------------------
# Bootstrapping on the reference's keys and ciphertexts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noisy", [False, True])
def test_blind_rotate_sample_extract(noisy, jit_ref):
    from hehub_tpu.models import tfhe as jtfhe

    jk, keys = _keys(noisy)
    rng = np.random.default_rng(5)
    a_t = rng.integers(0, 2 * N, (BATCH, M)).astype(np.uint32)
    b_t = rng.integers(0, 2 * N, BATCH).astype(np.uint32)
    lut = rng.integers(0, Q, N).astype(np.uint32)
    want = jtfhe.blind_rotate(_jpar(), lut, a_t, b_t, jk.bsk)
    got = ttfhe.blind_rotate(PAR, lut, torch.from_numpy(a_t.astype(np.int64)),
                             torch.from_numpy(b_t.astype(np.int64)), keys.bsk)
    np.testing.assert_array_equal(as_numpy(got), np.asarray(want))  # lazy representatives too
    _assert_lwe_equal(ttfhe.sample_extract(PAR, got), jtfhe.sample_extract(_jpar(), want))


def test_functional_bootstrap_noiseless(jit_ref):
    """tests/test_tfhe.py's exact and negacyclic cases, bitwise."""
    from hehub_tpu.models import tfhe as jtfhe

    jk, keys = _keys(False)
    two_n, nb = 2 * N, 8
    fvals = [(k + 1) * Q // 37 % Q for k in range(nb)]
    lut = np.repeat(np.asarray(fvals, np.uint32), N // nb)
    exps = np.arange(nb) * (N // nb) + N // nb // 2
    exps = np.concatenate([exps[:2], [N + N // 4, N + N // 2]])  # two negated
    msgs = (exps.astype(np.uint64) * Q // two_n).astype(np.uint32)
    jct, ct = _jax_ct(msgs, jk, 2, noise_std=0.0)
    want = jtfhe.functional_bootstrap(_jpar(), jct, lut, jk)
    got = ttfhe.functional_bootstrap(PAR, ct, lut, keys)
    _assert_lwe_equal(got, want)
    ph = as_numpy(ttfhe.lwe_phase(PAR, got, keys.lwe_s))
    np.testing.assert_array_equal(ph, [fvals[0], fvals[1], Q - fvals[2], Q - fvals[4]])


def test_redundant_msb_and_fully_functional_bootstrap(jit_ref):
    from hehub_tpu.models import tfhe as jtfhe

    jk, keys = _keys(False)
    two_n, nb = 2 * N, 8
    fvals = [(3 * k + 5) * Q // 41 % Q for k in range(nb)]
    lut = np.repeat(np.asarray(fvals, np.uint32), N // nb)
    buckets = np.asarray([1, 6, 1, 6])
    exps = buckets * (N // nb) + N // nb // 2 + np.asarray([0, 0, N, N])
    msgs = (exps.astype(np.uint64) * Q // two_n).astype(np.uint32)
    jct, ct = _jax_ct(msgs, jk, 5, noise_std=0.0)
    _assert_lwe_equal(ttfhe.get_redundant_msb(PAR, ct, keys),
                      jtfhe.get_redundant_msb(_jpar(), jct, jk))
    got = ttfhe.fully_functional_bootstrap(PAR, ct, lut, keys)
    _assert_lwe_equal(got, jtfhe.fully_functional_bootstrap(_jpar(), jct, lut, jk))
    err = (as_numpy(ttfhe.lwe_phase(PAR, got, keys.lwe_s)).astype(np.int64)
           - np.asarray(fvals, np.int64)[buckets]) % Q
    assert (np.minimum(err, Q - err) <= 16).all()


def test_nand_gate_noisy(jit_ref):
    from hehub_tpu.models import tfhe as jtfhe

    jk, keys = _keys(True)
    b1, b2 = np.asarray([0, 0, 1, 1]), np.asarray([0, 1, 0, 1])
    np.testing.assert_array_equal(as_numpy(ttfhe.encode_bit(PAR, b1, CPU)),
                                  np.asarray(jtfhe.encode_bit(_jpar(), b1)))
    (j1, c1), (j2, c2) = (_jax_ct(jtfhe.encode_bit(_jpar(), b), jk, s)
                          for b, s in ((b1, 6), (b2, 7)))
    want = jtfhe.nand_gate(_jpar(), j1, j2, jk)
    _assert_lwe_equal(ttfhe.nand_gate(PAR, c1, c2, keys), want)
    got = ttfhe.make_nand(PAR, keys)(c1, c2)
    _assert_lwe_equal(got, want)
    np.testing.assert_array_equal(as_numpy(ttfhe.lwe_decrypt_bit(PAR, got, keys.lwe_s)),
                                  1 - (b1 & b2))


def test_port_keygen_nand_truth_table():
    """The port's own keygen and sampling: the key-switch key's phases are
    z_j·Bks^v within its noise, and the NAND gives its truth table."""
    gen = torch.Generator().manual_seed(8)
    keys = ttfhe.keygen(PAR, gen)
    assert keys.bsk.shape == (M, 2, PAR.decomp_levels, 2, N)
    gks = torch.tensor([pow(1 << PAR.ks_decomp_bits, v, Q) for v in range(PAR.ks_levels)])
    want = keys.rlwe_sk.coeffs.to(torch.int64)[:, None] * gks % Q
    ph = ttfhe.lwe_phase(PAR, ttfhe.LweCt(keys.ksk_a, keys.ksk_b), keys.lwe_s)
    err = (ph - want) % Q
    assert int(torch.minimum(err, Q - err).max()) < 64
    bits = np.asarray([[0, 0, 1, 1], [0, 1, 0, 1]])
    c1, c2 = (ttfhe.lwe_encrypt(PAR, ttfhe.encode_bit(PAR, b, CPU), keys.lwe_s, gen)
              for b in bits)
    out = ttfhe.make_nand(PAR, keys)(c1, c2)
    np.testing.assert_array_equal(as_numpy(ttfhe.lwe_decrypt_bit(PAR, out, keys.lwe_s)),
                                  1 - (bits[0] & bits[1]))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("params", [PAR, ttfhe.PRESET_GATE_128], ids=["PAR", "GATE_128"])
def test_cmux_step_and_key_switch_on_card(cuda_device, params):  # noqa: F811
    """One CMUX step of the blind rotation (K1 on the digits, K2 on the
    accumulator difference), the monomial tables (K1) and the key switch on
    the card, bitwise against the CPU, on the port's own keys."""
    from hehub_tpu_torch import kernels

    gen = torch.Generator(device=cuda_device).manual_seed(9)
    keys = ttfhe.keygen(params, gen)
    n, q, B = params.rlwe_dimension, params.q, 8
    tables = ttfhe._monomial_tables(params, str(cuda_device))
    for got, want in zip(tables, ttfhe._monomial_tables(params, CPU)):
        assert torch.equal(got.cpu(), want)
    a_t = torch.randint(0, 2 * n, (B, 1), generator=gen, device=cuda_device)
    b_t = torch.randint(0, 2 * n, (B,), generator=gen, device=cuda_device)
    lut = torch.full((n,), q // 8, dtype=torch.int64)
    before = dict(kernels.LAUNCHES)
    acc = ttfhe.blind_rotate(params, lut, a_t, b_t, keys.bsk[:1], tables)
    assert kernels.LAUNCHES["ntt_fwd"] == before["ntt_fwd"] + 2  # test polynomial, digits
    assert kernels.LAUNCHES["ntt_inv"] == before["ntt_inv"] + 2  # difference, result
    cpu_tables = tuple(t.cpu() for t in tables)
    want = ttfhe.blind_rotate(params, lut, a_t.cpu(), b_t.cpu(), keys.bsk[:1].cpu(), cpu_tables)
    assert torch.equal(acc.cpu(), want)
    ext = ttfhe.sample_extract(params, acc)
    got = ttfhe.key_switch(params, ext, keys)
    cpu_keys = ttfhe.TfheKeys(None, None, None, keys.ksk_a.cpu(), keys.ksk_b.cpu())
    want = ttfhe.key_switch(params, ttfhe.LweCt(ext.a.cpu(), ext.b.cpu()), cpu_keys)
    torch.cuda.synchronize()
    assert torch.equal(got.a.cpu(), want.a) and torch.equal(got.b.cpu(), want.b)
