"""The plain reference reads the program's conventions: its primes, NTT
values of the secret, decryption of the program's ciphertexts, the slot
order and rotation, and the program decrypts the reference's."""

import numpy as np
import pytest
import torch

from hebench.reference import ckks as ref
from hehub_tpu_torch.core.context import create_ckks_params, make_context
from hehub_tpu_torch.core.rns import NTT, RnsPoly
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod

N, L, K, ALPHA = 1024, 6, 2, 2


@pytest.fixture(scope="module")
def env():
    params = create_ckks_params(N, 28, num_levels=L, use_security_budget=False, num_special=K)
    ctx = make_context(params)
    gen = torch.Generator().manual_seed(3)
    tern = torch.randint(-1, 2, (N,), generator=gen).to(torch.int8)
    chain, special = ref.chain_and_special(N, L, K)
    return params, ctx, gen, tern, rlwe_mod.sk_from_coeffs(ctx, tern), ref.Ckks(
        N, chain, special, ALPHA, tern, "cpu")


def test_primes_and_secret(env):
    params, ctx, _, _, sk, r = env
    assert r.chain == list(params.moduli) and r.special == list(params.special_mods)
    assert torch.equal(r.s, sk.ntt % r.ring.q(r.all))
    assert ref.ntt_primes(16384, 14)[:2] == [1073643521, 1073479681]


def test_codec_round_trip():
    z = np.random.default_rng(0).uniform(-1, 1, (2, N // 2)) + 0j
    c = ref.coeffs_from_slots(z, N)
    assert np.abs(ref.slots_from_coeffs(c, N) - z).max() < 1e-12
    want = ckks._coeffs_from_slots(z, N)
    assert np.abs(c - want).max() < 1e-12


def test_reference_reads_the_programs_ciphertexts(env):
    params, ctx, gen, _, sk, r = env
    a = np.random.default_rng(1).uniform(-1, 1, (3, N // 2))
    ct = ckks.encrypt(ctx, ckks.encode(a, params, device="cpu"), sk, gen)
    assert np.abs(r.decrypt_slots(ct.c0.data, ct.c1.data, ct.scaling_factor) - a).max() < 1e-4
    rlk = keys_mod.relin_key(ctx, sk, gen, alpha=ALPHA)
    rk = keys_mod.rot_key(ctx, sk, 5, gen, alpha=ALPHA)
    x = ckks.CkksCt(ct.c0.with_data(ct.c0.data[:2]), ct.c1.with_data(ct.c1.data[:2]), ct.scaling_factor)
    y = ckks.CkksCt(ct.c0.with_data(ct.c0.data[1:]), ct.c1.with_data(ct.c1.data[1:]), ct.scaling_factor)
    p = ckks.rescale(ctx, ckks.mult(ctx, x, y, rlk))
    got = r.decrypt_slots(p.c0.data, p.c1.data, p.scaling_factor)
    assert np.abs(got - a[:2] * a[1:]).max() < 1e-3
    assert np.abs(ckks.decode(ckks.decrypt(ctx, p, sk), params) - got).max() < 1e-12
    q = ckks.rotate(ctx, x, rk, 5)
    got = r.decrypt_slots(q.c0.data, q.c1.data, q.scaling_factor)
    assert np.abs(got - np.roll(a[:2], 5, axis=-1)).max() < 1e-3


def test_program_reads_the_references_ciphertexts(env):
    params, ctx, _, _, sk, r = env
    a = np.random.default_rng(2).uniform(-1, 1, (2, N // 2))
    c0, c1 = r.encrypt(a, L, 2.0**28, torch.Generator().manual_seed(9))
    ct = ckks.CkksCt(RnsPoly(c0, NTT, tuple(range(L))), RnsPoly(c1, NTT, tuple(range(L))), 2.0**28)
    assert np.abs(ckks.decode(ckks.decrypt(ctx, ct, sk), params) - a).max() < 1e-4
