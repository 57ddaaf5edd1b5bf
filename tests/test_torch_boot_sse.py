"""Sparse-secret encapsulation and the refresh of the 128-bit bootstrap set
(circuits/bootstrap.py with rlwe/keys.sse_keys): the key from the secret
to the ephemeral secret holds no limb outside q0 and the special primes; a
round trip through both keys decrypts under each secret; the refresh of
hebench's configuration ckks_boot_n65536_h192 cut to n=256 against the
plain reference (hebench/reference/ckks_boot.py), both decrypting within
2^-12 of the input and of each other, with the key switches counted by
stage. The card tests hold the captured refresh bitwise to the eager one
at the configuration's full size, and at n=256 raise_modulus to the CPU's,
with its launches. No JAX here."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from hebench import bounds_boot
from hebench.reference import ckks_boot as ref_boot
from hehub_tpu_torch import kernels
from hehub_tpu_torch.circuits import bootstrap as bs
from hehub_tpu_torch.core.context import make_context
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from tests.torch_support import to_device

CONFIG = json.loads((pathlib.Path(__file__).resolve().parents[1] / "hebench" / "configs"
                     / "ckks_boot_n65536_h192.json").read_text())
SCALE_IN = 2.0 ** CONFIG["scaling_bits"]


def _setup(n, levels, device="cpu", seed=5):
    """Parameters as the boot cell makes them (the working scale the chain's
    two smallest primes), a context, the secret and the ephemeral secret."""
    params = bs.make_boot_params(n, levels, num_special=CONFIG["special_primes"])
    params = dataclasses.replace(params, initial_scaling_factor=float(
        params.moduli[-1] * params.moduli[-2]))
    ctx = make_context(params)
    rng = np.random.default_rng(seed)
    tern = ref_boot.sparse_ternary(n, CONFIG["secret_weight"], rng)
    eph = ref_boot.sparse_ternary(n, CONFIG["ephemeral_weight"], rng)
    sk = rlwe_mod.sk_from_coeffs(ctx, torch.from_numpy(tern).to(device))
    sk_eph = rlwe_mod.sk_from_coeffs(ctx, torch.from_numpy(eph).to(device))
    gen = torch.Generator(device=device).manual_seed(seed)
    return params, ctx, tern, eph, sk, sk_eph, gen


def _decode(ctx, params, ct, sk):
    return ckks.decode(ckks.decrypt(ctx, ct, sk), params)[..., : params.dimension // 2]


def test_sse_key_lives_on_q0_and_the_special_primes_only():
    params, ctx, _, _, sk, sk_eph, gen = _setup(256, 8)
    to_eph, from_eph = keys_mod.sse_keys(ctx, sk, sk_eph, gen, alpha=4)
    assert to_eph.limb_ids == (0,) + ctx.special_indices
    assert tuple(to_eph.data.shape) == (1, 2, 1 + ctx.num_special, 256)
    assert from_eph.limb_ids == tuple(range(8)) + ctx.special_indices
    assert from_eph.rows == 2 and from_eph.alpha == to_eph.alpha == 4
    with pytest.raises(ValueError, match="chain_limbs"):
        keys_mod.ksk_gen(ctx, sk.ntt, sk_eph, gen, alpha=4, chain_limbs=0)


def test_sse_round_trip_decrypts_under_each_secret():
    params, ctx, _, _, sk, sk_eph, gen = _setup(256, 8)
    to_eph, from_eph = keys_mod.sse_keys(ctx, sk, sk_eph, gen, alpha=4)
    v = np.random.default_rng(1).uniform(-1, 1, 128)
    ct = ckks.encrypt(ctx, ckks.encode(v, params, scaling_factor=SCALE_IN, level=7,
                                       device="cpu"), sk, gen)
    under_eph = ckks.switch_key(ctx, ct, to_eph)
    assert np.abs(_decode(ctx, params, under_eph, sk_eph) - v).max() < 2.0**-12
    assert np.abs(_decode(ctx, params, under_eph, sk) - v).max() > 1.0
    back = ckks.switch_key(ctx, under_eph, from_eph)
    assert np.abs(_decode(ctx, params, back, sk) - v).max() < 2.0**-12
    top = ckks.encrypt(ctx, ckks.encode(v, params, scaling_factor=2.0**28, device="cpu"),
                       sk_eph, gen)
    switched = ckks.switch_key(ctx, top, from_eph)
    assert np.abs(_decode(ctx, params, switched, sk) - v).max() < 2.0**-12


def _booter(ctx, params, sk, sk_eph, gen):
    c, a = CONFIG, CONFIG["alpha"]
    sse = keys_mod.sse_keys(ctx, sk, sk_eph, gen, alpha=a)
    rks = {st: keys_mod.rot_key(ctx, sk, st, gen, alpha=a)
           for st in bs.bootstrap_rotation_steps(params, c["lt_stages"])}
    return bs.Bootstrapper(ctx, params, keys_mod.relin_key(ctx, sk, gen, alpha=a), rks,
                           keys_mod.conj_key(ctx, sk, gen, alpha=a), k_bound=c["k_bound"],
                           degree=c["evalmod_degree"], arcsine=c["arcsine_degree"],
                           double_angle=c["double_angle"], lt_stages=c["lt_stages"], sse=sse)


def test_refresh_matches_the_plain_reference():
    n, L = 256, CONFIG["chain_primes"]
    params, ctx, tern, eph, sk, sk_eph, gen = _setup(n, L)
    booter = _booter(ctx, params, sk, sk_eph, gen)
    v = np.random.default_rng(2).uniform(-1, 1, (1, n // 2))
    ct = ckks.encrypt(ctx, ckks.encode(v, params, scaling_factor=SCALE_IN, level=L - 1,
                                       device="cpu"), sk, gen)
    bs.reset_counters()
    out = booter(ct)
    assert out.c0.limb_count >= CONFIG["refreshed_limbs"]
    assert bs.REFRESHES == 1
    ks = bs.KEY_SWITCHES
    assert ks["sse_in"] == ks["sse_out"] == 1
    assert ks["evalmod"] == 2 * bounds_boot._evalmod_mults(CONFIG["evalmod_degree"],
                                                           CONFIG["arcsine_degree"])
    assert ks["c2s"] > 0 and ks["s2c"] > 0 and "mod_raise" not in ks

    ref = ref_boot.CkksBoot(n, list(params.moduli), list(params.special_mods), CONFIG["alpha"],
                            torch.from_numpy(tern), torch.from_numpy(eph), "cpu")
    keys = ref.boot_keys(torch.Generator().manual_seed(3), ref.rotation_steps())
    r0, r1, r_scale = ref.refresh((ct.c0.data, ct.c1.data), SCALE_IN, keys, CONFIG["k_bound"],
                                  CONFIG["evalmod_degree"], params.initial_scaling_factor)
    got = ref.decrypt_slots(out.c0.data, out.c1.data, out.scaling_factor)
    want = ref.decrypt_slots(r0, r1, r_scale)
    assert ref.residue_mismatches(out.c0.data, out.c1.data) == 0
    assert ref.residue_mismatches(r0, r1) == 0
    for err in (np.abs(got - v).max(), np.abs(want - v).max(), np.abs(got - want).max()):
        assert err < 2.0**-12, err


@pytest.mark.cuda
def test_captured_refresh_is_bitwise_eager_at_full_size():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, L = CONFIG["n"], CONFIG["chain_primes"]
    params, ctx, _, _, sk, sk_eph, gen = _setup(n, L, device="cuda")
    booter = _booter(ctx, params, sk, sk_eph, gen)
    v = np.random.default_rng(2).uniform(-1, 1, n // 2)
    ct = ckks.encrypt(ctx, ckks.encode(v, params, scaling_factor=SCALE_IN, level=L - 1,
                                       device="cuda"), sk, gen)
    compiled = bs.CompiledBootstrapper(booter, ct, split=True)
    eager, captured = booter(ct), compiled(ct)
    assert eager.c0.limb_ids == captured.c0.limb_ids
    assert eager.c0.limb_count == CONFIG["refreshed_limbs"]
    assert torch.equal(eager.c0.data, captured.c0.data)
    assert torch.equal(eager.c1.data, captured.c1.data)
    assert np.abs(_decode(ctx, params, captured, sk) - v).max() < 2.0**-4


@pytest.mark.cuda
def test_raise_modulus_on_card_is_cpu():
    """At n=256 on the configuration's chain, keys made on the card: the key
    into the ephemeral secret lies on q0 and the special primes, and the
    switch through it decodes there within 2^-12; raise_modulus (SSE in,
    mod_raise, SSE out) launches ModUp and K4 twice, one of each a switch,
    and is bitwise the same on the CPU; at the top, rotate_accumulate over
    two rotations launches ModUp and K4 twice, hoisted rotations one ModUp
    and no K4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n, L, alpha = 256, CONFIG["chain_primes"], CONFIG["alpha"]
    params, ctx, _, _, sk, sk_eph, gen = _setup(n, L, device="cuda")
    sse = keys_mod.sse_keys(ctx, sk, sk_eph, gen, alpha=alpha)
    assert sse[0].limb_ids == (0,) + ctx.special_indices
    rks = {st: keys_mod.rot_key(ctx, sk, st, gen, alpha=alpha) for st in (1, 5)}
    v = np.random.default_rng(7).uniform(-1, 1, n // 2)
    ct = ckks.encrypt(ctx, ckks.encode(v, params, scaling_factor=SCALE_IN, level=L - 1,
                                       device="cuda"), sk, gen)
    under_eph = ckks.switch_key(ctx, ct, sse[0])
    assert np.abs(_decode(ctx, params, under_eph, sk_eph) - v).max() < 2.0**-12
    booter = bs.Bootstrapper(ctx, params, None, rks, None, CONFIG["k_bound"],
                             lt_stages=CONFIG["lt_stages"], sse=sse)
    kernels.reset_launch_counts()
    raised = booter.raise_modulus(ct)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["modup"] == kernels.LAUNCHES["ext_prod_conv"] == 2
    assert raised.c0.limb_count == L
    kernels.reset_launch_counts()
    summed = ckks.rotate_accumulate(ctx, [(raised, 1), (raised, 5)], rks)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["modup"] == kernels.LAUNCHES["ext_prod_conv"] == 2
    assert summed.c0.limb_count == L
    kernels.reset_launch_counts()
    hoisted = ckks.hoisted_rotations(ctx, raised, rks, sorted(rks))
    torch.cuda.synchronize()
    assert len(hoisted) == len(rks)
    assert kernels.LAUNCHES["modup"] == 1 and kernels.LAUNCHES["ext_prod_conv"] == 0
    assert kernels.LAUNCHES["ntt_fwd"] >= 1

    cpu = bs.Bootstrapper(ctx, params, None, {}, None, CONFIG["k_bound"],
                          lt_stages=CONFIG["lt_stages"], sse=to_device(sse, "cpu"))
    want = cpu.raise_modulus(to_device(ct, "cpu"))
    assert raised.c0.limb_ids == want.c0.limb_ids
    assert raised.scaling_factor == want.scaling_factor
    assert torch.equal(raised.c0.data.cpu(), want.c0.data)
    assert torch.equal(raised.c1.data.cpu(), want.c1.data)
