"""The CKKS slice of hehub_tpu_torch against hehub_tpu:

(a) JAX-encrypted ciphertexts carried into the port, then mult -> rescale
    -> rotate(1) in both packages: bitwise equal ciphertexts;
(b) the port's host encode/decode against hehub_tpu's host codec;
(c) a port-only round trip with torch.Generator keys and noise, against
    numpy's np.roll(a*b, 1) (atol 2^-8: tests/test_ckks.py allows 2^-9 per
    operation);
(d) sampler statistics;
(e) on the card, the CKKS steps at alpha=1 (K3) and alpha>1 (ModUp, K4),
    and by parts at n=262144, against numpy and bitwise against the same
    steps on the CPU;
and chip_smoke.py's refusal to run without a card."""

import functools
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from hehub_tpu_torch import config, convert, kernels
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core import sampling
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.rlwe import keys as tkeys
from hehub_tpu_torch.rlwe import rlwe as trlwe
from tests.torch_support import Reference, as_numpy, cuda_device, to_device  # noqa: F401

jax = Reference("jax")
jcx = Reference("hehub_tpu.core.context")
jckks = Reference("hehub_tpu.models.ckks")
jkeys = Reference("hehub_tpu.rlwe.keys")
jrlwe = Reference("hehub_tpu.rlwe.rlwe")

RNG = np.random.default_rng(29)
N = 256
LEVELS = 3
ROOT = pathlib.Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _jax_setup():
    params = jcx.create_ckks_params(N, 28, LEVELS, use_security_budget=False)
    ctx = jcx.make_context(params)
    sk = jrlwe.keygen(ctx, jax.random.key(0))
    rlk = jkeys.relin_key(ctx, sk, jax.random.key(1))
    rk = jkeys.rot_key(ctx, sk, 1, jax.random.key(2))
    return params, ctx, sk, rlk, rk


def _port_params():
    params = tctx.create_ckks_params(N, 28, LEVELS, use_security_budget=False)
    return params, tctx.make_context(params)


def _rand(shape):
    return RNG.uniform(-1, 1, shape) + 1j * RNG.uniform(-1, 1, shape)


def _ct_to_port(ct):
    return convert.ct_from_numpy(np.asarray(ct.c0.data), np.asarray(ct.c1.data),
                                 ct.c0.limb_ids, ct.scaling_factor, device="cpu")


def test_slice_bitwise_against_jax():
    jparams, jctx, jsk, jrlk, jrk = _jax_setup()
    a, b = _rand((2, N // 2)), _rand((2, N // 2))
    encrypt = jax.jit(lambda pt, key: jckks.encrypt(jctx, pt, jsk, key))
    ca = encrypt(jckks.encode(a, jparams), jax.random.key(3))
    cb = encrypt(jckks.encode(b, jparams), jax.random.key(4))

    @jax.jit
    def jax_chain(ca, cb):
        r = jckks.rotate(jctx, jckks.rescale(jctx, jckks.mult(jctx, ca, cb, jrlk)), jrk, 1)
        return r.c0.data, r.c1.data

    want0, want1 = jax_chain(ca, cb)

    params, ctx = _port_params()
    rlk = convert.rgsw_from_numpy(np.asarray(jrlk.data), jrlk.limb_ids, device="cpu")
    rk = convert.rgsw_from_numpy(np.asarray(jrk.data), jrk.limb_ids, device="cpu")
    prod = tckks.rescale(ctx, tckks.mult(ctx, _ct_to_port(ca), _ct_to_port(cb), rlk))
    got = tckks.rotate(ctx, prod, rk, 1)
    assert got.limb_ids == tuple(range(LEVELS - 1))
    assert got.scaling_factor == ca.scaling_factor * cb.scaling_factor / jctx.mod_list[LEVELS - 1]
    np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want0))
    np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want1))

    # and it decrypts, under the carried-over key, to the rotated product
    sk = convert.sk_from_numpy(jsk.coeffs, jsk.ntt, jsk.ntt_sh, device="cpu")
    out = tckks.decode(tckks.decrypt(ctx, got, sk), params)
    np.testing.assert_allclose(out, np.roll(a * b, 1, axis=-1), atol=2**-8)


@pytest.mark.parametrize("magnitude", [1.0, 2.0**10])
def test_host_codec_against_jax(magnitude):
    """2^10 exceeds decode's default 2^8 magnitude bound: the sentinel limb
    fires and both packages re-decode over the full chain."""
    jparams = _jax_setup()[0]
    params, _ = _port_params()
    data = _rand((2, N // 2)) * magnitude
    jpt = jckks.encode(data, jparams)
    pt = tckks.encode(data, params, device="cpu")
    np.testing.assert_array_equal(as_numpy(pt.poly.data), np.asarray(jpt.poly.data))
    assert pt.scaling_factor == jpt.scaling_factor
    got = tckks.decode(pt, params)
    np.testing.assert_allclose(got, jckks.decode(jpt, jparams), rtol=0, atol=1e-9)
    np.testing.assert_allclose(got, data, atol=1e-6 * magnitude)


def test_round_trip_torch_generator():
    params, ctx = _port_params()
    gen = torch.Generator().manual_seed(2024)
    sk = trlwe.keygen(ctx, gen)
    rlk = tkeys.relin_key(ctx, sk, gen)
    rk = tkeys.rot_key(ctx, sk, 1, gen)
    a, b = _rand((3, N // 2)), _rand((3, N // 2))
    ca = tckks.encrypt(ctx, tckks.encode(a, params, device="cpu"), sk, gen)
    cb = tckks.encrypt(ctx, tckks.encode(b, params, device="cpu"), sk, gen)
    fresh = tckks.decode(tckks.decrypt(ctx, ca, sk), params)
    np.testing.assert_allclose(fresh, a, atol=2**-13)
    prod = tckks.rescale(ctx, tckks.mult(ctx, ca, cb, rlk))
    out = tckks.decode(tckks.decrypt(ctx, tckks.rotate(ctx, prod, rk, 1), sk), params)
    np.testing.assert_allclose(out, np.roll(a * b, 1, axis=-1), atol=2**-8)
    ck = tkeys.conj_key(ctx, sk, gen)
    conj = tckks.decode(tckks.decrypt(ctx, tckks.conjugate(ctx, ca, ck), sk), params)
    np.testing.assert_allclose(conj, np.conj(a), atol=2**-9)


def test_plain_ops_and_mod_drop():
    params, ctx = _port_params()
    gen = torch.Generator().manual_seed(77)
    sk = trlwe.keygen(ctx, gen)
    a, b = _rand((N // 2,)), _rand((N // 2,))
    ct = tckks.encrypt(ctx, tckks.encode(a, params, device="cpu"), sk, gen)
    pb = tckks.encode(b, params, device="cpu")
    dec = lambda c: tckks.decode(tckks.decrypt(ctx, c, sk), params)  # noqa: E731
    np.testing.assert_allclose(dec(tckks.add_plain(ctx, ct, pb)), a + b, atol=2**-12)
    np.testing.assert_allclose(dec(tckks.sub_plain(ctx, ct, pb)), a - b, atol=2**-12)
    np.testing.assert_allclose(dec(tckks.add(ctx, ct, ct)), 2 * a, atol=2**-12)
    np.testing.assert_allclose(dec(tckks.sub(ctx, ct, ct)), 0 * a, atol=2**-12)
    prod = tckks.rescale(ctx, tckks.mult_plain(ctx, ct, pb))
    np.testing.assert_allclose(dec(prod), a * b, atol=2**-10)
    dropped = tckks.mod_drop(ctx, ct)
    assert dropped.level == LEVELS - 1
    np.testing.assert_allclose(dec(dropped), a, atol=2**-12)


def test_sampler_statistics():
    _, ctx = _port_params()
    gen = torch.Generator().manual_seed(5)
    ids = tuple(range(LEVELS + 1))
    q = ctx.device_rows("q", ids, "cpu")
    tern = sampling.ternary_poly(ctx, gen, ids, (256,), form="coeff").data
    t = torch.where(tern > q // 2, tern - q, tern).to(torch.float64)
    assert set(t.unique().tolist()) == {-1.0, 0.0, 1.0}
    assert abs(t.mean().item()) < 0.01 and abs((t != 0).double().mean().item() - 2 / 3) < 0.01
    uni = sampling.uniform_poly(ctx, gen, ids, (256,)).data
    assert bool((uni >= 0).all()) and bool((uni < q).all())
    rel_mean = (uni.double() / q.double()).mean(dim=(0, 2))
    assert torch.allclose(rel_mean, torch.full_like(rel_mean, 0.5), atol=0.005)
    gauss = sampling.gaussian_poly(ctx, gen, ids, (256,), form="coeff").data
    e = torch.where(gauss > q // 2, gauss - q, gauss).to(torch.float64)
    assert torch.equal(e, e[:, :1].expand_as(e))  # one integer, lifted into every limb
    assert e.abs().max().item() <= 6 * sampling.SIGMA
    assert abs(e.mean().item()) < 0.05
    # a rounded normal has variance σ² + 1/12
    assert abs(e.std().item() - (sampling.SIGMA**2 + 1 / 12) ** 0.5) < 0.05
    sparse = trlwe.keygen(ctx, gen, hamming_weight=64)
    assert int((sparse.coeffs != 0).sum()) == 64


def test_chip_smoke_refuses_without_card(tmp_path):
    """No CUDA device here: the script fails and prints no result line; so
    it does alone in a directory without the package."""
    runs = [subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                           text=True, timeout=300)]
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    runs.append(subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                               capture_output=True, text=True, timeout=300))
    for run in runs:
        assert run.returncode != 0
        assert '"ok": true' not in run.stdout


# (n, chain limbs, special limbs, alpha, bounds on the product's and the
# rotated product's slots): n=16384 on 7 + 1 limbs and n=256 on 2 + 1 at
# alpha=1 (K3); at alpha>1 (ModUp, K4) n=256 on 4 + 2, std128.ks_b64's
# n=16384 on 12 + 2 and n=65536 on 4 + 4 at alpha=4 (K1, K2, K4 on
# sub-rows, K5 at m=32768); n=262144 on 2 + 2 at alpha 1 and 2, where every
# key switch runs by parts (the stage kernel S, then K4; K3 never) and the
# codec through K5 and F. At n=16384, alpha=1, the rotate carries the
# reference algorithm's own error (hehub_tpu's, which the port matches bit
# for bit): its key-switch digits are unsigned, in [0, q_i), and their mean
# q_i/2 times the key's noise lands on the slots whose root lies next to 1,
# about (n/π)·sqrt(l·n)·σ/Δ = 0.078 at l=6, Δ ≈ 2^26 (ROADMAP.md, Queue 3);
# the hybrid key switch's noise grows with n too, about 2^-7 at n=65536. At
# n=262144 the rescale's rounding noise reaches a slot as a sum over n
# coefficients: 2^-8 at n=65536 times the ring's ratio
CARD_CASES = [(16384, 7, 1, 1, 2.0**-8, 2.0**-3), (256, 2, 1, 1, 2.0**-8, 2.0**-8),
              (256, 4, 2, 2, 2.0**-8, 2.0**-8), (16384, 12, 2, 2, 2.0**-8, 2.0**-8),
              (65536, 4, 4, 4, 2.0**-8, 2.0**-5), (262144, 2, 2, 1, 2.0**-6, 2.0**-5),
              (262144, 2, 2, 2, 2.0**-6, 2.0**-5)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,levels,special,alpha,mult_bound,rot_bound", CARD_CASES)
def test_ckks_steps_on_card_are_cpu(cuda_device, monkeypatch, n, levels, special, alpha,  # noqa: F811
                                    mult_bound, rot_bound):
    """Keys, encode + encrypt (the device codec), mult + relinearize +
    rescale, rotate(1), decrypt + decode of a batch of 2 on the card: the
    slots within mult_bound of a*b and within rot_bound of its roll, the
    key switch's kernels launched (ModUp once a K4 launch at alpha>1), the
    tensor product's kernel once, and
    the steps on the CPU through the plain versions bitwise the card's,
    their slots (through the device codec's plain version) within 1e-12."""
    params = tctx.create_ckks_params(n, 28, levels, use_security_budget=False,
                                     num_special=special)
    ctx = tctx.make_context(params)
    gen = torch.Generator(device=cuda_device).manual_seed(n + alpha)
    rng = np.random.default_rng(n + alpha)
    a, b = (rng.uniform(-1, 1, (2, n // 2)) for _ in range(2))
    kernels.reset_launch_counts()
    sk = trlwe.keygen(ctx, gen)
    rlk = tkeys.relin_key(ctx, sk, gen, alpha=alpha)
    rk = tkeys.rot_key(ctx, sk, 1, gen, alpha=alpha)
    ca, cb = (tckks.encrypt(ctx, tckks.encode(v, params, device=cuda_device), sk, gen)
              for v in (a, b))
    prod = tckks.rescale(ctx, tckks.mult(ctx, ca, cb, rlk))
    rot = tckks.rotate(ctx, prod, rk, 1)
    out_prod, out_rot = (tckks.decode(tckks.decrypt(ctx, c, sk), params) for c in (prod, rot))
    torch.cuda.synchronize()
    if n > kernels.MAX_ROW_N:
        switch = ("ntt_stage", "ext_prod_conv", "fft_stage") + (("modup",) if alpha > 1 else ())
        assert kernels.LAUNCHES["ext_prod"] == 0
    else:
        switch = ("ext_prod",) if alpha == 1 else ("ext_prod_conv", "modup")
    for kind in ("ntt_fwd", "ntt_inv", "fft", "moddown_lift", "moddown_apply") + switch:
        assert kernels.LAUNCHES[kind] > 0, kind
    if alpha > 1:
        assert kernels.LAUNCHES["modup"] == kernels.LAUNCHES["ext_prod_conv"]
    assert kernels.LAUNCHES["tensor_product"] == 1
    assert rot.c0.limb_ids == tuple(range(levels - 1))
    assert np.abs(out_prod - a * b).max() <= mult_bound
    assert np.abs(out_rot - np.roll(a * b, 1, axis=-1)).max() <= rot_bound

    prod_c = tckks.rescale(ctx, tckks.mult(ctx, *to_device((ca, cb, rlk), "cpu")))
    rot_c = tckks.rotate(ctx, prod_c, to_device(rk, "cpu"), 1)
    for got, want in ((prod, prod_c), (rot, rot_c)):
        assert got.c0.limb_ids == want.c0.limb_ids and got.scaling_factor == want.scaling_factor
        assert torch.equal(got.c0.data.cpu(), want.c0.data)
        assert torch.equal(got.c1.data.cpu(), want.c1.data)
    monkeypatch.setattr(config, "use_device_codec", True)
    got_c = tckks.decode(tckks.decrypt(ctx, rot_c, to_device(sk, "cpu")), params)
    assert np.abs(got_c - out_rot).max() <= 1e-12
