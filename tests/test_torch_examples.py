"""The port's twins of examples/*.py (hehub_tpu_torch.examples) meet the JAX
demos' own checks: on the CPU at the demos' sizes (CKKS at n=4096 with
N=10000, BGV exact at n=4096, the TFHE NAND at PRESET_TOY), and on the card
(TFHE at PRESET_GATE_128). Also the fault the BGV twin works around: the
reference's restoring mod_switch is not exact at the demo's parameters."""

import math

import numpy as np
import pytest
import torch

from hehub_tpu_torch.core.context import create_bgv_params, make_context
from hehub_tpu_torch.examples import bgv_example, ckks_example, tfhe_example
from hehub_tpu_torch.models import bgv
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from tests.torch_support import cuda_device  # noqa: F401

TOTAL = 10000


def _basel(total):
    return sum(1.0 / i**2 for i in range(1, total + 1))


def test_ckks_example_cpu():
    res = ckks_example.main(TOTAL, device="cpu")
    assert abs(res - _basel(TOTAL)) < ckks_example.MAX_ERR
    assert abs(res - math.pi**2 / 6) < ckks_example.MAX_ERR


def test_bgv_example_cpu():
    assert bgv_example.main(device="cpu")


def test_bgv_restoring_switch_is_not_exact_at_the_demo_parameters():
    """The switch that restores the plain scale on the ciphertext (the
    reference's, bitwise) multiplies the noise by q_last mod t and decrypts
    wrong on the demo's 2-limb chain; deferring the factor is exact."""
    params = create_bgv_params(4096, plain_bits=17, num_levels=2)
    ctx = make_context(params)
    t = params.plain_modulus
    gen = torch.Generator("cpu").manual_seed(11)
    sk = rlwe_mod.keygen(ctx, gen)
    rlk = keys_mod.relin_key(ctx, sk, gen, noise_scale=t)
    rng = np.random.default_rng(0)
    a, b = (rng.integers(0, t, 4096, dtype=np.uint64) for _ in range(2))
    ca, cb = (bgv.encrypt(ctx, bgv.simd_encode(ctx, x, device="cpu"), sk, gen) for x in (a, b))
    prod = bgv.mult(ctx, ca, cb, rlk)
    want = a * b % np.uint64(t)

    def slots(ct):
        return bgv.simd_decode(ctx, bgv.decrypt(ctx, ct, sk), device="cpu").astype(np.uint64)

    assert np.array_equal(slots(prod), want)
    assert not np.array_equal(slots(bgv.mod_switch(ctx, prod)), want)
    scale = bgv.plain_scale_dropped(ctx, prod)
    assert scale == params.moduli[-1] % t
    deferred = slots(bgv.mod_switch(ctx, prod, restore_plain_scale=False))
    assert np.array_equal(deferred * np.uint64(scale) % np.uint64(t), want)


def test_tfhe_example_cpu():
    np.testing.assert_array_equal(tfhe_example.main(device="cpu"), [1, 1, 1, 0])


@pytest.mark.cuda
def test_examples_on_card(cuda_device):  # noqa: F811
    from hehub_tpu_torch import kernels

    kernels.reset_launch_counts()
    res = ckks_example.main(TOTAL, device=str(cuda_device))
    assert abs(res - _basel(TOTAL)) < ckks_example.MAX_ERR
    assert bgv_example.main(device=str(cuda_device))
    np.testing.assert_array_equal(tfhe_example.main(secure=True, device=str(cuda_device)),
                                  [1, 1, 1, 0])
    for kind in ("ntt_fwd", "ntt_inv", "ext_prod", "fft"):
        assert kernels.LAUNCHES[kind] > 0, kind
