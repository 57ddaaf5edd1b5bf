"""hehub_tpu_torch.ops.ntt against hehub_tpu.ops.ntt: the plain forward
chain bitwise, the plain inverse equal mod q (and, on the XLA path that
the JAX package takes on the CPU, bitwise), round trips, the wrappers'
input checks, and — on the card — the CUDA kernels K1/K2 bitwise against
the plain chains.

The JAX package is imported inside the tests that use it, so the card test
also runs where JAX is not installed."""

import numpy as np
import pytest
import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.ops import ntt as tn
from tests.torch_support import as_numpy, cuda_device, lazy_residues  # noqa: F401

RNG = np.random.default_rng(11)
IDS = (0, 1, 2)


def _port_ctx(n, levels=2):
    return tctx.make_context(tctx.create_ckks_params(n, 28, levels, use_security_budget=False))


def _jax_transform(n, inverse):
    """(hehub_tpu context, jitted JAX ntt or intt over IDS) at dimension n."""
    import jax

    from hehub_tpu.core.context import create_ckks_params, make_context
    from hehub_tpu.ops import ntt as jn

    ctx = make_context(create_ckks_params(n, 28, 2, use_security_budget=False))
    fn = jn.intt if inverse else jn.ntt
    return ctx, jax.jit(lambda d: fn(ctx, d, IDS))


@pytest.mark.parametrize("n,batch", [(256, (2,)), (1024, (2, 2)), (2048, ())])
def test_ntt_fwd_bitwise(n, batch):
    ctx = _port_ctx(n)
    x = lazy_residues(RNG, batch, ctx.moduli_of(IDS), n)
    _, jfn = _jax_transform(n, inverse=False)
    got = tn.ntt(ctx, torch.from_numpy(x.astype(np.int64)), IDS)
    np.testing.assert_array_equal(as_numpy(got), np.asarray(jfn(x)))


@pytest.mark.parametrize("n,batch", [(256, (2,)), (1024, (2, 2)), (2048, ())])
def test_ntt_inv_equal_mod_q(n, batch):
    ctx = _port_ctx(n)
    q = ctx.q[list(IDS)].astype(np.int64)
    x = lazy_residues(RNG, batch, ctx.moduli_of(IDS), n)
    _, jfn = _jax_transform(n, inverse=True)
    got = as_numpy(tn.intt(ctx, torch.from_numpy(x.astype(np.int64)), IDS))
    want = np.asarray(jfn(x))
    np.testing.assert_array_equal(got % q, want % q)
    assert (got < 2 * q).all()
    # the JAX package's XLA chain (its CPU path) has the same representatives
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [256, 2048])
def test_round_trip(n):
    ctx = _port_ctx(n)
    q = ctx.q[list(IDS)].astype(np.int64)
    x = lazy_residues(RNG, (3,), ctx.moduli_of(IDS), n)
    t = torch.from_numpy(x.astype(np.int64))
    back = as_numpy(tn.intt(ctx, tn.ntt(ctx, t, IDS), IDS))
    np.testing.assert_array_equal(back % q, x % q)


def test_wrappers_reject_other_devices_and_sizes():
    ctx = _port_ctx(256)
    meta = torch.empty((3, 256), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        tn.ntt(ctx, meta, IDS)
    with pytest.raises(ValueError):
        tn.intt(ctx, meta, IDS)
    for n in (512, 65536, 3000):
        with pytest.raises(ValueError):
            kernels._log_n(n)


def test_u32_bits_round_trip():
    x = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], dtype=torch.int64)
    bits = tn.to_u32_bits(x)
    assert bits.dtype == torch.int32 and bits.is_contiguous()
    assert torch.equal(tn.from_u32_bits(bits), x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,batch", [(1024, (3,)), (16384, (2,))])
def test_kernels_match_plain_on_card(cuda_device, n, batch):  # noqa: F811
    ctx = _port_ctx(n, levels=3)
    ids = (0, 1, 2, 3)
    x = torch.from_numpy(lazy_residues(RNG, batch, ctx.moduli_of(ids), n).astype(np.int64))
    xd = x.to(cuda_device)
    fwd = tn.ntt(ctx, xd, ids)
    assert torch.equal(fwd.cpu(), tn.ntt(ctx, x, ids))
    inv = tn.intt(ctx, xd, ids)
    assert torch.equal(inv.cpu(), tn.intt(ctx, x, ids))
    torch.cuda.synchronize()
