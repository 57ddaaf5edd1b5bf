"""hehub_tpu_torch.ops.ntt against hehub_tpu.ops.ntt: the plain forward
chain bitwise, the plain inverse equal mod q (and, on the XLA path that
the JAX package takes on the CPU, bitwise), round trips, the wrappers'
input checks, the register-group schedules of the CUDA kernels K1/K2 and
the several-rows-a-block schedule of their n <= 512 instantiations applied
with the plain butterflies, and — on the card — K1/K2 themselves bitwise
against the plain chains.

The JAX package is imported inside the tests that use it, so the card test
also runs where JAX is not installed."""

import numpy as np
import pytest
import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.ops import modarith as ma
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
    for n in (4, 3000, 1 << 18):
        with pytest.raises(ValueError):
            kernels._log_n(n)
    assert [kernels._log_n(n) for n in (8, 512, 32768, 65536, 131072)] == [3, 9, 15, 16, 17]


def test_u32_bits_round_trip():
    x = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1], dtype=torch.int64)
    bits = tn.to_u32_bits(x)
    assert bits.dtype == torch.int32 and bits.is_contiguous()
    assert torch.equal(tn.from_u32_bits(bits), x)


# log2 of the values a thread holds in csrc/ntt.cu's kernels (kElemsLog): the
# index bits of each register group
NTT_ELEMS_LOG = 4


def _reg_index(tid, e, b):
    """hh::reg_index of csrc/reglayout.cuh: value e of thread tid in the
    register group on index bits [b, b + NTT_ELEMS_LOG)."""
    return ((tid >> b) << (b + NTT_ELEMS_LOG)) | (e << b) | (tid & ((1 << b) - 1))


def _reg_groups(logh, inverse):
    """(B, LO, HI) of csrc/ntt.cuh's register groups on a half row of 2^logh
    values, in the order the chain runs them: the group at bit B runs the
    stages on bits [LO, HI). Forward from B = logh - EB down to 0, inverse
    from 0 up to logh - EB; where EB does not divide logh the last group is
    partial."""
    eb, out = NTT_ELEMS_LOG, []
    if inverse:
        B, lo = 0, 0
        while True:
            out.append((B, lo, B + eb))
            if B + eb >= logh:
                return out
            B, lo = (B + eb if B + 2 * eb <= logh else logh - eb), B + eb
    B, hi = logh - eb, logh
    while True:
        out.append((B, B, hi))
        if B == 0:
            return out
        B, hi = (B - eb if B > eb else 0), B


def _reg_schedule(x, tw, tw_sh, q, two_q, last=None):
    """csrc/ntt.cu's schedule with the plain butterflies of ops/modarith.py
    on rows x [..., L, n]. Forward: stage 0 pairs the two halves under
    tw[1]; then each half h (one block) runs the other stages in register
    groups. Inverse (`last` = (w_last, w_last_sh, n_inv, n_inv_sh) [L, 1]):
    each half runs all stages but the last in register groups; then the
    last pairs the halves and folds n^-1. A group gathers every thread's
    values at reg_index ([..., L, T, E]), runs its stages, the butterfly of
    values e_lo, e_lo + 2^(beta - B) under twiddle
    (2 + h) 2^(logh - 1 - beta) + (tid >> B) 2^(B + EB - 1 - beta)
    + (e_lo >> (beta - B + 1)), and puts them back."""
    n = x.shape[-1]
    H = n // 2
    logh, eb = H.bit_length() - 1, NTT_ELEMS_LOG
    tid = torch.arange(H >> eb)[:, None]
    e = torch.arange(1 << eb)[None, :]
    q3, two_q3 = q[..., None], two_q[..., None]
    inverse = last is not None
    x = x.clone()
    if not inverse:
        wh = ma.shoup_mul_lazy(x[..., H:], tw[:, 1:2], tw_sh[:, 1:2], q)
        x = torch.cat([ma.add_lazy(x[..., :H], wh, two_q), ma.sub_lazy(x[..., :H], wh, two_q)], -1)
    for h in (0, 1):
        part = x[..., h * H:(h + 1) * H].clone()
        for B, LO, HI in _reg_groups(logh, inverse):
            idx = _reg_index(tid, e, B)
            v = part[..., idx]
            for beta in (range(LO, HI) if inverse else range(HI - 1, LO - 1, -1)):
                lb = beta - B
                lo = torch.tensor([k for k in range(1 << eb) if not k >> lb & 1])
                hi = lo + (1 << lb)
                t = (((2 + h) << (logh - 1 - beta)) + ((tid >> B) << (B + eb - 1 - beta))
                     + (lo[None, :] >> (lb + 1)))
                w, w_sh = tw[:, t], tw_sh[:, t]
                a, b = v[..., lo], v[..., hi]
                if inverse:
                    new_lo = ma.add_lazy(a, b, two_q3)
                    new_hi = ma.shoup_mul_lazy(a + two_q3 - b, w, w_sh, q3)
                else:
                    wh = ma.shoup_mul_lazy(b, w, w_sh, q3)
                    new_lo, new_hi = ma.add_lazy(a, wh, two_q3), ma.sub_lazy(a, wh, two_q3)
                v[..., lo], v[..., hi] = new_lo, new_hi
            part[..., idx] = v
        x[..., h * H:(h + 1) * H] = part
    if inverse:
        a, b = x[..., :H], x[..., H:]
        w, w_sh, n_inv, n_inv_sh = last
        x = torch.cat([ma.shoup_mul_lazy(a + b, n_inv, n_inv_sh, q),
                       ma.shoup_mul_lazy(a + two_q - b, w, w_sh, q)], -1)
    return x


@pytest.mark.parametrize("n", [1024, 16384])
def test_register_schedules_are_bitwise_plain(n):
    """K1's and K2's schedules (the stage that pairs the halves; each half's
    register groups, their layouts and twiddle indices, the partial group:
    13 = 4+4+4+1 and 9 = 4+4+1 bits; the inverse's n^-1 fold), applied with
    the plain butterflies: bitwise ntt_fwd / ntt_inv. The layouts the
    kernels load and store hold too: the forward chain's first group and the
    inverse's last hold values at stride T, the other ends 2^EB contiguous
    values a thread."""
    ctx = _port_ctx(n)
    x = torch.from_numpy(
        lazy_residues(np.random.default_rng(n), (2,), ctx.moduli_of(IDS), n).astype(np.int64))
    fwd = [ctx.device_rows(nm, IDS, "cpu") for nm in tn.FWD_TABLES]
    inv = [ctx.device_rows(nm, IDS, "cpu") for nm in tn.INV_TABLES]
    assert torch.equal(_reg_schedule(x, *fwd), tn.ntt_fwd(x, *fwd))
    assert torch.equal(_reg_schedule(x, *inv[:4], last=inv[4:]), tn.ntt_inv(x, *inv))
    logh, eb = n.bit_length() - 2, NTT_ELEMS_LOG
    T = 1 << (logh - eb)
    tid, e = torch.arange(T)[:, None], torch.arange(1 << eb)[None, :]
    for groups in (_reg_groups(logh, False), _reg_groups(logh, True)[::-1]):
        assert any(hi - lo < eb for _, lo, hi in groups)  # a partial group ran
        assert torch.equal(_reg_index(tid, e, groups[0][0]), e * T + tid)
        assert torch.equal(_reg_index(tid, e, groups[-1][0]), tid * (1 << eb) + e)


# csrc/smallrow.cuh: values and threads of a block of the n <= 512 kernels
SMALL_VALUES, SMALL_THREADS = 2048, 256


def _small_schedule(x, tw, tw_sh, q, two_q, last=None):
    """csrc/smallrow.cuh's schedule with the plain butterflies of
    ops/modarith.py on rows x [rows, n] (row r under limb r % L): the rows
    packed SMALL_VALUES / n to a block (the last block padded), and in each
    stage thread tid's butterflies k < 4 acting on butterfly j = tid mod n/2
    of the block rows tid / (n/2) + k SMALL_THREADS / (n/2). Asserts that
    every stage's butterflies cover each block's values exactly once.
    Inverse when `last` = (w_last, w_last_sh, n_inv, n_inv_sh) [L, 1]."""
    rows, n = x.shape
    L, logn = tw.shape[0], n.bit_length() - 1
    per_block = SMALL_VALUES // n
    blocks = -(-rows // per_block)
    buf = torch.zeros(blocks * SMALL_VALUES, dtype=torch.int64)
    buf[: rows * n] = x.reshape(-1)
    buf = buf.view(blocks, SMALL_VALUES)
    tid = torch.arange(SMALL_THREADS)[:, None]
    rb = (tid >> (logn - 1)) + torch.arange(4)[None, :] * (SMALL_THREADS >> (logn - 1))
    limb = (torch.arange(blocks)[:, None, None] * per_block + rb) % L  # [blocks, T, 4]
    j = tid & (n // 2 - 1)
    for s in range(logn):
        t = 1 << s if last is not None else n >> (s + 1)
        i = j >> s if last is not None else j >> (logn - 1 - s)
        lo = (rb << logn) + 2 * t * i + (j & (t - 1))
        hi = lo + t
        assert torch.equal(torch.cat([lo.flatten(), hi.flatten()]).sort().values,
                           torch.arange(SMALL_VALUES))
        a, b = buf[:, lo], buf[:, hi]
        qk, two_qk = q[limb, 0], two_q[limb, 0]
        if last is None:
            w_at = (1 << s) + i
            wh = ma.shoup_mul_lazy(b, tw[limb, w_at], tw_sh[limb, w_at], qk)
            new_lo, new_hi = ma.add_lazy(a, wh, two_qk), ma.sub_lazy(a, wh, two_qk)
        elif s + 1 < logn:
            w_at = (n >> (s + 1)) + i
            new_lo = ma.add_lazy(a, b, two_qk)
            new_hi = ma.shoup_mul_lazy(a + two_qk - b, tw[limb, w_at], tw_sh[limb, w_at], qk)
        else:
            w, w_sh, n_inv, n_inv_sh = (c[limb, 0] for c in last)
            new_lo = ma.shoup_mul_lazy(a + b, n_inv, n_inv_sh, qk)
            new_hi = ma.shoup_mul_lazy(a + two_qk - b, w, w_sh, qk)
        buf = buf.clone()
        buf[:, lo], buf[:, hi] = new_lo, new_hi
    return buf.reshape(-1)[: rows * n].view(rows, n)


@pytest.mark.parametrize("n,batch", [(8, 257), (64, 5), (512, 6)])
def test_small_row_schedule_is_bitwise_plain(n, batch):
    """The schedule of K1's and K2's n <= 512 instantiations (several rows a
    block, a ragged last block; each thread's butterflies, rows, limbs and
    twiddle indices; the inverse's n^-1 fold), applied with the plain
    butterflies to [batch, 3, n]: bitwise ntt_fwd / ntt_inv."""
    ctx = _port_ctx(n)
    x = torch.from_numpy(
        lazy_residues(np.random.default_rng(n), (batch,), ctx.moduli_of(IDS), n).astype(np.int64))
    fwd = [ctx.device_rows(nm, IDS, "cpu") for nm in tn.FWD_TABLES]
    inv = [ctx.device_rows(nm, IDS, "cpu") for nm in tn.INV_TABLES]
    rows = x.reshape(-1, n)
    assert torch.equal(_small_schedule(rows, *fwd).view_as(x), tn.ntt_fwd(x, *fwd))
    assert torch.equal(_small_schedule(rows, *inv[:4], last=inv[4:]).view_as(x),
                       tn.ntt_inv(x, *inv))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,batch,L,against",
    [(1024, 3, 4, "cpu"), (16384, 2, 4, "cpu"), (8, 3, 4, "cpu"), (256, 3, 4, "cpu")]
    + [(1 << logn, batch, L, "card") for logn in range(3, 16) for batch in (1, 3, 128, 133)
       for L in (1, 4)])
def test_kernels_match_plain_on_card(cuda_device, n, batch, L, against):  # noqa: F811
    """K1 and K2 on [batch, L, n], one launch each, bitwise against the plain
    chains: on the CPU (through the wrappers), or on the same card at every
    n the kernels take (n = 8 .. 512 on the several-rows-a-block
    instantiations) and around one row per SM (133 is one more than the SM
    count)."""
    ctx = _port_ctx(n, levels=3)
    ids = tuple(range(L))
    x = torch.from_numpy(lazy_residues(RNG, (batch,), ctx.moduli_of(ids), n).astype(np.int64))
    xd = x.to(cuda_device)
    before = kernels.LAUNCHES["ntt_fwd"], kernels.LAUNCHES["ntt_inv"]
    fwd, inv = tn.ntt(ctx, xd, ids), tn.intt(ctx, xd, ids)
    assert (kernels.LAUNCHES["ntt_fwd"], kernels.LAUNCHES["ntt_inv"]) == (before[0] + 1,
                                                                          before[1] + 1)
    if against == "cpu":
        assert torch.equal(fwd.cpu(), tn.ntt(ctx, x, ids))
        assert torch.equal(inv.cpu(), tn.intt(ctx, x, ids))
    else:
        tabs = lambda names: [ctx.device_rows(nm, ids, cuda_device) for nm in names]  # noqa: E731
        assert torch.equal(fwd, tn.ntt_fwd(xd, *tabs(tn.FWD_TABLES)))
        assert torch.equal(inv, tn.ntt_inv(xd, *tabs(tn.INV_TABLES)))
    torch.cuda.synchronize()
