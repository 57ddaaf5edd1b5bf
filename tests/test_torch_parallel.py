"""hehub_tpu_torch.parallel (mesh, ntt_sharded, pipeline) and
hehub_tpu_torch.entry against hehub_tpu.parallel on the same numpy inputs,
each bitwise: the mesh helpers and their refusals; the mult step on the
(8,1), (4,2) and (2,4) meshes against hehub_tpu's step jitted with
in_shardings on the 8-device CPU mesh that tests/conftest.py forces, and
an alpha=2 mult and rotate; the limb-sharded NTT round trip; a sharded
encrypt -> mult -> decode round trip; make_sharded_ntt at D = 2, 4, 8; both
pipelines against hehub_tpu.parallel.pipeline on jax.devices()[:3]; the
dryrun twin. Also the stage between parts of a row (ops.ntt.ntt_stage's
plain twin) and ntt/intt at n=262144 against hehub_tpu.ops.ntt, with the
staged schedule the card runs there.

The port's ranks are one 8-rank gloo World on the CPU for the whole module
(tests/torch_parallel_support.py holds their tasks), one CPU thread each;
its process group, start, tasks and joins each time out after 120 s. JAX is
imported inside the tests that use it, so the card tests (`cuda` marker:
the stage kernel, K2 without the fold, K1/K2 at n=262144, K3 on a
destination-limb slice of the key) run where JAX is not installed."""

import functools

import numpy as np
import pytest
import torch

from hehub_tpu_torch import convert, entry, kernels
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core.rns import NTT, RnsPoly
from hehub_tpu_torch.models import ckks as tckks
from hehub_tpu_torch.ops import ntt as tn
from hehub_tpu_torch.parallel import mesh as pmesh
from hehub_tpu_torch.parallel import ntt_sharded
from hehub_tpu_torch.parallel import pipeline as tpipe
from hehub_tpu_torch.rlwe import rgsw as trgsw
from hehub_tpu_torch.rlwe import rlwe as trlwe
from hehub_tpu_torch.utils import hostmath as hm
from tests import torch_parallel_support as tasks
from tests.torch_support import as_numpy, cuda_device, lazy_residues  # noqa: F401

N = 256
LEVELS = 4
TIMEOUT = 120.0
LARGE_N = 262144


@pytest.fixture(scope="module")
def world():
    w = pmesh.World(8, "gloo", timeout=TIMEOUT)
    yield w
    w.close()


@functools.lru_cache(maxsize=None)
def _jax_setup(alpha=1, num_special=1):
    """hehub_tpu params, context, secret key (the port's, handed over as
    numpy: hehub_tpu's keygen runs its NTT eagerly) and relin and rotation(3)
    keys at n=256, 4 levels."""
    import jax

    from hehub_tpu.core.context import create_ckks_params, make_context
    from hehub_tpu.rlwe import keys, rlwe

    params = create_ckks_params(N, 28, LEVELS, use_security_budget=False,
                                num_special=num_special)
    ctx = make_context(params)
    tctx_ = tctx.make_context(tctx.create_ckks_params(N, 28, LEVELS, use_security_budget=False,
                                                      num_special=num_special))
    tsk = trlwe.keygen(tctx_, torch.Generator().manual_seed(0))
    sk = rlwe.RlweSk(tsk.coeffs.numpy(), as_numpy(tsk.ntt), as_numpy(tsk.ntt_sh))
    rlk = keys.relin_key(ctx, sk, jax.random.key(1), alpha=alpha)
    rk = keys.rot_key(ctx, sk, 3, jax.random.key(2), alpha=alpha)
    return params, ctx, sk, tsk, rlk, rk


def _jax_step(ctx, ids, scale, key, kind):
    from hehub_tpu.core import rns
    from hehub_tpu.models import ckks

    def step(c0a, c1a, c0b, c1b):
        mk = lambda d: rns.RnsPoly(d, rns.NTT, ids)  # noqa: E731
        ca = ckks.CkksCt(mk(c0a), mk(c1a), scale)
        if kind == "rotate":
            out = ckks.rotate(ctx, ca, key, 3)
        else:
            out = ckks.rescale(ctx, ckks.mult(ctx, ca, ckks.CkksCt(mk(c0b), mk(c1b), scale), key))
        return out.c0.data, out.c1.data
    return step


def _jax_sharded(fn, args, mesh_shape, spec=None):
    """fn jitted with in_shardings on a hehub_tpu mesh of the given shape."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hehub_tpu.parallel import mesh as jmesh

    mesh = jmesh.make_mesh(*mesh_shape)
    shard = NamedSharding(mesh, spec or P(jmesh.BATCH_AXIS, jmesh.LIMB_AXIS, None))
    out = jax.jit(fn, in_shardings=(shard,) * len(args))(
        *(jax.device_put(a, shard) for a in args))
    return tuple(np.asarray(o) for o in out)


def _assemble(results, k=2):
    """Whole [batch, L, n] arrays from each rank's (batch coord, limb coord,
    out...) (the k outputs from position 2), batches then limbs in order."""
    results = sorted(r for r in results if r is not None)
    outs = []
    for j in range(k):
        rows = {}
        for r in results:
            rows.setdefault(r[0], []).append(r[2 + j])
        outs.append(np.concatenate([np.concatenate(v, axis=-2) for _, v in sorted(rows.items())]))
    return outs


def _inputs(ctx, ids, batch, seed):
    """The reference test's inputs: uint32 draws below 2^31, mod 2q."""
    rng = np.random.default_rng(seed)
    qs = np.asarray(ctx.moduli_of(ids), np.uint32)[:, None]
    return [rng.integers(0, 1 << 31, (batch, len(ids), N)).astype(np.uint32) % (2 * qs)
            for _ in range(4)]


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def test_mesh_helpers(world):
    from jax.sharding import PartitionSpec as P

    from hehub_tpu.parallel import mesh as jmesh

    for rank in world.run(tasks.mesh_helpers):
        assert rank["shape"] == (4, 2) and rank["names"] == (pmesh.BATCH_AXIS, pmesh.LIMB_AXIS)
        assert rank["refused"] and rank["constrained"] and rank["shard_ok"], rank
    for bd, sl in ((1, True), (1, False), (0, True), (2, True)):
        assert pmesh.ct_pspec(bd, sl) == tuple(jmesh.ct_pspec(bd, sl))
    assert pmesh.ct_pspec(1, True) == tuple(P(pmesh.BATCH_AXIS, pmesh.LIMB_AXIS, None))
    with pytest.raises(ValueError):
        jmesh.make_mesh(8, 2)
    for total, ways in ((7, 2), (7, 4), (3, 4), (8, 8)):
        want = [len(p) for p in torch.tensor_split(torch.arange(total), ways)]
        assert pmesh.split_sizes(total, ways) == want
        assert sum(pmesh.limb_parts(range(total), ways), ()) == tuple(range(total))
    with pytest.raises(RuntimeError):  # no process group in this process
        pmesh.make_mesh(1, 1)


def test_rank_devices_and_backend():
    """The cards in turn, or the CPU on request; NCCL only where every
    rank has a card of its own."""
    cpu, c0, c1 = torch.device("cpu"), torch.device("cuda", 0), torch.device("cuda", 1)
    assert pmesh.rank_devices(3, "cpu") == [cpu] * 3
    if torch.cuda.device_count() == 0:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pmesh.rank_devices(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry.dryrun_multichip(2)
    else:
        cards = torch.cuda.device_count()
        assert pmesh.rank_devices(3) == [torch.device("cuda", r % cards) for r in range(3)]
    with pytest.raises(ValueError):
        pmesh.rank_devices(2, "meta")
    assert pmesh.backend_for(None) == pmesh.backend_for([cpu, cpu]) == "gloo"
    assert pmesh.backend_for([c0, c0]) == pmesh.backend_for([c0, cpu]) == "gloo"
    assert pmesh.backend_for([c0]) == pmesh.backend_for([c0, c1]) == "nccl"
    x = torch.arange(12).reshape(1, 3, 4)
    assert pmesh.all_gather_limbs(None, x, ((0, 1, 2),)) is x  # one limb rank: no collective


# ---------------------------------------------------------------------------
# Sharded CKKS steps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_ways,limb_ways", [(8, 1), (4, 2), (2, 4)])
def test_sharded_mult_matches_jax(world, batch_ways, limb_ways):
    params, jctx, _, _, rlk, _ = _jax_setup()
    ids = tuple(range(LEVELS))
    scale = params.initial_scaling_factor
    args = _inputs(jctx, ids, 2 * batch_ways, 42)
    want = _jax_sharded(_jax_step(jctx, ids, scale, rlk, "mult"), args, (batch_ways, limb_ways))
    res = world.run(tasks.sharded_step, "mult", N, LEVELS, 1, np.asarray(rlk.data),
                    rlk.limb_ids, 1, args, scale, (batch_ways, limb_ways))
    got = _assemble(res)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert {r[5] for r in res} == {scale * scale / jctx.mod_list[LEVELS - 1]}
    # batch sharding alone runs no collective
    assert {r[6] for r in res} == {() if limb_ways == 1 else ("all_gather", "broadcast")}


@pytest.mark.parametrize("kind", ["mult", "rotate"])
def test_sharded_hybrid_alpha2_matches_jax(world, kind):
    """alpha=2 keys (4 + 2 limbs): the all-gathered digit groups are base
    converted into each rank's own limbs (K4's path), on a (2, 4) mesh."""
    params, jctx, _, _, rlk, rk = _jax_setup(alpha=2, num_special=2)
    key = rlk if kind == "mult" else rk
    ids = tuple(range(LEVELS))
    scale = params.initial_scaling_factor
    args = _inputs(jctx, ids, 4, 43)
    want = _jax_sharded(_jax_step(jctx, ids, scale, key, kind), args, (2, 4))
    res = world.run(tasks.sharded_step, kind, N, LEVELS, 2, np.asarray(key.data), key.limb_ids,
                    2, args, scale, (2, 4))
    for g, w in zip(_assemble(res), want):
        np.testing.assert_array_equal(g, w)


def test_limb_sharded_ntt_roundtrip(world):
    from hehub_tpu.ops import ntt as jntt

    _, jctx, _, _, _, _ = _jax_setup()
    ids = tuple(range(LEVELS))
    rng = np.random.default_rng(7)
    qs = np.asarray(jctx.moduli_of(ids), np.uint32)[:, None]
    x = rng.integers(0, 1 << 31, (8, LEVELS, N)).astype(np.uint32) % (2 * qs)
    want = _jax_sharded(lambda v: (jntt.intt(jctx, jntt.ntt(jctx, v, ids), ids),), [x],
                        (2, 4))[0]
    got = _assemble(world.run(tasks.limb_ntt_roundtrip, N, LEVELS, x, (2, 4)), k=1)[0]
    np.testing.assert_array_equal(got, want)


def test_sharded_encrypt_mult_decode(world):
    """A ciphertext encrypted under the shared secret key, its square on a
    (1, 4) mesh (limbs only, as the reference's round trip), bitwise equal
    to hehub_tpu's step there, decoding to vals^2."""
    from jax.sharding import PartitionSpec as P

    from hehub_tpu.parallel import mesh as jmesh

    params, jctx, jsk, tsk, rlk, _ = _jax_setup()
    ctx = tctx.make_context(tctx.create_ckks_params(N, 28, LEVELS, use_security_budget=False))
    vals = np.random.default_rng(3).uniform(-1, 1, N // 2)
    ct = tckks.encrypt(ctx, tckks.encode(vals, ctx.params, device="cpu"), tsk,
                       torch.Generator().manual_seed(5))
    c0, c1 = as_numpy(ct.c0.data)[None], as_numpy(ct.c1.data)[None]
    ids = tuple(range(LEVELS))
    want = _jax_sharded(_jax_step(jctx, ids, ct.scaling_factor, rlk, "mult"), [c0, c1, c0, c1],
                        (1, 4), P(None, jmesh.LIMB_AXIS, None))
    sk = (jsk.coeffs, jsk.ntt, jsk.ntt_sh)
    res = world.run(tasks.sharded_decode, N, LEVELS, sk, np.asarray(rlk.data), rlk.limb_ids,
                    c0, c1, ct.scaling_factor, (1, 4))
    for g, w in zip(_assemble(res), want):
        np.testing.assert_array_equal(g, w)
    slots = next(r[5] for r in res if r is not None and r[5] is not None)
    np.testing.assert_allclose(np.real(slots[0]), vals * vals, atol=2e-4)


# ---------------------------------------------------------------------------
# The intra-transform sharded NTT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("D", [2, 4, 8])
def test_sharded_ntt_matches_jax(world, D):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hehub_tpu.core.context import RlweParams, make_context
    from hehub_tpu.parallel import ntt_sharded as jsharded

    n = 2048
    primes = hm.gen_ntt_primes(30, 2, n)
    jctx = make_context(RlweParams(dimension=n, moduli=tuple(primes)))
    ids = (0, 1)
    qs = np.asarray(jctx.moduli_of(ids), np.uint32)[:, None]
    x = np.random.default_rng(D).integers(0, 1 << 31, (2, 2, n)).astype(np.uint32) % (2 * qs)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:D]), ("seq",))
    shard = NamedSharding(mesh, P(None, None, "seq"))
    fwd = jax.jit(jsharded.make_sharded_ntt(jctx, ids, mesh, "seq"))
    inv = jax.jit(jsharded.make_sharded_ntt(jctx, ids, mesh, "seq", inverse=True))
    want_f = np.asarray(fwd(jax.device_put(x, shard)))
    want_i = np.asarray(inv(jax.device_put(want_f, shard)))
    res = sorted(r for r in world.run(tasks.sharded_ntt, n, primes, D, x) if r is not None)
    assert [r[0] for r in res] == list(range(D))
    np.testing.assert_array_equal(np.concatenate([r[1] for r in res], axis=-1), want_f)
    np.testing.assert_array_equal(np.concatenate([r[2] for r in res], axis=-1), want_i)


def test_sharded_ntt_plan_refusals():
    """_plan raises where the reference's does (the JAX twin alongside)."""
    from hehub_tpu.parallel import ntt_sharded as jsharded

    for n, D in ((2048, 3), (2048, 32), (64, 2), (256, 4)):
        with pytest.raises(ValueError):
            jsharded._plan(n, D)
        with pytest.raises(ValueError):
            ntt_sharded._plan(n, D)
    for n, D in ((2048, 16), (256, 2)):
        jsharded._plan(n, D)
        ntt_sharded._plan(n, D)


# ---------------------------------------------------------------------------
# Pipelines
# ---------------------------------------------------------------------------


def _pipeline_inputs(count, seed):
    """Port ciphertexts (the shared secret key, seeded noise) and the same
    as hehub_tpu ciphertexts."""
    from hehub_tpu.core import rns as jrns
    from hehub_tpu.models import ckks as jckks

    params, _, _, tsk, _, _ = _jax_setup()
    ctx = tctx.make_context(tctx.create_ckks_params(N, 28, LEVELS, use_security_budget=False))
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    cts = [tckks.encrypt(ctx, tckks.encode(rng.uniform(-1, 1, N // 2) * 0.9, ctx.params,
                                           device="cpu"), tsk, gen) for _ in range(count)]
    jcts = [jckks.CkksCt(jrns.RnsPoly(as_numpy(c.c0.data), jrns.NTT, c.c0.limb_ids),
                         jrns.RnsPoly(as_numpy(c.c1.data), jrns.NTT, c.c1.limb_ids),
                         c.scaling_factor) for c in cts]
    return ctx, cts, jcts


def _same(outs, jouts):
    for got, want in zip(outs, jouts):
        np.testing.assert_array_equal(as_numpy(got.c0.data), np.asarray(want.c0.data))
        np.testing.assert_array_equal(as_numpy(got.c1.data), np.asarray(want.c1.data))
        assert got.c0.limb_ids == want.c0.limb_ids
        assert abs(got.scaling_factor - want.scaling_factor) < 1e-3


def test_pipeline_squaring_chain_matches_jax():
    """Depth 3 over 3 stages, 5 microbatches: bitwise hehub_tpu's
    PipelinedSquaringChain on jax.devices()[:3], and the port's own
    sequential chain."""
    import jax

    from hehub_tpu.parallel.pipeline import PipelinedSquaringChain as JChain

    _, jctx, _, _, rlk, _ = _jax_setup()
    ctx, cts, jcts = _pipeline_inputs(5, 9)
    key = convert.rgsw_from_numpy(np.asarray(rlk.data), rlk.limb_ids, device="cpu")
    outs = tpipe.PipelinedSquaringChain(ctx, key, 3, LEVELS, devices=["cpu"] * 3).run(cts)
    _same(outs, JChain(jctx, rlk, 3, LEVELS, devices=jax.devices()[:3]).run(jcts))
    for ct, out in zip(cts, outs):
        seq = ct
        for _ in range(3):
            seq = tckks.rescale(ctx, tckks.mult(ctx, seq, seq, key))
        assert torch.equal(out.c0.data, seq.c0.data) and torch.equal(out.c1.data, seq.c1.data)


def test_pipeline_heterogeneous_matches_jax():
    """square -> rotate(3) -> halve (mult_plain + rescale) over 3 stages, 4
    microbatches, bitwise hehub_tpu's Pipeline on jax.devices()[:3]."""
    import jax

    from hehub_tpu.models import ckks as jckks
    from hehub_tpu.parallel.pipeline import Pipeline as JPipeline

    _, jctx, _, _, rlk, rk = _jax_setup()
    ctx, cts, jcts = _pipeline_inputs(4, 10)
    key = convert.rgsw_from_numpy(np.asarray(rlk.data), rlk.limb_ids, device="cpu")
    rkey = convert.rgsw_from_numpy(np.asarray(rk.data), rk.limb_ids, device="cpu")
    half = np.full(N // 2, 0.5)

    def stages(m, k, r):
        return [lambda c, ct: m.rescale(c, m.mult(c, ct, ct, k)),
                lambda c, ct: m.rotate(c, ct, r, 3),
                lambda c, ct: m.rescale(c, m.mult_plain(c, ct, m.encode(
                    half, c.params, level=len(c.params.moduli) - ct.c0.limb_count,
                    **({"device": ct.c0.data.device} if m is tckks else {}))))]

    outs = tpipe.Pipeline(ctx, stages(tckks, key, rkey), devices=["cpu"] * 3).run(cts)
    rlk_h = type(rlk)(np.asarray(rlk.data), rlk.limb_ids, rlk.alpha)
    rk_h = type(rk)(np.asarray(rk.data), rk.limb_ids, rk.alpha)
    _same(outs, JPipeline(jctx, stages(jckks, rlk_h, rk_h), devices=jax.devices()[:3]).run(jcts))


def test_pipeline_refuses_too_few_devices():
    ctx = tctx.make_context(tctx.create_ckks_params(N, 28, LEVELS, use_security_budget=False))
    with pytest.raises(ValueError):
        tpipe.Pipeline(ctx, [lambda c, ct: ct] * 3, devices=["cpu"] * 2)


# ---------------------------------------------------------------------------
# The dryrun twin
# ---------------------------------------------------------------------------


def test_dryrun_multichip(world):
    reports = entry.dryrun_multichip(8, world=world)
    assert reports[0]["mult"]["mesh"] == dict(zip(("batch", "limb"), entry.mesh_shape(8)))
    assert reports[0]["mult"]["out_shape"] == (8, LEVELS - 1, N)
    assert all(r["ntt"] == dict(D=8, n=2048) for r in reports)
    assert all(r["device"] == "cpu" for r in reports)


def test_entry_step_on_cpu():
    fn, args = entry.entry(device="cpu")
    c0, c1 = fn(*args)
    assert c0.shape == (2, 2, 1024) and c1.shape == (2, 2, 1024)


# ---------------------------------------------------------------------------
# The stage between parts of a row, and rings above kernels.MAX_ROW_N
# ---------------------------------------------------------------------------


def _rows_case(n, seed, batch=2, device="cpu"):
    ctx = tctx.make_context(tctx.RlweParams(dimension=n, moduli=hm.gen_ntt_primes(30, 2, n)))
    ids = (0, 1)
    x = lazy_residues(np.random.default_rng(seed), (batch,), ctx.moduli_of(ids), n)
    rows = lambda nm, dev, dt: ctx.device_rows(nm, ids, dev, dt)  # noqa: E731
    return ctx, ids, torch.from_numpy(x.astype(np.int64)).to(device), rows


@pytest.mark.parametrize("kind", ["forward", "inverse", "inverse_last"])
def test_stage_plain_is_the_chains_stage(kind):
    """ntt_stage_plain on the halves of a row is the chain's first forward
    stage, an inverse stage pairing halves, or the inverse chain's last
    (folding n^-1)."""
    n = 1024
    ctx, ids, x, rows = _rows_case(n, 5)
    r = lambda nm: rows(nm, "cpu", torch.int64)  # noqa: E731
    lo, hi = x[..., None, : n // 2], x[..., None, n // 2:]
    if kind == "forward":
        want = tn._fwd_stages(x, r("tw_fwd"), r("tw_fwd_sh"), r("q"), r("two_q"), range(1))
        got = tn.ntt_stage_plain(lo, hi, r("tw_fwd")[:, 1:2], r("tw_fwd_sh")[:, 1:2], r("q"),
                                 r("two_q"))
    else:
        last = [r(nm) for nm in tn.INV_TABLES[4:]] if kind == "inverse_last" else None
        want = tn._inv_stages(x, r("tw_inv"), r("tw_inv_sh"), r("q"), r("two_q"), last,
                              range(9, 10))
        w = (last[:2] if last else (r("tw_inv")[:, 1:2], r("tw_inv_sh")[:, 1:2]))
        got = tn.ntt_stage_plain(lo, hi, *w, r("q"), r("two_q"), True,
                                 *(last[2:] if last else ()))
    assert torch.equal(got.reshape(x.shape), want)
    kept = tn.ntt_stage(lo, hi, *(w if kind != "forward" else (r("tw_fwd")[:, 1:2],
                                                                r("tw_fwd_sh")[:, 1:2])),
                        r("q"), r("two_q"), kind != "forward",
                        *(last[2:] if kind == "inverse_last" else ()), keep=1)
    assert torch.equal(kept[..., 0, :], want[..., n // 2:])


@pytest.mark.parametrize("inverse", [False, True])
def test_staged_schedule_is_bitwise_full_chain(inverse):
    """n = 262144 as the card runs it (one stage between the halves in
    place, parts of 131072 under their regrouped rows: ntt_fwd_staged /
    ntt_inv_staged, with and without the fold) equals the full chains."""
    ctx, ids, x, rows = _rows_case(LARGE_N, 7 + inverse, batch=1)
    if inverse:
        assert torch.equal(tn.ntt_inv_staged(x, rows), tn.intt(ctx, x, ids))
        assert torch.equal(tn.ntt_inv_staged(x, rows, fold=False),
                           tn.transform(x, rows, inverse=True, fold=False))
    else:
        assert torch.equal(tn.ntt_fwd_staged(x, rows), tn.ntt(ctx, x, ids))


def test_large_ring_ntt_against_jax():
    """ntt and intt at n=262144 on 2 limbs, bitwise hehub_tpu.ops.ntt (its
    XLA chain, jitted)."""
    import jax

    from hehub_tpu.core.context import RlweParams, make_context
    from hehub_tpu.ops import ntt as jntt

    ctx, ids, x, rows = _rows_case(LARGE_N, 9, batch=1)
    jctx = make_context(RlweParams(dimension=LARGE_N, moduli=ctx.params.moduli))
    want_f = np.asarray(jax.jit(lambda v: jntt.ntt(jctx, v, ids))(as_numpy(x)))
    got_f = tn.ntt(ctx, x, ids)
    np.testing.assert_array_equal(as_numpy(got_f), want_f)
    np.testing.assert_array_equal(as_numpy(tn.ntt_fwd_staged(x, rows)), want_f)
    want_i = np.asarray(jax.jit(lambda v: jntt.intt(jctx, v, ids))(want_f))
    np.testing.assert_array_equal(as_numpy(tn.intt(ctx, got_f, ids)), want_i)
    np.testing.assert_array_equal(as_numpy(tn.ntt_inv_staged(got_f, rows)), want_i)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,inverse,fold,keep", [
    ((64, 7, 1, 8192), False, False, 0), ((64, 7, 1, 8192), True, False, 1),
    ((64, 7, 1, 4096), True, True, 0), ((2, 4, 2, 65536), False, False, None),
    ((2, 4, 1, 131072), True, True, None), ((3, 1, 4, 4), True, False, None),
])
def test_stage_kernel_bitwise_plain(cuda_device, shape, inverse, fold, keep):
    """The stage kernel against ntt_stage_plain: lo and hi the halves of
    each block of rows in place (keep None) or two tensors (keep 0 / 1),
    forward, inverse, inverse folding n^-1."""
    lead, L, B, m = shape[:-3], shape[-3], shape[-2], shape[-1]
    n = 2 * B * m
    ctx, _, _, _ = _rows_case(max(n, 8), 1)
    ids = (0,) * L if L > 2 else tuple(range(L))
    g = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    two_q = ctx.device_rows("two_q", ids, cuda_device)
    x = torch.randint(0, 1 << 62, (*lead, L, B, 2, m), generator=g, device=cuda_device)
    x = x % two_q[..., None, None]
    name = "tw_inv" if inverse else "tw_fwd"
    tabs = {dt: [ctx.device_rows(nm, ids, cuda_device, dt)
                 for nm in (name, name + "_sh", "q", "two_q", "n_inv", "n_inv_sh")]
            for dt in (torch.int32, torch.int64)}
    args = {dt: (t[0][:, B:2 * B], t[1][:, B:2 * B], t[2], t[3], inverse,
                 *(t[4:] if fold else ())) for dt, t in tabs.items()}
    lo, hi = x[..., 0, :], x[..., 1, :]
    want = tn.ntt_stage_plain(lo, hi, *args[torch.int64])
    if keep is None:
        got = tn.ntt_stage(lo, hi, *args[torch.int32])
        assert torch.equal(got, want)
    else:
        got = tn.ntt_stage(lo.contiguous(), hi.contiguous(), *args[torch.int32], keep=keep)
        assert torch.equal(got, want[..., keep, :])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 4096, 65536, 131072])
def test_k2_unfolded_bitwise_plain(cuda_device, n):
    """K2 without the fold (kernels.ntt_inv with no last-stage constants) is
    the plain inverse chain whose last stage is ordinary."""
    ctx, ids, x, rows = _rows_case(n, n, device=cuda_device)
    want = tn.transform(x.cpu(), rows, inverse=True, fold=False)
    assert torch.equal(tn.transform(x, rows, inverse=True, fold=False).cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_262144_bitwise_plain(cuda_device, inverse):
    """ntt / intt at n=262144 on the card (the stage kernel in place, K1 / K2
    on parts of 131072) against the plain full chains, and the launches."""
    ctx, ids, x, rows = _rows_case(LARGE_N, 3 + inverse, device=cuda_device)
    kernels.reset_launch_counts()
    fn = tn.intt if inverse else tn.ntt
    got = fn(ctx, x, ids)
    assert kernels.LAUNCHES["ntt_stage"] == 1
    assert kernels.LAUNCHES["ntt_inv" if inverse else "ntt_fwd"] == 1
    assert torch.equal(got.cpu(), fn(ctx, x.cpu(), ids))


@pytest.mark.cuda
def test_ext_prod_on_a_destination_limb_slice_of_the_key(cuda_device):
    """K3 reads a key slice over some destination limbs through its
    strides: those limbs of the full product, bitwise (the limb mesh's key
    shards)."""
    ctx = tctx.make_context(tctx.create_ckks_params(4096, 28, 5, use_security_budget=False))
    ids = tuple(range(5))
    ext = ids + ctx.special_indices
    rng = np.random.default_rng(4)
    d = np.stack([rng.integers(0, q, (3, 4096)) for q in ctx.moduli_of(ids)], axis=1)
    key = lazy_residues(rng, (5, 2), ctx.moduli_of(ext), 4096)
    poly = RnsPoly(torch.from_numpy(d).to(cuda_device), "coeff", ids)
    full = convert.rgsw_from_numpy(key, ext, device=cuda_device)
    whole = trgsw.ext_prod_strict(ctx, poly, full)
    dst = (2, 3, 5)
    part = trgsw.RgswCt(full.data[:, :, 2:], ext[2:], 1)  # a strided slice of the key
    part = trgsw.RgswCt(torch.cat([part.data[:, :, :2], part.data[:, :, 3:]], dim=2), dst, 1)
    got = trgsw.ext_prod_strict(ctx, poly, part)
    for a, b in ((got.c0, whole.c0), (got.c1, whole.c1)):
        assert torch.equal(a.data, b.data[..., [2, 3, 5], :])
    view = tn.to_u32_bits(full.data)[:, :, 2:4]  # a strided view of the key, not a copy
    assert not view.is_contiguous()
    tabs = [ctx.device_rows(nm, (2, 3), cuda_device, torch.int32) for nm in tn.EXT_TABLES]
    out = kernels.ext_prod(tn.to_u32_bits(poly.data), view, *tabs)
    assert torch.equal(tn.from_u32_bits(out[0]), whole.c0.data[..., 2:4, :])
