"""The rank tasks of tests/test_torch_parallel.py: functions that every
rank of a hehub_tpu_torch.parallel.mesh.World runs (importable by name, no
JAX). Each takes numpy inputs and returns numpy outputs with the rank's
mesh coordinates, for the test to assemble."""

import numpy as np
import torch
import torch.distributed as dist

from hehub_tpu_torch import convert
from hehub_tpu_torch.core import context as tctx
from hehub_tpu_torch.core.rns import NTT, RnsPoly
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.ops import ntt as tn
from hehub_tpu_torch.parallel import mesh as pmesh
from hehub_tpu_torch.parallel import ntt_sharded


def _ctx(n, levels, num_special=1):
    return tctx.make_context(tctx.create_ckks_params(
        n, 28, levels, use_security_budget=False, num_special=num_special))


def _tensor(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(pmesh.rank_device())


def _host(t):
    return t.cpu().numpy().astype(np.uint32)


def _coords(mesh):
    return pmesh.axis_index(mesh, pmesh.BATCH_AXIS), pmesh.axis_index(mesh, pmesh.LIMB_AXIS)


def mesh_helpers():
    """make_mesh's shape and refusal, and the shard shapes of a [8, 7, 16]
    tensor on a (4, 2) mesh (limbs split 4 + 3, batch 2 a rank)."""
    mesh = pmesh.make_mesh(4, 2)
    try:
        pmesh.make_mesh(8, 2)
        refused = False
    except ValueError:
        refused = True
    x = torch.arange(8 * 7 * 16).reshape(8, 7, 16)
    shard = pmesh.shard_poly_data(mesh, x, 1, True)
    pmesh.constrain(shard, mesh, x.shape, 1, True)
    try:
        pmesh.constrain(x, mesh, x.shape, 1, True)
        constrained = False
    except ValueError:
        constrained = True
    b, l = _coords(mesh)
    want = x[2 * b:2 * b + 2, (0, 4)[l]:(4, 7)[l]]
    return dict(shape=tuple(mesh.mesh.shape), names=mesh.mesh_dim_names, refused=refused,
                constrained=constrained, shard_ok=bool(torch.equal(shard, want)),
                rank=dist.get_rank(), coords=(b, l))


def sharded_step(kind, n, levels, num_special, key, key_ids, alpha, args, scale, mesh_shape):
    """rescale(mult(a, b)) (kind "mult") or rotate(a, 3) (kind "rotate")
    on the (batch, limb) mesh `mesh_shape`, from whole inputs a = args[:2],
    b = args[2:] ([batch, L, n] uint32) and the key [rows, 2, L_ext, n].
    Returns (batch coord, limb coord, c0, c1, limb ids, scale, the
    collectives it ran) of this rank, None outside the mesh."""
    mesh = pmesh.make_mesh(*mesh_shape)
    if not pmesh.in_mesh(mesh):
        return None
    ctx = _ctx(n, levels, num_special)
    ids = tuple(range(levels))
    mk = lambda c0, c1: ckks.CkksCt(RnsPoly(_tensor(c0), NTT, ids),  # noqa: E731
                                    RnsPoly(_tensor(c1), NTT, ids), scale)
    a = pmesh.shard_ct(mesh, mk(*args[:2]))
    rgsw = convert.rgsw_from_numpy(key, key_ids, alpha, device=pmesh.rank_device())
    k = pmesh.shard_key(mesh, rgsw, a.parts, ctx.num_special)
    pmesh.reset_comm_stats()
    if kind == "mult":
        out = pmesh.rescale(ctx, mesh, pmesh.mult(ctx, mesh, a, pmesh.shard_ct(mesh, mk(*args[2:])),
                                                  k))
    else:
        out = pmesh.rotate(ctx, mesh, a, k, 3)
    return (*_coords(mesh), _host(out.ct.c0.data), _host(out.ct.c1.data), out.ct.c0.limb_ids,
            out.ct.scaling_factor, tuple(sorted(pmesh.COMM)))


def limb_ntt_roundtrip(n, levels, x, mesh_shape):
    """intt(ntt(x)) of this rank's shard of x [batch, L, n] on the mesh:
    limb-local, no collective. Returns (batch coord, limb coord, out)."""
    mesh = pmesh.make_mesh(*mesh_shape)
    ctx = _ctx(n, levels)
    mine = pmesh.shard_poly_data(mesh, _tensor(x), 1, True)
    ids = pmesh.limb_parts(tuple(range(levels)), pmesh.axis_size(mesh, pmesh.LIMB_AXIS))[
        pmesh.axis_index(mesh, pmesh.LIMB_AXIS)]
    return (*_coords(mesh), _host(tn.intt(ctx, tn.ntt(ctx, mine, ids), ids)))


def sharded_ntt(n, moduli, D, x):
    """make_sharded_ntt over the first D ranks (axis "seq"): this rank's
    slice of the forward transform of x [..., 2, n] and of the inverse of
    that. Returns (d, fwd slice, inv slice), None outside the mesh."""
    ctx = tctx.make_context(tctx.RlweParams(dimension=n, moduli=tuple(moduli)))
    mesh = pmesh.make_axis_mesh(D, "seq")
    if not pmesh.in_mesh(mesh):
        return None
    ids = (0, 1)
    fwd = ntt_sharded.make_sharded_ntt(ctx, ids, mesh, "seq")
    inv = ntt_sharded.make_sharded_ntt(ctx, ids, mesh, "seq", inverse=True)
    got_f = fwd(ntt_sharded.shard_rows(_tensor(x), mesh, "seq"))
    return pmesh.axis_index(mesh, "seq"), _host(got_f), _host(inv(got_f))


def sharded_decode(n, levels, sk, key, key_ids, c0, c1, scale, mesh_shape):
    """rescale(mult(ct, ct)) of a [1, L, n] ciphertext on the mesh, gathered
    over "limb" and decrypted and decoded under `sk` (coeffs, ntt, ntt_sh)
    on limb rank 0. Returns (this rank's c0 and c1 shards, coords, the
    decoded slots or None)."""
    mesh = pmesh.make_mesh(*mesh_shape)
    if not pmesh.in_mesh(mesh):
        return None
    params = tctx.create_ckks_params(n, 28, levels, use_security_budget=False)
    ctx = tctx.make_context(params)
    ids = tuple(range(levels))
    ct = pmesh.shard_ct(mesh, ckks.CkksCt(RnsPoly(_tensor(c0), NTT, ids),
                                          RnsPoly(_tensor(c1), NTT, ids), scale))
    k = pmesh.shard_key(mesh, convert.rgsw_from_numpy(key, key_ids, device=pmesh.rank_device()),
                        ct.parts, ctx.num_special)
    out = pmesh.rescale(ctx, mesh, pmesh.mult(ctx, mesh, ct, ct, k))
    whole = pmesh.gather_limbs(mesh, out)
    slots = None
    if pmesh.axis_index(mesh, pmesh.LIMB_AXIS) == 0:
        tsk = convert.sk_from_numpy(*sk, device=pmesh.rank_device())
        slots = ckks.decode(ckks.decrypt(ctx, whole, tsk), params)
    return (*_coords(mesh), _host(out.ct.c0.data), _host(out.ct.c1.data), out.ct.c0.limb_ids,
            slots)



def collectives_unchanged():
    """all_gather and broadcast over the world of a tensor on this rank's
    device: whether each returns every rank's tensor unchanged."""
    base = torch.arange(4096, dtype=torch.int32, device=pmesh.rank_device())
    x = base * (dist.get_rank() + 1)
    gathered = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, x)
    sent = x.clone()
    dist.broadcast(sent, src=0)
    return (all(torch.equal(g, base * (r + 1)) for r, g in enumerate(gathered))
            and torch.equal(sent, base))
