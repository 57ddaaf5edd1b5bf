"""Entry points of the port, the twins of __graft_entry__.py.

entry()             -> (fn, example_args): the batched CKKS mult + relin +
                       rescale step at n=1024, 3 levels, batch 2, on the
                       card (or the device given).
dryrun_multichip(n) -> runs n ranks (launcher of parallel/mesh.py): one
                       (batch, limb)-sharded mult step at n=256 on the
                       reference's mesh shape, then the sharded NTT at
                       n=2048 over the largest power of two of ranks <= n,
                       forward and inverse, each asserted bitwise against
                       the unsharded port. The ranks take the cards in turn:
                       NCCL where each has a card of its own, gloo where they
                       share one; the CPU (gloo) only with device="cpu".

    python -c "from hehub_tpu_torch import entry; entry.dryrun_multichip(8)"
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.core.context import RlweParams, create_ckks_params, make_context
from hehub_tpu_torch.core.rns import NTT, RnsPoly
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.parallel import mesh as pmesh
from hehub_tpu_torch.parallel import ntt_sharded
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from hehub_tpu_torch.utils import hostmath as hm


def _setup(n: int, levels: int, device, seed: int = 0):
    """(params, ctx, sk, rlk) with keys from a seeded generator on `device`."""
    params = create_ckks_params(n, scaling_bits=28, num_levels=levels, use_security_budget=False)
    ctx = make_context(params)
    gen = torch.Generator(device=device).manual_seed(seed)
    sk = rlwe_mod.keygen(ctx, gen)
    return params, ctx, sk, keys_mod.relin_key(ctx, sk, gen)


def mult_step(ctx, params, rlk, ids, scale):
    """(c0a, c1a, c0b, c1b) -> rescale(mult(a, b)) halves, NTT form."""
    def step(c0a, c1a, c0b, c1b):
        mk = lambda d: RnsPoly(d, NTT, ids)  # noqa: E731
        out = ckks.rescale(ctx, ckks.mult(ctx, ckks.CkksCt(mk(c0a), mk(c1a), scale),
                                          ckks.CkksCt(mk(c0b), mk(c1b), scale), rlk))
        return out.c0.data, out.c1.data
    return step


def random_residues(rng, ctx, ids, shape) -> np.ndarray:
    """The reference's random lazy inputs: uint32 draws below 2^31, mod 2q."""
    qs = np.asarray(ctx.moduli_of(ids), np.int64)[:, None]
    return rng.integers(0, 1 << 31, (*shape, len(ids), ctx.params.dimension)) % (2 * qs)


def entry(device="cuda"):
    """Forward step: batched CKKS multiply + relinearize + rescale."""
    params, ctx, sk, rlk = _setup(1024, 3, device)
    ids = tuple(range(len(params.moduli)))
    rng = np.random.default_rng(7)
    args = tuple(torch.from_numpy(random_residues(rng, ctx, ids, (2,))).to(device)
                 for _ in range(4))
    return mult_step(ctx, params, rlk, ids, params.initial_scaling_factor), args


def mesh_shape(n_devices: int):
    """The reference's dryrun mesh: limb 2 where n is even and >= 4."""
    limb = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    return max(n_devices // limb, 1), limb


def _dryrun_rank(n_devices: int) -> dict:
    """One rank's part of dryrun_multichip: its checks, device and kernel
    launches."""
    dev = pmesh.rank_device()
    before = dict(kernels.LAUNCHES)
    batch_ways, limb = mesh_shape(n_devices)
    mesh = pmesh.make_mesh(batch_ways, limb)
    params, ctx, sk, rlk = _setup(256, 4, dev)
    ids = tuple(range(len(params.moduli)))
    scale = params.initial_scaling_factor
    batch = 2 * batch_ways
    rng = np.random.default_rng(11)
    args = [torch.from_numpy(random_residues(rng, ctx, ids, (batch,))).to(dev)
            for _ in range(4)]
    report = {}
    if pmesh.in_mesh(mesh):
        cts = [pmesh.shard_ct(mesh, ckks.CkksCt(RnsPoly(a, NTT, ids), RnsPoly(b, NTT, ids), scale))
               for a, b in (args[:2], args[2:])]
        key = pmesh.shard_key(mesh, rlk, cts[0].parts, ctx.num_special)
        out = pmesh.rescale(ctx, mesh, pmesh.mult(ctx, mesh, *cts, key))
        want = mult_step(ctx, params, rlk, ids, scale)(*args)
        for got, full in zip((out.ct.c0.data, out.ct.c1.data), want):
            mine = pmesh.shard_poly_data(mesh, full, 1, False)[..., list(out.ct.c0.limb_ids), :]
            assert torch.equal(got, mine), "sharded mult step != unsharded step"
        report["mult"] = dict(mesh=dict(batch=batch_ways, limb=limb),
                              out_shape=(batch, len(ids) - 1, params.dimension),
                              shard_shape=tuple(out.ct.c0.data.shape))

    D = 1 << (n_devices.bit_length() - 1)
    if D >= 2:
        n_poly = 2048
        nctx = make_context(RlweParams(dimension=n_poly, moduli=hm.gen_ntt_primes(30, 2, n_poly)))
        nids = (0, 1)
        x = torch.from_numpy(random_residues(rng, nctx, nids, (2,))).to(dev)
        smesh = pmesh.make_axis_mesh(D, "seq")
        if pmesh.in_mesh(smesh):
            fwd = ntt_sharded.make_sharded_ntt(nctx, nids, smesh, "seq")
            inv = ntt_sharded.make_sharded_ntt(nctx, nids, smesh, "seq", inverse=True)
            want_f = nttmod.ntt(nctx, x, nids)
            got_f = fwd(ntt_sharded.shard_rows(x, smesh, "seq"))
            assert torch.equal(got_f, ntt_sharded.shard_rows(want_f, smesh, "seq")), \
                "sharded NTT != local NTT"
            got_i = inv(got_f)
            want_i = nttmod.intt(nctx, want_f, nids)
            assert torch.equal(got_i, ntt_sharded.shard_rows(want_i, smesh, "seq")), \
                "sharded INTT != local INTT"
            report["ntt"] = dict(D=D, n=n_poly)
    report["device"] = str(dev)
    report["launches"] = {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES}
    return report


def dryrun_multichip(n_devices: int, device="cuda", world: Optional[pmesh.World] = None) -> list:
    """One sharded step over n_devices ranks: batch-parallel ciphertexts
    (the dp analog) x limb-parallel RNS residues (the tp analog), then the
    intra-transform sharded NTT; each rank asserts its shard bitwise
    against the unsharded port. Runs in `world` (its first n_devices
    ranks, on their devices) or in a World started for it on
    mesh.rank_devices(n_devices, device): the cards in turn, NCCL where
    each rank has a card of its own and gloo where ranks share one, the
    CPU (gloo) only where `device` is the CPU. Returns each rank's report
    (with its device and kernel launches)."""
    if world is None:
        devices = pmesh.rank_devices(n_devices, device)
        with pmesh.World(n_devices, devices=devices) as w:
            reports = w.run(_dryrun_rank, n_devices)
    else:
        if world.size < n_devices:
            raise ValueError(f"a world of {world.size} ranks cannot run {n_devices}")
        reports = world.run(_dryrun_rank, n_devices)
    mult = reports[0]["mult"]
    print(f"dryrun_multichip ok: mesh={mult['mesh']}, out_shape={mult['out_shape']}, "
          f"ranks on {sorted({r['device'] for r in reports})}")
    if "ntt" in reports[0]:
        ntt = reports[0]["ntt"]
        print(f"dryrun_multichip sharded NTT ok: D={ntt['D']}, n={ntt['n']}, fwd+inv "
              f"bitwise-equal to the single-rank transform")
    return reports
