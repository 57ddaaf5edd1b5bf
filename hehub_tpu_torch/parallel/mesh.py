"""The (batch, limb) device mesh over torch.distributed, with its
collectives written out (port of hehub_tpu/parallel/mesh.py).

Two mesh axes, as the reference's:
  * "batch": independent ciphertexts split over the leading batch axis
    (the FHE analog of data parallelism: no collective);
  * "limb": RNS limbs split over the [-2] axis as torch.tensor_split splits
    them (7 limbs over 2 ranks: 4 + 3), the analog of tensor parallelism.

The reference leaves the collectives to GSPMD. Here each is explicit, and
outside the kernels:
  * mult_low_level, the NTTs, the Galois gather and the divisions are
    limb-local;
  * the key switch (relinearize, rotate) takes this rank's limbs of the
    polynomial to strict coefficient form (K2), all-gathers them over
    "limb" (the digit all-gather the reference's mesh.py:9-11 describes),
    and computes the external product (K3; K4 after base_convert at
    alpha > 1) for its own destination limbs and the special primes only,
    from a key sharded the same way (shard_key): the special limbs are
    computed on every rank of the limb group, since sending them would
    cost one more collective after the product for a fraction of its work
    (one of l + 1 destination limbs at alpha = 1); the special primes are
    then divided out limb-locally;
  * rescale broadcasts the last limb from the rank that owns it.
Results are bitwise equal to the unsharded port, and so to hehub_tpu.

The limb partition of a ciphertext stays where it was made: rescale drops
the last limb from its owner (ShardedCt.parts). The transport is chosen by
the backend's name: NCCL moves device tensors; gloo (the CPU, or ranks
that share one card) moves pinned host buffers. Residues cross as their
uint32 bits (4 bytes each). A limb group of one rank (a batch-only mesh)
runs no collective. `COMM` counts each collective's calls, bytes and host
seconds.

The launcher (`World`) starts ranks by spawn, meets them through a
FileStore under a given directory, and bounds the process group, every
task and every join by a timeout. `rank_devices` and `backend_for` give
its ranks the cards in turn and the backend those devices call for.
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from hehub_tpu_torch.core import basecnv, galois, rns
from hehub_tpu_torch.core.rns import COEFF, NTT, RnsPoly
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod

BATCH_AXIS = "batch"
LIMB_AXIS = "limb"

# each collective's [calls, bytes sent and received by this rank, host s]
COMM: Dict[str, List[float]] = {}


def reset_comm_stats() -> None:
    COMM.clear()


def _record(op: str, nbytes: int, t0: float) -> None:
    rec = COMM.setdefault(op, [0, 0, 0.0])
    rec[0] += 1
    rec[1] += nbytes
    rec[2] += time.perf_counter() - t0


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------


def make_mesh(batch: int = 1, limb: int = 1) -> DeviceMesh:
    """A (batch, limb) DeviceMesh of the first batch x limb ranks of the
    process group. Every rank of the group calls it (the mesh's groups are
    made collectively); ranks beyond the mesh get no coordinate. The
    mesh's device type names where its collectives' tensors lie: "cuda"
    under NCCL, "cpu" under gloo."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (see World)")
    world = dist.get_world_size()
    if batch < 1 or limb < 1 or batch * limb > world:
        raise ValueError(f"mesh {batch}x{limb} exceeds {world} ranks")
    return DeviceMesh(_mesh_device_type(), torch.arange(batch * limb).reshape(batch, limb),
                      mesh_dim_names=(BATCH_AXIS, LIMB_AXIS))


def make_axis_mesh(size: int, axis: str) -> DeviceMesh:
    """A one-axis DeviceMesh named `axis` of the first `size` ranks (the
    reference's Mesh(devices[:size], (axis,)))."""
    if not dist.is_initialized():
        raise RuntimeError("make_axis_mesh needs an initialized process group (see World)")
    if not 1 <= size <= dist.get_world_size():
        raise ValueError(f"mesh of {size} exceeds {dist.get_world_size()} ranks")
    return DeviceMesh(_mesh_device_type(), torch.arange(size), mesh_dim_names=(axis,))


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _dim(mesh: DeviceMesh, axis: str) -> int:
    return mesh.mesh_dim_names.index(axis)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return int(mesh.mesh.shape[_dim(mesh, axis)])


def in_mesh(mesh: DeviceMesh) -> bool:
    return mesh.get_coordinate() is not None


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate on `axis`."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    return int(coord[_dim(mesh, axis)])


def axis_peer(mesh: DeviceMesh, axis: str, index: int) -> int:
    """The global rank at this rank's coordinate with `axis` set to index."""
    coord = list(mesh.get_coordinate())
    coord[_dim(mesh, axis)] = index
    return int(mesh.mesh[tuple(coord)])


def ct_pspec(batch_dims: int = 1, shard_limbs: bool = False) -> Tuple[Optional[str], ...]:
    """The placement of each axis of a ciphertext tensor [batch..., L, n]:
    the mesh axis it is split over, or None (the reference's
    PartitionSpec, as a tuple)."""
    spec: List[Optional[str]] = [None] * batch_dims + [LIMB_AXIS if shard_limbs else None, None]
    if batch_dims:
        spec[0] = BATCH_AXIS
    return tuple(spec)


def _shard_dims(mesh: DeviceMesh, ndim: int, batch_dims: int, shard_limbs: bool):
    """(axis of the tensor, mesh axis) of each split of a [batch..., L, n]
    tensor of `ndim` axes."""
    spec = ct_pspec(batch_dims, shard_limbs)
    if len(spec) != ndim:
        raise ValueError(f"a tensor of {ndim} axes does not have {batch_dims} batch axes")
    return [(d, ax) for d, ax in enumerate(spec) if ax is not None]


def shard_poly_data(mesh: DeviceMesh, data: torch.Tensor, batch_dims: int = 1,
                    shard_limbs: bool = False) -> torch.Tensor:
    """This rank's shard of a polynomial tensor [batch..., L, n] held whole
    by every rank: its part of the first batch axis over "batch" and, with
    shard_limbs, of the limb axis over "limb", split as torch.tensor_split
    splits them (uneven parts allowed)."""
    for d, ax in _shard_dims(mesh, data.dim(), batch_dims, shard_limbs):
        data = torch.tensor_split(data, axis_size(mesh, ax), dim=d)[axis_index(mesh, ax)]
    return data


def constrain(data: torch.Tensor, mesh: DeviceMesh, global_shape: Sequence[int],
              batch_dims: int = 1, shard_limbs: bool = False) -> torch.Tensor:
    """Checks that `data` has the shape of this rank's shard of a tensor of
    `global_shape` under the placement (the reference's sharding hint);
    returns it."""
    want = list(global_shape)
    for d, ax in _shard_dims(mesh, len(want), batch_dims, shard_limbs):
        want[d] = split_sizes(want[d], axis_size(mesh, ax))[axis_index(mesh, ax)]
    if tuple(data.shape) != tuple(want):
        raise ValueError(f"shard shape {tuple(data.shape)} is not this rank's {tuple(want)} of "
                         f"{tuple(global_shape)} under {ct_pspec(batch_dims, shard_limbs)}")
    return data


def split_sizes(total: int, ways: int) -> List[int]:
    """The part sizes of torch.tensor_split(range(total), ways)."""
    return [total // ways + (1 if i < total % ways else 0) for i in range(ways)]


def limb_parts(limb_ids: Sequence[int], ways: int) -> Tuple[Tuple[int, ...], ...]:
    """limb_ids split over `ways` limb ranks as torch.tensor_split splits
    them."""
    ids, out, at = tuple(limb_ids), [], 0
    for size in split_sizes(len(ids), ways):
        out.append(ids[at:at + size])
        at += size
    return tuple(out)


# ---------------------------------------------------------------------------
# The transport
# ---------------------------------------------------------------------------


def _on_host(mesh: DeviceMesh) -> bool:
    """gloo's collectives take host tensors: pinned buffers for card data."""
    return mesh.device_type != "cuda"


def _to_wire(mesh: DeviceMesh, data: torch.Tensor) -> torch.Tensor:
    """int64 residues as the contiguous int32 bits the collective moves."""
    bits = nttmod.to_u32_bits(data)
    if _on_host(mesh) and bits.is_cuda:
        buf = torch.empty(bits.shape, dtype=torch.int32, pin_memory=True)
        buf.copy_(bits)
        return buf
    return bits


def _wire_buffer(mesh: DeviceMesh, shape, device) -> torch.Tensor:
    if _on_host(mesh):
        return torch.empty(shape, dtype=torch.int32,
                           pin_memory=torch.device(device).type == "cuda")
    return torch.empty(shape, dtype=torch.int32, device=device)


def _from_wire(bits: torch.Tensor, device) -> torch.Tensor:
    return nttmod.from_u32_bits(bits.to(device, non_blocking=True))


def all_gather_limbs(mesh: DeviceMesh, data: torch.Tensor,
                     parts: Tuple[Tuple[int, ...], ...]) -> torch.Tensor:
    """This limb group's limbs [..., sum of parts, n], from each rank's own
    [..., len(parts[rank]), n], in limb order (uneven parts are padded to
    the largest on the wire). A limb group of one rank returns `data`."""
    if len(parts) == 1:
        return data
    t0 = time.perf_counter()
    sizes = [len(p) for p in parts]
    width = max(sizes)
    lead, n = data.shape[:-2], data.shape[-1]
    pad = torch.zeros((*lead, width - data.shape[-2], n), dtype=data.dtype, device=data.device)
    send = _to_wire(mesh, torch.cat([data, pad], dim=-2))
    recv = [_wire_buffer(mesh, send.shape, data.device) for _ in sizes]
    dist.all_gather(recv, send, group=mesh.get_group(_dim(mesh, LIMB_AXIS)))
    out = _from_wire(torch.cat([r[..., :s, :] for r, s in zip(recv, sizes)], dim=-2),
                     data.device)
    _record("all_gather", send.numel() * 4 * (len(sizes) + 1), t0)
    return out


def broadcast_limb(mesh: DeviceMesh, data: Optional[torch.Tensor], src: int, shape,
                   device) -> torch.Tensor:
    """`data` of the limb rank `src` (shape `shape`) on every rank of the
    limb group (`data` itself in a limb group of one rank)."""
    if axis_size(mesh, LIMB_AXIS) == 1:
        return data
    t0 = time.perf_counter()
    mine = axis_index(mesh, LIMB_AXIS) == src
    buf = _to_wire(mesh, data) if mine else _wire_buffer(mesh, shape, device)
    dist.broadcast(buf, src=axis_peer(mesh, LIMB_AXIS, src),
                   group=mesh.get_group(_dim(mesh, LIMB_AXIS)))
    _record("broadcast", buf.numel() * 4, t0)
    return data if mine else _from_wire(buf, device)


def exchange(mesh: DeviceMesh, data: torch.Tensor, peer: int) -> torch.Tensor:
    """Sends `data` to the global rank `peer` and returns what it sends in
    return (one isend and one irecv in a batch, the counterpart of the
    reference's ppermute block swap)."""
    t0 = time.perf_counter()
    send = _to_wire(mesh, data)
    recv = _wire_buffer(mesh, send.shape, data.device)
    for work in dist.batch_isend_irecv([dist.P2POp(dist.isend, send, peer),
                                        dist.P2POp(dist.irecv, recv, peer)]):
        work.wait()
    out = _from_wire(recv, data.device)
    _record("exchange", send.numel() * 8, t0)
    return out


# ---------------------------------------------------------------------------
# Sharded CKKS
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCt:
    """This rank's shard of a CKKS ciphertext: `ct` holds its rows of the
    batch and its own limbs (NTT form, their global limb ids); `parts` the
    limb ids of every rank of its limb group, in limb order."""

    ct: ckks.CkksCt
    parts: Tuple[Tuple[int, ...], ...]

    @property
    def limb_ids(self) -> Tuple[int, ...]:
        return sum(self.parts, ())


def shard_ct(mesh: DeviceMesh, ct: ckks.CkksCt) -> ShardedCt:
    """This rank's shard of a ciphertext [batch, L, n] that every rank
    holds whole."""
    parts = limb_parts(ct.c0.limb_ids, axis_size(mesh, LIMB_AXIS))
    own = parts[axis_index(mesh, LIMB_AXIS)]
    half = lambda p: RnsPoly(shard_poly_data(mesh, p.data, 1, True), p.form, own)  # noqa: E731
    return ShardedCt(ckks.CkksCt(half(ct.c0), half(ct.c1), ct.scaling_factor), parts)


def gather_limbs(mesh: DeviceMesh, sct: ShardedCt) -> ckks.CkksCt:
    """This rank's batch rows of the ciphertext with every limb."""
    pair = all_gather_limbs(mesh, torch.stack([sct.ct.c0.data, sct.ct.c1.data]), sct.parts)
    ids = sct.limb_ids
    return ckks.CkksCt(RnsPoly(pair[0], NTT, ids), RnsPoly(pair[1], NTT, ids),
                       sct.ct.scaling_factor)


def shard_key(mesh: DeviceMesh, key: rgsw_mod.RgswCt, parts, num_special: int):
    """This rank's destination limbs of a key-switching key: every digit
    row, over its own limbs of `parts` and the special primes (a copy, made
    once)."""
    own = parts[axis_index(mesh, LIMB_AXIS)]
    return _key_limbs(key, own + key.limb_ids[len(key.limb_ids) - num_special:])


def _key_limbs(key: rgsw_mod.RgswCt, ids: Tuple[int, ...]) -> rgsw_mod.RgswCt:
    if ids == key.limb_ids:
        return key
    at = torch.tensor([key.limb_ids.index(i) for i in ids], device=key.data.device)
    return rgsw_mod.RgswCt(key.data.index_select(2, at), ids, key.alpha)


def _empty(like: RnsPoly) -> RnsPoly:
    return RnsPoly(like.data[..., :0, :], NTT, ())


def key_switch(ctx, mesh: DeviceMesh, poly: RnsPoly, parts, key: rgsw_mod.RgswCt):
    """ext_prod + the special-prime division of this rank's limbs of `poly`
    (NTT form, limbs parts[rank]) under its key shard: the all-gather of
    the strict coefficient-form limbs over "limb", then K3 / K4 for its own
    destination limbs and the specials. Returns its limbs of (d0, d1)."""
    own = poly.limb_ids
    if own:
        d = rns.reduce_strict(ctx, rns.to_coeff(ctx, poly)).data
    else:
        d = poly.data
    full = all_gather_limbs(mesh, d, parts)
    if not own:
        return _empty(poly), _empty(poly)
    ids = sum(parts, ())
    groups = -(-len(ids) // key.alpha)
    specials = tuple(i for i in key.limb_ids if i in ctx.special_indices)
    k = _key_limbs(key, own + specials)
    k = rgsw_mod.RgswCt(k.data[:groups], k.limb_ids, k.alpha)
    out = rgsw_mod.ext_prod_strict(ctx, RnsPoly(full, COEFF, ids), k)
    return ckks._div_special(ctx, out.c0, out.c1)


def _check_parts(a: ShardedCt, b: ShardedCt) -> None:
    if a.parts != b.parts:
        raise ValueError(f"shards of different limb partitions: {a.parts} vs {b.parts}")


def relinearize(ctx, mesh: DeviceMesh, quad: ckks.CkksQuadCt, parts,
                rlk: rgsw_mod.RgswCt) -> ShardedCt:
    d0, d1 = key_switch(ctx, mesh, quad.c2, parts, rlk)
    if not quad.c0.limb_ids:
        return ShardedCt(ckks.CkksCt(d0, d1, quad.scaling_factor), parts)
    return ShardedCt(ckks.CkksCt(rns.add(ctx, d0, quad.c0), rns.add(ctx, d1, quad.c1),
                                 quad.scaling_factor), parts)


def mult(ctx, mesh: DeviceMesh, a: ShardedCt, b: ShardedCt, rlk: rgsw_mod.RgswCt) -> ShardedCt:
    """ckks.mult on shards: mult_low_level limb-locally, then the sharded
    key switch under this rank's key shard (shard_key)."""
    _check_parts(a, b)
    if a.ct.c0.limb_ids:
        quad = ckks.mult_low_level(ctx, a.ct, b.ct)
    else:
        e = _empty(a.ct.c0)
        quad = ckks.CkksQuadCt(e, e, e, a.ct.scaling_factor * b.ct.scaling_factor)
    return relinearize(ctx, mesh, quad, a.parts, rlk)


def rescale(ctx, mesh: DeviceMesh, a: ShardedCt, dropping_primes: int = 1) -> ShardedCt:
    """ckks.rescale on shards: the last limb (both halves, NTT form) is
    broadcast from its owner, and every rank divides its other limbs by it
    (basecnv.div_last_rounded_pair on its limbs and that one). The owner
    loses the limb; the partition is otherwise kept."""
    for _ in range(dropping_primes):
        parts, ct = a.parts, a.ct
        last = a.limb_ids[-1]
        owner = next(r for r, p in enumerate(parts) if last in p)
        own = ct.c0.limb_ids
        pair = torch.stack([ct.c0.data, ct.c1.data])
        shape = (*pair.shape[:-2], 1, pair.shape[-1])
        top = broadcast_limb(mesh, pair[..., -1:, :] if last in own else None, owner, shape,
                             pair.device)
        keep = tuple(i for i in own if i != last)
        new_parts = tuple(tuple(i for i in p if i != last) for p in parts)
        scale = ct.scaling_factor / ctx.mod_list[last]
        if not keep:
            e = _empty(ct.c0)
            a = ShardedCt(ckks.CkksCt(e, e, scale), new_parts)
            continue
        body = pair[..., :len(keep), :]
        ids = keep + (last,)
        c0, c1 = basecnv.div_last_rounded_pair(
            ctx, RnsPoly(torch.cat([body[0], top[0]], dim=-2), NTT, ids),
            RnsPoly(torch.cat([body[1], top[1]], dim=-2), NTT, ids))
        a = ShardedCt(ckks.CkksCt(c0, c1, scale), new_parts)
    return a


def rotate(ctx, mesh: DeviceMesh, a: ShardedCt, rk: rgsw_mod.RgswCt, step: int) -> ShardedCt:
    """ckks.rotate on shards: the Galois gather limb-locally, then the
    sharded key switch under this rank's rotation-key shard."""
    r0, r1 = galois.cycle(a.ct.c0, step), galois.cycle(a.ct.c1, step)
    d0, d1 = key_switch(ctx, mesh, r1, a.parts, rk)
    c0 = rns.add(ctx, d0, r0) if r0.limb_ids else d0
    return ShardedCt(ckks.CkksCt(c0, d1, a.ct.scaling_factor), a.parts)


# ---------------------------------------------------------------------------
# The rank launcher
# ---------------------------------------------------------------------------

# the device of this rank's work, set by the launcher in each rank
_RANK_DEVICE: Optional[torch.device] = None


def rank_device() -> torch.device:
    """The device the launcher gave this rank (the CPU outside a World)."""
    return _RANK_DEVICE if _RANK_DEVICE is not None else torch.device("cpu")


def rank_devices(size: int, device="cuda") -> List[torch.device]:
    """The device of each of `size` ranks: the CPU for every rank where
    `device` is the CPU, else the cards in turn (rank r on cuda:r % cards:
    ranks share the cards where there are fewer cards than ranks)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * size
    if device.type != "cuda":
        raise ValueError(f"ranks run on cuda or the CPU, not {device}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
    return [torch.device("cuda", r % cards) for r in range(size)]


def backend_for(devices: Optional[Sequence]) -> str:
    """NCCL where every rank has a card of its own; gloo on the CPU or
    where ranks share a card (NCCL refuses two ranks on one card)."""
    devs = [torch.device(d) for d in devices or ()]
    own_cards = all(d.type == "cuda" for d in devs) and len(set(devs)) == len(devs)
    return "nccl" if devs and own_cards else "gloo"


def _rank_main(rank: int, size: int, backend: str, store: str, timeout: float,
               device: Optional[str], tasks, results) -> None:
    global _RANK_DEVICE
    torch.set_num_threads(1)
    try:
        _RANK_DEVICE = torch.device(device) if device else torch.device("cpu")
        if _RANK_DEVICE.type == "cuda":
            torch.cuda.set_device(_RANK_DEVICE)
        dist.init_process_group(backend, store=dist.FileStore(store, size), rank=rank,
                                world_size=size,
                                timeout=datetime.timedelta(seconds=timeout))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, None))
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args = task
        try:
            results.put((rank, True, fn(*args)))
        except BaseException:  # reported to the parent, which raises
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class World:
    """`size` ranks in spawned processes, one torch.distributed process
    group over `backend` ("gloo" or "nccl"; by default backend_for(devices)),
    met through a FileStore in a fresh directory under `store_dir` (the
    system's temporary directory by default). Rank r works on devices[r]
    (the CPU without devices) with one CPU thread. `run(fn, *args)` calls fn(*args) in every rank
    (fn importable by name, its arguments and result picklable) and returns
    the results by rank; a rank's exception is raised here with its
    traceback. The process group's operations, the start, each run and the
    close wait at most `timeout` seconds; at a timeout or error the ranks
    are stopped."""

    def __init__(self, size: int, backend: Optional[str] = None,
                 devices: Optional[Sequence] = None, store_dir: Optional[str] = None,
                 timeout: float = 120.0):
        backend = backend or backend_for(devices)
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend must be gloo or nccl, got {backend}")
        if devices is not None and len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        self.size, self.backend, self.timeout = size, backend, timeout
        self._dir = tempfile.mkdtemp(prefix="hehub_world_", dir=store_dir)
        ctx = mp.get_context("spawn")
        self._tasks = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                r, size, backend, os.path.join(self._dir, "store"), timeout,
                None if devices is None else str(devices[r]), self._tasks[r],
                self._results))
            for r in range(size)]
        try:
            for p in self._procs:
                p.start()
            self._collect(timeout, "start")
        except BaseException:
            self.close()
            raise

    def _collect(self, timeout: float, what: str) -> List[Any]:
        """Every rank's answer within `timeout` s; raises at the first
        failure, or as soon as a rank that owes an answer has exited."""
        out: List[Any] = [None] * self.size
        waiting = set(range(self.size))
        deadline = time.monotonic() + timeout
        while waiting:
            try:
                rank, ok, value = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = sorted(r for r in waiting if not self._procs[r].is_alive())
                if dead:
                    raise RuntimeError(f"{what}: rank(s) {dead} exited without an answer "
                                       f"(exit codes {[self._procs[r].exitcode for r in dead]})"
                                       ) from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{what}: no answer from ranks {sorted(waiting)} within "
                                       f"{timeout} s") from None
                continue
            if not ok:
                raise RuntimeError(f"{what}: rank {rank} failed:\n{value}")
            out[rank] = value
            waiting.discard(rank)
        return out

    def run(self, fn: Callable, *args, timeout: Optional[float] = None) -> List[Any]:
        for q in self._tasks:
            q.put((fn, args))
        try:
            return self._collect(self.timeout if timeout is None else timeout,
                                 getattr(fn, "__name__", str(fn)))
        except BaseException:
            self.close()
            raise

    def close(self) -> None:
        """Asks the ranks to leave, joins them (each within the timeout) and
        stops any still running; removes the store."""
        if not self._procs:
            return
        for q, p in zip(self._tasks, self._procs):
            if p.is_alive():
                q.put(None)
        for p in self._procs:
            if p.pid is not None:
                p.join(self.timeout)
            if p.is_alive():
                p.kill()
                p.join(10)
        for q in self._tasks + [self._results]:
            q.cancel_join_thread()
            q.close()
        self._procs = []
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

