"""Bootstrap artifacts: a refresh saved by one process and run by another
(port of hehub_tpu/circuits/boot_artifact.py).

`save(refresh, path)` writes what a split-mode CompiledBootstrapper holds:
the parameters, the keys' data, the plans' plaintexts, the constant
plaintexts and the metadata between stages, as tensors in one `torch.save`
file. `load(path)` rebuilds the Bootstrapper from them and a
CompiledBootstrapper on its device (discovery on a zero ciphertext, then
the CUDA graphs captured anew on the card): no keygen and no encoding. A
loaded refresh is bitwise equal to the one that was saved.

The reference serializes its four stage programs with `jax.export`,
because tracing the refresh took minutes through a remote compile helper.
That part has no counterpart: a CUDA graph cannot be serialized, and
capturing one takes one refresh. Callers put artifacts under the
repository's git-ignored `.boot_cache/`.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch

from hehub_tpu_torch.circuits import bootstrap as bs
from hehub_tpu_torch.core import rns
from hehub_tpu_torch.core.context import CkksParams, make_context
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod

_FORMAT_VERSION = 1


def _key_state(k: rgsw_mod.RgswCt) -> Dict:
    return dict(data=k.data.cpu(), limb_ids=list(k.limb_ids), alpha=k.alpha)


def _key(state: Dict, device) -> rgsw_mod.RgswCt:
    return rgsw_mod.RgswCt(state["data"].to(device), tuple(state["limb_ids"]), state["alpha"])


def save(refresh: bs.CompiledBootstrapper, path: str) -> None:
    """Write a split-mode CompiledBootstrapper to `path` (one torch.save
    file, written under a temporary name and then moved into place)."""
    if not refresh.split:
        raise ValueError("artifact save requires CompiledBootstrapper(split=True)")
    b = refresh.b
    p = b.params
    plans = []
    for key, plan in b._plans.items():
        plans.append(dict(
            key=list(key), slot_count=plan.slot_count, level=plan.level,
            pt_scale=plan.pt_scale, dimension=plan.dimension, B=plan.B, G=plan.G,
            codec=plan.codec, gb=[list(gb) for gb in plan.pts],
            pts=torch.stack([pt.data for pt in plan.pts.values()]).cpu()))
    consts = [dict(key=[value, scale, limbs], data=pt.poly.data.cpu(), form=pt.poly.form)
              for (value, scale, limbs, _), pt in b._consts.pts.items()]
    state = dict(
        version=_FORMAT_VERSION,
        params=dict(dimension=p.dimension, moduli=list(p.moduli),
                    special_mods=list(p.special_mods),
                    special_is_tuple=not isinstance(p.special_mod, (int, np.integer)),
                    initial_scaling_factor=p.initial_scaling_factor),
        booter=dict(k_bound=b.k_bound, degree=b.degree, arcsine=b.arcsine,
                    double_angle=b.double_angle, lt_stages=b.lt_stages),
        keys=dict(rlk=_key_state(b.rlk), conj=_key_state(b.conj_key),
                  rot=[[st, _key_state(k)] for st, k in b.rot_keys.items()]),
        plans=plans, consts=consts,
        ids_in=list(refresh.ids_in), scale_in=refresh.scale_in,
        batch=list(refresh._batch_shape),
    )
    tmp = path + ".tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)


def _params(st: Dict) -> CkksParams:
    sp = tuple(st["special_mods"])
    return CkksParams(dimension=st["dimension"], moduli=tuple(st["moduli"]),
                      special_mod=sp if st["special_is_tuple"] else sp[0],
                      initial_scaling_factor=st["initial_scaling_factor"])


def _plan(st: Dict, device) -> bs.LinearTransformPlan:
    """A filled plan from its saved state (the matrix itself is not kept)."""
    plan = bs.LinearTransformPlan.__new__(bs.LinearTransformPlan)
    plan.slot_count, plan.level, plan.pt_scale = st["slot_count"], st["level"], st["pt_scale"]
    plan.dimension, plan.B, plan.G, plan.codec = st["dimension"], st["B"], st["G"], st["codec"]
    ids = tuple(range(plan.level))
    plan._keys = [tuple(gb) for gb in st["gb"]]
    plan._limb_ids = ids
    pts = st["pts"].to(device)
    plan.pts = {gb: rns.RnsPoly(pts[i], rns.NTT, ids) for i, gb in enumerate(plan._keys)}
    return plan


class LoadedBootstrapper(bs.CompiledBootstrapper):
    """A refresh loaded from an artifact onto `device` (the card unless the
    caller asks for the CPU): call-compatible with the CompiledBootstrapper
    that was saved (split mode), built without keygen or encoding."""

    def __init__(self, path: str, device="cuda"):
        st = torch.load(path, map_location="cpu", weights_only=True)
        if st["version"] != _FORMAT_VERSION:
            raise ValueError(f"artifact version {st['version']} != {_FORMAT_VERSION}")
        device = torch.device(device)
        params = _params(st["params"])
        ctx = make_context(params)
        keys = st["keys"]
        booter = bs.Bootstrapper(
            ctx, params, _key(keys["rlk"], device),
            {int(step): _key(k, device) for step, k in keys["rot"]},
            _key(keys["conj"], device), **st["booter"])
        for p in st["plans"]:
            booter._plans[tuple(p["key"])] = _plan(p, device)
        dev = str(device)
        for c in st["consts"]:
            value, scale, limbs = c["key"]
            poly = rns.RnsPoly(c["data"].to(device), c["form"], tuple(range(limbs)))
            booter._consts.pts[(value, scale, limbs, dev)] = ckks.CkksPt(poly, scale)
        ids_in = tuple(st["ids_in"])
        zero = torch.zeros((*st["batch"], len(ids_in), params.dimension), dtype=torch.int64,
                           device=device)
        example = ckks.CkksCt(rns.RnsPoly(zero, rns.NTT, ids_in),
                              rns.RnsPoly(zero, rns.NTT, ids_in), st["scale_in"])
        super().__init__(booter, example, split=True)


def load(path: str, device="cuda") -> LoadedBootstrapper:
    return LoadedBootstrapper(path, device)
