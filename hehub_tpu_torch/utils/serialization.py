"""Key, ciphertext and parameter (de)serialization (port of
hehub_tpu/utils/serialization.py), in the reference's file format, so that
files cross between the two packages both ways.

Format: a numpy .npz (compressed) holding `__meta__`, the UTF-8 JSON of
{"meta": {"kind": ..., ...}, "params": params_to_json(params)} as uint8,
and the object's arrays under the reference's names. Residues are stored as
uint32, as hehub_tpu stores them (the port holds them in int64 tensors),
and secret-key coefficients as int8.

Covered: RlweParams/CkksParams/BgvParams, RnsPoly, CkksCt, CkksPt, BgvCt,
RgswCt (key-switching keys, with `alpha`), RlweSk, TfheKeys and LweCt.
`load` makes the objects through hehub_tpu_torch.convert's functions, on the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict

import numpy as np
import torch

from hehub_tpu_torch import convert
from hehub_tpu_torch.core.context import BgvParams, CkksParams, RlweParams
from hehub_tpu_torch.core.rns import RnsPoly
from hehub_tpu_torch.models.bgv import BgvCt
from hehub_tpu_torch.models.ckks import CkksCt, CkksPt
from hehub_tpu_torch.models.tfhe import LweCt, TfheKeys
from hehub_tpu_torch.rlwe.rgsw import RgswCt
from hehub_tpu_torch.rlwe.rlwe import RlweSk

_PARAM_TYPES = {
    "RlweParams": RlweParams,
    "CkksParams": CkksParams,
    "BgvParams": BgvParams,
}


def params_to_json(params: RlweParams) -> str:
    d = dataclasses.asdict(params)
    d["__type__"] = type(params).__name__
    return json.dumps(d)


def _params_from_dict(d: Dict[str, Any]) -> RlweParams:
    d = dict(d)
    cls = _PARAM_TYPES[d.pop("__type__")]
    d["moduli"] = tuple(d["moduli"])
    if isinstance(d.get("special_mod"), list):
        d["special_mod"] = tuple(d["special_mod"])
    return cls(**d)


def params_from_json(s: str) -> RlweParams:
    return _params_from_dict(json.loads(s))


def _u32(t: torch.Tensor) -> np.ndarray:
    """Residues (int64 values in [0, 2^32)) as host uint32."""
    return t.detach().cpu().numpy().astype(np.uint32)


def _shoup(w: np.ndarray, q: int) -> np.ndarray:
    """Shoup companions floor(w 2^32 / q), as the reference's TFHE keygen
    makes them."""
    return ((w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)).astype(np.uint32)


def _meta(obj) -> Dict[str, Any]:
    if isinstance(obj, RnsPoly):
        return {"kind": "RnsPoly", "form": obj.form, "limb_ids": list(obj.limb_ids)}
    if isinstance(obj, CkksCt):
        return {"kind": "CkksCt", "scale": obj.scaling_factor,
                "form": obj.c0.form, "limb_ids": list(obj.c0.limb_ids)}
    if isinstance(obj, CkksPt):
        return {"kind": "CkksPt", "scale": obj.scaling_factor,
                "form": obj.poly.form, "limb_ids": list(obj.poly.limb_ids)}
    if isinstance(obj, BgvCt):
        return {"kind": "BgvCt", "t": obj.plain_modulus,
                "form": obj.c0.form, "limb_ids": list(obj.c0.limb_ids)}
    if isinstance(obj, RgswCt):
        return {"kind": "RgswCt", "limb_ids": list(obj.limb_ids), "alpha": obj.alpha}
    if isinstance(obj, RlweSk):
        return {"kind": "RlweSk"}
    if isinstance(obj, TfheKeys):
        return {"kind": "TfheKeys"}
    if isinstance(obj, LweCt):
        return {"kind": "LweCt"}
    raise TypeError(f"unsupported object {type(obj)}")


def _sk_arrays(sk: RlweSk) -> Dict[str, np.ndarray]:
    return {"coeffs": sk.coeffs.detach().cpu().numpy().astype(np.int8),
            "ntt": _u32(sk.ntt), "ntt_sh": _u32(sk.ntt_sh)}


def _arrays(obj, params: RlweParams) -> Dict[str, np.ndarray]:
    if isinstance(obj, RnsPoly):
        return {"data": _u32(obj.data)}
    if isinstance(obj, (CkksCt, BgvCt)):
        return {"c0": _u32(obj.c0.data), "c1": _u32(obj.c1.data)}
    if isinstance(obj, CkksPt):
        return {"data": _u32(obj.poly.data)}
    if isinstance(obj, RgswCt):
        return {"data": _u32(obj.data)}
    if isinstance(obj, RlweSk):
        return _sk_arrays(obj)
    if isinstance(obj, TfheKeys):
        # the reference's key switch reads the key-switch key's Shoup
        # companions from the keys; the port's does not keep them, so they
        # are made here for hehub_tpu to load (mod q, the one TFHE modulus)
        q = params.moduli[0]
        ksk_a, ksk_b = _u32(obj.ksk_a), _u32(obj.ksk_b)
        d = {"lwe_s": _u32(obj.lwe_s), "bsk": _u32(obj.bsk),
             "ksk_a": ksk_a, "ksk_a_sh": _shoup(ksk_a, q),
             "ksk_b": ksk_b, "ksk_b_sh": _shoup(ksk_b, q)}
        d.update({f"sk_{k}": v for k, v in _sk_arrays(obj.rlwe_sk).items()})
        return d
    if isinstance(obj, LweCt):
        return {"a": _u32(obj.a), "b": _u32(obj.b)}
    raise TypeError(f"unsupported object {type(obj)}")


def save(path_or_file, obj, params: RlweParams) -> None:
    """Write `obj` and its parameters in the reference's .npz format."""
    blob = {"meta": _meta(obj), "params": json.loads(params_to_json(params))}
    np.savez_compressed(
        path_or_file,
        __meta__=np.frombuffer(json.dumps(blob).encode(), dtype=np.uint8),
        **_arrays(obj, params),
    )


def load(path_or_file, device="cuda"):
    """Returns (object, params), the object's tensors on `device` (the card
    unless the caller asks for the CPU)."""
    z = np.load(path_or_file)
    blob = json.loads(bytes(z["__meta__"]).decode())
    meta = blob["meta"]
    params = _params_from_dict(blob["params"])
    kind = meta["kind"]

    def poly(name):
        return convert.poly_from_numpy(z[name], meta["form"], tuple(meta["limb_ids"]), device)

    def sk(prefix=""):
        return convert.sk_from_numpy(z[f"{prefix}coeffs"], z[f"{prefix}ntt"],
                                     z[f"{prefix}ntt_sh"], device)

    if kind == "RnsPoly":
        obj = poly("data")
    elif kind == "CkksCt":
        obj = CkksCt(poly("c0"), poly("c1"), float(meta["scale"]))
    elif kind == "CkksPt":
        obj = CkksPt(poly("data"), float(meta["scale"]))
    elif kind == "BgvCt":
        obj = BgvCt(poly("c0"), poly("c1"), int(meta["t"]))
    elif kind == "RgswCt":
        obj = convert.rgsw_from_numpy(z["data"], tuple(meta["limb_ids"]), meta.get("alpha", 1),
                                      device)
    elif kind == "RlweSk":
        obj = sk()
    elif kind == "TfheKeys":
        # the key-switch key's Shoup companions are dropped: the port's key
        # switch does not read them
        obj = convert.tfhe_keys_from_numpy(z["lwe_s"], sk("sk_"), z["bsk"], z["ksk_a"],
                                           z["ksk_b"], device)
    elif kind == "LweCt":
        obj = convert.lwe_ct_from_numpy(z["a"], z["b"], device)
    else:
        raise ValueError(f"unknown kind {kind}")
    return obj, params
