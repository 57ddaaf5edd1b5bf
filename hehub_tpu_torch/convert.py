"""Carry state made by the JAX package into this one.

Every function takes numpy arrays (e.g. `np.asarray` of a hehub_tpu key or
ciphertext) and returns this package's objects on `device`, the card unless
the caller asks for the CPU. JAX's PRNG and
torch's generators cannot agree, so this is how both packages are given the
same keys and ciphertexts. Nothing here imports JAX.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hehub_tpu_torch.core.rns import RnsPoly
from hehub_tpu_torch.models.bgv import BgvCt, BgvPt
from hehub_tpu_torch.models.ckks import CkksCt
from hehub_tpu_torch.models.tfhe import LweCt, TfheKeys
from hehub_tpu_torch.rlwe.rgsw import RgswCt
from hehub_tpu_torch.rlwe.rlwe import RlweSk


def _tensor(a, device="cuda", dtype=torch.int64) -> torch.Tensor:
    """A numpy array (uint32 residues, int8 coefficients, ...) as a tensor of
    `dtype` on `device`; uint32 values keep their value in int64."""
    return torch.from_numpy(np.asarray(a).astype(np.int64)).to(device=device, dtype=dtype)


def sk_from_numpy(coeffs, ntt, ntt_sh, device="cuda") -> RlweSk:
    """Secret key from its ternary coefficients [n] and strict NTT residues
    and Shoup companions [M, n]."""
    return RlweSk(
        coeffs=_tensor(coeffs, device, torch.int8),
        ntt=_tensor(ntt, device),
        ntt_sh=_tensor(ntt_sh, device),
    )


def rgsw_from_numpy(data, limb_ids: Tuple[int, ...], alpha: int = 1, device="cuda") -> RgswCt:
    """RGSW / key-switching key from its [rows, 2, L_ext, n] tensor."""
    return RgswCt(_tensor(data, device), tuple(limb_ids), alpha)


def poly_from_numpy(data, form: str, limb_ids: Tuple[int, ...], device="cuda") -> RnsPoly:
    """RnsPoly from its [..., L, n] residues."""
    return RnsPoly(_tensor(data, device), form, tuple(limb_ids))


def ct_from_numpy(c0, c1, limb_ids: Tuple[int, ...], scale: float, device="cuda") -> CkksCt:
    """NTT-form CKKS ciphertext from its two halves [..., L, n]."""
    return CkksCt(
        poly_from_numpy(c0, "ntt", limb_ids, device),
        poly_from_numpy(c1, "ntt", limb_ids, device),
        float(scale),
    )


def bgv_ct_from_numpy(c0, c1, limb_ids: Tuple[int, ...], plain_modulus: int,
                      device="cuda") -> BgvCt:
    """NTT-form BGV ciphertext from its two halves [..., L, n]."""
    return BgvCt(
        poly_from_numpy(c0, "ntt", limb_ids, device),
        poly_from_numpy(c1, "ntt", limb_ids, device),
        int(plain_modulus),
    )


def bgv_pt_from_numpy(digits, neg, plain_modulus: int) -> BgvPt:
    """BGV plaintext from its digit form (uint32 digits [..., 3, n], signs
    [..., n]); plaintexts stay on the host, as in the JAX package."""
    return BgvPt(np.asarray(digits, np.uint32), np.asarray(neg, np.uint32), int(plain_modulus))


def tfhe_keys_from_numpy(lwe_s, sk: RlweSk, bsk, ksk_a, ksk_b, device="cuda") -> TfheKeys:
    """TFHE keys from the LWE secret [m], the ring secret (sk_from_numpy),
    the bootstrap key [m, 2, l, 2, N] and the key-switch key ksk_a [N, kl,
    m], ksk_b [N, kl]. The JAX keys' Shoup companions of the key-switch key
    are not needed here."""
    return TfheKeys(_tensor(lwe_s, device), sk, _tensor(bsk, device), _tensor(ksk_a, device),
                    _tensor(ksk_b, device))


def lwe_ct_from_numpy(a, b, device="cuda") -> LweCt:
    """LWE ciphertext(s) from a [..., m] and b [...]."""
    return LweCt(_tensor(a, device), _tensor(b, device))
