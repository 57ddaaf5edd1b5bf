"""Helpers shared by the tests/test_torch_*.py files, which hold the PyTorch
port (hehub_tpu_torch) against the JAX package (hehub_tpu) on the same
numpy-made inputs.

Tests that need an NVIDIA card carry the `cuda` marker and take the
`cuda_device` fixture, which skips them where there is none; on the card
they run with `python -m pytest --noconftest -m cuda tests/test_torch_*.py`.
The port does not use JAX on the card: those tests import none of it, and
a test file imports the JAX package inside the tests that use it or through
`Reference`, never at its top.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch


class Reference:
    """A module of the JAX package (or of JAX), imported at its first
    attribute read rather than when the test file is imported."""

    def __init__(self, name: str):
        self._name = name

    def __getattr__(self, attr):
        return getattr(importlib.import_module(self._name), attr)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


def to_device(obj, device):
    """A copy of a port object with every tensor in it on `device`: a
    ciphertext (CkksCt, BgvCt), a key (RgswCt, RlweSk), an RnsPoly, or a
    list, tuple or dict of them. Other values are kept as they are."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: to_device(getattr(obj, f.name), device)
                                          for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    return obj


def lazy_residues(rng, batch_shape, mods, n):
    """uint32 numpy residues [*batch_shape, L, n], uniform in [0, 2 q_j)."""
    two_q = 2 * np.asarray(mods, np.int64)[:, None]
    x = rng.integers(0, 1 << 62, (*batch_shape, len(mods), n)) % two_q
    return x.astype(np.uint32)


def as_numpy(t: torch.Tensor) -> np.ndarray:
    """A port tensor of uint32 residues (int64) as numpy uint32."""
    return t.cpu().numpy().astype(np.uint32)


def ext_prod_case(n, num_levels, num_special, R, device, seed):
    """Random inputs of the fused external-product kernels at n, on
    `device`: (ctx, ids_ext, kernel tables (regrouped above
    kernels.EXT_SUB_N), strict digits [R, l, n] (K3), converted lazy digits
    [R, D, L_ext, n] with D = ceil(l / 2) (K4), key [l, 2, L_ext, n] lazy
    Montgomery-domain values), all int64."""
    from hehub_tpu_torch import kernels
    from hehub_tpu_torch.core import context as tctx
    from hehub_tpu_torch.ops import ntt as tn

    ctx = tctx.make_context(tctx.create_ckks_params(
        n, 28, num_levels, use_security_budget=False, num_special=num_special))
    ids = tuple(range(num_levels))
    ids_ext = ids + ctx.special_indices
    rng = np.random.default_rng(seed)
    strict = np.stack([rng.integers(0, q, (R, n)) for q in ctx.moduli_of(ids)], axis=1)
    conv = lazy_residues(rng, (R, -(-num_levels // 2)), ctx.moduli_of(ids_ext), n)
    key = lazy_residues(rng, (num_levels, 2), ctx.moduli_of(ids_ext), n)
    names = tn.EXT_SPLIT_TABLES if n > kernels.EXT_SUB_N else tn.EXT_TABLES
    tabs = [ctx.device_rows(nm, ids_ext, device, torch.int32) for nm in names]
    to = lambda a: torch.from_numpy(a.astype(np.int64)).to(device)  # noqa: E731
    return ctx, ids_ext, tabs, to(strict), to(conv), to(key)


def jit_reference_ops(mp):
    """Run hehub_tpu's NTTs, external products, key-switch digits and
    special-prime divisions (both flavours) under jax.jit, one compiled
    function per (operation, limbs, shape), for the rest of the monkeypatch
    context `mp`.

    Called eagerly, as the circuits call them, each of them compiles every
    primitive of its stage chains anew at each level (about 10 s a level at
    n=256 on the CPU); jitted, the same integer arithmetic gives the same
    bits in a fraction of that, and every later call at a level seen before
    reuses its compiled function."""
    import jax

    from hehub_tpu.core import basecnv
    from hehub_tpu.core.rns import RnsPoly
    from hehub_tpu.ops import ntt as nttmod
    from hehub_tpu.rlwe import rgsw

    cache = {}

    def cached(key, make):
        if key not in cache:
            cache[key] = jax.jit(make())
        return cache[key]

    def with_key(name, orig):
        def call(ctx, poly, key):
            k = (name, id(ctx), poly.form, poly.limb_ids, poly.data.shape, key.limb_ids,
                 key.alpha, key.data.shape)
            f = cached(k, lambda: lambda d, kd: orig(ctx, RnsPoly(d, poly.form, poly.limb_ids),
                                                     rgsw.RgswCt(kd, key.limb_ids, key.alpha)))
            return f(poly.data, key.data)
        return call

    mp.setattr(rgsw, "ext_prod", with_key("ext_prod", rgsw.ext_prod))
    mp.setattr(rgsw, "ks_digits", with_key("ks_digits", rgsw.ks_digits))
    div = basecnv.div_last_rounded_pair

    def div_pair(ctx, a, b, plain_modulus=None, restore_plain_scale=True):
        f = cached(("div", id(ctx), a.form, a.limb_ids, a.data.shape, plain_modulus,
                    restore_plain_scale), lambda: lambda x, y: div(
            ctx, RnsPoly(x, a.form, a.limb_ids), RnsPoly(y, a.form, a.limb_ids), plain_modulus,
            restore_plain_scale))
        return f(a.data, b.data)

    mp.setattr(basecnv, "div_last_rounded_pair", div_pair)
    for name in ("ntt", "intt"):
        def transform(ctx, data, limb_ids, orig=getattr(nttmod, name), name=name):
            ids = tuple(limb_ids)
            return cached((name, id(ctx), ids, data.shape),
                          lambda: lambda d: orig(ctx, d, ids))(data)
        mp.setattr(nttmod, name, transform)


def plain_ext_prod_conv(ctx, ids_ext, digits, key):
    """The plain PyTorch version of K3/K4 on the digits' device: forward NTT
    of digits [R, D, L_ext, n] by the plain stage chain, then ks_contract
    against key [>= D, 2, L_ext, n]; returns (c0, c1) [R, L_ext, n]."""
    from hehub_tpu_torch.ops import ntt as tn
    from hehub_tpu_torch.rlwe import rgsw as trgsw

    tabs = [ctx.device_rows(nm, ids_ext, digits.device) for nm in tn.FWD_TABLES]
    out = trgsw.ks_contract(ctx, tn.ntt_fwd(digits, *tabs), trgsw.RgswCt(key, ids_ext))
    return out.c0.data, out.c1.data
