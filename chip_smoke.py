#!/usr/bin/env python3
"""Smoke run of hehub_tpu_torch on one NVIDIA card (H100): builds the CUDA
kernels, holds each against its plain PyTorch version at the main path's
shapes, then drives the CKKS main path end to end and checks its result.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi); no card, no run;
  2. build: nvcc of hehub_tpu_torch/csrc/*.cu for sm_90a, timed;
  3. kernels vs plain at the main path's shapes — K1 (forward NTT) and K2
     (inverse NTT) on [64, 7, 16384], K3 (external product) with R=64,
     l=7, L_ext=8 — bitwise, each timed with CUDA events beside its plain
     version;
  4. main path at n=16384, 7+1 limbs, batch 64, keys and noise from a
     seeded CUDA generator: keygen, relin and rotation keys, encode +
     encrypt, mult + relin + rescale, rotate(1), decrypt + decode, against
     numpy's a*b (max |error| <= 2^-8) and np.roll(a*b, 1) (within the
     reference algorithm's own error, MAX_ERR_ROT below); every kernel
     must have launched during this phase; the homomorphic steps replayed
     on the CPU through the plain versions give bitwise the same
     ciphertexts; then device times of the steps;
  5. a `kernels` JSON line; the card line; last, the result line
     {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without a result line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.core.context import create_ckks_params, make_context
from hehub_tpu_torch.core.rns import RnsPoly
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from hehub_tpu_torch.utils.profiling import device_time, step_time

N = 16384
LEVELS = 7
BATCH = 64
# Bounds on the decoded slots of the main path against numpy:
# after mult + relin + rescale, the 2^-9-per-operation budget of
# tests/test_ckks.py, doubled;
MAX_ERR_MULT = 2.0**-8
# after rotate(1), the error the reference algorithm itself carries at this
# shape (hehub_tpu, which the port matches bit for bit): its alpha=1
# key-switch digits are unsigned, in [0, q_i), and their mean q_i/2 times
# the key's noise lands on the slots whose root lies next to 1, about
# (n/π)·sqrt(l·n)·σ/Δ = 0.078 at n=16384, l=6, Δ≈2^26 (ROADMAP.md, Queue 3).
MAX_ERR_ROT = 2.0**-3
# ciphertexts of the batch replayed on the CPU through the plain versions
REPLAY_ROWS = 4


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def lazy_residues(gen, shape, two_q):
    return torch.randint(0, 1 << 62, shape, generator=gen, device=gen.device) % two_q


def plain_ext_prod(ctx, digits, rgsw):
    """K3's plain version on strict digits [R, l, n]: broadcast each digit
    over the extended limbs, plain forward NTT, Montgomery contraction."""
    ids_ext = rgsw.limb_ids
    R, l, n = digits.shape
    tiled = digits[:, :, None, :].expand(R, l, len(ids_ext), n).contiguous()
    tabs = [ctx.device_rows(nm, ids_ext, digits.device) for nm in nttmod.FWD_TABLES]
    return rgsw_mod.ks_contract(ctx, nttmod.ntt_fwd(tiled, *tabs), rgsw)


def kernels_vs_plain(ctx, dev):
    """Phase 3. Returns the per-kernel records (launches filled in later)."""
    ids = tuple(range(LEVELS))
    ids_ext = ids + ctx.special_indices
    gen = torch.Generator(device=dev).manual_seed(1)
    two_q = ctx.device_rows("two_q", ids, dev)
    q = ctx.device_rows("q", ids, dev)
    x = lazy_residues(gen, (BATCH, LEVELS, N), two_q)
    records = {}

    fwd32 = [ctx.device_rows(nm, ids, dev, torch.int32) for nm in nttmod.FWD_TABLES]
    fwd64 = [ctx.device_rows(nm, ids, dev) for nm in nttmod.FWD_TABLES]
    inv32 = [ctx.device_rows(nm, ids, dev, torch.int32) for nm in nttmod.INV_TABLES]
    inv64 = [ctx.device_rows(nm, ids, dev) for nm in nttmod.INV_TABLES]
    x32 = nttmod.to_u32_bits(x)

    k1 = nttmod.ntt(ctx, x, ids)
    p1 = nttmod.ntt_fwd(x, *fwd64)
    check(torch.equal(k1, p1), "K1 ntt_fwd differs from the plain chain")
    records["ntt_fwd"] = dict(
        route="cuda", source="hehub_tpu_torch/csrc/ntt.cu",
        replaces="hehub_tpu/ops/pallas/ntt_pallas.py:207",
        match="bitwise", max_abs_err=int((k1 - p1).abs().max()),
        ms=device_time(lambda: kernels.ntt_fwd(x32, *fwd32)) * 1e3,
        plain_ms=device_time(lambda: nttmod.ntt_fwd(x, *fwd64), 1, 3) * 1e3,
    )

    k2 = nttmod.intt(ctx, x, ids)
    p2 = nttmod.ntt_inv(x, *inv64)
    check(torch.equal(k2, p2), "K2 ntt_inv differs from the plain chain")
    back = nttmod.intt(ctx, k1, ids)
    check(torch.equal(back % q, x % q), "K2(K1(x)) is not x mod q")
    records["ntt_inv"] = dict(
        route="cuda", source="hehub_tpu_torch/csrc/ntt.cu",
        replaces="hehub_tpu/ops/pallas/ntt_pallas.py:215",
        match="bitwise vs plain; round trip equal mod q",
        max_abs_err=int((k2 - p2).abs().max()),
        ms=device_time(lambda: kernels.ntt_inv(x32, *inv32)) * 1e3,
        plain_ms=device_time(lambda: nttmod.ntt_inv(x, *inv64), 1, 3) * 1e3,
    )

    sk = rlwe_mod.keygen(ctx, gen)
    rlk = keys_mod.relin_key(ctx, sk, gen)
    digits = torch.stack(
        [torch.randint(0, m, (BATCH, N), generator=gen, device=dev) for m in ctx.moduli_of(ids)],
        dim=1,
    )  # strict coefficient digits [R, l, n]
    ext32 = [ctx.device_rows(nm, ids_ext, dev, torch.int32)
             for nm in ("tw_fwd", "tw_fwd_sh", "q", "two_q", "neg_qinv")]
    d32 = nttmod.to_u32_bits(digits)
    key32 = nttmod.to_u32_bits(rlk.data[:LEVELS])
    k3 = nttmod.from_u32_bits(kernels.ext_prod(d32, key32, *ext32))
    p3 = plain_ext_prod(ctx, digits, rlk)
    err3 = max(int((k3[0] - p3.c0.data).abs().max()), int((k3[1] - p3.c1.data).abs().max()))
    check(err3 == 0, "K3 ext_prod differs from ks_contract(ks_digits(...))")
    records["ext_prod"] = dict(
        route="cuda", source="hehub_tpu_torch/csrc/extprod.cu",
        replaces="hehub_tpu/ops/pallas/extprod_pallas.py:27",
        match="bitwise", max_abs_err=err3,
        ms=device_time(lambda: kernels.ext_prod(d32, key32, *ext32)) * 1e3,
        plain_ms=device_time(lambda: plain_ext_prod(ctx, digits, rlk), 1, 3) * 1e3,
    )
    conv = dict(
        to_u32_ms=device_time(lambda: nttmod.to_u32_bits(x)) * 1e3,
        from_u32_ms=device_time(lambda: nttmod.from_u32_bits(x32)) * 1e3,
        key_to_u32_ms=device_time(lambda: nttmod.to_u32_bits(rlk.data[:LEVELS])) * 1e3,
    )
    for name, rec in records.items():
        print(f"[kernels] {name}: {rec['match']}, max_abs_err={rec['max_abs_err']}, "
              f"kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms")
    print(f"[kernels] int64<->int32 conversions at [{BATCH},{LEVELS},{N}]: {json.dumps(conv)}")
    return records


def _rows_on_cpu(ct, rows):
    take = lambda p: RnsPoly(p.data[:rows].cpu(), p.form, p.limb_ids)  # noqa: E731
    return ckks.CkksCt(take(ct.c0), take(ct.c1), ct.scaling_factor)


def cpu_replay(ctx, params, ca, cb, rlk, rk, sk, rot, out):
    """The main path's homomorphic steps again, on the CPU through the plain
    versions, for the first REPLAY_ROWS ciphertexts: the card's ciphertexts
    must be bitwise equal, and their decoded slots equal."""
    key = lambda k: rgsw_mod.RgswCt(k.data.cpu(), k.limb_ids, k.alpha)  # noqa: E731
    sk_c = rlwe_mod.RlweSk(sk.coeffs.cpu(), sk.ntt.cpu(), sk.ntt_sh.cpu())
    prod_c = ckks.rescale(ctx, ckks.mult(ctx, _rows_on_cpu(ca, REPLAY_ROWS),
                                         _rows_on_cpu(cb, REPLAY_ROWS), key(rlk)))
    rot_c = ckks.rotate(ctx, prod_c, key(rk), 1)
    card = _rows_on_cpu(rot, REPLAY_ROWS)
    check(torch.equal(rot_c.c0.data, card.c0.data) and torch.equal(rot_c.c1.data, card.c1.data),
          "the card's rotate(mult(...)) differs from the plain CPU path")
    out_c = ckks.decode(ckks.decrypt(ctx, rot_c, sk_c), params)
    check(np.allclose(out_c, out[:REPLAY_ROWS], rtol=0, atol=1e-12),
          "decoded slots differ from the plain CPU path")
    print(f"[main] plain CPU replay of {REPLAY_ROWS} ciphertexts: bitwise equal ciphertexts, "
          f"equal decoded slots")


def main_path(params, ctx, dev):
    """Phase 4: returns (launch counts of the run, metrics)."""
    ids = tuple(range(LEVELS))
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (BATCH, N // 2))
    b = rng.uniform(-1, 1, (BATCH, N // 2))
    gen = torch.Generator(device=dev).manual_seed(0)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sk = rlwe_mod.keygen(ctx, gen)
    rlk = keys_mod.relin_key(ctx, sk, gen)
    rk = keys_mod.rot_key(ctx, sk, 1, gen)
    ca = ckks.encrypt(ctx, ckks.encode(a, params, device=dev), sk, gen)
    cb = ckks.encrypt(ctx, ckks.encode(b, params, device=dev), sk, gen)
    prod = ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk))
    rot = ckks.rotate(ctx, prod, rk, 1)
    out_prod = ckks.decode(ckks.decrypt(ctx, prod, sk), params)
    out = ckks.decode(ckks.decrypt(ctx, rot, sk), params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)

    check(out.shape == (BATCH, N // 2), f"decoded shape {out.shape}")
    check(bool(np.isfinite(out).all() and np.isfinite(out_prod).all()), "decoded values not finite")
    check(rot.limb_ids == ids[:-1], f"result limbs {rot.limb_ids}")
    err_mult = float(np.abs(out_prod - a * b).max())
    err = float(np.abs(out - np.roll(a * b, 1, axis=-1)).max())
    print(f"[main] n={N} L={LEVELS}+1 batch={BATCH}: keygen..decode {wall:.3f} s (host clock), "
          f"max|err| of mult+rescale vs a*b = {err_mult:.3e} (log2 {np.log2(err_mult):.2f}), "
          f"of rotate(mult, 1) vs np.roll(a*b, 1) = {err:.3e} (log2 {np.log2(err):.2f}), "
          f"launches {json.dumps(launches)}")
    check(err_mult <= MAX_ERR_MULT, f"mult decode error {err_mult} above {MAX_ERR_MULT}")
    check(err <= MAX_ERR_ROT, f"rotate decode error {err} above {MAX_ERR_ROT}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")
    cpu_replay(ctx, params, ca, cb, rlk, rk, sk, rot, out)

    x = ca.c0.data
    transforms = BATCH * LEVELS
    metrics = dict(
        ntt_fwd_us_per_transform=device_time(lambda: nttmod.ntt(ctx, x, ids)) * 1e6 / transforms,
        intt_us_per_transform=device_time(lambda: nttmod.intt(ctx, x, ids)) * 1e6 / transforms,
        ckks_mult_ms_per_op=device_time(
            lambda: ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk)), 1, 5) * 1e3 / BATCH,
        ckks_rotate_ms_per_op=device_time(lambda: ckks.rotate(ctx, prod, rk, 1), 1, 5)
        * 1e3 / BATCH,
        ckks_encode_encrypt_ms=step_time(
            lambda: ckks.encrypt(ctx, ckks.encode(a, params, device=dev), sk, gen)) * 1e3 / BATCH,
        ckks_decrypt_decode_ms=step_time(
            lambda: ckks.decode(ckks.decrypt(ctx, rot, sk), params)) * 1e3 / BATCH,
        mult_max_abs_err=err_mult,
        rotate_max_abs_err=err,
    )
    print("[main] times (ntt/intt/mult/rotate: CUDA events, per transform or per ciphertext; "
          "encode/decode: host clock per ciphertext of a batch-64 call): " + json.dumps(metrics))
    return launches, metrics


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(f"[device] {card}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {name}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(kernels.SOURCES.values())}")
    for line in kernels.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[build] {line.strip()}")

    params = create_ckks_params(N, scaling_bits=28, num_levels=LEVELS)
    ctx = make_context(params)
    records = kernels_vs_plain(ctx, dev)
    launches, _ = main_path(params, ctx, dev)
    for k, rec in records.items():
        rec["launches"] = launches[k]
    print(json.dumps({"kernels": [dict(name=k, **rec) for k, rec in records.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
