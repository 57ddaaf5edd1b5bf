#!/usr/bin/env python3
"""Smoke run of hehub_tpu_torch on one NVIDIA card (H100): builds the CUDA
kernels, holds each against its plain PyTorch version at the shapes of the
paths that run it, then drives the CKKS main path and the hybrid
key-switching path end to end and checks their results.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi); no card, no run;
  2. build: nvcc of hehub_tpu_torch/csrc/*.cu for sm_90a, timed;
  3. kernels vs plain, at their paths' shapes: K1 (forward NTT) and K2
     (inverse NTT) on [64, 7, 16384]; K3 (alpha=1 external product) with
     R=64, l=7, L_ext=8; K4 (alpha=2 external product) with R=64, D=6,
     L_ext=14; K5 (FP64 FFT) on [64, 8192] — all bitwise, K5 also against
     numpy complex128; each timed twice, kernel-only (per call, from a
     torch.profiler trace: each kernel's mean interval times its launches
     per call, for the port's kernels and the library's alike) and per
     call (CUDA events around back-to-back Python calls, the wrapper's host
     work included), beside its plain version, its bound (the least time the
     card could take: bytes over the memory rate or operations over the
     peak rate, the larger) and the ratio of the two, and K5 beside
     torch.fft.fft, timed both ways too, and kernel-only against it at
     [130, 8192] and [64, 16384] as well (the card tests hold K1-K5 at
     every size they take); after phases 4 and 5, whose launch records
     give its shapes, K1 and K2 again at n=16384 at every row count the
     two paths launched them with, each bitwise against its plain chain and
     timed kernel-only and per call beside its bound at those rows, and
     the launch-weighted sums of those kernel-only times (Σ over a run's or
     a step's launches of the time at their row count) per path, per step
     and over both paths;
  4. main path at n=16384, 7+1 limbs, batch 64, keys and noise from a
     seeded CUDA generator: keygen, relin and rotation keys, encode +
     encrypt (device codec), mult + relin + rescale, rotate(1), decrypt +
     decode (device codec), against numpy's a*b (max |error| <= 2^-8) and
     np.roll(a*b, 1) (within the reference algorithm's own error,
     MAX_ERR_ROT below); K1, K2, K3 and K5 must have launched during this
     phase; the homomorphic steps replayed on the CPU through the plain
     versions give bitwise the same ciphertexts, and decoding them there
     through the device codec's plain version gives the same slots; then
     times of the steps, a profiler trace of each step, and the rows of
     each K1/K2 launch, of the whole run and of one call of each step;
  5. hybrid path at n=16384 over the full 128-bit budget, 12+2 limbs,
     alpha=2 keys, batch 64: encode, encrypt, mult + relin + rescale,
     rotate(1), decrypt, decode against a*b and its roll (<= 2^-8); K4 and
     K5 must have launched during this phase; a CPU replay of 4 rows gives
     bitwise the same ciphertexts; then mult and rotate times and traces,
     and the K1/K2 launch records as in phase 4;
  6. a `kernels` JSON line (K1 and K2 with `by_rows`, their times at each
     row count, and `launch_weighted_kernel_ms`); the card line; last, the
     result line {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without a result line.
"""

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

from hehub_tpu_torch import config, kernels
from hehub_tpu_torch.core.context import create_ckks_params, make_context
from hehub_tpu_torch.core.rns import RnsPoly
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.ops import fft as fftmod
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from hehub_tpu_torch.utils.profiling import device_time, device_trace, kernel_time, step_time

N = 16384
NTT_KERNELS = ("ntt_fwd", "ntt_inv")
LEVELS = 7
BATCH = 64
# hybrid key switching over the full 128-bit budget at n=16384: 12 ciphertext
# and 2 special primes of 30 bits (420 of 438 bits), digits of 2 limbs
HYBRID_SPECIAL = 2
ALPHA = 2
# Bounds on the decoded slots against numpy:
# after mult + relin + rescale, the 2^-9-per-operation budget of
# tests/test_ckks.py, doubled; the same after the hybrid rotate;
MAX_ERR_MULT = 2.0**-8
# after the main path's rotate(1), the error the reference algorithm itself
# carries at this shape (hehub_tpu, which the port matches bit for bit): its
# alpha=1 key-switch digits are unsigned, in [0, q_i), and their mean q_i/2
# times the key's noise lands on the slots whose root lies next to 1, about
# (n/π)·sqrt(l·n)·σ/Δ = 0.078 at n=16384, l=6, Δ≈2^26 (ROADMAP.md, Queue 3).
MAX_ERR_ROT = 2.0**-3
# ciphertexts of the batch replayed on the CPU through the plain versions
REPLAY_ROWS = 4
# K5 against numpy complex128, relative to max |X|
MAX_REL_ERR_FFT = 2.0**-44
# K5 timed against torch.fft.fft off the codec's [64, 8192]: (rows, m)
FFT_OTHER_SHAPES = ((130, 8192), (64, 16384))

# Peak rates of an H100 SXM at its 700 W limit, for the bound of each kernel:
HBM_BYTES_PER_S = 3.35e12  # data sheet
FP64_PER_S = 34e12  # data sheet, FP64 outside the tensor cores
INT32_PER_S = 132 * 64 * 1.98e9  # 64 INT32 lanes per SM (white paper), 132 SMs, 1.98 GHz
# uint32 operations of csrc/modarith.cuh: a forward (Cooley-Tukey) Shoup
# butterfly is shoup_mul_lazy (4) + add_lazy (3) + sub_lazy (4); an inverse
# (Gentleman-Sande) one add_lazy (3) + lo + 2q - hi (2) + shoup_mul_lazy
# (4), and in its last stage, n^-1 folded in, lo + hi (1) + shoup_mul_lazy
# (4) + lo + 2q - hi (2) + shoup_mul_lazy (4); a contraction step
# mont_mul_lazy (7) + add_lazy (3); an FP64 butterfly is 4 products and 6
# sums.
FWD_BUTTERFLY_OPS = 11
INV_BUTTERFLY_OPS = 9
INV_LAST_BUTTERFLY_OPS = 11
CONTRACT_OPS = 10
FFT_BUTTERFLY_FLOPS = 10


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, ops, ops_per_s):
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate, the larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return dict(bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes_ms=t_bytes * 1e3, bound_ops_ms=t_ops * 1e3)


def timed(call):
    """A kernel wrapper's call time (CUDA events around back-to-back Python
    calls, host work included) and its kernel's own device time (profiler)."""
    return dict(ms=device_time(call) * 1e3, kernel_ms=kernel_time(call, ours=True) * 1e3)


def ntt_ops(rows, n, inverse=False):
    """uint32 operations of `rows` forward (or inverse) NTTs of length n:
    log2 n stages of n/2 butterflies each."""
    stages = n.bit_length() - 1
    per_row = ((stages - 1) * INV_BUTTERFLY_OPS + INV_LAST_BUTTERFLY_OPS if inverse
               else stages * FWD_BUTTERFLY_OPS)
    return rows * (n // 2) * per_row


def lazy_residues(gen, shape, two_q):
    return torch.randint(0, 1 << 62, shape, generator=gen, device=gen.device) % two_q


def plain_ext_prod(ctx, digits, rgsw):
    """K3's plain version on strict digits [R, l, n]: broadcast each digit
    over the extended limbs, plain forward NTT, Montgomery contraction."""
    ids_ext = rgsw.limb_ids
    R, l, n = digits.shape
    tiled = digits[:, :, None, :].expand(R, l, len(ids_ext), n).contiguous()
    return plain_ext_prod_conv(ctx, tiled, rgsw)


def plain_ext_prod_conv(ctx, digits, rgsw):
    """K4's plain version on converted digits [R, D, L_ext, n]."""
    tabs = [ctx.device_rows(nm, rgsw.limb_ids, digits.device) for nm in nttmod.FWD_TABLES]
    return rgsw_mod.ks_contract(ctx, nttmod.ntt_fwd(digits, *tabs), rgsw)


def ext_tables(ctx, ids_ext, dev):
    return [ctx.device_rows(nm, ids_ext, dev, torch.int32)
            for nm in ("tw_fwd", "tw_fwd_sh", "q", "two_q", "neg_qinv")]


def fft_other_shapes(dev, gen):
    """K5 against torch.fft.fft kernel-only at shapes off the codec's path:
    a batch above one wave of row clusters and the largest m. Each checked
    bitwise against fft_plain first."""
    out = []
    for rows, m in FFT_OTHER_SHAPES:
        re, im = (torch.rand((rows, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
                  for _ in range(2))
        tw = fftmod._device_tables(m, str(dev))
        k, p = kernels.fft(re, im, *tw), fftmod.fft_plain(re, im, m)
        check(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]), f"K5 at [{rows}, {m}]")
        natural = torch.complex(re, im)
        rec = dict(rows=rows, m=m,
                   kernel_ms=kernel_time(lambda: kernels.fft(re, im, *tw), ours=True) * 1e3,
                   library_kernel_ms=kernel_time(lambda: torch.fft.fft(natural),
                                                 ours=False) * 1e3)
        rec["kernel_over_library"] = rec["kernel_ms"] / rec["library_kernel_ms"]
        print(f"[kernels] fft at [{rows}, {m}]: bitwise vs plain, kernel-only "
              f"{rec['kernel_ms']:.4f} ms, torch.fft.fft kernel-only "
              f"{rec['library_kernel_ms']:.4f} ms, ratio {rec['kernel_over_library']:.3f}")
        out.append(rec)
    return out


def kernels_vs_plain(ctx, hctx, dev):
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
    ntt_bytes = 2 * x32.numel() * 4

    k1 = nttmod.ntt(ctx, x, ids)
    p1 = nttmod.ntt_fwd(x, *fwd64)
    check(torch.equal(k1, p1), "K1 ntt_fwd differs from the plain chain")
    records["ntt_fwd"] = dict(
        route="cuda", source="hehub_tpu_torch/csrc/ntt.cu",
        replaces="hehub_tpu/ops/pallas/ntt_pallas.py:207",
        match="bitwise", max_abs_err=int((k1 - p1).abs().max()),
        **timed(lambda: kernels.ntt_fwd(x32, *fwd32)),
        plain_ms=device_time(lambda: nttmod.ntt_fwd(x, *fwd64), 1, 3) * 1e3,
        library_ms=None, **bound(ntt_bytes, ntt_ops(BATCH * LEVELS, N), INT32_PER_S),
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
        **timed(lambda: kernels.ntt_inv(x32, *inv32)),
        plain_ms=device_time(lambda: nttmod.ntt_inv(x, *inv64), 1, 3) * 1e3,
        library_ms=None,
        **bound(ntt_bytes, ntt_ops(BATCH * LEVELS, N, inverse=True), INT32_PER_S),
    )

    sk = rlwe_mod.keygen(ctx, gen)
    rlk = keys_mod.relin_key(ctx, sk, gen)
    digits = torch.stack(
        [torch.randint(0, m, (BATCH, N), generator=gen, device=dev) for m in ctx.moduli_of(ids)],
        dim=1,
    )  # strict coefficient digits [R, l, n]
    ext32 = ext_tables(ctx, ids_ext, dev)
    d32 = nttmod.to_u32_bits(digits)
    key32 = nttmod.to_u32_bits(rlk.data[:LEVELS])
    k3 = nttmod.from_u32_bits(kernels.ext_prod(d32, key32, *ext32))
    p3 = plain_ext_prod(ctx, digits, rlk)
    err3 = max(int((k3[0] - p3.c0.data).abs().max()), int((k3[1] - p3.c1.data).abs().max()))
    check(err3 == 0, "K3 ext_prod differs from ks_contract(ks_digits(...))")
    L_ext = len(ids_ext)
    records["ext_prod"] = dict(
        route="cuda", source="hehub_tpu_torch/csrc/extprod.cu",
        replaces="hehub_tpu/ops/pallas/extprod_pallas.py:27",
        match="bitwise", max_abs_err=err3,
        **timed(lambda: kernels.ext_prod(d32, key32, *ext32)),
        plain_ms=device_time(lambda: plain_ext_prod(ctx, digits, rlk), 1, 3) * 1e3,
        library_ms=None,
        **bound(4 * (d32.numel() + key32.numel() + 2 * BATCH * L_ext * N),
                ntt_ops(BATCH * LEVELS * L_ext, N) + BATCH * LEVELS * L_ext * N * 2 * CONTRACT_OPS,
                INT32_PER_S),
    )
    del digits, d32, k3, p3

    # K4 at the hybrid path's shape: D = 6 digits of the 12 limbs, 14 limbs out
    h_ids = tuple(range(len(hctx.params.moduli)))
    h_ext = h_ids + hctx.special_indices
    D = -(-len(h_ids) // ALPHA)
    h_sk = rlwe_mod.keygen(hctx, gen)
    h_rlk = keys_mod.relin_key(hctx, h_sk, gen, alpha=ALPHA)
    conv = lazy_residues(gen, (BATCH, D, len(h_ext), N), hctx.device_rows("two_q", h_ext, dev))
    h_ext32 = ext_tables(hctx, h_ext, dev)
    c32 = nttmod.to_u32_bits(conv)
    h_key32 = nttmod.to_u32_bits(h_rlk.data[:D])
    k4 = nttmod.from_u32_bits(kernels.ext_prod_conv(c32, h_key32, *h_ext32))
    p4 = plain_ext_prod_conv(hctx, conv, h_rlk)
    err4 = max(int((k4[0] - p4.c0.data).abs().max()), int((k4[1] - p4.c1.data).abs().max()))
    check(err4 == 0, "K4 ext_prod_conv differs from ks_contract(ntt(digits))")
    records["ext_prod_conv"] = dict(
        route="cuda", source="hehub_tpu_torch/csrc/extprod.cu",
        replaces="hehub_tpu/ops/pallas/extprod_pallas.py:52",
        match="bitwise", max_abs_err=err4,
        **timed(lambda: kernels.ext_prod_conv(c32, h_key32, *h_ext32)),
        plain_ms=device_time(lambda: plain_ext_prod_conv(hctx, conv, h_rlk), 1, 3) * 1e3,
        library_ms=None,
        **bound(4 * (c32.numel() + h_key32.numel() + 2 * BATCH * len(h_ext) * N),
                ntt_ops(c32.numel() // N, N) + c32.numel() * 2 * CONTRACT_OPS, INT32_PER_S),
    )
    del conv, c32, k4, p4

    # K5 at the codec's shape: [64, 8192] complex rows in bit-reversed order
    m = N // 2
    re = torch.rand((BATCH, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
    im = torch.rand((BATCH, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
    tw_re, tw_im = fftmod._device_tables(m, str(dev))
    k5 = kernels.fft(re, im, tw_re, tw_im)
    p5 = fftmod.fft_plain(re, im, m)
    err5 = max(float((k5[0] - p5[0]).abs().max()), float((k5[1] - p5[1]).abs().max()))
    check(err5 == 0.0, "K5 fft differs from fft_plain")
    br = torch.from_numpy(fftmod.bitrev_perm(m)).to(dev)
    natural = torch.complex(re[:, br], im[:, br])  # the bit reversal is an involution
    exact = np.fft.fft(natural[:REPLAY_ROWS].cpu().numpy(), axis=-1)
    got = (k5[0][:REPLAY_ROWS] + 1j * k5[1][:REPLAY_ROWS]).cpu().numpy()
    rel5 = float(np.abs(got - exact).max() / np.abs(exact).max())
    check(rel5 <= MAX_REL_ERR_FFT, f"K5 error {rel5} relative to max|X| above 2^-44")
    records["fft"] = dict(
        route="cuda", source="hehub_tpu_torch/csrc/fft.cu",
        replaces="hehub_tpu/ops/pallas/fft_pallas.py:60",
        match=f"bitwise vs plain; vs numpy complex128 {rel5:.3e} of max|X|",
        max_abs_err=err5,
        **timed(lambda: kernels.fft(re, im, tw_re, tw_im)),
        plain_ms=device_time(lambda: fftmod.fft_plain(re, im, m), 1, 3) * 1e3,
        library_ms=device_time(lambda: torch.fft.fft(natural)) * 1e3,
        library_kernel_ms=kernel_time(lambda: torch.fft.fft(natural), ours=False) * 1e3,
        **bound(4 * re.numel() * 8 + 2 * tw_re.numel() * 8,
                BATCH * (m // 2) * (m.bit_length() - 1) * FFT_BUTTERFLY_FLOPS, FP64_PER_S),
        other_shapes=fft_other_shapes(dev, gen),
    )

    conv_ms = dict(
        to_u32_ms=device_time(lambda: nttmod.to_u32_bits(x)) * 1e3,
        from_u32_ms=device_time(lambda: nttmod.from_u32_bits(x32)) * 1e3,
        key_to_u32_ms=device_time(lambda: nttmod.to_u32_bits(rlk.data[:LEVELS])) * 1e3,
    )
    for name, rec in records.items():
        check(rec["max_abs_err"] == 0, f"{name} is not bitwise equal to its plain version")
        rec.setdefault("library_kernel_ms", None)
        rec["kernel_over_bound"] = rec["kernel_ms"] / rec["bound_ms"]
        rec["kernel_over_library"] = (rec["kernel_ms"] / rec["library_kernel_ms"]
                                      if rec["library_kernel_ms"] else None)
        print(f"[kernels] {name}: {rec['match']}, max_abs_err={rec['max_abs_err']}, "
              f"kernel-only {rec['kernel_ms']:.4f} ms, call {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
              f"(bytes {rec['bound_bytes_ms']:.4f} ms, operations {rec['bound_ops_ms']:.4f} ms), "
              f"kernel-only / bound {rec['kernel_over_bound']:.3f}, "
              f"library call {rec['library_ms']} ms, library kernel-only "
              f"{rec['library_kernel_ms']} ms, kernel-only / library kernel-only "
              f"{rec['kernel_over_library']}")
    print(f"[kernels] int64<->int32 conversions at [{BATCH},{LEVELS},{N}]: {json.dumps(conv_ms)}")
    return records


def ntt_row_sweep(hctx, dev, path_rows):
    """Phase 3, second part, run after phases 4 and 5 because their records
    give its shapes: K1 and K2 at n=N at every row count the paths launched
    them with ([rows / L, L, N], the rows spread over as many of the hybrid
    context's 14 limbs as divide them), each bitwise against its plain
    chain, then timed per call (CUDA events) and kernel-only. Returns
    {kernel: {rows: record}}."""
    ids_all = tuple(range(len(hctx.params.moduli))) + hctx.special_indices
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for kind, names, plain, launch in (
            ("ntt_fwd", nttmod.FWD_TABLES, nttmod.ntt_fwd, kernels.ntt_fwd),
            ("ntt_inv", nttmod.INV_TABLES, nttmod.ntt_inv, kernels.ntt_inv)):
        out[kind] = {}
        for rows in sorted(set().union(*(rec[kind] for rec in path_rows))):
            L = max(l for l in range(1, len(ids_all) + 1) if rows % l == 0)
            ids = ids_all[:L]
            x = lazy_residues(gen, (rows // L, L, N), hctx.device_rows("two_q", ids, dev))
            tabs32 = [hctx.device_rows(nm, ids, dev, torch.int32) for nm in names]
            x32 = nttmod.to_u32_bits(x)
            got = nttmod.from_u32_bits(launch(x32, *tabs32))
            want = plain(x, *(hctx.device_rows(nm, ids, dev) for nm in names))
            check(torch.equal(got, want), f"{kind} at {rows} rows differs from the plain chain")
            rec = dict(limbs=L, **timed(functools.partial(launch, x32, *tabs32)),
                       **bound(2 * rows * N * 4, ntt_ops(rows, N, kind == "ntt_inv"),
                               INT32_PER_S))
            rec["kernel_over_bound"] = rec["kernel_ms"] / rec["bound_ms"]
            out[kind][rows] = rec
            del x, got, want
    for kind in out:
        for rows, rec in out[kind].items():
            print(f"[kernels] {kind} at [{rows // rec['limbs']}, {rec['limbs']}, {N}] ({rows} "
                  f"rows): bitwise vs plain, kernel-only {rec['kernel_ms']:.4f} ms, call "
                  f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}, "
                  f"kernel-only / bound {rec['kernel_over_bound']:.3f}")
    return out


def weighted_ms(rows_record, times):
    """Σ over the launches of a {rows: launches} record of the kernel-only
    ms at their row count."""
    return sum(count * times[rows]["kernel_ms"] for rows, count in rows_record.items())


def launch_weighted(sweep, path_rows, path_steps):
    """The kernel-only time of each kernel's launches, summed with the times
    of the row-count sweep: per path run, per step, and over both paths."""
    out = {}
    for kind, times in sweep.items():
        rec = {tag: weighted_ms(path_rows[tag][kind], times) for tag in path_rows}
        rec["both_paths"] = sum(rec.values())
        rec["steps"] = {f"{tag} {step}": weighted_ms(r[kind], times)
                        for tag, steps in path_steps.items() for step, r in steps.items()}
        out[kind] = rec
        print(f"[kernels] {kind} launch-weighted kernel-only ms: {json.dumps(rec)}")
    return out


def _rows_on_cpu(ct, rows):
    take = lambda p: RnsPoly(p.data[:rows].cpu(), p.form, p.limb_ids)  # noqa: E731
    return ckks.CkksCt(take(ct.c0), take(ct.c1), ct.scaling_factor)


def _key_on_cpu(k):
    return rgsw_mod.RgswCt(k.data.cpu(), k.limb_ids, k.alpha)


def _decode_on_cpu(ctx, params, ct, sk):
    """Decode through the device codec's plain version on the CPU."""
    sk_c = rlwe_mod.RlweSk(sk.coeffs.cpu(), sk.ntt.cpu(), sk.ntt_sh.cpu())
    old, config.use_device_codec = config.use_device_codec, True
    try:
        return ckks.decode(ckks.decrypt(ctx, ct, sk_c), params)
    finally:
        config.use_device_codec = old


def cpu_replay(tag, ctx, params, ca, cb, rlk, rk, sk, card_cts, out):
    """The path's homomorphic steps again, on the CPU through the plain
    versions, for the first REPLAY_ROWS ciphertexts: the card's ciphertexts
    (mult + rescale, then rotate(1)) must be bitwise equal, and decoding the
    rotated one through the device codec's plain version must give the card's
    slots to 1e-12."""
    prod_c = ckks.rescale(ctx, ckks.mult(ctx, _rows_on_cpu(ca, REPLAY_ROWS),
                                         _rows_on_cpu(cb, REPLAY_ROWS), _key_on_cpu(rlk)))
    rot_c = ckks.rotate(ctx, prod_c, _key_on_cpu(rk), 1)
    for got, card in zip((prod_c, rot_c), card_cts):
        card = _rows_on_cpu(card, REPLAY_ROWS)
        check(torch.equal(got.c0.data, card.c0.data) and torch.equal(got.c1.data, card.c1.data),
              f"{tag}: the card's ciphertexts differ from the plain CPU path")
    out_c = _decode_on_cpu(ctx, params, rot_c, sk)
    diff = float(np.abs(out_c - out[:REPLAY_ROWS]).max())
    check(diff <= 1e-12, f"{tag}: decoded slots differ from the plain CPU path by {diff}")
    print(f"[{tag}] plain CPU replay of {REPLAY_ROWS} ciphertexts: bitwise equal ciphertexts, "
          f"decoded slots within {diff:.3e} of the card's")


def run_path(tag, params, ctx, dev, alpha, seed):
    """Keygen, keys, encode + encrypt, mult + relin + rescale, rotate(1),
    decrypt + decode, between a reset and a read of the launch counts.
    Returns (launches, errors, state for the replay and the timings)."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (BATCH, N // 2))
    b = rng.uniform(-1, 1, (BATCH, N // 2))
    gen = torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sk = rlwe_mod.keygen(ctx, gen)
    rlk = keys_mod.relin_key(ctx, sk, gen, alpha=alpha)
    rk = keys_mod.rot_key(ctx, sk, 1, gen, alpha=alpha)
    ca = ckks.encrypt(ctx, ckks.encode(a, params, device=dev), sk, gen)
    cb = ckks.encrypt(ctx, ckks.encode(b, params, device=dev), sk, gen)
    prod = ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk))
    rot = ckks.rotate(ctx, prod, rk, 1)
    out_prod = ckks.decode(ckks.decrypt(ctx, prod, sk), params)
    out = ckks.decode(ckks.decrypt(ctx, rot, sk), params)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rows = {k: dict(kernels.LAUNCH_ROWS[k]) for k in NTT_KERNELS}

    L = len(params.moduli)
    check(out.shape == (BATCH, N // 2), f"{tag}: decoded shape {out.shape}")
    check(bool(np.isfinite(out).all() and np.isfinite(out_prod).all()),
          f"{tag}: decoded values not finite")
    check(rot.limb_ids == tuple(range(L - 1)), f"{tag}: result limbs {rot.limb_ids}")
    err_mult = float(np.abs(out_prod - a * b).max())
    err_rot = float(np.abs(out - np.roll(a * b, 1, axis=-1)).max())
    print(f"[{tag}] n={N} L={L}+{len(params.special_mods)} alpha={alpha} batch={BATCH}: "
          f"keygen..decode {wall:.3f} s (host clock), max|err| of mult+rescale vs a*b = "
          f"{err_mult:.3e} (log2 {np.log2(err_mult):.2f}), of rotate(mult, 1) vs "
          f"np.roll(a*b, 1) = {err_rot:.3e} (log2 {np.log2(err_rot):.2f}), "
          f"launches {json.dumps(launches)}")
    print(f"[{tag}] K1/K2 launches by rows {{rows: launches}}, keygen..decode: {json.dumps(rows)}")
    state = dict(a=a, b=b, gen=gen, sk=sk, rlk=rlk, rk=rk, ca=ca, cb=cb, prod=prod, rot=rot,
                 out=out, rows=rows)
    return launches, err_mult, err_rot, state


def step_rows(tag, steps):
    """The rows of each K1/K2 launch in one call of each step:
    {step: {kernel: {rows: launches}}}."""
    out = {}
    for name, fn in steps.items():
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        fn()
        out[name] = {k: dict(kernels.LAUNCH_ROWS[k]) for k in NTT_KERNELS}
    print(f"[{tag}] K1/K2 launches by rows, one batch-64 call of each step: {json.dumps(out)}")
    return out


def main_path(params, ctx, dev):
    """Phase 4: returns (launch counts of the run, K1/K2 launches by rows of
    the run, the same of each step)."""
    launches, err_mult, err_rot, s = run_path("main", params, ctx, dev, 1, 0)
    check(err_mult <= MAX_ERR_MULT, f"mult decode error {err_mult} above {MAX_ERR_MULT}")
    check(err_rot <= MAX_ERR_ROT, f"rotate decode error {err_rot} above {MAX_ERR_ROT}")
    for name in ("ntt_fwd", "ntt_inv", "ext_prod", "fft"):
        check(launches[name] > 0, f"kernel {name} was not launched on the main path")
    cpu_replay("main", ctx, params, s["ca"], s["cb"], s["rlk"], s["rk"], s["sk"],
               (s["prod"], s["rot"]), s["out"])

    ids = tuple(range(LEVELS))
    a, sk, gen, ca, cb, prod, rot = (s[k] for k in ("a", "sk", "gen", "ca", "cb", "prod", "rot"))
    rlk, rk = s["rlk"], s["rk"]
    encode_encrypt = lambda: ckks.encrypt(ctx, ckks.encode(a, params, device=dev), sk, gen)  # noqa: E731
    decrypt_decode = lambda: ckks.decode(ckks.decrypt(ctx, rot, sk), params)  # noqa: E731
    x = ca.c0.data
    transforms = BATCH * LEVELS
    metrics = dict(
        ntt_fwd_us_per_transform=device_time(lambda: nttmod.ntt(ctx, x, ids)) * 1e6 / transforms,
        intt_us_per_transform=device_time(lambda: nttmod.intt(ctx, x, ids)) * 1e6 / transforms,
        ckks_mult_ms_per_op=device_time(
            lambda: ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk)), 1, 5) * 1e3 / BATCH,
        ckks_rotate_ms_per_op=device_time(lambda: ckks.rotate(ctx, prod, rk, 1), 1, 5)
        * 1e3 / BATCH,
        ckks_encode_encrypt_ms=device_time(encode_encrypt, 1, 4) * 1e3 / BATCH,
        ckks_decrypt_decode_ms=device_time(decrypt_decode, 1, 4) * 1e3 / BATCH,
        ckks_encode_encrypt_host_ms=step_time(encode_encrypt) * 1e3 / BATCH,
        ckks_decrypt_decode_host_ms=step_time(decrypt_decode) * 1e3 / BATCH,
        mult_max_abs_err=err_mult,
        rotate_max_abs_err=err_rot,
    )
    print("[main] times (CUDA events per transform or per ciphertext of a batch-64 call; "
          "*_host_ms: host clock, per ciphertext): " + json.dumps(metrics))
    steps = {
        "encode+encrypt": encode_encrypt,
        "decrypt+decode": decrypt_decode,
        "mult+relin+rescale": lambda: ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk)),
        "rotate(1)": lambda: ckks.rotate(ctx, prod, rk, 1),
    }
    print_traces("main", steps)
    return launches, s["rows"], step_rows("main", steps)


def print_traces(tag, steps):
    for name, fn in steps.items():
        print(f"[{tag}] torch.profiler trace of one batch-64 {name}: "
              f"{json.dumps(device_trace(fn))}")


def hybrid_path(dev):
    """Phase 5: the hybrid key-switching path over the full budget. Returns
    what main_path returns."""
    params = create_ckks_params(N, scaling_bits=28, num_special=HYBRID_SPECIAL)
    ctx = make_context(params)
    launches, err_mult, err_rot, s = run_path("hybrid", params, ctx, dev, ALPHA, 5)
    check(err_mult <= MAX_ERR_MULT, f"hybrid mult decode error {err_mult} above {MAX_ERR_MULT}")
    check(err_rot <= MAX_ERR_MULT, f"hybrid rotate decode error {err_rot} above {MAX_ERR_MULT}")
    for name in ("ntt_fwd", "ntt_inv", "ext_prod_conv", "fft"):
        check(launches[name] > 0, f"kernel {name} was not launched on the hybrid path")
    cpu_replay("hybrid", ctx, params, s["ca"], s["cb"], s["rlk"], s["rk"], s["sk"],
               (s["prod"], s["rot"]), s["out"])
    ca, cb, prod, rlk, rk = (s[k] for k in ("ca", "cb", "prod", "rlk", "rk"))
    metrics = dict(
        ckks_mult_ms_per_op_hybrid=device_time(
            lambda: ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk)), 1, 5) * 1e3 / BATCH,
        ckks_rotate_ms_per_op_hybrid=device_time(lambda: ckks.rotate(ctx, prod, rk, 1), 1, 5)
        * 1e3 / BATCH,
        mult_max_abs_err_hybrid=err_mult,
        rotate_max_abs_err_hybrid=err_rot,
    )
    print("[hybrid] times (CUDA events, per ciphertext of a batch-64 call): "
          + json.dumps(metrics))
    steps = {
        "mult+relin+rescale": lambda: ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk)),
        "rotate(1)": lambda: ckks.rotate(ctx, prod, rk, 1),
    }
    print_traces("hybrid", steps)
    return launches, s["rows"], step_rows("hybrid", steps)


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
        if "registers" in line or "spill" in line or "error" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")

    params = create_ckks_params(N, scaling_bits=28, num_levels=LEVELS)
    ctx = make_context(params)
    hctx = make_context(create_ckks_params(N, scaling_bits=28, num_special=HYBRID_SPECIAL))
    records = kernels_vs_plain(ctx, hctx, dev)
    torch.cuda.empty_cache()
    main_launches, main_rows, main_steps = main_path(params, ctx, dev)
    torch.cuda.empty_cache()
    hybrid_launches, hybrid_rows, hybrid_steps = hybrid_path(dev)
    torch.cuda.empty_cache()
    sweep = ntt_row_sweep(hctx, dev, (main_rows, hybrid_rows))
    weighted = launch_weighted(sweep, {"main": main_rows, "hybrid": hybrid_rows},
                               {"main": main_steps, "hybrid": hybrid_steps})
    for k, rec in records.items():
        rec["launches"] = main_launches[k] + hybrid_launches[k]
        rec["launches_by_path"] = {"main": main_launches[k], "hybrid": hybrid_launches[k]}
        check(rec["launches"] > 0, f"kernel {k} was launched on no path")
    for k in NTT_KERNELS:
        records[k]["by_rows"] = [
            dict(rows=rows, launches_main=main_rows[k].get(rows, 0),
                 launches_hybrid=hybrid_rows[k].get(rows, 0), **rec)
            for rows, rec in sweep[k].items()]
        records[k]["launch_weighted_kernel_ms"] = weighted[k]
    print(json.dumps({"kernels": [dict(name=k, **rec) for k, rec in records.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
