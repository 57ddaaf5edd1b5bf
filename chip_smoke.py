#!/usr/bin/env python3
"""The kernel table of hehub_tpu_torch on one NVIDIA card (H100): builds the
CUDA kernels, then measures every hand-written kernel alone at the shapes
that PERF.md §6's table of kernels names, one entry of TABLE for each row.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi); no card, no run;
  2. build: nvcc of hehub_tpu_torch/csrc/*.cu for sm_90a, and g++ of the
     host runtime (csrc/host/hehub_native.cpp), timed;
  3. the table: for each entry of TABLE and each of its shapes, the kernel
     (or the route by parts that runs it above one launch's row) on random
     card tensors, held bitwise against its plain PyTorch version on the
     same tensors (K5 also against numpy complex128), then timed by
     `measure`: kernel-only (per call, from a torch.profiler trace: each
     kernel's mean interval times its launches a call), per call (CUDA
     events around back-to-back wrapper calls, host work included), the
     plain version per call, the bound (the least time the card could take:
     bytes over the memory rate or operations over the peak rate, the
     larger) and the ratio of kernel-only time to it; K5 also beside
     torch.fft.fft on the same values, per call and kernel-only;
  last, a `kernels` JSON line (a record for each entry, its other shapes
  nested under their keys), the card line and the result line
  {"ok": true, "device": {...}}.

Correctness of the paths on the card lives in the `cuda` tests (`python -m
pytest --noconftest -m cuda tests/test_torch_*.py`), end-to-end speed in
the benchmark (`hebench/run.py`). Any failure raises, and the script exits
non-zero without a result line. A kernel-only time is read from a window of
the profiler's trace that begins after a lead-in of small kernels; where the
profiler still lost a kernel's records in three traces, that time is null
in its record, with the fault beside it (`*_profiler_fault`), and fails no
check unless more than half of the records lack it.
"""

import dataclasses
import functools
import json
import subprocess
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.circuits import bootstrap as bs
from hehub_tpu_torch.core import basecnv
from hehub_tpu_torch.core.context import RlweParams, create_ckks_params, make_context
from hehub_tpu_torch.core.rns import COEFF, NTT, RnsPoly
from hehub_tpu_torch.models import tfhe
from hehub_tpu_torch.native import loader as native_loader
from hehub_tpu_torch.ops import fft as fftmod
from hehub_tpu_torch.ops import modarith
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod
from hehub_tpu_torch.utils import hostmath as hm
from hehub_tpu_torch.utils.profiling import ProfilerFault, device_time, kernel_time

# K5 against numpy complex128 on the first rows of [64, 8192], relative to max |X|
MAX_REL_ERR_FFT = 2.0**-44
NUMPY_ROWS = 4
# a plain version slower than this (host seconds of its checked call) is timed once
SLOW_PLAIN_S = 0.5

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
# sums; ModUp, per source coefficient shoup_mul_lazy (4) + reduce_strict
# (2) + z (3) + the carry (3), per output of a group of K limbs K + 1
# shoup_mul_lazy (4) + K - 1 add_lazy (3) + sub_lazy (4).
FWD_BUTTERFLY_OPS = 11
INV_BUTTERFLY_OPS = 9
INV_LAST_BUTTERFLY_OPS = 11
CONTRACT_OPS = 10
MODUP_SRC_OPS = 12
# ModDown: the lift's centred remainder of a correction word (reduce_strict
# 2, the compare, select and add 3), per dropped source coefficient its fold
# (2) and per pair of a step and a lower dropped limb the remainder (5),
# sub_lazy (3), shoup_mul_lazy (4) and the fold (2); the apply's sub_lazy (3)
# and shoup_mul_lazy (4) a step of an output word
MODDOWN_LIFT_OPS = 5
MODDOWN_WALK_OPS = 14
MODDOWN_APPLY_OPS = 7
# the tensor product: two shoup_mul_lazy (4), four mont_mul_lazy (7) and one
# add_lazy (3) a coefficient
TENSOR_PRODUCT_OPS = 39
FFT_BUTTERFLY_FLOPS = 10


# each kernel's CUDA source and the TPU kernel it replaces
ORIGIN = {
    "ntt_fwd": ("hehub_tpu_torch/csrc/ntt.cu", "hehub_tpu/ops/pallas/ntt_pallas.py:207"),
    "ntt_inv": ("hehub_tpu_torch/csrc/ntt.cu", "hehub_tpu/ops/pallas/ntt_pallas.py:215"),
    "ext_prod": ("hehub_tpu_torch/csrc/extprod.cu", "hehub_tpu/ops/pallas/extprod_pallas.py:27"),
    "ext_prod_conv": ("hehub_tpu_torch/csrc/extprod.cu",
                      "hehub_tpu/ops/pallas/extprod_pallas.py:52"),
    "fft": ("hehub_tpu_torch/csrc/fft.cu", "hehub_tpu/ops/pallas/fft_pallas.py:60"),
    # the port's own kernel: the jnp stage after each ppermute of the
    # reference's sharded NTT, not a Pallas kernel
    "ntt_stage": ("hehub_tpu_torch/csrc/ntt.cu", "hehub_tpu/parallel/ntt_sharded.py:135"),
    # the port's own kernel: one stage of the FFT's later stages, which the
    # reference runs as df64.fft_xla's XLA chain, not a Pallas kernel
    "fft_stage": ("hehub_tpu_torch/csrc/fft.cu", "hehub_tpu/ops/df64.py:260"),
    # the port's own kernel: ModUp, the reference's jnp base_convert of each
    # digit group (hehub_tpu/rlwe/rgsw.py:189), not a Pallas kernel
    "modup": ("hehub_tpu_torch/csrc/basecnv.cu", "hehub_tpu/core/basecnv.py:131"),
    # the port's own kernels: ModDown's lift and apply around K2 and K1, the
    # reference's jnp div_last_rounded once a dropped limb, not a Pallas kernel
    "moddown": ("hehub_tpu_torch/csrc/basecnv.cu", "hehub_tpu/core/basecnv.py:47"),
    # the port's own kernel: the reference's jnp tensor product of a
    # ciphertext product (mult_low_level), not a Pallas kernel
    "tensor_product": ("hehub_tpu_torch/csrc/modarith.cu", "hehub_tpu/models/ckks.py:638"),
}


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


def kernel_only(call, ours=True, key="kernel_ms"):
    """{key: the kernel-only ms of `call` (profiler)}; where the profiler
    lost the trace's records, {key: None, key's fault: what was lost}."""
    try:
        return {key: kernel_time(call, ours=ours) * 1e3}
    except ProfilerFault as err:
        return {key: None, key.replace("_ms", "_profiler_fault"): str(err)}


def ratio(a, b):
    return a / b if a is not None and b else None


def ntt_ops(rows, n, inverse=False):
    """uint32 operations of `rows` forward (or inverse) NTTs of length n:
    log2 n stages of n/2 butterflies each."""
    stages = n.bit_length() - 1
    per_row = ((stages - 1) * INV_BUTTERFLY_OPS + INV_LAST_BUTTERFLY_OPS if inverse
               else stages * FWD_BUTTERFLY_OPS)
    return rows * (n // 2) * per_row


def lazy_residues(gen, shape, two_q):
    return torch.randint(0, 1 << 62, shape, generator=gen, device=gen.device) % two_q


def strict_residues(ctx, gen, R, ids):
    """Strict coefficient-form limbs [R, len(ids), n]."""
    n = ctx.params.dimension
    return torch.stack([torch.randint(0, m, (R, n), generator=gen, device=gen.device)
                        for m in ctx.moduli_of(ids)], dim=1)


def plain_ext_prod(ctx, digits, rgsw):
    """K3's plain version on strict digits [R, l, n]: broadcast each digit
    over the extended limbs, plain forward NTT, Montgomery contraction."""
    R, l, n = digits.shape
    tiled = digits[:, :, None, :].expand(R, l, len(rgsw.limb_ids), n).contiguous()
    return plain_ext_prod_conv(ctx, tiled, rgsw)


def plain_ext_prod_conv(ctx, digits, rgsw):
    """K4's plain version on converted digits [R, D, L_ext, n]."""
    tabs = [ctx.device_rows(nm, rgsw.limb_ids, digits.device) for nm in nttmod.FWD_TABLES]
    return rgsw_mod.ks_contract(ctx, nttmod.ntt_fwd(digits, *tabs), rgsw)


def _words(out):
    """A kernel's or a plain version's output as int64 / float64 tensors:
    int32 bits widened, a ciphertext's halves stacked."""
    if hasattr(out, "c0"):
        out = torch.stack([out.c0.data, out.c1.data])
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    return [nttmod.from_u32_bits(t) if t.dtype == torch.int32 else t for t in outs]


def max_abs_err(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(_words(got), _words(want)))


@dataclasses.dataclass
class Case:
    """One shape of one kernel: the timed call, its plain version on the
    same card tensors (None: no plain version of its own), and the bytes
    and operations of its bound."""
    shape: str
    kernel: Callable[[], object]
    plain: Optional[Callable[[], object]]
    nbytes: int
    ops: int
    peak: float = INT32_PER_S
    # the checked output, where the timed call works in place
    got: Optional[Callable[[], object]] = None
    # torch.fft.fft on the same values
    library: Optional[Callable[[], object]] = None
    # more of the record (K5's numpy error), after the bitwise check
    extra: Optional[Callable[[], dict]] = None


def measure(case: Case) -> dict:
    """The case's kernel bitwise against its plain version, then its times
    beside its bound (and the library's)."""
    rec = dict(shape=case.shape)
    if case.plain is not None:
        got = (case.got or case.kernel)()
        t0 = time.perf_counter()
        want = case.plain()
        torch.cuda.synchronize()
        slow = time.perf_counter() - t0 > SLOW_PLAIN_S
        rec["max_abs_err"] = max_abs_err(got, want)
        del got, want
        check(rec["max_abs_err"] == 0,
              f"{case.shape} is not bitwise equal to its plain version ({rec['max_abs_err']})")
        rec["plain_ms"] = device_time(case.plain, *((0, 1) if slow else (1, 3))) * 1e3
    if case.extra is not None:
        rec.update(case.extra())
    rec.update(ms=device_time(case.kernel) * 1e3, **kernel_only(case.kernel),
               library_ms=None, library_kernel_ms=None,
               **bound(case.nbytes, case.ops, case.peak))
    if case.library is not None:
        rec["library_ms"] = device_time(case.library) * 1e3
        rec.update(kernel_only(case.library, False, "library_kernel_ms"))
    rec["kernel_over_bound"] = ratio(rec["kernel_ms"], rec["bound_ms"])
    rec["kernel_over_library"] = ratio(rec["kernel_ms"], rec["library_kernel_ms"])
    return rec


# ---------------------------------------------------------------------------
# The cases, one function a kind of kernel
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def ckks_ctx(n, levels, special=1):
    return make_context(create_ckks_params(n, 28, levels, use_security_budget=False,
                                           num_special=special))


@functools.lru_cache(maxsize=None)
def boot_ctx(n, levels, special):
    return make_context(bs.make_boot_params(n, levels, num_special=special))


@functools.lru_cache(maxsize=None)
def tfhe_ctx():
    return make_context(tfhe.PRESET_GATE_128.rlwe_params)


@functools.lru_cache(maxsize=None)
def top_ctx():
    """The top ring kernels.MAX_N, which has one NTT prime: every limb is it."""
    return make_context(RlweParams(dimension=kernels.MAX_N,
                                   moduli=(hm.gen_ntt_primes(30, 1, kernels.MAX_N)[0],)))


def _ext_ids(ctx, l):
    """The source limbs of l digits and the extended limbs they reach."""
    if ctx.params.dimension == kernels.MAX_N:
        return (0,) * l, (0,) * (l + 1)
    ids = tuple(range(l))
    return ids, ids + ctx.special_indices


def ntt_case(ctx, gen, R, L, inverse=False):
    """K1 (K2 if `inverse`) on lazy residues [R, L, n]; above
    kernels.MAX_ROW_N ops.ntt's route (the stage kernel, then K1 / K2 on
    parts)."""
    dev, n = gen.device, ctx.params.dimension
    ids = tuple(range(L))
    names = nttmod.INV_TABLES if inverse else nttmod.FWD_TABLES
    x = lazy_residues(gen, (R, L, n), ctx.device_rows("two_q", ids, dev))
    t64 = [ctx.device_rows(nm, ids, dev) for nm in names]
    plain = nttmod.ntt_inv if inverse else nttmod.ntt_fwd
    if n <= kernels.MAX_ROW_N:
        split = nttmod.INV_SPLIT_TABLES if inverse else nttmod.FWD_SPLIT_TABLES
        t32 = [ctx.device_rows(nm, ids, dev, torch.int32)
               for nm in (names if n <= kernels.NTT_SUB_N else split)]
        x32 = nttmod.to_u32_bits(x)
        launch = kernels.ntt_inv if inverse else kernels.ntt_fwd
        call = lambda: launch(x32, *t32)  # noqa: E731
    else:
        call = lambda: (nttmod.intt if inverse else nttmod.ntt)(ctx, x, ids)  # noqa: E731
    return Case(f"[{R}, {L}, {n}]", call, lambda: plain(x, *t64), 2 * R * L * n * 4,
                ntt_ops(R * L, n, inverse))


def _random_key(ctx, gen, rows, ids_ext):
    n = ctx.params.dimension
    return rgsw_mod.RgswCt(lazy_residues(gen, (rows, 2, len(ids_ext), n),
                                         ctx.device_rows("two_q", ids_ext, gen.device)), ids_ext)


def _by_rows(plain, R):
    """A plain version run one row of R at a time (its memory), the rows
    joined as the kernel's output [2, R, ...]."""
    return lambda: torch.cat([_words(plain(r))[0] for r in range(R)], dim=1)


def _ext_bound(R, D, L_ext, n, digit_words):
    return dict(nbytes=4 * (digit_words + D * 2 * L_ext * n + 2 * R * L_ext * n),
                ops=ntt_ops(R * D * L_ext, n) + R * D * L_ext * n * 2 * CONTRACT_OPS)


def ext_case(ctx, gen, R, l):
    """K3 on strict digits [R, l, n] with l random key rows; above
    kernels.MAX_ROW_N rgsw.ext_prod_strict (digits and key to int32, the
    stage kernel, K4 on parts) against its plain twin ext_prod_parts."""
    dev, n = gen.device, ctx.params.dimension
    ids, ids_ext = _ext_ids(ctx, l)
    digits = strict_residues(ctx, gen, R, ids)
    key = _random_key(ctx, gen, l, ids_ext)
    if n <= kernels.MAX_ROW_N:
        names = nttmod.EXT_TABLES if n <= kernels.EXT_SUB_N else nttmod.EXT_SPLIT_TABLES
        tabs = [ctx.device_rows(nm, ids_ext, dev, torch.int32) for nm in names]
        d32, k32 = nttmod.to_u32_bits(digits), nttmod.to_u32_bits(key.data)
        call = lambda: kernels.ext_prod(d32, k32, *tabs)  # noqa: E731
        plain = _by_rows(lambda r: plain_ext_prod(ctx, digits[r:r + 1], key), R)
    else:
        d = RnsPoly(digits, COEFF, ids)
        call = lambda: rgsw_mod.ext_prod_strict(ctx, d, key)  # noqa: E731
        plain = _by_rows(lambda r: rgsw_mod.ext_prod_parts(
            ctx, RnsPoly(digits[r:r + 1], COEFF, ids), key, kernels.MAX_ROW_N, False), R)
    return Case(f"R={R}, l={l}, L_ext={len(ids_ext)}, n={n}", call, plain,
                **_ext_bound(R, l, len(ids_ext), n, R * l * n))


def ext_conv_case(ctx, gen, R, D, l):
    """K4 on lazy converted digits [R, D, L_ext, n] with random key rows of
    l source limbs; above kernels.MAX_ROW_N rgsw.ext_prod_digits (the
    stage kernel in place, then K4 on parts) against its plain twin."""
    dev, n = gen.device, ctx.params.dimension
    _, ids_ext = _ext_ids(ctx, l)
    L_ext = len(ids_ext)
    digits = lazy_residues(gen, (R, D, L_ext, n), ctx.device_rows("two_q", ids_ext, dev))
    key = _random_key(ctx, gen, D, ids_ext)
    k32, d32 = nttmod.to_u32_bits(key.data), nttmod.to_u32_bits(digits)
    got = None
    if n <= kernels.MAX_ROW_N:
        names = nttmod.EXT_TABLES if n <= kernels.EXT_SUB_N else nttmod.EXT_SPLIT_TABLES
        tabs = [ctx.device_rows(nm, ids_ext, dev, torch.int32) for nm in names]
        call = lambda: kernels.ext_prod_conv(d32, k32, *tabs)  # noqa: E731
        plain = _by_rows(lambda r: plain_ext_prod_conv(ctx, digits[r:r + 1], key), R)
    else:
        route = rgsw_mod.parts_route(ctx, ids_ext, n, kernels.MAX_ROW_N, dev, True)
        plain_route = rgsw_mod.parts_route(ctx, ids_ext, n, kernels.MAX_ROW_N, dev, False)
        # the cross stages run in place: the timed calls take the previous
        # call's digits, lazy residues as well
        call = lambda: rgsw_mod.ext_prod_digits(d32, k32, route, True)  # noqa: E731
        got = lambda: rgsw_mod.ext_prod_digits(d32.clone(), k32, route, True)  # noqa: E731
        plain = _by_rows(lambda r: rgsw_mod.ext_prod_digits(digits[r:r + 1], key.data,
                                                             plain_route, False), R)
    return Case(f"R={R}, D={D}, L_ext={L_ext}, n={n}", call, plain, got=got,
                **_ext_bound(R, D, L_ext, n, digits.numel()))


def fft_case(gen, R, m, numpy_rows=0):
    """K5 on [R, m] (ops.fft.fft above kernels.MAX_FFT_M: K5 on parts, then
    F) against fft_plain and beside torch.fft.fft; with numpy_rows, the
    first rows also against numpy's complex128 FFT."""
    dev = gen.device
    re, im = (torch.rand((R, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
              for _ in range(2))
    tw = fftmod._device_tables(m, str(dev))
    if m <= kernels.MAX_FFT_M:
        call = lambda: kernels.fft(re, im, *tw)  # noqa: E731
    else:
        call = lambda: fftmod.fft(re, im, m)  # noqa: E731
    natural = torch.complex(re, im)

    def extra():
        if not numpy_rows:
            return {}
        br = torch.from_numpy(fftmod.bitrev_perm(m)).to(dev)  # the bit reversal is an involution
        exact = np.fft.fft(torch.complex(re[:numpy_rows, br], im[:numpy_rows, br]).cpu().numpy(),
                           axis=-1)
        out = call()
        got = (out[0][:numpy_rows] + 1j * out[1][:numpy_rows]).cpu().numpy()
        rel = float(np.abs(got - exact).max() / np.abs(exact).max())
        check(rel <= MAX_REL_ERR_FFT, f"K5 error {rel} relative to max|X| above 2^-44")
        return dict(numpy_rel_err=rel)

    return Case(f"[{R}, {m}]", call, lambda: fftmod.fft_plain(re, im, m),
                4 * re.numel() * 8 + 2 * tw[0].numel() * 8,
                R * (m // 2) * (m.bit_length() - 1) * FFT_BUTTERFLY_FLOPS, FP64_PER_S,
                library=lambda: torch.fft.fft(natural), extra=extra)


def fft_stage_case(gen, R, m):
    """F alone, the last stage (span m/2) of [R, m] in place, against
    fft_stage_plain."""
    dev, t = gen.device, m // 2
    re, im = (torch.rand((R, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
              for _ in range(2))
    tw = fftmod._device_tables(m, str(dev))
    out_re, out_im = re.clone(), im.clone()

    def got():
        g_re, g_im = re.clone(), im.clone()
        kernels.fft_stage(g_re, g_im, *tw, t)
        return g_re, g_im

    # in place: the timed calls take the previous call's output
    return Case(f"[{R}, {m}], span {t}, in place",
                lambda: kernels.fft_stage(out_re, out_im, *tw, t),
                lambda: fftmod.fft_stage_plain(re, im, t, *tw),
                4 * re.numel() * 8 + 2 * t * 8, R * (m // 2) * FFT_BUTTERFLY_FLOPS, FP64_PER_S,
                got=got)


def ntt_stage_case(ctx, gen, R, L, B, m, keep):
    """The stage kernel on pairs [R, L, B, m]: two tensors of which one half
    is kept (`keep`, the sharded NTT's cross stage), or the halves of each
    block of rows in place (keep None, a ring above kernels.MAX_ROW_N),
    against ntt_stage_plain."""
    dev = gen.device
    ids = tuple(range(L))
    two_q = ctx.device_rows("two_q", ids, dev)
    if keep is None:
        x = lazy_residues(gen, (R, L, B, 2, m), two_q[..., None, None])
        lo, hi = x[..., 0, :], x[..., 1, :]
        x32 = nttmod.to_u32_bits(x)
        lo32, hi32 = x32[..., 0, :], x32[..., 1, :]
    else:
        lo, hi = (lazy_residues(gen, (R, L, B, m), two_q[..., None]) for _ in range(2))
        lo32, hi32 = nttmod.to_u32_bits(lo), nttmod.to_u32_bits(hi)
    tabs = {dt: [ctx.device_rows(nm, ids, dev, dt)[:, B:2 * B] for nm in ("tw_fwd", "tw_fwd_sh")]
            + [ctx.device_rows(nm, ids, dev, dt) for nm in ("q", "two_q")]
            for dt in (torch.int32, torch.int64)}

    def plain():
        want = nttmod.ntt_stage_plain(lo, hi, *tabs[torch.int64])
        return want if keep is None else want[..., keep, :]

    pairs = R * L * B * m
    out_words = pairs * (1 if keep is not None else 2)
    return Case(f"pairs [{R}, {L}, {B}, {m}], keep {keep}",
                lambda: kernels.ntt_stage(lo32, hi32, *tabs[torch.int32], keep=keep), plain,
                4 * (2 * pairs + out_words + 2 * L * B), pairs * FWD_BUTTERFLY_OPS,
                got=lambda: nttmod.ntt_stage(lo, hi, *tabs[torch.int32], keep=keep))


def modup_case(ctx, gen, R, l, alpha):
    """ModUp on strict source limbs [R, l, n] into those l limbs and the
    context's special limbs at `alpha`, against base_convert of each digit
    group on the same card tensors (the plain chain it replaces,
    rgsw._coeff_digits off the card)."""
    dev, n = gen.device, ctx.params.dimension
    ids = tuple(range(l))
    ids_ext = ids + ctx.special_indices
    groups = [ids[g:g + alpha] for g in range(0, l, alpha)]
    src = strict_residues(ctx, gen, R, ids)
    tabs = basecnv.modup_tables(ctx, ids, ids_ext, alpha, str(dev))

    def plain():
        out = torch.empty((R, len(groups), len(ids_ext), n), dtype=torch.int64, device=dev)
        for g, grp in enumerate(groups):
            part = RnsPoly(src[:, grp[0]:grp[-1] + 1], COEFF, grp)
            out[:, g] = basecnv.base_convert(ctx, part, ids_ext).data
        return out

    words = R * len(groups) * len(ids_ext) * n
    return Case(f"[{R}, {l} -> {len(groups)}x{len(ids_ext)}, {n}], alpha={alpha}",
                lambda: kernels.modup(src, *tabs, alpha), plain,
                8 * src.numel() + 4 * (words + tabs[0].numel() + tabs[1].numel()),
                R * n * (MODUP_SRC_OPS * l + len(ids_ext) * sum(7 * len(g) + 5 for g in groups)))


def moddown_cases(ctx, gen, R, L, count):
    """ModDown on both halves [R, L + count, n] of lazy NTT-form residues:
    the chain (div_last_rounded_many on the card: K2, the lift, K1, the
    apply) against the plain loop it replaces (count div_last_rounded calls
    on both halves stacked); then the lift and the apply alone, timed beside
    their bounds. Returns (chain, lift, apply)."""
    dev, n = gen.device, ctx.params.dimension
    ids = tuple(range(L + count))
    two_q = ctx.device_rows("two_q", ids, dev)
    a, b = (RnsPoly(lazy_residues(gen, (R, L + count, n), two_q), NTT, ids) for _ in range(2))

    def loop():
        x, y = a, b
        for _ in range(count):
            out = basecnv.div_last_rounded(ctx, RnsPoly(torch.stack([x.data, y.data]), NTT,
                                                        x.limb_ids))
            x, y = (RnsPoly(out.data[h], NTT, out.limb_ids) for h in range(2))
        return x.data, y.data

    def chain():
        return tuple(p.data for p in basecnv.div_last_rounded_many(ctx, a, b, count))

    tab = basecnv.moddown_tables(ctx, ids, count, str(dev))
    low = nttmod.transform_bits(torch.stack([a.data[:, L:], b.data[:, L:]]).to(torch.int32),
                                nttmod.limb_rows(ctx, ids[L:]), inverse=True)
    low = low.view(2 * R, count, n)
    rhat = nttmod.transform_bits(kernels.moddown_lift(low, tab, L), nttmod.limb_rows(ctx, ids[:L]))
    x0, x1 = a.data.contiguous(), b.data.contiguous()
    words = 2 * R * count * L * n  # the corrections
    shape = f"[{R}, {L} + {count}, {n}]"
    return (Case(shape, chain, loop, 0, 0),
            Case(shape, lambda: kernels.moddown_lift(low, tab, L), None,
                 4 * (low.numel() + words + tab.numel()),
                 MODDOWN_LIFT_OPS * words + 2 * R * n * (
                     2 * count + MODDOWN_WALK_OPS * count * (count - 1) // 2)),
            Case(shape, lambda: kernels.moddown_apply(x0, x1, rhat, tab), None,
                 8 * 2 * (2 * R * L * n) + 4 * (words + tab.numel()),
                 MODDOWN_APPLY_OPS * words))


def moddown_records(ctx, gen, R, L, count):
    """The lift's and the apply's records: each alone beside its bound, with
    the chain's check and times (`chain_ms`, `chain_kernel_ms`, the loop's
    `plain_ms`)."""
    chain, lift, apply = moddown_cases(ctx, gen, R, L, count)
    c = measure(chain)
    common = dict(shape=c["shape"], max_abs_err=c["max_abs_err"], chain_ms=c["ms"],
                  chain_kernel_ms=c["kernel_ms"], plain_ms=c["plain_ms"],
                  match=f"the chain bitwise vs {count} div_last_rounded calls")
    return dict(measure(lift), **common), dict(measure(apply), **common)


def tensor_case(ctx, gen, R, L):
    """The tensor product of two ciphertexts [R, L, n] of lazy residues
    against tensor_product_plain, the int64 chain it replaces."""
    dev, n = gen.device, ctx.params.dimension
    ids = tuple(range(L))
    two_q = ctx.device_rows("two_q", ids, dev)
    x = [lazy_residues(gen, (R, L, n), two_q) for _ in range(4)]
    consts = [ctx.device_rows(nm, ids, dev) for nm in ("q", "two_q", "neg_qinv", "r_mod_q",
                                                      "r_shoup")]
    return Case(f"[{R}, {L}, {n}]", lambda: kernels.tensor_product(*x, *consts),
                lambda: modarith.tensor_product_plain(*x, *consts),
                8 * 7 * R * L * n + 8 * 5 * L, TENSOR_PRODUCT_OPS * R * L * n)


# ---------------------------------------------------------------------------
# The table: one entry for each row of PERF.md §6's table of kernels
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Entry:
    row: str  # the row of PERF.md §6's table
    names: tuple  # the records it gives
    kind: str  # its kernel (ORIGIN)
    shapes: tuple  # (None or the key to nest it under, function of gen -> Case)
    match: str = "bitwise vs plain"


def _ntt_entries(name, inverse):
    p = functools.partial(ntt_case, inverse=inverse)
    tfhe_rows = 64 * 2 * tfhe.PRESET_GATE_128.decomp_levels if not inverse else 64 * 2
    boot_shape = (1, 2) if inverse else (2, 27)  # the refresh's most launched rows
    return (
        Entry("K1/K2", (name,), name, ((None, lambda g: p(ckks_ctx(16384, 7), g, 64, 7)),),
              "bitwise vs plain" + ("; round trip in the cuda tests" if inverse else "")),
        Entry("K1/K2, TFHE rows", (f"{name}_tfhe",), name,
              ((None, lambda g: p(tfhe_ctx(), g, tfhe_rows, 1)),)),
        Entry("K1/K2, bootstrap rows", (f"{name}_boot",), name,
              ((None, lambda g: p(boot_ctx(4096, 28, 3), g, *boot_shape)),)),
        Entry("K1/K2, n=16384 bootstrap rows", (f"{name}_boot16",), name,
              ((None, lambda g: p(boot_ctx(16384, 28, 3), g, *boot_shape)),)),
        Entry("K1/K2, n = 65536 / 131072", (f"{name}_large",), name,
              ((None, lambda g: p(ckks_ctx(65536, 40, 4), g, 8, 40)),
               ("n131072", lambda g: p(ckks_ctx(131072, 8, 2), g, 2, 8)))),
        Entry("K1/K2, n <= 512", (f"{name}_small_n",), name,
              ((None, lambda g: p(ckks_ctx(256, 2, 2), g, 64, 2)),)),
        Entry("K1/K2, n = 262144", (f"{name}_staged",), name,
              ((None, lambda g: p(ckks_ctx(262144, 40, 4), g, 2, 4)),),
              "bitwise vs plain (the stage kernel, then K1/K2 on parts)"),
    )


TABLE = (
    *_ntt_entries("ntt_fwd", False),
    *_ntt_entries("ntt_inv", True),
    Entry("K3", ("ext_prod",), "ext_prod",
          ((None, lambda g: ext_case(ckks_ctx(16384, 7), g, 64, 7)),)),
    Entry("K3, bootstrap", ("ext_prod_boot",), "ext_prod",
          ((None, lambda g: ext_case(boot_ctx(4096, 28, 3), g, 8, 28)),)),
    Entry("K3, n=16384 bootstrap", ("ext_prod_boot16",), "ext_prod",
          ((None, lambda g: ext_case(boot_ctx(16384, 28, 3), g, 8, 28)),)),
    Entry("K3, n = 65536 / 131072", ("ext_prod_large",), "ext_prod",
          ((None, lambda g: ext_case(ckks_ctx(65536, 40, 4), g, 8, 40)),
           ("n131072", lambda g: ext_case(ckks_ctx(131072, 8, 2), g, 2, 8)))),
    Entry("K3, n = 262144 / 2^23", ("ext_prod_staged",), "ext_prod",
          ((None, lambda g: ext_case(ckks_ctx(262144, 40, 4), g, 8, 40)),
           (f"n{kernels.MAX_N}", lambda g: ext_case(top_ctx(), g, 1, 2))),
          "bitwise vs plain (the stage kernel, then K4 on parts)"),
    Entry("K3, n <= 512", ("ext_prod_small_n",), "ext_prod",
          ((None, lambda g: ext_case(ckks_ctx(256, 2), g, 64, 2)),)),
    Entry("K4", ("ext_prod_conv",), "ext_prod_conv",
          ((None, lambda g: ext_conv_case(ckks_ctx(16384, 12, 2), g, 64, 6, 12)),)),
    Entry("K4, n = 65536 / 131072", ("ext_prod_conv_large",), "ext_prod_conv",
          ((None, lambda g: ext_conv_case(ckks_ctx(65536, 40, 4), g, 8, 10, 40)),
           ("deep_top", lambda g: ext_conv_case(ckks_ctx(65536, 54, 4), g, 8, 14, 54)),
           ("n131072", lambda g: ext_conv_case(ckks_ctx(131072, 8, 2), g, 2, 2, 8)))),
    Entry("K4, n = 262144 / 2^23", ("ext_prod_conv_staged",), "ext_prod_conv",
          ((None, lambda g: ext_conv_case(ckks_ctx(262144, 40, 4), g, 8, 10, 40)),
           (f"n{kernels.MAX_N}", lambda g: ext_conv_case(top_ctx(), g, 1, 2, 2))),
          "bitwise vs plain (the stage kernel, then K4 on parts)"),
    Entry("K4, n <= 512", ("ext_prod_conv_small_n",), "ext_prod_conv",
          ((None, lambda g: ext_conv_case(ckks_ctx(256, 4, 2), g, 64, 2, 4)),)),
    Entry("K5", ("fft",), "fft",
          ((None, lambda g: fft_case(g, 64, 8192, NUMPY_ROWS)),
           ("rows130", lambda g: fft_case(g, 130, 8192)),
           ("m16384", lambda g: fft_case(g, 64, 16384))),
          "bitwise vs plain; vs numpy complex128 (numpy_rel_err)"),
    Entry("K5, bootstrap plans", ("fft_boot",), "fft", ((None, lambda g: fft_case(g, 31, 2048)),)),
    Entry("K5, n=16384 bootstrap plans", ("fft_boot16",), "fft",
          ((None, lambda g: fft_case(g, 63, 8192)),)),
    Entry("K5, m = 32768 / 65536", ("fft_large",), "fft",
          ((None, lambda g: fft_case(g, 8, 32768)), ("n131072", lambda g: fft_case(g, 3, 65536)))),
    Entry("K5, m = 131072 / 2^22", ("fft_staged",), "fft",
          ((None, lambda g: fft_case(g, 8, 131072)),
           (f"m{kernels.MAX_N // 2}", lambda g: fft_case(g, 1, kernels.MAX_N // 2))),
          "bitwise vs plain (K5 on parts, then F)"),
    Entry("K5, m <= 256", ("fft_small_m",), "fft", ((None, lambda g: fft_case(g, 64, 128)),)),
    Entry("S", ("ntt_stage",), "ntt_stage",
          ((None, lambda g: ntt_stage_case(ckks_ctx(16384, 7), g, 64, 7, 1, 8192, 0)),
           ("n262144_in_place",
            lambda g: ntt_stage_case(ckks_ctx(262144, 40, 4), g, 2, 4, 1, 131072, None)))),
    Entry("F", ("fft_stage",), "fft_stage",
          ((None, lambda g: fft_stage_case(g, 8, 131072)),
           (f"m{kernels.MAX_N // 2}", lambda g: fft_stage_case(g, 1, kernels.MAX_N // 2)))),
    Entry("M", ("modup",), "modup",
          ((None, lambda g: modup_case(ckks_ctx(16384, 12, 2), g, 64, 12, 2)),),
          "bitwise vs base_convert per digit group"),
    Entry("M", ("modup_large",), "modup",
          ((None, lambda g: modup_case(ckks_ctx(65536, 40, 4), g, 8, 40, 4)),
           ("deep_top", lambda g: modup_case(ckks_ctx(65536, 54, 4), g, 8, 54, 4))),
          "bitwise vs base_convert per digit group"),
    Entry("M", ("modup_small_n",), "modup",
          ((None, lambda g: modup_case(ckks_ctx(256, 4, 2), g, 64, 4, 2)),),
          "bitwise vs base_convert per digit group"),
    Entry("M, K4, K1, K2 at the 128-bit bootstrap's SSE shapes", ("modup_sse",), "modup",
          ((None, lambda g: modup_case(boot_ctx(65536, 47, 4), g, 1, 1, 4)),
           ("top", lambda g: modup_case(boot_ctx(65536, 47, 4), g, 1, 47, 4))),
          "bitwise vs base_convert per digit group"),
    Entry("M, K4, K1, K2 at the 128-bit bootstrap's SSE shapes", ("ext_prod_conv_sse",),
          "ext_prod_conv",
          ((None, lambda g: ext_conv_case(boot_ctx(65536, 47, 4), g, 1, 1, 1)),
           ("top", lambda g: ext_conv_case(boot_ctx(65536, 47, 4), g, 1, 12, 47)))),
    Entry("M, K4, K1, K2 at the 128-bit bootstrap's SSE shapes", ("ntt_fwd_sse",), "ntt_fwd",
          ((None, lambda g: ntt_case(boot_ctx(65536, 47, 4), g, 1, 47)),)),
    Entry("M, K4, K1, K2 at the 128-bit bootstrap's SSE shapes", ("ntt_inv_sse",), "ntt_inv",
          ((None, lambda g: ntt_case(boot_ctx(65536, 47, 4), g, 1, 1, inverse=True)),)),
    Entry("D", ("moddown_lift", "moddown_apply"), "moddown",
          ((None, lambda g: moddown_records(ckks_ctx(16384, 12, 2), g, 64, 12, 2)),)),
    Entry("D", ("moddown_lift_large", "moddown_apply_large"), "moddown",
          ((None, lambda g: moddown_records(ckks_ctx(65536, 54, 4), g, 8, 54, 4)),)),
    Entry("D", ("moddown_lift_sse", "moddown_apply_sse"), "moddown",
          ((None, lambda g: moddown_records(boot_ctx(65536, 47, 4), g, 1, 47, 4)),)),
    Entry("T", ("tensor_product",), "tensor_product",
          ((None, lambda g: tensor_case(ckks_ctx(16384, 12, 2), g, 64, 12)),
           ("deep_top", lambda g: tensor_case(ckks_ctx(65536, 54, 4), g, 8, 54)),
           ("boot_evalmod", lambda g: tensor_case(boot_ctx(65536, 47, 4), g, 1, 41)))),
)


def run_entry(entry: Entry, dev, seed) -> dict:
    """{record name: record} of one entry: each shape measured, the first
    shape's numbers the record's own, the others nested under their keys."""
    source, replaces = ORIGIN[entry.kind]
    head = dict(route="cuda", source=source, replaces=replaces, match=entry.match, row=entry.row)
    records = {}
    for key, build in entry.shapes:
        gen = torch.Generator(device=dev).manual_seed(seed)
        made = build(gen)
        recs = made if isinstance(made, tuple) else (measure(made),)
        for name, rec in zip(entry.names, recs):
            if key is None:
                records[name] = dict(head, **rec)
            else:
                records[name][key] = rec
        del made
        torch.cuda.empty_cache()
    return records


def describe(name, rec) -> str:
    def one(r):
        faults = [v for k, v in r.items() if k.endswith("profiler_fault")]
        return (f"{r['shape']}: max_abs_err={r.get('max_abs_err')}, kernel-only {r['kernel_ms']} "
                f"ms, call {r['ms']:.4f} ms, plain {r.get('plain_ms')} ms, bound "
                f"{r['bound_ms']:.5f} ms by {r['bound_by']}, kernel-only / bound "
                f"{r['kernel_over_bound']}, library kernel-only {r['library_kernel_ms']} ms"
                + "".join(f", {f}" for f in faults))

    nested = [f"; {k} {one(v)}" for k, v in rec.items() if isinstance(v, dict)]
    return f"[kernels] {name} ({rec['row']}, {rec['match']}) {one(rec)}" + "".join(nested)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    device_name = torch.cuda.get_device_name(0)
    print(f"[device] {card_line()}")
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {device_name}, "
          f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    kernels.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s for {sorted(kernels.SOURCES.values())}")
    t0 = time.perf_counter()
    host_lib = native_loader.build()
    print(f"[build] {time.perf_counter() - t0:.1f} s for the host runtime (g++ "
          f"{' '.join(native_loader.GXX_FLAGS)}): {host_lib.parent.name}/{host_lib.name}")
    for line in kernels.ptxas_report().splitlines():
        if "registers" in line or "spill" in line or "error" in line or "Compiling" in line:
            print(f"[build] {line.strip()}")

    records = {}
    for seed, entry in enumerate(TABLE, 1):
        t0 = time.perf_counter()
        got = run_entry(entry, dev, seed)
        for name, rec in got.items():
            print(describe(name, rec) + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        records.update(got)
    lost = [k for k, rec in records.items() if rec["kernel_ms"] is None]
    check(2 * len(lost) <= len(records),
          f"the profiler gave no kernel-only time for {lost}: the instrument, not a dropped record")
    print(json.dumps({"kernels": [dict(name=k, **rec) for k, rec in records.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
