#!/usr/bin/env python3
"""Smoke run of hehub_tpu_torch on one NVIDIA card (H100): builds the CUDA
kernels, holds each against its plain PyTorch version at the shapes of the
paths that run it, then drives the CKKS main path, the hybrid
key-switching path, the small-ring path, the circuits path, BGV, the
bootstrapped TFHE NAND, the CKKS bootstrap, the large ring, the
multi-rank paths (parallel/*), the bootstrap at n=16384, the examples,
CKKS at n=262144 and the 128-bit bootstrap set's sparse-secret switches end
to end and checks their results.

    python3 chip_smoke.py

Phases, each printing its own lines:
  1. device: the card's name and power limit (nvidia-smi); no card, no run;
  2. build: nvcc of hehub_tpu_torch/csrc/*.cu for sm_90a, and g++ of the
     host runtime (csrc/host/hehub_native.cpp), timed;
  3. kernels vs plain, at their paths' shapes: K1 (forward NTT) and K2
     (inverse NTT) on [64, 7, 16384]; K3 (alpha=1 external product) with
     R=64, l=7, L_ext=8; K4 (alpha=2 external product) with R=64, D=6,
     L_ext=14; ModUp (the alpha=2 digits' base conversion) on [64, 12
     limbs -> 6 x 14, 16384] against base_convert per digit group; K5
     (FP64 FFT) on [64, 8192] — all bitwise, K5 also against numpy
     complex128; each timed twice, kernel-only (per call, from a
     torch.profiler trace: each kernel's mean interval times its launches
     per call, for the port's kernels and the library's alike) and per
     call (CUDA events around back-to-back Python calls, the wrapper's host
     work included), beside its plain version, its bound (the least time the
     card could take: bytes over the memory rate or operations over the
     peak rate, the larger) and the ratio of the two, and K5 beside
     torch.fft.fft, timed both ways too, and kernel-only against it at
     [130, 8192] and [64, 16384] as well (the card tests hold K1-K5 at
     every size they take); after phases 4, 5 and 7, whose launch records
     give its shapes, K1 and K2 again at n=16384 at every row count the
     paths launched them with, each bitwise against its plain chain and
     timed kernel-only and per call beside its bound at those rows, and
     the launch-weighted sums of those kernel-only times (Σ over a run's or
     a step's launches of the time at their row count) per path, per step
     and over all paths; utils/profiling's roofline reports (the
     reference's operation counts) of K1 on [64, 7, 16384] and of the int64
     mul_mod_lazy chain on two such operands, with modmul_gops;
  3b. small rings: K1-K4 bitwise against their plain versions at n = 8,
     16, 64, 256, 512 (their several-rows-a-block instantiations), 1, 3
     and 133 rows, 1 and 4 limbs (+2 special), K5 at m = 4, 8, 128, 256;
     each timed as in phase 3 at the small-ring path's shapes (n=256: K1/K2
     on [64, 2, 256], K3 at R=64, l=2, L_ext=3, K4 at R=64, D=2, L_ext=6,
     ModUp at R=64, l=4 -> 2 x 6 (bitwise vs base_convert), K5 on [64,
     128]);
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
     rotate(1), decrypt, decode against a*b and its roll (<= 2^-8); K4,
     ModUp and K5 must have launched during this phase, one ModUp a K4
     launch; a CPU replay of 4 rows gives
     bitwise the same ciphertexts; then mult and rotate times and traces,
     and the K1/K2 launch records as in phase 4;
  6. small-ring path: phase 4's steps at tests/test_core.py:121's n=256,
     2+1 limbs, batch 64 (K1-K3, K5 on their small instantiations), with
     its CPU replay, times and traces; then mult + relin + rescale at
     alpha=2 on 4+2 limbs (K4, one ModUp a K4 launch), 4 rows replayed
     bitwise;
  7. circuits path on phase 5's configuration, batch 16, keys made on the
     card: matrix_vector_mul of a 64 x 64 matrix (narrow, hoisted: 126
     alpha=2 rotation keys), sign (2 iterations), inverse (3 iterations)
     and rotate_accumulate (steps 0, 2, 5), decoded within the reference
     tests' bounds; K1, K2, K4 and K5 must have launched; 2 rows replayed
     on the CPU bitwise; each circuit's CUDA-event time per ciphertext and
     a trace;
  8. BGV at n=16384 over the full 128-bit budget (12+2 limbs, alpha=2
     relinearization key with noise_scale=t, t = 65537), batch 64, keys on
     the card: simd_encode + encrypt, add, mult_plain, mult + relin,
     mod_switch, exact decrypt + simd_decode, each exactly numpy's slots
     mod t, decrypt_device equal to decrypt on the fresh ciphertexts; K1,
     K2 and K4 must have launched; 2 ciphertexts replayed on the CPU
     bitwise; then the same at tests/test_bgv.py's n=256, 3+1 limbs,
     alpha=1 (K1-K3 small); after the row sweep, the steps' times per
     ciphertext and their traces (its K1/K2 rows join the sweep);
  9. the bootstrapped TFHE NAND at PRESET_GATE_128 (N=2048, m=740),
     batch 64, keys on the card: make_nand, the NAND against 1 - (a & b)
     for every gate; K1 and K2 must have launched, 740 times each at the
     blind rotation's [640, 1, 2048] and [128, 1, 2048] (timed first at
     those shapes, as in phase 3); 1 gate replayed on the CPU bitwise,
     its blind rotation too; per-gate time (tfhe_gate_ms,
     tfhe_gates_per_sec); last, traces of 8 CMUX steps and of one NAND;
  10. CKKS bootstrapping at bench.py's bench_bootstrap(n=4096): 28+3 limbs
     of 30 bits (Δ ≈ 2^60), keys made on the card (sparse secret, alpha=1,
     the 52 rotation keys of the 3-stage factored transforms),
     Bootstrapper(k_bound=5, degree=63, arcsine=True, lt_stages=3) and
     CompiledBootstrapper(split=True) (CUDA graphs); the eager and the
     captured refresh of one ciphertext and of a batch of 8 (v uniform in
     [-1, 1]^2048 at Δ_in = 2^26 on one limb), bitwise equal and decoded
     within 1e-3 of v; K1, K2, K3 and K5 must have launched; a second eager
     refresh adds no plan; mod_raise and the first CoeffToSlot pair
     replayed on the CPU bitwise; K1/K2 at every row count of one eager
     refresh, K3 at its largest launch and K5 on [D, 2048], timed as in
     phase 3; CUDA-event times of the whole refresh, its four stages and
     the batch-8 refresh, eager and captured; traces of one eager and one
     captured refresh;
  11. CKKS at n=65536, above the kernels' sub-rows of 32768: 40+4 limbs
     of 30 bits, batch 8, keys on the card (alpha=4 relin and rotation
     keys, an alpha=1 relin key): encode + encrypt (device codec, K5 at
     m=32768), mult + relin + rescale at alpha=4 (K1, K2, K4), rotate(1)
     at alpha=4, mult + relin + rescale at alpha=1 (K3), decrypt + decode,
     against a*b (<= 2^-8) and its roll (<= 2^-5); all five kernels must
     have launched, and one ModUp a K4 launch; one row of the alpha=4
     mult and of the rotate replayed on the CPU bitwise; the batch-8 product and the alpha=4 relin key
     saved (utils/serialization.py) and loaded onto the card bitwise equal,
     the loaded ciphertext decoding to the same slots, with bytes and host
     seconds; modulus_headroom_bits fresh and after the mult and
     ckks_error_bits after it on one row (utils/noise.py), with host
     seconds; CUDA-event times per ciphertext of each step and traces of
     the mults and the rotate; K1-K5 at the
     path's shapes and at n=131072 (K5 at m=65536) bitwise against their
     plain versions and timed as in phase 3 (`*_large` records), and ModUp
     at R=8, l=40 -> 10 x 44 and at deep65536.ks_b8's top level, R=8, l=54
     -> 14 x 58 (`modup_large`, bitwise vs base_convert);
  12. parallel/* at the main path's width (n=16384, 7+1 limbs, batch 64,
     keys made on the card from a seeded generator in every process alike):
     (a) the sharded mult + relin + rescale on a 1x1 mesh in an NCCL world
     of one rank (a limb group of one rank runs no collective), and NCCL's
     all_gather and broadcast of the step's input on the card, which must
     return it unchanged; (b) two ranks sharing the card over gloo: the mult step on
     the (2,1) and (1,2) meshes, the alpha=2 hybrid configuration (12+2
     limbs) on (1,2) (K4), rotate(1) on (1,2), and the sharded NTT/INTT at
     D=2 on [64, 7, 16384]; (c) four ranks sharing the card: the meshes
     (4,1), (2,2), (1,4) and the sharded NTT at D=4; every shard bitwise
     (sha256) the unsharded port's in this process, and K1, K2, K3, K4 and
     the stage kernel launched inside the ranks; then
     entry.dryrun_multichip(8) as a user calls it: eight ranks on the card
     (gloo, since they share it), each asserting its shards bitwise, with
     K1, K2, K3 and the stage kernel launched in them; (d) PipelinedSquaringChain
     of depth 3 and the square -> rotate(3) -> halve Pipeline over
     [cuda:0] * 3, 5 microbatches of batch 64, bitwise the sequential
     chains, decoded within 3 x 2^-8 of v^8 (and the rotate's bound);
     (e) ops.ntt.ntt / intt at n=262144 on [2, 4, 262144] (the stage
     kernel, K1 / K2 on parts of 131072) bitwise the plain chains; times:
     each sharded step per rank (CUDA events) beside the single-process
     step, each collective's bytes and host seconds, pipelined against
     sequential, the stage kernel timed as in phase 3 at the sharded NTT's
     and at n=262144's shapes; the shared-card lines say they are not
     multi-GPU numbers;
  13. CKKS bootstrapping at the reference's flagship bench_bootstrap(n=16384),
     as phase 10 and not cut: 28+3 limbs, the 62 rotation keys, 64 keys
     of 227.5 MB; the host seconds of the set-up (matrices, rotation steps,
     keygen, discovery, materialisation, capture), key and plan GB, peak
     device memory; batch 1 and 8, captured bitwise equal to eager, decoded
     within 1e-3, K1/K2/K3/K5 launched, the CPU replay (mod_raise and
     c2sR0 alone: the pair took 145 s of the host's CPU); times under
     bench.py's ckks_bootstrap_16384_* names (batch 8: the captured refresh
     only); K1/K2 at the refresh's most launched row counts, K3 at R=8,
     l=28, L_ext=31 and K5 on [D, 8192] as `*_boot16` records; traces;
  14. the examples (hehub_tpu_torch.examples) on the card: the CKKS Basel
     series over 10000 terms, BGV (a + b)·c mod t exact, the TFHE NAND
     truth table at PRESET_GATE_128, each its own check, with wall seconds
     and K1/K2/K3/K5 launches;
  15. CKKS at n=262144, above one launch of K3/K4 (rows of 131072) and of
     K5 (m = 65536): phase 11's chain (40+4 limbs of 30 bits), batch 8,
     keys on the card (alpha=4 relin and rotation keys, an alpha=1 relin
     key): encode + encrypt (device codec: K5 on parts of 65536, then the
     FFT stage kernel F), mult + relin + rescale at alpha=4, rotate(1) at
     alpha=4, mult + relin + rescale at alpha=1 (each key switch: the
     digits in device memory, the stage kernel on them in place, then K4 on
     parts of 131072 as virtual limbs; K3's own kernel not launched),
     decrypt + decode, against a*b (<= 2^-6: phase 11's 2^-8 times the
     ring's ratio, the rescale's rounding noise growing as n) and its roll
     (<= 2^-5); the stage kernel, K1, K2, K4, K5 and F must have launched,
     K3's own kernel not; the alpha=4 mult's key switch (rgsw.ext_prod on
     its tensor product) replayed on the CPU for one row, bitwise (the whole
     mult row took over 120 s of host time); CUDA-event times per
     ciphertext, peak device memory, traces of the key-switching steps;
     then `ext_prod_staged` (R=8, l=40, L_ext=44, the path's alpha=1 key),
     `ext_prod_conv_staged` (R=8, D=10, L_ext=44), `fft_staged` on
     [8, 131072] beside torch.fft.fft and `fft_stage` (F alone, the last
     stage of those rows), each bitwise its plain version and timed as in
     phase 3, and each again at the top ring n = 2^23 (one prime there:
     alpha=1 at R=1, l=2, so K4 at D=2, L_ext=3; the FFT on [1, 2^22]);
  16. the 128-bit bootstrap set of the benchmark's boot65536.refresh_b1 at
     n=65536 (47+4 limbs of 30 bits, alpha=4, secret weight 192, ephemeral
     weight 32, Δ_in = 2^22), batch 1, keys made on the card (the two SSE
     keys, the key into the ephemeral secret on q0 and the special primes
     only; the first CoeffToSlot pair's 15 giant rotations and the third
     factor's 7 baby rotations): the exhausted ciphertext switched to the
     ephemeral secret decodes within MAX_ERR_SSE of v; raise_modulus (SSE
     in at one limb, mod_raise, SSE out at 47 limbs), the first CoeffToSlot
     pair (rotate_accumulate at 47 limbs) and hoisted rotations at 47
     limbs, each with the launches of its own run: 2 ModUp and 2 K4, one
     ModUp a K4 launch, one ModUp and no K4; raise_modulus replayed on the
     CPU bitwise; CUDA-event times of each; then ModUp on [1, 1 -> 1x5] and
     [1, 47 -> 12x51] against base_convert per digit group, K4 at D=1,
     L_ext=5 and D=12, L_ext=51 under the SSE keys, K1 on [1, 47, 65536]
     and K2 on [1, 1, 65536], each bitwise its plain version on the same
     card tensors and timed as in phase 3 (`*_sse` records);
  17. a `kernels` JSON line (K1-K5 at their large shapes, with K1 and K2's
     `by_rows`, their times at each row count, and
     `launch_weighted_kernel_ms`, ModUp as `modup` and ModDown's two kernels
     as `moddown_lift` / `moddown_apply` at the hybrid path's top level,
     each also with the chain's times beside the plain loop's; then the six
     small-ring records `*_small_n` / `fft_small_m`, whose launches are the small-ring
     paths'; then `ntt_fwd_tfhe` / `ntt_inv_tfhe`, whose launches are the
     TFHE path's; then `ntt_fwd_boot`, `ntt_inv_boot`, `ext_prod_boot`,
     `fft_boot`, whose launches are phase 10's; then `ntt_fwd_large`,
     `ntt_inv_large`, `ext_prod_large`, `ext_prod_conv_large`, `fft_large`,
     whose launches are phase 11's, each with its n=131072 numbers, and
     `modup_large` with `deep_top`, `moddown_lift_large` /
     `moddown_apply_large` at deep65536.ks_b8's top level; then
     `ntt_stage`, the stage kernel, whose launches are phase 12's, and
     `ntt_fwd_staged` / `ntt_inv_staged`, K1 / K2 at n=262144; the
     `*_boot16` records, whose launches are phase 13's; phase 14's launches
     join K1-K5's `launches_by_path` as "examples"; then phase 15's
     `ext_prod_staged`, `ext_prod_conv_staged`, `fft_staged` and
     `fft_stage`, whose launches are that phase's; then phase 16's
     `modup_sse`, `ext_prod_conv_sse`, `ntt_fwd_sse`, `ntt_inv_sse`,
     `moddown_lift_sse`, `moddown_apply_sse` (47 + 4 limbs, batch 1), whose
     launches are that phase's); the card line; last,
     the result line {"ok": true, "device": {...}}.

Any failure raises, and the script exits non-zero without a result line.
A kernel-only time is read from a window of the profiler's trace that
begins after a lead-in of small kernels; where the profiler still lost a
kernel's records in three traces, that time is null in its record, with
the fault beside it (`*_profiler_fault`), and fails no check unless more
than half of the `kernels` line's records lack it.
"""

import copy
import dataclasses
import functools
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from hehub_tpu_torch import config, entry, kernels
from hehub_tpu_torch.circuits import bootstrap as bs
from hehub_tpu_torch.circuits import linear_algebra as la
from hehub_tpu_torch.circuits import poly_eval as pe
from hehub_tpu_torch.core import basecnv
from hehub_tpu_torch.core.context import (RlweParams, create_bgv_params, create_ckks_params,
                                          make_context)
from hehub_tpu_torch.core.rns import COEFF, NTT, RnsPoly
from hehub_tpu_torch.models import bgv, ckks, tfhe
from hehub_tpu_torch.examples import bgv_example, ckks_example, tfhe_example
from hehub_tpu_torch.native import loader as native_loader
from hehub_tpu_torch.ops import fft as fftmod
from hehub_tpu_torch.ops import modarith as ma
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.parallel import mesh as pmesh
from hehub_tpu_torch.parallel import ntt_sharded
from hehub_tpu_torch.parallel import pipeline as pipemod
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from hehub_tpu_torch.utils import hostmath as hm
from hehub_tpu_torch.utils import noise
from hehub_tpu_torch.utils import serialization
from hehub_tpu_torch.utils.profiling import (ProfilerFault, device_time, device_trace,
                                              kernel_time, modmul_roofline, ntt_roofline,
                                              op_counters, step_time)

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

# Small rings: the kernels' several-rows-a-block instantiations checked at
# n = 8 .. 512 (K5 at m = 4 .. 256), at these row counts and limbs; timed
# at the small-n path's ring SMALL_N (K5 at SMALL_N / 2)
SMALL_NS = (8, 16, 64, 256, 512)
SMALL_FFT_MS = (4, 8, 128, 256)
SMALL_ROWS = (1, 3, 133)
SMALL_LIMBS = (1, 4)
# the small-n path: tests/test_core.py:121's n=256, 2 + 1 limbs; its
# alpha=2 step: 4 + 2 limbs, as tests/test_torch_hybrid.py
SMALL_N = 256
SMALL_LEVELS = 2
SMALL_HYBRID_LEVELS = 4
# The circuits path on the hybrid configuration: batch 16; a 64 x 64 matrix
# (126 rotation keys); sign of |v| in [0.6, 1], 2 iterations; inverse of v
# in [0.6, 1.4], 3 iterations; a sum of three rotations by 0, 2 and 5. The
# bounds are the reference tests': tests/test_linalg.py:34,
# tests/test_poly_eval.py:83 and :73, tests/test_ckks.py:193.
CIRCUIT_BATCH = 16
MV_DIM = 64
ACC_STEPS = (0, 2, 5)
MAX_ERR_MV = 2.0**-7
MAX_ERR_SIGN = 0.15
RTOL_INVERSE = 3e-2
MAX_ERR_ACC = 2.0**-8
CIRCUIT_REPLAY_ROWS = 2
# Phase 8, BGV on the hybrid path's chain: 12 + 2 limbs of 30 bits, alpha=2,
# t = 65537 (create_bgv_params' 17-bit default, SIMD-capable at n=16384);
# ciphertexts of the batch replayed on the CPU
BGV_LEVELS = 12
BGV_REPLAY_ROWS = 2
# Phase 9, TFHE at PRESET_GATE_128, batch BATCH (bench.py's): gates replayed
# on the CPU (740 CMUX steps each), CMUX steps in the short trace
TFHE_REPLAY_GATES = 1
TFHE_TRACE_STEPS = 8
# Phase 10, CKKS bootstrapping at bench.py's bench_bootstrap(n=4096): 28
# limbs and 3 special primes of 30 bits, Δ = q1·q2, the factored transforms
# in 3 stages, EvalMod of degree 63 over |I| <= 5 with the arcsine cubic,
# Δ_in = 2^26; the batch of the second call; the bound on the decoded slots
# against v that tests/test_bootstrap.py:169-170 cites
BOOT_N = 4096
BOOT_LEVELS = 28
BOOT_SPECIAL = 3
BOOT_LT_STAGES = 3
BOOT_DEGREE = 63
BOOT_K_BOUND = 5
BOOT_D_IN = 2.0**26
BOOT_BATCH = 8
MAX_ERR_BOOT = 1e-3
# Phase 16, the 128-bit bootstrap set of the benchmark's boot65536.refresh_b1
# (hebench/configs/ckks_boot_n65536_h192.json): n=65536, 47 + 4 primes of 30
# bits, alpha=4, a secret of weight 192 and an ephemeral secret of weight 32,
# the input at 2^22 on one limb, transforms in 4 stages, batch 1; the
# working scale is the chain's two smallest primes. The SSE round trip's
# bound: the fresh input's own decode error at 2^22 and n=65536 (about
# 2^-10) with room
SSE_N = 65536
SSE_LEVELS = 47
SSE_SPECIAL = 4
SSE_ALPHA = 4
SSE_WEIGHT = 192
SSE_EPH_WEIGHT = 32
SSE_D_IN = 2.0**22
SSE_LT_STAGES = 4
SSE_K_BOUND = 13
MAX_ERR_SSE = 2.0**-6
# Phase 13, the same refresh at the reference's flagship ring,
# bench_bootstrap(16384) (bench.py:770-787): nothing cut
BOOT16_N = 16384
# Phase 14, the examples' sizes: the Basel series over EXAMPLE_TERMS terms
EXAMPLE_TERMS = 10000
# Phase 11, CKKS at n=65536, a ring above the kernels' sub-rows of 32768:
# 40 + 4 limbs of 30 bits (1318 bits of log QP), batch 8, alpha=4 relin and
# rotation keys, an alpha=1 relin key (K3); the rotate's bound is looser
# than the mults' 2^-8: the hybrid key switch's noise grows with n (about
# 2^-7 here against 2^-8.55 at n=16384); one row replayed on the CPU;
# K1-K5 also held and timed at n=131072 (K5 at m=65536) on a few rows
LARGE_N = 65536
LARGE_LEVELS = 40
LARGE_SPECIAL = 4
LARGE_ALPHA = 4
LARGE_BATCH = 8
DEEP_LEVELS = 54  # deep65536.ks_b8's top level, for ModUp's record
MAX_ERR_LARGE_ROT = 2.0**-5
LARGE_REPLAY_ROWS = 1
LARGEST_N = 131072
LARGEST_SHAPES = dict(ntt=(2, 8), ext=(2, 8, 2), fft=3)  # [rows, L]; (R, l, specials); rows
# Phase 12, parallel/*: worlds of ranks (ranks, cases), each case a mesh step
# ("mult", "hybrid_mult", "rotate" on a (batch, limb) mesh) or the sharded
# NTT over D ranks; every rank on the one card (mesh.backend_for: NCCL for
# the one rank, gloo for ranks that share the card); then the dryrun twin
PAR_SEED = 71
PAR_WORLDS = (
    (1, (("mult", (1, 1)),)),
    (2, (("mult", (2, 1)), ("mult", (1, 2)), ("hybrid_mult", (1, 2)), ("rotate", (1, 2)),
         ("ntt", 2))),
    (4, (("mult", (4, 1)), ("mult", (2, 2)), ("mult", (1, 4)), ("ntt", 4))),
)
DRYRUN_RANKS = 8
PAR_TIMEOUT = 120.0
SHARED_CARD = "ranks sharing one card, gloo through host memory: not a multi-GPU number"
# the pipelines: depth, microbatches of BATCH, the heterogeneous rotation,
# and the inputs' scale: at 2^30 the squarings' scale stays near 2^30
# (Δ^2 / q, every q just below 2^30); at the default 2^28 it falls to 2^26,
# 2^22 and 2^14, where the rescale's rounding noise is no longer small
# against the slots, in both packages alike
PIPE_DEPTH = 3
PIPE_MICRO = 5
PIPE_ROT = 3
PIPE_SCALE = 2.0**30
# rings above the longest kernel row: K1/K2 at n = 262144 on [rows, L]
STAGED_N = 262144
STAGED_SHAPE = (2, 4)
# Phase 15, CKKS at n = STAGED_N, above one launch of K3/K4 (rows of
# 131072) and of K5 (m = 65536): phase 11's chain (40 + 4 limbs of 30 bits,
# 1318 bits of log QP) at 4x its ring, batch 8, keys made on the card
# (alpha=4 relin and rotation keys, an alpha=1 relin key); the rotate's
# bound is phase 11's. The depth is cut from what a 2^18 deployment would
# use (about 7000 bits at 128-bit security), so that the alpha=1 key (6.9 GB
# as int64) and a chunk of its digits fit on the card together. The alpha=4
# mult's key switch replayed on the CPU for one row. The routes by parts
# also held and timed at the top ring kernels.MAX_N, which has one NTT
# prime: every limb is that prime there (the external product at alpha=1
# on R x l rows, K4's D = l, L_ext = l + 1; the FFT on rows of MAX_N / 2).
STAGED_BATCH = 8
STAGED_REPLAY_ROWS = 1
# the mults' bound: phase 11's 2^-8 at n=65536 times the ring's ratio. The
# rescale's rounding noise r·s (r uniform in [-1/2, 1/2] on each of n
# coefficients, s ternary) reaches a slot as a sum over n coefficients, so
# its size grows as n: phase 11 measured 2^-9.4 at 65536, and the same
# algorithm (hehub_tpu's, which the CPU replay below matches bit for bit)
# carries about 4x that here. The rotate keeps phase 11's 2^-5.
MAX_ERR_STAGED_MULT = MAX_ERR_MULT * STAGED_N / LARGE_N
TOP_EXT = (1, 2)  # R, l
TOP_FFT_ROWS = 1

# Peak rates of an H100 SXM at its 700 W limit, for the bound of each kernel:
HBM_BYTES_PER_S = 3.35e12  # data sheet
HBM_GBPS = HBM_BYTES_PER_S / 1e9  # the same, for utils/profiling's roofline reports
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
}


# the kernels that port a TPU kernel (K1-K5); the stage kernel is the port's own
TPU_KERNELS = ("ntt_fwd", "ntt_inv", "ext_prod", "ext_prod_conv", "fft")


def origin(kind):
    source, replaces = ORIGIN[kind]
    return dict(route="cuda", source=source, replaces=replaces)


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


def timed(call):
    """A kernel wrapper's call time (CUDA events around back-to-back Python
    calls, host work included) and its kernel's own device time (profiler)."""
    return dict(ms=device_time(call) * 1e3, **kernel_only(call))


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


def modup_record(ctx, dev, R, l, alpha, gen):
    """ModUp on strict source limbs [R, l, n] into those l limbs and the
    context's special limbs at `alpha`: bitwise against
    base_convert(signed=True) of each digit group on the same card tensors,
    timed as in phase 3 beside that base_convert loop, the plain chain it
    replaces (rgsw._coeff_digits off the card)."""
    n = ctx.params.dimension
    ids = tuple(range(l))
    ids_ext = ids + ctx.special_indices
    groups = [ids[g:g + alpha] for g in range(0, l, alpha)]
    src = torch.stack([torch.randint(0, m, (R, n), generator=gen, device=dev)
                       for m in ctx.moduli_of(ids)], dim=1)
    tabs = basecnv.modup_tables(ctx, ids, ids_ext, alpha, str(dev))

    def plain():
        out = torch.empty((R, len(groups), len(ids_ext), n), dtype=torch.int32, device=dev)
        for g, grp in enumerate(groups):
            part = RnsPoly(src[:, grp[0]:grp[-1] + 1], COEFF, grp)
            out[:, g] = basecnv.base_convert(ctx, part, ids_ext).data
        return out

    got, want = kernels.modup(src, *tabs, alpha), plain()
    err = 0 if torch.equal(got, want) else int((got.long() - want.long()).abs().max())
    del want
    nbytes = 8 * src.numel() + 4 * (got.numel() + tabs[0].numel() + tabs[1].numel())
    return dict(
        **origin("modup"), match="bitwise vs base_convert per digit group",
        shape=f"[{R}, {l} -> {len(groups)}x{len(ids_ext)}, {n}], alpha={alpha}",
        max_abs_err=err, **timed(lambda: kernels.modup(src, *tabs, alpha)),
        plain_ms=device_time(plain, 1, 3) * 1e3, library_ms=None,
        **bound(nbytes, R * n * (MODUP_SRC_OPS * l
                                 + len(ids_ext) * sum(7 * len(g) + 5 for g in groups)),
                INT32_PER_S))


def moddown_records(ctx, dev, R, L, count, gen):
    """ModDown on both halves [R, L + count, n] of lazy NTT-form residues
    (div_last_rounded_many on the card: K2, the lift, K1, the apply) bitwise
    against the plain loop it replaces (count div_last_rounded calls on both
    halves stacked, on the same card tensors), the chain timed per call
    (`chain_ms`) and kernel-only (its four launches, `chain_kernel_ms`)
    beside that loop (`plain_ms`); then the lift and the apply alone, each
    timed as in phase 3 beside its bound. Returns (lift's record, apply's)."""
    n = ctx.params.dimension
    ids = tuple(range(L + count))
    two_q = ctx.device_rows("two_q", ids, dev)
    a, b = (RnsPoly(lazy_residues(gen, (R, L + count, n), two_q), NTT, ids) for _ in range(2))

    def loop():
        x, y = a, b
        for _ in range(count):
            out = basecnv.div_last_rounded(ctx, RnsPoly(torch.stack([x.data, y.data]), NTT,
                                                        x.limb_ids))
            x, y = (RnsPoly(out.data[h], NTT, out.limb_ids) for h in range(2))
        return x, y

    def chain():
        return basecnv.div_last_rounded_many(ctx, a, b, count)

    got, want = chain(), loop()
    err = max(int((g.data - w.data).abs().max()) for g, w in zip(got, want))
    del got, want
    tab = basecnv.moddown_tables(ctx, ids, count, str(dev))
    low = nttmod.transform_bits(torch.stack([a.data[:, L:], b.data[:, L:]]).to(torch.int32),
                                nttmod.limb_rows(ctx, ids[L:]), inverse=True)
    low = low.view(2 * R, count, n)
    rhat = nttmod.transform_bits(kernels.moddown_lift(low, tab, L), nttmod.limb_rows(ctx, ids[:L]))
    x0, x1 = a.data.contiguous(), b.data.contiguous()
    common = dict(
        **origin("moddown"), match=f"the chain bitwise vs {count} div_last_rounded calls",
        shape=f"[{R}, {L} + {count}, {n}]", max_abs_err=err, chain_ms=device_time(chain) * 1e3,
        **kernel_only(chain, key="chain_kernel_ms"), plain_ms=device_time(loop, 1, 3) * 1e3,
        library_ms=None)
    words = 2 * R * count * L * n  # the corrections
    lift = dict(common, **timed(lambda: kernels.moddown_lift(low, tab, L)),
                **bound(4 * (low.numel() + words + tab.numel()),
                        MODDOWN_LIFT_OPS * words + 2 * R * n * (
                            2 * count + MODDOWN_WALK_OPS * count * (count - 1) // 2),
                        INT32_PER_S))
    apply = dict(common, **timed(lambda: kernels.moddown_apply(x0, x1, rhat, tab)),
                 **bound(8 * 2 * (2 * R * L * n) + 4 * (words + tab.numel()),
                         MODDOWN_APPLY_OPS * words, INT32_PER_S))
    return lift, apply


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
        rec = dict(rows=rows, m=m, **kernel_only(lambda: kernels.fft(re, im, *tw)),
                   **kernel_only(lambda: torch.fft.fft(natural), False, "library_kernel_ms"))
        rec["kernel_over_library"] = ratio(rec["kernel_ms"], rec["library_kernel_ms"])
        print(f"[kernels] fft at [{rows}, {m}]: bitwise vs plain, kernel-only "
              f"{rec['kernel_ms']} ms, torch.fft.fft kernel-only "
              f"{rec['library_kernel_ms']} ms, ratio {rec['kernel_over_library']}")
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
        **origin("ntt_fwd"),
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
        **origin("ntt_inv"),
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
        **origin("ext_prod"),
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
        **origin("ext_prod_conv"),
        match="bitwise", max_abs_err=err4,
        **timed(lambda: kernels.ext_prod_conv(c32, h_key32, *h_ext32)),
        plain_ms=device_time(lambda: plain_ext_prod_conv(hctx, conv, h_rlk), 1, 3) * 1e3,
        library_ms=None,
        **bound(4 * (c32.numel() + h_key32.numel() + 2 * BATCH * len(h_ext) * N),
                ntt_ops(c32.numel() // N, N) + c32.numel() * 2 * CONTRACT_OPS, INT32_PER_S),
    )
    del conv, c32, k4, p4
    # ModUp at the hybrid path's shape: 12 limbs in 6 groups of 2 into 14
    records["modup"] = modup_record(hctx, dev, BATCH, len(h_ids), ALPHA, gen)
    # ModDown at the hybrid path's top level (std128.ks_b64's): 12 + 2 limbs
    records["moddown_lift"], records["moddown_apply"] = moddown_records(
        hctx, dev, BATCH, len(h_ids), HYBRID_SPECIAL, gen)

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
        **origin("fft"),
        match=f"bitwise vs plain; vs numpy complex128 {rel5:.3e} of max|X|",
        max_abs_err=err5,
        **timed(lambda: kernels.fft(re, im, tw_re, tw_im)),
        plain_ms=device_time(lambda: fftmod.fft_plain(re, im, m), 1, 3) * 1e3,
        library_ms=device_time(lambda: torch.fft.fft(natural)) * 1e3,
        **kernel_only(lambda: torch.fft.fft(natural), False, "library_kernel_ms"),
        **bound(4 * re.numel() * 8 + 2 * tw_re.numel() * 8,
                BATCH * (m // 2) * (m.bit_length() - 1) * FFT_BUTTERFLY_FLOPS, FP64_PER_S),
        other_shapes=fft_other_shapes(dev, gen),
    )

    conv_ms = dict(
        to_u32_ms=device_time(lambda: nttmod.to_u32_bits(x)) * 1e3,
        from_u32_ms=device_time(lambda: nttmod.from_u32_bits(x32)) * 1e3,
        key_to_u32_ms=device_time(lambda: nttmod.to_u32_bits(rlk.data[:LEVELS])) * 1e3,
    )
    summarize(records)
    print(f"[kernels] int64<->int32 conversions at [{BATCH},{LEVELS},{N}]: {json.dumps(conv_ms)}")

    # utils/profiling's roofline reports, the reference's counts (18 lane
    # operations a butterfly, 20 a Montgomery product, 4-byte residues; the
    # records above count 11 a forward butterfly): K1 on [64, 7, 16384]
    # kernel-only, and the raw int64 mul_mod_lazy chain on two such operands
    # (bench.py:648-662), per call
    y = lazy_residues(gen, (BATCH, LEVELS, N), two_q)
    mm_tabs = [ctx.device_rows(nm, ids, dev) for nm in ("q", "neg_qinv", "r_mod_q", "r_shoup")]
    check(torch.equal(ma.mul_mod_lazy(x, y, *mm_tabs) % q, x * y % q),
          "mul_mod_lazy is not x * y mod q")
    k1_ms = records["ntt_fwd"]["kernel_ms"] or records["ntt_fwd"]["ms"]
    rl_ntt = ntt_roofline(k1_ms / 1e3, N, BATCH * LEVELS)
    rl_mm = modmul_roofline(device_time(lambda: ma.mul_mod_lazy(x, y, *mm_tabs)), x.numel())
    print(f"[kernels] rooflines (utils/profiling, the reference's counts), {card_line()}: "
          f"{rl_ntt.report('ntt_fwd', hbm_gbps=HBM_GBPS)} "
          f"({'kernel-only' if records['ntt_fwd']['kernel_ms'] else 'per call'}); "
          f"{rl_mm.report(f'modmul {x.numel()} elems', hbm_gbps=HBM_GBPS)} (per call, "
          f"PyTorch int64 kernels); modmul_gops {rl_mm.gops_per_s}")
    return records


def summarize(records):
    """Check every record bitwise, add its ratios and print it."""
    for name, rec in records.items():
        check(rec["max_abs_err"] == 0, f"{name} is not bitwise equal to its plain version")
        rec.setdefault("library_kernel_ms", None)
        rec["kernel_over_bound"] = ratio(rec["kernel_ms"], rec["bound_ms"])
        rec["kernel_over_library"] = ratio(rec["kernel_ms"], rec["library_kernel_ms"])
        faults = [v for k, v in rec.items() if k.endswith("profiler_fault")]
        print(f"[kernels] {name}: {rec['match']}, max_abs_err={rec['max_abs_err']}, "
              f"kernel-only {rec['kernel_ms']} ms, call {rec['ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} "
              f"(bytes {rec['bound_bytes_ms']:.4f} ms, operations {rec['bound_ops_ms']:.4f} ms), "
              f"kernel-only / bound {rec['kernel_over_bound']}, "
              f"library call {rec['library_ms']} ms, library kernel-only "
              f"{rec['library_kernel_ms']} ms, kernel-only / library kernel-only "
              f"{rec['kernel_over_library']}" + "".join(f", {f}" for f in faults))


def ntt_row_sweep(hctx, dev, path_rows):
    """Phase 3, second part, run after phases 4 and 5 because their records
    give its shapes: K1 and K2 at the context's n (N, or the bootstrap's
    ring in phase 10) at every row count the paths launched them with
    ([rows / L, L, n], the rows spread over as many of the context's limbs
    as divide them: 14 for the hybrid context), each bitwise against its
    plain chain, then timed per call (CUDA events) and kernel-only. Returns
    {kernel: {rows: record}}."""
    ids_all = tuple(range(len(hctx.params.moduli))) + hctx.special_indices
    N = hctx.params.dimension
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
                       **bound(2 * rows * N * 4, ntt_ops(rows, N, kind == "ntt_inv"), INT32_PER_S))
            rec["kernel_over_bound"] = ratio(rec["kernel_ms"], rec["bound_ms"])
            out[kind][rows] = rec
            del x, got, want
    for kind in out:
        for rows, rec in out[kind].items():
            print(f"[kernels] {kind} at [{rows // rec['limbs']}, {rec['limbs']}, {N}] ({rows} "
                  f"rows): bitwise vs plain, kernel-only {rec['kernel_ms']} ms, call "
                  f"{rec['ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms by {rec['bound_by']}, "
                  f"kernel-only / bound {rec['kernel_over_bound']}"
                  + (f", {rec['kernel_profiler_fault']}" if rec["kernel_ms"] is None else ""))
    return out


def weighted_ms(rows_record, times):
    """Σ over the launches of a {rows: launches} record of the kernel-only
    ms at their row count (the call ms where the profiler lost the kernel
    time)."""
    return sum(count * (times[rows]["kernel_ms"] or times[rows]["ms"])
               for rows, count in rows_record.items())


def launch_weighted(sweep, path_rows, path_steps):
    """The kernel-only time of each kernel's launches, summed with the times
    of the row-count sweep: per path run, per step, and over all paths."""
    out = {}
    for kind, times in sweep.items():
        rec = {tag: weighted_ms(path_rows[tag][kind], times) for tag in path_rows}
        rec["all_paths"] = sum(rec.values())
        rec["steps"] = {f"{tag} {step}": weighted_ms(r[kind], times)
                        for tag, steps in path_steps.items() for step, r in steps.items()}
        out[kind] = rec
        print(f"[kernels] {kind} launch-weighted kernel-only ms: {json.dumps(rec)}")
    return out


def _first_rows(ct, rows, device=None):
    """The first `rows` ciphertexts of a batch, on `device` (theirs by
    default)."""
    take = lambda p: RnsPoly(p.data[:rows].to(device or p.data.device), p.form,  # noqa: E731
                             p.limb_ids)
    return ckks.CkksCt(take(ct.c0), take(ct.c1), ct.scaling_factor)


def _rows_on_cpu(ct, rows):
    return _first_rows(ct, rows, "cpu")


def _key_on_cpu(k):
    return rgsw_mod.RgswCt(k.data.cpu(), k.limb_ids, k.alpha)


def _same_ct(a, b):
    """Bitwise equal ciphertexts, limbs and scales."""
    return (a.limb_ids == b.limb_ids and a.scaling_factor == b.scaling_factor
            and torch.equal(a.c0.data, b.c0.data) and torch.equal(a.c1.data, b.c1.data))


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
    decrypt + decode of a batch of BATCH, between a reset and a read of the
    launch counts. Returns (launches, errors, state for the replay and the
    timings)."""
    n = params.dimension
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (BATCH, n // 2))
    b = rng.uniform(-1, 1, (BATCH, n // 2))
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
    check(out.shape == (BATCH, n // 2), f"{tag}: decoded shape {out.shape}")
    check(bool(np.isfinite(out).all() and np.isfinite(out_prod).all()),
          f"{tag}: decoded values not finite")
    check(rot.limb_ids == tuple(range(L - 1)), f"{tag}: result limbs {rot.limb_ids}")
    err_mult = float(np.abs(out_prod - a * b).max())
    err_rot = float(np.abs(out - np.roll(a * b, 1, axis=-1)).max())
    print(f"[{tag}] n={n} L={L}+{len(params.special_mods)} alpha={alpha} batch={BATCH}: "
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


def print_traces(tag, steps, batch=BATCH):
    for name, fn in steps.items():
        print(f"[{tag}] torch.profiler trace of one batch-{batch} {name}: "
              f"{json.dumps(device_trace(fn))}")


def hybrid_path(dev):
    """Phase 5: the hybrid key-switching path over the full budget. Returns
    what main_path returns."""
    params = create_ckks_params(N, scaling_bits=28, num_special=HYBRID_SPECIAL)
    ctx = make_context(params)
    launches, err_mult, err_rot, s = run_path("hybrid", params, ctx, dev, ALPHA, 5)
    check(err_mult <= MAX_ERR_MULT, f"hybrid mult decode error {err_mult} above {MAX_ERR_MULT}")
    check(err_rot <= MAX_ERR_MULT, f"hybrid rotate decode error {err_rot} above {MAX_ERR_MULT}")
    for name in ("ntt_fwd", "ntt_inv", "ext_prod_conv", "fft", "modup"):
        check(launches[name] > 0, f"kernel {name} was not launched on the hybrid path")
    check(launches["modup"] == launches["ext_prod_conv"],
          "the hybrid path did not launch one ModUp a K4 launch")
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


def small_case(n, levels, dev):
    """A context of `levels` + 2 limbs at n (a 2^18 scale, so that one limb
    is allowed): (ctx, ciphertext limbs, extended limbs, kernel tables of
    the extended limbs)."""
    ctx = make_context(create_ckks_params(n, 18, levels, use_security_budget=False,
                                          num_special=2))
    ids = tuple(range(levels))
    ids_ext = ids + ctx.special_indices
    return ctx, ids, ids_ext, ext_tables(ctx, ids_ext, dev)


def small_inputs(ctx, ids, ids_ext, rows, gen):
    """Random inputs of K1-K4 at rows R: lazy x [R, L, n], strict K3 digits
    [R, L, n], K4 digits [R, ceil(L / 2), L_ext, n] and a lazy key [L, 2,
    L_ext, n]."""
    dev, n = gen.device, ctx.params.dimension
    x = lazy_residues(gen, (rows, len(ids), n), ctx.device_rows("two_q", ids, dev))
    digits = torch.stack([torch.randint(0, m, (rows, n), generator=gen, device=dev)
                          for m in ctx.moduli_of(ids)], dim=1)
    two_q_ext = ctx.device_rows("two_q", ids_ext, dev)
    conv = lazy_residues(gen, (rows, -(-len(ids) // ALPHA), len(ids_ext), n), two_q_ext)
    key = lazy_residues(gen, (len(ids), 2, len(ids_ext), n), two_q_ext)
    return x, digits, conv, rgsw_mod.RgswCt(key, ids_ext)


def small_kernels(dev):
    """Phase 3b: K1-K4 bitwise against their plain versions at every n in
    SMALL_NS, SMALL_ROWS rows and SMALL_LIMBS limbs (+ 2 special), K5 at
    every m in SMALL_FFT_MS and SMALL_ROWS rows; then each timed at the
    small-n path's shapes: K1/K2 on [64, 2, 256], K3 at R=64, l=2, L_ext=3,
    K4 at R=64, D=2, L_ext=6, K5 on [64, 128]. Returns the records."""
    gen = torch.Generator(device=dev).manual_seed(7)
    cases = 0
    for n in SMALL_NS:
        for levels in SMALL_LIMBS:
            ctx, ids, ids_ext, tabs = small_case(n, levels, dev)
            for rows in SMALL_ROWS:
                x, digits, conv, key = small_inputs(ctx, ids, ids_ext, rows, gen)
                for kind, names, plain, launch in (
                        ("ntt_fwd", nttmod.FWD_TABLES, nttmod.ntt_fwd, kernels.ntt_fwd),
                        ("ntt_inv", nttmod.INV_TABLES, nttmod.ntt_inv, kernels.ntt_inv)):
                    got = nttmod.from_u32_bits(launch(
                        nttmod.to_u32_bits(x), *(ctx.device_rows(nm, ids, dev, torch.int32)
                                                 for nm in names)))
                    want = plain(x, *(ctx.device_rows(nm, ids, dev) for nm in names))
                    check(torch.equal(got, want), f"{kind} at [{rows}, {levels}, {n}]")
                key32 = nttmod.to_u32_bits(key.data)
                for kind, got, want in (
                        ("ext_prod", kernels.ext_prod(nttmod.to_u32_bits(digits), key32, *tabs),
                         plain_ext_prod(ctx, digits, key)),
                        ("ext_prod_conv",
                         kernels.ext_prod_conv(nttmod.to_u32_bits(conv), key32, *tabs),
                         plain_ext_prod_conv(ctx, conv, key))):
                    got = nttmod.from_u32_bits(got)
                    check(torch.equal(got[0], want.c0.data) and torch.equal(got[1], want.c1.data),
                          f"{kind} at n={n}, R={rows}, L={levels}")
                cases += 1
    for m in SMALL_FFT_MS:
        tw = fftmod._device_tables(m, str(dev))
        for rows in SMALL_ROWS:
            re, im = (torch.rand((rows, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
                      for _ in range(2))
            got, want = kernels.fft(re, im, *tw), fftmod.fft_plain(re, im, m)
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"fft at [{rows}, {m}]")
    torch.cuda.synchronize()
    print(f"[small kernels] K1-K4 bitwise vs plain at n in {SMALL_NS}, rows {SMALL_ROWS}, "
          f"limbs {SMALL_LIMBS} (+2 special): {cases} cases each; K5 bitwise at m in "
          f"{SMALL_FFT_MS}, rows {SMALL_ROWS}")

    n, R = SMALL_N, BATCH
    match = f"bitwise vs plain at {cases} cases of n = 8..512 and here"
    records = {}
    ctx, ids, ids_ext, tabs = small_case(n, SMALL_LEVELS, dev)
    x, digits, _, key = small_inputs(ctx, ids, ids_ext[: SMALL_LEVELS + 1], R, gen)
    x32 = nttmod.to_u32_bits(x)
    for kind, names, plain, launch in (
            ("ntt_fwd", nttmod.FWD_TABLES, nttmod.ntt_fwd, kernels.ntt_fwd),
            ("ntt_inv", nttmod.INV_TABLES, nttmod.ntt_inv, kernels.ntt_inv)):
        t32 = [ctx.device_rows(nm, ids, dev, torch.int32) for nm in names]
        t64 = [ctx.device_rows(nm, ids, dev) for nm in names]
        err = int((nttmod.from_u32_bits(launch(x32, *t32)) - plain(x, *t64)).abs().max())
        records[f"{kind}_small_n"] = dict(
            **origin(kind), match=match, shape=f"[{R}, {SMALL_LEVELS}, {n}]", max_abs_err=err,
            **timed(functools.partial(launch, x32, *t32)),
            plain_ms=device_time(lambda: plain(x, *t64), 1, 3) * 1e3, library_ms=None,
            **bound(2 * x32.numel() * 4, ntt_ops(R * SMALL_LEVELS, n, kind == "ntt_inv"),
                    INT32_PER_S))
    # K3 at the small path's relinearisation: l = 2 digits, L_ext = 3 limbs
    tabs3 = ext_tables(ctx, key.limb_ids, dev)
    d32, key32 = nttmod.to_u32_bits(digits), nttmod.to_u32_bits(key.data)
    got = nttmod.from_u32_bits(kernels.ext_prod(d32, key32, *tabs3))
    want = plain_ext_prod(ctx, digits, key)
    L_ext = len(key.limb_ids)
    records["ext_prod_small_n"] = dict(
        **origin("ext_prod"), match=match, shape=f"R={R}, l={SMALL_LEVELS}, L_ext={L_ext}, n={n}",
        max_abs_err=max(int((got[0] - want.c0.data).abs().max()),
                        int((got[1] - want.c1.data).abs().max())),
        **timed(lambda: kernels.ext_prod(d32, key32, *tabs3)),
        plain_ms=device_time(lambda: plain_ext_prod(ctx, digits, key), 1, 3) * 1e3,
        library_ms=None,
        **bound(4 * (d32.numel() + key32.numel() + 2 * R * L_ext * n),
                ntt_ops(R * SMALL_LEVELS * L_ext, n)
                + R * SMALL_LEVELS * L_ext * n * 2 * CONTRACT_OPS,
                INT32_PER_S))
    # K4 at the small path's alpha=2 step: D = 2 digits, L_ext = 6 limbs
    ctx, ids, ids_ext, tabs = small_case(n, SMALL_HYBRID_LEVELS, dev)
    _, _, conv, key = small_inputs(ctx, ids, ids_ext, R, gen)
    c32, key32 = nttmod.to_u32_bits(conv), nttmod.to_u32_bits(key.data)
    got = nttmod.from_u32_bits(kernels.ext_prod_conv(c32, key32, *tabs))
    want = plain_ext_prod_conv(ctx, conv, key)
    records["ext_prod_conv_small_n"] = dict(
        **origin("ext_prod_conv"), match=match,
        shape=f"R={R}, D={conv.shape[1]}, L_ext={len(ids_ext)}, n={n}",
        max_abs_err=max(int((got[0] - want.c0.data).abs().max()),
                        int((got[1] - want.c1.data).abs().max())),
        **timed(lambda: kernels.ext_prod_conv(c32, key32, *tabs)),
        plain_ms=device_time(lambda: plain_ext_prod_conv(ctx, conv, key), 1, 3) * 1e3,
        library_ms=None,
        **bound(4 * (c32.numel() + conv.shape[1] * 2 * len(ids_ext) * n + 2 * R * len(ids_ext) * n),
                ntt_ops(c32.numel() // n, n) + c32.numel() * 2 * CONTRACT_OPS, INT32_PER_S))
    # ModUp at the small path's alpha=2 step: 4 limbs in 2 groups into 6
    records["modup_small_n"] = modup_record(ctx, dev, R, SMALL_HYBRID_LEVELS, ALPHA, gen)
    # K5 at the small path's codec: [64, 128]
    m = n // 2
    tw = fftmod._device_tables(m, str(dev))
    re, im = (torch.rand((R, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
              for _ in range(2))
    got, want = kernels.fft(re, im, *tw), fftmod.fft_plain(re, im, m)
    natural = torch.complex(re, im)
    records["fft_small_m"] = dict(
        **origin("fft"), shape=f"[{R}, {m}]",
        match=f"bitwise vs plain at {len(SMALL_FFT_MS) * len(SMALL_ROWS)} cases of m = 4..256 "
              "and here",
        max_abs_err=max(float((got[0] - want[0]).abs().max()),
                        float((got[1] - want[1]).abs().max())),
        **timed(lambda: kernels.fft(re, im, *tw)),
        plain_ms=device_time(lambda: fftmod.fft_plain(re, im, m), 1, 3) * 1e3,
        library_ms=device_time(lambda: torch.fft.fft(natural)) * 1e3,
        **kernel_only(lambda: torch.fft.fft(natural), False, "library_kernel_ms"),
        **bound(4 * re.numel() * 8 + 2 * tw[0].numel() * 8,
                R * (m // 2) * (m.bit_length() - 1) * FFT_BUTTERFLY_FLOPS, FP64_PER_S))
    summarize(records)
    return records


def small_path(dev):
    """Phase 6: the main path's steps at tests/test_core.py:121's n=256, 2 + 1
    limbs, batch 64, on the card (K1-K3 and K5 on their small-n
    instantiations), replayed on the CPU; then mult + relin + rescale at
    alpha=2 on 4 + 2 limbs (K4). Returns the launch counts of both runs."""
    params = create_ckks_params(SMALL_N, scaling_bits=28, num_levels=SMALL_LEVELS,
                                use_security_budget=False)
    ctx = make_context(params)
    launches, err_mult, err_rot, s = run_path("small", params, ctx, dev, 1, 9)
    check(err_mult <= MAX_ERR_MULT, f"small-n mult decode error {err_mult} above {MAX_ERR_MULT}")
    check(err_rot <= MAX_ERR_MULT, f"small-n rotate decode error {err_rot} above {MAX_ERR_MULT}")
    for name in ("ntt_fwd", "ntt_inv", "ext_prod", "fft"):
        check(launches[name] > 0, f"kernel {name} was not launched on the small-n path")
    cpu_replay("small", ctx, params, s["ca"], s["cb"], s["rlk"], s["rk"], s["sk"],
               (s["prod"], s["rot"]), s["out"])
    ca, cb, prod, rlk, rk = (s[k] for k in ("ca", "cb", "prod", "rlk", "rk"))
    steps = {
        "mult+relin+rescale": lambda: ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk)),
        "rotate(1)": lambda: ckks.rotate(ctx, prod, rk, 1),
    }
    metrics = {f"ckks_{k}_ms_per_op_small": device_time(fn, 1, 5) * 1e3 / BATCH
               for k, fn in zip(("mult", "rotate"), steps.values())}
    print(f"[small] times (CUDA events, per ciphertext of a batch-{BATCH} call): "
          + json.dumps(metrics))
    print_traces("small", steps)

    h_params = create_ckks_params(SMALL_N, scaling_bits=28, num_levels=SMALL_HYBRID_LEVELS,
                                  use_security_budget=False, num_special=2)
    h_ctx = make_context(h_params)
    rng = np.random.default_rng(10)
    a, b = (rng.uniform(-1, 1, (BATCH, SMALL_N // 2)) for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(10)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    sk = rlwe_mod.keygen(h_ctx, gen)
    h_rlk = keys_mod.relin_key(h_ctx, sk, gen, alpha=ALPHA)
    ha, hb = (ckks.encrypt(h_ctx, ckks.encode(v, h_params, device=dev), sk, gen) for v in (a, b))
    h_prod = ckks.rescale(h_ctx, ckks.mult(h_ctx, ha, hb, h_rlk))
    out = ckks.decode(ckks.decrypt(h_ctx, h_prod, sk), h_params)
    torch.cuda.synchronize()
    h_launches = dict(kernels.LAUNCHES)
    err = float(np.abs(out - a * b).max())
    check(err <= MAX_ERR_MULT, f"small-n alpha=2 mult decode error {err} above {MAX_ERR_MULT}")
    check(h_launches["ext_prod_conv"] > 0, "K4 was not launched on the small-n alpha=2 step")
    check(h_launches["modup"] == h_launches["ext_prod_conv"],
          "the small-n alpha=2 step did not launch one ModUp a K4 launch")
    h_prod_c = ckks.rescale(h_ctx, ckks.mult(h_ctx, _rows_on_cpu(ha, REPLAY_ROWS),
                                             _rows_on_cpu(hb, REPLAY_ROWS), _key_on_cpu(h_rlk)))
    card = _rows_on_cpu(h_prod, REPLAY_ROWS)
    check(torch.equal(h_prod_c.c0.data, card.c0.data) and torch.equal(h_prod_c.c1.data,
                                                                      card.c1.data),
          "small-n alpha=2: the card's product differs from the plain CPU path")
    mult_ms = device_time(lambda: ckks.rescale(h_ctx, ckks.mult(h_ctx, ha, hb, h_rlk)), 1, 5)
    print(f"[small] alpha=2 step, n={SMALL_N} L={SMALL_HYBRID_LEVELS}+2, batch {BATCH}: mult + "
          f"relin + rescale max|err| vs a*b = {err:.3e}, {mult_ms * 1e3 / BATCH:.5f} ms per "
          f"ciphertext (CUDA events); plain CPU replay of {REPLAY_ROWS} ciphertexts bitwise "
          f"equal; launches {json.dumps(h_launches)}")
    return {k: launches[k] + h_launches[k] for k in launches}


def circuit_calls(ctx, params):
    """The circuits of phase 7, each a function of (ciphertexts, relin key,
    rotation keys)."""
    return {
        "matrix_vector_mul": lambda c, rlk, rks: la.matrix_vector_mul(
            ctx, params, c["mat"], c["vec"], rks),
        "sign": lambda c, rlk, rks: pe.sign(ctx, params, c["sign"], rlk, iterations=2),
        "inverse": lambda c, rlk, rks: pe.inverse(ctx, params, c["inverse"], rlk, iterations=3),
        "rotate_accumulate": lambda c, rlk, rks: ckks.rotate_accumulate(
            ctx, list(zip(c["acc"], ACC_STEPS)), rks),
    }


def circuit_errors(decoded, inputs):
    """Max error of each circuit's decoded slots against numpy, and whether
    it is within its bound."""
    mat, vec = inputs["mat"], inputs["vec"]
    out = {
        "matrix_vector_mul": (float(np.abs(decoded["matrix_vector_mul"][:, :MV_DIM].real
                                           - vec[:, :MV_DIM] @ mat.T).max()), MAX_ERR_MV),
        "sign": (float(np.abs(decoded["sign"].real - np.sign(inputs["sign"])).max()),
                 MAX_ERR_SIGN),
        "inverse": (float((np.abs(decoded["inverse"].real - 1 / inputs["inverse"])
                           * inputs["inverse"]).max()), RTOL_INVERSE),
        "rotate_accumulate": (float(np.abs(decoded["rotate_accumulate"] - sum(
            np.roll(v, s, axis=-1) for v, s in zip(inputs["acc"], ACC_STEPS))).max()),
            MAX_ERR_ACC),
    }
    return out


def circuits_path(dev):
    """Phase 7: the circuits on the hybrid configuration (12 + 2 limbs,
    alpha=2, the full 128-bit budget at n=16384), batch 16, keys made on
    the card: matrix_vector_mul (narrow, hoisted: 126 rotation keys), sign,
    inverse and rotate_accumulate, between a reset and a read of the launch
    counts; decode errors under the reference tests' bounds; 2 rows replayed
    on the CPU through the plain versions (the device codec's plain version
    for the encodes inside the circuits), bitwise. Returns (launches, K1/K2
    launches by rows, and a function that prints each circuit's CUDA-event
    time per ciphertext and a trace of it: main() calls it after the K1/K2
    row sweep; run before the sweep, with the matrix product's trace of
    ~40 000 kernels, the sweep's short traces lost most of a kernel's
    records on an H100, twice)."""
    params = create_ckks_params(N, scaling_bits=28, num_special=HYBRID_SPECIAL)
    ctx = make_context(params)
    slots, B = N // 2, CIRCUIT_BATCH
    rng = np.random.default_rng(21)
    vec = np.zeros((B, slots))
    vec[:, :MV_DIM] = rng.uniform(-1, 1, (B, MV_DIM))
    inputs = dict(
        mat=rng.uniform(-1, 1, (MV_DIM, MV_DIM)), vec=vec,
        sign=rng.uniform(0.6, 1, (B, slots)) * rng.choice([-1.0, 1.0], (B, slots)),
        inverse=rng.uniform(0.6, 1.4, (B, slots)),
        acc=[rng.uniform(-1, 1, (B, slots)) for _ in ACC_STEPS])
    steps = sorted(set(la.mv_mul_requiring_steps(slots, MV_DIM)) | set(ACC_STEPS) - {0})
    calls = circuit_calls(ctx, params)
    gen = torch.Generator(device=dev).manual_seed(21)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sk = rlwe_mod.keygen(ctx, gen)
    rlk = keys_mod.relin_key(ctx, sk, gen, alpha=ALPHA)
    rks = {s: keys_mod.rot_key(ctx, sk, s, gen, alpha=ALPHA) for s in steps}
    t_keys = time.perf_counter() - t0
    enc = lambda v: ckks.encrypt(ctx, ckks.encode(v, params, device=dev), sk, gen)  # noqa: E731
    cts = dict(mat=inputs["mat"], vec=enc(vec), sign=enc(inputs["sign"]),
               inverse=enc(inputs["inverse"]), acc=[enc(v) for v in inputs["acc"]])
    outs = {name: fn(cts, rlk, rks) for name, fn in calls.items()}
    decoded = {name: ckks.decode(ckks.decrypt(ctx, ct, sk), params) for name, ct in outs.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rows = {k: dict(kernels.LAUNCH_ROWS[k]) for k in NTT_KERNELS}
    for name in ("ntt_fwd", "ntt_inv", "ext_prod_conv", "fft"):
        check(launches[name] > 0, f"kernel {name} was not launched on the circuits path")
    errors = circuit_errors(decoded, inputs)
    for name, (err, limit) in errors.items():
        check(bool(np.isfinite(decoded[name]).all()), f"{name}: decoded values not finite")
        check(err <= limit, f"{name}: decode error {err} above {limit}")
    key_bytes = sum(k.data.numel() * 8 for k in rks.values())
    print(f"[circuits] n={N} L={len(params.moduli)}+{HYBRID_SPECIAL} alpha={ALPHA} batch={B}: "
          f"keygen + {len(rks)} rotation keys ({key_bytes / 1e9:.2f} GB as int64) "
          f"{t_keys:.3f} s, keygen..decode {wall:.3f} s (host clock); max|err| and bound "
          f"{json.dumps(errors)}; output limbs "
          f"{json.dumps({k: v.level for k, v in outs.items()})}; launches {json.dumps(launches)}")
    print(f"[circuits] K1/K2 launches by rows {{rows: launches}}: {json.dumps(rows)}")

    R = CIRCUIT_REPLAY_ROWS
    cts_c = dict(mat=inputs["mat"], vec=_rows_on_cpu(cts["vec"], R),
                 sign=_rows_on_cpu(cts["sign"], R), inverse=_rows_on_cpu(cts["inverse"], R),
                 acc=[_rows_on_cpu(c, R) for c in cts["acc"]])
    rlk_c, rks_c = _key_on_cpu(rlk), {s: _key_on_cpu(k) for s, k in rks.items()}
    old, config.use_device_codec = config.use_device_codec, True
    t0 = time.perf_counter()
    try:
        for name, fn in calls.items():
            got, card = fn(cts_c, rlk_c, rks_c), _rows_on_cpu(outs[name], R)
            check(got.limb_ids == card.limb_ids and got.scaling_factor == card.scaling_factor
                  and torch.equal(got.c0.data, card.c0.data)
                  and torch.equal(got.c1.data, card.c1.data),
                  f"{name}: the card's ciphertexts differ from the plain CPU path")
    finally:
        config.use_device_codec = old
    print(f"[circuits] plain CPU replay of {R} of {B} ciphertexts (device codec's plain "
          f"version for the encodes): bitwise equal ciphertexts, scales and limbs for all four "
          f"circuits ({time.perf_counter() - t0:.1f} s)")
    del rks_c, rlk_c

    def timings():
        metrics = {}
        for name, fn in calls.items():
            call = functools.partial(fn, cts, rlk, rks)
            metrics[f"{name}_ms_per_ct"] = device_time(call, 0, 1) * 1e3 / B
            print(f"[circuits] torch.profiler trace of one batch-{B} {name}: "
                  f"{json.dumps(device_trace(call))}")
        print(f"[circuits] times (CUDA events around one warm batch-{B} call, per ciphertext), "
              f"{card_line()}: {json.dumps(metrics)}")

    return launches, rows, timings


def _bgv_rows_on_cpu(ct, rows):
    take = lambda p: RnsPoly(p.data[:rows].cpu(), p.form, p.limb_ids)  # noqa: E731
    return bgv.BgvCt(take(ct.c0), take(ct.c1), ct.plain_modulus)


def _bgv_run(tag, params, dev, alpha, seed):
    """Keygen, the relinearization key (noise_scale=t), simd_encode +
    encrypt of three batches of slots, add, mult_plain, mult (+ relin),
    mod_switch, exact decrypt + simd_decode of each, between a reset and a
    read of the launch counts; every result exactly numpy's mod t, and
    decrypt_device equal to decrypt on the fresh ciphertexts. Then the
    homomorphic steps replayed on the CPU for BGV_REPLAY_ROWS ciphertexts,
    bitwise. Returns (launches, K1/K2 launches by rows, state)."""
    ctx = make_context(params)
    n, t = params.dimension, params.plain_modulus
    rng = np.random.default_rng(seed)
    a, b, c = (rng.integers(0, t, (BATCH, n), dtype=np.uint64) for _ in range(3))
    gen = torch.Generator(device=dev).manual_seed(seed)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sk = rlwe_mod.keygen(ctx, gen)
    rlk = keys_mod.relin_key(ctx, sk, gen, alpha=alpha, noise_scale=t)
    pc = bgv.simd_encode(ctx, c, device=dev)
    ca, cb = (bgv.encrypt(ctx, bgv.simd_encode(ctx, v, device=dev), sk, gen) for v in (a, b))
    outs = dict(add=bgv.add(ctx, ca, cb), mult_plain=bgv.mult_plain(ctx, ca, pc),
                mult=bgv.mult(ctx, ca, cb, rlk))
    outs["mod_switch"] = bgv.mod_switch(ctx, outs["mult"])
    decoded = {k: bgv.simd_decode(ctx, bgv.decrypt(ctx, ct, sk), device=dev)
               for k, ct in outs.items()}
    fresh = {k: (bgv.decrypt(ctx, ct, sk), bgv.decrypt_device(ctx, ct, sk))
             for k, ct in (("a", ca), ("b", cb))}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    rows = {k: dict(kernels.LAUNCH_ROWS[k]) for k in NTT_KERNELS}

    mul = lambda x, y: np.asarray(x.astype(object) * y.astype(object) % t, np.uint64)  # noqa: E731
    want = dict(add=(a + b) % t, mult_plain=mul(a, c), mult=mul(a, b), mod_switch=mul(a, b))
    for k, got in decoded.items():
        check(got.shape == (BATCH, n) and np.array_equal(got, want[k]),
              f"{tag}: {k} does not decrypt to numpy's slots mod t")
    for k, (exact, fast) in fresh.items():
        check(np.array_equal(exact.digits, fast.digits) and np.array_equal(exact.neg, fast.neg),
              f"{tag}: decrypt_device differs from decrypt on the fresh ciphertext {k}")
    check(outs["mod_switch"].limb_ids == tuple(range(len(params.moduli) - 1)),
          f"{tag}: mod_switch limbs {outs['mod_switch'].limb_ids}")
    print(f"[{tag}] n={n} L={len(params.moduli)}+{len(params.special_mods)} alpha={alpha} "
          f"t={t} batch={BATCH}: keygen..decode {wall:.3f} s (host clock); add, mult_plain, mult "
          f"+ relin and mod_switch decrypt exactly to numpy's slots mod t, decrypt_device equals "
          f"decrypt on the fresh ciphertexts; launches {json.dumps(launches)}")
    print(f"[{tag}] K1/K2 launches by rows {{rows: launches}}, keygen..decode: {json.dumps(rows)}")

    R = BGV_REPLAY_ROWS
    t0 = time.perf_counter()
    ca_c, cb_c, rlk_c = _bgv_rows_on_cpu(ca, R), _bgv_rows_on_cpu(cb, R), _key_on_cpu(rlk)
    pc_c = bgv.BgvPt(pc.digits[:R], pc.neg[:R], t)
    replay = dict(add=bgv.add(ctx, ca_c, cb_c), mult_plain=bgv.mult_plain(ctx, ca_c, pc_c),
                  mult=bgv.mult(ctx, ca_c, cb_c, rlk_c))
    replay["mod_switch"] = bgv.mod_switch(ctx, replay["mult"])
    for k, got in replay.items():
        card = _bgv_rows_on_cpu(outs[k], R)
        check(got.limb_ids == card.limb_ids and torch.equal(got.c0.data, card.c0.data)
              and torch.equal(got.c1.data, card.c1.data),
              f"{tag}: the card's {k} differs from the plain CPU path")
    print(f"[{tag}] plain CPU replay of {R} ciphertexts: add, mult_plain, mult + relin and "
          f"mod_switch bitwise equal to the card's ({time.perf_counter() - t0:.1f} s)")
    return launches, rows, dict(ctx=ctx, sk=sk, rlk=rlk, a=a, pc=pc, ca=ca, cb=cb, gen=gen,
                                prod=outs["mult"])


def bgv_path(dev):
    """Phase 8: BGV at n=16384 over the full 128-bit budget (12 + 2 limbs,
    alpha=2, t = 65537), batch 64 (K1, K2, K4 and the plain-modulus NTTs);
    then the same steps at tests/test_bgv.py's n=256, 3 + 1 limbs, alpha=1
    (K1-K3 on their small-row instantiations). Returns (launches of the
    full-width run, its K1/K2 launches by rows, launches of the small-ring
    run, and a function that prints the times and traces of the steps:
    main() calls it after the K1/K2 row sweep)."""
    params = create_bgv_params(N, plain_bits=17, num_levels=BGV_LEVELS, num_special=HYBRID_SPECIAL)
    check(params.plain_modulus == 65537 and params.simd_capable,
          f"BGV plain modulus {params.plain_modulus}")
    launches, rows, s = _bgv_run("bgv", params, dev, ALPHA, 31)
    for name in ("ntt_fwd", "ntt_inv", "ext_prod_conv"):
        check(launches[name] > 0, f"kernel {name} was not launched on the BGV path")
    small = create_bgv_params(SMALL_N, plain_bits=17, num_levels=3, use_security_budget=False)
    small_launches, _, _ = _bgv_run("bgv small", small, dev, 1, 32)
    for name in ("ntt_fwd", "ntt_inv", "ext_prod"):
        check(small_launches[name] > 0, f"kernel {name} was not launched on the small BGV path")

    ctx, sk, rlk, a, pc, ca, cb, gen, prod = (
        s[k] for k in ("ctx", "sk", "rlk", "a", "pc", "ca", "cb", "gen", "prod"))
    encode_encrypt = lambda: bgv.encrypt(ctx, bgv.simd_encode(ctx, a, device=dev), sk, gen)  # noqa: E731
    decrypt_decode = lambda: bgv.simd_decode(ctx, bgv.decrypt(ctx, prod, sk), device=dev)  # noqa: E731
    steps = {
        "encode+encrypt": encode_encrypt,
        "decrypt+decode": decrypt_decode,
        "mult+relin": lambda: bgv.mult(ctx, ca, cb, rlk),
        "mod_switch": lambda: bgv.mod_switch(ctx, prod),
        "mult_plain": lambda: bgv.mult_plain(ctx, ca, pc),
    }
    step_launch_rows = step_rows("bgv", steps)

    def timings():
        metrics = dict(
            bgv_mult_ms_per_op=device_time(steps["mult+relin"], 1, 5) * 1e3 / BATCH,
            bgv_mod_switch_ms_per_op=device_time(steps["mod_switch"], 1, 5) * 1e3 / BATCH,
            bgv_mult_plain_ms_per_op=device_time(steps["mult_plain"], 1, 5) * 1e3 / BATCH,
            bgv_encode_encrypt_ms=device_time(encode_encrypt, 1, 4) * 1e3 / BATCH,
            bgv_decrypt_decode_ms=device_time(decrypt_decode, 1, 4) * 1e3 / BATCH,
            bgv_encode_encrypt_host_ms=step_time(encode_encrypt) * 1e3 / BATCH,
            bgv_decrypt_decode_host_ms=step_time(decrypt_decode) * 1e3 / BATCH,
        )
        print(f"[bgv] times (CUDA events per ciphertext of a batch-{BATCH} call; *_host_ms: host "
              f"clock, per ciphertext), {card_line()}: {json.dumps(metrics)}")
        print_traces("bgv", steps)

    return launches, rows, step_launch_rows, small_launches, timings


def _tfhe_rows(before, after):
    """K1/K2 launches by rows between two LAUNCH_ROWS snapshots."""
    return {k: {r: after[k].get(r, 0) - before[k].get(r, 0) for r in after[k]
                if after[k].get(r, 0) != before[k].get(r, 0)} for k in NTT_KERNELS}


def tfhe_kernel_records(params, dev, gen):
    """K1 and K2 at the blind rotation's shapes, [B·2·ℓ, 1, N] (the digits)
    and [B·2, 1, N] (the accumulator difference), bitwise against their
    plain chains, timed as in phase 3 beside their bounds."""
    ctx = make_context(params.rlwe_params)
    n, ids = params.rlwe_dimension, (0,)
    records = {}
    for kind, rows, names, plain, launch in (
            ("ntt_fwd", BATCH * 2 * params.decomp_levels, nttmod.FWD_TABLES, nttmod.ntt_fwd,
             kernels.ntt_fwd),
            ("ntt_inv", BATCH * 2, nttmod.INV_TABLES, nttmod.ntt_inv, kernels.ntt_inv)):
        x = lazy_residues(gen, (rows, 1, n), ctx.device_rows("two_q", ids, dev))
        t32 = [ctx.device_rows(nm, ids, dev, torch.int32) for nm in names]
        t64 = [ctx.device_rows(nm, ids, dev) for nm in names]
        x32 = nttmod.to_u32_bits(x)
        err = int((nttmod.from_u32_bits(launch(x32, *t32)) - plain(x, *t64)).abs().max())
        records[f"{kind}_tfhe"] = dict(
            **origin(kind), match="bitwise vs plain", shape=f"[{rows}, 1, {n}]",
            max_abs_err=err, **timed(functools.partial(launch, x32, *t32)),
            plain_ms=device_time(lambda: plain(x, *t64), 1, 3) * 1e3, library_ms=None,
            **bound(2 * x32.numel() * 4, ntt_ops(rows, n, kind == "ntt_inv"), INT32_PER_S))
    summarize(records)
    return records


def tfhe_path(dev):
    """Phase 9: the bootstrapped TFHE NAND at PRESET_GATE_128 (N = 2048,
    m = 740, ℓ = 5 digits of 6 bits, key switch 6 digits of 5 bits), batch
    64: keygen on the card, make_nand, encryption of random bit pairs, the
    NAND, decryption, against 1 − (a & b); K1 and K2 must have launched,
    740 steps of [640, 1, 2048] and [128, 1, 2048]; 1 gate replayed on the
    CPU bitwise (its blind rotation too); per-gate time; K1/K2 at those
    shapes. Returns (launches, records, NAND launches by rows, and a
    function that traces 8 CMUX steps and one whole NAND: main() calls it
    last)."""
    params = tfhe.PRESET_GATE_128
    n, m, q = params.rlwe_dimension, params.lwe_dimension, params.q
    print(f"[tfhe] PRESET_GATE_128: N={n} m={m} q={q} decomp {params.decomp_levels} x "
          f"{params.decomp_bits} bits, key switch {params.ks_levels} x {params.ks_decomp_bits} "
          f"bits; security_bits() = {params.security_bits():.4f}")
    rng = np.random.default_rng(41)
    b1, b2 = (rng.integers(0, 2, BATCH) for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(41)
    # kernel-only times first: after the NAND's ~45 000 launches a call, the
    # profiler kept 5 of 10 records of a kernel, three traces running, on an
    # H100
    records = tfhe_kernel_records(params, dev, gen)

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    keys = tfhe.keygen(params, gen)
    nand = tfhe.make_nand(params, keys)
    c1, c2 = (tfhe.lwe_encrypt(params, tfhe.encode_bit(params, v, dev), keys.lwe_s, gen)
              for v in (b1, b2))
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    before = {k: dict(kernels.LAUNCH_ROWS[k]) for k in NTT_KERNELS}
    t1 = time.perf_counter()
    out = nand(c1, c2)
    got = tfhe.lwe_decrypt_bit(params, out, keys.lwe_s).cpu().numpy()
    t_gate = time.perf_counter() - t1
    launches = dict(kernels.LAUNCHES)
    gate_rows = _tfhe_rows(before, {k: dict(kernels.LAUNCH_ROWS[k]) for k in NTT_KERNELS})
    check(np.array_equal(got, 1 - (b1 & b2)), f"NAND outputs {got} are not 1 - (a & b)")
    for name in NTT_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the TFHE path")
    digit_rows, diff_rows = BATCH * 2 * params.decomp_levels, BATCH * 2
    check(gate_rows["ntt_fwd"].get(digit_rows) == m
          and gate_rows["ntt_inv"].get(diff_rows) == m + 1,
          f"NAND launch rows {gate_rows}: expected {m} K1 launches of {digit_rows} rows and "
          f"{m + 1} K2 launches of {diff_rows} rows (the steps and the final INTT)")
    print(f"[tfhe] batch {BATCH}: keygen + make_nand + encrypt {t_setup:.3f} s, first NAND + "
          f"decrypt {t_gate:.3f} s (host clock); all {BATCH} NANDs equal 1 - (a & b); launches "
          f"{json.dumps(launches)}; K1/K2 launches by rows of the NAND {{rows: launches}}: "
          f"{json.dumps(gate_rows)}")

    # gates replayed on the CPU through the plain path, their blind rotation too
    R = TFHE_REPLAY_GATES
    cpu_keys = tfhe.TfheKeys(None, None, nand.bsk.cpu(), nand.ksk_a.cpu(), nand.ksk_b.cpu())
    cpu_tables = (nand.t_mont.cpu(), nand.tm1_mont.cpu())
    lut = torch.full((n,), q // 8, dtype=torch.int64)
    t0 = time.perf_counter()
    lin = tfhe._nand_linear(params, *(tfhe.LweCt(c.a[:R].cpu(), c.b[:R].cpu()) for c in (c1, c2)))
    a_t, b_t = tfhe._mod_switch_2n(params, lin.a), tfhe._mod_switch_2n(params, lin.b)
    acc_cpu = tfhe.blind_rotate(params, lut, a_t, b_t, cpu_keys.bsk, cpu_tables)
    out_cpu = tfhe.key_switch(params, tfhe.sample_extract(params, acc_cpu), cpu_keys)
    t_replay = time.perf_counter() - t0
    acc_card = tfhe.blind_rotate(params, lut.to(dev), a_t.to(dev), b_t.to(dev), nand.bsk,
                                 (nand.t_mont, nand.tm1_mont))
    check(torch.equal(acc_cpu, acc_card.cpu()),
          "TFHE: the card's blind rotation differs from the plain CPU path")
    check(torch.equal(out_cpu.a, out.a[:R].cpu()) and torch.equal(out_cpu.b, out.b[:R].cpu()),
          "TFHE: the card's NAND differs from the plain CPU path")
    print(f"[tfhe] plain CPU replay of {R} gate(s): blind rotation and NAND output bitwise equal "
          f"to the card's ({t_replay:.1f} s on the CPU)")

    call = lambda: nand(c1, c2)  # noqa: E731
    gate_ms = device_time(call, 1, 3) * 1e3 / BATCH
    gate_host_ms = step_time(call, 0, 2) * 1e3 / BATCH
    metrics = dict(tfhe_gate_ms=gate_ms, tfhe_gates_per_sec=1e3 / gate_ms,
                   tfhe_gate_host_ms=gate_host_ms, tfhe_gates_per_sec_host=1e3 / gate_host_ms)
    print(f"[tfhe] times (CUDA events around a batch-{BATCH} NAND, per gate; *_host: host clock), "
          f"{card_line()}: {json.dumps(metrics)}")

    def traces():
        steps = TFHE_TRACE_STEPS
        lin = tfhe._nand_linear(params, c1, c2)
        a_full, b_full = tfhe._mod_switch_2n(params, lin.a), tfhe._mod_switch_2n(params, lin.b)
        few = lambda: tfhe.blind_rotate(params, lut.to(dev), a_full[:, :steps], b_full,  # noqa: E731
                                        nand.bsk[:steps], (nand.t_mont, nand.tm1_mont))
        print(f"[tfhe] torch.profiler trace of {steps} CMUX steps of a batch-{BATCH} blind "
              f"rotation: {json.dumps(device_trace(few))}")
        print(f"[tfhe] torch.profiler trace of one batch-{BATCH} NAND: "
              f"{json.dumps(device_trace(call))}")

    return launches, records, gate_rows, traces


def _boot_keys_on_cpu(booter, plans):
    """The rotation keys that `plans` need (their babies and giants), on
    the CPU."""
    s = plans[0].slot_count
    steps = set()
    for p in plans:
        for g, b in p.pts:
            steps |= {(-b) % s} if b else set()
            steps |= {(-g * p.B) % s} if g else set()
    return {st: _key_on_cpu(booter.rot_keys[st]) for st in sorted(steps)}


def _plan_on_cpu(plan):
    cpu = copy.copy(plan)
    cpu.pts = {gb: RnsPoly(pt.data.cpu(), pt.form, pt.limb_ids) for gb, pt in plan.pts.items()}
    return cpu


def _boot_ct_on_cpu(ct):
    return ckks.CkksCt(*(RnsPoly(p.data.cpu(), p.form, p.limb_ids) for p in (ct.c0, ct.c1)),
                       ct.scaling_factor)


def boot_cpu_replay(tag, booter, ct, pair=True):
    """mod_raise and the first CoeffToSlot pair (c2sR0, c2sI0 under one
    set of hoisted babies; c2sR0 alone without `pair`) of the batch-1
    ciphertext, on the card and on the CPU through the plain versions,
    with the card's keys and plan plaintexts (a strict CPU Bootstrapper:
    no plan is encoded there)."""
    ctx, params = booter.ctx, booter.params
    c2s_r, c2s_im, _, _ = bs._merged_chain_matrices(params.dimension, booter.lt_stages)
    raised = bs.mod_raise(ctx, ct)
    target = raised.scaling_factor * booter._balanced_pt_scale(raised, len(c2s_r))
    specs = (("c2sR0", c2s_r[0]), ("c2sI0", c2s_im[0]))[:2 if pair else 1]
    card = (booter._lt_pair(*specs, raised, target) if pair
            else [booter._lt(*specs[0], raised, target)])
    plans = [booter._plan(name, M, raised, target) for name, M in specs]
    t0 = time.perf_counter()
    cpu = bs.Bootstrapper(ctx, params, None, _boot_keys_on_cpu(booter, plans), None,
                          booter.k_bound, booter.degree, booter.arcsine, booter.double_angle,
                          booter.lt_stages)
    for (name, M), plan in zip(specs, plans):
        cpu._plans[(name, raised.c0.limb_count, raised.scaling_factor, target)] = _plan_on_cpu(plan)
    cpu._strict = True
    raised_c = bs.mod_raise(ctx, _boot_ct_on_cpu(ct))
    got = (cpu._lt_pair(*specs, raised_c, target) if pair
           else [cpu._lt(*specs[0], raised_c, target)])
    seconds = time.perf_counter() - t0
    for what, c, k in (("mod_raise", raised_c, raised), *(
            (name, g, w) for (name, _), g, w in zip(specs, got, card))):
        check(c.limb_ids == k.limb_ids and c.scaling_factor == k.scaling_factor
              and torch.equal(c.c0.data, k.c0.data.cpu())
              and torch.equal(c.c1.data, k.c1.data.cpu()),
              f"{tag}: the card's {what} differs from the plain CPU path")
    done = (f"the first CoeffToSlot pair (c2sR0 with {len(plans[0].pts)} diagonals, c2sI0 with "
            f"{len(plans[1].pts)}, shared hoisted babies)" if pair else
            f"c2sR0 alone ({len(plans[0].pts)} diagonals; not c2sI0, to keep the replay short)")
    print(f"[{tag}] plain CPU replay of mod_raise and {done}, with the card's keys and plan "
          f"plaintexts, on the batch-1 ciphertext: bitwise equal to the card's "
          f"({seconds:.1f} s on the CPU)")
    return seconds


def _decode_err(ctx, params, out, sk, v):
    got = ckks.decode(ckks.decrypt(ctx, out, sk), params).real
    check(got.shape == v.shape and bool(np.isfinite(got).all()),
          f"bootstrap: decoded shape {got.shape} or values not finite")
    return float(np.abs(got - v).max())


def boot_kernel_records(ctx, dev, booter, refresh_rows, suffix, every_row_count):
    """K1/K2 at every row count of one eager batch-1 refresh (the phase 3
    row sweep at the refresh's ring, 31 limbs; with every_row_count False
    only at the most launched one), each record's main numbers at its most
    launched row count; K3 at the refresh's largest launch (R=8 of the
    batch-8 call, l=28 digits, L_ext=31); K5 on [D, n/2] at the most
    diagonals of a plan that took the device codec; each bitwise against
    its plain version, timed as in phase 3. Records are named
    `<kernel><suffix>`."""
    most = {kind: max(refresh_rows[kind], key=lambda r: (refresh_rows[kind][r], r))
            for kind in NTT_KERNELS}
    sweep = ntt_row_sweep(ctx, dev, (refresh_rows if every_row_count else
                                     {kind: {most[kind]: 1} for kind in NTT_KERNELS},))
    n = ctx.params.dimension
    ids_all = tuple(range(len(ctx.params.moduli))) + ctx.special_indices
    records = {}
    for kind, names, plain in (("ntt_fwd", nttmod.FWD_TABLES, nttmod.ntt_fwd),
                               ("ntt_inv", nttmod.INV_TABLES, nttmod.ntt_inv)):
        rows = most[kind]
        rec = dict(sweep[kind][rows])
        ids = ids_all[:rec["limbs"]]
        x = lazy_residues(torch.Generator(device=dev).manual_seed(4),
                          (rows // rec["limbs"], rec["limbs"], n), ctx.device_rows("two_q", ids, dev))
        t64 = [ctx.device_rows(nm, ids, dev) for nm in names]
        records[f"{kind}{suffix}"] = dict(
            **origin(kind), max_abs_err=0,
            match=("bitwise vs plain at every row count" if every_row_count else
                   "bitwise vs plain at the most launched row count"),
            shape=f"[{rows // rec['limbs']}, {rec['limbs']}, {n}]", **rec,
            plain_ms=device_time(lambda: plain(x, *t64), 1, 3) * 1e3, library_ms=None,
            by_rows=[dict(rows=r, launches_refresh=refresh_rows[kind].get(r, 0), **v)
                     for r, v in sweep[kind].items()],
            launch_weighted_kernel_ms=(weighted_ms(refresh_rows[kind], sweep[kind])
                                       if every_row_count else None))
        del x

    gen = torch.Generator(device=dev).manual_seed(5)
    R, l = BOOT_BATCH, len(ctx.params.moduli)
    ids_ext = booter.rlk.limb_ids
    L_ext = len(ids_ext)
    digits = torch.stack([torch.randint(0, m, (R, n), generator=gen, device=dev)
                          for m in ctx.moduli_of(ids_all[:l])], dim=1)
    ext32 = ext_tables(ctx, ids_ext, dev)
    d32, key32 = nttmod.to_u32_bits(digits), nttmod.to_u32_bits(booter.rlk.data[:l])
    got = nttmod.from_u32_bits(kernels.ext_prod(d32, key32, *ext32))
    want = plain_ext_prod(ctx, digits, booter.rlk)
    records[f"ext_prod{suffix}"] = dict(
        **origin("ext_prod"), match="bitwise", shape=f"R={R}, l={l}, L_ext={L_ext}, n={n}",
        max_abs_err=max(int((got[0] - want.c0.data).abs().max()),
                        int((got[1] - want.c1.data).abs().max())),
        **timed(lambda: kernels.ext_prod(d32, key32, *ext32)),
        plain_ms=device_time(lambda: plain_ext_prod(ctx, digits, booter.rlk), 1, 3) * 1e3,
        library_ms=None,
        **bound(4 * (d32.numel() + key32.numel() + 2 * R * L_ext * n),
                ntt_ops(R * l * L_ext, n) + R * l * L_ext * n * 2 * CONTRACT_OPS, INT32_PER_S))
    del digits, d32, key32, got, want

    device_plans = [p for p in booter._plans.values() if p.codec == "device"]
    check(device_plans, f"n={n} bootstrap: no plan took the device codec (K5)")
    D, m = max(len(p.pts) for p in device_plans), n // 2
    tw = fftmod._device_tables(m, str(dev))
    re, im = (torch.rand((D, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
              for _ in range(2))
    got, want = kernels.fft(re, im, *tw), fftmod.fft_plain(re, im, m)
    natural = torch.complex(re, im)
    records[f"fft{suffix}"] = dict(
        **origin("fft"), match="bitwise vs plain", shape=f"[{D}, {m}]",
        max_abs_err=max(float((got[0] - want[0]).abs().max()),
                        float((got[1] - want[1]).abs().max())),
        **timed(lambda: kernels.fft(re, im, *tw)),
        plain_ms=device_time(lambda: fftmod.fft_plain(re, im, m), 1, 3) * 1e3,
        library_ms=device_time(lambda: torch.fft.fft(natural)) * 1e3,
        **kernel_only(lambda: torch.fft.fft(natural), False, "library_kernel_ms"),
        **bound(4 * re.numel() * 8 + 2 * tw[0].numel() * 8,
                D * (m // 2) * (m.bit_length() - 1) * FFT_BUTTERFLY_FLOPS, FP64_PER_S))
    summarize(records)
    return records


def bootstrap_path(dev, n, flagship=False):
    """Phase 10 (n=BOOT_N, bench.py's bench_bootstrap(4096)) and phase 13
    (flagship: n=BOOT16_N, bench_bootstrap(16384), reported under
    bench.py's ckks_bootstrap_16384_* names): make_boot_params(n, 28,
    num_special=3) (Δ = q1·q2 ≈ 2^60), a sparse secret (h=8), alpha=1
    relinearization and conjugation keys and the rotation keys of the
    three-stage factored transforms, made on the card;
    Bootstrapper(k_bound=5, degree=63, arcsine=True, lt_stages=3) and
    CompiledBootstrapper(split=True); v uniform in [-1, 1]^(n/2) at Δ_in =
    2^26 on one limb. The eager and the captured refresh of one ciphertext
    and of a batch of 8, decoded within MAX_ERR_BOOT of v, bitwise equal;
    K1, K2, K3 and K5 launched; the launches of one eager refresh; a CPU
    replay of mod_raise and the first CoeffToSlot pair (phase 13: c2sR0
    alone); the kernels at the
    refresh's shapes; then CUDA-event times (whole refresh, per stage, per
    ciphertext at batch 8: phase 13 times the captured batch-8 refresh
    only) and traces of one eager and one captured refresh. Phase 13 also
    prints the host seconds of the set-up and the peak device memory.
    Returns (launch counts of the phase, the `*_boot` / `*_boot16` kernel
    records)."""
    tag = "bootstrap16" if flagship else "bootstrap"
    params = bs.make_boot_params(n, BOOT_LEVELS, num_special=BOOT_SPECIAL)
    ctx = make_context(params)
    slots = n // 2
    v = np.random.default_rng(3).uniform(-1, 1, slots)
    v8 = np.random.default_rng(4).uniform(-1, 1, (BOOT_BATCH, slots))
    gen = torch.Generator(device=dev).manual_seed(51)
    print(f"[{tag}] n={n} L={BOOT_LEVELS}+{BOOT_SPECIAL}, log2 Δ = "
          f"{np.log2(params.initial_scaling_factor):.4f}, Δ_in = 2^{np.log2(BOOT_D_IN):.0f}, "
          f"degree {BOOT_DEGREE}, arcsine, lt_stages={BOOT_LT_STAGES}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t_phase = t0 = time.perf_counter()
    host = dict(matrices=0.0)
    bs._merged_chain_matrices(n, BOOT_LT_STAGES)
    host["matrices"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    steps = bs.bootstrap_rotation_steps(params, BOOT_LT_STAGES)
    host["rotation_steps"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sk = rlwe_mod.keygen(ctx, gen, hamming_weight=8)
    rlk = keys_mod.relin_key(ctx, sk, gen)
    rks = {st: keys_mod.rot_key(ctx, sk, st, gen) for st in steps}
    ck = keys_mod.conj_key(ctx, sk, gen)
    enc = lambda x: ckks.encrypt(ctx, ckks.encode(x, params, scaling_factor=BOOT_D_IN,  # noqa: E731
                                                  level=BOOT_LEVELS - 1, device=dev), sk, gen)
    ct, ct8 = enc(v), enc(v8)
    torch.cuda.synchronize()
    host["keygen"] = t_keys = time.perf_counter() - t0
    booter = bs.Bootstrapper(ctx, params, rlk, rks, ck, k_bound=BOOT_K_BOUND, degree=BOOT_DEGREE,
                             arcsine=True, lt_stages=BOOT_LT_STAGES)
    t0 = time.perf_counter()
    refresh = bs.CompiledBootstrapper(booter, ct, split=True)
    t_compiled = time.perf_counter() - t0
    host.update({f"compiled_{k}": t for k, t in refresh.timings.items()})
    key_bytes = sum(k.data.numel() * 8 for k in (rlk, ck, *rks.values()))
    plan_bytes = sum(pt.data.numel() * 8 for p in booter._plans.values() for pt in p.pts.values())
    print(f"[{tag}] keygen + {len(rks)} rotation keys + encrypt {t_keys:.3f} s, keys "
          f"{key_bytes / 1e9:.3f} GB as int64; CompiledBootstrapper(split=True) {t_compiled:.3f} s "
          f"{json.dumps(refresh.timings)}; {len(booter._plans)} plans, {plan_bytes / 1e9:.3f} GB, "
          f"{len(booter._consts.pts)} constant plaintexts")
    print(f"[{tag}] plans (name, limbs): diagonals, codec: " + json.dumps(
        {f"{k[0]} L{k[1]}": f"{len(p.pts)}, {p.codec}" for k, p in booter._plans.items()}))

    n_plans = len(booter._plans)
    eager = booter(ct)
    captured = refresh(ct)
    check(len(booter._plans) == n_plans, f"{tag}: a second eager refresh added a plan")
    check(_same_ct(captured, eager), f"{tag}: the captured refresh differs from the eager one")
    check(eager.c0.limb_count >= 3, f"{tag}: {eager.c0.limb_count} limbs after the refresh")
    err = _decode_err(ctx, params, eager, sk, v)
    check(err <= MAX_ERR_BOOT, f"{tag}: decode error {err} above {MAX_ERR_BOOT}")
    t0 = time.perf_counter()
    refresh8 = bs.CompiledBootstrapper(booter, ct8, split=True)
    t_compiled8 = time.perf_counter() - t0
    host.update({f"compiled8_{k}": t for k, t in refresh8.timings.items()})
    eager8 = booter(ct8)
    captured8 = refresh8(ct8)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(_same_ct(captured8, eager8), f"{tag}: the captured batch-8 refresh differs from eager")
    err8 = _decode_err(ctx, params, eager8, sk, v8)
    check(err8 <= MAX_ERR_BOOT, f"{tag}: batch-8 decode error {err8} above {MAX_ERR_BOOT}")
    for name in ("ntt_fwd", "ntt_inv", "ext_prod", "fft"):
        check(launches[name] > 0, f"kernel {name} was not launched on the n={n} bootstrap path")
    print(f"[{tag}] refresh: {eager.c0.limb_count} limbs out, scale 2^"
          f"{np.log2(eager.scaling_factor):.4f}; captured == eager bitwise (batch 1 and 8); max|"
          f"decoded - v| {err:.3e} (batch 1), {err8:.3e} (batch 8, every row), bound "
          f"{MAX_ERR_BOOT}; batch-8 CompiledBootstrapper {t_compiled8:.3f} s "
          f"{json.dumps(refresh8.timings)}; launches of the phase {json.dumps(launches)}")
    del eager8, captured8
    if flagship:
        stats = op_counters()
        print(f"[{tag}] device memory, {card_line()}: peak allocated "
              f"{stats['allocated_bytes.all.peak'] / 1e9:.3f} GB, now allocated "
              f"{stats['allocated_bytes.all.current'] / 1e9:.3f} GB, reserved "
              f"{stats['reserved_bytes.all.current'] / 1e9:.3f} GB (keys {key_bytes / 1e9:.3f} GB, "
              f"plans {plan_bytes / 1e9:.3f} GB as int64)")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    booter(ct)
    torch.cuda.synchronize()
    refresh_launches = dict(kernels.LAUNCHES)
    refresh_rows = {k: dict(kernels.LAUNCH_ROWS[k]) for k in NTT_KERNELS}
    print(f"[{tag}] launches of one eager batch-1 refresh {json.dumps(refresh_launches)}; "
          f"K1/K2 by rows {{rows: launches}}: {json.dumps(refresh_rows)}")
    seconds = dict(drive=time.perf_counter() - t_phase)
    # at n=16384 the pair took 145 s of the card host's CPU: c2sR0 alone there
    seconds["cpu_replay"] = boot_cpu_replay(tag, booter, ct, pair=not flagship)
    t0 = time.perf_counter()
    records = boot_kernel_records(ctx, dev, booter, refresh_rows,
                                  "_boot16" if flagship else "_boot", not flagship)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    fa, fb_re, fb_im, fc = (f for _, f in refresh.stage_fns())
    a = fa(ct.c0.data, ct.c1.data)
    wre, wim = fb_re(*a[:2]), fb_im(*a[2:])
    z_re, z_im = booter.coeff_to_slot(bs.mod_raise(ctx, ct))
    w_re, w_im = booter.eval_mod(z_re), booter.eval_mod(z_im)
    stage_ms = dict(
        c2s=device_time(lambda: fa(ct.c0.data, ct.c1.data), 1, 5) * 1e3,
        evalmod_re=device_time(lambda: fb_re(*a[:2]), 1, 5) * 1e3,
        evalmod_im=device_time(lambda: fb_im(*a[2:]), 1, 5) * 1e3,
        s2c=device_time(lambda: fc(*wre, *wim), 1, 5) * 1e3,
        # the eager calls are warm (every plan and constant made) and take
        # seconds each: fewer of them
        c2s_eager=device_time(lambda: booter.coeff_to_slot(bs.mod_raise(ctx, ct)), 0, 1) * 1e3,
        evalmod_re_eager=device_time(lambda: booter.eval_mod(z_re), 0, 1) * 1e3,
        evalmod_im_eager=device_time(lambda: booter.eval_mod(z_im), 0, 1) * 1e3,
        s2c_eager=device_time(lambda: booter.slot_to_coeff(w_re, w_im), 0, 1) * 1e3,
    )
    refresh_ms = device_time(lambda: refresh(ct), 1, 5) * 1e3
    eager_ms = device_time(lambda: booter(ct), 0, 2) * 1e3
    eager_host_ms = step_time(lambda: booter(ct), 0, 1) * 1e3
    batch8_ms = device_time(lambda: refresh8(ct8), 1, 3) * 1e3 / BOOT_BATCH
    if flagship:
        metrics = {f"ckks_bootstrap_{n}_ms": refresh_ms, f"ckks_bootstrap_{n}_max_err": err,
                   f"ckks_bootstrap_{n}_max_err_batch8": err8,
                   f"ckks_bootstrap_{n}_eager_ms": eager_ms,
                   f"ckks_bootstrap_{n}_eager_host_ms": eager_host_ms,
                   **{f"bootstrap_{n}_{k}_ms": t for k, t in stage_ms.items()},
                   f"ckks_bootstrap_{n}_ms_per_ct_batch8": batch8_ms}
    else:
        metrics = dict(
            ckks_bootstrap_ms_per_refresh=refresh_ms,
            **{f"bootstrap_{k}_ms": t for k, t in stage_ms.items() if "eager" not in k},
            ckks_bootstrap_ms_per_ct_batch8=batch8_ms,
            ckks_bootstrap_eager_ms_per_refresh=eager_ms,
            **{f"bootstrap_{k.removesuffix('_eager')}_eager_ms": t
               for k, t in stage_ms.items() if "eager" in k},
            ckks_bootstrap_eager_ms_per_ct_batch8=device_time(lambda: booter(ct8), 0, 1) * 1e3
            / BOOT_BATCH,
            ckks_bootstrap_eager_host_ms_per_refresh=eager_host_ms,
            bootstrap_max_abs_err=err, bootstrap_max_abs_err_batch8=err8,
        )
    print(f"[{tag}] times (CUDA events; captured: CUDA graphs, *_eager: the eager "
          f"Bootstrapper; *_host: host clock), {card_line()}: {json.dumps(metrics)}")
    seconds["times"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for what, fn in (("eager", lambda: booter(ct)), ("captured", lambda: refresh(ct))):
        trace = device_trace(fn)
        print(f"[{tag}] torch.profiler trace of one {what} batch-1 refresh: {json.dumps(trace)}")
    # a replay passes no wrapper: its kernels show only in the trace
    for name in ("ntt_fwd_kernel", "ntt_inv_kernel", "ext_prod_kernel"):
        check(trace["busy_ms"] is None or trace["launches"].get(name, 0) > 0,
              f"{tag}: the captured refresh's trace holds no {name}")
    seconds["traces"] = time.perf_counter() - t0
    if flagship:
        print(f"[{tag}] host seconds of the set-up (host clock), {card_line()}: "
              f"{json.dumps(host)}")
    print(f"[{tag}] seconds of the phase (host clock): {json.dumps(seconds)}")
    # the host matrices of the factored transforms (their diagonals from
    # n=8192) and the stage matrices go with the phase
    for cache in (bs._merged_chain_matrices, bs._butterfly_factors, bs._butterfly_roots):
        cache.cache_clear()
    return launches, records


def large_ntt_record(kind, ctx, dev, shape, gen):
    """K1 or K2 (`kind`) on lazy residues of `shape` [rows, L, n], n above
    kernels.NTT_SUB_N, with the regrouped tables: bitwise against the plain
    chain, timed as in phase 3."""
    rows, L, n = shape
    ids = tuple(range(L))
    fwd = kind == "ntt_fwd"
    names = nttmod.FWD_TABLES if fwd else nttmod.INV_TABLES
    split = nttmod.FWD_SPLIT_TABLES if fwd else nttmod.INV_SPLIT_TABLES
    plain = nttmod.ntt_fwd if fwd else nttmod.ntt_inv
    launch = kernels.ntt_fwd if fwd else kernels.ntt_inv
    x = lazy_residues(gen, shape, ctx.device_rows("two_q", ids, dev))
    tabs32 = [ctx.device_rows(nm, ids, dev, torch.int32) for nm in split]
    t64 = [ctx.device_rows(nm, ids, dev) for nm in names]
    x32 = nttmod.to_u32_bits(x)
    got = nttmod.from_u32_bits(launch(x32, *tabs32))
    want = plain(x, *t64)
    return dict(shape=str(list(shape)), max_abs_err=int((got - want).abs().max()),
                **timed(lambda: launch(x32, *tabs32)),
                plain_ms=device_time(lambda: plain(x, *t64), 1, 3) * 1e3, library_ms=None,
                **bound(2 * x32.numel() * 4, ntt_ops(rows * L, n, not fwd), INT32_PER_S))


def large_ext_record(kind, ctx, dev, digits, key):
    """K3 (`kind` "ext_prod", strict digits [R, l, n]) or K4
    ("ext_prod_conv", converted digits [R, D, L_ext, n]) against the RGSW
    rows `key`, n above kernels.EXT_SUB_N, with the regrouped tables:
    bitwise against the plain version one row at a time (its memory), timed
    as in phase 3."""
    ids_ext = key.limb_ids
    R, D, n = digits.shape[0], digits.shape[1], digits.shape[-1]
    L_ext = len(ids_ext)
    tabs = [ctx.device_rows(nm, ids_ext, dev, torch.int32) for nm in nttmod.EXT_SPLIT_TABLES]
    d32, key32 = nttmod.to_u32_bits(digits), nttmod.to_u32_bits(key.data[:D])
    launch = kernels.ext_prod if kind == "ext_prod" else kernels.ext_prod_conv
    plain = plain_ext_prod if kind == "ext_prod" else plain_ext_prod_conv
    got = nttmod.from_u32_bits(launch(d32, key32, *tabs))
    err = 0
    for r in range(R):
        want = plain(ctx, digits[r:r + 1], key)
        err = max(err, int((got[0, r:r + 1] - want.c0.data).abs().max()),
                  int((got[1, r:r + 1] - want.c1.data).abs().max()))
    del got, want
    rows = R * D * L_ext
    return dict(shape=f"R={R}, {'l' if kind == 'ext_prod' else 'D'}={D}, L_ext={L_ext}, n={n}",
                max_abs_err=err, **timed(lambda: launch(d32, key32, *tabs)),
                plain_ms=device_time(lambda: [plain(ctx, digits[r:r + 1], key)
                                              for r in range(R)], 0, 1) * 1e3,
                library_ms=None,
                **bound(4 * (d32.numel() + key32.numel() + 2 * R * L_ext * n),
                        ntt_ops(rows, n) + rows * n * 2 * CONTRACT_OPS, INT32_PER_S))


def large_fft_record(dev, rows, m, gen):
    """K5 on [rows, m] (clusters of 4 or 8 blocks a row), bitwise against
    fft_plain, timed as in phase 3 beside torch.fft.fft."""
    re, im = (torch.rand((rows, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
              for _ in range(2))
    tw = fftmod._device_tables(m, str(dev))
    got, want = kernels.fft(re, im, *tw), fftmod.fft_plain(re, im, m)
    natural = torch.complex(re, im)
    return dict(shape=f"[{rows}, {m}]",
                max_abs_err=max(float((got[0] - want[0]).abs().max()),
                                float((got[1] - want[1]).abs().max())),
                **timed(lambda: kernels.fft(re, im, *tw)),
                plain_ms=device_time(lambda: fftmod.fft_plain(re, im, m), 1, 3) * 1e3,
                library_ms=device_time(lambda: torch.fft.fft(natural)) * 1e3,
                **kernel_only(lambda: torch.fft.fft(natural), False, "library_kernel_ms"),
                **bound(4 * re.numel() * 8 + 2 * tw[0].numel() * 8,
                        rows * (m // 2) * (m.bit_length() - 1) * FFT_BUTTERFLY_FLOPS, FP64_PER_S))


def large_kernel_records(ctx, dev, rlk1, rlk4):
    """K1-K5 at phase 11's shapes (K1/K2 on [8, 40, 65536], K3 with the
    path's alpha=1 relin key at R=8, l=40, L_ext=44, K4 with its alpha=4
    key at R=8, D=10, L_ext=44, K5 on [8, 32768]) and at n=131072 (random
    key rows; K5 at m=65536), each bitwise against its plain version and
    timed as in phase 3. Returns the `*_large` records, the n=131072
    numbers under `n131072`."""
    gen = torch.Generator(device=dev).manual_seed(62)
    n, L = LARGE_N, LARGE_LEVELS
    ids = tuple(range(L))
    ids_ext = rlk1.limb_ids
    D = -(-L // LARGE_ALPHA)
    strict = torch.stack([torch.randint(0, m, (LARGE_BATCH, n), generator=gen, device=dev)
                          for m in ctx.moduli_of(ids)], dim=1)
    conv = lazy_residues(gen, (LARGE_BATCH, D, len(ids_ext), n),
                         ctx.device_rows("two_q", ids_ext, dev))
    at_path = dict(
        ntt_fwd=large_ntt_record("ntt_fwd", ctx, dev, (LARGE_BATCH, L, n), gen),
        ntt_inv=large_ntt_record("ntt_inv", ctx, dev, (LARGE_BATCH, L, n), gen),
        ext_prod=large_ext_record("ext_prod", ctx, dev, strict, rlk1),
        ext_prod_conv=large_ext_record("ext_prod_conv", ctx, dev, conv, rlk4),
        fft=large_fft_record(dev, LARGE_BATCH, n // 2, gen),
    )
    del strict, conv
    torch.cuda.empty_cache()

    R, l, sp = LARGEST_SHAPES["ext"]
    big = make_context(create_ckks_params(LARGEST_N, 28, l, use_security_budget=False,
                                          num_special=sp))
    b_ids = tuple(range(l))
    b_ext = b_ids + big.special_indices
    b_two_q = big.device_rows("two_q", b_ext, dev)
    key = rgsw_mod.RgswCt(lazy_residues(gen, (l, 2, len(b_ext), LARGEST_N), b_two_q), b_ext)
    strict = torch.stack([torch.randint(0, m, (R, LARGEST_N), generator=gen, device=dev)
                          for m in big.moduli_of(b_ids)], dim=1)
    conv = lazy_residues(gen, (R, 2, len(b_ext), LARGEST_N), b_two_q)
    rows, limbs = LARGEST_SHAPES["ntt"]
    at_largest = dict(
        ntt_fwd=large_ntt_record("ntt_fwd", big, dev, (rows, limbs, LARGEST_N), gen),
        ntt_inv=large_ntt_record("ntt_inv", big, dev, (rows, limbs, LARGEST_N), gen),
        ext_prod=large_ext_record("ext_prod", big, dev, strict, key),
        ext_prod_conv=large_ext_record("ext_prod_conv", big, dev, conv, key),
        fft=large_fft_record(dev, LARGEST_SHAPES["fft"], LARGEST_N // 2, gen),
    )
    del strict, conv, key
    torch.cuda.empty_cache()
    records = {}
    # ModUp at the path's alpha=4 shape, and at deep65536.ks_b8's top level
    # (54 limbs in 14 groups, 13 of 4 and one of 2, into 58)
    deep = make_context(create_ckks_params(LARGE_N, 28, DEEP_LEVELS, use_security_budget=False,
                                           num_special=LARGE_SPECIAL))
    top = modup_record(deep, dev, LARGE_BATCH, DEEP_LEVELS, LARGE_ALPHA, gen)
    check(top["max_abs_err"] == 0, f"ModUp at {top['shape']} differs from base_convert")
    top["kernel_over_bound"] = ratio(top["kernel_ms"], top["bound_ms"])
    records["modup_large"] = dict(modup_record(ctx, dev, LARGE_BATCH, L, LARGE_ALPHA, gen),
                                  deep_top=top)
    # ModDown at deep65536.ks_b8's top level: 54 + 4 limbs
    records["moddown_lift_large"], records["moddown_apply_large"] = moddown_records(
        deep, dev, LARGE_BATCH, DEEP_LEVELS, LARGE_SPECIAL, gen)
    print(f"[large] modup at {top['shape']}: bitwise vs plain, kernel-only {top['kernel_ms']} "
          f"ms, call {top['ms']:.4f} ms, plain {top['plain_ms']:.4f} ms, bound "
          f"{top['bound_ms']:.4f} ms by {top['bound_by']} (bytes {top['bound_bytes_ms']:.4f} ms, "
          f"operations {top['bound_ops_ms']:.4f} ms), kernel-only / bound "
          f"{top['kernel_over_bound']}")
    for kind, rec in at_path.items():
        top = at_largest[kind]
        check(top["max_abs_err"] == 0, f"{kind} at n={LARGEST_N} differs from its plain version")
        top["kernel_over_bound"] = ratio(top["kernel_ms"], top["bound_ms"])
        records[f"{kind}_large"] = dict(**origin(kind), match="bitwise vs plain", **rec,
                                        n131072=top)
        print(f"[large] {kind} at n={LARGEST_N}, {top['shape']}: bitwise vs plain, kernel-only "
              f"{top['kernel_ms']} ms, call {top['ms']:.4f} ms, plain {top['plain_ms']:.4f} ms, "
              f"bound {top['bound_ms']:.4f} ms by {top['bound_by']}, kernel-only / bound "
              f"{top['kernel_over_bound']}")
    summarize(records)
    return records


def large_ring_path(dev):
    """Phase 11: CKKS at n=65536, 40+4 limbs of 30 bits, batch 8, keys made
    on the card (alpha=4 relin and rotation keys, an alpha=1 relin key):
    encode + encrypt, mult + relin + rescale at alpha=4, rotate(1) at
    alpha=4, mult + relin + rescale at alpha=1, decrypt + decode, between a
    reset and a read of the launch counts; a CPU replay of one row;
    serialization of the product and of the alpha=4 relin key through a
    temporary directory; the noise probes on one row; CUDA-event times of
    the steps, traces of the key-switching ones; K1-K5 at the path's
    shapes and at n=131072. Returns (launch
    counts of the phase, the `*_large` kernel records)."""
    params = create_ckks_params(LARGE_N, scaling_bits=28, num_levels=LARGE_LEVELS,
                                num_special=LARGE_SPECIAL, use_security_budget=False)
    ctx = make_context(params)
    rng = np.random.default_rng(61)
    a, b = (rng.uniform(-1, 1, (LARGE_BATCH, LARGE_N // 2)) for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(61)
    log_qp = float(sum(np.log2(float(q)) for q in params.moduli + params.special_mods))
    print(f"[large] n={LARGE_N} L={LARGE_LEVELS}+{LARGE_SPECIAL}, log2 QP = {log_qp:.2f}, "
          f"alpha={LARGE_ALPHA} and 1, batch {LARGE_BATCH}")

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t_phase = t0 = time.perf_counter()
    sk = rlwe_mod.keygen(ctx, gen)
    rlk4 = keys_mod.relin_key(ctx, sk, gen, alpha=LARGE_ALPHA)
    rk4 = keys_mod.rot_key(ctx, sk, 1, gen, alpha=LARGE_ALPHA)
    rlk1 = keys_mod.relin_key(ctx, sk, gen)
    torch.cuda.synchronize()
    t_keys = time.perf_counter() - t0
    encode_encrypt = lambda x: ckks.encrypt(ctx, ckks.encode(x, params, device=dev), sk, gen)  # noqa: E731
    mult = lambda rlk: ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk))  # noqa: E731
    dec = lambda ct: ckks.decode(ckks.decrypt(ctx, ct, sk), params)  # noqa: E731
    ca, cb = encode_encrypt(a), encode_encrypt(b)
    prod4 = mult(rlk4)
    rot = ckks.rotate(ctx, prod4, rk4, 1)
    prod1 = mult(rlk1)
    out4, out_rot, out1 = dec(prod4), dec(rot), dec(prod1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_phase
    launches = dict(kernels.LAUNCHES)
    launch_rows = {k: dict(v) for k, v in kernels.LAUNCH_ROWS.items()}

    ab = a * b
    errs = dict(mult_alpha4=float(np.abs(out4 - ab).max()),
                rotate_alpha4=float(np.abs(out_rot - np.roll(ab, 1, axis=-1)).max()),
                mult_alpha1=float(np.abs(out1 - ab).max()))
    for out in (out4, out_rot, out1):
        check(out.shape == (LARGE_BATCH, LARGE_N // 2) and bool(np.isfinite(out).all()),
              f"large: decoded shape {out.shape} or values not finite")
    check(rot.limb_ids == tuple(range(LARGE_LEVELS - 1)), f"large: result limbs {rot.limb_ids}")
    check(errs["mult_alpha4"] <= MAX_ERR_MULT and errs["mult_alpha1"] <= MAX_ERR_MULT,
          f"large: mult decode errors {errs} above {MAX_ERR_MULT}")
    check(errs["rotate_alpha4"] <= MAX_ERR_LARGE_ROT,
          f"large: rotate decode error {errs['rotate_alpha4']} above {MAX_ERR_LARGE_ROT}")
    for name in TPU_KERNELS:
        check(launches[name] > 0, f"kernel {name} was not launched on the n={LARGE_N} path")
    check(launches["modup"] == launches["ext_prod_conv"],
          f"the n={LARGE_N} path did not launch one ModUp a K4 launch")
    key_gb = sum(k.data.numel() * 8 for k in (rlk4, rk4, rlk1)) / 1e9
    print(f"[large] keygen + keys {t_keys:.3f} s ({key_gb:.3f} GB as int64: alpha=4 "
          f"{list(rlk4.data.shape)} x 2, alpha=1 {list(rlk1.data.shape)}); keygen..decode "
          f"{wall:.3f} s (host clock); max|err| {json.dumps(errs)} (log2 "
          f"{json.dumps({k: round(float(np.log2(v)), 3) for k, v in errs.items()})}); launches "
          f"{json.dumps(launches)}; by rows {{rows: launches}} {json.dumps(launch_rows)}")
    seconds = dict(drive=wall)

    t0 = time.perf_counter()
    r = LARGE_REPLAY_ROWS
    prod_c = ckks.rescale(ctx, ckks.mult(ctx, _rows_on_cpu(ca, r), _rows_on_cpu(cb, r),
                                         _key_on_cpu(rlk4)))
    rot_c = ckks.rotate(ctx, prod_c, _key_on_cpu(rk4), 1)
    for got, card in ((prod_c, prod4), (rot_c, rot)):
        check(_same_ct(got, _rows_on_cpu(card, r)),
              "large: the card's ciphertexts differ from the plain CPU path")
    seconds["cpu_replay"] = time.perf_counter() - t0
    print(f"[large] plain CPU replay of {r} row(s) of the alpha=4 mult + rescale and the "
          f"rotate: bitwise equal, {seconds['cpu_replay']:.3f} s")
    del prod_c, rot_c

    t0 = time.perf_counter()
    files = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, obj in (("ciphertext", prod4), ("relin_key_alpha4", rlk4)):
            path = os.path.join(tmp, f"{tag}.npz")
            t1 = time.perf_counter()
            serialization.save(path, obj, params)
            t_save = time.perf_counter() - t1
            t1 = time.perf_counter()
            back, back_params = serialization.load(path, device=dev)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t1
            check(back_params == params, f"large: {tag} loaded with other parameters")
            if tag == "ciphertext":
                same = (_same_ct(back, obj) and back.c0.data.device == dev
                        and np.array_equal(dec(back), out4))
            else:
                same = (back.limb_ids == obj.limb_ids and back.alpha == obj.alpha
                        and back.data.device == dev and torch.equal(back.data, obj.data))
            check(same, f"large: the loaded {tag} differs from the saved one")
            files[tag] = dict(bytes=os.path.getsize(path), save_s=t_save, load_s=t_load)
            del back
    seconds["serialization"] = time.perf_counter() - t0
    print(f"[large] serialization (host seconds; .npz in the reference's format, deleted after): "
          f"{json.dumps(files)}; the loaded ciphertext and key are bitwise the saved ones on the "
          f"card, and the ciphertext decodes to the same slots")

    t0 = time.perf_counter()
    probes = {}
    fresh, after = _first_rows(ca, 1), _first_rows(prod4, 1)
    for tag, fn in (
            ("headroom_bits_fresh",
             lambda: noise.modulus_headroom_bits(ctx, (fresh.c0, fresh.c1), sk)),
            ("headroom_bits_after_mult",
             lambda: noise.modulus_headroom_bits(ctx, (after.c0, after.c1), sk)),
            ("ckks_error_bits_after_mult",
             lambda: noise.ckks_error_bits(ctx, after, sk, ab[0], params))):
        t1 = time.perf_counter()
        probes[tag] = fn()
        probes[f"{tag}_host_s"] = time.perf_counter() - t1
    check(probes["headroom_bits_fresh"] > probes["headroom_bits_after_mult"] > 0,
          f"large: headroom {probes} does not shrink with the mult")
    check(probes["ckks_error_bits_after_mult"] <= np.log2(MAX_ERR_MULT),
          f"large: ckks_error_bits {probes['ckks_error_bits_after_mult']} above the mult bound")
    seconds["noise"] = time.perf_counter() - t0
    print(f"[large] noise probes on one row (*_s: host seconds): {json.dumps(probes)}")

    t0 = time.perf_counter()
    per_ct = lambda fn: device_time(fn, 1, 3) * 1e3 / LARGE_BATCH  # noqa: E731
    metrics = dict(
        large_encode_encrypt_ms=per_ct(lambda: encode_encrypt(a)),
        large_mult_alpha4_ms_per_op=per_ct(lambda: mult(rlk4)),
        large_rotate_alpha4_ms_per_op=per_ct(lambda: ckks.rotate(ctx, prod4, rk4, 1)),
        large_mult_alpha1_ms_per_op=per_ct(lambda: mult(rlk1)),
        large_decrypt_decode_ms=per_ct(lambda: dec(prod4)),
    )
    print(f"[large] times (CUDA events, per ciphertext of a batch-{LARGE_BATCH} call), "
          f"{card_line()}: {json.dumps(metrics)}")
    print_traces("large", {"mult+relin+rescale alpha=4": lambda: mult(rlk4),
                           "rotate(1) alpha=4": lambda: ckks.rotate(ctx, prod4, rk4, 1),
                           "mult+relin+rescale alpha=1": lambda: mult(rlk1)}, LARGE_BATCH)
    seconds["times_and_traces"] = time.perf_counter() - t0
    del ca, cb, prod1, rot, rk4
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    records = large_kernel_records(ctx, dev, rlk1, rlk4)
    seconds["kernels"] = time.perf_counter() - t0
    seconds["phase"] = time.perf_counter() - t_phase
    print(f"[large] seconds of the phase (host clock): {json.dumps(seconds)}")
    return launches, records


def _par_setup(dev):
    """Phase 12's inputs and keys, made alike in every process: the main
    configuration's context and keys (secret, relin, rotation by 1 and by
    PIPE_ROT) from a generator seeded PAR_SEED on the card, the hybrid
    configuration's (12+2 limbs) secret and alpha=2 relin key from the same
    generator, and from a numpy generator seeded PAR_SEED random lazy
    residues [BATCH, L, n] (the reference's draws below 2^31, mod 2q): four
    ciphertext halves of each configuration, and rows for the sharded NTT."""
    params = create_ckks_params(N, scaling_bits=28, num_levels=LEVELS)
    ctx = make_context(params)
    hparams = create_ckks_params(N, scaling_bits=28, num_special=HYBRID_SPECIAL)
    hctx = make_context(hparams)
    gen = torch.Generator(device=dev).manual_seed(PAR_SEED)
    sk = rlwe_mod.keygen(ctx, gen)
    keys = dict(rlk=keys_mod.relin_key(ctx, sk, gen), rk=keys_mod.rot_key(ctx, sk, 1, gen),
                rk3=keys_mod.rot_key(ctx, sk, PIPE_ROT, gen))
    hsk = rlwe_mod.keygen(hctx, gen)
    keys["hrlk"] = keys_mod.relin_key(hctx, hsk, gen, alpha=ALPHA)
    rng = np.random.default_rng(PAR_SEED)
    ids, hids = tuple(range(LEVELS)), tuple(range(len(hparams.moduli)))
    res = lambda c, i: torch.from_numpy(entry.random_residues(rng, c, i, (BATCH,))).to(dev)  # noqa: E731
    mk = lambda c0, c1, i, p: ckks.CkksCt(RnsPoly(c0, "ntt", i), RnsPoly(c1, "ntt", i),  # noqa: E731
                                          p.initial_scaling_factor)
    x = [res(ctx, ids) for _ in range(4)]
    hx = [res(hctx, hids) for _ in range(4)]
    return dict(params=params, ctx=ctx, hparams=hparams, hctx=hctx, gen=gen, sk=sk, **keys,
                ca=mk(*x[:2], ids, params), cb=mk(*x[2:], ids, params),
                ha=mk(*hx[:2], hids, hparams), hb=mk(*hx[2:], hids, hparams),
                rows=res(ctx, ids))


def _par_single(s, kind):
    """The unsharded step of a phase-12 case kind in this process."""
    ctx, hctx = s["ctx"], s["hctx"]
    return {
        "mult": lambda: ckks.rescale(ctx, ckks.mult(ctx, s["ca"], s["cb"], s["rlk"])),
        "hybrid_mult": lambda: ckks.rescale(hctx, ckks.mult(hctx, s["ha"], s["hb"], s["hrlk"])),
        "rotate": lambda: ckks.rotate(ctx, s["ca"], s["rk"], 1),
        "ntt": lambda: (lambda f: (f, nttmod.intt(ctx, f, tuple(range(LEVELS)))))(
            nttmod.ntt(ctx, s["rows"], tuple(range(LEVELS)))),
    }[kind]


def _par_step(s, kind, shape):
    """This rank's part of a phase-12 case: (its step, a function giving
    the step's output tensors, where they lie in the unsharded output);
    made collectively (the mesh) by every rank of the world."""
    if kind == "ntt":
        mesh = pmesh.make_axis_mesh(shape, "seq")
        ids = tuple(range(LEVELS))
        fwd = ntt_sharded.make_sharded_ntt(s["ctx"], ids, mesh, "seq")
        inv = ntt_sharded.make_sharded_ntt(s["ctx"], ids, mesh, "seq", inverse=True)
        x = ntt_sharded.shard_rows(s["rows"], mesh, "seq")
        m = N // shape
        d = pmesh.axis_index(mesh, "seq")
        return ((lambda: (lambda f: (f, inv(f)))(fwd(x))), lambda out: out,
                dict(columns=(d * m, (d + 1) * m)))
    mesh = pmesh.make_mesh(*shape)
    hybrid = kind == "hybrid_mult"
    ctx = s["hctx"] if hybrid else s["ctx"]
    a = pmesh.shard_ct(mesh, s["ha"] if hybrid else s["ca"])
    b = pmesh.shard_ct(mesh, s["hb"] if hybrid else s["cb"])
    key = pmesh.shard_key(mesh, s[{"mult": "rlk", "hybrid_mult": "hrlk", "rotate": "rk"}[kind]],
                          a.parts, ctx.num_special)
    if kind == "rotate":
        step = lambda: pmesh.rotate(ctx, mesh, a, key, 1)  # noqa: E731
    else:
        step = lambda: pmesh.rescale(ctx, mesh, pmesh.mult(ctx, mesh, a, b, key))  # noqa: E731
    sizes = pmesh.split_sizes(BATCH, pmesh.axis_size(mesh, pmesh.BATCH_AXIS))
    at = pmesh.axis_index(mesh, pmesh.BATCH_AXIS)
    where = dict(batch=(sum(sizes[:at]), sum(sizes[:at + 1])))
    return step, lambda out: (out.ct.c0.data, out.ct.c1.data), where


def _digest(t) -> str:
    return hashlib.sha256(t.cpu().numpy().astype(np.uint32).tobytes()).hexdigest()


def _nccl_collectives(s):
    """NCCL's all_gather and broadcast over the world on the card: the main
    step's first input ciphertext as its uint32 bits through each, which
    must return it unchanged; their bytes and CUDA-event times (ms)."""
    dist = torch.distributed
    bits = nttmod.to_u32_bits(torch.stack([s["ca"].c0.data, s["ca"].c1.data]))
    gathered = [torch.empty_like(bits) for _ in range(dist.get_world_size())]
    sent = bits.clone()
    gather = lambda: dist.all_gather(gathered, bits)  # noqa: E731
    bcast = lambda: dist.broadcast(sent, src=0)  # noqa: E731
    gather()
    bcast()
    torch.cuda.synchronize()
    check(all(torch.equal(g, bits) for g in gathered) and torch.equal(sent, bits),
          "NCCL's all_gather or broadcast changed the data")
    return dict(bytes=bits.numel() * 4, all_gather_ms=device_time(gather, 1, 3) * 1e3,
                broadcast_ms=device_time(bcast, 1, 3) * 1e3)


def _par_rank(cases):
    """Phase 12 in one rank of a World: every case once between a reset and
    a read of the launch counts (the checked run), each output's sha256 and
    place; then each case's CUDA-event time (1 warm-up, 3 calls, every rank
    at once) and its collectives' calls, bytes and host seconds a call;
    under NCCL also _nccl_collectives."""
    dev = pmesh.rank_device()
    s = _par_setup(dev)
    steps = [_par_step(s, kind, shape) for kind, shape in cases]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    pmesh.reset_comm_stats()
    outs = [step() for step, _, _ in steps]
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    report = []
    for (step, tensors, where), out in zip(steps, outs):
        where = dict(where, digests=[_digest(t) for t in tensors(out)])
        if hasattr(out, "ct"):
            where["limbs"] = out.ct.c0.limb_ids
            where["scale"] = out.ct.scaling_factor
        pmesh.reset_comm_stats()
        ms = device_time(step, 1, 3) * 1e3
        calls = 4
        where["step_ms"] = ms
        where["comm_per_call"] = {op: dict(calls=c / calls, bytes=b / calls, host_s=h / calls)
                                  for op, (c, b, h) in pmesh.COMM.items()}
        report.append(where)
    nccl = _nccl_collectives(s) if torch.distributed.get_backend() == "nccl" else None
    return dict(rank=torch.distributed.get_rank(), launches=launches, cases=report, nccl=nccl)


@functools.lru_cache(maxsize=None)
def _par_output(kind):
    """The unsharded step's output of a case kind (_PAR_STATE's inputs)."""
    return _par_single(_PAR_STATE, kind)()


_PAR_STATE = None  # phase 12's inputs in this process (parallel_path)


def _par_expected(kind, where):
    """The sha256 of the unsharded step's part where a rank's output lies."""
    out = _par_output(kind)
    if kind == "ntt":
        c0, c1 = (t[..., where["columns"][0]:where["columns"][1]] for t in out)
    else:
        b0, b1 = where["batch"]
        c0, c1 = (p.data[b0:b1][..., list(where["limbs"]), :] for p in (out.c0, out.c1))
    return [_digest(c0), _digest(c1)]


def parallel_worlds(dev, s):
    """Phase 12 (a)-(c): each world of PAR_WORLDS started on the card, its
    cases run in every rank, every output checked against the unsharded
    step here, the ranks' launches summed. Returns (launch counts summed
    over the ranks of every world, the single-process step times)."""
    single_ms = {kind: device_time(_par_single(s, kind), 1, 3) * 1e3
                 for kind in ("mult", "hybrid_mult", "rotate", "ntt")}
    print(f"[parallel] single process, one batch-{BATCH} step (CUDA events, {card_line()}): "
          + json.dumps({k: dict(step_ms=v, ms_per_ct=v / BATCH) for k, v in single_ms.items()}))
    expected = {}
    total = {k: 0 for k in kernels.LAUNCHES}
    for size, cases in PAR_WORLDS:
        t0 = time.perf_counter()
        with pmesh.World(size, devices=[dev] * size, timeout=PAR_TIMEOUT) as world:
            backend = world.backend
            t_start = time.perf_counter() - t0
            ranks = world.run(_par_rank, cases)
        t_world = time.perf_counter() - t0
        launches = {k: sum(r["launches"][k] for r in ranks) for k in kernels.LAUNCHES}
        for k in total:
            total[k] += launches[k]
        label = "NCCL world of 1 rank on the card" if backend == "nccl" else \
            f"gloo world of {size} ranks, {SHARED_CARD}"
        for c, (kind, shape) in enumerate(cases):
            per_rank = []
            for r in ranks:
                where = r["cases"][c]
                key = (kind, json.dumps({k: v for k, v in where.items()
                                         if k in ("batch", "limbs", "columns")}))
                if key not in expected:
                    expected[key] = _par_expected(kind, where)
                check(where["digests"] == expected[key],
                      f"{backend} world of {size}, {kind} {shape}: rank {r['rank']}'s shard "
                      f"differs from the unsharded step")
                per_rank.append(dict(rank=r["rank"], step_ms=where["step_ms"],
                                     ms_per_ct=where["step_ms"] / BATCH,
                                     comm_per_call=where["comm_per_call"]))
            print(f"[parallel] {label}: {kind} on {'D=' if kind == 'ntt' else 'mesh '}{shape}: "
                  f"every shard bitwise the unsharded step's; per rank (CUDA events around one "
                  f"batch-{BATCH} step, every rank at once; ms_per_ct over the whole batch; "
                  f"collectives per call: bytes sent + received, host s), single process "
                  f"{single_ms[kind]:.4f} ms: {json.dumps(per_rank)}")
        if backend == "nccl":
            print(f"[parallel] {label}: NCCL all_gather and broadcast of the step's input "
                  f"returned it unchanged (CUDA events, {card_line()}): "
                  f"{json.dumps([r['nccl'] for r in ranks])}")
        print(f"[parallel] {label}: started in {t_start:.2f} s, {t_world:.2f} s in all (host "
              f"clock); launches in the ranks {json.dumps(launches)}")
        wanted = ("ntt_fwd", "ntt_inv", "ext_prod") + (
            ("ext_prod_conv", "ntt_stage") if size == 2 else ("ntt_stage",) if size == 4 else ())
        for k in wanted:
            check(launches[k] > 0, f"kernel {k} was not launched in the ranks of the {backend} "
                                   f"world of {size}")
    return total, single_ms


def parallel_dryrun():
    """Phase 12: entry.dryrun_multichip(DRYRUN_RANKS) as a user calls it,
    its ranks on the card (sharing it, over gloo); each rank asserts its
    shards bitwise. Checks that every rank ran on the card and that K1, K2,
    K3 and the stage kernel launched in the ranks."""
    t0 = time.perf_counter()
    reports = entry.dryrun_multichip(DRYRUN_RANKS)
    devices = sorted({r["device"] for r in reports})
    check(all(d.startswith("cuda") for d in devices),
          f"dryrun_multichip ran ranks on {devices}, not on the card")
    launches = {k: sum(r["launches"][k] for r in reports) for k in kernels.LAUNCHES}
    for k in ("ntt_fwd", "ntt_inv", "ext_prod", "ntt_stage"):
        check(launches[k] > 0, f"kernel {k} was not launched in dryrun_multichip's ranks")
    print(f"[parallel] dryrun_multichip({DRYRUN_RANKS}): ranks on {devices} ({SHARED_CARD}), "
          f"every shard bitwise the unsharded port's; {time.perf_counter() - t0:.2f} s (host "
          f"clock); launches in the ranks {json.dumps(launches)}")


def _decode_err(ctx, params, ct, sk, want):
    return float(np.abs(ckks.decode(ckks.decrypt(ctx, ct, sk), params) - want).max())


def parallel_pipelines(dev, s):
    """Phase 12 (d): PipelinedSquaringChain of depth PIPE_DEPTH and the
    square -> rotate(PIPE_ROT) -> halve Pipeline over [dev] * 3 (three
    streams of the card), PIPE_MICRO microbatches of BATCH encoded at
    PIPE_SCALE, bitwise the sequential chains and decoded against numpy
    (2^-8 a squaring; the rotate's bound MAX_ERR_ROT); then pipelined and
    sequential CUDA-event times."""
    ctx, params, sk, gen = s["ctx"], s["params"], s["sk"], s["gen"]
    rng = np.random.default_rng(PAR_SEED + 1)
    vs = [rng.uniform(-1, 1, (BATCH, N // 2)) * 0.9 for _ in range(PIPE_MICRO)]
    cts = [ckks.encrypt(ctx, ckks.encode(v, params, PIPE_SCALE, device=dev), sk, gen)
           for v in vs]
    half = np.full(N // 2, 0.5)
    square = lambda c, ct: ckks.rescale(c, ckks.mult(c, ct, ct, s["rlk"]))  # noqa: E731
    stages = [square, lambda c, ct: ckks.rotate(c, ct, s["rk3"], PIPE_ROT),
              lambda c, ct: ckks.rescale(c, ckks.mult_plain(c, ct, ckks.encode(
                  half, c.params, level=LEVELS - ct.c0.limb_count, device=dev)))]
    chain = pipemod.PipelinedSquaringChain(ctx, s["rlk"], PIPE_DEPTH, LEVELS, [dev] * PIPE_DEPTH)
    mixed = pipemod.Pipeline(ctx, stages, [dev] * len(stages))

    def sequential(fns):
        def run():
            outs = []
            for ct in cts:
                for fn in fns:
                    ct = fn(ctx, ct)
                outs.append(ct)
            return outs
        return run

    report = {}
    for tag, pipe, fns, want, bound in (
            ("squaring chain", chain, [square] * PIPE_DEPTH, [v**8 for v in vs],
             PIPE_DEPTH * MAX_ERR_MULT),
            ("square -> rotate -> halve", mixed, stages,
             [np.roll(v * v, PIPE_ROT, axis=-1) * 0.5 for v in vs], MAX_ERR_ROT)):
        got, seq = pipe.run(cts), sequential(fns)()
        for g, q in zip(got, seq):
            check(_same_ct(g, q), f"pipeline {tag}: differs from the sequential chain")
        errs = [_decode_err(ctx, params, g, sk, w) for g, w in zip(got, want)]
        check(max(errs) <= bound, f"pipeline {tag}: decode errors {errs} above {bound}")
        piped_ms = device_time(lambda: pipe.run(cts), 1, 3) * 1e3
        seq_ms = device_time(sequential(fns), 1, 3) * 1e3
        report[tag] = dict(max_abs_err=max(errs), bound=bound, pipelined_ms=piped_ms,
                           sequential_ms=seq_ms, speedup=seq_ms / piped_ms)
    print(f"[parallel] pipelines over [cuda:0] * 3 (three streams of one card), {PIPE_MICRO} "
          f"microbatches of {BATCH}: bitwise the sequential chains; CUDA events around one run "
          f"of all microbatches, {card_line()}: {json.dumps(report)}")


def staged_records(dev, gen):
    """Phase 12 (e) and the stage kernel's records: K1 / K2 at n=262144 on
    STAGED_SHAPE through ops.ntt (the stage kernel on the halves in place,
    then K1 / K2 on parts of 131072), bitwise the plain chains, timed as in
    phase 3; the stage kernel alone at the sharded NTT's cross stage
    ([BATCH, L, 1, N/2] pairs from two tensors, one half kept) and at
    n=262144's in-place stage, bitwise ntt_stage_plain. Returns (launches
    of one ntt and one intt, the records)."""
    rows, L = STAGED_SHAPE
    big = make_context(RlweParams(dimension=STAGED_N, moduli=hm.gen_ntt_primes(30, L, STAGED_N)))
    ids = tuple(range(L))
    x = lazy_residues(gen, (rows, L, STAGED_N), big.device_rows("two_q", ids, dev))
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    f = nttmod.ntt(big, x, ids)
    i = nttmod.intt(big, f, ids)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    records = {}
    for kind, got, inp in (("ntt_fwd", f, x), ("ntt_inv", i, f)):
        fwd = kind == "ntt_fwd"
        plain = nttmod.ntt_fwd if fwd else nttmod.ntt_inv
        names = nttmod.FWD_TABLES if fwd else nttmod.INV_TABLES
        t64 = [big.device_rows(nm, ids, dev) for nm in names]
        want = plain(inp, *t64)
        call = (lambda v=inp: nttmod.ntt(big, v, ids)) if fwd else \
            (lambda v=inp: nttmod.intt(big, v, ids))
        records[f"{kind}_staged"] = dict(
            **origin(kind), match="bitwise vs plain", shape=str([rows, L, STAGED_N]),
            max_abs_err=int((got - want).abs().max()), **timed(call),
            plain_ms=device_time(lambda: plain(inp, *t64), 1, 3) * 1e3, library_ms=None,
            **bound(2 * inp.numel() * 4, ntt_ops(rows * L, STAGED_N, not fwd), INT32_PER_S))

    ctx = make_context(create_ckks_params(N, scaling_bits=28, num_levels=LEVELS))
    lids = tuple(range(LEVELS))
    shapes = (("sharded", ctx, lids, (BATCH, LEVELS, 1, N // 2), 0),
              ("in_place", big, ids, (rows, L, 1, STAGED_N // 2), None))
    stage = {}
    for tag, c, i_, (R, L_, B, m), keep in shapes:
        two_q = c.device_rows("two_q", i_, dev)
        if keep is None:  # the halves of each block of rows in place
            x = lazy_residues(gen, (R, L_, B, 2, m), two_q[..., None, None])
            lo, hi = x[..., 0, :], x[..., 1, :]
            x32 = nttmod.to_u32_bits(x)
            lo32, hi32 = x32[..., 0, :], x32[..., 1, :]
        else:  # two tensors, as a rank and the block it received
            lo, hi = (lazy_residues(gen, (R, L_, B, m), two_q[..., None]) for _ in range(2))
            lo32, hi32 = nttmod.to_u32_bits(lo), nttmod.to_u32_bits(hi)
        tabs = {dt: [c.device_rows(nm, i_, dev, dt)[:, B:2 * B] for nm in ("tw_fwd", "tw_fwd_sh")]
                + [c.device_rows(nm, i_, dev, dt) for nm in ("q", "two_q")]
                for dt in (torch.int32, torch.int64)}
        got = nttmod.ntt_stage(lo, hi, *tabs[torch.int32], keep=keep)
        want = nttmod.ntt_stage_plain(lo, hi, *tabs[torch.int64])
        want = want if keep is None else want[..., keep, :]
        pairs = R * L_ * B * m
        out_words = pairs * (1 if keep is not None else 2)
        stage[tag] = dict(
            shape=f"pairs [{R}, {L_}, {B}, {m}], keep {keep}", max_abs_err=int((got - want).abs().max()),
            **timed(lambda: kernels.ntt_stage(lo32, hi32, *tabs[torch.int32], keep=keep)),
            plain_ms=device_time(lambda: nttmod.ntt_stage_plain(lo, hi, *tabs[torch.int64]),
                                 1, 3) * 1e3,
            library_ms=None,
            **bound(4 * (2 * pairs + out_words + 2 * L_ * B), pairs * FWD_BUTTERFLY_OPS,
                    INT32_PER_S))
    records["ntt_stage"] = dict(**origin("ntt_stage"), match="bitwise vs plain", **stage["sharded"],
                                n262144_in_place=stage["in_place"])
    check(stage["in_place"]["max_abs_err"] == 0, "the stage kernel in place differs from plain")
    summarize(records)
    return launches, records


def parallel_path(dev):
    """Phase 12. Returns (the launch counts of the phase: the ranks' and this
    process's pipelines and n=262144 transforms, those of one n=262144 ntt
    and intt, the stage kernel's and K1 / K2's n=262144 records)."""
    global _PAR_STATE
    t_phase = time.perf_counter()
    s = _PAR_STATE = _par_setup(dev)
    seconds = {}
    t0 = time.perf_counter()
    rank_launches, _ = parallel_worlds(dev, s)
    seconds["worlds"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    parallel_dryrun()
    seconds["dryrun"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    parallel_pipelines(dev, s)
    here = dict(kernels.LAUNCHES)
    seconds["pipelines"] = time.perf_counter() - t0
    _PAR_STATE = s = None
    _par_output.cache_clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    staged_launches, records = staged_records(dev, torch.Generator(device=dev).manual_seed(72))
    seconds["staged"] = time.perf_counter() - t0
    launches = {k: rank_launches[k] + here[k] + staged_launches[k] for k in kernels.LAUNCHES}
    seconds["phase"] = time.perf_counter() - t_phase
    print(f"[parallel] launches of the phase (ranks, pipelines, one n={STAGED_N} ntt and intt): "
          f"{json.dumps(launches)}; seconds (host clock): {json.dumps(seconds)}")
    return launches, staged_launches, records


def examples_path(dev):
    """Phase 14: the JAX package's three demos as the port's twins
    (hehub_tpu_torch.examples) on the card, as `python -m` runs them: the
    CKKS Basel series over EXAMPLE_TERMS terms, BGV (a + b)·c mod t, and
    the TFHE NAND truth table at PRESET_GATE_128 (`secure`). Each main()
    raises unless its own check passes. Prints each one's wall seconds
    (keys included) and its K1/K2/K3/K5 launches; returns the launch counts
    of the phase."""
    runs = (("ckks", lambda: ckks_example.main(EXAMPLE_TERMS, device=str(dev)),
             ("ntt_fwd", "ntt_inv", "ext_prod", "fft")),
            ("bgv", lambda: bgv_example.main(device=str(dev)), ("ntt_fwd", "ntt_inv", "ext_prod")),
            ("tfhe", lambda: tfhe_example.main(secure=True, device=str(dev)),
             ("ntt_fwd", "ntt_inv")))
    total = dict.fromkeys(kernels.LAUNCHES, 0)
    for name, run, kinds in runs:
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        for kind in kinds:
            check(launches[kind] > 0, f"kernel {kind} was not launched by the {name} example")
        for kind, count in launches.items():
            total[kind] += count
        result = result.tolist() if isinstance(result, np.ndarray) else result
        print(f"[examples] {name}_example.main(): its check passed ({result}); {wall:.3f} s "
              f"wall (host clock, keygen included), {card_line()}; launches "
              f"{json.dumps({k: launches[k] for k in ('ntt_fwd', 'ntt_inv', 'ext_prod', 'fft')})}")
    return total


def _snapshot():
    return dict(kernels.LAUNCHES)


def _since(before):
    return {k: v - before[k] for k, v in kernels.LAUNCHES.items()}


def staged_ext_records(ctx, dev, rlk1, rlk4, gen):
    """The external product by parts at phase 15's shapes: `ext_prod_staged`
    (alpha=1, strict digits [8, 40, n] with the path's relin key through
    rgsw.ext_prod_strict: the stage kernel and K4 on parts) and
    `ext_prod_conv_staged` (lazy converted digits [8, 10, 44, n] with the
    alpha=4 key through rgsw.ext_prod_digits), each bitwise its plain twin
    (on the card, a row at a time), timed as in phase 3; then both at the
    top ring kernels.MAX_N (one prime: l = 2 strict limbs at alpha=1, and
    converted digits D = 2, L_ext = 3) under `n8388608`."""
    n, ids_ext = STAGED_N, rlk1.limb_ids
    L, L_ext = LARGE_LEVELS, len(ids_ext)
    D = -(-L // LARGE_ALPHA)
    strict = torch.stack([torch.randint(0, m, (STAGED_BATCH, n), generator=gen, device=dev)
                          for m in ctx.moduli_of(tuple(range(L)))], dim=1)
    conv = lazy_residues(gen, (STAGED_BATCH, D, L_ext, n), ctx.device_rows("two_q", ids_ext, dev))

    def strict_record(c, d, key):
        R, l, n_ = d.data.shape
        L_e = len(key.limb_ids)
        call = lambda: rgsw_mod.ext_prod_strict(c, d, key)  # noqa: E731
        got = call()
        plain = lambda r: rgsw_mod.ext_prod_parts(  # noqa: E731
            c, RnsPoly(d.data[r:r + 1], COEFF, d.limb_ids), key, kernels.MAX_ROW_N, False)
        err = 0
        for r in range(R):
            want = plain(r)
            err = max(err, int((got.c0.data[r:r + 1] - want.c0.data).abs().max()),
                      int((got.c1.data[r:r + 1] - want.c1.data).abs().max()))
        del got, want
        return dict(shape=f"R={R}, l={l}, L_ext={L_e}, n={n_}", max_abs_err=err, **timed(call),
                    plain_ms=device_time(lambda: [plain(r) for r in range(R)], 0, 1) * 1e3,
                    library_ms=None,
                    **bound(4 * (R * l * n_ + l * 2 * L_e * n_ + 2 * R * L_e * n_),
                            ntt_ops(R * l * L_e, n_) + R * l * L_e * n_ * 2 * CONTRACT_OPS,
                            INT32_PER_S))

    def conv_record(c, ids_e, digits, key):
        R, D_, L_e, n_ = digits.shape
        route = rgsw_mod.parts_route(c, ids_e, n_, kernels.MAX_ROW_N, dev, True)
        plain_route = rgsw_mod.parts_route(c, ids_e, n_, kernels.MAX_ROW_N, dev, False)
        key32 = nttmod.to_u32_bits(key[:D_])
        d32 = nttmod.to_u32_bits(digits)
        got = nttmod.from_u32_bits(rgsw_mod.ext_prod_digits(d32.clone(), key32, route, True))
        plain = lambda r: rgsw_mod.ext_prod_digits(  # noqa: E731
            digits[r:r + 1], key[:D_], plain_route, False)
        err = max(int((got[:, r:r + 1] - plain(r)).abs().max()) for r in range(R))
        del got
        # the cross stages run in place: the timed calls take the previous
        # call's digits, lazy residues as well
        return dict(shape=f"R={R}, D={D_}, L_ext={L_e}, n={n_}", max_abs_err=err,
                    **timed(lambda: rgsw_mod.ext_prod_digits(d32, key32, route, True)),
                    plain_ms=device_time(lambda: [plain(r) for r in range(R)], 0, 1) * 1e3,
                    library_ms=None,
                    **bound(4 * (digits.numel() + D_ * 2 * L_e * n_ + 2 * R * L_e * n_),
                            ntt_ops(R * D_ * L_e, n_) + R * D_ * L_e * n_ * 2 * CONTRACT_OPS,
                            INT32_PER_S))

    at_path = dict(
        ext_prod=strict_record(ctx, RnsPoly(strict, COEFF, tuple(range(L))), rlk1),
        ext_prod_conv=conv_record(ctx, ids_ext, conv, rlk4.data))
    del strict, conv
    torch.cuda.empty_cache()

    top_n = kernels.MAX_N
    R, l = TOP_EXT
    q = hm.gen_ntt_primes(30, 1, top_n)[0]
    top = make_context(RlweParams(dimension=top_n, moduli=(q,)))
    ids_top = (0,) * (l + 1)
    key = rgsw_mod.RgswCt(torch.randint(0, 2 * q, (l, 2, l + 1, top_n), generator=gen,
                                        device=dev), ids_top)
    d = RnsPoly(torch.randint(0, q, (R, l, top_n), generator=gen, device=dev), COEFF, (0,) * l)
    conv = torch.randint(0, 2 * q, (R, l, l + 1, top_n), generator=gen, device=dev)
    at_top = dict(ext_prod=strict_record(top, d, key),
                  ext_prod_conv=conv_record(top, ids_top, conv, key.data))
    records = {}
    for kind, rec in at_path.items():
        t = at_top[kind]
        check(t["max_abs_err"] == 0, f"{kind} by parts at n={top_n} differs from its plain twin")
        t["kernel_over_bound"] = ratio(t["kernel_ms"], t["bound_ms"])
        records[f"{kind}_staged"] = dict(
            **origin(kind), match="bitwise vs plain (the stage kernel, then K4 on parts)", **rec,
            **{f"n{top_n}": t})
        print(f"[staged] {kind} by parts at n={top_n}, {t['shape']}: bitwise vs plain, "
              f"kernel-only {t['kernel_ms']} ms, call {t['ms']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms by {t['bound_by']}, "
              f"kernel-only / bound {t['kernel_over_bound']}")
    return records


def staged_fft_records(dev, gen):
    """`fft_staged`: ops.fft.fft on [STAGED_BATCH, STAGED_N / 2] (K5 on parts
    of 65536, then F), bitwise fft_plain, timed as in phase 3 beside
    torch.fft.fft; `fft_stage`: F alone in place, the last stage (span m/2)
    of those rows, bitwise fft_stage_plain; each also on [1, MAX_N / 2]
    under `m4194304`."""
    def fft_record(rows, m):
        re, im = (torch.rand((rows, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
                  for _ in range(2))
        got, want = fftmod.fft(re, im, m), fftmod.fft_plain(re, im, m)
        natural = torch.complex(re, im)
        tw = fftmod._device_tables(m, str(dev))
        return dict(shape=f"[{rows}, {m}]",
                    max_abs_err=max(float((got[0] - want[0]).abs().max()),
                                    float((got[1] - want[1]).abs().max())),
                    **timed(lambda: fftmod.fft(re, im, m)),
                    plain_ms=device_time(lambda: fftmod.fft_plain(re, im, m), 1, 3) * 1e3,
                    library_ms=device_time(lambda: torch.fft.fft(natural)) * 1e3,
                    **kernel_only(lambda: torch.fft.fft(natural), False, "library_kernel_ms"),
                    **bound(4 * re.numel() * 8 + 2 * tw[0].numel() * 8,
                            rows * (m // 2) * (m.bit_length() - 1) * FFT_BUTTERFLY_FLOPS,
                            FP64_PER_S))

    def stage_record(rows, m):
        t = m // 2
        re, im = (torch.rand((rows, m), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
                  for _ in range(2))
        tw = fftmod._device_tables(m, str(dev))
        want = fftmod.fft_stage_plain(re, im, t, *tw)
        got_re, got_im = re.clone(), im.clone()
        kernels.fft_stage(got_re, got_im, *tw, t)
        # in place: the timed calls take the previous call's output
        return dict(shape=f"[{rows}, {m}], span {t}, in place",
                    max_abs_err=max(float((got_re - want[0]).abs().max()),
                                    float((got_im - want[1]).abs().max())),
                    **timed(lambda: kernels.fft_stage(got_re, got_im, *tw, t)),
                    plain_ms=device_time(lambda: fftmod.fft_stage_plain(re, im, t, *tw),
                                         1, 3) * 1e3,
                    library_ms=None,
                    **bound(4 * re.numel() * 8 + 2 * t * 8, rows * (m // 2) * FFT_BUTTERFLY_FLOPS,
                            FP64_PER_S))

    top_m = kernels.MAX_N // 2
    records = {}
    for kind, make in (("fft", fft_record), ("fft_stage", stage_record)):
        rec, t = make(STAGED_BATCH, STAGED_N // 2), make(TOP_FFT_ROWS, top_m)
        check(t["max_abs_err"] == 0, f"{kind} at m={top_m} differs from its plain version")
        t["kernel_over_bound"] = ratio(t["kernel_ms"], t["bound_ms"])
        t["kernel_over_library"] = ratio(t["kernel_ms"], t.get("library_kernel_ms"))
        name = "fft_staged" if kind == "fft" else "fft_stage"
        records[name] = dict(**origin(kind), match="bitwise vs plain", **rec, **{f"m{top_m}": t})
        print(f"[staged] {name} at m={top_m}, {t['shape']}: bitwise vs plain, kernel-only "
              f"{t['kernel_ms']} ms, call {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']}, library call {t['library_ms']} ms, "
              f"library kernel-only {t.get('library_kernel_ms')} ms")
    return records


def staged_ring_path(dev):
    """Phase 15: CKKS at n = STAGED_N, 40+4 limbs of 30 bits, batch 8, keys
    made on the card (alpha=4 relin and rotation keys, an alpha=1 relin
    key): encode + encrypt (the device codec: K5 on parts of 65536, then F),
    mult + relin + rescale at alpha=4, rotate(1) at alpha=4, mult + relin +
    rescale at alpha=1 (the key switches: the stage kernel, then K4 on
    parts), decrypt + decode, between a reset and a read of the launch
    counts; a CPU replay of one row of the alpha=4 mult's key switch;
    CUDA-event times per ciphertext, peak device memory, traces of the
    key-switching steps; the routes by parts' records. Returns the `*_staged` and `fft_stage`
    records, their launches filled in from the driven run."""
    t_phase = time.perf_counter()
    params = create_ckks_params(STAGED_N, scaling_bits=28, num_levels=LARGE_LEVELS,
                                num_special=LARGE_SPECIAL, use_security_budget=False)
    ctx = make_context(params)
    t_setup = time.perf_counter() - t_phase
    rng = np.random.default_rng(151)
    a, b = (rng.uniform(-1, 1, (STAGED_BATCH, STAGED_N // 2)) for _ in range(2))
    gen = torch.Generator(device=dev).manual_seed(151)
    print(f"[staged] n={STAGED_N} L={LARGE_LEVELS}+{LARGE_SPECIAL}, alpha={LARGE_ALPHA} and 1, "
          f"batch {STAGED_BATCH}; context {t_setup:.3f} s (host clock)")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    sk = rlwe_mod.keygen(ctx, gen)
    rlk4 = keys_mod.relin_key(ctx, sk, gen, alpha=LARGE_ALPHA)
    rk4 = keys_mod.rot_key(ctx, sk, 1, gen, alpha=LARGE_ALPHA)
    rlk1 = keys_mod.relin_key(ctx, sk, gen)
    torch.cuda.synchronize()
    t_keys = time.perf_counter() - t0
    encode_encrypt = lambda x: ckks.encrypt(ctx, ckks.encode(x, params, device=dev), sk, gen)  # noqa: E731
    mult = lambda rlk: ckks.rescale(ctx, ckks.mult(ctx, ca, cb, rlk))  # noqa: E731
    dec = lambda ct: ckks.decode(ckks.decrypt(ctx, ct, sk), params)  # noqa: E731
    steps = {}
    before = _snapshot()
    ca, cb = encode_encrypt(a), encode_encrypt(b)
    steps["encode_encrypt"], before = _since(before), _snapshot()
    prod4 = mult(rlk4)
    steps["mult_alpha4"], before = _since(before), _snapshot()
    rot = ckks.rotate(ctx, prod4, rk4, 1)
    steps["rotate_alpha4"], before = _since(before), _snapshot()
    prod1 = mult(rlk1)
    steps["mult_alpha1"], before = _since(before), _snapshot()
    out4, out_rot, out1 = dec(prod4), dec(rot), dec(prod1)
    steps["decrypt_decode"] = _since(before)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    ab = a * b
    errs = dict(mult_alpha4=float(np.abs(out4 - ab).max()),
                rotate_alpha4=float(np.abs(out_rot - np.roll(ab, 1, axis=-1)).max()),
                mult_alpha1=float(np.abs(out1 - ab).max()))
    for out in (out4, out_rot, out1):
        check(out.shape == (STAGED_BATCH, STAGED_N // 2) and bool(np.isfinite(out).all()),
              f"staged: decoded shape {out.shape} or values not finite")
    check(max(errs["mult_alpha4"], errs["mult_alpha1"]) <= MAX_ERR_STAGED_MULT,
          f"staged: mult decode errors {errs} above {MAX_ERR_STAGED_MULT}")
    check(errs["rotate_alpha4"] <= MAX_ERR_LARGE_ROT,
          f"staged: rotate decode error {errs['rotate_alpha4']} above {MAX_ERR_LARGE_ROT}")
    for name in ("ntt_stage", "ntt_fwd", "ntt_inv", "ext_prod_conv", "fft", "fft_stage"):
        check(launches[name] > 0, f"kernel {name} was not launched on the n={STAGED_N} path")
    check(launches["ext_prod"] == 0, f"K3's own kernel was launched at n={STAGED_N}")
    for step in ("mult_alpha4", "rotate_alpha4", "mult_alpha1"):
        check(steps[step]["ext_prod_conv"] > 0 and steps[step]["ntt_stage"] > 0,
              f"staged: {step} did not go through the stage kernel and K4")
    key_gb = sum(k.data.numel() * 8 for k in (rlk4, rk4, rlk1)) / 1e9
    print(f"[staged] keygen + keys {t_keys:.3f} s ({key_gb:.3f} GB as int64: alpha=4 "
          f"{list(rlk4.data.shape)} x 2, alpha=1 {list(rlk1.data.shape)}); keygen..decode "
          f"{wall:.3f} s (host clock); peak device memory {peak_gb:.3f} GB; max|err| "
          f"{json.dumps(errs)} (log2 "
          f"{json.dumps({k: round(float(np.log2(v)), 3) for k, v in errs.items()})}); launches "
          f"{json.dumps(launches)}; by step {json.dumps(steps)}")
    seconds = dict(context=t_setup, drive=wall)

    t0 = time.perf_counter()
    r = STAGED_REPLAY_ROWS
    c2 = ckks.mult_low_level(ctx, ca, cb).c2
    key = rlk4.at_level(c2.limb_count, ctx.num_special)
    ks = rgsw_mod.ext_prod(ctx, c2, key)
    ks_c = rgsw_mod.ext_prod(ctx, RnsPoly(c2.data[:r].cpu(), c2.form, c2.limb_ids),
                             _key_on_cpu(key))
    check(all(torch.equal(got.data, card.data[:r].cpu())
              for got, card in ((ks_c.c0, ks.c0), (ks_c.c1, ks.c1))),
          "staged: the card's alpha=4 key switch differs from the plain CPU path")
    seconds["cpu_replay"] = time.perf_counter() - t0
    print(f"[staged] plain CPU replay of the alpha=4 mult's ext_prod on {r} row(s) of the "
          f"batch-{STAGED_BATCH} tensor product (the whole mult + rescale row took 121.9 s of "
          f"host time on the H100 machine's CPU, over the phase's 120 s budget): bitwise "
          f"equal, {seconds['cpu_replay']:.3f} s (host clock)")
    del c2, ks, ks_c, key

    t0 = time.perf_counter()
    per_ct = lambda fn: device_time(fn, 1, 3) * 1e3 / STAGED_BATCH  # noqa: E731
    metrics = dict(
        staged_encode_encrypt_ms=per_ct(lambda: encode_encrypt(a)),
        staged_mult_alpha4_ms_per_op=per_ct(lambda: mult(rlk4)),
        staged_rotate_alpha4_ms_per_op=per_ct(lambda: ckks.rotate(ctx, prod4, rk4, 1)),
        staged_mult_alpha1_ms_per_op=per_ct(lambda: mult(rlk1)),
        staged_decrypt_decode_ms=per_ct(lambda: dec(prod4)),
    )
    print(f"[staged] times (CUDA events, per ciphertext of a batch-{STAGED_BATCH} call), "
          f"{card_line()}: {json.dumps(metrics)}; peak device memory "
          f"{torch.cuda.max_memory_allocated(dev) / 1e9:.3f} GB")
    print_traces("staged", {"mult+relin+rescale alpha=4": lambda: mult(rlk4),
                            "rotate(1) alpha=4": lambda: ckks.rotate(ctx, prod4, rk4, 1),
                            "mult+relin+rescale alpha=1": lambda: mult(rlk1)}, STAGED_BATCH)
    seconds["times_and_traces"] = time.perf_counter() - t0
    del ca, cb, prod1, prod4, rot, rk4, sk
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    kgen = torch.Generator(device=dev).manual_seed(152)
    records = staged_ext_records(ctx, dev, rlk1, rlk4, kgen)
    del rlk1, rlk4
    torch.cuda.empty_cache()
    records.update(staged_fft_records(dev, kgen))
    seconds["kernels"] = time.perf_counter() - t0
    by_record = dict(
        ext_prod_staged=steps["mult_alpha1"]["ext_prod_conv"],
        ext_prod_conv_staged=steps["mult_alpha4"]["ext_prod_conv"]
        + steps["rotate_alpha4"]["ext_prod_conv"],
        fft_staged=launches["fft"], fft_stage=launches["fft_stage"])
    for name, count in by_record.items():
        records[name]["launches"] = count
        records[name]["launches_by_path"] = {"staged_ring": count}
        check(count > 0, f"kernel {name} was not launched on the n={STAGED_N} path")
    summarize(records)
    seconds["phase"] = time.perf_counter() - t_phase
    print(f"[staged] seconds of the phase (host clock): {json.dumps(seconds)}")
    return records


def sse_kernel_records(ctx, dev, sse, gen):
    """ModUp and K4 at the SSE switches' shapes, batch 1: ModUp on [1, 1 ->
    1 x 5, n] (the switch into the ephemeral secret at one limb, its key on
    q0 and the special primes only) and on [1, 47 -> 12 x 51, n] (the switch
    back at the top, and every key switch of the first CoeffToSlot step)
    against base_convert(signed=True) per digit group; K4 at D=1, L_ext=5
    and at D=12, L_ext=51 under the two SSE keys against its plain version;
    K1 on [1, 47, n] and K2 on [1, 1, n] (mod_raise's); all on the same card
    tensors, bitwise, timed as in phase 3. The top shapes are nested under
    `top`."""
    n, L = ctx.params.dimension, SSE_LEVELS
    records = {}
    low, top = (modup_record(ctx, dev, 1, l, SSE_ALPHA, gen) for l in (1, L))
    records["modup_sse"] = dict(low, top=top)
    convs = []
    for key in sse:
        D, ids_ext = key.rows, key.limb_ids
        digits = lazy_residues(gen, (1, D, len(ids_ext), n),
                               ctx.device_rows("two_q", ids_ext, dev))
        convs.append(dict(**origin("ext_prod_conv"), match="bitwise vs plain",
                          **large_ext_record("ext_prod_conv", ctx, dev, digits, key)))
        del digits
    records["ext_prod_conv_sse"] = dict(convs[0], top=convs[1])
    records["ntt_fwd_sse"] = dict(**origin("ntt_fwd"), match="bitwise vs plain",
                                  **large_ntt_record("ntt_fwd", ctx, dev, (1, L, n), gen))
    records["ntt_inv_sse"] = dict(**origin("ntt_inv"), match="bitwise vs plain",
                                  **large_ntt_record("ntt_inv", ctx, dev, (1, 1, n), gen))
    # ModDown at a key switch of the refresh's top level: 47 + 4 limbs
    records["moddown_lift_sse"], records["moddown_apply_sse"] = moddown_records(
        ctx, dev, 1, L, ctx.num_special, gen)
    for name, rec in records.items():
        for r in (rec, rec.get("top")):
            if r is not None:
                check(r["max_abs_err"] == 0, f"{name} at {r['shape']} differs from its plain "
                                             f"version")
    summarize(records)
    for name in ("modup_sse", "ext_prod_conv_sse"):
        t = records[name]["top"]
        t["kernel_over_bound"] = ratio(t["kernel_ms"], t["bound_ms"])
        print(f"[sse] {name} at {t['shape']}: bitwise vs plain, kernel-only {t['kernel_ms']} "
              f"ms, call {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms by {t['bound_by']}, kernel-only / bound "
              f"{t['kernel_over_bound']}")
    return records


def sse_path(dev):
    """Phase 16: the 128-bit bootstrap set's sparse-secret encapsulation and
    its first CoeffToSlot steps, batch 1, keys made on the card (the two SSE
    keys, the 15 giant rotations of the first CoeffToSlot pair and the 7
    baby rotations of the third CoeffToSlot factor). Bootstrapper(sse=...)
    .raise_modulus on one exhausted ciphertext (SSE in at one limb,
    mod_raise, SSE out at the top), then the first CoeffToSlot pair
    (c2sR0, c2sI0: giant rotations only, by rotate_accumulate) and the
    hoisted rotations of the third factor's babies at the top level, each
    with the launches of its own run (counts reset just before it): one
    ModUp a K4 launch in the first two, one ModUp and no K4 in the hoisted
    one. The ciphertext under the ephemeral secret decodes within
    MAX_ERR_SSE of v; raise_modulus replayed on the CPU bitwise; CUDA-event
    times of each; then the kernels at these shapes (sse_kernel_records).
    Returns (launch counts of the phase, the `*_sse` records)."""
    tag = "sse"
    params = bs.make_boot_params(SSE_N, SSE_LEVELS, num_special=SSE_SPECIAL)
    params = dataclasses.replace(params, initial_scaling_factor=float(
        params.moduli[-1] * params.moduli[-2]))
    ctx = make_context(params)
    s = SSE_N // 2
    gen = torch.Generator(device=dev).manual_seed(71)
    v = np.random.default_rng(7).uniform(-1, 1, s)
    log_qp = float(sum(np.log2([float(q) for q in (*params.moduli, *params.special_mods)])))
    print(f"[{tag}] n={SSE_N} L={SSE_LEVELS}+{SSE_SPECIAL} (log2 QP = {log_qp:.1f}), "
          f"alpha={SSE_ALPHA}, secret weight {SSE_WEIGHT}, ephemeral weight {SSE_EPH_WEIGHT}, "
          f"Δ_in = 2^{np.log2(SSE_D_IN):.0f}, lt_stages={SSE_LT_STAGES}, batch 1")

    t0 = time.perf_counter()
    sk = rlwe_mod.keygen(ctx, gen, hamming_weight=SSE_WEIGHT)
    sk_eph = rlwe_mod.keygen(ctx, gen, hamming_weight=SSE_EPH_WEIGHT)
    sse = keys_mod.sse_keys(ctx, sk, sk_eph, gen, alpha=SSE_ALPHA)
    c2s_r, c2s_im, _, _ = bs._merged_chain_matrices(SSE_N, SSE_LT_STAGES)
    B = bs._bsgs_split(s)[0]
    offsets = bs._nonzero_diagonals(c2s_r[0]).tolist() + bs._nonzero_diagonals(c2s_im[0]).tolist()
    giants = sorted({(-(k // B) * B) % s for k in offsets if k // B})
    babies = sorted({(-(k % B)) % s for k in bs._nonzero_diagonals(c2s_r[2]).tolist() if k % B})
    rks = {st: keys_mod.rot_key(ctx, sk, st, gen, alpha=SSE_ALPHA) for st in giants + babies}
    ct = ckks.encrypt(ctx, ckks.encode(v, params, scaling_factor=SSE_D_IN,
                                       level=SSE_LEVELS - 1, device=dev), sk, gen)
    torch.cuda.synchronize()
    print(f"[{tag}] keys (2 SSE, {len(giants)} giant and {len(babies)} baby rotations) and "
          f"encrypt {time.perf_counter() - t0:.3f} s, SSE keys "
          f"{sum(k.data.numel() * 8 for k in sse) / 1e9:.3f} GB as int64, key limbs "
          f"{[len(k.limb_ids) for k in sse]}, digit rows {[k.rows for k in sse]}")
    booter = bs.Bootstrapper(ctx, params, None, rks, None, SSE_K_BOUND, lt_stages=SSE_LT_STAGES,
                             sse=sse)

    check(sse[0].limb_ids == (0,) + ctx.special_indices,
          f"{tag}: the key into the ephemeral secret lies on {sse[0].limb_ids}")
    under_eph = ckks.switch_key(ctx, ct, sse[0])
    err = _decode_err(ctx, params, under_eph, sk_eph, v)
    check(err <= MAX_ERR_SSE, f"{tag}: decode error {err} under the ephemeral secret above "
                              f"{MAX_ERR_SSE}")
    print(f"[{tag}] SSE in: decoded under the ephemeral secret within {err:.3e} of v "
          f"(bound {MAX_ERR_SSE})")

    runs, launches = {}, {k: 0 for k in kernels.LAUNCHES}

    def run(what, call):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = call()
        torch.cuda.synchronize()
        runs[what] = dict(launches={k: c for k, c in kernels.LAUNCHES.items() if c},
                          rows={k: dict(r) for k, r in kernels.LAUNCH_ROWS.items() if r})
        for k, c in kernels.LAUNCHES.items():
            launches[k] += c
        print(f"[{tag}] {what}: launches {json.dumps(runs[what]['launches'])}, rows "
              f"{json.dumps(runs[what]['rows'])}")
        return out

    raised = run("raise_modulus", lambda: booter.raise_modulus(ct))
    target = raised.scaling_factor * booter._balanced_pt_scale(raised, len(c2s_r))
    specs = (("c2sR0", c2s_r[0]), ("c2sI0", c2s_im[0]))
    for name, M in specs:  # the plans outside the counted run
        booter._plan(name, M, raised, target)
    pair = run("c2s_pair", lambda: booter._lt_pair(*specs, raised, target))
    hoisted = run("hoisted", lambda: ckks.hoisted_rotations(ctx, raised, rks, babies))
    r = {w: runs[w]["launches"] for w in runs}
    check(r["raise_modulus"].get("modup") == r["raise_modulus"].get("ext_prod_conv") == 2,
          f"{tag}: raise_modulus launched {r['raise_modulus']}, not 2 ModUp and 2 K4")
    check(r["c2s_pair"].get("modup") == r["c2s_pair"].get("ext_prod_conv") == 2 * (len(giants)),
          f"{tag}: the first CoeffToSlot pair launched {r['c2s_pair']}")
    check(r["hoisted"].get("modup") == 1 and not r["hoisted"].get("ext_prod_conv")
          and r["hoisted"].get("ntt_fwd", 0) >= 1,
          f"{tag}: the hoisted rotations launched {r['hoisted']}")
    check(raised.c0.limb_count == SSE_LEVELS and pair[0].c0.limb_count == SSE_LEVELS - 1
          and len(hoisted) == len(babies), f"{tag}: limbs {raised.c0.limb_count}, "
                                           f"{pair[0].c0.limb_count}; {len(hoisted)} rotations")

    t0 = time.perf_counter()
    cpu = bs.Bootstrapper(ctx, params, None, {}, None, SSE_K_BOUND, lt_stages=SSE_LT_STAGES,
                          sse=tuple(_key_on_cpu(k) for k in sse))
    raised_c = cpu.raise_modulus(_boot_ct_on_cpu(ct))
    check(_same_ct(_boot_ct_on_cpu(raised), raised_c),
          f"{tag}: the card's raise_modulus differs from the plain CPU path")
    print(f"[{tag}] plain CPU replay of raise_modulus (SSE in, mod_raise, SSE out): bitwise "
          f"equal to the card's ({time.perf_counter() - t0:.1f} s on the CPU)")

    times = {
        "sse_in": device_time(lambda: ckks.switch_key(ctx, ct, sse[0]), 1, 5),
        "raise_modulus": device_time(lambda: booter.raise_modulus(ct), 1, 5),
        "c2s_pair": device_time(lambda: booter._lt_pair(*specs, raised, target), 1, 3),
        "hoisted": device_time(lambda: ckks.hoisted_rotations(ctx, raised, rks, babies), 1, 3),
    }
    print(f"[{tag}] CUDA-event ms, batch 1, {card_line()}: "
          f"{json.dumps({k: t * 1e3 for k, t in times.items()})}")
    del pair, hoisted, raised, raised_c, cpu, booter, rks
    torch.cuda.empty_cache()
    records = sse_kernel_records(ctx, dev, sse, gen)
    return launches, records


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = card_line()
    device_name = torch.cuda.get_device_name(0)
    print(f"[device] {card}")
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

    params = create_ckks_params(N, scaling_bits=28, num_levels=LEVELS)
    ctx = make_context(params)
    hctx = make_context(create_ckks_params(N, scaling_bits=28, num_special=HYBRID_SPECIAL))
    records = kernels_vs_plain(ctx, hctx, dev)
    small_records = small_kernels(dev)
    torch.cuda.empty_cache()
    main_launches, main_rows, main_steps = main_path(params, ctx, dev)
    torch.cuda.empty_cache()
    hybrid_launches, hybrid_rows, hybrid_steps = hybrid_path(dev)
    torch.cuda.empty_cache()
    small_launches = small_path(dev)
    torch.cuda.empty_cache()
    circuit_launches, circuit_rows, circuit_timings = circuits_path(dev)
    bgv_launches, bgv_rows, bgv_steps, bgv_small_launches, bgv_timings = bgv_path(dev)
    path_rows = {"main": main_rows, "hybrid": hybrid_rows, "circuits": circuit_rows,
                 "bgv": bgv_rows}
    sweep = ntt_row_sweep(hctx, dev, tuple(path_rows.values()))
    weighted = launch_weighted(sweep, path_rows, {"main": main_steps, "hybrid": hybrid_steps,
                                                  "bgv": bgv_steps})
    torch.cuda.empty_cache()
    tfhe_launches, tfhe_records, tfhe_gate_rows, tfhe_traces = tfhe_path(dev)
    circuit_timings()
    bgv_timings()
    del circuit_timings, bgv_timings
    torch.cuda.empty_cache()
    boot_launches, boot_records = bootstrap_path(dev, BOOT_N)
    torch.cuda.empty_cache()
    large_launches, large_records = large_ring_path(dev)
    torch.cuda.empty_cache()
    par_launches, staged_launches, par_records = parallel_path(dev)
    torch.cuda.empty_cache()
    boot16_launches, boot16_records = bootstrap_path(dev, BOOT16_N, flagship=True)
    torch.cuda.empty_cache()
    example_launches = examples_path(dev)
    torch.cuda.empty_cache()
    staged_records_ = staged_ring_path(dev)
    torch.cuda.empty_cache()
    sse_launches, sse_records = sse_path(dev)
    torch.cuda.empty_cache()
    by_path = {"main": main_launches, "hybrid": hybrid_launches, "circuits": circuit_launches,
               "bgv": bgv_launches, "parallel": par_launches, "examples": example_launches}
    for k, rec in records.items():
        rec["launches_by_path"] = {tag: counts[k] for tag, counts in by_path.items()}
        rec["launches"] = sum(rec["launches_by_path"].values())
        check(rec["launches"] > 0, f"kernel {k} was launched on no path")
    for k in NTT_KERNELS:
        records[k]["by_rows"] = [
            dict(rows=rows, **{f"launches_{tag}": r[k].get(rows, 0)
                               for tag, r in path_rows.items()}, **rec)
            for rows, rec in sweep[k].items()]
        records[k]["launch_weighted_kernel_ms"] = weighted[k]
    for name, rec in small_records.items():
        kind = name.rsplit("_small", 1)[0]
        rec["launches_by_path"] = {"small": small_launches[kind],
                                   "bgv_small": bgv_small_launches[kind]}
        rec["launches"] = sum(rec["launches_by_path"].values())
        check(rec["launches"] > 0, f"kernel {name} was not launched on the small-n paths")
    records.update(small_records)
    for name, rec in tfhe_records.items():
        kind = name.rsplit("_tfhe", 1)[0]
        rec["launches"] = tfhe_launches[kind]
        rec["launches_by_path"] = {"tfhe": tfhe_launches[kind]}
        rec["nand_launches_by_rows"] = tfhe_gate_rows[kind]
        check(rec["launches"] > 0, f"kernel {name} was not launched on the TFHE path")
    records.update(tfhe_records)
    for name, rec in boot_records.items():
        kind = name.rsplit("_boot", 1)[0]
        rec["launches"] = boot_launches[kind]
        rec["launches_by_path"] = {"bootstrap": boot_launches[kind]}
        check(rec["launches"] > 0, f"kernel {name} was not launched on the bootstrap path")
    records.update(boot_records)
    for name, rec in boot16_records.items():
        kind = name.rsplit("_boot16", 1)[0]
        rec["launches"] = boot16_launches[kind]
        rec["launches_by_path"] = {"bootstrap16": boot16_launches[kind]}
        check(rec["launches"] > 0, f"kernel {name} was not launched on the n={BOOT16_N} bootstrap")
    records.update(boot16_records)
    for name, rec in large_records.items():
        kind = name.rsplit("_large", 1)[0]
        rec["launches"] = large_launches[kind]
        rec["launches_by_path"] = {"large_ring": large_launches[kind]}
        check(rec["launches"] > 0, f"kernel {name} was not launched on the n={LARGE_N} path")
    records.update(large_records)
    for name, rec in par_records.items():
        launches = (par_launches if name == "ntt_stage" else staged_launches)[
            name.removesuffix("_staged")]
        rec["launches"] = launches
        rec["launches_by_path"] = {"parallel": launches}
        check(launches > 0, f"kernel {name} was not launched on the parallel path")
    records.update(par_records)
    records.update(staged_records_)
    for name, rec in sse_records.items():
        kind = name.rsplit("_sse", 1)[0]
        rec["launches"] = sse_launches[kind]
        rec["launches_by_path"] = {"sse": sse_launches[kind]}
        check(rec["launches"] > 0, f"kernel {name} was not launched on the SSE path")
    records.update(sse_records)
    lost = [k for k, rec in records.items() if rec["kernel_ms"] is None]
    check(2 * len(lost) <= len(records),
          f"the profiler gave no kernel-only time for {lost}: the instrument, not a dropped record")
    tfhe_traces()
    print(json.dumps({"kernels": [dict(name=k, **rec) for k, rec in records.items()]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
