"""CKKS bootstrapping (port of hehub_tpu/circuits/bootstrap.py).

Pipeline (Cheon-Han-Kim-Kim-Song style):
  1. mod_raise: reinterpret an exhausted ciphertext (1 limb, modulus q0) over
     the full RNS basis; it then decrypts to t(X) = m(X) + q0·I(X) with small
     integer polynomial I (|I| bounded by the secret's Hamming weight).
  2. coeff_to_slot: homomorphic linear maps taking the n coefficients of t
     into slot space as TWO real-slot ciphertexts (r_j = t_j,
     im_j = t_{j+n/2}), with the matrices derived numerically from the
     encoding layout (dense: four BSGS products and one conjugation;
     factored: one butterfly chain and one conjugation per half).
  3. eval_mod: u ↦ (u mod q0)/q0 on each half by a Chebyshev sine
     approximation, sin(2πu)/(2π), evaluated by a baby-step/giant-step split
     under the flexible-scale discipline (make_boot_params), optionally
     followed by the arcsine cubic that cancels the sine's linearization
     error.
  4. slot_to_coeff: the inverse linear map, returning a fresh ciphertext of
     m at a usable level.

Sparse-secret encapsulation (SSE, `Bootstrapper(sse=...)`, the keys from
rlwe/keys.sse_keys) wraps step 1: the exhausted ciphertext is switched to
a sparse ephemeral secret at its one limb, raised, and switched back at
the top, so |I| is bounded by the ephemeral secret's weight.

Each stage of a refresh (sse_in, mod_raise, sse_out, c2s, evalmod twice,
s2c) launches its device marker where it begins (kernels.mark of its
index in MARKERS; "done" after s2c), so that a device trace, CUDA-graph
replays included, splits a refresh by stage; it opens a host range
boot.<stage> and counts its key switches (rlwe/rgsw.KEY_SWITCHES) under
its name in KEY_SWITCHES; REFRESHES counts the ciphertexts refreshed.

Without SSE every function is bitwise equal to its hehub_tpu counterpart
on the same inputs and keys, on the CPU. The matrices are host numpy, as in
the reference; from SPARSE_CHAIN_MIN_N the factored chains are built and
held by their diagonals (Diagonals), where the reference multiplies dense
matrices. Linear-transform plans encode their diagonals in one batched
`ckks.encode` on the plan's device (the device codec, kernel K5, where the
diagonals fit its bound) and one `rns.to_ntt` of [D, L, n] (one K1 launch
on the card).

Differences from the reference, none in the arithmetic:
- The JAX tracing helpers `LinearTransformPlan.shape_view`/`traced_view`
  and the tracer branch of `Bootstrapper._plan` have no counterpart:
  PyTorch runs eagerly and nothing is traced.
- `cheb_eval`, `eval_mod` and `_arcsine_correct` take an optional
  `consts` (ConstantPlaintexts) through which every constant plaintext is
  encoded once and then reused; `Bootstrapper` always passes its own.
  CompiledBootstrapper needs this: a CUDA graph cannot capture an encode,
  which copies from the host.
- `CompiledBootstrapper` captures the refresh (or its four stages) as CUDA
  graphs on static input buffers, where the reference jits it with keys and
  plans as parameters; on a CPU ciphertext the same stage functions run
  eagerly.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hehub_tpu_torch import kernels
from hehub_tpu_torch.circuits import poly_eval as pe
from hehub_tpu_torch.core import rns
from hehub_tpu_torch.core.context import CkksParams, Context
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod

# the stage markers, in csrc/marker.cu's HH_MARKERS order: empty kernels
# named boot_mark_<stage>, launched where each stage of a refresh begins
# ("done" where the last one ends)
MARKERS = ("sse_in", "mod_raise", "sse_out", "c2s", "evalmod", "s2c", "done")

# ciphertexts refreshed, and key switches by the stage they ran in, since
# reset_counters(). A CUDA graph's replay runs no Python, so
# CompiledBootstrapper adds the counts of its discovery refresh for each
# refresh it replays.
REFRESHES = 0
KEY_SWITCHES: Dict[str, int] = {}


def reset_counters() -> None:
    global REFRESHES
    REFRESHES = 0
    KEY_SWITCHES.clear()


def _count(refreshes: int, key_switches: Dict[str, int]) -> None:
    global REFRESHES
    REFRESHES += refreshes
    for stage, count in key_switches.items():
        if count:
            KEY_SWITCHES[stage] = KEY_SWITCHES.get(stage, 0) + count

# ---------------------------------------------------------------------------
# Numeric derivation of the C2S / S2C matrices for the encoding layout
# ---------------------------------------------------------------------------


def _decode_matrix(n: int) -> np.ndarray:
    """W [n/2, n] with slots(c) = W·c for coefficient vectors c (scale 1),
    from the encoder's own layout (models/ckks.py _slots_to_read)."""
    W = np.empty((n // 2, n), dtype=np.complex128)
    for k in range(n):
        e = np.zeros(n)
        e[k] = 1.0
        W[:, k] = ckks._slots_to_read(e, n, n // 2)
    return W


@functools.lru_cache(maxsize=None)
def _c2s_s2c_matrices(n: int):
    """(E, F, G, H, C1, C2) with
       coeff→slot (two real-slot outputs):
           r  = E·s + F·conj(s)   slots r_j  = t_j
           im = G·s + H·conj(s)   slots im_j = t_{j+n/2}
       slot→coeff:
           s' = C1·r + C2·im      (s' = W·t for t = [r; im])
    where s = current slots = W·t."""
    s_cnt = n // 2
    W = _decode_matrix(n)
    M = np.vstack([W, np.conj(W)])  # [n, n]
    Minv = np.linalg.inv(M)
    P_re = np.zeros((s_cnt, n))
    P_re[:, :s_cnt] = np.eye(s_cnt)
    P_im = np.zeros((s_cnt, n))
    P_im[:, s_cnt:] = np.eye(s_cnt)
    EF = P_re @ Minv
    GH = P_im @ Minv
    E, F = EF[:, :s_cnt], EF[:, s_cnt:]
    G, H = GH[:, :s_cnt], GH[:, s_cnt:]
    C1 = W[:, :s_cnt]
    C2 = W[:, s_cnt:]
    return E, F, G, H, C1, C2


# ---------------------------------------------------------------------------
# Butterfly factorization of the evaluation map (factored C2S/S2C)
# ---------------------------------------------------------------------------
#
# V := C1 = W[:, :s] is the degree-<s evaluation map V[i,k] = ζ^{e_i k}
# (e_i = 3^i mod 2n), with the radix-2 factorization V = M_d · … · M_1 · P_br
# in this layout (every M_t has nonzero diagonals only at {0, ±2^(t−1)}).
# Then E = C1^H/n, F = C1^T/n, C2 = D·C1, G = E·D̄, H = F·D with
# D = diag(ζ^{e_i s}), so each C2S half is one factored chain plus one
# conjugation, P·(E z + F z̄) = (u + ū)/n. The bit-reversal cancels across the
# pipeline: C2S emits r/im in bit-reversed coefficient order, EvalMod is
# slot-wise, and S2C's chain consumes that order.


# From this ring dimension on the groups are built in the diagonal domain
# (Diagonals: a group of r stages of half-widths 2^a .. 2^(a+r-1) has
# nonzero wrapped diagonals only at offsets sum e_i 2^(a+i), e_i in
# {-1, 0, 1}, so at most 2^(r+1) - 1 of them), and D scales them as
# vectors: no s x s array is made, where a dense group takes s^2 x 16 bytes
# (17.2 GB at n=65536). The two routes agree to rounding (the dense one sums
# in BLAS's order), not bitwise, so the rings that the tests hold against
# hehub_tpu bitwise, n=4096 and below, keep the dense route.
SPARSE_CHAIN_MIN_N = 8192


@functools.lru_cache(maxsize=None)
def _butterfly_roots(n: int):
    """(roots, rev, e): roots[t−1] [s] holds the twiddles of stage M_t, which
    has half-width h = 2^(t−1) and, in each block of 2h rows at `base`,
    M_t[base+i, base+i] = M_t[base+h+i, base+i] = 1,
    M_t[base+i, base+h+i] = roots[t−1][base+i] and
    M_t[base+h+i, base+h+i] = roots[t−1][base+h+i] (i < h); rev is the
    bit-reversal permutation (an involution) and e the Galois exponents
    e_i = 3^i mod 2n."""
    s = n // 2
    d = s.bit_length() - 1
    e = np.empty(s, dtype=np.int64)
    x = 1
    for i in range(s):
        e[i] = x
        x = x * 3 % (2 * n)
    zeta = np.exp(1j * np.pi / n)
    cur_roots = [zeta**e]
    roots = []
    for t in range(d, 0, -1):
        h = 1 << (t - 1)
        roots.append(np.concatenate(cur_roots))
        new_roots = []
        for r in cur_roots:
            sq = r[:h] ** 2
            new_roots += [sq, sq]
        cur_roots = new_roots
    rev = np.zeros(s, np.int64)
    idx = np.arange(s)
    for bit in range(d):
        rev |= ((idx >> bit) & 1) << (d - 1 - bit)
    return tuple(roots[::-1]), rev, e


@functools.lru_cache(maxsize=None)
def _butterfly_factors(n: int):
    """(Ms, rev, e): dense stage matrices with V = Ms[d−1] @ … @ Ms[0] @
    P_br, the bit-reversal permutation rev (an involution), and the Galois
    exponents e_i = 3^i mod 2n."""
    roots, rev, e = _butterfly_roots(n)
    s = n // 2
    stages = []
    for t, r in enumerate(roots, start=1):
        h = 1 << (t - 1)
        lo = (np.arange(s // (2 * h))[:, None] * 2 * h + np.arange(h)).ravel()
        hi = lo + h
        M = np.zeros((s, s), dtype=np.complex128)
        M[lo, lo] = 1.0
        M[lo, hi] = r[lo]
        M[hi, lo] = 1.0
        M[hi, hi] = r[hi]
        stages.append(M)
    return tuple(stages), rev, e


class Diagonals:
    """A slot-space matrix [s, s] held by its wrapped diagonals: vecs[k][j]
    = M[j, (j + k) mod s] for each offset k it has (any other diagonal is
    zero)."""

    def __init__(self, s: int, vecs: Dict[int, np.ndarray]):
        self.s, self.vecs = s, vecs

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.s, self.s)

    def adjoint(self) -> "Diagonals":
        """M^H: diagonal k of M^H at row j is conj(M[j + k, j]), diagonal -k
        of M at row j + k."""
        out = {}
        for a, v in self.vecs.items():
            k = (-a) % self.s
            out[k] = np.conj(np.roll(v, -k))
        return Diagonals(self.s, out)

    def scale_cols(self, c: np.ndarray) -> "Diagonals":
        """M · diag(c)."""
        return Diagonals(self.s, {k: v * np.roll(c, -k) for k, v in self.vecs.items()})

    def scale_rows(self, c: np.ndarray) -> "Diagonals":
        """diag(c) · M."""
        return Diagonals(self.s, {k: c * v for k, v in self.vecs.items()})

    def __mul__(self, x: float) -> "Diagonals":
        return Diagonals(self.s, {k: v * x for k, v in self.vecs.items()})

    def norm(self) -> float:
        """The Frobenius norm."""
        return float(np.sqrt(sum(np.vdot(v, v).real for v in self.vecs.values())))


def _stage_diagonals(roots, first: int, stop: int) -> Diagonals:
    """M_stop ⋯ M_(first+1) (stages first .. stop−1 of `roots`, 0-based) in
    the diagonal domain, from the identity one stage at a time: M_t of
    half-width h has diagonals 0 (1 on the low rows of each block, r on the
    high ones), +h (r on the low rows) and −h (1 on the high rows), and
    diagonal k of M_t·G at row j is Σ_a M_t's diagonal a at j times G's
    diagonal k − a at j + a."""
    s = roots[0].size
    G = {0: np.ones(s, dtype=np.complex128)}
    for t in range(first, stop):
        h = 1 << t
        r = roots[t]
        low = (np.arange(s) // h) % 2 == 0
        stage = ((0, np.where(low, 1.0, r)), (h, np.where(low, r, 0.0)),
                 (s - h, np.where(low, 0.0, 1.0)))
        out: Dict[int, np.ndarray] = {}
        for a, m in stage:
            for k, g in G.items():
                key = (a + k) % s
                term = m * np.roll(g, -a)
                out[key] = out[key] + term if key in out else term
        G = out
    return Diagonals(s, G)


def _chain_matrices(n: int, lt_stages: int, sparse: bool):
    """_merged_chain_matrices in the diagonal domain (sparse=True:
    Diagonals) or as dense arrays."""
    if sparse:
        roots, rev, e = _butterfly_roots(n)
        d = len(roots)
    else:
        Ms, rev, e = _butterfly_factors(n)
        d = len(Ms)
    k = min(lt_stages, d)
    bounds = [round(j * d / k) for j in range(k + 1)]
    groups = []
    for j in range(k):
        if sparse:
            groups.append(_stage_diagonals(roots, bounds[j], bounds[j + 1]))
            continue
        Gj = Ms[bounds[j]]
        for t in range(bounds[j] + 1, bounds[j + 1]):
            Gj = Ms[t] @ Gj
        groups.append(Gj)
    D = np.exp(1j * np.pi * e / 2)  # ζ^{e_i s}
    adj = [Gj.adjoint() if sparse else Gj.conj().T for Gj in groups]
    c2s_r = [adj[j] for j in range(k - 1, -1, -1)]
    c2s_im = list(c2s_r)
    c2s_im[0] = (adj[k - 1].scale_cols(np.conj(D)) if sparse
                 else adj[k - 1] @ np.diag(np.conj(D)))
    # the 1/n normalization spread over the stages so that every folded
    # factor has the same rms gain κ = (Π gains / n)^(1/k): plan entries stay
    # O(κ/g_t) and the per-stage plan quantization error is balanced
    gains = [(M.norm() if sparse else np.linalg.norm(M)) / np.sqrt(n / 2) for M in c2s_r]
    kappa = (np.prod(gains) / n) ** (1.0 / k)
    folds = [kappa / g for g in gains]
    c2s_r = [M * c for M, c in zip(c2s_r, folds)]
    c2s_im = [M * c for M, c in zip(c2s_im, folds)]
    s2c_r = list(groups)
    s2c_im = list(groups)
    s2c_im[-1] = groups[-1].scale_rows(D) if sparse else np.diag(D) @ s2c_im[-1]
    return (tuple(c2s_r), tuple(c2s_im), tuple(s2c_r), tuple(s2c_im))


@functools.lru_cache(maxsize=None)
def _merged_chain_matrices(n: int, lt_stages: int):
    """The four factored chains as tuples of matrices in application order:
    (c2s_r, c2s_im, s2c_r, s2c_im). Merges the d butterflies into
    `lt_stages` near-equal groups G_1..G_k (V = G_k ⋯ G_1 P_br), then
      c2s chains: (1/n)·G_1^H applied last, G_k^H (·D̄ for im) first;
      s2c chains: G_1 applied first, G_k (D·G_k for im) last.
    Dense arrays below SPARSE_CHAIN_MIN_N, Diagonals from it."""
    return _chain_matrices(n, lt_stages, sparse=n >= SPARSE_CHAIN_MIN_N)


def _nonzero_diagonals(M: np.ndarray) -> np.ndarray:
    """The k (ascending) whose wrapped diagonal M[j, (j+k) mod s] holds a
    nonzero entry: one pass over M's nonzeros in place of a gather per k
    (in memory order: the C2S factors are transposes)."""
    if isinstance(M, Diagonals):
        return np.asarray(sorted(k for k, v in M.vecs.items() if np.any(v)), dtype=np.int64)
    if M.flags.f_contiguous and not M.flags.c_contiguous:
        j, i = np.nonzero(M.T)
    else:
        i, j = np.nonzero(M)
    return np.unique((j - i) % M.shape[0])


def _diagonal(M, k: int) -> np.ndarray:
    """Wrapped diagonal k of M: M[j, (j + k) mod s] for each row j."""
    if isinstance(M, Diagonals):
        return M.vecs[k]
    idx = np.arange(M.shape[0])
    return M[idx, (idx + k) % M.shape[0]]


def _bsgs_split(s: int) -> Tuple[int, int]:
    b = 1 << max((s.bit_length() - 1) // 2, 0)
    g = (s + b - 1) // b
    return b, g


def linear_transform_steps(slot_count: int) -> List[int]:
    """Rotation steps required by linear_transform (negative steps are taken
    mod slot_count)."""
    B, G = _bsgs_split(slot_count)
    steps = [(-b) % slot_count for b in range(1, B)]
    steps += [(-g * B) % slot_count for g in range(1, G)]
    return sorted(set(steps))


class LinearTransformPlan:
    """Precomputed BSGS diagonal plaintexts of a slot-space matrix (a dense
    array or Diagonals) at a fixed ciphertext level and scale: every
    diagonal encoded once, in one batched encode, and kept in NTT form so
    that each use is one pointwise multiply.

    Attributes: pts[(g, b)] -> RnsPoly NTT [L, n] on the plan's device;
    `codec`: which codec encoded the diagonals ('device' or 'host')."""

    def __init__(
        self,
        ctx: Context,
        params: CkksParams,
        M: np.ndarray,
        level: int,
        pt_scale: float,
        host_only: bool = False,
        *,
        device="cuda",
    ):
        s = params.dimension // 2
        if M.shape != (s, s):
            raise ValueError(f"matrix must be [{s},{s}]")
        self.slot_count = s
        self.level = level
        self.pt_scale = float(pt_scale)
        self.dimension = params.dimension
        B, G = _bsgs_split(s)
        self.B, self.G = B, G
        keys: List[Tuple[int, int]] = []
        diags: List[np.ndarray] = []
        for k in _nonzero_diagonals(M):
            g, b = divmod(int(k), B)
            # diag_k[j] = M[j, (j+k) mod s], pre-rotated by +gB so the
            # final giant rotation lands it in place
            keys.append((g, b))
            diags.append(np.roll(_diagonal(M, int(k)), (g * B) % s))
        self._keys = keys
        self._diags = np.stack(diags)
        self._level_tag = len(params.moduli) - level
        self._limb_ids = tuple(range(level))
        self.pts = None
        self.codec = None
        if not host_only:
            self.materialize(ctx, params, device)

    def materialize(self, ctx: Context, params: CkksParams, device="cuda") -> None:
        """Encode the diagonals (one batched encode on `device`) and NTT
        them there (one K1 launch on [D, L, n] on the card). Split out from
        __init__ so that host_only plans, recorded first, are filled
        afterwards."""
        if self.pts is not None:
            return
        max_abs = float(np.abs(self._diags).max(initial=0.0))
        self.codec = ("device" if ckks.device_encode_selected(max_abs, self.pt_scale, device)
                      else "host")
        batched = ckks.encode(self._diags, params, scaling_factor=self.pt_scale,
                              level=self._level_tag, device=device)
        pt_ntt = rns.to_ntt(ctx, batched.poly).data  # one batched NTT [D, L, n]
        self.pts = {gb: rns.RnsPoly(pt_ntt[i], rns.NTT, self._limb_ids)
                    for i, gb in enumerate(self._keys)}


def make_lt_plan(
    ctx: Context,
    params: CkksParams,
    M: np.ndarray,
    level: int,
    ct_scale: float,
    target_scale: float = None,
    host_only: bool = False,
    *,
    device="cuda",
) -> LinearTransformPlan:
    """Plan for applying M to ciphertexts of `ct_scale` at `level` limbs so
    the rescaled output lands at (target_scale or Δ·q_drop)/q_drop."""
    q_drop = ctx.mod_list[level - 1]
    target = target_scale or params.initial_scaling_factor * q_drop
    return LinearTransformPlan(ctx, params, M, level, target / ct_scale,
                               host_only=host_only, device=device)


def make_babies(
    ctx: Context,
    ct: ckks.CkksCt,
    rot_keys: Dict[int, rgsw_mod.RgswCt],
    plans: Sequence[LinearTransformPlan],
) -> Dict[int, ckks.CkksCt]:
    """Baby rotations z_b = rot(z, −b) needed by any of `plans`, computed
    once (hoisted: one shared digit decomposition) and shared across every
    plan applied to the same input."""
    s = plans[0].slot_count
    B = max(p.B for p in plans)
    needed = {b for p in plans for (_, b) in p.pts}
    steps = {b: (-b) % s for b in range(1, B) if b in needed}
    rotated = ckks.hoisted_rotations(ctx, ct, rot_keys, sorted(set(steps.values())))
    babies = {0: ct}
    for b, step in steps.items():
        babies[b] = rotated[step]
    return babies


def apply_lt_plan(
    ctx: Context,
    plan: LinearTransformPlan,
    ct: ckks.CkksCt,
    rot_keys: Dict[int, rgsw_mod.RgswCt],
    babies: Optional[Dict[int, ckks.CkksCt]] = None,
) -> ckks.CkksCt:
    """Homomorphic z ↦ M·z on slots by the BSGS diagonal method with
    precomputed diagonals (B+G−2 rotations); consumes one level; batched
    ciphertexts broadcast through. Pass `babies` (from make_babies) to share
    baby rotations across plans. The giant steps are lazy: one special-prime
    division for their sum (ckks.rotate_accumulate)."""
    s = plan.slot_count
    B, G = plan.B, plan.G
    if ct.c0.limb_count != plan.level:
        raise ValueError(
            f"plan built for level {plan.level}, ciphertext at {ct.c0.limb_count}"
        )
    if babies is None:
        babies = make_babies(ctx, ct, rot_keys, [plan])
    terms = []
    for g in range(G):
        inner = None
        for b in range(B):
            if (g, b) not in plan.pts:
                continue
            pt = ckks.CkksPt(plan.pts[(g, b)], plan.pt_scale)
            term = ckks.mult_plain(ctx, babies[b], pt)
            inner = term if inner is None else ckks.add(ctx, inner, term)
        if inner is None:
            continue
        terms.append((inner, ((-g * B) % s) if g else 0))
    acc = ckks.rotate_accumulate(ctx, terms, rot_keys)
    return ckks.rescale(ctx, acc)


def linear_transform(
    ctx: Context,
    params: CkksParams,
    M: np.ndarray,
    ct: ckks.CkksCt,
    rot_keys: Dict[int, rgsw_mod.RgswCt],
    target_scale: float = None,
) -> ckks.CkksCt:
    """One-shot z ↦ M·z (builds a plan on the ciphertext's device and
    applies it; callers that reuse a matrix build the plan once)."""
    plan = make_lt_plan(ctx, params, M, ct.c0.limb_count, ct.scaling_factor, target_scale,
                        device=ct.c0.data.device)
    return apply_lt_plan(ctx, plan, ct, rot_keys)


# ---------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------


def mod_raise(ctx: Context, ct: ckks.CkksCt) -> ckks.CkksCt:
    """Reinterpret a 1-limb ciphertext over the full modulus chain: each
    coefficient x ∈ [0, q0) is lifted signed into every limb (K2 on the one
    limb, K1 on all of them on the card). The result decrypts to
    t = m + q0·I. Scaling factor becomes q0 so slots read t/q0."""
    if ct.c0.limb_count != 1:
        raise ValueError("mod_raise expects a ciphertext at the last level")
    q0 = ctx.mod_list[ct.c0.limb_ids[0]]
    dst_ids = tuple(range(len(ctx.params.moduli)))

    def lift(poly):
        x = rns.reduce_strict(
            ctx, rns.to_coeff(ctx, poly) if poly.form == rns.NTT else poly
        ).data  # [..., 1, n] strict mod q0
        q = ctx.device_rows("q", dst_ids, x.device)
        # x < q0 < 2*q_j for 30-bit primes, so x mod q_j is a single select,
        # and the negative branch x − q0 + q_j is nonnegative since q_j > q0/2
        lo = x - torch.where(x >= q, q, 0)
        hi = x + q - q0
        lifted = torch.where(x < q0 // 2, lo, hi)
        return rns.to_ntt(ctx, rns.RnsPoly(lifted, rns.COEFF, dst_ids))

    return ckks.CkksCt(lift(ct.c0), lift(ct.c1), float(q0))


def coeff_to_slot(
    ctx: Context,
    params: CkksParams,
    ct: ckks.CkksCt,
    rot_keys: Dict[int, rgsw_mod.RgswCt],
    conj_key: rgsw_mod.RgswCt,
) -> Tuple[ckks.CkksCt, ckks.CkksCt]:
    """Two real-slot outputs: (r, im) with r_j = t_j/scale and
    im_j = t_{j+n/2}/scale (4 matrix products + 1 conjugation, 1 level)."""
    E, F, G, H, _, _ = _c2s_s2c_matrices(params.dimension)
    ct_conj = ckks.conjugate(ctx, ct, conj_key)
    lvl = ct.c0.limb_count
    q_drop = ctx.mod_list[lvl - 1]
    target = params.initial_scaling_factor * q_drop
    lt = lambda M, c: linear_transform(ctx, params, M, c, rot_keys,  # noqa: E731
                                       target_scale=target)
    r = ckks.add(ctx, lt(E, ct), lt(F, ct_conj))
    im = ckks.add(ctx, lt(G, ct), lt(H, ct_conj))
    return r, im


def slot_to_coeff(
    ctx: Context,
    params: CkksParams,
    ct_re: ckks.CkksCt,
    ct_im: ckks.CkksCt,
    rot_keys: Dict[int, rgsw_mod.RgswCt],
) -> ckks.CkksCt:
    """Inverse packing from the two real-slot halves back to coefficients."""
    _, _, _, _, C1, C2 = _c2s_s2c_matrices(params.dimension)
    lvl = min(ct_re.c0.limb_count, ct_im.c0.limb_count)
    q_drop = ctx.mod_list[lvl - 1]
    target = params.initial_scaling_factor * q_drop
    ct_re = pe.align_level(ctx, ct_re, lvl)
    ct_im = pe.align_level(ctx, ct_im, lvl)
    tc = linear_transform(ctx, params, C1, ct_re, rot_keys, target_scale=target)
    td = linear_transform(ctx, params, C2, ct_im, rot_keys, target_scale=target)
    return ckks.add(ctx, tc, td)


def _matrix_bsgs_steps(M: np.ndarray) -> set:
    """Rotation steps a LinearTransformPlan of M will request (same
    nonzero-diagonal pruning and BSGS split)."""
    s = M.shape[0]
    B, _ = _bsgs_split(s)
    steps = set()
    babies = set()
    for k in _nonzero_diagonals(M):
        g, b = divmod(int(k), B)
        babies.add(b)
        if g:
            steps.add((-g * B) % s)
    steps |= {(-b) % s for b in babies if b}
    return steps


def bootstrap_rotation_steps(params: CkksParams, lt_stages: int = 0) -> List[int]:
    """Rotation keys the bootstrap needs. lt_stages=0: dense BSGS
    transforms (all baby/giant steps). lt_stages=k: the factored chains'
    union of per-stage steps."""
    if not lt_stages:
        return linear_transform_steps(params.dimension // 2)
    chains = _merged_chain_matrices(params.dimension, lt_stages)
    steps = set()
    for chain in chains:
        for M in chain:
            steps |= _matrix_bsgs_steps(M)
    return sorted(steps)


# ---------------------------------------------------------------------------
# Constant plaintexts
# ---------------------------------------------------------------------------


class ConstantPlaintexts:
    """Constant plaintexts (one value in every slot) encoded once each and
    memoised on (value, scale, limbs, device): `self(value, scale,
    limb_count, device)` -> CkksPt. `frozen`: a miss raises (set while a
    CUDA graph is captured, which cannot hold an encode)."""

    def __init__(self, params: CkksParams):
        self.params = params
        self.pts: Dict[tuple, ckks.CkksPt] = {}
        self.frozen = False

    def __call__(self, value: float, scale: float, limb_count: int, device) -> ckks.CkksPt:
        key = (float(value), float(scale), int(limb_count), str(torch.device(device)))
        pt = self.pts.get(key)
        if pt is None:
            if self.frozen:
                raise RuntimeError(f"constant plaintext {key} was not encoded before capture")
            pt = ckks.encode(np.full(self.params.dimension // 2, float(value)), self.params,
                             scaling_factor=scale,
                             level=len(self.params.moduli) - limb_count, device=device)
            self.pts[key] = pt
        return pt


# ---------------------------------------------------------------------------
# EvalMod: Chebyshev sine approximation
# ---------------------------------------------------------------------------


def chebyshev_coeffs(fn, a: float, b: float, degree: int) -> np.ndarray:
    """Chebyshev interpolation coefficients of fn on [a, b] (numpy fit at
    Chebyshev nodes)."""
    k = np.arange(degree + 1)
    nodes = np.cos((2 * k + 1) * np.pi / (2 * (degree + 1)))
    x = 0.5 * (b - a) * nodes + 0.5 * (b + a)
    y = fn(x)
    c = np.polynomial.chebyshev.chebfit(nodes, y, degree)
    return c


def _cheb_divmod(c: List[float], m: int) -> Tuple[List[float], List[float]]:
    """Chebyshev-basis division: Σ c_j T_j = q(y)·T_m + r(y), deg r < m,
    deg q = deg c − m, via T_j = 2·T_m·T_{j−m} − T_{2m−j} for m < j < 2m."""
    c = list(c)
    deg = len(c) - 1
    if deg >= 2 * m:
        raise ValueError("divisor too small: need deg < 2m")
    q = [0.0] * (deg - m + 1)
    for j in range(deg, m, -1):
        cj = c[j]
        if cj:
            q[j - m] += 2.0 * cj
            c[2 * m - j] -= cj
            c[j] = 0.0
    q[0] += c[m]  # c_m·T_m = c_m·T_0·T_m
    return q, c[:m]


def _eff_deg(c: Sequence[float]) -> int:
    d = len(c) - 1
    while d > 0 and c[d] == 0.0:
        d -= 1
    return d


class _ChebBasis:
    """Chebyshev power basis T_1..T_{B−1} plus giants T_B, T_2B, ... under
    the flexible-scale discipline (Δ ≈ limb size): every basis mult costs
    one level; ct-ct subtractions match scales with a zero-level
    constant-1 mult_plain on the smaller-scale operand."""

    def __init__(self, ctx, params, y: ckks.CkksCt, degree: int, rlk,
                 consts: Optional[ConstantPlaintexts] = None):
        self.ctx, self.params, self.rlk = ctx, params, rlk
        self.consts = consts
        self.delta = params.initial_scaling_factor
        B = 1 << max((degree.bit_length() + 1) // 2, 1)
        while B > 2 and B * B > 4 * (degree + 1):
            B //= 2
        self.B = B
        self.T: Dict[int, ckks.CkksCt] = {1: y}
        for k in range(2, min(B, degree + 1)):
            self._build(k)
        self.giants: List[int] = []
        m = B
        while m <= degree:
            self._build(m)
            self.giants.append(m)
            m *= 2

    def _lift(self, ct: ckks.CkksCt, target: float) -> ckks.CkksCt:
        """Raise a ciphertext's scale to `target` >= scale with a constant-1
        multiply (no level consumed)."""
        ratio = target / ct.scaling_factor
        if abs(ratio - 1.0) < 1e-9:
            return ct
        if ratio < 1.0:
            raise ValueError("cannot lower a scale without rescaling")
        pt = pe._constant(self.params, 1.0, ratio, ct.c0.limb_count, ct, self.consts)
        return ckks.mult_plain(self.ctx, ct, pt)

    def _build(self, k: int):
        if k in self.T:
            return
        i, j = (k + 1) // 2, k // 2  # i + j = k, i − j ∈ {0, 1}
        self._build(i)
        self._build(j)
        a, b = self.T[i], self.T[j]
        lvl = min(a.c0.limb_count, b.c0.limb_count)
        prod = ckks.mult(
            self.ctx, pe.align_level(self.ctx, a, lvl),
            pe.align_level(self.ctx, b, lvl), self.rlk,
        )
        two_prod = ckks.add(self.ctx, prod, prod)
        if i == j:  # T_2i = 2T_i² − T_0: subtract after the rescale so the
            # constant is encodable even when Δ² exceeds the 2^62 bound
            tk = ckks.rescale_to(self.ctx, two_prod, self.delta)
            pt1 = pe._constant(self.params, 1.0, tk.scaling_factor, tk.c0.limb_count, tk,
                         self.consts)
            tk = ckks.sub_plain(self.ctx, tk, pt1)
        else:  # T_{i+j} = 2T_iT_j − T_1 (T_1 lifted by a constant-1 multiply
            # at a large ratio ≈ Δ)
            t1 = pe.align_level(self.ctx, self.T[1], lvl)
            t1 = self._lift(t1, two_prod.scaling_factor)
            tk = ckks.rescale_to(
                self.ctx, ckks.sub(self.ctx, two_prod, t1), self.delta
            )
        self.T[k] = tk


def cheb_eval(
    ctx: Context,
    params: CkksParams,
    ct: ckks.CkksCt,
    coeffs: Sequence[float],
    rlk: rgsw_mod.RgswCt,
    interval: Tuple[float, float] = (-1.0, 1.0),
    consts: Optional[ConstantPlaintexts] = None,
) -> ckks.CkksCt:
    """Evaluate Σ c_k·T_k(y), y = affine(x) mapped onto [−1,1], by a
    baby-step/giant-step split: T_1..T_{B−1} babies + T_{B·2^j} giants, then
    the recursion p = q·T_m + r where every leaf emits unrescaled plaintext
    products at ≈Δ² and every internal node spends exactly one rescale.
    Near-zero coefficients are pruned. A static first pass fixes every
    node's exact output scale, so that leaves hit them by compensating
    plaintext scales; constants are deferred up the tree and added after
    the final rescale. Designed for flexible scales with Δ ≈ limb size
    (make_boot_params)."""
    a, b = interval
    coeffs = list(coeffs)
    tol = 1e-12 * max(abs(x) for x in coeffs)
    coeffs = [x if abs(x) > tol else 0.0 for x in coeffs]
    d = _eff_deg(coeffs)
    if d < 1:
        raise ValueError("need degree >= 1")
    alpha = 2.0 / (b - a)
    beta = -(a + b) / (b - a)
    y = pe.poly_eval(ctx, params, ct, [beta, alpha], rlk, consts=consts)

    basis = _ChebBasis(ctx, params, y, d, rlk, consts)
    delta = params.initial_scaling_factor
    base_scale = delta * delta / 4.0  # headroom below the 2^62 encode bound

    # ---- pass 1: static schedule (levels depend only on the basis levels
    # and the tree structure) ------------------------------------------------
    def schedule(c: List[float]):
        deg = _eff_deg(c)
        if deg < basis.B:
            lvls = [basis.T[k].c0.limb_count for k in range(1, deg + 1)
                    if c[k] != 0.0]
            if not lvls:
                raise ValueError("empty Chebyshev leaf")
            return min(lvls)
        m = max(g for g in basis.giants if g <= deg)
        qc, rc = _cheb_divmod(c, m)
        t_m_lvl = basis.T[m].c0.limb_count
        if _eff_deg(qc) == 0:
            lvl = t_m_lvl
        else:
            lq = schedule(qc)
            # drop enough of the q-child's top limbs that its rescaled
            # scale times Δ_m stays within ×2 of base_scale
            s = base_scale * basis.T[m].scaling_factor
            drops = 0
            while s > base_scale * 2.0 and drops < lq - 1:
                drops += 1
                s /= ctx.mod_list[lq - drops]
            lvl = min(lq - drops, t_m_lvl)
        if _eff_deg(rc) >= 1:
            # a constant-only remainder folds into the parent by add_plain
            # and constrains no level
            lvl = min(lvl, schedule(rc))
        return lvl

    def eval_node(c: List[float], target: float):
        """(ct, const): Σ_{k≥1} c_k T_k unrescaled at scale exactly `target`,
        plus a deferred additive constant in value units (a mult node folds
        its q-child's constant in as const·T_m; the root adds what remains
        after the final rescale)."""
        deg = _eff_deg(c)
        if deg < basis.B:  # leaf: plaintext products only
            lvls = [basis.T[k].c0.limb_count for k in range(1, deg + 1)
                    if c[k] != 0.0]
            lvl = min(lvls)
            acc = None
            for k in range(1, deg + 1):
                if c[k] == 0.0:
                    continue
                t_k = pe.align_level(ctx, basis.T[k], lvl)
                pt = pe._constant(params, c[k], target / t_k.scaling_factor, lvl, t_k, consts)
                term = ckks.mult_plain(ctx, t_k, pt)
                acc = term if acc is None else ckks.add(ctx, acc, term)
            return acc, c[0]
        m = max(g for g in basis.giants if g <= deg)
        qc, rc = _cheb_divmod(c, m)
        t_m = basis.T[m]
        if _eff_deg(qc) == 0:  # deg == m exactly: no ct-ct mult needed
            prod = ckks.mult_plain(
                ctx, t_m,
                pe._constant(params, qc[0], target / t_m.scaling_factor, t_m.c0.limb_count, t_m,
                       consts),
            )
        else:
            lq = schedule(qc)
            # the q-child's exact target: target·(∏ dropped moduli)/Δ_m, so
            # prod = (S_q/∏q)·Δ_m == target to float-ulp precision
            s = base_scale * t_m.scaling_factor
            drops = 0
            prod_q = 1.0
            while s > base_scale * 2.0 and drops < lq - 1:
                drops += 1
                qv = float(ctx.mod_list[lq - drops])
                s /= qv
                prod_q *= qv
            t_q = target * prod_q / t_m.scaling_factor
            q_un, q_const = eval_node(qc, t_q)
            q_resc = ckks.rescale(ctx, q_un, drops) if drops else q_un
            lvl = min(q_resc.c0.limb_count, t_m.c0.limb_count)
            t_m_al = pe.align_level(ctx, t_m, lvl)
            prod = ckks.mult(
                ctx, pe.align_level(ctx, q_resc, lvl), t_m_al, rlk,
            )
            if q_const != 0.0:
                # deferred q-constant contributes q_const·T_m: an ordinary
                # plaintext product at prod's scale (pt scale ≈ Δ/4)
                pt_c = pe._constant(params, q_const, prod.scaling_factor / t_m_al.scaling_factor,
                              lvl, t_m_al, consts)
                prod = ckks.add(ctx, prod,
                                ckks.mult_plain(ctx, t_m_al, pt_c))
        if not any(rc):
            return prod, 0.0
        if _eff_deg(rc) == 0:
            # constant-only remainder (e.g. coeffs = 1 + T_4 with B > 4)
            return prod, rc[0]
        rv, r_const = eval_node(rc, prod.scaling_factor)
        lvl = min(prod.c0.limb_count, rv.c0.limb_count)
        out = ckks.add(
            ctx, pe.align_level(ctx, prod, lvl), pe.align_level(ctx, rv, lvl)
        )
        return out, r_const

    out, const = eval_node(coeffs, base_scale)
    # the recursive closures hold themselves and the basis (every T_k) in a
    # reference cycle that only a garbage-collector pass would free, at a
    # moment no run controls: break it, so the basis goes now
    schedule = eval_node = None
    # the unrescaled root sits at ≈Δ²/4: rescale to land as close to Δ as
    # the limb geometry allows
    out = ckks.rescale_to(ctx, out, delta)
    if const != 0.0:
        pt0 = pe._constant(params, const, out.scaling_factor, out.c0.limb_count, out, consts)
        out = ckks.add_plain(ctx, out, pt0)
    return out


def eval_mod(
    ctx: Context,
    params: CkksParams,
    ct: ckks.CkksCt,
    rlk: rgsw_mod.RgswCt,
    k_bound: int,
    degree: int = 31,
    arcsine=False,
    double_angle: int = 0,
    consts: Optional[ConstantPlaintexts] = None,
) -> ckks.CkksCt:
    """u ↦ (u mod 1) on slots for u = m/q0 + I, |I| ≤ k_bound, |m/q0| small.

    double_angle=0: approximate sin(2πu)/(2π) on [−k_bound−½, k_bound+½]
    directly by a degree-`degree` Chebyshev fit.

    double_angle=r>0 (Han–Ki): approximate cos(2π(u−¼)/2^r) on the 2^r-fold
    compressed interval, then apply r double-angle squarings
    cos(2θ) = 2cos²θ − 1, landing on cos(2π(u−¼)) = sin(2πu).

    `arcsine`: post-compose w ↦ arcsin(2πw)/(2π) truncated at the given odd
    degree (True ≙ 3; 5 and 7 supported), cancelling the sine's
    linearization error."""
    r = k_bound + 0.5
    if double_angle:
        fold = float(1 << double_angle)
        c = chebyshev_coeffs(
            lambda x: np.cos(2 * np.pi * (x - 0.25) / fold), -r, r, degree
        )
        out = cheb_eval(ctx, params, ct, c, rlk, interval=(-r, r), consts=consts)
        delta = params.initial_scaling_factor
        for _ in range(double_angle):
            sq = ckks.mult(ctx, out, out, rlk)
            sq = ckks.rescale_to(ctx, ckks.add(ctx, sq, sq), delta)
            pt1 = pe._constant(params, 1.0, sq.scaling_factor, sq.c0.limb_count, sq, consts)
            out = ckks.sub_plain(ctx, sq, pt1)  # cos(2θ) = 2cos²θ − 1
        # out = sin(2πu); reinterpret the scale to divide by 2π for free
        out = ckks.CkksCt(out.c0, out.c1,
                          out.scaling_factor * (2.0 * np.pi))
    else:
        c = chebyshev_coeffs(lambda x: np.sin(2 * np.pi * x) / (2 * np.pi),
                             -r, r, degree)
        out = cheb_eval(ctx, params, ct, c, rlk, interval=(-r, r), consts=consts)
    if arcsine:
        out = _arcsine_correct(ctx, params, out, rlk,
                               3 if arcsine is True else int(arcsine), consts)
    return out


# odd Taylor coefficients of arcsin(2πw)/(2π) beyond the identity term
_ARCSINE_C3 = (2.0 * np.pi) ** 2 / 6.0
_ARCSINE_C5 = 3.0 * (2.0 * np.pi) ** 4 / 40.0
_ARCSINE_C7 = 15.0 * (2.0 * np.pi) ** 6 / 336.0


def _arcsine_correct(
    ctx: Context, params: CkksParams, w: ckks.CkksCt, rlk: rgsw_mod.RgswCt,
    degree: int = 3, consts: Optional[ConstantPlaintexts] = None,
) -> ckks.CkksCt:
    """w + a₃w³ [+ a₅w⁵ [+ a₇w⁷]] under the flexible-scale discipline,
    written as w + w³·g(w²) with g = a₃ [+ w²(a₅ [+ a₇w²])]: degree 3 costs 2
    ct-ct mults, degree 5 costs 3, degree 7 costs 4. Constant multiples are
    applied by reinterpreting scales; the linear term is one
    compensating-scale plaintext multiply."""
    if degree not in (3, 5, 7):
        raise ValueError("arcsine degree must be 3, 5, or 7")
    delta = params.initial_scaling_factor

    def lift_const(ct_in, const):
        """ct_in (value x, scale S) -> value const + c·x via reinterpret."""
        return ckks.add_plain(
            ctx, ct_in,
            pe._constant(params, const, ct_in.scaling_factor, ct_in.c0.limb_count, ct_in, consts),
        )

    sq = ckks.rescale_to(ctx, ckks.mult(ctx, w, w, rlk), delta)  # w²
    if degree == 3:
        g = None  # g(w²) = a₃: fold into the cube by scale reinterpretation
    else:
        if degree == 5:
            inner = ckks.CkksCt(sq.c0, sq.c1,
                                sq.scaling_factor / _ARCSINE_C5)
            g = lift_const(inner, _ARCSINE_C3)  # a₃ + a₅w², no mult spent
        else:  # degree 7: g = a₃ + w²(a₅ + a₇w²)
            inner = ckks.CkksCt(sq.c0, sq.c1,
                                sq.scaling_factor / _ARCSINE_C7)
            h = lift_const(inner, _ARCSINE_C5)  # a₅ + a₇w²
            lvl = min(sq.c0.limb_count, h.c0.limb_count)
            gp = ckks.mult(ctx, pe.align_level(ctx, sq, lvl),
                           pe.align_level(ctx, h, lvl), rlk)
            g = lift_const(ckks.rescale_to(ctx, gp, delta), _ARCSINE_C3)
    if g is not None:
        lvl = min(sq.c0.limb_count, g.c0.limb_count)
        sg = ckks.mult(ctx, pe.align_level(ctx, sq, lvl),
                       pe.align_level(ctx, g, lvl), rlk)  # w²·g
        sg = ckks.rescale_to(ctx, sg, delta)
    else:
        sg = ckks.CkksCt(sq.c0, sq.c1, sq.scaling_factor / _ARCSINE_C3)
    lvl = min(sg.c0.limb_count, w.c0.limb_count)
    w_al = pe.align_level(ctx, w, lvl)
    cube = ckks.mult(ctx, pe.align_level(ctx, sg, lvl), w_al, rlk)
    s = cube.scaling_factor  # value w³·g at scale s, unrescaled
    pt = pe._constant(params, 1.0, s / w_al.scaling_factor, lvl, w_al, consts)
    term1 = ckks.mult_plain(ctx, w_al, pt)  # value w at scale s
    return ckks.rescale_to(ctx, ckks.add(ctx, cube, term1), delta)


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------


def make_boot_params(
    dimension: int,
    num_levels: int,
    num_special: int = 1,
    two_limb_scale: bool = True,
) -> CkksParams:
    """Bootstrap-friendly CKKS parameters: the working scale Δ is pinned to
    a product of actual limb values so the flexible-scale dynamics of
    cheb_eval stay within one rescale of Δ.

    two_limb_scale=True (default): Δ = q_a·q_b ≈ 2^60, every mult rescales
    by exactly two limbs. False: Δ ≈ q ≈ 2^30, half the level consumption.
    Level budgets for bootstrapping exceed the 128-bit table below
    n=32768: callers own that tradeoff."""
    from hehub_tpu_torch.utils import hostmath as hm

    primes = hm.gen_ntt_primes(30, num_levels + num_special, dimension)
    moduli = tuple(primes[num_special:])
    if two_limb_scale and num_levels >= 4:
        delta = float(moduli[1] * moduli[2])
    else:
        delta = float(moduli[1] if num_levels > 1 else moduli[0])
    return CkksParams(
        dimension=dimension,
        moduli=moduli,
        special_mod=tuple(primes[:num_special])
        if num_special != 1
        else primes[0],
        initial_scaling_factor=delta,
    )


class Bootstrapper:
    """Reusable CKKS bootstrapping pipeline with precomputed linear-
    transform plans (encoded once per (name, level, scale, target)
    signature and cached) and constant plaintexts (ConstantPlaintexts).
    Plans are made on the device of the ciphertext that first needs them.
    `sse`: the two keys of sparse-secret encapsulation around ModRaise
    (keys.sse_keys), or None."""

    def __init__(
        self,
        ctx: Context,
        params: CkksParams,
        rlk: rgsw_mod.RgswCt,
        rot_keys: Dict[int, rgsw_mod.RgswCt],
        conj_key: rgsw_mod.RgswCt,
        k_bound: int,
        degree: int = 31,
        arcsine=False,
        double_angle: int = 0,
        lt_stages: int = 0,
        sse: Optional[Tuple[rgsw_mod.RgswCt, rgsw_mod.RgswCt]] = None,
    ):
        self.ctx, self.params = ctx, params
        self.rlk, self.rot_keys, self.conj_key = rlk, rot_keys, conj_key
        # sparse-secret encapsulation: (KSK(s -> s_eph) over q0 and the
        # special primes, KSK(s_eph -> s)) from keys.sse_keys, or None
        self.sse = sse
        self.k_bound, self.degree = k_bound, degree
        self.arcsine = arcsine
        self.double_angle = double_angle
        self.lt_stages = lt_stages  # 0 = dense BSGS; k = factored chains
        self._plans: Dict = {}
        self._consts = ConstantPlaintexts(params)
        self._discover = False  # discovery: record plans host_only, fill them timed
        self._strict = False  # capture: a plan miss is a bug
        self._materialize_s = 0.0  # seconds spent filling host_only plans

    @staticmethod
    @contextlib.contextmanager
    def _stage(name: str, ct: ckks.CkksCt):
        """One stage of the refresh: its device marker where it begins, a host
        range boot.<name>, and its key switches counted under its name."""
        kernels.mark(MARKERS.index(name), ct.c0.data.device)
        before = rgsw_mod.KEY_SWITCHES
        try:
            with torch.profiler.record_function(f"boot.{name}"):
                yield
        finally:
            _count(0, {name: rgsw_mod.KEY_SWITCHES - before})

    def _plan(self, name: str, M: np.ndarray, ct: ckks.CkksCt,
              target_scale: float) -> LinearTransformPlan:
        key = (name, ct.c0.limb_count, ct.scaling_factor, target_scale)
        plan = self._plans.get(key)
        if self._strict and (plan is None or plan.pts is None):
            raise RuntimeError(
                f"plan {key} was not discovered before capture: CompiledBootstrapper's "
                f"discovery refresh and the captured one diverged"
            )
        if plan is None:
            plan = make_lt_plan(
                self.ctx, self.params, M, ct.c0.limb_count,
                ct.scaling_factor, target_scale, host_only=self._discover,
                device=ct.c0.data.device,
            )
            self._plans[key] = plan
        if plan.pts is None:  # recorded host_only by discovery
            t0 = time.perf_counter()
            plan.materialize(self.ctx, self.params, ct.c0.data.device)
            self._materialize_s += time.perf_counter() - t0
        return plan

    def _lt(self, name: str, M: np.ndarray, ct: ckks.CkksCt,
            target_scale: float) -> ckks.CkksCt:
        plan = self._plan(name, M, ct, target_scale)
        return apply_lt_plan(self.ctx, plan, ct, self.rot_keys)

    def _lt_pair(self, spec1, spec2, ct: ckks.CkksCt, target_scale: float):
        """Apply two matrices to the same input with shared baby rotations."""
        p1 = self._plan(spec1[0], spec1[1], ct, target_scale)
        p2 = self._plan(spec2[0], spec2[1], ct, target_scale)
        babies = make_babies(self.ctx, ct, self.rot_keys, [p1, p2])
        return (
            apply_lt_plan(self.ctx, p1, ct, self.rot_keys, babies),
            apply_lt_plan(self.ctx, p2, ct, self.rot_keys, babies),
        )

    def _default_target(self, ct: ckks.CkksCt) -> float:
        q_drop = self.ctx.mod_list[ct.c0.limb_count - 1]
        return self.params.initial_scaling_factor * q_drop

    def _balanced_pt_scale(self, ct: ckks.CkksCt, k: int) -> float:
        """Geometric-mean plaintext scale for a k-stage chain entered at
        `ct`: Π pt_scale_t is pinned to Δ·Πq_drop/ct_scale by the scale
        algebra, so equal pt_scales minimize the total plan quantization
        error."""
        L = ct.c0.limb_count
        prod = self.params.initial_scaling_factor
        for t in range(k):
            prod *= float(self.ctx.mod_list[L - 1 - t])
        return (prod / ct.scaling_factor) ** (1.0 / k)

    def _chain(self, name: str, mats, ct: ckks.CkksCt,
               pt_scale: Optional[float] = None) -> ckks.CkksCt:
        for t, M in enumerate(mats):
            target = (self._default_target(ct) if pt_scale is None
                      else ct.scaling_factor * pt_scale)
            ct = self._lt(f"{name}{t}", M, ct, target)
        return ct

    def raise_modulus(self, ct: ckks.CkksCt) -> ckks.CkksCt:
        """The exhausted ciphertext (1 limb) over the full modulus chain:
        mod_raise; with sparse-secret encapsulation, switched to the
        ephemeral secret at its one limb first and back to the secret at the
        top after, so that I is bounded by the ephemeral secret's weight."""
        if self.sse is not None:
            with self._stage("sse_in", ct):
                ct = ckks.switch_key(self.ctx, ct, self.sse[0])
        with self._stage("mod_raise", ct):
            raised = mod_raise(self.ctx, ct)
        if self.sse is not None:
            with self._stage("sse_out", raised):
                raised = ckks.switch_key(self.ctx, raised, self.sse[1])
        return raised

    def coeff_to_slot(self, ct: ckks.CkksCt):
        with self._stage("c2s", ct):
            return self._coeff_to_slot(ct)

    def _coeff_to_slot(self, ct: ckks.CkksCt):
        if self.lt_stages:
            # factored: one chain + one conjugation per half; outputs hold
            # the coefficients in bit-reversed order, which slot_to_coeff
            # consumes
            c2s_r, c2s_im, _, _ = _merged_chain_matrices(
                self.params.dimension, self.lt_stages
            )
            pt_bal = self._balanced_pt_scale(ct, len(c2s_r))
            target = ct.scaling_factor * pt_bal
            u, u2 = self._lt_pair(("c2sR0", c2s_r[0]), ("c2sI0", c2s_im[0]),
                                  ct, target)
            u = self._chain("c2sR", c2s_r[1:], u, pt_bal) \
                if len(c2s_r) > 1 else u
            u2 = self._chain("c2sI", c2s_im[1:], u2, pt_bal) \
                if len(c2s_im) > 1 else u2
            r = ckks.add(self.ctx, u,
                         ckks.conjugate(self.ctx, u, self.conj_key))
            im = ckks.add(self.ctx, u2,
                          ckks.conjugate(self.ctx, u2, self.conj_key))
            return r, im
        E, F, G, H, _, _ = _c2s_s2c_matrices(self.params.dimension)
        ct_conj = ckks.conjugate(self.ctx, ct, self.conj_key)
        target = self._default_target(ct)
        e_ct, g_ct = self._lt_pair(("E", E), ("G", G), ct, target)
        f_ct, h_ct = self._lt_pair(("F", F), ("H", H), ct_conj, target)
        r = ckks.add(self.ctx, e_ct, f_ct)
        im = ckks.add(self.ctx, g_ct, h_ct)
        return r, im

    def eval_mod(self, ct: ckks.CkksCt) -> ckks.CkksCt:
        with self._stage("evalmod", ct):
            return eval_mod(self.ctx, self.params, ct, self.rlk, self.k_bound, self.degree,
                            self.arcsine, self.double_angle, consts=self._consts)

    def slot_to_coeff(self, ct_re: ckks.CkksCt, ct_im: ckks.CkksCt):
        with self._stage("s2c", ct_re):
            out = self._slot_to_coeff(ct_re, ct_im)
        kernels.mark(MARKERS.index("done"), out.c0.data.device)
        return out

    def _slot_to_coeff(self, ct_re: ckks.CkksCt, ct_im: ckks.CkksCt):
        lvl = min(ct_re.c0.limb_count, ct_im.c0.limb_count)
        ct_re = pe.align_level(self.ctx, ct_re, lvl)
        ct_im = pe.align_level(self.ctx, ct_im, lvl)
        if self.lt_stages:
            _, _, s2c_r, s2c_im = _merged_chain_matrices(
                self.params.dimension, self.lt_stages
            )
            tc = self._chain("s2cR", s2c_r, ct_re)
            td = self._chain("s2cI", s2c_im, ct_im)
            lv = min(tc.c0.limb_count, td.c0.limb_count)
            return ckks.add(self.ctx, pe.align_level(self.ctx, tc, lv),
                            pe.align_level(self.ctx, td, lv))
        _, _, _, _, C1, C2 = _c2s_s2c_matrices(self.params.dimension)
        target = self._default_target(ct_re)
        # the two halves may carry different (flexible) scales: plan per half
        tc = self._lt("C1", C1, ct_re, target)
        td = self._lt("C2", C2, ct_im, target)
        return ckks.add(self.ctx, tc, td)

    def __call__(self, ct: ckks.CkksCt) -> ckks.CkksCt:
        """Refresh an exhausted ciphertext: input at 1 limb, output at
        (levels − consumed) limbs encrypting the same message. The message
        scale Δ_in must satisfy Δ_in·|v| ≪ q0."""
        out = self._refresh(ct)
        _count(_rows(ct), {})
        return out

    def _refresh(self, ct: ckks.CkksCt) -> ckks.CkksCt:
        raised = self.raise_modulus(ct)  # scale q0, value t/q0
        z_re, z_im = self.coeff_to_slot(raised)
        w_re = self.eval_mod(z_re)
        w_im = self.eval_mod(z_im)
        out = self.slot_to_coeff(w_re, w_im)
        # the output's coefficients represent m/q0 at the working scale Δ_w,
        # so the message v = m/Δ_in sits at the scale Δ_w·Δ_in/q0
        q0 = self.ctx.mod_list[ct.c0.limb_ids[0]]
        return ckks.CkksCt(
            out.c0, out.c1, out.scaling_factor * ct.scaling_factor / float(q0)
        )


def _rows(ct: ckks.CkksCt) -> int:
    """Ciphertexts in a (batched) ciphertext."""
    return int(np.prod(ct.c0.data.shape[:-2], dtype=np.int64))


def bootstrap(
    ctx: Context,
    params: CkksParams,
    ct: ckks.CkksCt,
    rlk: rgsw_mod.RgswCt,
    rot_keys: Dict[int, rgsw_mod.RgswCt],
    conj_key: rgsw_mod.RgswCt,
    k_bound: int,
    degree: int = 31,
) -> ckks.CkksCt:
    """One-shot bootstrap (builds a transient Bootstrapper; callers that
    refresh repeatedly hold a Bootstrapper to reuse its plans)."""
    return Bootstrapper(ctx, params, rlk, rot_keys, conj_key, k_bound,
                        degree)(ct)


# ---------------------------------------------------------------------------
# The refresh as CUDA graphs
# ---------------------------------------------------------------------------


class _GraphStage:
    """A stage function of tensors captured as one CUDA graph on static
    input buffers: calling it copies the arguments into the buffers,
    replays the graph and returns clones of its outputs (the next replay
    overwrites them). Capture runs after one warm-up call on a side stream,
    with the bootstrapper strict: a plan or constant that the discovery
    refresh did not make raises instead of being encoded."""

    def __init__(self, fn, example_inputs, booter: Bootstrapper):
        dev = example_inputs[0].device
        self.inputs = tuple(x.clone() for x in example_inputs)
        booter._strict = booter._consts.frozen = True
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                fn(*self.inputs)
            torch.cuda.current_stream(dev).wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.outputs = tuple(fn(*self.inputs))
        finally:
            booter._strict = booter._consts.frozen = False

    def __call__(self, *args):
        for buf, x in zip(self.inputs, args):
            buf.copy_(x)
        self.graph.replay()
        return tuple(o.clone() for o in self.outputs)


class CompiledBootstrapper:
    """The whole refresh, or its four stages, captured as CUDA graphs that
    hold the keys and the plan plaintexts, bitwise equal to the eager
    Bootstrapper.

    Three phases at construction, timed in `timings`:
      1. discovery: one eager refresh of `example_ct` through the same stage
         functions; it records every plan (filled as it is recorded: the
         seconds of those encodes count under `materialize`), every constant
         plaintext and the metadata between stages;
      2. materialize: fills any plan still recorded host_only;
      3. capture: on a CUDA ciphertext, each stage (split=True: c2s, which
         begins with raise_modulus, evalmod_re, evalmod_im, s2c; the two
         EvalMod halves share one graph
         when their (limbs, scale) signatures match) or the whole refresh is
         captured as a CUDA graph after one warm-up. A failed capture
         raises. On a CPU ciphertext the stage functions run eagerly: that
         is the plain version.

    `key_switches`: the discovery refresh's key switches by stage, which
    each replayed refresh adds to KEY_SWITCHES.

    A call takes ciphertexts of example_ct's batch shape, limbs and scale.
    The stage callables of `stage_fns()` take and return data tensors:
    c2s (c0, c1) -> (re0, re1, im0, im1), evalmod (c0, c1) -> (c0, c1),
    s2c (re0, re1, im0, im1) -> (c0, c1)."""

    def __init__(self, booter: Bootstrapper, example_ct: ckks.CkksCt,
                 split: bool = False):
        t0 = time.perf_counter()
        self.timings: Dict[str, float] = {}
        self.b = booter
        self.split = bool(split)
        self.ids_in = example_ct.c0.limb_ids
        self.scale_in = float(example_ct.scaling_factor)
        self._batch_shape = tuple(example_ct.c0.data.shape[:-2])
        self.device = example_ct.c0.data.device
        self._meta: Dict = {}
        self._out_meta = None
        c0, c1 = example_ct.c0.data, example_ct.c1.data

        # 1. discovery: one eager refresh, chained through the stages; its
        # key switches by stage are what each replayed refresh adds
        mat0 = booter._materialize_s
        ks0 = dict(KEY_SWITCHES)
        booter._discover = True
        try:
            if not self.split:
                self._refresh(c0, c1)
            else:
                a = self._stage_a(c0, c1)
                re_key, im_key = self._meta["a"]
                self._fn_b = {}
                b_in = {}
                for kk, args in ((re_key, a[:2]), (im_key, a[2:])):
                    if kk not in self._fn_b:
                        self._fn_b[kk] = self._make_stage_b(*kk)
                        b_in[kk] = args
                wre = self._fn_b[re_key](*a[:2])
                wim = self._fn_b[im_key](*a[2:])
                self._stage_c(*wre, *wim)
        finally:
            booter._discover = False
        self.key_switches = {k: v - ks0.get(k, 0) for k, v in KEY_SWITCHES.items()
                             if v != ks0.get(k, 0)}
        mat = booter._materialize_s - mat0
        self.timings["discovery"] = time.perf_counter() - t0 - mat

        # 2. materialize whatever is still recorded host_only
        t0 = time.perf_counter()
        for plan in booter._plans.values():
            plan.materialize(booter.ctx, booter.params, self.device)
        self.timings["materialize"] = mat + time.perf_counter() - t0

        # 3. capture on the card; eager stage functions on the CPU
        t0 = time.perf_counter()
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        if not self.split:
            self._fn = _GraphStage(self._refresh, (c0, c1), booter) if cuda else self._refresh
        else:
            self._fn_a = _GraphStage(self._stage_a, (c0, c1), booter) if cuda else self._stage_a
            if cuda:
                self._fn_b = {kk: _GraphStage(f, b_in[kk], booter) for kk, f in self._fn_b.items()}
            self._fn_c = (_GraphStage(self._stage_c, (*wre, *wim), booter) if cuda
                          else self._stage_c)
        if cuda:
            torch.cuda.synchronize(self.device)
        self.timings["capture"] = time.perf_counter() - t0

    def _ct(self, c0, c1, ids, scale) -> ckks.CkksCt:
        return ckks.CkksCt(rns.RnsPoly(c0, rns.NTT, ids), rns.RnsPoly(c1, rns.NTT, ids), scale)

    def _refresh(self, c0, c1):
        out = self.b._refresh(self._ct(c0, c1, self.ids_in, self.scale_in))
        self._out_meta = (out.c0.limb_ids, float(out.scaling_factor))
        return out.c0.data, out.c1.data

    # ---- split-mode stages ------------------------------------------------

    def _stage_a(self, c0, c1):
        """raise_modulus + CoeffToSlot -> the two half ciphertexts."""
        b = self.b
        z_re, z_im = b.coeff_to_slot(b.raise_modulus(self._ct(c0, c1, self.ids_in,
                                                              self.scale_in)))
        self._meta["a"] = (
            (z_re.c0.limb_ids, float(z_re.scaling_factor)),
            (z_im.c0.limb_ids, float(z_im.scaling_factor)),
        )
        return z_re.c0.data, z_re.c1.data, z_im.c0.data, z_im.c1.data

    def _make_stage_b(self, ids, scale):
        """EvalMod at a static (limb_ids, scale) signature: both halves of
        CoeffToSlot share one stage when their signatures match."""

        def stage_b(c0, c1):
            w = self.b.eval_mod(self._ct(c0, c1, ids, scale))
            self._meta[("b", ids, scale)] = (w.c0.limb_ids, float(w.scaling_factor))
            return w.c0.data, w.c1.data

        return stage_b

    def _stage_c(self, re0, re1, im0, im1):
        """SlotToCoeff + the output-scale fix."""
        b = self.b
        re_key, im_key = self._meta["a"]
        w_re = self._ct(re0, re1, *self._meta[("b",) + re_key])
        w_im = self._ct(im0, im1, *self._meta[("b",) + im_key])
        out = b.slot_to_coeff(w_re, w_im)
        q0 = b.ctx.mod_list[self.ids_in[0]]
        self._out_meta = (out.c0.limb_ids,
                          float(out.scaling_factor * self.scale_in / float(q0)))
        return out.c0.data, out.c1.data

    def stage_fns(self):
        """Split-mode stage callables in refresh order."""
        if not self.split:
            raise ValueError("stage_fns requires split=True")
        re_key, im_key = self._meta["a"]
        return [
            ("c2s", self._fn_a),
            ("evalmod_re", self._fn_b[re_key]),
            ("evalmod_im", self._fn_b[im_key]),
            ("s2c", self._fn_c),
        ]

    def __call__(self, ct: ckks.CkksCt) -> ckks.CkksCt:
        if abs(ct.scaling_factor - self.scale_in) > 1e-6 * self.scale_in:
            raise ValueError("compiled for a different input scale")
        if (ct.c0.limb_ids != self.ids_in
                or tuple(ct.c0.data.shape[:-2]) != self._batch_shape):
            raise ValueError(f"compiled for limbs {self.ids_in} and batch shape "
                             f"{self._batch_shape}")
        if not self.split:
            o0, o1 = self._fn(ct.c0.data, ct.c1.data)
        else:
            fa, fb_re, fb_im, fc = (f for _, f in self.stage_fns())
            re0, re1, im0, im1 = fa(ct.c0.data, ct.c1.data)
            wre, wim = fb_re(re0, re1), fb_im(im0, im1)
            o0, o1 = fc(*wre, *wim)
        # a replay ran no Python to count its key switches
        _count(_rows(ct), self.key_switches if self.device.type == "cuda" else {})
        ids, scale = self._out_meta
        return self._ct(o0, o1, ids, scale)
