"""TFHE functional bootstrapping (port of hehub_tpu/models/tfhe.py).

  * LWE ciphertexts are batched int64 tensors of residues mod a 30-bit NTT
    prime q.
  * Blind rotation is a Python loop of CMUX steps, one per LWE secret
    coefficient; each step is a batched gadget decomposition, single-limb
    NTTs of 2048-value rows (K1, K2 on the card) and a Montgomery
    contraction against the bootstrap key in plain PyTorch (XLA in the
    reference, not a Pallas kernel).
  * The negacyclic monomial multiply X^k of the hot loop is one pointwise
    Montgomery multiply by a row of a precomputed NTT(X^k) table.
  * Sample extraction and the LWE key switch complete the bootstrap. The
    key switch is one float64 matrix product of the digit matrix with the
    key, exact while every row sum stays below 2^53 (else the key is split
    into bit planes recombined mod q).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from hehub_tpu_torch.core.context import RlweParams, make_context
from hehub_tpu_torch.ops import modarith as ma
from hehub_tpu_torch.ops import ntt as nttmod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod
from hehub_tpu_torch.utils import hostmath as hm
from hehub_tpu_torch.utils import security as sec

# float64 holds every integer below 2^53 exactly
_F64_EXACT_BITS = 53


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TfheParams:
    """Gate/functional bootstrapping parameters.

    rlwe_dimension: accumulator ring size N; lwe_dimension: LWE secret size;
    decomp_bits/levels: RGSW gadget base 2^b and level count; ks_*: the LWE
    key-switch digit decomposition."""

    rlwe_dimension: int = 1024
    lwe_dimension: int = 512
    decomp_bits: int = 6
    decomp_levels: int = 5
    ks_decomp_bits: int = 10
    ks_levels: int = 3
    lwe_noise_std: float = 3.2

    @functools.cached_property
    def rlwe_params(self) -> RlweParams:
        q = hm.gen_ntt_primes(30, 1, self.rlwe_dimension)[0]
        return RlweParams(dimension=self.rlwe_dimension, moduli=(q,))

    @property
    def q(self) -> int:
        return self.rlwe_params.moduli[0]

    def security_bits(self) -> float:
        """Estimated LWE security of the weakest link: min over the LWE
        layer (n, q, σ_lwe) and the RLWE accumulator (N, q, σ=3.2)."""
        lwe = lwe_security_bits(self.lwe_dimension, self.q, self.lwe_noise_std)
        rlwe = lwe_security_bits(self.rlwe_dimension, self.q, 3.2)
        return min(lwe, rlwe)


def lwe_security_bits(n: int, q: int, sigma: float) -> float:
    """Estimated (R)LWE security for binary/ternary secrets, interpolated
    through the HomomorphicEncryption.org Standard v1.1 ternary-classical
    table (utils/security.py)."""
    return sec.ternary_lwe_security_bits(n, q, sigma)


# The 128-bit preset (utils/security.py): LWE layer n=740, σ = 2^13.5,
# q/σ = 2^16.5 → 141.1 bits; accumulator N=2048, σ = 3.2 → 246.0 bits.
# Key-switch base 2^5 x 6 levels keeps the key-switch noise ≈ 2^24.3 well
# below the q/8 gate margin. The toy preset is NOT secure (LWE layer n=256,
# σ=3.2 → 9.5 bits).
PRESET_GATE_128 = TfheParams(
    rlwe_dimension=2048,
    lwe_dimension=740,
    decomp_bits=6,
    decomp_levels=5,
    ks_decomp_bits=5,
    ks_levels=6,
    lwe_noise_std=float(2.0**13.5),
)
PRESET_TOY = TfheParams(rlwe_dimension=1024, lwe_dimension=256)


class LweCt(NamedTuple):
    """LWE ciphertext(s): a [..., m], b [...], int64 residues mod q,
    phase = b + <a,s>."""

    a: torch.Tensor
    b: torch.Tensor


class TfheKeys(NamedTuple):
    """lwe_s: binary LWE secret [m]; rlwe_sk: accumulator ring key;
    bsk: bootstrap key [m, 2, l, 2, N] (Montgomery-domain NTT values);
    ksk_a [N, kl, m], ksk_b [N, kl]: the LWE key-switch key (strict).
    All int64 tensors on the keys' device."""

    lwe_s: torch.Tensor
    rlwe_sk: rlwe_mod.RlweSk
    bsk: torch.Tensor
    ksk_a: torch.Tensor
    ksk_b: torch.Tensor


def _as_int64(x, device) -> torch.Tensor:
    """Numpy values (any integer dtype) or a tensor as int64 on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.asarray(x).astype(np.int64)).to(device)


# ---------------------------------------------------------------------------
# LWE layer
# ---------------------------------------------------------------------------


def lwe_keygen(params: TfheParams, gen: torch.Generator) -> torch.Tensor:
    """Binary LWE secret [m] on the generator's device."""
    return torch.randint(0, 2, (params.lwe_dimension,), generator=gen, device=gen.device)


def lwe_encrypt(params: TfheParams, msg, s: torch.Tensor, gen: torch.Generator,
                noise_std: Optional[float] = None) -> LweCt:
    """b = m - <a,s> + e, so phase := b + <a,s> = m + e; on the generator's
    device. `msg`: uint32 values [...]; uint32 wraparound is reproduced."""
    q = params.q
    dev = gen.device
    msg = _as_int64(msg, dev)
    a = torch.randint(0, q, (*msg.shape, params.lwe_dimension), generator=gen, device=dev)
    sig = params.lwe_noise_std if noise_std is None else noise_std
    e = torch.round(torch.randn(msg.shape, generator=gen, device=dev, dtype=torch.float64)
                    * sig).to(torch.int64)
    dot = _lwe_dot(a, s, q)
    b = ((msg + e % q + 2 * q - dot) & ma.MASK32) % q
    return LweCt(a, b)


def _lwe_dot(a, s, q: int):
    """<a, s> mod q for binary s: masked lazy tree sum."""
    masked = torch.where(s != 0, a % q, 0)
    return ma.reduce_strict(ma.reduce_add_lazy(masked, -1, 2 * q), q)


def lwe_phase(params: TfheParams, ct: LweCt, s: torch.Tensor):
    q = params.q
    return (ct.b % q + _lwe_dot(ct.a, s, q)) % q


def lwe_decrypt_bit(params: TfheParams, ct: LweCt, s: torch.Tensor):
    """1 if phase in [0, q/2) else 0."""
    return (lwe_phase(params, ct, s) < params.q // 2).to(torch.int64)


# ---------------------------------------------------------------------------
# Keygen: bootstrap + key-switch keys
# ---------------------------------------------------------------------------


def keygen(params: TfheParams, gen: torch.Generator, debug_zero_e: bool = False) -> TfheKeys:
    """All keys on the generator's device: the LWE and ring secrets, the
    bootstrap key RGSW(s_i) over one limb and the LWE key-switch key
    LWE_s(z_j · Bks^v)."""
    dev = gen.device
    lwe_s = lwe_keygen(params, gen)
    ctx = make_context(params.rlwe_params)
    rlwe_sk = rlwe_mod.keygen(ctx, gen)
    q = params.q
    m = params.lwe_dimension
    ell = params.decomp_levels
    B = 1 << params.decomp_bits

    # bootstrap key: rows of component c = 0 perturb c0, c = 1 perturb c1
    # (constant polynomials: the NTT of a constant is that constant)
    c0, c1 = rlwe_mod.rlwe_sample(ctx, rlwe_sk, gen, (0,), batch_shape=(m, 2, ell),
                                  debug_zero_e=debug_zero_e)
    c0d, c1d = c0.data[..., 0, :], c1.data[..., 0, :]  # [m, 2, ell, n]
    gadget = torch.tensor([pow(B, j, q) for j in range(ell)], dtype=torch.int64, device=dev)
    add0 = lwe_s[:, None] * gadget[None, :] % q  # [m, ell] = s_i * B^j
    zero = torch.zeros_like(add0)
    c0d = ma.add_lazy(c0d, torch.stack([add0, zero], dim=1)[..., None], 2 * q)
    c1d = ma.add_lazy(c1d, torch.stack([zero, add0], dim=1)[..., None], 2 * q)
    bsk = torch.stack([c0d, c1d], dim=-2)  # [m, 2, ell, 2, n]
    bsk = ma.shoup_mul_lazy(bsk, int(ctx.r_mod_q[0, 0]), int(ctx.r_shoup[0, 0]), q)

    # LWE key-switch key
    N, kl = params.rlwe_dimension, params.ks_levels
    Bks = 1 << params.ks_decomp_bits
    z = rlwe_sk.coeffs.to(torch.int64)  # ternary [N]
    a = torch.randint(0, q, (N, kl, m), generator=gen, device=dev)
    if debug_zero_e:
        e = torch.zeros((N, kl), dtype=torch.int64, device=dev)
    else:
        e = torch.round(torch.randn((N, kl), generator=gen, device=dev, dtype=torch.float64)
                        * params.lwe_noise_std).to(torch.int64)
    gks = torch.tensor([pow(Bks, v, q) for v in range(kl)], dtype=torch.int64, device=dev)
    dot = (a * lwe_s).sum(-1) % q  # [N, kl]
    b = (z[:, None] * gks[None, :] + e - dot) % q
    return TfheKeys(lwe_s, rlwe_sk, bsk, a, b)


# ---------------------------------------------------------------------------
# Blind rotation machinery
# ---------------------------------------------------------------------------


def _negacyclic_monomial_mul(coeffs, k, n: int, two_q):
    """coeffs(X) * X^k in Z_q[X]/(X^n+1), k in [0, 2n), per batch.
    coeffs: [..., C, n]; k: [...] (broadcast over C). The test path: the
    blind rotation multiplies by rows of _monomial_tables instead."""
    k = _as_int64(k, coeffs.device)
    k0 = (k % n)[..., None, None]
    wrap = ((k // n) % 2)[..., None, None]
    j = torch.arange(n, device=coeffs.device)
    src = ((j - k0) % n).expand(coeffs.shape)
    g = torch.gather(coeffs, -1, src)
    flip = (j < k0) ^ (wrap != 0)
    return torch.where(flip, ma.neg_lazy(g, two_q), g)


@functools.lru_cache(maxsize=None)
def _monomial_tables(params: TfheParams, device: str = "cuda"):
    """(T_mont, Tm1_mont) on `device`: NTT-value tables of X^k and X^k − 1
    for every k ∈ [0, 2n), pre-scaled to the Montgomery domain (·2^32 mod
    q), int64 [2n, n] each. Multiplying the NTT-form accumulator by row k
    is the negacyclic monomial multiply. Built with one batched NTT (K1 on
    the card); the strict residues are unique, so the tables equal the
    reference's host-built ones."""
    n, q = params.rlwe_dimension, params.q
    ctx = make_context(params.rlwe_params)
    k = torch.arange(n, device=device)
    mono = torch.zeros((2 * n, 1, n), dtype=torch.int64, device=device)
    mono[k, 0, k] = 1
    mono[n + k, 0, k] = q - 1  # X^{n+k} = −X^k mod (X^n + 1)
    t_hat = ma.reduce_strict(nttmod.ntt(ctx, mono, (0,)), q)[:, 0, :]
    r = (1 << 32) % q
    return t_hat * r % q, (t_hat + (q - 1)) % q * r % q


def _gadget_decompose(x, bits: int, levels: int):
    """Unsigned base-2^bits digits of strict residues: [..., n] -> [..., levels, n]."""
    mask = (1 << bits) - 1
    return torch.stack([(x >> (bits * j)) & mask for j in range(levels)], dim=-2)


def _ntt1(ctx, x):
    """Single-limb NTT of [..., n] batches under limb 0's tables."""
    return nttmod.ntt(ctx, x.reshape(-1, 1, x.shape[-1]), (0,)).reshape(x.shape)


def _intt1(ctx, x):
    return nttmod.intt(ctx, x.reshape(-1, 1, x.shape[-1]), (0,)).reshape(x.shape)


def blind_rotate(params: TfheParams, test_poly, a_tilde, b_tilde, bsk, tables=None):
    """acc = test_poly * X^{-(b~ + <a~, s>)} under RLWE encryption.

    test_poly: [n] strict; a_tilde: [..., m] in [0, 2N); b_tilde: [...] in
    [0, 2N). Returns acc (c0, c1) coeff-form [..., 2, n].

    The accumulator stays in NTT form across the loop: each CMUX step forms
    acc·(X^{−a_i} − 1) as a table row times acc, inverse-transforms only
    that difference for the gadget decomposition, and adds the
    external-product update back in the NTT domain; the contraction's tree
    sum over (component, level) keeps the reference's lazy
    representatives."""
    ctx = make_context(params.rlwe_params)
    dev = a_tilde.device
    q, n = params.q, params.rlwe_dimension
    two_n, two_q = 2 * n, 2 * q
    neg_qinv = int(ctx.neg_qinv[0, 0])
    t_mont, tm1_mont = tables if tables is not None else _monomial_tables(params, str(dev))

    batch = a_tilde.shape[:-1]
    # initial acc: (c0, c1) = (t · X^{-b~}, 0), in NTT form
    t_hat = _ntt1(ctx, _as_int64(test_poly, dev))  # [n] lazy
    b_row = t_mont[(two_n - b_tilde) % two_n]  # [..., n]
    c0_hat = ma.mont_mul_lazy(t_hat.expand(*batch, n), b_row, q, neg_qinv)[..., None, :]
    acc = torch.cat([c0_hat, torch.zeros_like(c0_hat)], dim=-2)
    for i in range(a_tilde.shape[-1]):
        rows = tm1_mont[(two_n - a_tilde[..., i]) % two_n]  # NTT(X^{−a_i} − 1)
        diff_hat = ma.mont_mul_lazy(acc, rows[..., None, :], q, neg_qinv)
        diff = ma.reduce_strict(_intt1(ctx, diff_hat), q)
        digits = _gadget_decompose(diff, params.decomp_bits, params.decomp_levels)
        dig_ntt = _ntt1(ctx, digits)  # [..., 2, ell, n]
        prod = ma.mont_mul_lazy(dig_ntt[..., None, :], bsk[i], q, neg_qinv)  # [..., 2, ell, 2, n]
        summed = ma.reduce_add_lazy(prod.reshape(*batch, -1, 2, n), -3, two_q)
        acc = ma.add_lazy(acc, summed, two_q)
    return _intt1(ctx, acc)


def sample_extract(params: TfheParams, acc) -> LweCt:
    """LWE ct of acc's constant coefficient under the ring key's coefficient
    vector: a = (c1[0], -c1[n-1], ..., -c1[1]), b = c0[0]."""
    q = params.q
    c0, c1 = acc[..., 0, :], acc[..., 1, :]
    rest = ma.neg_lazy(torch.flip(c1[..., 1:], dims=(-1,)), 2 * q)
    a = torch.cat([c1[..., :1], rest], dim=-1)
    return LweCt(ma.reduce_strict(a, q), ma.reduce_strict(c0[..., 0], q))


def _ks_plane_bits(params: TfheParams) -> int:
    """The widest key bit plane whose float64 product with the digit matrix
    stays exact: N·kl·(2^kb − 1)·(2^w − 1) < 2^53."""
    terms = params.rlwe_dimension * params.ks_levels * ((1 << params.ks_decomp_bits) - 1)
    w = params.q.bit_length()
    while w > 1 and terms * ((1 << w) - 1) >= 1 << _F64_EXACT_BITS:
        w -= 1
    return w


def _key_switch_planes(params: TfheParams, ct: LweCt, keys: TfheKeys, plane_bits: int) -> LweCt:
    """The key switch with the key [ksk_a | ksk_b] cut into bit planes of
    `plane_bits` bits: per plane one float64 product D @ plane, exact while
    every row sum stays below 2^53, then the planes' sums recombined mod q
    (Horner, from the top plane). The b part rides as the key's last
    column."""
    q = params.q
    kb, kl = params.ks_decomp_bits, params.ks_levels
    m, N = params.lwe_dimension, params.rlwe_dimension
    mask = (1 << kb) - 1
    d = torch.stack([(ct.a >> (kb * v)) & mask for v in range(kl)], dim=-1)  # [..., N, kl]
    D = d.reshape(*d.shape[:-2], N * kl).to(torch.float64)
    key = torch.cat([keys.ksk_a, keys.ksk_b[..., None]], dim=-1).reshape(N * kl, m + 1)
    acc = None
    for s in reversed(range(-(-q.bit_length() // plane_bits))):
        plane = ((key >> (plane_bits * s)) & ((1 << plane_bits) - 1)).to(torch.float64)
        part = torch.matmul(D, plane).to(torch.int64) % q
        acc = part if acc is None else (acc * (1 << plane_bits) + part) % q
    return LweCt(acc[..., :m], (acc[..., m] + ct.b % q) % q)


def key_switch(params: TfheParams, ct: LweCt, keys: TfheKeys) -> LweCt:
    """LWE dimension switch N -> m by digit decomposition against the
    key-switch key: the strict residues (Σ d·k + b) mod q of both of the
    reference's forms (its int8 planes for digit bases ≤ 2^7, its
    elementwise Shoup form above), here by float64 matrix products
    (_key_switch_planes). Plain PyTorch: the reference computes this
    product outside any Pallas kernel."""
    return _key_switch_planes(params, ct, keys, _ks_plane_bits(params))


# ---------------------------------------------------------------------------
# Functional bootstrapping
# ---------------------------------------------------------------------------


def _mod_switch_2n(params: TfheParams, x):
    """x mod q -> round(x * 2N / q) mod 2N via a mulhi magic constant
    (exact up to +-1, inside the bootstrap noise budget)."""
    q = params.q
    two_n = 2 * params.rlwe_dimension
    magic = (two_n << 32) // q
    return ma.mul_hi((x + q // (2 * two_n)) & ma.MASK32, magic) % two_n


def functional_bootstrap(params: TfheParams, ct: LweCt, lut_poly, keys: TfheKeys,
                         tables=None) -> LweCt:
    """Evaluate the LUT polynomial on ct's phase under encryption, refreshing
    noise. Negacyclic: for a phase in the upper half the result is the
    negated LUT value."""
    a_t = _mod_switch_2n(params, ct.a)
    b_t = _mod_switch_2n(params, ct.b)
    acc = blind_rotate(params, lut_poly, a_t, b_t, keys.bsk, tables)
    return key_switch(params, sample_extract(params, acc), keys)


def _const_lut(params: TfheParams, device):
    return torch.full((params.rlwe_dimension,), params.q // 8, dtype=torch.int64, device=device)


def get_redundant_msb(params: TfheParams, ct: LweCt, keys: TfheKeys, tables=None) -> LweCt:
    """LWE(k * q/2) where k is the redundant MSB of ct's phase: the
    bootstrap with the constant q/8 test vector gives ±q/8 by
    negacyclicity; map {+q/8 -> 0, -q/8 -> q/2}."""
    q = params.q
    out = functional_bootstrap(params, ct, _const_lut(params, ct.a.device), keys, tables)
    # msb = (q/8 - out) * 2 = q/4 - 2*out
    a = ma.neg_lazy(ma.add_lazy(out.a, out.a, 2 * q), 2 * q)
    b = ma.sub_lazy(torch.full_like(out.b, q // 4), ma.add_lazy(out.b, out.b, 2 * q) % q, 2 * q)
    return LweCt(ma.reduce_strict(a, q), ma.reduce_strict(b, q))


def fully_functional_bootstrap(params: TfheParams, ct: LweCt, lut_poly, keys: TfheKeys,
                               tables=None) -> LweCt:
    """Negacyclicity-free bootstrap: strip the redundant MSB, then the
    functional bootstrap (two bootstraps in all)."""
    q = params.q
    msb = get_redundant_msb(params, ct, keys, tables)
    a = ma.sub_lazy(ct.a % q, msb.a, 2 * q)
    b = ma.sub_lazy(ct.b % q, msb.b, 2 * q)
    fixed = LweCt(ma.reduce_strict(a, q), ma.reduce_strict(b, q))
    return functional_bootstrap(params, fixed, lut_poly, keys, tables)


# ---------------------------------------------------------------------------
# Gate helpers
# ---------------------------------------------------------------------------


def encode_bit(params: TfheParams, bit, device="cuda"):
    """TRUE -> q/8, FALSE -> -q/8, on `device`."""
    q = params.q
    return torch.where(_as_int64(bit, device) != 0, q // 8, q - q // 8)


def _nand_linear(params: TfheParams, ct1: LweCt, ct2: LweCt) -> LweCt:
    """The NAND's linear part (0, q/8) - ct1 - ct2, strict."""
    q = params.q
    a = ma.neg_lazy(ma.add_lazy(ct1.a % q, ct2.a % q, 2 * q), 2 * q)
    b = ma.sub_lazy(torch.full_like(ct1.b, q // 8),
                    ma.add_lazy(ct1.b % q, ct2.b % q, 2 * q) % q, 2 * q)
    return LweCt(ma.reduce_strict(a, q), ma.reduce_strict(b, q))


def nand_gate(params: TfheParams, ct1: LweCt, ct2: LweCt, keys: TfheKeys,
              tables=None) -> LweCt:
    """Bootstrapped NAND: linear part (0, q/8) - ct1 - ct2, then the
    bootstrap with the constant q/8 test vector."""
    lin = _nand_linear(params, ct1, ct2)
    return functional_bootstrap(params, lin, _const_lut(params, ct1.a.device), keys, tables)


class NandGate(torch.nn.Module):
    """A batched bootstrapped NAND holding the public key material as
    buffers: the bootstrap key, the key-switch key and the monomial tables
    (`.to(device)` moves them all). Holds no secret."""

    def __init__(self, params: TfheParams, keys: TfheKeys):
        super().__init__()
        self.params = params
        t_mont, tm1_mont = _monomial_tables(params, str(keys.bsk.device))
        for name, t in (("bsk", keys.bsk), ("ksk_a", keys.ksk_a), ("ksk_b", keys.ksk_b),
                        ("t_mont", t_mont), ("tm1_mont", tm1_mont)):
            self.register_buffer(name, t)

    def forward(self, ct1: LweCt, ct2: LweCt) -> LweCt:
        keys = TfheKeys(None, None, self.bsk, self.ksk_a, self.ksk_b)
        return nand_gate(self.params, ct1, ct2, keys, tables=(self.t_mont, self.tm1_mont))


def make_nand(params: TfheParams, keys: TfheKeys) -> NandGate:
    """The batched NAND of `keys`, on their device: (ct1, ct2) -> LweCt."""
    return NandGate(params, keys)
