"""Parameter objects and the immutable precomputed-table Context (port of
hehub_tpu/core/context.py: create_ckks_params,
create_ckks_params_from_bit_lengths, create_bgv_params, Context).

Tables are computed once, on the host, in numpy uint32 — bitwise equal to
the JAX package's. Ops take them as device tensors through
`Context.device_rows`, which caches one tensor per (table, limb ids,
device, dtype) on the context.

Layout: a context covers M = len(moduli) + len(special_mods) limbs, the
ciphertext chain q_0..q_{L-1} followed by the key-switching special
prime(s).

The twiddle tables also come regrouped for rows split into sub-rows, as
the kernels split rows above kernels.NTT_SUB_N / EXT_SUB_N: under the
name `sub_table(name, sub_n)` (see `sub_row_tables`), made from the
compact ones when first asked for.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from hehub_tpu_torch.utils import hostmath as hm

U32 = np.uint32
U64 = np.uint64


@dataclasses.dataclass(frozen=True)
class RlweParams:
    """Static RLWE parameters. `special_mod` is one prime or a tuple of
    primes (the key-switching specials)."""

    dimension: int
    moduli: Tuple[int, ...]
    special_mod: Optional[object] = None  # int | Tuple[int, ...] | None

    def __post_init__(self):
        n = self.dimension
        if n & (n - 1) or n < 8:
            raise ValueError("dimension must be a power of two >= 8")
        if self.special_mod is not None and not isinstance(
            self.special_mod, (int, np.integer)
        ):
            object.__setattr__(self, "special_mod", tuple(self.special_mod))
        all_mods = self.moduli + self.special_mods
        if len(set(all_mods)) != len(all_mods):
            raise ValueError("moduli must be distinct")
        for q in all_mods:
            # lazy [0, 2q) residues in 32 bits need q < 2^30 (4q < 2^32 in
            # the butterflies); q >= 2^22 keeps the base-2^22 digit planes
            # of basecnv.decompose_digits valid lazy inputs
            if not (1 << 22) <= q < (1 << 30):
                raise ValueError(f"modulus {q} outside the [23, 30]-bit lane range")
            if q % (2 * n) != 1 or not hm.is_prime(q):
                raise ValueError(f"{q} is not an NTT prime for n={n}")

    @property
    def special_mods(self) -> Tuple[int, ...]:
        if self.special_mod is None:
            return ()
        if isinstance(self.special_mod, (int, np.integer)):
            return (int(self.special_mod),)
        return tuple(self.special_mod)


@dataclasses.dataclass(frozen=True)
class CkksParams(RlweParams):
    initial_scaling_factor: float = 1.0


@dataclasses.dataclass(frozen=True)
class BgvParams(RlweParams):
    """BGV parameters: plaintext modulus t, any integer in [2, 2^58)
    coprime to the ciphertext moduli.

    SIMD slot packing additionally needs every prime factor of t to satisfy
    t_i ≡ 1 (mod 2n); factors < 2^29 pack through the NTT kernels, larger
    ones through the host big-prime NTT (hostmath.ntt_host_u64)."""

    plain_modulus: int = 0

    def __post_init__(self):
        super().__post_init__()
        t = self.plain_modulus
        if not 2 <= t < (1 << 58):
            raise ValueError(f"plain modulus {t} must be in [2, 2^58)")
        for q in self.moduli + self.special_mods:
            if math.gcd(t, q) != 1:
                raise ValueError("plain modulus must be coprime with ct moduli")

    @property
    def plain_factors(self) -> Tuple[int, ...]:
        """t as pairwise-coprime prime powers (the CRT basis for Z_t)."""
        return hm.coprime_factors(self.plain_modulus)

    @property
    def simd_capable(self) -> bool:
        """True when Z_t slots pack via per-factor negacyclic NTTs."""
        n = self.dimension
        return all(e == 1 and p % (2 * n) == 1 for p, e in hm.factorize(self.plain_modulus))


# ~128-bit-security total log(Q·P) budgets per dimension (the
# HomomorphicEncryption.org Standard v1.1 ternary-classical column).
STD_LOGQP_BUDGET = {1024: 27, 2048: 54, 4096: 109, 8192: 218, 16384: 438, 32768: 881}


def create_ckks_params(
    dimension: int,
    scaling_bits: int = 28,
    num_levels: Optional[int] = None,
    use_security_budget: bool = True,
    num_special: int = 1,
) -> CkksParams:
    """CKKS parameters with 30-bit limbs; the level budget comes from the
    standard log(QP) table divided into 30-bit primes."""
    if scaling_bits > 55:
        raise ValueError(
            "scaling factors above 2^55 leave no slot-value headroom below "
            "the 2^62 encode bound"
        )
    budget = STD_LOGQP_BUDGET.get(dimension)
    if num_levels is None:
        if budget is None:
            raise ValueError(f"no standard budget for dimension {dimension}")
        num_levels = budget // 30 - num_special
        if num_levels < 1:
            if use_security_budget:
                raise ValueError(
                    f"dimension {dimension} cannot fit even one level plus "
                    f"{num_special} special prime(s) within its {budget}-bit "
                    "128-bit-security budget; use a larger dimension, or pass "
                    "num_levels explicitly with use_security_budget=False to "
                    "build KNOWINGLY-INSECURE parameters"
                )
            num_levels = 1
    if use_security_budget:
        if budget is None:
            raise ValueError(
                f"no standard security budget for dimension {dimension}; "
                "pass use_security_budget=False to opt out explicitly"
            )
        if 30 * (num_levels + num_special) > budget:
            raise ValueError(
                f"{num_levels} levels exceed the 128-bit-security budget "
                f"({budget} bits) for dimension {dimension}"
            )
    if 29 * num_levels < scaling_bits + 11:
        raise ValueError(
            f"{num_levels} levels of 30-bit primes cannot hold coefficients "
            f"at a 2^{scaling_bits} scale (fresh ciphertexts would wrap mod Q)"
        )
    primes = hm.gen_ntt_primes(30, num_levels + num_special, dimension)
    return CkksParams(
        dimension=dimension,
        moduli=tuple(primes[num_special:]),
        special_mod=tuple(primes[:num_special]) if num_special != 1 else primes[0],
        initial_scaling_factor=float(2.0**scaling_bits),
    )


def create_ckks_params_from_bit_lengths(
    dimension: int,
    moduli_bits: Sequence[int],
    special_mod_bits: Union[int, Sequence[int]] = 30,
    initial_scaling_factor: Optional[float] = None,
    use_security_budget: bool = True,
) -> CkksParams:
    """CKKS parameters from the bit width of every chain prime and of the
    special prime(s), each in [23, 30] (uint32 limbs with lazy headroom);
    the scaling factor defaults to 2^(last chain width). Picks the primes
    of the reference: the specials first, then the chain, each width's
    primes from one downward scan (gen_ntt_primes)."""
    if not moduli_bits:
        raise ValueError("need at least one chain modulus")
    specials = (
        (special_mod_bits,) if isinstance(special_mod_bits, int) else tuple(special_mod_bits)
    )
    for w in (*moduli_bits, *specials):
        if not 23 <= w <= 30:
            raise ValueError(
                f"per-prime widths must be in [23, 30] bits (got {w}): uint32 limbs need "
                "q < 2^30 for lazy arithmetic and q >= 2^22 for the digit-plane "
                "decompositions; for wider effective scales use create_ckks_params with a "
                "multi-limb scaling factor (scaling_bits up to 55)"
            )
    if use_security_budget:
        budget = STD_LOGQP_BUDGET.get(dimension)
        if budget is None:
            raise ValueError(
                f"no standard security budget for dimension {dimension}; "
                "pass use_security_budget=False to opt out explicitly"
            )
        total = sum(moduli_bits) + sum(specials)
        if total > budget:
            raise ValueError(
                f"sum of prime widths ({total} bits) exceeds the 128-bit-security budget "
                f"({budget} bits) for dimension {dimension}"
            )
    # same-width primes come from one scan, so all are distinct; different
    # widths lie in disjoint ranges [2^(w-1), 2^w)
    order = [*specials, *moduli_bits]
    need: Dict[int, int] = {}
    for w in order:
        need[w] = need.get(w, 0) + 1
    pools = {w: list(hm.gen_ntt_primes(w, c, dimension)) for w, c in need.items()}
    picked = [pools[w].pop(0) for w in order]
    special = picked[: len(specials)]
    scale = (float(initial_scaling_factor) if initial_scaling_factor is not None
             else float(2.0 ** moduli_bits[-1]))
    return CkksParams(
        dimension=dimension,
        moduli=tuple(picked[len(specials):]),
        special_mod=tuple(special) if len(special) != 1 else special[0],
        initial_scaling_factor=scale,
    )


def create_bgv_params(
    dimension: int,
    plain_bits: int = 17,
    num_levels: int = 3,
    num_special: int = 1,
    plain_modulus: Optional[int] = None,
    use_security_budget: bool = True,
) -> BgvParams:
    """BGV parameters: 30-bit ciphertext primes and a plaintext modulus, an
    NTT prime of `plain_bits` bits by default, or any explicit
    `plain_modulus` in [2, 2^58) coprime to the chain (composite, large
    prime or non-NTT values all work; SIMD needs NTT-friendly factors).
    The 128-bit-security log(QP) budget is enforced as for CKKS;
    use_security_budget=False builds knowingly insecure test parameters."""
    if use_security_budget:
        budget = STD_LOGQP_BUDGET.get(dimension)
        if budget is None:
            raise ValueError(
                f"no standard security budget for dimension {dimension}; "
                "pass use_security_budget=False to opt out explicitly"
            )
        if 30 * (num_levels + num_special) > budget:
            raise ValueError(
                f"{num_levels} levels exceed the 128-bit-security budget "
                f"({budget} bits) for dimension {dimension}"
            )
    primes = hm.gen_ntt_primes(30, num_levels + num_special, dimension)
    t = plain_modulus or hm.gen_ntt_primes(plain_bits, 1, dimension)[0]
    return BgvParams(
        dimension=dimension,
        moduli=tuple(primes[num_special:]),
        special_mod=tuple(primes[:num_special]) if num_special != 1 else primes[0],
        plain_modulus=int(t),
    )


def _bitrev_indices(n: int) -> np.ndarray:
    logn = n.bit_length() - 1
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(logn):
        rev |= ((idx >> b) & 1) << (logn - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def _psi_power_table(q: int, n: int, inverse: bool) -> np.ndarray:
    """psis[j] = ψ^{±bitrev(j, log n)} mod q, uint32 [n]."""
    psi = hm.negacyclic_psi(q, n)
    if inverse:
        psi = hm.modinv(psi, q)
    powers = np.empty(n, dtype=np.uint64)
    acc = 1
    for j in range(n):
        powers[j] = acc
        acc = acc * psi % q
    return powers[_bitrev_indices(n)].astype(np.uint32)


def _shoup_np(w: np.ndarray, q: int) -> np.ndarray:
    return ((w.astype(U64) << U64(32)) // U64(q)).astype(U32)


def sub_table(name: str, sub_n: int) -> str:
    """The name under which Context.rows / device_rows,
    ModulusTables.device_row and TableRows.device_rows give the twiddle
    table `name` (tw_fwd, tw_fwd_sh, tw_inv or tw_inv_sh, or a sub_table
    name itself) regrouped for sub-rows of sub_n (sub_row_tables): so
    sub_table(sub_table("tw_fwd", 131072), 32768) is the table regrouped
    for parts of 131072, each part's row regrouped again for sub-rows of
    32768."""
    return f"{name}@{sub_n}"


def _host_rows(lookup, name: str) -> np.ndarray:
    """The host rows of table `name`: lookup(name) for a plain name, and for
    a sub_table name its compact table lookup(base) regrouped along the
    name's chain of sub-row lengths."""
    base, *subs = name.split("@")
    if not subs:
        return lookup(name)
    tw = lookup(base)
    for sub_n in subs:
        tw = sub_row_tables(tw, int(sub_n))
    return tw


def _device_copy(host: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """uint32 host rows on `device`: int64 values, or int32 bits."""
    host = np.ascontiguousarray(host, dtype=U32)
    host = host.view(np.int32).copy() if dtype == torch.int32 else host.astype(np.int64)
    return torch.from_numpy(host).to(device=device)


def sub_row_tables(tw: np.ndarray, sub_n: int) -> np.ndarray:
    """A compact [L, n] twiddle table regrouped for rows of n = P sub_n
    split into P = 2^k sub-rows of sub_n: [L P, sub_n], row l P + j holding
    sub-row j's table sub_j[m + i] = tw[l, P m + j m + i] for m = 1, 2, 4,
    ..., sub_n / 2 and i < m, and in its entry 0, which no stage of a
    sub-row reads, tw[l, j]: so the rows of limb l also hold tw[l, :2P],
    entry e < P at row l P + e, entry 0, and entry P + j at row l P + j,
    entry 1 (the twiddles of the stages that pair whole sub-rows, which the
    kernels read there).

    After the first k forward stages, which pair whole sub-rows, stage
    k + s of the chain takes tw[2^(k+s) + i] for group i = j 2^s + i' of
    sub-row j, which is sub_j[2^s + i']: each sub-row runs the ordinary
    chain of length sub_n under sub_j. The inverse chain's first
    log2(sub_n) stages act within sub-rows the same way (block b of stage s
    takes tw[n / 2^(s+1) + b]). For n <= sub_n the result is tw itself."""
    L, n = tw.shape
    parts = max(n // sub_n, 1)
    width = n // parts
    out = np.empty((L, parts, width), tw.dtype)
    out[:, :, 0] = tw[:, :parts]
    m = 1
    while m < width:
        out[:, :, m : 2 * m] = tw[:, parts * m : 2 * parts * m].reshape(L, parts, m)
        m *= 2
    return out.reshape(L * parts, width)


class ModulusTables:
    """Per-modulus constants and twiddle tables for one prime q; `device_row`
    hands out cached device copies shaped as one limb."""

    def __init__(self, q: int, n: int):
        self.q = U32(q)
        self.two_q = U32(2 * q)
        self.neg_qinv = U32((-hm.modinv(q, 1 << 32)) % (1 << 32))
        r = (1 << 32) % q
        self.r_mod_q = U32(r)
        self.r_shoup = U32(hm.shoup(r, q))
        self.r2_mod_q = U32(r * r % q)
        self.tw_fwd = _psi_power_table(q, n, inverse=False)
        self.tw_fwd_sh = _shoup_np(self.tw_fwd, q)
        tw_inv = _psi_power_table(q, n, inverse=True).astype(np.uint64)
        n_inv = hm.modinv(n, q)
        # n^-1 folds into the single twiddle of the last inverse stage
        last = int(tw_inv[1]) * n_inv % q
        self.tw_inv = tw_inv.astype(U32)
        self.tw_inv_sh = _shoup_np(self.tw_inv, q)
        self.tw_inv_last = U32(last)
        self.tw_inv_last_sh = U32(hm.shoup(last, q))
        self.n_inv = U32(n_inv)
        self.n_inv_sh = U32(hm.shoup(n_inv, q))
        self._device_cache: Dict[tuple, torch.Tensor] = {}

    def device_row(self, name: str, device: torch.device,
                   dtype: torch.dtype = torch.int64) -> torch.Tensor:
        """Table `name` as the one limb of a context's rows ([1, n] for a
        twiddle table, [1, 1] for a constant, [n / sub_n, sub_n] for a
        sub_table) on `device`, in the dtypes of Context.device_rows.
        Cached on the tables."""
        device = torch.device(device)
        key = (name, str(device), dtype)
        t = self._device_cache.get(key)
        if t is None:
            host = _host_rows(lambda nm: np.asarray(getattr(self, nm), dtype=U32).reshape(1, -1),
                              name)
            t = _device_copy(host, device, dtype)
            self._device_cache[key] = t
        return t


class TableRows:
    """The tables of L rows that are not a context's limbs, e.g. the parts of
    longer rows that parallel/ntt_sharded.py gives each rank: host uint32
    arrays by name ([L, n] twiddle tables, [L, 1] constants), served as
    Context.device_rows serves a context's (sub_table names regrouped),
    cached. `device_rows` takes the (name, device, dtype) of the rows
    providers of ops/ntt.py."""

    def __init__(self, **host: np.ndarray):
        self.host = {nm: np.ascontiguousarray(a, dtype=U32) for nm, a in host.items()}
        self._device_cache: Dict[tuple, torch.Tensor] = {}

    def device_rows(self, name: str, device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
        device = torch.device(device)
        key = (name, str(device), dtype)
        t = self._device_cache.get(key)
        if t is None:
            t = _device_copy(_host_rows(self.host.__getitem__, name), device, dtype)
            self._device_cache[key] = t
        return t


class Context:
    """Immutable table bundle for a parameter set, hashed by identity.

    Host tables are read-only numpy uint32 ([M, 1] per-limb columns,
    [M, n] twiddle tables); `device_rows` hands out cached device copies."""

    def __init__(self, params: RlweParams):
        self.params = params
        n = params.dimension
        mods = list(params.moduli) + list(params.special_mods)
        self.mod_list: Tuple[int, ...] = tuple(mods)
        n_sp = len(params.special_mods)
        self.special_indices: Tuple[int, ...] = tuple(
            range(len(params.moduli), len(mods))
        )
        self.num_special = n_sp
        tabs = [ModulusTables(q, n) for q in mods]

        def col(attr):  # [M, 1] for broadcasting against [..., M, n]
            return np.asarray([getattr(t, attr) for t in tabs], dtype=U32)[:, None]

        self.q = col("q")
        self.two_q = col("two_q")
        self.neg_qinv = col("neg_qinv")
        self.r_mod_q = col("r_mod_q")
        self.r_shoup = col("r_shoup")
        self.r2_mod_q = col("r2_mod_q")
        self.n_inv = col("n_inv")
        self.n_inv_sh = col("n_inv_sh")
        self.tw_inv_last = col("tw_inv_last")
        self.tw_inv_last_sh = col("tw_inv_last_sh")
        self.tw_fwd = np.stack([t.tw_fwd for t in tabs])  # [M, n]
        self.tw_fwd_sh = np.stack([t.tw_fwd_sh for t in tabs])
        self.tw_inv = np.stack([t.tw_inv for t in tabs])
        self.tw_inv_sh = np.stack([t.tw_inv_sh for t in tabs])
        for a in vars(self).values():
            if isinstance(a, np.ndarray):
                a.setflags(write=False)
        self._device_cache: Dict[tuple, torch.Tensor] = {}

        # BGV: per-factor tables of the plaintext modulus t. A factor gets
        # NTT tables when it is a prime ≡ 1 mod 2n below 2^29 (the kernels'
        # lanes); larger NTT-friendly primes use the host u64 NTT
        # (hostmath.ntt_host_u64); other factors have no SIMD packing.
        self.plain_fact_tables: Optional[list] = None
        if isinstance(params, BgvParams):
            ftabs = []
            for f in params.plain_factors:
                (p, e), = hm.factorize(f)
                ok = e == 1 and p % (2 * n) == 1 and p < (1 << 29)
                ftabs.append(ModulusTables(p, n) if ok else None)
            self.plain_fact_tables = ftabs

    def rows(self, name: str, limb_ids: Tuple[int, ...]) -> np.ndarray:
        """Host rows of table `name` for `limb_ids` (of a sub_table: its
        [len(limb_ids) n / sub_n, sub_n] rows, sub_row_tables)."""
        return _host_rows(lambda nm: getattr(self, nm)[np.asarray(limb_ids, dtype=np.int64)],
                          name)

    def device_rows(
        self,
        name: str,
        limb_ids: Tuple[int, ...],
        device: torch.device,
        dtype: torch.dtype = torch.int64,
    ) -> torch.Tensor:
        """Rows of table `name` for `limb_ids` as a contiguous tensor on
        `device` (int64 holds the uint32 values; int32 holds their bits, as
        the kernels read them). Cached on the context."""
        device = torch.device(device)
        key = (name, tuple(limb_ids), str(device), dtype)
        t = self._device_cache.get(key)
        if t is None:
            t = _device_copy(self.rows(name, limb_ids), device, dtype)
            self._device_cache[key] = t
        return t

    def moduli_of(self, limb_ids: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(self.mod_list[i] for i in limb_ids)

    def __hash__(self):
        return id(self)

    def __eq__(self, other):
        return self is other


@functools.lru_cache(maxsize=None)
def make_context(params: RlweParams) -> Context:
    return Context(params)
