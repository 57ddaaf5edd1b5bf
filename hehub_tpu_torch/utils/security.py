"""(R)LWE security estimation anchored to published lattice-estimator
results (port of hehub_tpu/utils/security.py; pure math).

Anchor data: the HomomorphicEncryption.org Security Standard v1.1
(Albrecht et al., 2018), Table 1 — maximum log2 q for ternary-secret LWE at
dimension n and security level λ ∈ {128, 192, 256} under the CLASSICAL
cost model, error σ = 3.2 (8/√(2π)). Those numbers are themselves
lattice-estimator (Albrecht–Player–Scott) outputs. Cross-check anchor:
TFHE-rs's published gaussian gate set (n = 742, log2(q/σ) = 64 − 46.1 =
17.9) targets 2^-128.

Model: at fixed n, λ is almost exactly LINEAR in ρ = n / log2(q/σ), so λ
is interpolated piecewise-linearly in ρ between the three standard columns
and extrapolated on the end segments; the per-column anchor ρ_λ(n)
interpolates linearly in log2 n between table rows. Exact at the anchors
by construction and within a few bits between them.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

# HomomorphicEncryption.org Security Standard v1.1, Table 1 (ternary
# secret, classical cost model): n -> (log2 q at λ=128, 192, 256).
HESTD_TERNARY_CLASSICAL: Dict[int, Tuple[int, int, int]] = {
    1024: (27, 19, 14),
    2048: (54, 37, 29),
    4096: (109, 75, 58),
    8192: (218, 152, 118),
    16384: (438, 305, 237),
    32768: (881, 611, 476),
}
_LAMBDAS = (128.0, 192.0, 256.0)
_SIGMA_STD = 3.2  # the standard table's error width


def _rho_anchors(n: int) -> Tuple[float, float, float]:
    """ρ_λ(n) = n / log2(q_max(λ, n)/3.2) for the three standard columns,
    interpolated (and end-extrapolated) linearly in log2 n."""
    rows = sorted(HESTD_TERNARY_CLASSICAL)
    ln = math.log2(n)

    def rho(nn: int, col: int) -> float:
        logq = HESTD_TERNARY_CLASSICAL[nn][col]
        return nn / (logq - math.log2(_SIGMA_STD))

    if n <= rows[0]:
        lo, hi = rows[0], rows[1]
    elif n >= rows[-1]:
        lo, hi = rows[-2], rows[-1]
    else:
        lo = max(r for r in rows if r <= n)
        hi = min(r for r in rows if r > n)
    f = (ln - math.log2(lo)) / (math.log2(hi) - math.log2(lo))
    return tuple(
        rho(lo, c) + f * (rho(hi, c) - rho(lo, c)) for c in range(3)
    )


def ternary_lwe_security_bits(n: int, q: float, sigma: float) -> float:
    """Estimated classical security (bits) of ternary/binary-secret (R)LWE
    with dimension n, modulus q, discrete-gaussian error width sigma.

    Piecewise-linear in ρ = n/log2(q/σ) through the HEstd v1.1 anchors
    (module docstring). Binary secrets are ≤ a few bits weaker than
    ternary at these sizes; treat results as ±5 bits and re-run the
    lattice estimator before standardizing new production parameters."""
    l = math.log2(q / sigma)
    if l <= 0:
        return float("inf")  # noise swamps the modulus: trivially hiding
    rho = n / l
    r128, r192, r256 = _rho_anchors(n)
    if rho <= r192:
        slope = (192.0 - 128.0) / (r192 - r128)
        return max(128.0 + (rho - r128) * slope, 1.0)
    slope = (256.0 - 192.0) / (r256 - r192)
    return 192.0 + (rho - r192) * slope


def rlwe_budget_security_bits(dimension: int, total_log_qp: float) -> float:
    """Security of an RNS RLWE chain: dimension n, total log2(Q·P) bits,
    σ = 3.2 (the CKKS/BGV keygen error, core/sampling.py). The key-switch
    special primes COUNT toward the attack modulus — hence budgets are on
    log(Q·P), matching STD_LOGQP_BUDGET (core/context.py)."""
    return ternary_lwe_security_bits(
        dimension, 2.0**total_log_qp, _SIGMA_STD
    )
