"""The host set-up of the factored bootstrap transforms at the sizes where
the port leaves hehub_tpu's route: the chains built in the diagonal domain
(circuits/bootstrap.py's Diagonals, used from SPARSE_CHAIN_MIN_N) against
the dense products within 1e-12 relative Frobenius error at n=2048 and
4096, and against the dense groups multiplied out one butterfly at a time
as row combinations (the route n=8192 and 16384 took before) at n=8192;
the rotation steps they give, the same as before at n <= 16384 and 68 at
n=65536 with four stages, planned without an s x s array; and the one-pass
scan of nonzero diagonals against the per-diagonal scan it replaced, with
the rotation steps it gives equal to hehub_tpu's. JAX is imported inside
the tests."""

import tracemalloc

import numpy as np
import pytest

from hehub_tpu_torch.circuits import bootstrap as bs

LT_STAGES = 3


def _dense(D):
    """The [s, s] array of a Diagonals."""
    M = np.zeros(D.shape, dtype=np.complex128)
    idx = np.arange(D.s)
    for k, v in D.vecs.items():
        M[idx, (idx + k) % D.s] = v
    return M


def _row_combination_group(roots, first, stop):
    """M_stop ⋯ M_(first+1) as a dense array, from the identity one
    butterfly stage at a time as row combinations: (M_t X)[lo] = X[lo] +
    r[lo]·X[hi], (M_t X)[hi] = X[lo] + r[hi]·X[hi]."""
    s = roots[0].size
    G = np.eye(s, dtype=np.complex128)
    for t in range(first, stop):
        h = 1 << t
        X = G.reshape(s // (2 * h), 2, h, s)
        r = roots[t].reshape(s // (2 * h), 2, h, 1)
        out = np.empty_like(X)
        for half in (0, 1):
            np.multiply(r[:, half], X[:, 1], out=out[:, half])
            out[:, half] += X[:, 0]
        G = out.reshape(s, s)
    return G


def _diagonal_scan(M):
    """The per-k gather the plans and the step discovery used to make."""
    s = M.shape[0]
    idx = np.arange(s)
    return np.asarray([k for k in range(s) if np.any(M[idx, (idx + k) % s])], np.int64)


@pytest.mark.parametrize("n", [2048, 4096])
def test_sparse_chains_match_dense(n):
    assert n < bs.SPARSE_CHAIN_MIN_N  # the dense route is the one hehub_tpu takes here
    dense = bs._merged_chain_matrices(n, LT_STAGES)
    sparse = bs._chain_matrices(n, LT_STAGES, sparse=True)
    for chain_d, chain_s in zip(dense, sparse):
        assert len(chain_d) == len(chain_s) == LT_STAGES
        for d, s in zip(chain_d, chain_s):
            assert isinstance(s, bs.Diagonals) and s.shape == d.shape
            assert np.linalg.norm(_dense(s) - d) <= 1e-12 * np.linalg.norm(d)
            assert abs(s.norm() - np.linalg.norm(d)) <= 1e-12 * np.linalg.norm(d)
            np.testing.assert_array_equal(bs._nonzero_diagonals(s), bs._nonzero_diagonals(d))


def test_diagonal_chains_match_row_combinations_at_8192():
    """At n=8192 (four groups of three butterflies) the diagonal-domain
    chains against the route that built the dense groups by row
    combinations, one matrix at a time; the rotation steps from both."""
    n, k = 8192, 4
    roots, _, e = bs._butterfly_roots(n)
    d = len(roots)
    bounds = [round(j * d / k) for j in range(k + 1)]
    groups = [_row_combination_group(roots, bounds[j], bounds[j + 1]) for j in range(k)]
    D = np.exp(1j * np.pi * e / 2)
    gains = [np.linalg.norm(G) / np.sqrt(n / 2) for G in groups[::-1]]
    kappa = (np.prod(gains) / n) ** (1.0 / k)
    folds = [kappa / g for g in gains]
    want = (  # each chain's matrices, made when compared
        [lambda i=i: groups[k - 1 - i].conj().T * folds[i] for i in range(k)],
        [lambda i=i: (groups[k - 1 - i].conj().T * (np.conj(D)[None, :] if i == 0 else 1))
         * folds[i] for i in range(k)],
        [lambda j=j: groups[j] for j in range(k)],
        [lambda j=j: groups[j] * (D[:, None] if j == k - 1 else 1) for j in range(k)],
    )
    steps = set()
    for chain, makers in zip(bs._merged_chain_matrices(n, k), want):
        for M, make in zip(chain, makers):
            W = make()
            assert np.linalg.norm(_dense(M) - W) <= 1e-12 * np.linalg.norm(W)
            np.testing.assert_array_equal(bs._nonzero_diagonals(M), bs._nonzero_diagonals(W))
            steps |= bs._matrix_bsgs_steps(M)  # the same diagonals as W's
    params = bs.make_boot_params(n, 4, num_special=1)
    assert bs.bootstrap_rotation_steps(params, k) == sorted(steps)


@pytest.mark.parametrize("n, lt_stages, count", [(16384, 3, 62), (65536, 4, 68)])
def test_rotation_steps_planned_without_dense_matrices(n, lt_stages, count):
    """The flagship's 62 rotation keys at n=16384, and 68 at n=65536 in four
    stages (plans of 16/15/31/31 diagonals for CoeffToSlot), built in the
    diagonal domain: the host memory this takes stays far below one s x s
    array (17.2 GB at n=65536)."""
    bs._merged_chain_matrices.cache_clear()
    tracemalloc.start()
    try:
        params = bs.make_boot_params(n, 4, num_special=1)
        steps = bs.bootstrap_rotation_steps(params, lt_stages)
        chains = bs._merged_chain_matrices(n, lt_stages)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
        bs._merged_chain_matrices.cache_clear()
    assert len(steps) == count
    s = n // 2
    assert peak < 2e9 and peak < s * s * 16 / 8
    for chain in chains:
        assert len(chain) == lt_stages
        for M in chain:
            assert isinstance(M, bs.Diagonals) and len(M.vecs) <= 2 ** (d_max(n, lt_stages) + 1)
    if n == 65536:
        assert [len(M.vecs) for M in chains[0]] == [16, 15, 31, 31]


def d_max(n, lt_stages):
    """The most butterflies one group of the chain merges."""
    d = (n // 2).bit_length() - 1
    return max(round((j + 1) * d / lt_stages) - round(j * d / lt_stages)
               for j in range(lt_stages))


@pytest.mark.parametrize("n", [256, 2048])
def test_nonzero_diagonals_and_steps(n):
    from hehub_tpu.circuits import bootstrap as jbs

    for chain in bs._merged_chain_matrices(n, LT_STAGES):
        for M in chain:
            want = _diagonal_scan(M)
            np.testing.assert_array_equal(bs._nonzero_diagonals(M), want)
            np.testing.assert_array_equal(bs._nonzero_diagonals(np.ascontiguousarray(M)), want)
            np.testing.assert_array_equal(bs._nonzero_diagonals(np.asfortranarray(M)), want)
    params = bs.make_boot_params(n, 28, num_special=3)
    from hehub_tpu.circuits.bootstrap import make_boot_params as j_make_boot_params

    assert bs.bootstrap_rotation_steps(params, LT_STAGES) == jbs.bootstrap_rotation_steps(
        j_make_boot_params(n, 28, num_special=3), LT_STAGES)
