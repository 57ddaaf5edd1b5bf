"""The host set-up of the factored bootstrap transforms at the sizes where
the port leaves hehub_tpu's route: the sparse route of the chain matrices
(circuits/bootstrap.py, used from SPARSE_CHAIN_MIN_N) against the dense
products within 1e-12 relative Frobenius error at n=2048 and 4096, and the
one-pass scan of nonzero diagonals against the per-diagonal scan it
replaced, with the rotation steps it gives equal to hehub_tpu's. JAX is
imported inside the tests."""

import numpy as np
import pytest

from hehub_tpu_torch.circuits import bootstrap as bs

LT_STAGES = 3


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
            assert s.shape == d.shape and s.dtype == d.dtype
            assert np.linalg.norm(s - d) <= 1e-12 * np.linalg.norm(d)
            np.testing.assert_array_equal(bs._nonzero_diagonals(s), bs._nonzero_diagonals(d))


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
