"""The frozen work counts against hand-worked numbers."""

import math

from hebench import bounds

INT32 = 132 * 64 * 1.98e9  # 1.672704e13


def test_one_k1_row_at_n16384():
    # 14 stages of 8192 butterflies, 11 operations each; 2 x 16384 residues
    ops = 14 * 8192 * 11
    assert bounds.ntt_ops(1, 16384) == ops == 1_261_568
    assert math.isclose(bounds.ntt_launch_s(1, 16384), max(ops / INT32, 131072 / 3.35e12))
    # the inverse: 13 stages of 9 and the last (n^-1 folded) of 11
    assert bounds.ntt_ops(1, 16384, inverse=True) == (13 * 9 + 11) * 8192


def test_one_k4_launch_std128_top():
    # R=64 ciphertexts, D=6 digits, L_ext=14 limbs, n=16384
    ops = 5376 * 1_261_568 + 64 * 6 * 14 * 16384 * 2 * 10
    assert ops == 8_543_797_248
    nbytes = (5376 + 168 + 1792) * 16384 * 4
    assert math.isclose(bounds.ext_prod_launch_s(64, 6, 14, 16384),
                        max(ops / INT32, nbytes / 3.35e12))
    assert math.isclose(bounds.ext_prod_launch_s(64, 6, 14, 16384) * 1e3, 0.51078, rel_tol=1e-4)


def test_one_key_switch_at_each_top_level():
    # n=16384, 12 chain limbs, 2 special, alpha=2: INTT 12 rows; 6 groups of
    # 2 limbs (conversion 2 x 7 + 2 x 12 x 10 a coefficient, NTT 12 rows);
    # inner product 2 x 6 x 14 MACs; ModDown twice (INTT 2 rows,
    # conversion 2 x 7 + 2 x 12 x 10, NTT 12 rows, 12 x (3 + 7))
    fwd, inv = 1_261_568, 1_048_576
    std = (12 * inv + 6 * (16384 * 254 + 12 * fwd) + 16384 * 2 * 6 * 14 * 10
           + 2 * (2 * inv + 16384 * 254 + 12 * fwd + 16384 * 12 * 10))
    assert std == 202_637_312 == bounds.key_switch_ops(16384, 12, 2, 2)
    # n=65536, 54 + 4 limbs, alpha=4: 13 groups of 4 and one of 2
    fwd, inv = 32768 * 16 * 11, 32768 * (15 * 9 + 11)
    deep = (54 * inv + 13 * (65536 * (4 * 7 + 4 * 54 * 10) + 54 * fwd)
            + (65536 * (2 * 7 + 2 * 56 * 10) + 56 * fwd) + 65536 * 2 * 14 * 58 * 10
            + 2 * (4 * inv + 65536 * (4 * 7 + 4 * 54 * 10) + 54 * fwd + 65536 * 54 * 10))
    assert deep == 8_651_276_288 == bounds.key_switch_ops(65536, 54, 4, 4)


def test_op_least_time_is_bound_by_operations_at_the_top():
    t = bounds.op_least_s("mult", 16384, 12, 2, 2, 64)
    ops_s = 64 * (bounds.key_switch_ops(16384, 12, 2, 2) + bounds.rescale_ops(16384, 12)
                  + 12 * 16384 * (4 * 7 + 3 * 3)) / INT32
    assert math.isclose(t, ops_s)


def test_fft_launch_is_bound_by_bytes():
    m = 32768
    nbytes = (4 * 8 * m + 2 * m) * 8
    assert math.isclose(bounds.fft_launch_s(8, m), nbytes / 3.35e12)
