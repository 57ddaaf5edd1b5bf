"""hehub_tpu_torch.core.context against hehub_tpu.core.context: the primes
of create_ckks_params and every Context table, bitwise; the device-table
cache; and the rule that the port never imports JAX."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from hehub_tpu_torch.core import context as tctx
from tests.torch_support import Reference

jctx = Reference("hehub_tpu.core.context")

TABLES = ("q", "two_q", "neg_qinv", "r_mod_q", "r_shoup", "r2_mod_q", "n_inv", "n_inv_sh",
          "tw_inv_last", "tw_inv_last_sh", "tw_fwd", "tw_fwd_sh", "tw_inv", "tw_inv_sh")


@pytest.mark.parametrize("n,levels", [(1024, 3), (4096, None)])
def test_params_and_tables_bitwise(n, levels):
    jp = jctx.create_ckks_params(n, 28, levels, use_security_budget=levels is None)
    tp = tctx.create_ckks_params(n, 28, levels, use_security_budget=levels is None)
    assert (tp.moduli, tp.special_mods) == (jp.moduli, jp.special_mods)
    assert tp.initial_scaling_factor == jp.initial_scaling_factor
    jc, tc = jctx.make_context(jp), tctx.make_context(tp)
    assert tc.mod_list == jc.mod_list and tc.special_indices == jc.special_indices
    for name in TABLES:
        want, got = getattr(jc, name), getattr(tc, name)
        assert got.dtype == want.dtype == np.uint32, name
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_secure_main_path_params_match():
    """The main path's n=16384, 7+1 limbs: same primes, within budget."""
    jp = jctx.create_ckks_params(16384, scaling_bits=28, num_levels=7)
    tp = tctx.create_ckks_params(16384, scaling_bits=28, num_levels=7)
    assert (tp.moduli, tp.special_mods) == (jp.moduli, jp.special_mods)
    assert all((1 << 29) <= q < (1 << 30) for q in tp.moduli + tp.special_mods)


@pytest.mark.parametrize("bad", [dict(scaling_bits=56), dict(num_levels=30)])
def test_param_checks_raise(bad):
    with pytest.raises(ValueError):
        tctx.create_ckks_params(1024, **{"scaling_bits": 28, **bad})


def test_device_rows_cached_and_typed():
    ctx = tctx.make_context(tctx.create_ckks_params(1024, 28, 2, use_security_budget=False))
    ids = (2, 0)
    t64 = ctx.device_rows("tw_fwd", ids, "cpu")
    assert t64.dtype == torch.int64 and tuple(t64.shape) == (2, 1024)
    np.testing.assert_array_equal(t64.numpy(), ctx.tw_fwd[[2, 0]].astype(np.int64))
    assert ctx.device_rows("tw_fwd", ids, "cpu") is t64
    t32 = ctx.device_rows("q", ids, "cpu", torch.int32)
    np.testing.assert_array_equal(t32.numpy().view(np.uint32), ctx.q[[2, 0]])


def test_port_imports_no_jax():
    code = (
        "import sys; from hehub_tpu_torch import make_context; "
        "import hehub_tpu_torch.models.ckks, hehub_tpu_torch.kernels, "
        "hehub_tpu_torch.convert, hehub_tpu_torch.rlwe.keys, hehub_tpu_torch.config, "
        "hehub_tpu_torch.ops.fft, hehub_tpu_torch.core.basecnv, "
        "hehub_tpu_torch.utils.profiling, hehub_tpu_torch.parallel.mesh, "
        "hehub_tpu_torch.parallel.ntt_sharded, hehub_tpu_torch.parallel.pipeline, "
        "hehub_tpu_torch.entry, chip_smoke; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'hehub_tpu.'))]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=pathlib.Path(__file__).resolve().parents[1])
