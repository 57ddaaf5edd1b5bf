"""The roofline accounting of hehub_tpu_torch.utils.profiling against
hehub_tpu's (same fields, properties and report strings), and the card-only
helpers time_op, trace and op_counters: they refuse to run without a card
and, on the card, write a trace and read the allocator's statistics. JAX is
imported inside the tests that compare with it, since the card's machine
has none."""

import json
import os

import pytest
import torch

from hehub_tpu_torch.utils import profiling
from tests.torch_support import cuda_device  # noqa: F401

CASES = [
    (1e-4, 16384, 448),
    (5.54e-5, 16384, 448),
    (3e-5, 1024, 7),
    (2.5e-6, 8, 1),
    (1.25e-3, 262144, 8),
]


def _same_roofline(got, want):
    assert (got.seconds, got.bytes_moved, got.int_ops) == (want.seconds, want.bytes_moved,
                                                           want.int_ops)
    for prop in ("gbytes_per_s", "gops_per_s", "arithmetic_intensity"):
        assert getattr(got, prop) == getattr(want, prop), prop
    for hbm in (None, 3350, 819.0):
        assert got.report("op", hbm) == want.report("op", hbm)


@pytest.mark.parametrize("seconds, n, transforms", CASES)
def test_rooflines_match_jax(seconds, n, transforms):
    from hehub_tpu.utils import profiling as jprof

    assert (profiling._OPS_PER_BUTTERFLY, profiling._OPS_PER_MULMOD) == (
        jprof._OPS_PER_BUTTERFLY, jprof._OPS_PER_MULMOD)
    _same_roofline(profiling.ntt_roofline(seconds, n, transforms),
                   jprof.ntt_roofline(seconds, n, transforms))
    _same_roofline(profiling.modmul_roofline(seconds, transforms * n),
                   jprof.modmul_roofline(seconds, transforms * n))
    _same_roofline(profiling.Roofline(seconds, 12 * n, 20 * n),
                   jprof.Roofline(seconds, 12 * n, 20 * n))


@pytest.mark.parametrize("call", [
    lambda: profiling.time_op(lambda x: x, (1,)),
    lambda: profiling.trace("unused").__enter__(),
    profiling.op_counters,
])
def test_card_helpers_refuse_without_cuda(call):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for hosts without one")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        call()


@pytest.mark.cuda
def test_trace_and_op_counters_on_card(cuda_device, tmp_path):  # noqa: F811
    x = torch.ones(1 << 20, device=cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    with profiling.trace(str(tmp_path / "logs")) as path:
        y = (x * 2).sum()
    assert float(y) == 2.0 * (1 << 20)
    assert os.path.isfile(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    stats = profiling.op_counters()
    assert stats["allocated_bytes.all.peak"] >= x.numel() * 4
    assert profiling.time_op(lambda a: a * 2, (x,), 1, 3) > 0
