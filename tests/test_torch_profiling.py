"""The kernel-only estimator of hehub_tpu_torch.utils.profiling, on traces
given by hand (the trace itself needs the card)."""

import pytest

from hehub_tpu_torch.utils import profiling

ITERS = 10


def _trace(per_call, drop=()):
    """(name, µs) of ITERS calls, each launching the kernels of `per_call`
    [(name, µs)] in order, without the records at the indices in `drop`."""
    spans = [span for _ in range(ITERS) for span in per_call]
    return [s for i, s in enumerate(spans) if i not in drop]


@pytest.mark.parametrize("per_call, drop", [
    ([("ours", 40.0)], ()),
    ([("ours", 40.0)], (3,)),
    ([("fft_a", 5.0), ("fft_b", 7.0), ("fft_a", 5.0)], ()),
    ([("fft_a", 5.0), ("fft_b", 7.0), ("fft_a", 5.0)], (0, 4)),
])
def test_kernel_time_is_per_call_despite_dropped_records(monkeypatch, per_call, drop):
    monkeypatch.setattr(profiling, "_kernel_spans", lambda fn, ours, warmup, iters:
                        _trace(per_call, drop))
    want = sum(us for _, us in per_call) / 1e6
    assert profiling.kernel_time(lambda: None, ours=True, iters=ITERS) == pytest.approx(want)


def test_kernel_time_refuses_more_launches_than_calls(monkeypatch):
    monkeypatch.setattr(profiling, "_kernel_spans", lambda fn, ours, warmup, iters:
                        _trace([("ours", 40.0)]) + [("ours", 40.0)])
    with pytest.raises(RuntimeError, match="11 launches"):
        profiling.kernel_time(lambda: None, ours=True, iters=ITERS)


def test_kernel_time_retraces_a_trace_that_lost_most_records(monkeypatch):
    """A trace holding 4 of 10 launches (the profiler lost the rest) is taken
    again; the next, whole one gives the time."""
    traces = iter([_trace([("ours", 40.0)], drop=range(6)), _trace([("ours", 30.0)])])
    monkeypatch.setattr(profiling, "_kernel_spans", lambda fn, ours, warmup, iters: next(traces))
    assert profiling.kernel_time(lambda: None, ours=True, iters=ITERS) == pytest.approx(30e-6)
