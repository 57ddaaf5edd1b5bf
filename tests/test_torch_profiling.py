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


def test_kernel_time_fault_is_a_profiler_fault(monkeypatch):
    """A trace that keeps losing records raises ProfilerFault, the one error
    that a caller may record as a missing time."""
    monkeypatch.setattr(profiling, "_kernel_spans", lambda fn, ours, warmup, iters:
                        _trace([("ours", 40.0)], drop=range(6)))
    with pytest.raises(profiling.ProfilerFault, match="4 launches of ours"):
        profiling.kernel_time(lambda: None, ours=True, iters=ITERS)


@pytest.mark.parametrize("key", ["kernel_ms", "library_kernel_ms"])
def test_chip_smoke_records_a_lost_kernel_time_as_null(monkeypatch, key):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "kernel_time", lambda call, ours: 2.5e-5)
    assert chip_smoke.kernel_only(None, True, key) == {key: pytest.approx(0.025)}

    def lost(call, ours):
        raise profiling.ProfilerFault("4 launches of k traced for 10 calls in each of 3 traces")

    monkeypatch.setattr(chip_smoke, "kernel_time", lost)
    fault = key.replace("_ms", "_profiler_fault")
    assert chip_smoke.kernel_only(None, True, key) == {
        key: None, fault: "4 launches of k traced for 10 calls in each of 3 traces"}
    assert chip_smoke.ratio(None, 1.0) is None


def test_chip_smoke_lets_other_kernel_time_errors_through(monkeypatch):
    """Only a lost trace becomes a null time; any other error stops the run."""
    import chip_smoke

    def broken(call, ours):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(chip_smoke, "kernel_time", broken)
    with pytest.raises(RuntimeError, match="launch failed"):
        chip_smoke.kernel_only(None)


def _event(name, device, start, end):
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    return SimpleNamespace(name=name, device_type=getattr(DeviceType, device),
                           time_range=SimpleNamespace(start=start, end=end))


def test_window_spans_keep_the_device_work_of_the_window_only():
    """Lead-in kernels before the window are left out, and so is the
    window's own annotation on the device, which spans its kernels."""
    w = profiling._WINDOW
    events = [
        _event("lead_in_add", "CUDA", 5.0, 6.0),
        _event(w, "CPU", 100.0, 200.0),
        _event(w, "CUDA", 110.0, 190.0),
        _event("void (anonymous namespace)::k", "CUDA", 120.0, 130.0),
        _event("Memcpy DtoH", "CUDA", 140.0, 150.0),
        _event("cudaLaunchKernel", "CPU", 115.0, 116.0),
    ]
    assert profiling._window_spans(events) == [
        (120.0, 130.0, "void (anonymous namespace)::k"), (140.0, 150.0, "Memcpy DtoH")]


@pytest.mark.parametrize("windows", [0, 2])
def test_window_spans_refuse_a_trace_without_one_window(windows):
    """A trace without exactly one host-side window is a fault of the
    instrument, not lost records: it raises RuntimeError, not
    ProfilerFault."""
    events = [_event(profiling._WINDOW, "CPU", 100.0 * i, 100.0 * i + 50) for i in range(windows)]
    with pytest.raises(RuntimeError, match=f"{windows} host-side windows") as err:
        profiling._window_spans(events)
    assert not isinstance(err.value, profiling.ProfilerFault)


def test_raw_events_match_the_profilers_function_events():
    """The trace's activities read from the raw results carry the names,
    device types and durations of torch.profiler's own FunctionEvents."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.zeros(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(profiling._WINDOW):
            for _ in range(20):
                x.add_(1)
    raw = profiling._raw_events(prof)
    events = prof.events()
    for name in (profiling._WINDOW, "aten::add_"):
        got = sorted(e.time_range.end - e.time_range.start for e in raw if e.name == name)
        want = sorted(e.time_range.end - e.time_range.start for e in events if e.name == name)
        assert len(got) == len(want) > 0
        assert got == pytest.approx(want, abs=1e-3)
        assert {e.device_type for e in raw if e.name == name} == {
            e.device_type for e in events if e.name == name}
    assert min(e.time_range.start for e in raw) == 0.0
