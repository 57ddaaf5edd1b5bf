"""Interval union, idle gaps and their attribution on hand-made spans."""

import math

from hebench import trace


def _traced():
    spans = [(0.0, 10.0, "void (anonymous namespace)::ntt_fwd_kernel<14, 3>(NttArgs)"),
             (5.0, 15.0, "void at::native::vectorized_elementwise_kernel<4>(int)"),
             (20.0, 30.0, "Memcpy HtoD (Pageable -> Device)")]
    host = [(0.0, 3.0, "aten::mul"), (14.0, 22.0, "aten::add"), (25.0, 45.0, "cudaStreamSynchronize")]
    return trace.Traced(40e-6, spans, host, 0.0, 40.0)


def test_union_and_gaps():
    t = _traced()
    assert trace.union_us(t.spans) == 25.0
    assert math.isclose(t.busy_s, 25e-6)
    assert trace.idle_gaps(t.spans, 0.0, 40.0) == [(15.0, 20.0), (30.0, 40.0)]
    assert math.isclose(1 - t.busy_s / t.wall_s, 15 / 40)


def test_classes_and_breakdown():
    t = _traced()
    assert [trace.activity_class(s[2]) for s in t.spans] == ["K1", "pytorch kernels", "copies"]
    b = t.breakdown()
    assert b["device_ops"][0] == ["ntt_fwd_kernel", 10e-6]
    # the gap at 15 us opens while aten::add runs, the one at 30 while the sync does
    assert sorted(b["idle_gaps"]) == [["aten::add", 5e-6], ["cudaStreamSynchronize", 10e-6]]
