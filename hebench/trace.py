"""A traced window on the card, summarised in memory.

The arithmetic is that of the program's `utils/profiling.device_trace`,
copied here so that the yardstick stays fixed: torch.profiler traces the
window after a lead-in of small launches (the profiler loses the first
records of a trace), the device activities that began inside the window's
host-side marker are kept, busy is the union of their intervals, idle the
rest of the window's wall time. No Chrome trace is written.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Callable, Dict, List, Tuple

import torch

LEAD_IN_LAUNCHES = 200
WINDOW = "hebench.window"
OURS = "(anonymous namespace)::"
# the program's kernels by their CUDA function names (csrc/*.cu)
KERNEL_NAMES = {
    "ntt_fwd_kernel": "K1", "ntt_inv_kernel": "K2", "ntt_small_kernel": "K1/K2 small",
    "ntt_stage_kernel": "S", "ext_prod_kernel": "K3/K4", "ext_prod_small_kernel": "K3/K4 small",
    "fft_row_kernel": "K5", "fft_small_kernel": "K5 small", "fft_stage_kernel": "F",
}
GAP_MIN_US = 5.0  # idle gaps shorter than this are not attributed


def short_name(name: str) -> str:
    """A device activity's name without its template and argument lists."""
    return name.removeprefix("void ").replace(OURS, "").split("(")[0].split("<")[0]


def activity_class(name: str) -> str:
    """'copies', one of the program's kernels (K1 ... F), or 'pytorch kernels'."""
    if name.startswith(("Memcpy", "Memset")):
        return "copies"
    if name.removeprefix("void ").startswith(OURS):
        return KERNEL_NAMES.get(short_name(name), short_name(name))
    return "pytorch kernels"


def union_us(spans: List[Tuple[float, float, str]]) -> float:
    """Length of the union of the [start, stop) intervals, spans sorted by start."""
    busy, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy


def idle_gaps(spans: List[Tuple[float, float, str]], lo: float, hi: float):
    """(start, stop) of the intervals of [lo, hi] that no span covers."""
    gaps, end = [], lo
    for start, stop, _ in spans:
        if start > end:
            gaps.append((end, start))
        end = max(end, stop)
    if hi > end:
        gaps.append((end, hi))
    return gaps


def _raw(prof):
    """(name, on_device, start µs, stop µs) of every activity of a finished
    trace, read from the profiler's raw results (building its
    FunctionEvents takes tens of seconds for a long window)."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    t0 = min((e.start_ns() for e in raw), default=0)
    return [(e.name(), e.device_type() == DeviceType.CUDA, (e.start_ns() - t0) / 1e3,
             (e.start_ns() + e.duration_ns() - t0) / 1e3) for e in raw]


class Traced:
    """The device activities of one window: `spans` (start µs, stop µs,
    name) sorted by start, `wall_s` (host clock, ending in a device sync),
    `host` (start µs, stop µs, name) of the host-side ranges inside it."""

    def __init__(self, wall_s: float, spans, host, lo: float, hi: float):
        self.wall_s, self.spans, self.host, self.lo, self.hi = wall_s, spans, host, lo, hi

    @property
    def busy_s(self) -> float:
        return union_us(self.spans) / 1e6

    def seconds_by(self, key: Callable[[str], str]) -> Dict[str, float]:
        out: Dict[str, float] = collections.defaultdict(float)
        for start, stop, name in self.spans:
            out[key(name)] += (stop - start) / 1e6
        return dict(out)

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle gaps by
        the innermost host range that was open when each began."""
        ops = sorted(self.seconds_by(short_name).items(), key=lambda kv: -kv[1])[:top]
        starts = [h[0] for h in self.host]
        by_host: Dict[str, float] = collections.defaultdict(float)
        for g0, g1 in idle_gaps(self.spans, self.lo, self.hi):
            if g1 - g0 < GAP_MIN_US:
                continue
            label = "no host range"
            i = bisect.bisect_right(starts, g0)
            for h0, h1, name in reversed(self.host[max(0, i - 64):i]):
                if h1 >= g0:
                    label = name
                    break
            by_host[label] += (g1 - g0) / 1e6
        gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}


def traced_window(fn: Callable[[], object], on_card: bool = True) -> Traced:
    """Trace `fn()` (which ends in a device sync) after the lead-in. Off
    the card (a rehearsal on the CPU) only the host is traced, and the
    window holds no device activity."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync():
        if on_card:
            torch.cuda.synchronize()

    scratch = torch.zeros(1, device="cuda" if on_card else "cpu")
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        for _ in range(LEAD_IN_LAUNCHES):
            scratch.add_(1)
        sync()
        with record_function(WINDOW):
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
    events = _raw(prof)
    marks = [(s, e) for name, dev, s, e in events if name == WINDOW and not dev]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} host-side windows, not 1")
    lo, hi = marks[0]
    spans = sorted((s, e, name) for name, dev, s, e in events
                   if dev and name != WINDOW and lo <= s <= hi and e > s)
    host = sorted((s, e, name) for name, dev, s, e in events
                  if not dev and name != WINDOW and lo <= s <= hi)
    end = max([hi] + [e for _, e, _ in spans])
    return Traced(wall, spans, host, lo, end)
