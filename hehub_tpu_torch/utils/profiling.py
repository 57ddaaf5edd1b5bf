"""Timing on the card and roofline accounting (port of
hehub_tpu/utils/profiling.py).

`device_time` is the device time per call between CUDA events, after
warm-up: host work that outlasts the kernels shows in it. `kernel_time` is
the time per call inside kernels, from a torch.profiler trace: this
package's kernels, or a library call's. `step_time` (and the reference's
`time_op`, the same over `fn(*args)`) is the host clock around calls that
end in `torch.cuda.synchronize()`, for work whose host part counts too (the
host codec). `trace` writes a torch.profiler trace of a block as a Chrome
trace; `op_counters` reads the caching allocator's statistics. All of these
refuse to run without a CUDA device: there is no CPU number under a device
metric's name.

`Roofline`, `ntt_roofline` and `modmul_roofline` turn a time into achieved
bytes/s and integer operations/s with the reference's counts, so that their
reports read as the reference's do: 18 lane operations a butterfly, 20 a
Montgomery product, 4-byte residues. The kernel table of PERF.md counts the
kernels' own uint32 operations instead (chip_smoke.py's FWD_BUTTERFLY_OPS
and the like).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import time
from types import SimpleNamespace
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch


def _require_cuda() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("device timing needs a CUDA device")


def device_time(fn: Callable[[], object], warmup: int = 2, iters: int = 10) -> float:
    """Device seconds per call of `fn()`, from CUDA events around `iters`
    back-to-back calls on the current stream, after `warmup` calls."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / 1e3 / iters


def step_time(fn: Callable[[], object], warmup: int = 1, iters: int = 4) -> float:
    """Host seconds per call of `fn()`, each run ending in a device sync."""
    _require_cuda()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


def time_op(fn: Callable, args: tuple, warmup: int = 2, iters: int = 10) -> float:
    """Steady-state host seconds per call of `fn(*args)`, each run of calls
    ending in a device sync."""
    return step_time(lambda: fn(*args), warmup, iters)


@dataclasses.dataclass
class Roofline:
    seconds: float
    bytes_moved: int  # minimum memory traffic of the op
    int_ops: int  # 32-bit integer lane operations

    @property
    def gbytes_per_s(self) -> float:
        return self.bytes_moved / self.seconds / 1e9

    @property
    def gops_per_s(self) -> float:
        return self.int_ops / self.seconds / 1e9

    @property
    def arithmetic_intensity(self) -> float:
        return self.int_ops / self.bytes_moved

    def report(self, name: str, hbm_gbps: Optional[float] = None) -> str:
        s = (
            f"{name}: {self.seconds*1e6:.1f} us | {self.gbytes_per_s:.1f} GB/s"
            f" | {self.gops_per_s:.1f} Gint-op/s | AI={self.arithmetic_intensity:.1f}"
        )
        if hbm_gbps:
            s += f" | {100*self.gbytes_per_s/hbm_gbps:.0f}% of {hbm_gbps:.0f} GB/s HBM"
        return s


# the reference's counts: a Shoup mulmod is 4 half-word products and about 8
# adds and shifts, a butterfly adds 2 lazy add/sub chains; a Montgomery
# product is 2 wide products and the reduction
_OPS_PER_BUTTERFLY = 18
_OPS_PER_MULMOD = 20


def ntt_roofline(seconds: float, n: int, transforms: int) -> Roofline:
    """Fused-kernel NTT: one read and one write of each 4-byte residue per
    transform (twiddles amortized over the rows)."""
    logn = n.bit_length() - 1
    return Roofline(
        seconds=seconds,
        bytes_moved=transforms * 2 * 4 * n,
        int_ops=transforms * logn * (n // 2) * _OPS_PER_BUTTERFLY,
    )


def modmul_roofline(seconds: float, n_elements: int) -> Roofline:
    """Elementwise dynamic*dynamic mulmod: 2 reads and 1 write of 4 bytes
    per element."""
    return Roofline(
        seconds=seconds,
        bytes_moved=n_elements * 3 * 4,
        int_ops=n_elements * _OPS_PER_MULMOD,
    )


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[str]:
    """Trace the block's host and device activities with torch.profiler and
    write them as one Chrome trace under `logdir` (created if missing);
    yields the path of that file, written when the block ends (after a
    device sync)."""
    _require_cuda()
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        try:
            yield path
        finally:
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)


def op_counters() -> Dict[str, float]:
    """The caching allocator's statistics of the current CUDA device
    (`torch.cuda.memory_stats()`: bytes and counts, e.g.
    "allocated_bytes.all.peak")."""
    _require_cuda()
    return dict(torch.cuda.memory_stats())


_OURS = "(anonymous namespace)::"
# PyTorch kernels launched at the start of each trace, before the window
# that is read: the profiler loses the first records of a trace (on an H100,
# the first kernel of every trace after one of 30 000 launches, and up to 6
# of 10 calls' kernels after a long run)
_LEAD_IN_LAUNCHES = 200
_WINDOW = "hehub_tpu_torch.profiling.window"


class ProfilerFault(RuntimeError):
    """The profiler's trace lost the records that a time is read from."""


def _is_ours(name: str) -> bool:
    return name.removeprefix("void ").startswith(_OURS)


def _window_spans(events) -> List[Tuple[float, float, str]]:
    """(start µs, stop µs, name) of the device activities of a trace's
    `events` that began inside its one host-side window. The window's
    annotation on the device (a span over the window's kernels) is not an
    activity."""
    from torch.autograd import DeviceType

    window = [e.time_range for e in events
              if e.name == _WINDOW and e.device_type == DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"the trace holds {len(window)} host-side windows, not 1")
    lo, hi = window[0].start, window[0].end
    return sorted(
        (e.time_range.start, e.time_range.end, e.name) for e in events
        if e.device_type == DeviceType.CUDA and e.name != _WINDOW
        and lo <= e.time_range.start <= hi)


def _raw_events(prof) -> List[SimpleNamespace]:
    """The activities of a finished torch.profiler trace as records with
    the `name`, `device_type` and `time_range` (µs from the first activity)
    of its FunctionEvents, read from the profiler's raw results: building
    the FunctionEvents takes about 40 s for 500 000 activities (a traced
    eager bootstrap refresh holds that many), this a second."""
    raw = prof.profiler.kineto_results.events()
    t0 = min((e.start_ns() for e in raw), default=0)
    return [SimpleNamespace(
        name=e.name(), device_type=e.device_type(),
        time_range=SimpleNamespace(start=(e.start_ns() - t0) / 1e3,
                                   end=(e.start_ns() + e.duration_ns() - t0) / 1e3))
        for e in raw]


def _traced_window(fn: Callable[[], object]):
    """Trace `fn()` with torch.profiler after a lead-in of small PyTorch
    kernels, inside a marked window that ends in a device sync. Returns the
    host wall seconds of the window and the device activities (start µs,
    stop µs, name) that began inside it."""
    from torch.profiler import ProfilerActivity, profile, record_function

    scratch = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(_LEAD_IN_LAUNCHES):
            scratch.add_(1)
        torch.cuda.synchronize()
        with record_function(_WINDOW):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    return wall, _window_spans(_raw_events(prof))


def _kernel_spans(fn: Callable[[], object], ours: bool, warmup: int,
                  iters: int) -> List[Tuple[str, float]]:
    """(name, µs) of the CUDA kernels (no copies) of `iters` calls of `fn()`
    traced by torch.profiler after `warmup` calls; `ours` True keeps only
    this package's kernels, False only the others (a library call's). A
    trace without such a kernel is taken again (the profiler now and then
    records no device activity at all), twice at most; then this raises
    (the profiler cannot trace the card)."""
    _require_cuda()
    for _ in range(warmup):
        fn()

    def calls():
        for _ in range(iters):
            fn()

    for _ in range(3):
        spans, seen = [], set()
        for start, stop, name in _traced_window(calls)[1]:
            if name.startswith(("Memcpy", "Memset")):
                continue
            seen.add(name)
            if _is_ours(name) == ours:
                spans.append((name, stop - start))
        if spans:
            return spans
    raise ProfilerFault(f"the profiler trace holds no kernel of the call (ours={ours}); "
                        f"kernels seen: {sorted(seen)}")


def kernel_time(fn: Callable[[], object], ours: bool, warmup: int = 2, iters: int = 10) -> float:
    """Device seconds per call of `fn()` spent inside kernels (no copies, no
    gaps between launches), from a torch.profiler trace of `iters` calls
    after `warmup` calls: this package's kernels if `ours`, else the others
    (a library call's). Each kernel name adds its mean traced interval
    times its launches per call (its traced count over `iters`, rounded),
    so that a record the profiler drops biases neither side of a
    comparison. A trace that lost more than half of a kernel's records, or
    holds more than whole calls' worth, is taken again, three times in all;
    then this raises ProfilerFault."""
    for attempt in range(3):
        by_name: Dict[str, List[float]] = collections.defaultdict(list)
        for name, us in _kernel_spans(fn, ours, warmup if attempt == 0 else 0, iters):
            by_name[name].append(us)
        total, fault = 0.0, None
        for name, durations in by_name.items():
            per_call = round(len(durations) / iters)
            if per_call < 1 or len(durations) > per_call * iters:
                fault = f"{len(durations)} launches of {name} traced for {iters} calls"
                break
            total += sum(durations) / len(durations) * per_call
        if fault is None:
            return total / 1e6
    raise ProfilerFault(f"{fault} in each of 3 traces")

