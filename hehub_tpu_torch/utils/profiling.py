"""Timing on the card (port of the timing part of
hehub_tpu/utils/profiling.py).

`device_time` is the device time per call between CUDA events, after
warm-up. `step_time` is the host clock around calls that end in
`torch.cuda.synchronize()`, for work whose host part counts too (the host
codec). Both refuse to run without a CUDA device: there is no CPU number
under a device metric's name.
"""

from __future__ import annotations

import time
from typing import Callable

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
