"""Pipeline parallelism for deep leveled circuits (port of
hehub_tpu/parallel/pipeline.py).

A chain of homomorphic stages is a natural pipeline: each stage takes a
ciphertext at some level and gives one at a lower level. Stage s runs on
devices[s] (a torch.device), on a CUDA stream of its own; the host
enqueues the GPipe schedule of the reference (M microbatches through D
stages in M + D - 1 ticks) and never waits inside it, so consecutive
microbatches run at once on different devices, or, where devices repeat
(on one card, [cuda:0] * 3), on the stages' streams side by side. A
handoff is `.to(next device, non_blocking=True)` on the stage's stream and
an event the next stage's stream waits on. The reference compiles each
stage once per (stage, limb ids, scale); here that entry is the stage's
output metadata, and the first run of each entry ends in a synchronize of
its stream, so the constants it made on first use (context tables, codec
plans) are complete before another stream reads them.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Sequence

import torch

from hehub_tpu_torch.core import rns
from hehub_tpu_torch.core.context import Context
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.rlwe import rgsw as rgsw_mod

StageFn = Callable[[Context, ckks.CkksCt], ckks.CkksCt]


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    """The given devices (a CUDA one without index: the current), or every
    CUDA device."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ValueError("no CUDA device: pass the stages' devices, e.g. "
                             "[torch.device('cpu')] * depth")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


class Pipeline:
    """An arbitrary staged circuit: stages[s](ctx, ct) -> ct runs on
    devices[s] (every CUDA device by default; repeats allowed). With D
    stages and M microbatches, `run` executes the GPipe schedule in
    M + D - 1 ticks with up to D microbatches in flight. A stage's keys and
    constants must be on its device."""

    def __init__(self, ctx: Context, stages: Sequence[StageFn],
                 devices: Optional[Sequence] = None):
        self.ctx = ctx
        self.stages: List[StageFn] = list(stages)
        devs = _devices(devices)
        if len(self.stages) > len(devs):
            raise ValueError(f"need {len(self.stages)} devices, have {len(devs)}")
        self.devices = devs[: len(self.stages)]
        self.streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None
                        for d in self.devices]
        self._compiled = {}  # (stage, limb_ids, scale) -> (out limb_ids, out scale)

    def _on(self, s: int):
        return (torch.cuda.stream(self.streams[s]) if self.streams[s] is not None
                else contextlib.nullcontext())

    def _stage(self, s: int, c0, c1, ids, scale, ready):
        """Stage s on its stream after the event `ready`: its output halves
        on the next stage's device (or the last stage's), the output's limb
        ids and scale, and the event that marks them done."""
        stream = self.streams[s]
        with self._on(s):
            if stream is not None:
                if ready is not None:
                    stream.wait_event(ready)
                c0.record_stream(stream)
                c1.record_stream(stream)
            out = self.stages[s](self.ctx, ckks.CkksCt(
                rns.RnsPoly(c0, rns.NTT, ids), rns.RnsPoly(c1, rns.NTT, ids), scale))
            meta = (out.c0.limb_ids, float(out.scaling_factor))
            key = (s, ids, scale)
            if key not in self._compiled:
                if stream is not None:
                    stream.synchronize()
                self._compiled[key] = meta
            elif self._compiled[key] != meta:
                raise ValueError(f"stage {s} gave {meta}, before {self._compiled[key]}")
            dst = self.devices[min(s + 1, len(self.devices) - 1)]
            o0 = out.c0.data.to(dst, non_blocking=True)
            o1 = out.c1.data.to(dst, non_blocking=True)
            done = None
            if stream is not None:
                done = torch.cuda.Event()
                done.record(stream)
        return o0, o1, meta[0], meta[1], done

    def run(self, cts: Sequence[ckks.CkksCt]) -> List[ckks.CkksCt]:
        """GPipe schedule: microbatch m enters stage 0 at tick m; stage s
        takes microbatch m at tick m + s. The host never waits inside it
        but for each entry's first run; the outputs are ready on the
        caller's current stream."""
        depth, devs = len(self.stages), self.devices
        n_micro = len(cts)
        for d, stream in zip(devs, self.streams):
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(d))
        feed = [(ct.c0.data.to(devs[0], non_blocking=True),
                 ct.c1.data.to(devs[0], non_blocking=True), ct.c0.limb_ids,
                 float(ct.scaling_factor), None) for ct in cts]
        if self.streams[0] is not None:
            self.streams[0].wait_stream(torch.cuda.current_stream(devs[0]))
        state = [None] * depth  # (c0, c1, ids, scale, done event, microbatch) per stage
        done: List[Optional[ckks.CkksCt]] = [None] * n_micro
        for tick in range(n_micro + depth - 1):
            new_state = [None] * depth
            for s in reversed(range(depth)):
                if s == 0:
                    inp = (*feed[tick], tick) if tick < n_micro else None
                else:
                    inp = state[s - 1]
                if inp is None:
                    continue
                *args, idx = inp
                o0, o1, ids, scale, ev = self._stage(s, *args)
                if s + 1 < depth:
                    new_state[s] = (o0, o1, ids, scale, ev, idx)
                else:
                    done[idx] = ckks.CkksCt(rns.RnsPoly(o0, rns.NTT, ids),
                                            rns.RnsPoly(o1, rns.NTT, ids), scale)
            state = new_state
        last = devs[-1]
        for stream in self.streams:
            if stream is not None:
                torch.cuda.current_stream(last).wait_stream(stream)
        if self.streams[-1] is not None:
            for ct in done:
                ct.c0.data.record_stream(torch.cuda.current_stream(last))
                ct.c1.data.record_stream(torch.cuda.current_stream(last))
        return done


class PipelinedSquaringChain:
    """Iterated squaring ct -> ct^(2^depth) staged across `devices`: a
    Pipeline of `depth` stages of rescale(mult(ct, ct)), each under a copy
    of the relinearization key on its own device. `top_level` is the
    reference's argument, which it does not use either."""

    def __init__(self, ctx: Context, rlk: rgsw_mod.RgswCt, depth: int, top_level: int,
                 devices: Optional[Sequence] = None):
        devs = _devices(devices)[:depth]
        keys = {d: rgsw_mod.RgswCt(rlk.data.to(d), rlk.limb_ids, rlk.alpha) for d in devs}

        def square(c: Context, ct: ckks.CkksCt) -> ckks.CkksCt:
            return ckks.rescale(c, ckks.mult(c, ct, ct, keys[ct.c0.data.device]))

        self._pipe = Pipeline(ctx, [square] * depth, devs)
        self.devices = self._pipe.devices

    def run(self, cts: Sequence[ckks.CkksCt]) -> List[ckks.CkksCt]:
        return self._pipe.run(cts)
