#!/usr/bin/env python3
"""Kernel-only times of hehub_tpu_torch's CUDA kernels K1-K5 at the shapes
of chip_smoke.py's phase 3 (n=16384: K1/K2 on [64, 7, 16384], K3 at R=64,
l=7, L_ext=8, K4 at R=64, D=6, L_ext=14, K5 on [64, 8192]), each the median
of five profiler readings, as one JSON line. Needs an NVIDIA card.

It imports hehub_tpu_torch from the working directory, so one call on the
card can compare two checkouts in turns, building each's kernels:

    for tree in parent change change parent; do
        (cd $tree && python3 /path/to/scripts/torch_kernel_times.py)
    done
"""

import json
import os
import statistics
import sys

import torch

sys.path.insert(0, os.getcwd())

from hehub_tpu_torch import kernels  # noqa: E402
from hehub_tpu_torch.core.context import create_ckks_params, make_context  # noqa: E402
from hehub_tpu_torch.ops import fft as fftmod  # noqa: E402
from hehub_tpu_torch.ops import ntt as nttmod  # noqa: E402
from hehub_tpu_torch.utils.profiling import kernel_time  # noqa: E402

EXT = ("tw_fwd", "tw_fwd_sh", "q", "two_q", "neg_qinv")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.build()
    gen = torch.Generator(device=dev).manual_seed(1)

    def lazy(shape, two_q):
        return torch.randint(0, 1 << 62, shape, generator=gen, device=dev) % two_q

    def rows(ctx, names, ids):
        return [ctx.device_rows(nm, ids, dev, torch.int32) for nm in names]

    ctx = make_context(create_ckks_params(16384, 28, 7))
    ids = tuple(range(7))
    ext = ids + ctx.special_indices
    x = nttmod.to_u32_bits(lazy((64, 7, 16384), ctx.device_rows("two_q", ids, dev)))
    digits = nttmod.to_u32_bits(torch.stack(
        [torch.randint(0, m, (64, 16384), generator=gen, device=dev) for m in ctx.moduli_of(ids)],
        dim=1))
    key = nttmod.to_u32_bits(lazy((7, 2, 8, 16384), ctx.device_rows("two_q", ext, dev)))
    hctx = make_context(create_ckks_params(16384, 28, num_special=2))
    h_ext = tuple(range(12)) + hctx.special_indices
    h_two_q = hctx.device_rows("two_q", h_ext, dev)
    conv = nttmod.to_u32_bits(lazy((64, 6, 14, 16384), h_two_q))
    h_key = nttmod.to_u32_bits(lazy((6, 2, 14, 16384), h_two_q))
    re, im = (torch.rand((64, 8192), generator=gen, device=dev, dtype=torch.float64)
              for _ in range(2))
    tw = fftmod._device_tables(8192, str(dev))
    fwd, inv = rows(ctx, nttmod.FWD_TABLES, ids), rows(ctx, nttmod.INV_TABLES, ids)
    calls = dict(
        ntt_fwd=lambda: kernels.ntt_fwd(x, *fwd),
        ntt_inv=lambda: kernels.ntt_inv(x, *inv),
        ext_prod=lambda: kernels.ext_prod(digits, key, *rows(ctx, EXT, ext)),
        ext_prod_conv=lambda: kernels.ext_prod_conv(conv, h_key, *rows(hctx, EXT, h_ext)),
        fft=lambda: kernels.fft(re, im, *tw),
    )
    print(json.dumps({name: statistics.median(kernel_time(fn, ours=True) * 1e3
                                              for _ in range(5))
                      for name, fn in calls.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
