"""Basel-series demo (port of examples/ckks_example.py, the reference's
flagship example).

The 10,000 values 1/i are packed into the SIMD slots of a batch of
ciphertexts; one step squares every ciphertext (ct-ct mult + relinearize +
rescale) and tree-adds the batch into one ciphertext of per-slot partial
sums; log2(slots) rotate+add folds then bring the total into every slot.

Computes sum_{i=1..N} 1/i^2 -> pi^2/6, and checks it within 5e-2 of the
exact partial sum (28-bit scale, one squaring and 11 chained rotation
key switches at 30-bit RNS digits: about 1e-2 absolute error).

Usage: python -m hehub_tpu_torch.examples.ckks_example [N]   (default 10000)
"""

import math
import sys
import time

import numpy as np
import torch

from hehub_tpu_torch.core import rns
from hehub_tpu_torch.core.context import create_ckks_params, make_context
from hehub_tpu_torch.models import ckks
from hehub_tpu_torch.ops import modarith as ma
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod

MAX_ERR = 5e-2


def square_and_fold(ctx, ct: ckks.CkksCt, rlk) -> ckks.CkksCt:
    """Square every ciphertext of the batch, then tree-add the batch into one
    ciphertext of per-slot partial sums."""
    sq = ckks.rescale(ctx, ckks.mult(ctx, ct, ct, rlk))
    ids = sq.c0.limb_ids
    two_q = ctx.device_rows("two_q", ids, sq.c0.data.device)
    return ckks.CkksCt(rns.RnsPoly(ma.reduce_add_lazy(sq.c0.data, 0, two_q), rns.NTT, ids),
                       rns.RnsPoly(ma.reduce_add_lazy(sq.c1.data, 0, two_q), rns.NTT, ids),
                       sq.scaling_factor)


def main(total: int = 10000, device="cuda") -> float:
    # n=4096, 2 levels + 1 special = 90 bits, inside the 109-bit budget of
    # 128-bit security for this dimension: the budget check stays on
    params = create_ckks_params(4096, scaling_bits=28, num_levels=2)
    ctx = make_context(params)
    slots = params.dimension // 2
    gen = torch.Generator(device).manual_seed(2024)
    sk = rlwe_mod.keygen(ctx, gen)
    rlk = keys_mod.relin_key(ctx, sk, gen)

    vals = np.zeros(((total + slots - 1) // slots) * slots)
    vals[:total] = 1.0 / np.arange(1, total + 1)
    batch = len(vals) // slots
    t0 = time.perf_counter()
    ct = ckks.encrypt(ctx, ckks.encode(vals.reshape(batch, slots), params, device=device), sk, gen)
    ct_sum = square_and_fold(ctx, ct, rlk)

    step = 1
    while step < slots:
        rk = keys_mod.rot_key(ctx, sk, step, gen)
        ct_sum = ckks.add(ctx, ct_sum, ckks.rotate(ctx, ct_sum, rk, step))
        step *= 2
    recovered = ckks.decode(ckks.decrypt(ctx, ct_sum, sk), params, count=1)
    elapsed = time.perf_counter() - t0

    result = float(np.real(recovered[0]))
    expect = sum(1.0 / i**2 for i in range(1, total + 1))
    print(f"({result:.6f}, {math.pi * math.pi / 6:.6f})  "
          f"[N={total}, batch={batch} cts x {slots} slots, {elapsed:.2f}s on {device}]")
    if not abs(result - expect) < MAX_ERR:
        raise RuntimeError(f"Basel sum {result} vs {expect}: off by more than {MAX_ERR}")
    return result


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10000)
