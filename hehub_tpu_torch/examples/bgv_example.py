"""BGV demo (port of examples/bgv_example.py): exact modular SIMD
arithmetic, including the ct-ct multiply with relinearization.

Computes slot-wise (a + b)·c mod t over encrypted vectors and checks it
exactly: BGV is exact arithmetic, so the check is equality, not a
noise-tolerant comparison.

One departure from the JAX demo, which fails its own check in both
packages: its mod_switch restores the plaintext scale by multiplying the
ciphertext by (q_last mod t) = 47984 here, and that multiplies the noise
(2^22.6 after the switch) past the last 30-bit limb's q_0/2. This twin
switches with restore_plain_scale=False and multiplies the decrypted slots
by that factor mod t instead, which leaves the noise alone.

Usage: python -m hehub_tpu_torch.examples.bgv_example
"""

import numpy as np
import torch

from hehub_tpu_torch.core.context import create_bgv_params, make_context
from hehub_tpu_torch.models import bgv
from hehub_tpu_torch.rlwe import keys as keys_mod
from hehub_tpu_torch.rlwe import rlwe as rlwe_mod


def main(device="cuda") -> bool:
    params = create_bgv_params(4096, plain_bits=17, num_levels=2)
    ctx = make_context(params)
    t = params.plain_modulus
    n = params.dimension

    gen = torch.Generator(device).manual_seed(11)
    sk = rlwe_mod.keygen(ctx, gen)
    # BGV key-switching keys carry noise lifted by t
    rlk = keys_mod.relin_key(ctx, sk, gen, noise_scale=t)

    rng = np.random.default_rng(0)
    a = rng.integers(0, t, n, dtype=np.uint64)
    b = rng.integers(0, t, n, dtype=np.uint64)
    c = rng.integers(0, t, n, dtype=np.uint64)

    ct_a, ct_b, ct_c = (bgv.encrypt(ctx, bgv.simd_encode(ctx, x, device=device), sk, gen)
                        for x in (a, b, c))
    ct_sum = bgv.add(ctx, ct_a, ct_b)
    ct_prod = bgv.mult(ctx, ct_sum, ct_c, rlk)  # ct-ct mult + relin
    # manage noise growth; the dropped prime's factor mod t stays on the
    # plaintext until it is decrypted
    plain_scale = bgv.plain_scale_dropped(ctx, ct_prod)
    ct_prod = bgv.mod_switch(ctx, ct_prod, restore_plain_scale=False)

    got = bgv.simd_decode(ctx, bgv.decrypt(ctx, ct_prod, sk), device=device)
    got = got.astype(np.uint64) * np.uint64(plain_scale) % np.uint64(t)
    want = (a + b) * c % t
    exact = np.array_equal(got.astype(np.uint64), want)
    print(f"BGV (a+b)*c mod {t}: exact={exact}, n={n} slots on {device}")
    if not exact:
        raise RuntimeError(f"BGV (a+b)*c mod {t} is not exact in "
                           f"{int((got.astype(np.uint64) != want).sum())} slots")
    return exact


if __name__ == "__main__":
    main()
