"""TFHE gate-bootstrapping demo (port of examples/tfhe_example.py).

Evaluates a bootstrapped NAND truth table over batched LWE ciphertexts: all
four input pairs run through one batched blind rotation, which is how TFHE
gates amortize on wide hardware. Checks the table exactly.

Usage: python -m hehub_tpu_torch.examples.tfhe_example [secure]
"""

import sys
import time

import numpy as np
import torch

from hehub_tpu_torch.models import tfhe


def main(secure: bool = False, device="cuda") -> np.ndarray:
    # named presets with documented security estimates (models/tfhe.py):
    # PRESET_TOY is fast for a demo but NOT secure; `secure` takes the
    # ~128-bit production preset
    params = tfhe.PRESET_GATE_128 if secure else tfhe.PRESET_TOY
    print(f"preset: N={params.rlwe_dimension}, m={params.lwe_dimension}, "
          f"estimated security ≈ {params.security_bits():.0f} bits"
          + ("" if secure else "  (TOY parameters — do not deploy)"))
    gen = torch.Generator(device).manual_seed(0)
    keys = tfhe.keygen(params, gen)

    bits1 = np.array([0, 0, 1, 1], np.uint32)
    bits2 = np.array([0, 1, 0, 1], np.uint32)
    ct1 = tfhe.lwe_encrypt(params, tfhe.encode_bit(params, bits1, device), keys.lwe_s, gen)
    ct2 = tfhe.lwe_encrypt(params, tfhe.encode_bit(params, bits2, device), keys.lwe_s, gen)

    t0 = time.perf_counter()
    out = tfhe.nand_gate(params, ct1, ct2, keys)
    got = tfhe.lwe_decrypt_bit(params, out, keys.lwe_s).cpu().numpy()
    dt = time.perf_counter() - t0

    want = 1 - (bits1 & bits2)
    print(f"NAND({bits1}, {bits2}) = {got}  expected {want}  "
          f"[4 bootstrapped gates in {dt:.2f}s on {device}]")
    if not np.array_equal(got, want):
        raise RuntimeError(f"NAND truth table {got}, expected {want}")
    return got


if __name__ == "__main__":
    main(secure="secure" in sys.argv[1:])
