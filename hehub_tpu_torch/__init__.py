"""hehub_tpu_torch — the PyTorch + CUDA port of hehub_tpu for NVIDIA Hopper.

Mirrors `hehub_tpu`'s layout and names module for module (ops/modarith.py,
ops/ntt.py, core/context.py, ...), so each function's reference sits at the
same path in the JAX package, which stays the reference this package is
tested against.

Conventions:
  * residues are `torch.int64` tensors holding uint32 values lazy in
    [0, 2q); the JAX package's uint32 wraparound is reproduced with
    `& 0xFFFFFFFF` exactly where it relies on it (ops/modarith.py);
  * every kernel that the JAX package wrote in Pallas is a hand-written
    CUDA kernel for sm_90a (csrc/), built at first use by `kernels.py`.
    Its wrapper launches it for a CUDA tensor and runs the plain PyTorch
    version beside it for a CPU tensor; there is no fallback from one to
    the other;
  * randomness comes from an explicit `torch.Generator`, tensors are made
    on an explicit device;
  * this package never imports `jax` or `hehub_tpu`.
"""

__version__ = "0.1.0"

from hehub_tpu_torch.core.context import CkksParams, BgvParams, Context, make_context  # noqa: F401
