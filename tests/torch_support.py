"""Helpers shared by the tests/test_torch_*.py files, which hold the PyTorch
port (hehub_tpu_torch) against the JAX package (hehub_tpu) on the same
numpy-made inputs.

Tests that need an NVIDIA card carry the `cuda` marker and take the
`cuda_device` fixture, which skips them where there is none; on the card
they run with `python -m pytest --noconftest -m cuda tests/test_torch_*.py`
(that machine has no JAX, so those tests import none of it).
"""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda", 0)


def lazy_residues(rng, batch_shape, mods, n):
    """uint32 numpy residues [*batch_shape, L, n], uniform in [0, 2 q_j)."""
    two_q = 2 * np.asarray(mods, np.int64)[:, None]
    x = rng.integers(0, 1 << 62, (*batch_shape, len(mods), n)) % two_q
    return x.astype(np.uint32)


def as_numpy(t: torch.Tensor) -> np.ndarray:
    """A port tensor of uint32 residues (int64) as numpy uint32."""
    return t.cpu().numpy().astype(np.uint32)
