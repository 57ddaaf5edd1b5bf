"""Run-time configuration (port of hehub_tpu/config.py, its codec switch).

use_device_codec: None selects the CKKS device codec (models/ckks.py: the
FP64 FFT kernel K5 and the digit work on the card) for tensors on a CUDA
device and the float64 host codec for tensors on the CPU; True or False
forces the choice (True on the CPU runs the device codec's plain version).
models/ckks.py gates each call further on the magnitudes that the device
codec handles exactly, as the reference does, and takes the host codec
outside them.
"""

from __future__ import annotations

from typing import Optional

import torch

use_device_codec: Optional[bool] = None


def device_codec_selected(device: torch.device) -> bool:
    """Should a codec call whose tensors lie on `device` take the device
    codec?"""
    if use_device_codec is not None:
        return use_device_codec
    return torch.device(device).type == "cuda"
