"""The complex FFT and the digit split of the CKKS device codec (port of
hehub_tpu/ops/df64.py: bitrev_perm, fft_tables, fft, fft_xla,
balanced_digits).

The reference carries each value as a double-float32 pair, since the TPU
has no float64. The H100 has native FP64, so this module works on float64
and ports none of the double-float32 arithmetic (two_sum, two_prod, mul_dd,
add_dd, ...). A complex vector is a pair of float64 tensors (real,
imaginary), never torch.complex128, whose multiply may round differently
on the CPU and on the card: here a complex product is four real products
and two sums in a fixed order, which the kernel K5 (csrc/fft.cu) repeats
with rounded-to-nearest intrinsics, so the two agree bit for bit.

`fft_plain` is the plain PyTorch stage chain; `fft` launches K5 for CUDA
tensors and runs `fft_plain` for CPU tensors. Rows longer than one K5
launch takes (kernels.MAX_FFT_M, up to kernels.MAX_N / 2) run by parts
(`fft_parts`): K5 on the aligned parts of MAX_FFT_M, inside which the
first log2(MAX_FFT_M) stages of a bit-reversed row act, then one launch of
the stage kernel F (`kernels.fft_stage`, plain twin `fft_stage_plain`)
for each later stage; the same butterflies in the same order as
`fft_plain`, so bitwise equal to it.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from hehub_tpu_torch import kernels


@functools.lru_cache(maxsize=None)
def bitrev_perm(m: int) -> np.ndarray:
    """Bit-reversal permutation of [0, m)."""
    logm = m.bit_length() - 1
    idx = np.arange(m)
    out = np.zeros(m, np.int64)
    for _ in range(logm):
        out = (out << 1) | (idx & 1)
        idx >>= 1
    return out


@functools.lru_cache(maxsize=None)
def fft_tables(m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Compact per-stage twiddles of the forward DFT, float64 (real,
    imaginary) [m - 1]: stage s (span t = 2^s) holds w_j = e^{-iπ j / t},
    j < t, at offset t - 1, the values of df64.fft_tables in float64. The
    table of m/2 is a prefix of the table of m."""
    logm = m.bit_length() - 1
    w = np.concatenate(
        [np.exp(-1j * np.pi * np.arange(1 << s) / (1 << s)) for s in range(logm)]
    )
    re, im = np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag)
    re.setflags(write=False)
    im.setflags(write=False)
    return re, im


@functools.lru_cache(maxsize=None)
def _device_tables(m: int, device: str) -> Tuple[torch.Tensor, torch.Tensor]:
    return tuple(torch.from_numpy(t.copy()).to(device) for t in fft_tables(m))


def fft_stage_plain(re: torch.Tensor, im: torch.Tensor, t: int, tw_re: torch.Tensor,
                    tw_im: torch.Tensor):
    """One radix-2 DIT stage of span t on float64 (real, imaginary) rows
    [..., m]: in each block of 2t, x[j] and x[j + t] become x[j] ± w_j x[j + t]
    under w_j = tw[t - 1 + j] of the compact table (fft_tables), a complex
    product as four real products and two sums. Returns new tensors. The
    plain twin of the stage kernel F (kernels.fft_stage)."""
    m = re.shape[-1]
    lead = re.shape[:-1]
    wr, wi = tw_re[t - 1 : 2 * t - 1], tw_im[t - 1 : 2 * t - 1]
    vr = re.reshape(*lead, m // (2 * t), 2, t)
    vi = im.reshape(*lead, m // (2 * t), 2, t)
    ar, br, ai, bi = vr[..., 0, :], vr[..., 1, :], vi[..., 0, :], vi[..., 1, :]
    bwr = br * wr - bi * wi
    bwi = br * wi + bi * wr
    return (torch.stack([ar + bwr, ar - bwr], dim=-2).reshape(*lead, m),
            torch.stack([ai + bwi, ai - bwi], dim=-2).reshape(*lead, m))


def fft_plain(re: torch.Tensor, im: torch.Tensor, m: int):
    """The in-order radix-2 DIT stage chain of df64.fft_xla on float64
    (real, imaginary) tensors [..., m] whose rows are in bit-reversed order;
    returns the natural-order forward DFT as (real, imaginary)."""
    tw_re, tw_im = _device_tables(m, str(re.device))
    for s in range(m.bit_length() - 1):
        re, im = fft_stage_plain(re, im, 1 << s, tw_re, tw_im)
    return re, im


def fft_parts(re: torch.Tensor, im: torch.Tensor, m: int, part: int, on_card: bool):
    """fft_plain of rows [..., m] by parts of `part` (a power of two < m):
    the DFT of each aligned part of the bit-reversed row, under the table of
    `part` (a prefix of the table of m), which is the chain's first
    log2(part) stages, then the stages of span part .. m/2 on whole rows.
    on_card: K5 on the parts, then the stage kernel F in place; else
    fft_plain on the parts, then fft_stage_plain: the same operations in
    the same order, bitwise equal to fft_plain."""
    lead = re.shape[:-1]
    tw_re, tw_im = _device_tables(m, str(re.device))
    parts = (re.reshape(*lead, m // part, part), im.reshape(*lead, m // part, part))
    if on_card:
        re, im = kernels.fft(*(p.contiguous() for p in parts), tw_re[:part - 1],
                             tw_im[:part - 1])
    else:
        re, im = fft_plain(*parts, part)
    re, im = re.reshape(*lead, m), im.reshape(*lead, m)
    t = part
    while t < m:
        if on_card:
            kernels.fft_stage(re, im, tw_re, tw_im, t)
        else:
            re, im = fft_stage_plain(re, im, t, tw_re, tw_im)
        t *= 2
    return re, im


def fft(re: torch.Tensor, im: torch.Tensor, m: int):
    """Forward DFT of bit-reversed float64 rows [..., m] (the contract of
    df64.fft): the K5 kernel for CUDA tensors (above kernels.MAX_FFT_M, up
    to kernels.MAX_N / 2, K5 on parts and the stage kernel F: fft_parts),
    fft_plain for CPU tensors."""
    if re.shape != im.shape or re.shape[-1] != m:
        raise ValueError(f"fft takes real and imaginary parts [..., {m}], "
                         f"got {tuple(re.shape)} and {tuple(im.shape)}")
    if re.dtype != torch.float64 or im.dtype != torch.float64:
        raise TypeError("fft takes float64 tensors")
    dev = re.device
    if dev.type == "cuda":
        if m <= kernels.MAX_FFT_M:
            return kernels.fft(re.contiguous(), im.contiguous(), *_device_tables(m, str(dev)))
        if m > kernels.MAX_N // 2:
            raise ValueError(f"the FFT on the card takes m up to {kernels.MAX_N // 2}, got {m}")
        return fft_parts(re, im, m, kernels.MAX_FFT_M, on_card=True)
    if dev.type != "cpu":
        raise ValueError(f"no FFT for tensors on {dev}")
    return fft_plain(re, im, m)


def balanced_digits(v: torch.Tensor) -> torch.Tensor:
    """rint(v) of float64 values with |v| < 2^45 as three balanced base-2^22
    digit planes, int32 [..., 3, n] with rint(v) = d0 + d1·2^22 + d2·2^44
    and |d_i| <= 2^21 (the input of basecnv.decompose_balanced). Every
    step is exact in FP64: integers below 2^53, scalings by powers of two."""
    r = torch.round(v)  # half to even, as np.rint
    d2 = torch.round(r * 2.0**-44)
    r = r - d2 * 2.0**44
    d1 = torch.round(r * 2.0**-22)
    d0 = r - d1 * 2.0**22
    return torch.stack([d0, d1, d2], dim=-2).to(torch.int32)
