"""Build and binding of the hand-written CUDA kernels (csrc/*.cu).

Each `csrc/*.cu` source is compiled by `nvcc` for sm_90a into its own
shared library with a plain C interface, at first use, into
`hehub_tpu_torch/_build/<hash of sources and flags>/`; the libraries are
loaded with ctypes. The sources build in parallel, one `nvcc` each. Nothing
is built or loaded when this module is imported.

The launch functions below take CUDA tensors (int32 holding the bits of
uint32 residues; float64 for the FFT), check device, dtype, shape and
layout, allocate the output, launch on PyTorch's current stream, raise on a
non-zero `cudaGetLastError()`, and count the launch in `LAUNCHES` and by
its rows in `LAUNCH_ROWS`. They are called by the wrappers `ops.ntt.ntt` /
`ops.ntt.intt` (K1, K2, and the stage kernel above MAX_ROW_N), `ops.ntt.ntt_stage`
(the stage kernel, also behind parallel/ntt_sharded.py's cross stages),
`rlwe.rgsw.ext_prod` (K3 at alpha=1, K4 at alpha>1; K4 on parts of
MAX_ROW_N after the stage kernel above it) and `ops.fft.fft` (K5; above
MAX_FFT_M K5 on parts, then the FFT stage kernel F), which hold the plain
PyTorch versions beside them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict

import torch

_PKG = pathlib.Path(__file__).resolve().parent
_SRC = _PKG / "csrc"
_BUILD = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# one shared library per source file
SOURCES = {"ntt": "ntt.cu", "extprod": "extprod.cu", "fft": "fft.cu"}

# launches of each kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {
    "ntt_fwd": 0, "ntt_inv": 0, "ext_prod": 0, "ext_prod_conv": 0, "fft": 0, "ntt_stage": 0,
    "fft_stage": 0,
}
# the same launches by their rows ({rows: launches}; R for the external products)
LAUNCH_ROWS: Dict[str, Dict[int, int]] = {k: {} for k in LAUNCHES}

# the rows one launch of K1-K4 takes: every power of two from 8 to
# MAX_ROW_N = 131072; below n = 1024 the sources launch their instantiations
# that hold several rows a block (csrc/smallrow.cuh, fft.cu's
# fft_small_kernel); longer rows than NTT_SUB_N (K1, K2) or EXT_SUB_N (K3,
# K4) are split into sub-rows of that length (csrc/ntt.cu's and
# extprod.cu's headers): those launches take Context's twiddle tables
# regrouped for the sub-rows (context.sub_table, sub_row_tables) in place of
# the compact ones
MIN_N, MAX_ROW_N = 8, 131072
NTT_SUB_N, EXT_SUB_N = 32768, 16384
# the rings on the card: rows of n > MAX_ROW_N run their first (forward)
# or last (inverse) log2(n / MAX_ROW_N) stages through the stage kernel, the
# rest as K1 / K2 launches (ops.ntt.transform) or K4 launches (the key
# switch, rlwe.rgsw.ext_prod_strict) on parts of MAX_ROW_N, up to MAX_N =
# 2^23, the largest ring that has a prime q < 2^30 with q = 1 mod 2n
# (hostmath.gen_ntt_primes: one at 2^23, none at 2^24), so the largest
# whose tables exist
MAX_N = 1 << 23
# the FFT's length m = n/2 of the codec's ring dimension n: one K5 launch
# takes rows up to MAX_FFT_M; ops.fft.fft runs longer ones (up to MAX_N / 2)
# as K5 on parts of MAX_FFT_M, then one launch of the stage kernel F
# (fft_stage) for each later stage
MIN_FFT_M, MAX_FFT_M = MIN_N // 2, MAX_ROW_N // 2


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_ROWS[k].clear()


def _count(kind: str, rows: int) -> None:
    LAUNCHES[kind] += 1
    LAUNCH_ROWS[kind][rows] = LAUNCH_ROWS[kind].get(rows, 0) + 1


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build_dir() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(_SRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return _BUILD / h.hexdigest()[:16]


def build() -> Dict[str, pathlib.Path]:
    """Compile every library that is not built yet (in parallel) and return
    {name: path}. Raises RuntimeError with nvcc's output on failure. The
    ptxas report (registers, shared memory, spills) of each build is kept
    beside its library as <name>.ptxas.txt."""
    out_dir = _build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    libs = {name: out_dir / f"lib{name}.so" for name in SOURCES}
    procs = {}
    for name, src in SOURCES.items():
        if libs[name].exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(_SRC / src)]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out_dir / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{SOURCES[name]} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[name])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return libs


def ptxas_report() -> str:
    """The ptxas output of the current build, one block per library."""
    out_dir = _build_dir()
    return "\n".join(
        (out_dir / f"{name}.ptxas.txt").read_text()
        for name in SOURCES
        if (out_dir / f"{name}.ptxas.txt").exists()
    )


_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong

_ARGTYPES = {
    "ntt": {
        "hh_ntt_fwd": [_P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
        "hh_ntt_inv": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _I, _I, _P],
        "hh_ntt_stage": [_P, _P, _LL, _P, _P, _LL, _P, _P, _LL, _P, _P, _P, _P, _LL, _I, _I, _I,
                         _I, _P],
    },
    "extprod": {
        "hh_ext_prod": [_P, _P, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
        "hh_ext_prod_conv": [_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P,
                             _I, _I, _I, _I, _P],
    },
    "fft": {
        "hh_fft": [_P, _P, _P, _P, _P, _P, _LL, _I, _P],
        "hh_fft_stage": [_P, _P, _P, _P, _LL, _I, _I, _P],
    },
}


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()[name]))
    for fn, argtypes in _ARGTYPES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.hh_error_string.argtypes = [ctypes.c_int]
    lib.hh_error_string.restype = ctypes.c_char_p
    return lib


def _check_rc(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.hh_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")


def _require(t: torch.Tensor, name: str, device: torch.device, shape=None,
             dtype=torch.int32) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _log_n(n: int) -> int:
    if n & (n - 1) or not MIN_N <= n <= MAX_ROW_N:
        raise ValueError(f"one launch of K1-K4 takes rows of n a power of two in [{MIN_N}, "
                         f"{MAX_ROW_N}], got {n}; longer rows (up to {MAX_N}) run by parts "
                         f"through ops.ntt.transform and rlwe.rgsw.ext_prod_strict")
    return n.bit_length() - 1


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _table_shape(L: int, n: int, sub_n: int):
    """The twiddle tables' shape for L limbs of rows of n: [L, n], or, above
    sub_n, regrouped for sub-rows of sub_n: [L n / sub_n, sub_n]."""
    return (L, n) if n <= sub_n else (L * n // sub_n, sub_n)


def _launch_ntt(kind: str, x: torch.Tensor, tw, tw_sh, per_limb) -> torch.Tensor:
    """Check and launch hh_<kind> on x [..., L, n]; `per_limb` are the [L, 1]
    constant tables in the C function's argument order (None: a null
    pointer)."""
    dev = x.device
    L, n = x.shape[-2], x.shape[-1]
    logn = _log_n(n)
    _require(x, "x", dev)
    if x.data_ptr() % 16:
        raise ValueError("x must start 16-byte aligned (K2 loads its rows as uint4)")
    _require(tw, "tw", dev, _table_shape(L, n, NTT_SUB_N))
    _require(tw_sh, "tw_sh", dev, _table_shape(L, n, NTT_SUB_N))
    for i, c in enumerate(per_limb):
        if c is not None:
            _require(c, f"per-limb table {i}", dev, (L, 1))
    out = torch.empty_like(x)
    rows = x.numel() // n
    if rows:
        lib = _lib("ntt")
        with torch.cuda.device(dev):
            rc = getattr(lib, f"hh_{kind}")(
                x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(),
                *(None if c is None else c.data_ptr() for c in per_limb), rows, L, logn,
                _stream(dev),
            )
        _check_rc(lib, rc, kind)
        _count(kind, rows)
    return out


def ntt_fwd(x: torch.Tensor, tw, tw_sh, q, two_q) -> torch.Tensor:
    """K1: forward NTT of x [..., L, n] (int32 bits of lazy residues) under
    per-limb tables tw/tw_sh [L, n] (above n = NTT_SUB_N regrouped, [L n /
    NTT_SUB_N, NTT_SUB_N]) and q/two_q [L, 1]."""
    return _launch_ntt("ntt_fwd", x, tw, tw_sh, (q, two_q))


def ntt_inv(x: torch.Tensor, tw, tw_sh, q, two_q, w_last=None, w_last_sh=None, n_inv=None,
            n_inv_sh=None):
    """K2: inverse NTT of x [..., L, n]; tw/tw_sh as ntt_fwd's, the
    last-stage constants w_last/w_last_sh/n_inv/n_inv_sh [L, 1] like
    q/two_q. Without them (all None) the last stage does not fold n^-1: it
    is an ordinary stage under tw[1], as a part of a longer row needs."""
    last = (w_last, w_last_sh, n_inv, n_inv_sh)
    if any(c is None for c in last) and any(c is not None for c in last):
        raise ValueError("ntt_inv takes all four last-stage constants or none")
    return _launch_ntt("ntt_inv", x, tw, tw_sh, (q, two_q) + last)


def _row_stride(t: torch.Tensor, name: str) -> int:
    """The stride s at which the rows of t [..., m] (every axis but the
    last, flattened in order) lie: row r at r s. Raises where they do not
    lie at one stride."""
    if t.stride(-1) != 1:
        raise ValueError(f"{name} needs unit stride on its last axis")
    stride = None
    for d in range(t.dim() - 2, -1, -1):
        if t.shape[d] == 1:
            continue
        if stride is None:
            stride, span = t.stride(d), t.stride(d) * t.shape[d]
        elif t.stride(d) != span:
            raise ValueError(f"{name}'s rows do not lie at one stride: {tuple(t.stride())}")
        else:
            span *= t.shape[d]
    return t.shape[-1] if stride is None else stride


def ntt_stage(lo: torch.Tensor, hi: torch.Tensor, w, w_sh, q, two_q, inverse: bool = False,
              n_inv=None, n_inv_sh=None, keep=None, in_place: bool = False):
    """The stage kernel: one radix-2 stage on the pairs (lo, hi) of [..., L,
    B, m] (int32 bits of lazy residues, same shape and row stride, rows at
    one stride, 16-byte aligned; m a power of two >= 4, B a power of two),
    block b of limb l under the twiddle w[l, b] (w/w_sh [L, B], unit stride
    on the last axis): forward lo + hi w, lo - hi w; inverse lo + hi,
    (lo + 2q - hi) w, with n_inv/n_inv_sh [L, 1] folding n^-1 into the
    first (the last stage of an inverse chain). q/two_q [L, 1]. Returns the
    pairs as [..., L, B, 2, m] (lo' then hi' in each block: in place for a
    row whose blocks they were), or, with keep 0 or 1, only lo' or hi' as
    [..., L, B, m]; with in_place, writes lo' over lo and hi' over hi (each
    thread reads its pairs before it writes them) and returns None."""
    dev = lo.device
    *lead, L, B, m = lo.shape
    if tuple(hi.shape) != tuple(lo.shape):
        raise ValueError(f"lo {tuple(lo.shape)} and hi {tuple(hi.shape)} differ in shape")
    if m < 4 or m & (m - 1) or B & (B - 1):
        raise ValueError(f"the stage kernel takes m a power of two >= 4 and B a power of two, "
                         f"got m={m}, B={B}")
    if (n_inv is None) != (n_inv_sh is None) or (n_inv is not None and not inverse):
        raise ValueError("n_inv and n_inv_sh fold n^-1 into an inverse stage, both or neither")
    if keep not in (None, 0, 1) or (in_place and keep is not None):
        raise ValueError(f"keep must be None, 0 or 1, and None in place, got {keep}")
    strides = []
    for t, nm in ((lo, "lo"), (hi, "hi")):
        if not t.is_cuda or t.device != dev or t.dtype != torch.int32:
            raise ValueError(f"{nm} must be an int32 CUDA tensor on {dev}")
        strides.append(_row_stride(t, nm))
        if strides[-1] % 4 or t.data_ptr() % 16:
            raise ValueError(f"{nm} needs 16-byte aligned rows")
    if strides[0] != strides[1]:
        raise ValueError(f"lo and hi rows lie at different strides {strides}")
    for t, nm in ((w, "w"), (w_sh, "w_sh")):
        if (not t.is_cuda or t.device != dev or t.dtype != torch.int32
                or tuple(t.shape) != (L, B) or (B > 1 and t.stride(1) != 1)):
            raise ValueError(f"{nm} must be an int32 CUDA tensor [L, B] = [{L}, {B}] with unit "
                             f"stride on its last axis")
    if w.stride(0) != w_sh.stride(0):
        raise ValueError("w and w_sh rows lie at different strides")
    consts = [q, two_q] + ([n_inv, n_inv_sh] if n_inv is not None else [])
    for i, c in enumerate(consts):
        _require(c, f"per-limb table {i}", dev, (L, 1))
    rows = lo.numel() // (L * B * m)
    if in_place:
        out, outs, out_stride = None, (lo, hi), strides[0]
    elif keep is None:
        out = torch.empty((*lead, L, B, 2, m), dtype=torch.int32, device=dev)
        outs, out_stride = (out[..., 0, :], out[..., 1, :]), 2 * m
    else:
        out = torch.empty((*lead, L, B, m), dtype=torch.int32, device=dev)
        outs, out_stride = (out, None) if keep == 0 else (None, out), m
    if rows:
        lib = _lib("ntt")
        with torch.cuda.device(dev):
            rc = lib.hh_ntt_stage(
                lo.data_ptr(), hi.data_ptr(), strides[0],
                *(None if o is None else o.data_ptr() for o in outs), out_stride,
                w.data_ptr(), w_sh.data_ptr(), w.stride(0), q.data_ptr(), two_q.data_ptr(),
                None if n_inv is None else n_inv.data_ptr(),
                None if n_inv_sh is None else n_inv_sh.data_ptr(),
                rows, L, B.bit_length() - 1, m.bit_length() - 3, int(inverse), _stream(dev))
        _check_rc(lib, rc, "ntt_stage")
        _count("ntt_stage", rows * L * B)
    return out


def _require_rows(t: torch.Tensor, name: str, device: torch.device) -> None:
    """An int32 CUDA tensor read through its strides: unit stride on the last
    axis, every row 16-byte aligned (the kernels load rows as uint4)."""
    if not t.is_cuda or t.device != device or t.dtype != torch.int32:
        raise ValueError(f"{name} must be an int32 CUDA tensor on {device}")
    if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(f"{name} needs unit stride on its last axis and 16-byte aligned rows")


def _launch_ext_prod(kind: str, digits: torch.Tensor, dig_strides, D: int, key: torch.Tensor,
                     tabs) -> torch.Tensor:
    """Check the key and the tables of K3/K4 for D digit rows of digits [R,
    ..., n], allocate out [2, R, L_ext, n] and launch hh_<kind>, whose
    digit stride arguments `dig_strides` come first when it has them."""
    dev = digits.device
    R, n = digits.shape[0], digits.shape[-1]
    logn = _log_n(n)
    if key.dim() != 4 or key.shape[0] < D or key.shape[1] != 2 or key.shape[3] != n:
        raise ValueError(f"key shape {tuple(key.shape)} does not fit {D} digit rows of length {n}")
    _require_rows(key, "key", dev)
    L_ext = key.shape[2]
    tw_shape = _table_shape(L_ext, n, EXT_SUB_N)
    shapes = (tw_shape, tw_shape, (L_ext, 1), (L_ext, 1), (L_ext, 1))
    for t, nm, shp in zip(tabs, ("tw", "tw_sh", "q", "two_q", "neg_qinv"), shapes):
        _require(t, nm, dev, shp)
    out = torch.empty((2, R, L_ext, n), dtype=torch.int32, device=dev)
    if R == 0:
        return out
    lib = _lib("extprod")
    with torch.cuda.device(dev):
        rc = getattr(lib, f"hh_{kind}")(
            digits.data_ptr(), *dig_strides, key.data_ptr(), *key.stride()[:3],
            *(t.data_ptr() for t in tabs), out.data_ptr(), R, D, L_ext, logn, _stream(dev),
        )
    _check_rc(lib, rc, kind)
    _count(kind, R)
    return out


def ext_prod(digits: torch.Tensor, key: torch.Tensor, tw, tw_sh, q, two_q, neg_qinv):
    """K3: fused alpha=1 external product.

    digits: [R, l, n] strict coefficient-form digits; key: [rows >= l, 2,
    L_ext, n] Montgomery-domain RGSW rows (any strides, unit stride on the
    last axis); tw/tw_sh [L_ext, n] (above n = EXT_SUB_N regrouped, [L_ext n
    / EXT_SUB_N, EXT_SUB_N]), q/two_q/neg_qinv [L_ext, 1] of the extended
    limbs. Returns out [2, R, L_ext, n]: c0 = out[0], c1 = out[1]."""
    if digits.dim() != 3:
        raise ValueError("ext_prod takes digits [R, l, n]")
    _require(digits, "digits", digits.device)
    return _launch_ext_prod("ext_prod", digits, (), digits.shape[1], key,
                            (tw, tw_sh, q, two_q, neg_qinv))


def ext_prod_conv(digits: torch.Tensor, key: torch.Tensor, tw, tw_sh, q, two_q, neg_qinv):
    """K4: fused alpha>1 (hybrid) external product on digits already
    base-converted into every extended limb.

    digits: [R, D, L_ext, n], lazy in [0, 2 q_j) under limb j (any strides,
    unit stride on the last axis); key, tables and output as ext_prod, with
    D digit rows of the key."""
    if digits.dim() != 4 or digits.shape[2] != key.shape[2]:
        raise ValueError(f"ext_prod_conv takes digits [R, D, L_ext, n] with the key's L_ext, "
                         f"got {tuple(digits.shape)} and key {tuple(key.shape)}")
    _require_rows(digits, "digits", digits.device)
    return _launch_ext_prod("ext_prod_conv", digits, digits.stride()[:3], digits.shape[1], key,
                            (tw, tw_sh, q, two_q, neg_qinv))


def fft(re: torch.Tensor, im: torch.Tensor, tw_re: torch.Tensor, tw_im: torch.Tensor):
    """K5: the natural-order forward DFT of each row of re + i·im [..., m]
    (float64, rows given in bit-reversed order), under the compact per-stage
    twiddles tw_re/tw_im [m - 1] of ops.fft.fft_tables. Returns (re, im)."""
    dev = re.device
    m = re.shape[-1]
    if m & (m - 1) or not MIN_FFT_M <= m <= MAX_FFT_M:
        raise ValueError(f"one K5 launch takes m a power of two in [{MIN_FFT_M}, {MAX_FFT_M}], "
                         f"got {m}; longer rows (up to {MAX_N // 2}) run as K5 on parts, then "
                         f"the stage kernel F, through ops.fft.fft")
    _require(re, "re", dev, dtype=torch.float64)
    _require(im, "im", dev, tuple(re.shape), torch.float64)
    _require(tw_re, "tw_re", dev, (m - 1,), torch.float64)
    _require(tw_im, "tw_im", dev, (m - 1,), torch.float64)
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    rows = re.numel() // m
    if rows:
        lib = _lib("fft")
        with torch.cuda.device(dev):
            rc = lib.hh_fft(re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
                            tw_re.data_ptr(), tw_im.data_ptr(), rows, m.bit_length() - 1,
                            _stream(dev))
        _check_rc(lib, rc, "fft")
        _count("fft", rows)
    return out_re, out_im


def fft_stage(re: torch.Tensor, im: torch.Tensor, tw_re: torch.Tensor, tw_im: torch.Tensor,
              t: int) -> None:
    """F: one radix-2 DIT stage of span t on every row of re + i·im [..., m]
    (float64, contiguous, 16-byte aligned), in place: x[lo] and x[lo + t]
    of each block of 2t, j = lo mod t, become x[lo] ± w_j x[lo + t] under
    w_j = tw[t - 1 + j] of the compact twiddles tw_re/tw_im (ops.fft's
    fft_tables of any length >= 2t), K5's butterfly (ops.fft.fft_stage_plain
    is its plain twin). t a power of two, 2 <= t <= m / 2."""
    dev = re.device
    m = re.shape[-1]
    if m & (m - 1) or t & (t - 1) or not 2 <= t <= m // 2:
        raise ValueError(f"the FFT stage kernel takes m and t powers of two with "
                         f"2 <= t <= m / 2, got m={m}, t={t}")
    _require(re, "re", dev, dtype=torch.float64)
    _require(im, "im", dev, tuple(re.shape), torch.float64)
    for tw, nm in ((tw_re, "tw_re"), (tw_im, "tw_im")):
        _require(tw, nm, dev, dtype=torch.float64)
        if tw.dim() != 1 or tw.numel() < 2 * t - 1:
            raise ValueError(f"{nm} must be a compact table of at least {2 * t - 1} entries")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError("re and im must start 16-byte aligned (F loads pairs as double2)")
    rows = re.numel() // m
    if rows:
        lib = _lib("fft")
        with torch.cuda.device(dev):
            rc = lib.hh_fft_stage(re.data_ptr(), im.data_ptr(), tw_re[t - 1:].data_ptr(),
                                  tw_im[t - 1:].data_ptr(), rows, m.bit_length() - 1,
                                  t.bit_length() - 1, _stream(dev))
        _check_rc(lib, rc, "fft_stage")
        _count("fft_stage", rows)
