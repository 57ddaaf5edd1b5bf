"""ctypes loader of the host C++ runtime, csrc/host/hehub_native.cpp (port
of hehub_tpu/native/loader.py, with the same functions).

The library is built with g++ at first use, with the reference's flags,
into `hehub_tpu_torch/_build/host-<hash>/`. The hash covers the source, the
flags and the target that `-march=native` resolves to on this host, so a
library built for another CPU is never loaded. A failed build raises with
the compiler's output: unlike the reference, there is no quiet fallback to
Python. The numpy chains beside the callers (models/ckks.py's `*_plain`
functions, core/basecnv.convert_to_single_host_plain) are the plain twins
the tests hold this library against. Host code, not a GPU kernel.
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

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parents[1]
_SRC = _PKG / "csrc" / "host" / "hehub_native.cpp"
_BUILD = _PKG / "_build"
# no FMA contraction: hh_mixed_radix must round exactly like the numpy twin
GXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the host runtime needs a C++ compiler")
    return gxx


def _run(cmd) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                           f"{proc.stderr}{proc.stdout}")
    return proc.stdout


def _library_path() -> pathlib.Path:
    """Where this host's build of the library lies (built or not)."""
    gxx = _gxx()
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    h.update(_run([gxx, "-march=native", "-Q", "--help=target"]).encode())
    return _BUILD / f"host-{h.hexdigest()[:16]}" / "libhehub_native.so"


def build() -> pathlib.Path:
    """Compile the library unless this host's build exists; return its path.
    Raises RuntimeError with g++'s output on failure. Concurrent builds
    each write a temporary file and rename it into place."""
    so = _library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
        os.close(fd)
        try:
            _run([_gxx(), *GXX_FLAGS, str(_SRC), "-o", tmp])
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    c_ll, c_int, c_u64 = ctypes.c_longlong, ctypes.c_int, ctypes.c_uint64
    signatures = {
        "hh_is_prime_u64": ([c_u64], c_int),
        "hh_decompose_i64": ([i64p, c_ll, u64p, c_int, u32p], None),
        "hh_gen_ntt_primes": ([c_int, c_int, c_u64, u64p], c_int),
        "hh_compose_mod": ([u32p, u64p, c_int, c_ll, c_u64, u32p], None),
        "hh_compose_double": ([u32p, u64p, c_int, c_ll, f64p], None),
        "hh_ntt_fwd": ([u32p, c_ll, c_u64, u32p], None),
        "hh_ntt_inv": ([u32p, c_ll, c_u64, u32p, c_u64], None),
        "hh_digitize": ([f64p, c_ll, c_ll, u32p, u32p], c_int),
        "hh_mixed_radix": ([u32p, c_ll, c_int, c_ll, u64p, c_int, f64p,
                            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(c_int)], None),
        "hh_encode_pre": ([f64p, i64p, c_ll, c_ll, f64p], None),
        "hh_encode_post": ([f64p, f64p, ctypes.c_double, c_ll, c_ll, u32p, u32p], c_int),
        "hh_decode_pre": ([f64p, f64p, ctypes.c_double, c_ll, c_ll, f64p], None),
        "hh_decode_post": ([f64p, i64p, c_ll, c_ll, c_ll, f64p], None),
    }
    for name, (argtypes, restype) in signatures.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def available() -> bool:
    """True once the library is built and loaded; a failed build raises."""
    _lib()
    return True


def _as_f64(a: np.ndarray) -> np.ndarray:
    """Interleaved-double view of a C-contiguous complex128 array."""
    return np.ascontiguousarray(a, np.complex128).view(np.float64)


_OVERFLOW = "encoded coefficients exceed 2^62; lower the scaling factor"


def encode_pre(data: np.ndarray, invj: np.ndarray) -> np.ndarray:
    """Slot order -> DFT bin order with the odd slots conjugated, in one
    gather pass."""
    c = np.ascontiguousarray(data, np.complex128)
    half = c.shape[-1]
    rows = c.size // half
    out = np.empty(c.shape, np.complex128)
    _lib().hh_encode_pre(
        c.view(np.float64).reshape(rows, 2 * half),
        np.ascontiguousarray(invj, np.int64), rows, half,
        out.view(np.float64).reshape(rows, 2 * half),
    )
    return out


def encode_post(u: np.ndarray, tw: np.ndarray, scale: float):
    """FFT output -> (digits, neg): twist, scale, rint and the base-2^22
    split in one pass. Raises ValueError on |coefficient| >= 2^62."""
    c = np.ascontiguousarray(u, np.complex128)
    half = c.shape[-1]
    rows = c.size // half
    n = 2 * half
    digits = np.empty((*c.shape[:-1], 3, n), np.uint32)
    neg = np.empty((*c.shape[:-1], n), np.uint32)
    if _lib().hh_encode_post(
        c.view(np.float64).reshape(rows, 2 * half), _as_f64(tw),
        float(scale), rows, half,
        digits.reshape(rows, 3, n), neg.reshape(rows, n),
    ):
        raise ValueError(_OVERFLOW)
    return digits, neg


def decode_pre(coeffs: np.ndarray, tw: np.ndarray, scale: float) -> np.ndarray:
    """Real coefficients [..., n] -> twisted complex [..., n/2] ready for
    the iFFT: complex build, 1/scale and twist in one pass."""
    c = np.ascontiguousarray(coeffs, np.float64)
    n = c.shape[-1]
    half = n // 2
    rows = c.size // n
    out = np.empty((*c.shape[:-1], half), np.complex128)
    _lib().hh_decode_pre(
        c.reshape(rows, n), _as_f64(tw), float(scale), rows, half,
        out.view(np.float64).reshape(rows, 2 * half),
    )
    return out


def decode_post(vals: np.ndarray, j: np.ndarray, count: int) -> np.ndarray:
    """iFFT output -> the first `count` slots (gather and odd-position
    conjugation)."""
    c = np.ascontiguousarray(vals, np.complex128)
    half = c.shape[-1]
    rows = c.size // half
    out = np.empty((*c.shape[:-1], count), np.complex128)
    _lib().hh_decode_post(
        c.view(np.float64).reshape(rows, 2 * half),
        np.ascontiguousarray(j, np.int64), rows, half, count,
        out.view(np.float64).reshape(rows, 2 * count),
    )
    return out


def compose_mod(residues: np.ndarray, moduli, new_mod: int) -> np.ndarray:
    """Exact signed k -> 1 base conversion of strict residues [L, n] to
    new_mod."""
    res = np.ascontiguousarray(residues, np.uint32)
    L, n = res.shape
    out = np.empty(n, np.uint32)
    _lib().hh_compose_mod(res, np.asarray(moduli, np.uint64), L, n, np.uint64(new_mod), out)
    return out


def compose_double(residues: np.ndarray, moduli) -> np.ndarray:
    """Centred CRT-composed values of strict residues [L, n] as float64
    [n]."""
    res = np.ascontiguousarray(residues, np.uint32)
    L, n = res.shape
    out = np.empty(n, np.float64)
    _lib().hh_compose_double(res, np.asarray(moduli, np.uint64), L, n, out)
    return out


def decompose_i64(coeffs: np.ndarray, moduli) -> np.ndarray:
    """Signed int64 coefficients [..., n] -> strict residues [..., L, n]."""
    flat = np.ascontiguousarray(coeffs, dtype=np.int64).reshape(-1)
    mods = np.asarray(list(moduli), np.uint64)
    out = np.empty((len(mods), flat.size), np.uint32)
    _lib().hh_decompose_i64(flat, flat.size, mods, len(mods), out)
    return np.moveaxis(out.reshape(len(mods), *np.shape(coeffs)), 0, -2)


def digitize(coeffs: np.ndarray):
    """rint and base-2^22 digit split of float64 coefficients [..., n] in
    one pass: (digits uint32 [..., 3, n], neg uint32 [..., n]). Raises
    ValueError on |rint(x)| >= 2^62."""
    c = np.ascontiguousarray(coeffs, np.float64)
    n = c.shape[-1]
    rows = c.size // n
    digits = np.empty((*c.shape[:-1], 3, n), np.uint32)
    neg = np.empty(c.shape, np.uint32)
    if _lib().hh_digitize(c.reshape(rows, n), rows, n, digits.reshape(rows, 3, n),
                          neg.reshape(rows, n)):
        raise ValueError(_OVERFLOW)
    return digits, neg


def mixed_radix(digits: np.ndarray, mods, split_top: bool = False):
    """Balanced-digit carry pass: Garner digits [..., K, n] -> centred
    float64 values [..., n]. split_top=True also returns the balanced top
    digit row as int64 (the decode's overflow sentinel), or None when every
    sentinel digit is zero."""
    lib = _lib()
    d = np.ascontiguousarray(digits, np.uint32)
    K, n = d.shape[-2], d.shape[-1]
    rows = d.size // (K * n)
    out = np.empty((*d.shape[:-2], n), np.float64)
    mods_arr = np.asarray(list(mods), np.uint64)
    if split_top:
        top = np.empty((*d.shape[:-2], n), np.int64)
        nz = ctypes.c_int(0)
        lib.hh_mixed_radix(d.reshape(rows, K, n), rows, K, n, mods_arr, 1, out.reshape(rows, n),
                           top.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ctypes.byref(nz))
        return out, (top if nz.value else None)
    lib.hh_mixed_radix(d.reshape(rows, K, n), rows, K, n, mods_arr, 0, out.reshape(rows, n),
                       None, None)
    return out


def is_prime(n: int) -> bool:
    return bool(_lib().hh_is_prime_u64(np.uint64(n)))


def ntt_fwd(data: np.ndarray, q: int, tw: np.ndarray) -> np.ndarray:
    """Strict forward negacyclic NTT of one row (natural -> bit-reversed)
    under twiddles psi^bitrev."""
    out = np.ascontiguousarray(data, np.uint32).copy()
    _lib().hh_ntt_fwd(out, out.shape[-1], np.uint64(q), np.ascontiguousarray(tw))
    return out


def ntt_inv(data: np.ndarray, q: int, tw_inv: np.ndarray, n_inv: int) -> np.ndarray:
    """Strict inverse of ntt_fwd, n^-1 applied."""
    out = np.ascontiguousarray(data, np.uint32).copy()
    _lib().hh_ntt_inv(out, out.shape[-1], np.uint64(q), np.ascontiguousarray(tw_inv),
                      np.uint64(n_inv))
    return out
