"""The native (C) CPU kernels: the CPU baseline and a host oracle.

The counterpart of `ace_tpu.native`: `ace_tpu_torch/native/ckks_core.c`
(single-thread -O3 NTTs, Barrett products and table builders on uint64
numpy arrays) built with gcc at first use and loaded with ctypes.
`bench_torch.py --ntt` divides the card's NTT rate by `ntt_fwd_inplace`'s
on the same host; the tests hold the port's numpy tables and plain
ladders against these functions.

The library goes into the build directory of the CUDA kernels,
`<repo>/build/ace_tpu_torch/libckks_core-<hash of source and flags>.so`,
written to a temporary file and renamed into place, so processes that
build it at once do not race. A failed build or load raises: there is
no Python fallback. Unlike `ace_tpu`, the port's NTT tables do not come
from here (ops/ntt.py builds them in numpy, word for word the same), so
a context never needs gcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from ace_tpu_torch.ops.kernels import build_dir

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "native", "ckks_core.c")
_CC_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]
_lib = None
_lock = threading.Lock()

_U64P = ctypes.POINTER(ctypes.c_uint64)
_U64 = ctypes.c_uint64
_SIZE = ctypes.c_size_t
_SIGNATURES = {
    "ckks_ntt_fwd": [_U64P, _U64P, _U64P, _U64, ctypes.c_uint32],
    "ckks_ntt_inv": [_U64P, _U64P, _U64P, _U64, _U64, _U64,
                     ctypes.c_uint32],
    "ckks_modadd": [_U64P, _U64P, _U64P, _U64, _SIZE],
    "ckks_modmul_barrett": [_U64P, _U64P, _U64P, _U64, _U64, _U64, _SIZE],
    "ckks_mac": [_U64P, _U64P, _U64P, _U64, _U64, _U64, _SIZE],
    "ckks_pow_table": [_U64, _U64, _U64P, _SIZE],
    "ckks_shoup_prec": [_U64P, _U64, _U64P, _SIZE],
    "ckks_twiddle_matrix": [_U64, _U64, ctypes.POINTER(ctypes.c_uint32),
                            _SIZE, _SIZE, _U64P],
}


def lib_path() -> str:
    h = hashlib.sha256(" ".join(_CC_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir(), f"libckks_core-{h.hexdigest()[:16]}.so")


def build() -> bool:
    """Build the library if it is missing; True when it was built now."""
    so = lib_path()
    if os.path.exists(so):
        return False
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    out = subprocess.run(["gcc", *_CC_FLAGS, "-o", tmp, _SRC],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"gcc ckks_core.c failed ({out.returncode}):\n"
                           f"{out.stdout}{out.stderr}")
    os.replace(tmp, so)
    return True


def get_lib() -> ctypes.CDLL:
    """The loaded library, built with gcc when it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(lib_path())
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = None
            _lib = lib
    return _lib


def _u64(a, name: str) -> np.ndarray:
    """a itself: a C-contiguous uint64 array (the functions below write
    through its pointer, so no copy is taken)."""
    if not (isinstance(a, np.ndarray) and a.dtype == np.uint64
            and a.flags.c_contiguous):
        raise TypeError(f"{name}: expected a C-contiguous uint64 array")
    return a


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_U64P)


def _same_size(*arrays) -> int:
    n = arrays[0].size
    if any(a.size != n for a in arrays):
        raise ValueError(f"sizes differ: {[a.size for a in arrays]}")
    return n


def _n(data: np.ndarray, *tables) -> int:
    n = _same_size(data, *tables)
    if n < 2 or n & (n - 1):
        raise ValueError(f"degree {n} is not a power of two")
    return n


def ntt_fwd_inplace(data: np.ndarray, rou: np.ndarray, rou_prec: np.ndarray,
                    q: int) -> None:
    """Forward negacyclic NTT of one limb in place, natural order into
    bit-reversed NTT form; rou[bitrev(i)] = psi^i and its Shoup words
    (a row of ops/ntt.py's tables)."""
    n = _n(_u64(data, "data"), _u64(rou, "rou"), _u64(rou_prec, "rou_prec"))
    get_lib().ckks_ntt_fwd(_ptr(data), _ptr(rou), _ptr(rou_prec), q, n)


def ntt_inv_inplace(data: np.ndarray, rou_inv: np.ndarray,
                    rou_inv_prec: np.ndarray, n_inv: int, n_inv_prec: int,
                    q: int) -> None:
    """Inverse negacyclic NTT of one limb in place, N^-1 folded in."""
    n = _n(_u64(data, "data"), _u64(rou_inv, "rou_inv"),
           _u64(rou_inv_prec, "rou_inv_prec"))
    get_lib().ckks_ntt_inv(_ptr(data), _ptr(rou_inv), _ptr(rou_inv_prec),
                           n_inv, n_inv_prec, q, n)


def pow_table(base: int, q: int, n: int) -> np.ndarray:
    """[base^i mod q for i in range(n)]."""
    out = np.empty(n, dtype=np.uint64)
    get_lib().ckks_pow_table(base % q, q, _ptr(out), n)
    return out


def shoup_prec(w: np.ndarray, q: int) -> np.ndarray:
    """floor(w * 2^64 / q) elementwise."""
    w = np.ascontiguousarray(w, dtype=np.uint64)
    out = np.empty_like(w)
    get_lib().ckks_shoup_prec(_ptr(w), q, _ptr(out), w.size)
    return out


def twiddle_matrix(base: int, q: int, row_order: np.ndarray,
                   c: int) -> np.ndarray:
    """T[row_order[u], b] = base^(u*b) mod q, shape [len(row_order), c]."""
    ro = np.ascontiguousarray(row_order, dtype=np.uint32)
    if len(ro) and (int(ro.max()) >= len(ro)):
        raise ValueError("row_order indexes rows beyond its length")
    out = np.empty((len(ro), c), dtype=np.uint64)
    get_lib().ckks_twiddle_matrix(
        base % q, q, ro.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        len(ro), c, _ptr(out))
    return out


def modadd(a: np.ndarray, b: np.ndarray, q: int) -> np.ndarray:
    """(a + b) mod q elementwise."""
    n = _same_size(_u64(a, "a"), _u64(b, "b"))
    out = np.empty_like(a)
    get_lib().ckks_modadd(_ptr(out), _ptr(a), _ptr(b), q, n)
    return out


def modmul_barrett(a: np.ndarray, b: np.ndarray, q: int, mu_hi: int,
                   mu_lo: int) -> np.ndarray:
    """a * b mod q elementwise, two-word Barrett with mu = floor(2^128/q)
    (modops.precompute_barrett128)."""
    n = _same_size(_u64(a, "a"), _u64(b, "b"))
    out = np.empty_like(a)
    get_lib().ckks_modmul_barrett(_ptr(out), _ptr(a), _ptr(b), q, mu_hi,
                                  mu_lo, n)
    return out


def mac(acc: np.ndarray, key: np.ndarray, raised: np.ndarray, q: int,
        mu_hi: int, mu_lo: int) -> None:
    """acc += key * raised mod q elementwise, in place (the key switch's
    digit MAC over one limb)."""
    n = _same_size(_u64(acc, "acc"), _u64(key, "key"), _u64(raised, "raised"))
    get_lib().ckks_mac(_ptr(acc), _ptr(key), _ptr(raised), q, mu_hi, mu_lo, n)
