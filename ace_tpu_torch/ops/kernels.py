"""Build and load the CUDA kernels of `ace_tpu_torch/csrc/`.

Each `csrc/*.cu` compiles with `nvcc` for sm_90a into a shared library
with a plain C interface, loaded with ctypes; the launchers take raw
device pointers and PyTorch's current stream and return
cudaGetLastError(). Nothing here runs at import: the first call of a
kernel wrapper builds every library (one `nvcc` per source, all started
together) into the build directory, `<repo>/build/ace_tpu_torch/`.
Libraries are named by a hash of
their sources, so an edited kernel rebuilds and an unchanged one loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
SOURCES = ("modmul", "ntt")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    # name: argtypes (pointers, sizes, flags, stream last)
    "ace_k1_barrett_mul": [_VP, _VP, _VP, _VP, _VP, _VP, _LL, _I, _I, _VP],
    "ace_k2_shoup_mul": [_VP, _VP, _VP, _VP, _VP, _LL, _I, _VP],
    "ace_k3_ntt_fwd": [_VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP],
    "ace_k4_ntt_inv": [_VP, _VP, _VP, _VP, _VP, _VP, _VP, _VP, _I, _I, _VP],
}

_libs: dict = {}
_lock = threading.Lock()


def build_dir() -> str:
    repo = os.path.dirname(os.path.dirname(_HERE))
    return os.path.join(repo, "build", "ace_tpu_torch")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(os.listdir(CSRC)):
        if f.endswith(".cuh") or f == f"{name}.cu":
            with open(os.path.join(CSRC, f), "rb") as fh:
                h.update(f.encode() + fh.read())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(build_dir(), f"lib{name}-{_digest(name)}.so")


def build_all(verbose: bool = False) -> dict:
    """Compile every source that has no library yet, all in parallel.
    Returns {source: seconds} of the compiles run (empty when cached).
    verbose: pass -Xptxas -v and print nvcc's output (registers, shared
    memory and spills per kernel)."""
    import time
    os.makedirs(build_dir(), exist_ok=True)
    jobs = {}
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
               "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out, time.perf_counter())
    times, errors = {}, []
    for name, (proc, tmp, out, t0) in jobs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if verbose and log:
            print(f"[nvcc {name}.cu]\n{log}", file=sys.stderr)
        if proc.returncode != 0:
            errors.append(f"nvcc {name}.cu failed ({proc.returncode}):\n"
                          f"{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building on first use."""
    with _lock:
        if name not in _libs:
            if not os.path.exists(_lib_path(name)):
                build_all()
            so = ctypes.CDLL(_lib_path(name))
            for fn, argtypes in _SIGNATURES.items():
                if hasattr(so, fn):
                    getattr(so, fn).argtypes = argtypes
                    getattr(so, fn).restype = ctypes.c_int
            _libs[name] = so
        return _libs[name]


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (cudaError {rc})")
