"""Async block reader over the native io_uring loader.

The `ace_tpu.runtime.block_io` analog of the reference runtime's block IO
subsystem (rtlib common/src/block_io_linux.c:10-22 — io_uring reads that
stage pre-encoded plaintext blobs ahead of the generated program's op
stream). `PtManager` submits reads for upcoming weight entries and only
blocks when the op actually needs the bytes.

The native engine is `ace_tpu_torch/native/block_io.cc` (raw io_uring
syscalls; it falls back to a pread thread pool when io_uring is
unavailable, e.g. under seccomp; `AsyncBlockLoader.engine` says which
runs). `g++` builds it on first use into the build directory of the CUDA
kernels, `<repo>/build/ace_tpu_torch/`, under a name carrying a hash of
the source, and ctypes loads it. A failed build or open raises.
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
    __file__))), "native", "block_io.cc")
_CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]
_lib = None
_lock = threading.Lock()


def lib_path() -> str:
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir(), f"libblock_io-{h.hexdigest()[:16]}.so")


def get_lib() -> ctypes.CDLL:
    """The loaded host library, built with g++ when it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            so = lib_path()
            if not os.path.exists(so):
                os.makedirs(build_dir(), exist_ok=True)
                tmp = f"{so}.{os.getpid()}.tmp"
                out = subprocess.run(["g++", *_CXX_FLAGS, "-o", tmp, _SRC],
                                     capture_output=True, text=True)
                if out.returncode != 0:
                    raise RuntimeError(
                        f"g++ block_io.cc failed ({out.returncode}):\n"
                        f"{out.stdout}{out.stderr}")
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.bio_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.bio_open.restype = ctypes.c_int
            lib.bio_engine.argtypes = [ctypes.c_int]
            lib.bio_engine.restype = ctypes.c_int
            lib.bio_submit.argtypes = [ctypes.c_int, ctypes.c_uint64,
                                       ctypes.c_uint64, ctypes.c_void_p]
            lib.bio_submit.restype = ctypes.c_int64
            lib.bio_wait.argtypes = [ctypes.c_int, ctypes.c_uint64]
            lib.bio_wait.restype = ctypes.c_int64
            lib.bio_close.argtypes = [ctypes.c_int]
            lib.bio_close.restype = None
            _lib = lib
    return _lib


class AsyncBlockLoader:
    """Token-based async reads of (offset, nbytes) extents of one file."""

    def __init__(self, path: str, queue_depth: int = 32):
        self._h = -1
        self._lib = get_lib()
        self._h = self._lib.bio_open(path.encode(), queue_depth)
        if self._h < 0:
            raise OSError(f"bio_open failed for {path!r}")
        self._bufs: dict[int, np.ndarray] = {}

    @property
    def engine(self) -> str:
        return "io_uring" if self._lib.bio_engine(self._h) == 1 \
            else "threadpool"

    def submit(self, offset: int, nbytes: int) -> int:
        """Start reading [offset, offset+nbytes); returns a wait token."""
        buf = np.empty(nbytes, dtype=np.uint8)
        tok = self._lib.bio_submit(self._h, offset, nbytes,
                                   buf.ctypes.data_as(ctypes.c_void_p))
        if tok < 0:
            raise OSError("bio_submit failed")
        self._bufs[tok] = buf
        return int(tok)

    def wait(self, token: int) -> np.ndarray:
        """Block until the read for `token` completes; returns the bytes."""
        buf = self._bufs.pop(token)
        got = self._lib.bio_wait(self._h, token)
        if got != buf.size:
            raise OSError(f"short read: {got} of {buf.size} bytes")
        return buf

    def close(self):
        if self._h >= 0:
            self._lib.bio_close(self._h)
            self._h = -1

    def __del__(self):
        self.close()
