"""BLAKE2b counter-mode CSPRNG for key material.

The reference generates all secret randomness from a BLAKE2-based
stream (rtlib/ant/src/util/prng.c:13-40) and draws uniform residues /
ternary noise from it (random_sample.c:39-173). numpy's PCG64 is not a
CSPRNG, so key generation defaults to this generator instead; it
exposes the small numpy.Generator surface KeyGenerator uses
(`integers`, `choice`) with identical call semantics.

Deterministic when seeded (tests), os.urandom-seeded otherwise.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

_BLOCK = 64  # blake2b digest size


class Blake2Csprng:
    """Counter-mode BLAKE2b keystream with numpy-style sampling."""

    def __init__(self, seed=None):
        if seed is None:
            key = os.urandom(32)
        elif isinstance(seed, int):
            key = seed.to_bytes(32, "little", signed=False) \
                if seed >= 0 else hashlib.blake2b(
                    str(seed).encode(), digest_size=32).digest()
        else:
            key = hashlib.blake2b(bytes(seed), digest_size=32).digest()
        self._key = hashlib.blake2b(key, digest_size=32).digest()
        self._ctr = 0

    def _bytes(self, n: int) -> bytes:
        """Counter-mode keystream. Bulk expansion uses the SHAKE-256
        XOF seeded with (key || counter) — one C-speed call per draw
        instead of a Python loop of 64-byte BLAKE2b blocks (a ~50x
        difference at key-generation sizes: one uniform QP polynomial
        at N=2^15 is ~14 MB of stream). SHAKE-256(k||ctr) is a
        standard PRF construction; the BLAKE2b-derived key and the
        counter discipline match the reference's posture (prng.c:13-40).
        """
        out = hashlib.shake_256(
            self._key + self._ctr.to_bytes(8, "little")).digest(n)
        self._ctr += 1
        return out

    def _u64(self, n: int) -> np.ndarray:
        return np.frombuffer(self._bytes(8 * n), dtype=np.uint64).copy()

    # -- numpy.Generator-compatible surface ------------------------------

    def integers(self, low, high=None, size=None, dtype=np.int64):
        """Uniform ints in [low, high) — numpy.Generator semantics
        (endpoint excluded), via masked rejection sampling."""
        if high is None:
            low, high = 0, low
        span = int(high) - int(low)
        if span <= 0:
            raise ValueError("high must be > low")
        n = 1 if size is None else int(np.prod(size))
        bits = max(span - 1, 1).bit_length()
        mask = np.uint64((1 << bits) - 1)
        out = np.empty(n, dtype=np.uint64)
        have = 0
        while have < n:
            need = n - have
            # oversample so one round usually suffices
            cand = self._u64(need + (need >> 2) + 8) & mask
            cand = cand[cand < span]
            take = min(len(cand), need)
            out[have:have + take] = cand[:take]
            have += take
        res = out.astype(np.int64) + int(low)
        res = res.astype(dtype)
        if size is None:
            return res[0]
        return res.reshape(size)

    def choice(self, a, size=None, replace=True):
        if isinstance(a, (int, np.integer)):
            pool = np.arange(int(a))
        else:
            pool = np.asarray(a)
        n = 1 if size is None else int(np.prod(size))
        if replace:
            idx = self.integers(0, len(pool), size=n)
            res = pool[idx]
        else:
            if n > len(pool):
                raise ValueError("cannot sample without replacement")
            # partial Fisher-Yates
            pool = pool.copy()
            for i in range(n):
                j = int(self.integers(i, len(pool)))
                pool[i], pool[j] = pool[j], pool[i]
            res = pool[:n]
        if size is None:
            return res[0]
        return res.reshape(size)
