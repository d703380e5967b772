"""Exact modular arithmetic on int64 residue tensors.

Same contracts as `ace_tpu.ops.modops` (the reference runtime's
fhe_utils.h primitives): add/sub with one conditional correction, Shoup
multiply with one correction, SEAL-style two-word Barrett-128. Every
function returns canonical residues in [0, q); torch broadcasting
applies, so per-limb modulus tensors [L, 1] act across [L, N] data.

Storage is torch.int64 (see the package docstring). Residues are below
2^61 and compare as signed values; the full-width 64-bit words (Shoup
precomputes, Barrett mu, 128-bit product halves) are unsigned bit
patterns: high products go through 32-bit halves, and their carries
through `_ult`, an unsigned compare. int64 products wrap modulo 2^64,
which is exactly the unsigned low word.

`barrett_mul` and `shoup_mul` are the plain versions of kernels K1 and
K2; callers take them through ops/pallas_modops.py, which launches the
kernels for CUDA tensors.
"""

from __future__ import annotations

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def _ult(a, b):
    """Unsigned a < b for int64 bit patterns."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def add_mod(a, b, q):
    """(a + b) mod q for a, b in [0, q), q < 2^62."""
    s = a + b
    return torch.where(s >= q, s - q, s)


def sub_mod(a, b, q):
    """(a - b) mod q for a, b in [0, q)."""
    return torch.where(a >= b, a - b, a + q - b)


def neg_mod(a, q):
    """(-a) mod q, canonical (0 stays 0)."""
    return torch.where(a == 0, a, q - a)


def mul_hi64(a, b):
    """High 64 bits of the exact unsigned 128-bit product a*b."""
    a_lo = a & _M32
    a_hi = (a >> 32) & _M32
    b_lo = b & _M32
    b_hi = (b >> 32) & _M32
    lo = a_lo * b_lo
    m1 = a_hi * b_lo
    m2 = a_lo * b_hi
    hi = a_hi * b_hi
    # carry column: bits [32, 96) of the product (< 3 * 2^32, positive)
    t = ((lo >> 32) & _M32) + (m1 & _M32) + (m2 & _M32)
    return hi + ((m1 >> 32) & _M32) + ((m2 >> 32) & _M32) + (t >> 32)


def mul_128(a, b):
    """Exact 128-bit product as (hi, lo) 64-bit words."""
    return mul_hi64(a, b), a * b


def shoup_mul(x, w, w_prec, q):
    """x*w mod q with w_prec = floor(w * 2^64 / q); x, w in [0, q)."""
    qq = mul_hi64(x, w_prec)
    r = x * w - qq * q
    return torch.where(r >= q, r - q, r)


def barrett_reduce_128(v_hi, v_lo, q, mu_hi, mu_lo):
    """(v_hi:v_lo) mod q with mu = floor(2^128 / q) as two words
    (Mod_barrett_128); two conditional subtractions."""
    left_h = mul_hi64(v_lo, mu_lo)
    mid_h, mid_l = mul_128(v_lo, mu_hi)
    tmp1 = mid_l + left_h
    carry = _ult(tmp1, left_h).to(torch.int64)
    tmp2 = mid_h + carry
    mid2_h, mid2_l = mul_128(v_hi, mu_lo)
    carry2 = _ult(mid2_l + tmp1, tmp1).to(torch.int64)
    left2 = mid2_h + carry2
    quot = v_hi * mu_hi + tmp2 + left2
    r = v_lo - quot * q
    r = torch.where(r >= q, r - q, r)
    r = torch.where(r >= q, r - q, r)
    return r


def barrett_mul(a, b, q, mu_hi, mu_lo):
    """(a * b) mod q via the 128-bit product and Barrett reduction."""
    hi, lo = mul_128(a, b)
    return barrett_reduce_128(hi, lo, q, mu_hi, mu_lo)


def mod_u64(a, q, mu_hi, mu_lo):
    """a mod q for a full-range unsigned 64-bit a (Barrett, v_hi = 0)."""
    return barrett_reduce_128(torch.zeros_like(a), a, q, mu_hi, mu_lo)


# ---------------------------------------------------------------------------
# Host-side precompute helpers (Python ints -> numpy u64 -> torch int64)
# ---------------------------------------------------------------------------

def precompute_shoup(w: int, q: int) -> int:
    """floor(w * 2^64 / q); reference Precompute_const (fhe_utils.h:378)."""
    return (w << 64) // q


def precompute_barrett128(q: int) -> tuple[int, int]:
    """mu = floor(2^128/q) as (hi, lo) words; Precompute_const_128."""
    mu = (1 << 128) // q
    return mu >> 64, mu & 0xFFFFFFFFFFFFFFFF


def np_u64(vals) -> np.ndarray:
    """Python ints -> numpy uint64 array (values must fit in 64 bits)."""
    def conv(v):
        if isinstance(v, (list, tuple)):
            return [conv(x) for x in v]
        return int(v) & 0xFFFFFFFFFFFFFFFF
    return np.array(conv(list(vals)), dtype=np.uint64)


def to_torch(arr, device=None) -> torch.Tensor:
    """numpy uint64 (or int64) residues -> torch int64 with the same bits."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    return torch.from_numpy(arr.astype(np.int64, copy=False)).to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch int64 residues -> numpy uint64 with the same bits."""
    return t.detach().cpu().numpy().view(np.uint64)
