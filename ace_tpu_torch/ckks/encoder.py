"""CKKS encoder/decoder: canonical embedding with power-of-5 rot group.

Host-side (client) numpy implementation, as in ace_tpu's encoder,
replicating the reference
(fhe-cmplr/rtlib/ant/src/util/ckks_encoder.c Encode_impl 64-bit path,
Decode; ntt.c:585-753 Embedding/Embedding_inv with fft_length = 2N).

Rounding convention matches exactly: llround(x*Delta + 0.5) (ties away
from zero) and signed residues taken canonically mod each prime. Decode
reconstructs coefficients exactly with Python big ints (centered lift
mod Q_level) before the float divide — so decode precision is limited
only by the final double ops, as in the reference.

Limb shard (CrtContext.shard): encode builds this rank's rows only;
decode gathers every rank's rows in global order first.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.ops import modops
from ace_tpu_torch.poly import poly as P
from ace_tpu_torch.poly.poly import RnsPoly
from ace_tpu_torch.runtime.timing import timed


@dataclasses.dataclass
class Plaintext:
    poly: RnsPoly
    scaling_factor: float
    sf_degree: int
    slots: int

    @property
    def level(self) -> int:
        return self.poly.num_q


def _llround_interleave(to_scale: np.ndarray, scale: float, n: int,
                        slots: int, gap: int) -> np.ndarray:
    """llround(x*scale + 0.5) per slot (+0.5 bias per ckks_encoder.c:248,
    llround = ties away from zero), interleaved real/imag at `gap`.
    float64 arithmetic matches the reference's double math exactly."""
    sr = to_scale.real * scale + 0.5
    si = to_scale.imag * scale + 0.5

    def llround(v):
        return np.where(v >= 0, np.floor(v + 0.5),
                        -np.floor(-v + 0.5)).astype(np.int64)

    message = np.zeros(n, dtype=np.int64)
    idx = np.arange(slots) * gap
    message[idx] = llround(sr)
    message[idx + slots * gap] = llround(si)
    return message


def _signed_to_rns(message: np.ndarray, primes) -> np.ndarray:
    """Canonical residue rows per prime from signed int64 coefficients."""
    out = np.empty((len(primes), len(message)), dtype=np.uint64)
    neg = message < 0
    mag = np.abs(message).astype(np.uint64)
    for i, q in enumerate(primes):
        r = mag % np.uint64(q)
        out[i] = np.where(neg & (r != 0), np.uint64(q) - r, r)
    return out


def _bit_reverse_perm(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


class Encoder:
    def __init__(self, params: CkksParams, pt_cache_mb: int = 1024):
        """pt_cache_mb: budget of the encoded-plaintext LRU (ace_tpu's
        default; 0 disables)."""
        self.params = params
        n = params.degree
        self.fft_length = 2 * n
        num_slots = self.fft_length // 4  # = N/2
        self.rot_group = np.empty(num_slots, dtype=np.int64)
        self.rot_group[0] = 1
        for i in range(1, num_slots):
            self.rot_group[i] = (5 * self.rot_group[i - 1]) % self.fft_length
        ang = 2 * np.pi * np.arange(self.fft_length) / self.fft_length
        self.rou = np.cos(ang) + 1j * np.sin(ang)
        self._value_cache: dict = {}
        self.device = params.device
        # content-hash LRU over encoded weight plaintexts: static
        # weights / bootstrap diagonals are encoded once per (content,
        # level, sf_degree, extended) and reused across inferences
        import collections
        self._pt_cache: "collections.OrderedDict" = \
            collections.OrderedDict()
        self._pt_cache_bytes = 0
        # 1 GB default: the conv and bootstrap diagonals are messages,
        # kept stacked by their call sites (Evaluator.kept_msgs), so
        # this LRU only holds small mask/bias plaintexts
        self._pt_cache_budget = pt_cache_mb << 20
        self._zero_msg = None

    # -- special FFT (ntt.c:678-753) ------------------------------------

    def embedding(self, vals: np.ndarray) -> np.ndarray:
        """Slot values from coefficient-side values (decode direction)."""
        n = len(vals)
        d = np.asarray(vals, dtype=np.complex128)[_bit_reverse_perm(n)]
        logn = n.bit_length() - 1
        for logm in range(1, logn + 1):
            idx_mod = 1 << (logm + 2)
            gap = self.fft_length // idx_mod
            m = 1 << logm
            num = m // 2
            d = d.reshape(n // m, m)
            rou_idx = (self.rot_group[:num] % idx_mod) * gap
            w = self.rou[rou_idx]
            even = d[:, :num]
            odd = d[:, num:] * w[None, :]
            d = np.concatenate([even + odd, even - odd], axis=1)
        return d.reshape(n)

    def embedding_inv(self, vals: np.ndarray) -> np.ndarray:
        """Coefficient-side values from slot values (encode direction)."""
        n = len(vals)
        d = np.asarray(vals, dtype=np.complex128).copy()
        logn = n.bit_length() - 1
        for logm in range(logn, 0, -1):
            idx_mod = 1 << (logm + 2)
            gap = self.fft_length // idx_mod
            m = 1 << logm
            num = m // 2
            d = d.reshape(n // m, m)
            rou_idx = (idx_mod - (self.rot_group[:num] % idx_mod)) * gap
            w = self.rou[rou_idx]
            plus = d[:, :num] + d[:, num:]
            minus = (d[:, :num] - d[:, num:]) * w[None, :]
            d = np.concatenate([plus, minus], axis=1)
        d = d.reshape(n)[_bit_reverse_perm(n)]
        return d / n

    # -- encode / decode -------------------------------------------------

    @timed("RTM_PT_ENCODE", setup=True)
    def encode(self, values, level: int = 0, slots: int = 0,
               sf_degree: int = 1, extended: bool = False) -> Plaintext:
        """Encode complex slot values at (level, scale^sf_degree).

        Replicates Encode_impl (ckks_encoder.c:199-300): embedding_inv,
        llround(x*Delta + 0.5), slot->coefficient interleave with
        gap = N/(2*slots), RNS transform, optional Delta^(sf_degree-1)
        multiply, final NTT.

        extended: also carry residues over the P primes, so the
        plaintext can multiply extended-basis (QP) ciphertexts inside
        hoisted rotation accumulations (the reference encodes weights
        per-level the same way for its ext BSGS loops).
        """
        params = self.params
        crt = params.crt
        n = params.degree
        slots = slots or n // 2
        level = level or crt.num_q
        values = np.asarray(values, dtype=np.complex128)
        assert len(values) <= slots <= n // 2
        if len(values) < slots:
            values = np.concatenate(
                [values, np.zeros(slots - len(values), np.complex128)])

        to_scale = self.embedding_inv(values)
        delta = params.scaling_factor
        gap = n // (slots * 2)
        message = _llround_interleave(to_scale, delta, n, slots, gap)
        primes = crt.q_primes[:level] + (crt.p_primes if extended else [])
        rows = crt.limbs(level, crt.num_p if extended else 0)
        data = _signed_to_rns(message, crt.select(primes, rows))
        p = RnsPoly(modops.to_torch(data, self.device), level,
                    crt.num_p if extended else 0, False)
        if sf_degree > 1:
            idelta = int(delta)
            p = P.mul_scalars(
                p, [pow(idelta, sf_degree - 1, q) for q in primes], crt)
        p = P.to_ntt(p, crt)
        return Plaintext(p, delta ** sf_degree, sf_degree, slots)

    def encode_cached(self, values, level: int = 0, slots: int = 0,
                      sf_degree: int = 1,
                      extended: bool = False) -> Plaintext:
        """encode() with a content-addressed LRU cache — the runtime
        analog of the reference's compile-time encoding (encode/ cte):
        hot weight vectors and bootstrap diagonals encode once and stay
        device-resident."""
        if self._pt_cache_budget <= 0:
            return self.encode(values, level, slots, sf_degree, extended)
        import hashlib
        values = np.asarray(values, dtype=np.complex128)
        key = (hashlib.blake2b(values.tobytes(), digest_size=16)
               .hexdigest(), level, slots, sf_degree, extended)
        hit = self._pt_cache.pop(key, None)
        if hit is not None:
            self._pt_cache[key] = hit
            return hit
        pt = self.encode(values, level, slots, sf_degree, extended)
        nb = int(pt.poly.data.numel()) * 8
        self._pt_cache[key] = pt
        self._pt_cache_bytes += nb
        while (self._pt_cache_bytes > self._pt_cache_budget
               and len(self._pt_cache) > 1):
            _, old_pt = self._pt_cache.popitem(last=False)
            self._pt_cache_bytes -= int(old_pt.poly.data.numel()) * 8
        return pt

    # -- level-independent message encoding -----------------------------
    # The host half of encode() only (embedding_inv + llround): the
    # signed int64 coefficient message fully determines the RNS residues
    # at EVERY (level, extended) basis, so the device-side lift + NTT
    # move into the consuming bundle (evaluator rot_mac_groups_msgs)
    # and one kept [N] int64 row serves all levels. This replaces the
    # reference's per-level compile-time encoding (encode/ cte,
    # rt_data_writer.h:62-71) with something strictly smaller: the
    # message is 8N bytes vs (level+K)*8N per-level residues.

    @timed("RTM_PT_ENCODE", setup=True)
    def encode_msg(self, values, slots: int = 0) -> torch.Tensor:
        """Signed int64 coefficient message for `values` at scale Delta
        (sf_degree=1). Device [N] int64 tensor."""
        n = self.params.degree
        slots = slots or n // 2
        values = np.asarray(values, dtype=np.complex128)
        assert len(values) <= slots <= n // 2
        if len(values) < slots:
            values = np.concatenate(
                [values, np.zeros(slots - len(values), np.complex128)])
        to_scale = self.embedding_inv(values)
        gap = n // (slots * 2)
        message = _llround_interleave(
            to_scale, self.params.scaling_factor, n, slots, gap)
        return torch.as_tensor(message, device=self.device)

    def zero_msg(self) -> torch.Tensor:
        """Shared all-zero message (zero weight rows encode exactly 0)."""
        if self._zero_msg is None:
            self._zero_msg = torch.zeros(self.params.degree,
                                         dtype=torch.int64,
                                         device=self.device)
        return self._zero_msg

    def encode_value(self, value: float, level: int,
                     sf_degree: int = 1) -> Plaintext:
        """Encode a broadcast scalar (Encode_val_at_level). Cached —
        constants like the Chebyshev coefficients recur at every level."""
        key = (float(value), level, sf_degree)
        cached = self._value_cache.get(key)
        if cached is None:
            slots = self.params.degree // 2
            cached = self.encode(np.full(slots, value, np.complex128),
                                 level, slots, sf_degree)
            self._value_cache[key] = cached
        return cached

    def encode_value_with_scale(self, value: float, level: int,
                                scale: float) -> Plaintext:
        """Encode scalar at an explicit scale (Encode_val_at_level_with_scale
        -> Encode_impl_with_scale). Used by upscale: coefficients are
        llround(x*scale + 0.5) without the Delta^k structure."""
        crt = self.params.crt
        n = self.params.degree
        slots = n // 2
        values = np.full(slots, value, np.complex128)
        to_scale = self.embedding_inv(values)
        message = _llround_interleave(to_scale, scale, n, slots, 1)
        data = _signed_to_rns(message, crt.select(crt.q_primes[:level],
                                                  range(level)))
        p = P.to_ntt(RnsPoly(modops.to_torch(data, self.device), level, 0,
                             False), crt)
        return Plaintext(p, scale, 1, slots)

    def decode(self, plain: Plaintext, length: int = 0) -> np.ndarray:
        """Exact CRT reconstruction + embedding (ckks_encoder.c:649-703).

        Vectorized exact CRT: Python-int object arrays, one pass per
        limb, restricted to the 2*slots coefficient columns the message
        occupies.
        """
        crt = self.params.crt
        poly = plain.poly
        if poly.is_ntt:
            poly = P.from_ntt(poly, self.params.crt)
        level = poly.num_q
        n = poly.degree
        slots = plain.slots
        gap = (n // 2) // slots
        qs = crt.q_primes[:level]
        data = modops.to_numpy(crt.gather_poly(poly))
        idx = np.concatenate([np.arange(slots) * gap,
                              np.arange(slots) * gap + n // 2])
        cols = data[:, idx]  # [level, 2*slots]
        Q = 1
        for q in qs:
            Q *= q
        half_q = Q // 2
        hats = [Q // q for q in qs]
        hat_invs = [pow(h % q, -1, q) for h, q in zip(hats, qs)]
        # vectorized exact CRT over Python-int object arrays, one pass
        # per limb (object math only on the selected 2*slots columns)
        acc = np.zeros(2 * slots, dtype=object)
        for l in range(level):
            t = (cols[l].astype(object) * hat_invs[l]) % qs[l]
            acc += t * hats[l]
        acc %= Q
        acc = np.where(acc > half_q, acc - Q, acc)
        vals = acc.astype(np.float64) / plain.scaling_factor
        msg = vals[:slots] + 1j * vals[slots:]
        res = self.embedding(msg)
        return res[:length] if length else res
