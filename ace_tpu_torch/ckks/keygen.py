"""CKKS key generation: secret/public/relin/rotation keys.

Structure of `ace_tpu.ckks.keygen` (the reference's
ckks_key_generator.c): ternary secret with optional exact hamming
weight, pk = (-(a s)+e, a), and hybrid key-switching keys with one
(b, a) pair per digit: b = -a*old_key + P*Q~_part*new_key + e over the
Q ∪ P basis (Generate_switching_key, ckks_key_generator.c:127-197;
rotation keys use the inverse automorphism of the NTT secret and swap
old/new for rotate-after-keyswitch, :238-268; the conjugation key is the
rotation key of auto index 2N-1 and shares their LRU).

Randomness: the secret, the public key and every error come from the
host generator `rng` (BLAKE2b counter-mode CSPRNG by default,
utils/csprng.py; tests may pass a seeded numpy Generator), with the
same draws as `ace_tpu`, so one seed gives the same secret and public
key in both packages. The uniform component `a` of each switching key is
drawn on the key's device from two torch.Generators, each seeded with
64 bits from `rng`: the XOR of their words makes each key's `a` a
function of 128 seed bits. It cannot reproduce `ace_tpu`'s jax.random
bits; tests that compare the packages inject keys (interop.py).

Limb shard (CrtContext.shard): every rank draws the whole of every
stream above from the same seed, so the ranks agree on every key, and
computes each key on the limbs it owns only; the rows it holds are those
of the unsharded key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.ops import modops, ntt
from ace_tpu_torch.poly import poly as P
from ace_tpu_torch.poly.poly import RnsPoly
from ace_tpu_torch.utils import number_theory as nt


@dataclasses.dataclass
class SecretKey:
    coeffs: np.ndarray          # signed ternary, length N (host)
    ntt_sk: RnsPoly             # NTT form over Q ∪ P


@dataclasses.dataclass
class PublicKey:
    b: RnsPoly                  # pk0 = -(a s) + e
    a: RnsPoly                  # pk1


@dataclasses.dataclass
class SwitchKey:
    """One (b, a) pair per KSW digit, each over the full Q ∪ P basis."""
    b: list
    a: list

    @property
    def nbytes(self) -> int:
        """Actual device bytes held by this key (all digit pairs)."""
        return sum(p.data.numel() * p.data.element_size()
                   for pair in (self.b, self.a) for p in pair)


def switch_key_nbytes(params: CkksParams) -> int:
    """Bytes of one hybrid switching key at these parameters, derived
    from the key structure (num_q_parts digits x (b, a) x (Q ∪ P) limbs
    x N words) — the sizing input for the rotation-key LRU budget."""
    num_qp = params.num_q + params.crt.num_p
    return params.num_q_parts * 2 * num_qp * params.degree * 8


def _signed_to_rns(samples: np.ndarray, primes: list[int]) -> np.ndarray:
    """Small signed ints -> canonical residue rows per prime."""
    out = []
    for q in primes:
        v = samples.astype(np.int64).copy()
        v[v < 0] += q
        out.append(v.astype(np.uint64))
    return np.stack(out)


class KeyGenerator:
    def __init__(self, params: CkksParams, rng=None,
                 max_rot_keys: int = 0):
        """Keys live on params.device. max_rot_keys: LRU capacity for
        rotation keys (0 = unbounded); evicted keys are regenerated on
        demand with fresh randomness (each switching key is an
        independent encryption of the rotated secret)."""
        self.params = params
        self.crt = params.crt
        self.device = params.device
        if rng is None:
            from ace_tpu_torch.utils.csprng import Blake2Csprng
            rng = Blake2Csprng()
        self.rng = rng
        self.max_rot_keys = max_rot_keys
        self.sk = self._gen_secret_key()
        self.pk = self._gen_public_key()
        self.relin_key = self._gen_relin_key()
        self._rot_keys: dict[int, SwitchKey] = {}

    # -- sampling (random_sample.c:39-173) -------------------------------

    def _sample_ternary(self) -> np.ndarray:
        n = self.params.degree
        hw = self.params.hamming_weight
        if hw:
            s = np.zeros(n, dtype=np.int64)
            pos = self.rng.choice(n, size=hw, replace=False)
            s[pos] = self.rng.choice(np.array([-1, 1]), size=hw)
            return s
        return self.rng.integers(-1, 2, size=n).astype(np.int64)

    def _sample_triangle(self) -> np.ndarray:
        r = self.rng.integers(0, 4, size=self.params.degree)
        return np.where(r == 0, -1, np.where(r == 1, 1, 0)).astype(np.int64)

    def _sample_uniform_qp(self) -> RnsPoly:
        crt = self.crt
        rows = [self.rng.integers(0, q, dtype=np.uint64,
                                  size=self.params.degree)
                for q in crt.q_primes + crt.p_primes]
        # fresh uniform values interpreted directly as NTT form
        # (ckks_key_generator.c:159 "skip ntt convert")
        return RnsPoly(modops.to_torch(crt.put(np.stack(rows)), self.device),
                       crt.num_q, crt.num_p, True)

    def _small_qp_poly(self, samples: np.ndarray, ntt: bool = True) -> RnsPoly:
        crt = self.crt
        data = _signed_to_rns(samples, crt.select(
            crt.all_primes, crt.limbs(crt.num_q, crt.num_p)))
        p = RnsPoly(modops.to_torch(data, self.device), crt.num_q,
                    crt.num_p, False)
        return P.to_ntt(p, crt) if ntt else p

    # -- keys ------------------------------------------------------------

    def _gen_secret_key(self) -> SecretKey:
        s = self._sample_ternary()
        return SecretKey(s, self._small_qp_poly(s))

    def _gen_public_key(self) -> PublicKey:
        crt = self.crt
        a_full = self._sample_uniform_qp()
        # public key lives over Q only (ckks_key_generator.c:100)
        kq = crt.q_rows(crt.num_q)
        a = RnsPoly(a_full.data[:kq], crt.num_q, 0, True)
        sk_q = RnsPoly(self.sk.ntt_sk.data[:kq], crt.num_q, 0, True)
        e = self._small_qp_poly(self._sample_triangle())
        e_q = RnsPoly(e.data[:kq], crt.num_q, 0, True)
        b = P.add(P.neg(P.mul(a, sk_q, crt), crt), e_q, crt)
        return PublicKey(b, a)

    def _part_scalars(self, part: int) -> list:
        """P mod q_i inside the part, 0 on other q limbs and on P limbs
        (Scalars_integer_multiply_poly_qpart)."""
        crt = self.crt
        per = crt.per_part_size
        scalars = []
        for i, q in enumerate(crt.q_primes):
            in_part = per * part <= i < min(per * (part + 1), crt.num_q)
            scalars.append(crt.big_p % q if in_part else 0)
        scalars.extend(0 for _ in crt.p_primes)
        return scalars

    def _scaled_new_key(self, new_key: RnsPoly) -> torch.Tensor:
        """[parts, L+K, N] stack of P*Q~_part * new_key — constant
        across every rotation key (new_key is always the secret key),
        so computed once and cached by object identity."""
        cache = getattr(self, "_pk_new_cache", None)
        if cache is not None and cache[0] is new_key.data:
            return cache[1]
        stack = torch.stack([
            P.mul_scalars(new_key, self._part_scalars(p), self.crt).data
            for p in range(self.crt.num_q_parts)])
        self._pk_new_cache = (new_key.data, stack)
        return stack

    def _a_generators(self):
        """Two torch.Generators on the key device, freshly seeded with 64
        bits each from the host CSPRNG stream (one pair per key)."""
        gens = []
        for _ in range(2):
            seed = int(self.rng.integers(0, 1 << 64, dtype=np.uint64))
            g = torch.Generator(device=self.device)
            g.manual_seed(seed)
            gens.append(g)
        return gens

    def _uniform_qp_words(self, shape) -> tuple:
        """(hi, lo) uniform 64-bit words (int64 bit patterns), each word
        the XOR of the two generators' draws; built from 32-bit halves."""
        g1, g2 = self._a_generators()

        def word():
            halves = []
            for _ in range(2):
                u = torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                                  device=self.device, generator=g1)
                v = torch.randint(0, 1 << 32, shape, dtype=torch.int64,
                                  device=self.device, generator=g2)
                halves.append(u ^ v)
            return (halves[0] << 32) | halves[1]

        return word(), word()

    def _gen_switching_key(self, new_key: RnsPoly,
                           old_key: RnsPoly) -> SwitchKey:
        """b_part = -a*old_key + P*Q~_part*new_key + e (NTT over Q ∪ P)."""
        crt = self.crt
        parts = crt.num_q_parts
        lk = crt.num_q + crt.num_p
        n = self.params.degree
        e_h = np.stack([self._sample_triangle() for _ in range(parts)])
        idx = crt.local(range(lk))
        q, mu_hi, mu_lo = crt.mod_arrays(idx)
        # uniform a: a 128-bit uniform word reduced mod q (Barrett-128,
        # bias <= 2^-67); `a` is a public key component. Every limb's
        # words are drawn; the shard keeps its own
        hi, lo = (crt.put(w) for w in self._uniform_qp_words((parts, lk, n)))
        a = modops.barrett_reduce_128(hi, lo, q[None], mu_hi[None],
                                      mu_lo[None])
        # the errors' residues (_signed_to_rns) formed on the device, all
        # digits' NTTs in one launch
        e = torch.as_tensor(e_h, device=self.device)[:, None, :]
        e_rns = torch.where(e < 0, q[None] + e, e).reshape(
            parts * len(idx), n)
        e_ntt = ntt.ntt_fwd(e_rns, crt.tables_for(idx * parts)
                            ).view(parts, len(idx), n)
        t = modops.barrett_mul_d(a, old_key.data[None], q[None],
                                 mu_hi[None], mu_lo[None])
        b = modops.add_mod(modops.sub_mod(e_ntt, t, q[None]),
                           self._scaled_new_key(new_key), q[None])
        return SwitchKey(
            [RnsPoly(b[i], crt.num_q, crt.num_p, True) for i in range(parts)],
            [RnsPoly(a[i], crt.num_q, crt.num_p, True) for i in range(parts)])

    def _gen_relin_key(self) -> SwitchKey:
        sk2 = P.mul(self.sk.ntt_sk, self.sk.ntt_sk, self.crt)
        return self._gen_switching_key(sk2, self.sk.ntt_sk)

    def _lru_insert(self, auto_idx: int, key: SwitchKey) -> None:
        if (auto_idx not in self._rot_keys and self.max_rot_keys
                and len(self._rot_keys) >= self.max_rot_keys):
            del self._rot_keys[next(iter(self._rot_keys))]
        self._rot_keys[auto_idx] = key  # (re)insert as most recent

    def rot_key(self, rotation: int) -> tuple[int, SwitchKey]:
        """Rotation key for slot-rotation `rotation`; returns (auto_idx,
        key). Key maps sigma_{k^-1}(s) -> s so rotation is applied after
        key-switching (ckks_key_generator.c:238-268, is_fast path).
        LRU-evicts + regenerates beyond max_rot_keys."""
        m = 2 * self.params.degree
        return self._auto_key(nt.find_automorphism_index(rotation, m))

    def all_keys(self) -> list[SwitchKey]:
        """Every evaluation key held (for the key-memory report,
        context.c:100-107)."""
        return [self.relin_key] + list(self._rot_keys.values())

    def conj_key(self) -> tuple[int, SwitchKey]:
        """Conjugation key (auto index 2N-1), held in the same LRU as the
        rotation keys (touched on use, bounded by max_rot_keys)."""
        return self._auto_key(2 * self.params.degree - 1)

    def _auto_key(self, auto_idx: int) -> tuple[int, SwitchKey]:
        """The LRU's key of automorphism auto_idx, generated from the
        inverse automorphism of the secret when absent."""
        key = self._rot_keys.pop(auto_idx, None)
        if key is None:
            from ace_tpu_torch.runtime.timing import TIMING
            with TIMING.tm("RTM_ROT_KEY_REGEN"):
                gen_idx = nt.mod_inv(auto_idx, 2 * self.params.degree)
                rotated = P.automorphism(self.sk.ntt_sk, gen_idx, self.crt)
                key = self._gen_switching_key(self.sk.ntt_sk, rotated)
        self._lru_insert(auto_idx, key)
        return auto_idx, key
