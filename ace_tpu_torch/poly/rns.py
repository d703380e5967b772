"""CRT context: RNS prime chains and all host-side precomputes.

The CRT_CONTEXT of `ace_tpu.poly.rns` (the reference's crt.h:873-878,
src/util/crt.c): the same prime chains and Python-int tables. Device
constants (per-limb moduli, Barrett words, NTT tables, automorphism
orders, small per-op constant columns) are built once on the context's
`device` and cached.

Semantics replicated exactly (same prime chains, same tables):
  - Q/P prime generation:    crt.c:16-126 (+ 2N-step search)
  - Precompute_primes:       crt.c:206-330 (hat_inv per level, rescale consts)
  - Precompute_new_base:     crt.c:332-381 (hat matrices between bases)
  - Precompute_qpart:        crt.c:383-424 (hybrid-KSW digit partition, num_p
                             = ceil(max_part_bits / AUXBITS), AUXBITS=60
                             per fhe_types.h:28)
  - Precompute_qpart_new_base: crt.c:426-533 (per-level digit hat tables and
                             complement bases)

The limb shard. `shard(mesh)` puts the context on a parallel.mesh
LimbMesh: every RnsPoly of the context then holds only this rank's rows,
the limbs g (q_i is g = i, p_j is g = num_q + j) with g mod n_limb equal
to the rank's limb coordinate, in ascending global order. Every [:level]
prefix of the chain is then a prefix of the local rows (`q_rows`), so a
rescale or a level drop moves no data. The helpers below (`limbs`,
`local`, `q_rows`, `select`, `put`, `gather`, `bcast_row`) are the
identity without a mesh, so one code path serves both cases.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from ace_tpu_torch.ops import modops, ntt
from ace_tpu_torch.utils import number_theory as nt

AUXBITS = 60


def _prod(xs: Sequence[int]) -> int:
    r = 1
    for x in xs:
        r *= x
    return r


class CrtContext:
    """Prime chains + precomputed tables for one CKKS parameter set.

    Limb index convention: the "full chain" is q_0..q_{L-1}, p_0..p_{K-1};
    global index of p_j is num_q + j. NTT tables are built once for the
    full chain and sliced/gathered per op.
    """

    def __init__(self, num_q: int, first_mod_size: int, scaling_mod_size: int,
                 degree: int, num_q_parts: int, device=None):
        """device: None is the card (and raises without one); pass "cpu"
        for the plain versions."""
        from ace_tpu_torch import resolve_device
        self.device = resolve_device(device)
        self.mesh = None  # a LimbMesh once shard() is called
        self.degree = degree
        self.num_q = num_q
        self.num_q_parts = num_q_parts
        self.first_mod_size = first_mod_size
        self.scaling_mod_size = scaling_mod_size

        self.q_primes = nt.generate_q_primes(
            num_q, first_mod_size, scaling_mod_size, degree)

        # hybrid key-switching digit partition (crt.c:383-424)
        self.per_part_size = math.ceil(num_q / num_q_parts)
        self.parts = [
            self.q_primes[j * self.per_part_size:
                          min((j + 1) * self.per_part_size, num_q)]
            for j in range(num_q_parts)
        ]
        max_bits = max(_prod(part).bit_length() for part in self.parts)
        self.num_p = math.ceil(max_bits / AUXBITS)
        self.p_primes = nt.generate_p_primes(
            self.num_p, AUXBITS, degree, self.q_primes)

        self.all_primes = self.q_primes + self.p_primes
        self.big_p = _prod(self.p_primes)

        self._precompute_q()
        self._precompute_p()
        self._precompute_qpart()

        # full-chain NTT tables (device tensors), built lazily
        self._ntt_tables = None
        self._auto_order_cache = {}
        self._const_cache = {}

    # -- basic accessors ---------------------------------------------------

    @property
    def ntt_tables(self) -> ntt.NttTables:
        if self._ntt_tables is None:
            self._ntt_tables = ntt.make_ntt_tables(self.all_primes,
                                                   self.degree, self.device)
        return self._ntt_tables

    def tables_for(self, idx) -> ntt.NttTables:
        """NTT tables selecting the global limbs `idx` (cached)."""
        key = ("tables", tuple(idx))
        if key not in self._const_cache:
            self._const_cache[key] = ntt.gather_tables(self.ntt_tables, idx)
        return self._const_cache[key]

    def memo(self, key, build):
        """The object cached under `key`; `build()` makes it on a miss."""
        hit = self._const_cache.get(key)
        if hit is None:
            hit = self._const_cache[key] = build()
        return hit

    def const(self, key, build):
        """A device tensor cached under `key`; `build()` returns the numpy
        (uint64 or int64) array on a miss."""
        return self.memo(key, lambda: modops.to_torch(build(), self.device))

    def column(self, vals) -> torch.Tensor:
        """Python ints -> cached [len, 1] int64 column on the device."""
        vals = tuple(int(v) for v in vals)
        return self.const(("col", vals),
                          lambda: modops.np_u64(vals).reshape(-1, 1))

    def mod_arrays(self, idx) -> tuple:
        """(q, mu_hi, mu_lo) tensors [len(idx), 1] for global limbs idx."""
        idx = tuple(idx)
        key = ("mods", idx)
        if key not in self._const_cache:
            qs = [self.all_primes[i] for i in idx]
            mus = [modops.precompute_barrett128(v) for v in qs]
            self._const_cache[key] = (
                self.column(qs), self.column([m[0] for m in mus]),
                self.column([m[1] for m in mus]))
        return self._const_cache[key]

    def auto_order(self, auto_idx: int) -> torch.Tensor:
        """NTT-form automorphism gather indices (number_theory.c:201-214)."""
        key = auto_idx
        if key not in self._auto_order_cache:
            self._auto_order_cache[key] = torch.as_tensor(
                np.asarray(nt.precompute_auto_order(auto_idx, self.degree),
                           dtype=np.int64), device=self.device)
        return self._auto_order_cache[key]

    # -- limb shard ---------------------------------------------------------

    def shard(self, mesh) -> None:
        """Limb-shard every poly of this context over `mesh` (a
        parallel.mesh.LimbMesh). A context is sharded once, before any
        poly of it is made."""
        if self.mesh is not None and self.mesh is not mesh:
            raise ValueError("this CRT context is already sharded over "
                             "another mesh")
        if mesh.device.type != self.device.type:
            raise ValueError(f"mesh on {mesh.device}, CRT context on "
                             f"{self.device}")
        self.mesh = mesh

    @property
    def sharded(self) -> bool:
        """True when polys hold a strict subset of their limbs."""
        return self.mesh is not None and self.mesh.n_limb > 1

    def limbs(self, num_q: int, num_p: int) -> list:
        """Global limb indices of a poly over q_0..q_{num_q-1} and
        p_0..p_{num_p-1}."""
        return list(range(num_q)) + [self.num_q + j for j in range(num_p)]

    def owns(self, g: int) -> bool:
        return not self.sharded or self.mesh.owns(g)

    def local(self, rows) -> list:
        """The global limbs of `rows` that this rank holds, in order."""
        return [g for g in rows if self.owns(g)]

    def select(self, vals, rows) -> list:
        """The entries of `vals` (one per global limb of `rows`) at the
        limbs this rank holds."""
        vals = list(vals)
        assert len(vals) == len(rows), (len(vals), len(rows))
        return [v for v, g in zip(vals, rows) if self.owns(g)]

    def q_rows(self, level: int) -> int:
        """Local rows of the q limbs below `level`: the length of the
        local prefix that the chain's [:level] prefix is."""
        if not self.sharded:
            return level
        n, r = self.mesh.n_limb, self.mesh.limb
        return max(0, (level - r + n - 1) // n)

    def put(self, data, rows=None):
        """This rank's rows of `data` [..., len(rows), N] (global limbs
        `rows`, default 0..L-1): parallel.mesh.put_limb."""
        if not self.sharded:
            return data
        from ace_tpu_torch.parallel.mesh import put_limb
        return put_limb(data, self.mesh, rows)

    def gather(self, data: torch.Tensor, rows) -> torch.Tensor:
        """All of [len(rows), N] in `rows`' order from every limb rank's
        local rows `data` (the rows it owns, in order): one all-gather
        over the limb axis."""
        if not self.sharded:
            return data
        rows = list(rows)
        n = self.mesh.n_limb
        counts = [0] * n
        pos = []
        for g in rows:
            pos.append((g % n, counts[g % n]))
            counts[g % n] += 1
        m = max(counts)
        if m == 0:
            return data
        parts = self.mesh.all_gather_limb(data, m)     # [n, m, N]
        flat = parts.reshape(n * m, *parts.shape[2:])
        idx = torch.as_tensor([r * m + i for r, i in pos], dtype=torch.int64,
                              device=flat.device)
        return flat.index_select(0, idx)

    def gather_poly(self, p) -> torch.Tensor:
        """All residues [num_q + num_p, N] of RnsPoly p in global order."""
        return self.gather(p.data, self.limbs(p.num_q, p.num_p))

    def bcast_row(self, row, g: int) -> torch.Tensor:
        """Limb g's row [1, N]: `row` on its owner (None elsewhere), sent
        to every limb rank."""
        if not self.sharded:
            return row
        if row is None:
            row = torch.empty((1, self.degree), dtype=torch.int64,
                              device=self.device)
        return self.mesh.broadcast_limb(row, g % self.mesh.n_limb)

    # -- precomputes -------------------------------------------------------

    def _precompute_q(self):
        qs = self.q_primes
        L = self.num_q
        # hat_inv_mod_self[level][l] = (prod_{h<=level, h!=l} q_h)^-1 mod q_l
        # (crt.c:233-263; level = index of highest live limb)
        self.q_hat_inv_mod_q = []
        for level in range(L):
            row = []
            for l in range(level + 1):
                hat = 1
                for h in range(level + 1):
                    if h != l:
                        hat = hat * qs[h] % qs[l]
                row.append(nt.mod_inv(hat, qs[l]))
            self.q_hat_inv_mod_q.append(row)

        # rescale constants (crt.c:265-330). Index k drops prime q_{k+1}.
        M = _prod(qs)
        self.ql_inv_mod_qi = []     # [k][i] = q_{k+1}^-1 mod q_i
        self.ql_div2_mod_qi = []    # [k][i] = (q_{k+1}/2) mod q_i
        self.ql_ql_inv_mod_ql_div_ql_mod_qi = []
        for k in range(L - 1):
            lvl = k + 1
            last = qs[lvl]
            hat = M // last
            hat_inv_mod_last = nt.mod_inv(hat % last, last)
            big = hat_inv_mod_last * hat // last
            self.ql_inv_mod_qi.append(
                [nt.mod_inv(last, qs[i]) for i in range(lvl)])
            self.ql_div2_mod_qi.append(
                [(last >> 1) % qs[i] for i in range(lvl)])
            self.ql_ql_inv_mod_ql_div_ql_mod_qi.append(
                [big % qs[i] for i in range(lvl)])

    def _precompute_p(self):
        ps = self.p_primes
        qs = self.q_primes
        P = self.big_p
        # P-base hats (crt.c:233-263 with Is_q=false: single level, all K)
        self.p_hat_inv_mod_p = [
            nt.mod_inv((P // p) % p, p) for p in ps]
        # Precompute_new_base(P, Q) (crt.c:332-381): conversions P -> Q
        self.p_hat_mod_q = [[(P // p) % q for p in ps] for q in qs]  # [q][p]
        self.p_inv_mod_q = [nt.mod_inv(P % q, q) for q in qs]
        self.p_mod_q = [P % q for q in qs]
        # Precompute_new_base(Q, P): conversions Q_level -> P
        # q_hat_mod_p[level][p][l] = (prod_{h<=level,h!=l} q_h) mod p
        self.q_hat_mod_p = []
        for level in range(self.num_q):
            mat = []
            for p in ps:
                row = []
                for l in range(level + 1):
                    hat = 1
                    for h in range(level + 1):
                        if h != l:
                            hat = hat * (qs[h] % p) % p
                    row.append(hat)
                mat.append(row)
            self.q_hat_mod_p.append(mat)

    def _precompute_qpart(self):
        qs = self.q_primes
        ps = self.p_primes
        per = self.per_part_size
        # l_hat_inv_modq[j][sz-1][i]: within part j truncated to sz primes
        # (crt.c:437-461)
        self.part_hat_inv_mod_q = []
        for j, part in enumerate(self.parts):
            by_size = []
            for sz in range(1, len(part) + 1):
                mod_part = _prod(part[:sz])
                by_size.append([
                    nt.mod_inv((mod_part // part[i]) % part[i], part[i])
                    for i in range(sz)])
            self.part_hat_inv_mod_q.append(by_size)

        # complement bases (crt.c:463-494): compl[l][j] = global limb indices
        # of {Q_l \ part_j} ∪ P
        num_q = self.num_q
        self.compl_indices = []
        for l in range(num_q):
            dim2 = math.ceil((l + 1) / per)
            rows = []
            for j in range(dim2):
                num_part_qj = len(self.parts[j])
                if j == dim2 - 1:
                    num_part_qj = (l + 1) - j * per
                n_q_compl = (l + 1) - num_part_qj
                idxs = []
                for k in range(n_q_compl + self.num_p):
                    if k < n_q_compl:
                        cur = k // per
                        if cur >= j:
                            cur += 1
                        idxs.append(cur * per + (k % per))
                    else:
                        idxs.append(num_q + (k - n_q_compl))
                rows.append(idxs)
            self.compl_indices.append(rows)

        # l_hat_modp[l][k][i][j] (crt.c:496-533): digit hat matrix from
        # (truncated) part k to its complement basis at level l
        self.part_hat_mod_compl = []
        for l in range(num_q):
            dim2 = math.ceil((l + 1) / per)
            by_part = []
            for k in range(dim2):
                part = self.parts[k]
                num_part_qk = len(part)
                if k == dim2 - 1:
                    num_part_qk = l + 1 - k * per
                mod_part = _prod(part[:num_part_qk])
                compl = [self.all_primes[g] for g in self.compl_indices[l][k]]
                mat = []
                for i in range(num_part_qk):
                    hat = mod_part // part[i]
                    mat.append([hat % c for c in compl])
                by_part.append(mat)
            self.part_hat_mod_compl.append(by_part)

    def num_decomp(self, num_q_live: int) -> int:
        """Number of KSW digits for a ciphertext with num_q_live limbs."""
        return min(math.ceil(num_q_live / self.per_part_size),
                   self.num_q_parts)
