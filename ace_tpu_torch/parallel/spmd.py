"""SPMD hybrid key switching over a ('digit', 'slot') process mesh.

`ace_tpu.parallel.spmd` on torch.distributed. ace_tpu writes the key
switch as one shard_map body; here the body is a plain function that
every rank runs on its own block:

  - 'digit' axis: each digit row of the mesh stacks ONLY its own key
    digit (1/D of every switching key: the rotation-key residency that
    motivates multi-chip, rtlib context.c:100-107), does its digit's
    mod-up and MAC, and the extended-basis accumulation is ONE all-reduce
    over the digit column (ace_tpu's psum). As in ace_tpu, the rank's
    KeyGenerator still makes and holds every full key on its device, so
    the stacks add to the key memory rather than divide it;
  - 'slot' axis: the coefficients are cut into column shards; all limb
    arithmetic is local and the NTTs of mod-up and mod-down are the
    slot-sharded 4-step (parallel/sharded_ntt.py), whose transposes are
    all_to_all exchanges over the digit row.

`axis_index("digit")` is the rank's own coordinate, so the digit's
window start = min(d*per, level-per) and the dynamic_slice windows of
ace_tpu are static slices. rotate and relinearize take the whole
ciphertext on every rank and return the whole result on every rank, as
ace_tpu's return global arrays: the automorphism follows one all_gather
over 'slot' of the two outputs.

Kernels: the digit MAC's two products go through K1
(pallas_modops.barrett_mul), the ladders' twiddle products and
mod-down's P^-1 product through K2 (pallas_modops.shoup_mul); base
conversion through K5 (poly._base_conv_data), on the column shard's
[rows, R * C/s] rows.

Residues are int64. The digit sum wraps modulo 2^64 and its D terms
are canonical, so it is exact while D * max(q) < 2^64; the D - 1
conditional subtractions after it compare as unsigned (modops._ult), so
sums past 2^63 (which a signed compare would misread) stay exact.

Op programs. rotate and relinearize each run one program, cached in
`_jit_cache` under ace_tpu's keys "rot" and "relin"
(utils/liftgraph.py): on the card a chain of CUDA graphs split at the
body's collectives (2 all_to_all per sharded NTT, the digit all_reduce
and the slot all_gather; a one-rank axis under gloo staging is no
collective), which run eagerly between the segments' replays. The key
blocks and the automorphism order are copied in at each call, as
ace_tpu passes kb, ka and its maps as arguments, so the programs read
no key by reference and need no eviction hook. `switches` counts in the
wrappers, at every call.

Bit-exactness contract: SpmdKeySwitch.rotate == Evaluator.rotate on the
same keys (tests/test_torch_spmd.py, against ace_tpu's SpmdKeySwitch).
The digit's own rows of the base conversion use the identity
conv(x)_j == x_j (q_j | Q_part), so every digit extends to the whole QP
basis with one matrix instead of the reference's splice: same values.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ace_tpu_torch.ckks.cipher import Ciphertext
from ace_tpu_torch.ops import modops, pallas_modops as pm
from ace_tpu_torch.parallel import sharded_ntt as SN
from ace_tpu_torch.poly.poly import RnsPoly, _base_conv_data
from ace_tpu_torch.utils.liftgraph import GraphPool, lift_graph


def window_constants(crt, level: int) -> dict:
    """Per-digit constants in WINDOW coordinates (ace_tpu's
    SpmdKeySwitch.__init__): digit d's part iNTT reads chain rows
    [start, start + per) with start = min(d*per, level - per), and its
    own limbs sit at window positions [d*per - start, ... + size).
    Returns numpy uint64 `hat_inv` and `hat_prec` [D, per], `mat`
    [D, QP, per] (the base-conversion matrix to the live QP basis,
    P limbs at [level, level + K)), `part_q` [D, per] and `start` [D]."""
    D = crt.num_decomp(level)
    per = crt.per_part_size
    qp_primes = list(crt.q_primes[:level]) + list(crt.p_primes)
    QP = len(qp_primes)
    if level < per:
        raise ValueError("the level must cover one full digit")
    hat_inv = np.zeros((D, per), dtype=np.uint64)
    hat_prec = np.zeros((D, per), dtype=np.uint64)
    mat = np.zeros((D, QP, per), dtype=np.uint64)
    part_q = np.zeros((D, per), dtype=np.uint64)
    start = np.zeros(D, dtype=np.int64)
    for d in range(D):
        part_qs = [int(q) for q in crt.parts[d]][:max(0, level - per * d)]
        sz = len(part_qs)
        st = min(d * per, level - per)
        off = d * per - st
        start[d] = st
        part_q[d] = qp_primes[st:st + per]
        hi = crt.part_hat_inv_mod_q[d][sz - 1]
        m = crt.part_hat_mod_compl[level - 1][d]
        for i in range(sz):
            v = int(hi[i])
            hat_inv[d, off + i] = v
            hat_prec[d, off + i] = (v << 64) // part_qs[i]
            for j, g in enumerate(crt.compl_indices[level - 1][d]):
                # compl_indices are in all-primes coordinates; P limbs
                # sit at [level, level + K) in the live basis
                gl = g if g < level else level + (g - crt.num_q)
                mat[d, gl, off + i] = int(m[i][j])
        qpart = 1
        for q in part_qs:
            qpart *= q
        for i, q in enumerate(part_qs):
            # own-part rows: exact diagonal (u * Q_part == 0 mod q)
            mat[d, d * per + i, off + i] = (qpart // q) % q
    return {"hat_inv": hat_inv, "hat_prec": hat_prec, "mat": mat,
            "part_q": part_q, "start": start}


def reduce_digit_sum(e: torch.Tensor, q: torch.Tensor, terms: int
                     ) -> torch.Tensor:
    """A sum of `terms` canonical residues (an int64 sum, i.e. modulo
    2^64) back to [0, q): terms - 1 conditional subtractions, compared
    as unsigned so that sums at or above 2^63 stay exact."""
    for _ in range(terms - 1):
        e = torch.where(modops._ult(e, q), e, e - q)
    return e


def chain_tables(crt) -> SN.ShardedNttTables:
    """Sharded NTT tables of the whole Q ∪ P chain, built once per CRT
    context; each level's key switch selects its rows."""
    return crt.memo(("sharded_ntt_tables",), lambda:
                    SN.make_sharded_ntt_tables(crt.all_primes, crt.degree,
                                               crt.device))


class SpmdKeySwitch:
    """The SPMD key switch at one (level, mesh), this rank's part of it."""

    def __init__(self, params, level: int, mesh, programs: bool = True,
                 pool=None):
        """programs: run rotate and relinearize as op programs (see the
        module docstring) on `pool` (a utils.liftgraph.GraphPool, e.g.
        an evaluator's; None makes one); False runs them eagerly."""
        crt = params.crt
        self.params, self.crt, self.level, self.mesh = params, crt, level, mesh
        self.n = params.degree
        self.num_digits = crt.num_decomp(level)
        if mesh.num_digits != self.num_digits:
            raise ValueError("the mesh's digit axis must equal the live "
                             f"q-part count ({self.num_digits} at level "
                             f"{level}), not {mesh.num_digits}")
        self.s = mesh.num_slot
        per = crt.per_part_size
        qp_primes = list(crt.q_primes[:level]) + list(crt.p_primes)
        QP = len(qp_primes)
        self.QP, self.per = QP, per
        if self.num_digits * max(qp_primes) >= 1 << 64:
            raise ValueError("the digit sum of canonical residues would "
                             "overflow 64 bits")
        full = chain_tables(crt)
        R, C = full.shape_rc
        self.R, self.C = R, C
        if C % self.s or R % self.s:
            raise ValueError(f"{self.s} slot shards do not divide [{R}, {C}]")
        mine = full.shard(mesh.slot, self.s)
        self.tabs = mine._make(torch.cat([f[:level], f[crt.num_q:]])
                               for f in mine)
        # this rank's digit window (the others' are other ranks')
        w = window_constants(crt, level)
        d = mesh.digit
        self.start = int(w["start"][d])
        self.window_qs = [int(q) for q in w["part_q"][d]]
        self.window_hat_inv = [int(v) for v in w["hat_inv"][d]]
        self.window_mat = [[int(v) for v in row] for row in w["mat"][d]]
        self.qp_primes = qp_primes
        self.q3 = crt.mod_arrays(range(level))[0][:, :, None]
        qp = crt.mod_arrays(list(range(level))
                            + [crt.num_q + j for j in range(crt.num_p)])
        self.qp3, self.mu_hi3, self.mu_lo3 = (x[:, :, None] for x in qp)
        p_inv = [int(v) for v in crt.p_inv_mod_q[:level]]
        self.p_inv = crt.column(p_inv)[:, :, None]
        self.p_inv_prec = crt.column(
            [modops.precompute_shoup(v, q)
             for v, q in zip(p_inv, crt.q_primes[:level])])[:, :, None]
        self._resident = {}  # id(SwitchKey) -> (kb, ka)
        self.switches = 0    # key switches this rank took part in
        # the programs' pool, None with programs off
        self.pool = (pool or GraphPool(crt.device)) if programs else None
        self._jit_cache = {}  # "rot", "relin" -> program (ace_tpu's keys)

    # -- per-digit key residency -------------------------------------------

    def _key_stack(self, key):
        """This rank's [QP, R, C/s] blocks of its digit of `key` (b and
        a): 1/(D*s) of the key's bytes. Kept while the key object lives
        (the rotation-key LRU may drop it)."""
        hit = self._resident.get(id(key))
        if hit is not None:
            return hit
        d, k, cl = self.mesh.digit, self.mesh.slot, self.C // self.s
        nq = self.crt.num_q

        def block(kp):
            data = torch.cat([kp.data[:self.level], kp.data[nq:]])
            return data.reshape(self.QP, self.R, self.C)[
                :, :, k * cl:(k + 1) * cl].contiguous()

        hit = self._resident[id(key)] = (block(key.b[d]), block(key.a[d]))
        weakref.finalize(key, self._resident.pop, id(key), None)
        return hit

    def key_memory_resident_bytes(self) -> int:
        """Bytes in this rank's key stacks (ace_tpu: total / D / s); the
        full keys its KeyGenerator holds are not counted."""
        return sum(kb.numel() * kb.element_size()
                   + ka.numel() * ka.element_size()
                   for kb, ka in self._resident.values())

    # -- the per-rank body ---------------------------------------------------

    def _local(self, x: torch.Tensor) -> torch.Tensor:
        """[level, N] -> this rank's [level, R, C/s] column shard."""
        cl = self.C // self.s
        k = self.mesh.slot
        return x.reshape(-1, self.R, self.C)[:, :, k * cl:(k + 1) * cl]

    def _mod_down(self, e):
        level, t, mesh = self.level, self.tabs, self.mesh
        crt = self.crt
        R, cl = self.R, self.C // self.s
        p_rows = SN.ntt_inv_local(e[level:], t.rows(slice(level, None)),
                                  mesh)
        conv = _base_conv_data(
            p_rows.reshape(crt.num_p, R * cl), list(crt.p_primes),
            list(crt.q_primes[:level]), crt.p_hat_inv_mod_p,
            crt.p_hat_mod_q[:level], crt).reshape(level, R, cl)
        conv = SN.ntt_fwd_local(conv, t.rows(slice(0, level)), mesh)
        diff = modops.sub_mod(e[:level], conv, self.q3)
        return pm.shoup_mul(diff, self.p_inv, self.p_inv_prec, self.q3)

    def _switch(self, c0, c1, tgt, kb, ka, rotate: bool):
        """One hybrid key switch of `tgt` ([level, N], NTT form) against
        this rank's key blocks kb, ka: [2, level, N], the whole result on
        every rank. rotate=False: relinearize semantics, (s0 + c0,
        s1 + c1); True: (s0 + c0, s1), before the automorphism."""
        level, per, mesh, t = self.level, self.per, self.mesh, self.tabs
        R, cl = self.R, self.C // self.s
        part = self._local(tgt)[self.start:self.start + per]
        part = SN.ntt_inv_local(part, t.rows(
            slice(self.start, self.start + per)), mesh)
        # base conversion of the digit to the whole QP basis
        ext = _base_conv_data(part.reshape(per, R * cl), self.window_qs,
                              self.qp_primes, self.window_hat_inv,
                              self.window_mat, self.crt
                              ).reshape(self.QP, R, cl)
        ext = SN.ntt_fwd_local(ext, t, mesh)
        # digit MAC against this rank's key digit, then ONE digit sum
        e = mesh.all_reduce_digit(torch.stack([
            pm.barrett_mul(ext, kb, self.qp3, self.mu_hi3, self.mu_lo3),
            pm.barrett_mul(ext, ka, self.qp3, self.mu_hi3, self.mu_lo3)]))
        e = reduce_digit_sum(e, self.qp3, self.num_digits)
        s0, s1 = self._mod_down(e[0]), self._mod_down(e[1])
        t0 = modops.add_mod(s0, self._local(c0), self.q3)
        t1 = s1 if rotate else modops.add_mod(s1, self._local(c1), self.q3)
        both = mesh.all_gather_slot(torch.stack([t0, t1]), dim=3)
        return both.reshape(2, level, self.n)

    # -- programs (ace_tpu's _jit_cache: "rot" and "relin") -------------------

    def _program(self, kind: str):
        """The program of `kind`, built at its first use: a function of
        the ciphertext data, this rank's key blocks and (rot) the
        automorphism's order, all copied in, so that one program serves
        every rotation at this level, as ace_tpu's one jitted shard_map
        body does."""
        if kind not in self._jit_cache:
            ks = weakref.proxy(self)
            if kind == "rot":
                def impl(c0, c1, kb, ka, order):
                    both = ks._switch(c0, c1, c1, kb, ka, True)
                    both = both.index_select(2, order)
                    return both[0], both[1]
            else:
                def impl(c0, c1, c2, kb, ka):
                    both = ks._switch(c0, c1, c2, kb, ka, False)
                    return both[0], both[1]
            self._jit_cache[kind] = (impl if self.pool is None
                                     else lift_graph(impl, self.pool))
        return self._jit_cache[kind]

    # -- ops -----------------------------------------------------------------

    def _result(self, d0, d1, like) -> Ciphertext:
        return Ciphertext(RnsPoly(d0, self.level, 0, True),
                          RnsPoly(d1, self.level, 0, True),
                          like.scaling_factor, like.sf_degree, like.slots)

    def rotate(self, ct, rotation: int, keygen) -> Ciphertext:
        """SPMD rotate: bit-exact against Evaluator.rotate."""
        auto_idx, key = keygen.rot_key(rotation)
        if ct.level != self.level:
            raise ValueError(f"ciphertext at level {ct.level}, key switch "
                             f"at {self.level}")
        kb, ka = self._key_stack(key)
        d0, d1 = self._program("rot")(ct.c0.data, ct.c1.data, kb, ka,
                                      self.crt.auto_order(auto_idx))
        self.switches += 1
        return self._result(d0, d1, ct)

    def relinearize(self, c3, keygen) -> Ciphertext:
        """SPMD relinearize of a 3-term ciphertext: key-switch c2 with the
        relinearization key and add (c0, c1). Bit-exact against
        Evaluator.relinearize."""
        if c3.c2.num_q != self.level:
            raise ValueError(f"c2 at level {c3.c2.num_q}, key switch at "
                             f"{self.level}")
        kb, ka = self._key_stack(keygen.relin_key)
        d0, d1 = self._program("relin")(c3.c0.data, c3.c1.data, c3.c2.data,
                                        kb, ka)
        self.switches += 1
        return self._result(d0, d1, c3)
