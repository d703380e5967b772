"""CKKS homomorphic evaluator: the scheme-op layer.

The Evaluator of `ace_tpu.ckks.evaluator` (the reference's
ckks_evaluator.c) as eager PyTorch: the jitted op bundles of the JAX
package become plain methods, its lax.scan over weight groups a Python
loop. Every op keeps the JAX package's order of operations, so residues
match it bit for bit on the same keys.

Exact-semantics sources (file:line in the reference):
  encrypt/decrypt:   ckks_encryptor.c:20-75, ckks_decryptor.c:18-57
  add/sub/plain ops: ckks_evaluator.c:37-215
  mul (ciph3):       ckks_evaluator.c:181-226 (c0c0', c0c1'+c1c0', c1c1')
  relinearize:       ckks_evaluator.c:258-270 (switch-key on c2 + add)
  rescale:           ckks_evaluator.c:309-329 (+ scale bookkeeping)
  hybrid keyswitch:  ckks_evaluator.c:391-461 (digit MACs in QP basis,
                     then mod-down); digits via Decompose/Raise
  rotate/conjugate:  ckks_evaluator.c:507-545 (keyswitch c1, add c0,
                     then automorphism of both outputs; 2N-1 conjugates)
  mul_by_monomial:   ckks_evaluator.c:228-256
  bsgs_iter_jit:     ckks_bootstrap_context.c:1237-1383 (Rotate_iteration)

Limb shard (FheContext(mesh=...), CrtContext.shard): every poly holds
this rank's rows only; the ops below take limb positions from the CRT
context's helpers (q_rows, local, limbs), never from a global index, so
the same code runs sharded and unsharded. Communication happens inside
poly.py's conversions only.
"""

from __future__ import annotations

import numpy as np
import torch

from ace_tpu_torch.ckks.cipher import Ciphertext, Ciphertext3
from ace_tpu_torch.ckks.encoder import Encoder, Plaintext
from ace_tpu_torch.ckks.keygen import KeyGenerator, SwitchKey
from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.ops import modops, ntt
from ace_tpu_torch.poly import poly as P
from ace_tpu_torch.poly.poly import RnsPoly


class Evaluator:
    def __init__(self, params: CkksParams, keygen: KeyGenerator,
                 encoder: Encoder, max_bundle: int = 5,
                 max_bundle_msg: int = 12):
        """max_bundle: rotations per rot_sum_jit and
        rot_ext_mac_groups_jit accumulation;
        max_bundle_msg: rotations per rot_mac_groups_msgs_jit bundle.
        Larger sets are chunked and the mod-downed partials summed, as
        in ace_tpu (whose defaults these are), which keeps the residues
        identical to it and bounds the live extended-basis workspace."""
        self.params = params
        self.crt = params.crt
        self.keygen = keygen
        self.encoder = encoder
        self.max_bundle = max_bundle
        self.max_bundle_msg = max_bundle_msg

    # -- encrypt / decrypt ----------------------------------------------

    def encrypt(self, plain: Plaintext) -> Ciphertext:
        kg = self.keygen
        crt = self.crt
        level = plain.poly.num_q
        v = kg._small_qp_poly(kg._sample_triangle())
        e0 = kg._small_qp_poly(kg._sample_triangle())
        e1 = kg._small_qp_poly(kg._sample_triangle())

        def at_level(p: RnsPoly) -> RnsPoly:
            return RnsPoly(p.data[:crt.q_rows(level)], level, 0, p.is_ntt)

        pk_b, pk_a = at_level(kg.pk.b), at_level(kg.pk.a)
        c0 = P.add(P.add(P.mul(pk_b, at_level(v), crt), at_level(e0), crt),
                   plain.poly, crt)
        c1 = P.add(P.mul(pk_a, at_level(v), crt), at_level(e1), crt)
        return Ciphertext(c0, c1, plain.scaling_factor, plain.sf_degree,
                          plain.slots)

    def decrypt(self, ciph: Ciphertext) -> Plaintext:
        crt = self.crt
        level = ciph.level
        sk = RnsPoly(self.keygen.sk.ntt_sk.data[:crt.q_rows(level)], level,
                     0, True)
        m = P.add(P.mul(ciph.c1, sk, crt), ciph.c0, crt)
        return Plaintext(m, ciph.scaling_factor, ciph.sf_degree, ciph.slots)

    # -- linear ops ------------------------------------------------------

    def at_level(self, c: Ciphertext, lv: int) -> Ciphertext:
        """c with its limbs at and above `lv` dropped (no rescaling)."""
        if c.level == lv:
            return c
        k = self.crt.q_rows(lv)
        return Ciphertext(RnsPoly(c.c0.data[:k], lv, 0, c.c0.is_ntt),
                          RnsPoly(c.c1.data[:k], lv, 0, c.c1.is_ntt),
                          c.scaling_factor, c.sf_degree, c.slots)

    def _adjust(self, c1: Ciphertext, c2: Ciphertext):
        """Drop limbs of the higher-level operand (Adjust_level)."""
        lv = min(c1.level, c2.level)
        return self.at_level(c1, lv), self.at_level(c2, lv)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._adjust(a, b)
        return Ciphertext(P.add(a.c0, b.c0, self.crt),
                          P.add(a.c1, b.c1, self.crt),
                          a.scaling_factor, a.sf_degree, a.slots)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        a, b = self._adjust(a, b)
        return Ciphertext(P.sub(a.c0, b.c0, self.crt),
                          P.sub(a.c1, b.c1, self.crt),
                          a.scaling_factor, a.sf_degree, a.slots)

    def negate(self, a: Ciphertext) -> Ciphertext:
        return Ciphertext(P.neg(a.c0, self.crt), P.neg(a.c1, self.crt),
                          a.scaling_factor, a.sf_degree, a.slots)

    def add_plain(self, a: Ciphertext, plain: Plaintext) -> Ciphertext:
        return Ciphertext(P.add(a.c0, plain.poly, self.crt), a.c1,
                          a.scaling_factor, a.sf_degree, a.slots)

    def sub_plain(self, a: Ciphertext, plain: Plaintext) -> Ciphertext:
        return Ciphertext(P.sub(a.c0, plain.poly, self.crt), a.c1,
                          a.scaling_factor, a.sf_degree, a.slots)

    def _const_int(self, val: float, sf_degree: int) -> int:
        """llround(val * Delta) * Delta^(sf_degree-1) as an exact int —
        the value encode() produces for a broadcast scalar, with the same
        +0.5 pre-bias (ckks_encoder.c:248)."""
        delta = self.params.scaling_factor
        m = val * delta + 0.5
        m = int(np.floor(m + 0.5)) if m >= 0 else -int(np.floor(-m + 0.5))
        return m * int(delta) ** (sf_degree - 1)

    def add_const(self, a: Ciphertext, val: float) -> Ciphertext:
        """Add a broadcast scalar: in NTT form the constant polynomial c
        contributes c to every slot of c0."""
        c = self._const_int(val, a.sf_degree)
        level = a.level
        idx = self.crt.local(range(level))
        q, _, _ = self.crt.mod_arrays(idx)
        res = self.crt.column([c % self.crt.q_primes[g] for g in idx])
        d0 = modops.add_mod(a.c0.data, res, q)
        return Ciphertext(RnsPoly(d0, level, 0, True), a.c1,
                          a.scaling_factor, a.sf_degree, a.slots)

    def mul_plain(self, a: Ciphertext, plain: Plaintext) -> Ciphertext:
        level, num_p = a.level, a.c0.num_p
        p = RnsPoly(plain.poly.data, level, num_p, True)
        return Ciphertext(P.mul(a.c0, p, self.crt), P.mul(a.c1, p, self.crt),
                          a.scaling_factor * plain.scaling_factor,
                          a.sf_degree + plain.sf_degree, a.slots)

    def mul_const(self, a: Ciphertext, val: float) -> Ciphertext:
        """Multiply by a broadcast scalar: per-limb Shoup scalar multiply
        (scale grows by Delta)."""
        c = self._const_int(val, 1)
        return Ciphertext(
            P.mul_scalars(a.c0, [c] * a.level, self.crt),
            P.mul_scalars(a.c1, [c] * a.level, self.crt),
            a.scaling_factor * self.params.scaling_factor,
            a.sf_degree + 1, a.slots)

    def mul_integer(self, a: Ciphertext, k: int) -> Ciphertext:
        scalars = [k % q for q in self.crt.q_primes[:a.level]]
        return Ciphertext(P.mul_scalars(a.c0, scalars, self.crt),
                          P.mul_scalars(a.c1, scalars, self.crt),
                          a.scaling_factor, a.sf_degree, a.slots)

    def mul_by_monomial(self, a: Ciphertext, power: int) -> Ciphertext:
        """Multiply by x^power (ckks_evaluator.c:228-256): the monomial's
        coefficient residues (1, or q-1 past the negacyclic wrap) are
        written on the device, then NTT'd and multiplied in."""
        crt = self.crt
        n = a.c0.degree
        index = power % n
        vals = [1 if power % (2 * n) < n else crt.q_primes[g] - 1
                for g in crt.local(range(a.level))]
        data = torch.zeros((len(vals), n), dtype=torch.int64,
                           device=a.c0.data.device)
        data[:, index:index + 1] = crt.column(vals)
        mono = P.to_ntt(RnsPoly(data, a.level, 0, False), crt)
        return Ciphertext(P.mul(a.c0, mono, crt), P.mul(a.c1, mono, crt),
                          a.scaling_factor, a.sf_degree, a.slots)

    # -- multiplication / relinearization -------------------------------

    def mul3(self, a: Ciphertext, b: Ciphertext) -> Ciphertext3:
        a, b = self._adjust(a, b)
        crt = self.crt
        c0 = P.mul(a.c0, b.c0, crt)
        c1 = P.add(P.mul(a.c0, b.c1, crt), P.mul(a.c1, b.c0, crt), crt)
        c2 = P.mul(a.c1, b.c1, crt)
        return Ciphertext3(c0, c1, c2,
                           a.scaling_factor * b.scaling_factor,
                           a.sf_degree + b.sf_degree, a.slots)

    def _switch_key_digits(self, poly: RnsPoly) -> list[RnsPoly]:
        """Decompose + raise every digit (Switch_key_precompute)."""
        crt = self.crt
        return [P.mod_up(P.decompose(poly, crt, part), crt, poly.num_q, part)
                for part in range(crt.num_decomp(poly.num_q))]

    def _switch_key_ext(self, key: SwitchKey, digits: list[RnsPoly],
                        level: int) -> tuple[RnsPoly, RnsPoly]:
        """Digit MACs against the key in the extended QP basis
        (Fast_switch_key_ext, ckks_evaluator.c:404-461)."""
        crt = self.crt
        acc0 = acc1 = None
        for part, raised in enumerate(digits):
            def key_at_level(kp: RnsPoly) -> RnsPoly:
                data = torch.cat([kp.data[:crt.q_rows(level)],
                                  kp.data[crt.q_rows(crt.num_q):]], dim=0)
                return RnsPoly(data, level, crt.num_p, True)
            t0 = P.mul(key_at_level(key.b[part]), raised, crt)
            t1 = P.mul(key_at_level(key.a[part]), raised, crt)
            acc0 = t0 if acc0 is None else P.add(acc0, t0, crt)
            acc1 = t1 if acc1 is None else P.add(acc1, t1, crt)
        return acc0, acc1

    def _switch_key(self, key: SwitchKey, poly: RnsPoly
                    ) -> tuple[RnsPoly, RnsPoly]:
        """Full hybrid key switch of `poly`: returns (s0, s1) over Q_level."""
        digits = self._switch_key_digits(poly)
        e0, e1 = self._switch_key_ext(key, digits, poly.num_q)
        return P.mod_down(e0, self.crt), P.mod_down(e1, self.crt)

    def relinearize(self, c3: Ciphertext3) -> Ciphertext:
        s0, s1 = self._switch_key(self.keygen.relin_key, c3.c2)
        crt = self.crt
        return Ciphertext(P.add(s0, c3.c0, crt), P.add(s1, c3.c1, crt),
                          c3.scaling_factor, c3.sf_degree, c3.slots)

    def mul(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """mul3 + relinearize."""
        return self.relinearize(self.mul3(a, b))

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.mul(a, a)

    # -- rescale / scale management -------------------------------------

    def rescale(self, a: Ciphertext) -> Ciphertext:
        assert a.level > 1
        return Ciphertext(P.rescale(a.c0, self.crt), P.rescale(a.c1, self.crt),
                          a.scaling_factor / self.params.scaling_factor,
                          a.sf_degree - 1, a.slots)

    def upscale(self, a: Ciphertext, mod_size: int) -> Ciphertext:
        """Multiply by an encoding of 1.0 at scale 2^mod_size
        (ckks_evaluator.c:331-345): a constant polynomial with coefficient
        exactly 2^mod_size, so a per-limb scalar multiply."""
        up = 1 << mod_size
        return Ciphertext(
            P.mul_scalars(a.c0, [up] * a.level, self.crt),
            P.mul_scalars(a.c1, [up] * a.level, self.crt),
            a.scaling_factor * float(up), a.sf_degree + 1, a.slots)

    def downscale(self, a: Ciphertext, waterline: int) -> Ciphertext:
        """Normalize the scale back to one Delta (ckks_evaluator.c:
        347-366): upscale to 2^(waterline + sf bits), then rescale."""
        sf_bits = self.params.scaling_mod_size
        ciph_bits = int(np.log2(a.scaling_factor))
        up = self.upscale(a, waterline + sf_bits - ciph_bits)
        up = Ciphertext(up.c0, up.c1, up.scaling_factor, a.sf_degree + 1,
                        up.slots)
        return self.rescale(up)

    def mod_switch(self, a: Ciphertext) -> Ciphertext:
        """Drop the last limb without scaling (Mod_down_q_primes)."""
        return self.at_level(a, a.level - 1)

    def mod_switch_to_decode_floor(self, a: Ciphertext) -> Ciphertext:
        """Drop residual limbs down to 3 (2 + 2*sf_degree above scale
        degree 1) before a decrypt+decode: an exact mod-switch (message +
        noise << the remaining modulus), so the decoded values are the
        same and the exact-CRT decode costs the same at any level."""
        floor = 3 if a.sf_degree <= 1 else 2 + 2 * a.sf_degree
        while a.level > floor:
            a = self.mod_switch(a)
        return a

    # -- rotation --------------------------------------------------------

    def rotate(self, a: Ciphertext, rotation: int) -> Ciphertext:
        """Slot rotation: keyswitch c1, add c0, then automorphism
        (Fast_rotate, ckks_evaluator.c:507-545)."""
        if rotation == 0:
            return a
        return self._key_switch_auto(a, *self.keygen.rot_key(rotation))

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        """Conjugation: key switch, then automorphism 2N-1, as rotate."""
        return self._key_switch_auto(a, *self.keygen.conj_key())

    def _key_switch_auto(self, a: Ciphertext, auto_idx: int,
                         key: SwitchKey) -> Ciphertext:
        crt = self.crt
        s0, s1 = self._switch_key(key, a.c1)
        t0 = P.add(s0, a.c0, crt)
        return Ciphertext(P.automorphism(t0, auto_idx, crt),
                          P.automorphism(s1, auto_idx, crt),
                          a.scaling_factor, a.sf_degree, a.slots)

    def rotations_hoisted(self, a: Ciphertext,
                          rotations: list[int]) -> list[Ciphertext]:
        """Many rotations of one ciphertext sharing a single digit
        decompose/mod-up (ut_ksw_opt.cxx:349-375)."""
        crt = self.crt
        digits = None
        out = []
        for r in rotations:
            if r == 0:
                out.append(a)
                continue
            if digits is None:
                digits = self._switch_key_digits(a.c1)
            auto_idx, key = self.keygen.rot_key(r)
            e0, e1 = self._switch_key_ext(key, digits, a.c1.num_q)
            t0 = P.add(P.mod_down(e0, crt), a.c0, crt)
            out.append(Ciphertext(
                P.automorphism(t0, auto_idx, crt),
                P.automorphism(P.mod_down(e1, crt), auto_idx, crt),
                a.scaling_factor, a.sf_degree, a.slots))
        return out

    # -- extended-basis (QP) rotation accumulation ------------------------
    # mod-up + mod-down hoisting (ut_ksw_opt.cxx:349-375, Fast_rotate_ext
    # ckks_evaluator.c:539-575): many rotations share one digit
    # decompose/mod-up, accumulate in the QP basis, and pay one
    # mod-down at the end.

    def _p_scale(self, poly: RnsPoly, ext: bool = False) -> RnsPoly:
        """x -> x*P over Q limbs (+ zero P limbs if ext): the embedding
        of a Q-basis poly into the QP basis (Get_pmodq)."""
        crt = self.crt
        scal = [crt.big_p % q for q in crt.q_primes[:poly.num_q]]
        out = P.mul_scalars(poly, scal, crt)
        if ext:
            rows = len(crt.local(crt.limbs(0, crt.num_p)))
            zeros = torch.zeros((rows, poly.degree), dtype=torch.int64,
                                device=poly.data.device)
            out = RnsPoly(torch.cat([out.data, zeros], dim=0),
                          poly.num_q, crt.num_p, poly.is_ntt)
        return out

    def to_ext(self, a: Ciphertext) -> Ciphertext:
        """Embed a Q-basis ciphertext into the QP basis (x*P, zero P
        rows); mod_down_ciph inverts it exactly."""
        return Ciphertext(self._p_scale(a.c0, True),
                          self._p_scale(a.c1, True),
                          a.scaling_factor, a.sf_degree, a.slots)

    def switch_key_precompute(self, poly: RnsPoly) -> list:
        """Shared digit decompose + mod-up (Switch_key_precompute)."""
        return self._switch_key_digits(poly)

    def _add_p_c0(self, e0: RnsPoly, c0p: torch.Tensor) -> torch.Tensor:
        """e0's data with P*c0 (c0p, over e0's q limbs) added to its q
        limbs: the key-switched c0 of an ext rotation, before its
        automorphism."""
        crt = self.crt
        k = crt.q_rows(e0.num_q)
        q, _, _ = crt.mod_arrays(crt.local(range(e0.num_q)))
        top = modops.add_mod(e0.data[:k], c0p, q)
        return torch.cat([top, e0.data[k:]], dim=0)

    def rotate_ext(self, a: Ciphertext, rotation: int, digits=None,
                   add_first: bool = True) -> Ciphertext:
        """Rotation in the extended basis (Fast_rotate_ext); the result
        stays over QP. `digits` are shared switch-key digits from
        switch_key_precompute(a.c1); add_first adds P*c0 before the
        automorphism."""
        if digits is None:
            digits = self._switch_key_digits(a.c1)
        crt = self.crt
        auto_idx, key = self.keygen.rot_key(rotation)
        e0, e1 = self._switch_key_ext(key, digits, a.c1.num_q)
        if add_first:
            e0 = RnsPoly(self._add_p_c0(e0, self._p_scale(a.c0).data),
                         e0.num_q, e0.num_p, True)
        return Ciphertext(P.automorphism(e0, auto_idx, crt),
                          P.automorphism(e1, auto_idx, crt),
                          a.scaling_factor, a.sf_degree, a.slots)

    def mod_down_ciph(self, a: Ciphertext) -> Ciphertext:
        """QP -> Q: one Reduce_rns_base per component."""
        return Ciphertext(P.mod_down(a.c0, self.crt),
                          P.mod_down(a.c1, self.crt),
                          a.scaling_factor, a.sf_degree, a.slots)

    def _ext_rotations(self, ct: Ciphertext, rots: list) -> tuple:
        """The QP-basis rotations of ct for each r in rots, as two lists
        (c0, c1) of data tensors [LK, N]: one digit decompose/mod-up and
        one P*c0 shared by all rotations; each key-switches c1 into QP,
        adds P*c0, then applies its automorphism. Rotation 0 is the plain
        embedding _p_scale(., True). The ext rotation of every bundle."""
        crt = self.crt
        level = ct.level
        cin0 = RnsPoly(ct.c0.data, level, 0, True)
        cin1 = RnsPoly(ct.c1.data, level, 0, True)
        ext0, ext1 = [], []
        digits = c0p = None
        for r in rots:
            if r == 0:
                ext0.append(self._p_scale(cin0, True).data)
                ext1.append(self._p_scale(cin1, True).data)
                continue
            if digits is None:
                digits = self._switch_key_digits(cin1)
                c0p = self._p_scale(cin0).data
            ai, key = self.keygen.rot_key(r)
            e0, e1 = self._switch_key_ext(key, digits, level)
            order = crt.auto_order(ai)
            ext0.append(self._add_p_c0(e0, c0p).index_select(1, order))
            ext1.append(e1.data.index_select(1, order))
        return ext0, ext1

    # -- the two bundles of the conv path ---------------------------------

    def rot_sum_jit(self, items: list) -> Ciphertext:
        """sum_i rot(ct_i, r_i) with one trailing mod-down per chunk of
        max_bundle rotations (mod-down hoisting across different inputs,
        the Add_ciphertext-in-QP pattern of ut_ksw_opt.cxx:349-375)."""
        if len(items) > self.max_bundle:
            acc = None
            for s in range(0, len(items), self.max_bundle):
                part = self.rot_sum_jit(items[s:s + self.max_bundle])
                acc = part if acc is None else self.add(acc, part)
            return acc
        crt = self.crt
        level = items[0][0].level
        acc0 = acc1 = None
        for ct, r in items:
            assert ct.level == level, "rot_sum inputs must share a level"
            (d0,), (d1,) = self._ext_rotations(ct, [r])
            e0 = RnsPoly(d0, level, crt.num_p, True)
            e1 = RnsPoly(d1, level, crt.num_p, True)
            acc0 = e0 if acc0 is None else P.add(acc0, e0, crt)
            acc1 = e1 if acc1 is None else P.add(acc1, e1, crt)
        ct0 = items[0][0]
        return Ciphertext(P.mod_down(acc0, crt), P.mod_down(acc1, crt),
                          ct0.scaling_factor, ct0.sf_degree, ct0.slots)

    def rot_ext_mac_groups_jit(self, ct: Ciphertext, rots: list,
                               plain_groups: list) -> list:
        """[sum_i rot(ct, rots[i]) * plain_groups[g][i] for g], with the
        plaintexts given as extended-basis Plaintexts (or None where a
        group does not use a rotation): one digit decompose/mod-up for
        all rotations, the MACs in the QP basis, one mod-down per group
        and component. Rotation sets beyond max_bundle are chunked and
        the mod-downed partials summed, as in ace_tpu; a group with no
        plaintext gives a zero ciphertext at the others' scale."""
        if not plain_groups or all(all(p is None for p in grp)
                                   for grp in plain_groups):
            raise ValueError(
                "rot_ext_mac_groups_jit: plain_groups must contain at "
                "least one non-None plaintext")
        dead = [g for g, grp in enumerate(plain_groups)
                if all(p is None for p in grp)]
        if dead:
            live = [g for g in range(len(plain_groups)) if g not in dead]
            parts = self.rot_ext_mac_groups_jit(
                ct, rots, [plain_groups[g] for g in live])
            total = [None] * len(plain_groups)
            for g, part in zip(live, parts):
                total[g] = part
            zero = self.sub(parts[0], parts[0])
            for g in dead:
                total[g] = zero
            return total
        if len(rots) > self.max_bundle:
            step = self.max_bundle
            total = [None] * len(plain_groups)
            for s in range(0, len(rots), step):
                sub_groups = [grp[s:s + step] for grp in plain_groups]
                live = [g for g, grp in enumerate(sub_groups)
                        if any(p is not None for p in grp)]
                if not live:
                    continue
                parts = self.rot_ext_mac_groups_jit(
                    ct, rots[s:s + step], [sub_groups[g] for g in live])
                for g, part in zip(live, parts):
                    total[g] = part if total[g] is None \
                        else self.add(total[g], part)
            ref = next(x for x in total if x is not None)
            return [self.sub(ref, ref) if v is None else v for v in total]
        crt = self.crt
        level, num_p = ct.level, crt.num_p
        ext0, ext1 = self._ext_rotations(ct, rots)
        outs = []
        for grp in plain_groups:
            acc0 = acc1 = None
            for e0, e1, pl in zip(ext0, ext1, grp):
                if pl is None:
                    continue
                p = RnsPoly(pl.poly.data, level, num_p, True)
                t0 = P.mul(RnsPoly(e0, level, num_p, True), p, crt)
                t1 = P.mul(RnsPoly(e1, level, num_p, True), p, crt)
                acc0 = t0 if acc0 is None else P.add(acc0, t0, crt)
                acc1 = t1 if acc1 is None else P.add(acc1, t1, crt)
            pl_scale = next(p.scaling_factor for p in grp if p is not None)
            outs.append(Ciphertext(P.mod_down(acc0, crt),
                                   P.mod_down(acc1, crt),
                                   ct.scaling_factor * pl_scale,
                                   ct.sf_degree + 1, ct.slots))
        return outs

    def _lift_msgs(self, msg: torch.Tensor, qk, muh, mulo) -> torch.Tensor:
        """int64 messages [..., N] -> canonical residues [..., LK, N] at
        the moduli qk [LK, 1] (bit-exact encoder._signed_to_rns)."""
        neg = msg < 0
        mag = torch.where(neg, -msg, msg)
        r = modops.mod_u64(mag[..., None, :], qk, muh, mulo)
        return torch.where(neg[..., None, :] & (r != 0), qk - r, r)

    def _mac_msgs(self, msgs: torch.Tensor, ext0: torch.Tensor,
                  ext1: torch.Tensor, idx: list) -> tuple:
        """(sum_i lift(msgs[i]) * ext0[i], the same for ext1) over the QP
        limbs `idx` (the local ones), for R messages [R, N] and exts
        [R, LK, N]. The R messages are lifted together, NTT'd in one
        launch over R x LK limbs and multiplied in one launch per
        component; the products are summed by a pairwise add_mod tree.
        Residue sums are exact, so this equals ace_tpu's per-message
        accumulation."""
        crt = self.crt
        qk, muh, mulo = crt.mod_arrays(idx)
        r, n = msgs.shape
        lift = self._lift_msgs(msgs, qk, muh, mulo).reshape(r * len(idx), n)
        pn = ntt.ntt_fwd(lift, crt.tables_for(idx * r)).view(r, len(idx), n)
        return (_sum_mod(modops.barrett_mul_d(pn, ext0, qk, muh, mulo), qk),
                _sum_mod(modops.barrett_mul_d(pn, ext1, qk, muh, mulo), qk))

    def rot_mac_groups_msgs_jit(self, ct: Ciphertext, rots: list,
                                msgs: torch.Tensor) -> list:
        """[sum_i rot(ct, rots[i]) * encode(msgs[g, i]) for g] with the
        plaintexts given as level-independent int64 messages [G, R, N]
        (dense; zero rows contribute exact zeros): one digit
        decompose/mod-up for all rotations, the plaintext lift + NTT and
        the MACs in the QP basis, one mod-down per group and component.

        Rotation sets beyond max_bundle_msg are chunked and the
        mod-downed partials summed, which bounds the R live keyswitch
        exts."""
        if len(rots) > self.max_bundle_msg:
            outs = None
            step = self.max_bundle_msg
            for s in range(0, len(rots), step):
                part = self.rot_mac_groups_msgs_jit(
                    ct, rots[s:s + step], msgs[:, s:s + step])
                outs = part if outs is None else \
                    [self.add(a, b) for a, b in zip(outs, part)]
            return outs
        crt = self.crt
        level, num_p = ct.level, crt.num_p
        idx = crt.local(crt.limbs(level, num_p))
        ext0, ext1 = (torch.stack(e) for e in  # [R, LK, N]
                      self._ext_rotations(ct, rots))
        outs = []
        pl_scale = self.params.scaling_factor
        for g in range(msgs.shape[0]):  # the lax.scan over groups
            acc0, acc1 = self._mac_msgs(msgs[g], ext0, ext1, idx)
            o0 = P.mod_down(RnsPoly(acc0, level, num_p, True), crt)
            o1 = P.mod_down(RnsPoly(acc1, level, num_p, True), crt)
            outs.append(Ciphertext(o0, o1, ct.scaling_factor * pl_scale,
                                   ct.sf_degree + 1, ct.slots))
        return outs

    # -- the bootstrap's BSGS level ---------------------------------------

    def bsgs_iter_jit(self, ct: Ciphertext, baby_rots: list,
                      giant_rots: list, msgs: torch.Tensor) -> Ciphertext:
        """One collapsed-FFT level of the bootstrap as baby-step/giant-step
        rotations (Rotate_iteration, ckks_bootstrap_context.c:1237-1383),
        with ace_tpu's _mk_bsgs_iter bookkeeping: baby rotations share one
        digit decompose/mod-up and stay in the QP basis (rotation 0 is the
        plain embedding _p_scale(., True)); group i's MACs against the
        messages msgs[i] ([len(giant_rots), len(baby_rots), N] int64)
        accumulate in QP; group i's c0 joins the extended `first`
        accumulator by automorphism alone, and only its c1 is mod-downed
        and key-switched for the giant rotation; one final mod-down per
        component.

        The baby keys are read one at a time (never stacked). Each
        group's MACs are one _mac_msgs call."""
        crt = self.crt
        level, num_p = ct.level, crt.num_p
        idx = crt.local(crt.limbs(level, num_p))
        ext0, ext1 = (torch.stack(e) for e in  # [g, LK, N]
                      self._ext_rotations(ct, baby_rots))

        first = out0 = out1 = None
        for i, r in enumerate(giant_rots):
            acc0, acc1 = (RnsPoly(d, level, num_p, True) for d in
                          self._mac_msgs(msgs[i], ext0, ext1, idx))
            gai, gkey = self.keygen.rot_key(r) if r else (1, None)
            if i == 0:
                first, out1 = acc0, acc1
            elif gai != 1:
                c1q = P.mod_down(acc1, crt)
                first = P.add(first, P.automorphism(acc0, gai, crt), crt)
                e0, e1 = self._switch_key_ext(
                    gkey, self._switch_key_digits(c1q), level)
                a0 = P.automorphism(e0, gai, crt)
                out0 = a0 if out0 is None else P.add(out0, a0, crt)
                out1 = P.add(out1, P.automorphism(e1, gai, crt), crt)
            else:
                first = P.add(first, acc0, crt)
                out1 = P.add(out1, acc1, crt)
        out0 = first if out0 is None else P.add(out0, first, crt)
        return Ciphertext(P.mod_down(out0, crt), P.mod_down(out1, crt),
                          ct.scaling_factor * self.params.scaling_factor,
                          ct.sf_degree + 1, ct.slots)


def _sum_mod(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x[0] + ... + x[k-1] mod q by a pairwise add_mod tree (ceil(log2 k)
    launches)."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s = modops.add_mod(x[:h], x[h:2 * h], q)
        x = torch.cat([s, x[2 * h:]]) if x.shape[0] % 2 else s
    return x[0]
