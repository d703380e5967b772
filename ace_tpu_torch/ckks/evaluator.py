"""CKKS homomorphic evaluator: the scheme-op layer.

The Evaluator of `ace_tpu.ckks.evaluator` (the reference's
ckks_evaluator.c) in PyTorch. Every op keeps the JAX package's order of
operations, so residues match it bit for bit on the same keys.

Op programs. As in ace_tpu, each op of the main path (rotate and
conjugate, mul, rescale, mul_plain, add_const and the four bundles)
runs as one program, cached in `_jit_cache` under ace_tpu's static key
(("rot", auto_idx, level), ("mulrl", level), ...) and built by the
`_mk_*` builder of the same name: a function of the ciphertext, the
plaintext or message data and the raw key planes (`_key_raw`), wrapped
by utils/liftgraph.py into a CUDA graph captured at its second call and
replayed after (on the CPU the function runs directly). Its lax.scan
over weight groups is a Python loop. Keys are read by reference: when
the rotation-key LRU evicts a key, the programs that captured it are
dropped (`_drop_key_programs`). `programs=False` caches the plain
functions instead. Under a limb mesh (FheContext(mesh=...)) the same
programs, under the same keys, are split at their collectives (mod-up's
and mod-down's gathers, rescale's and mod-raise's broadcasts), which run
eagerly between the graph segments' replays (utils/liftgraph.py).

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

Spans: each public op that the graph runner, the ReLU and the bootstrap
call is the span CKKS::<op> (runtime/timing.py), the key-switching ones
(mul's relinearization, rotate, conjugate and the rotation bundles)
marked as such; those that only launch a few elementwise kernels (add,
sub, negate, add_plain, sub_plain, mul_const, mul_integer, upscale) open
none: their time is the enclosing span's own.

Limb shard (FheContext(mesh=...), CrtContext.shard): every poly holds
this rank's rows only; the ops below take limb positions from the CRT
context's helpers (q_rows, local, limbs), never from a global index, so
the same code runs sharded and unsharded. Communication happens inside
poly.py's conversions only.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ace_tpu_torch.ckks.cipher import Ciphertext, Ciphertext3
from ace_tpu_torch.ckks.encoder import Encoder, Plaintext
from ace_tpu_torch.ckks.keygen import KeyGenerator, SwitchKey
from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.ops import lift, modops, ntt, pallas_modops as pm
from ace_tpu_torch.poly import poly as P
from ace_tpu_torch.poly.poly import RnsPoly
from ace_tpu_torch.runtime.timing import timed
from ace_tpu_torch.utils.liftgraph import GraphPool, Program, lift_graph


class Evaluator:
    def __init__(self, params: CkksParams, keygen: KeyGenerator,
                 encoder: Encoder, max_bundle: int = 5,
                 max_bundle_msg: int = 12, programs: bool = True):
        """max_bundle: rotations per rot_sum_jit and
        rot_ext_mac_groups_jit accumulation;
        max_bundle_msg: rotations per rot_mac_groups_msgs_jit bundle.
        Larger sets are chunked and the mod-downed partials summed, as
        in ace_tpu (whose defaults these are), which keeps the residues
        identical to it and bounds the live extended-basis workspace.
        programs: run the ops as op programs (see the module docstring);
        False runs the same functions eagerly, for comparison."""
        self.params = params
        self.crt = params.crt
        self.encoder = encoder
        self.max_bundle = max_bundle
        self.max_bundle_msg = max_bundle_msg
        self.programs = programs
        # op programs by static structure (op, level, rotation indices, ...)
        self._jit_cache: dict = {}
        self._pool = None  # the programs' GraphPool, made at first use
        # message stacks of the MAC bundles' call sites (kept_msgs)
        self._stack_counts = dict(stacks_built=0, stacks_reused=0)
        self._keygen = None
        self.keygen = keygen

    @property
    def keygen(self) -> KeyGenerator:
        return self._keygen

    @keygen.setter
    def keygen(self, kg: KeyGenerator) -> None:
        """The key generator, whose LRU evictions drop the programs that
        captured the evicted key (tests swap in a key generator holding
        another package's keys). Swapping in another one drops every
        program: they captured the old one's keys."""
        if kg is self._keygen:
            return
        self._jit_cache.clear()
        self._keygen = kg
        if kg is not None:
            kg.on_evict(self._drop_key_programs)

    # -- encrypt / decrypt ----------------------------------------------

    @timed("CKKS::encrypt")
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

    @timed("CKKS::decrypt")
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

    @timed("CKKS::add_const")
    def add_const(self, a: Ciphertext, val: float) -> Ciphertext:
        """Add a broadcast scalar: in NTT form the constant polynomial c
        contributes c to every slot of c0."""
        c = self._const_int(val, a.sf_degree)
        level = a.level
        # the residues of c: the program's input, not a captured constant
        res = self.crt.column([c % self.crt.q_primes[g]
                               for g in self.crt.local(range(level))])
        fn = self._get_jit(("addc", level), self._mk_add_scalar, level)
        d0 = fn(a.c0.data, res)
        return Ciphertext(RnsPoly(d0, level, 0, True), a.c1,
                          a.scaling_factor, a.sf_degree, a.slots)

    def _mk_add_scalar(self, level: int):
        q, _, _ = self.crt.mod_arrays(self.crt.local(range(level)))

        def impl(c0, res):
            return modops.add_mod(c0, res, q)

        return self._lift(impl)

    @timed("CKKS::mul_plain")
    def mul_plain(self, a: Ciphertext, plain: Plaintext) -> Ciphertext:
        level, num_p = a.level, a.c0.num_p
        fn = self._get_jit(("mp", level, num_p), self._mk_mul_plain,
                           level, num_p)
        d0, d1 = fn(a.c0.data, a.c1.data, plain.poly.data)
        return Ciphertext(RnsPoly(d0, level, num_p, True),
                          RnsPoly(d1, level, num_p, True),
                          a.scaling_factor * plain.scaling_factor,
                          a.sf_degree + plain.sf_degree, a.slots)

    def _mk_mul_plain(self, level: int, num_p: int):
        crt = self.crt

        def impl(c0, c1, pl):
            p = RnsPoly(pl, level, num_p, True)
            return (P.mul(RnsPoly(c0, level, num_p, True), p, crt).data,
                    P.mul(RnsPoly(c1, level, num_p, True), p, crt).data)

        return self._lift(impl)

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

    @timed("CKKS::mul_by_monomial")
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

    @timed("CKKS::mul", keyswitch=True)
    def mul(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """mul3 + relinearize as one program, ("mulrl", level)."""
        a, b = self._adjust(a, b)
        level = a.level
        fn = self._get_jit(("mulrl", level), self._mk_mul_relin, level)
        kb, ka = self._key_raw(self.keygen.relin_key)
        d0, d1 = fn(a.c0.data, a.c1.data, b.c0.data, b.c1.data, kb, ka)
        return Ciphertext(RnsPoly(d0, level, 0, True),
                          RnsPoly(d1, level, 0, True),
                          a.scaling_factor * b.scaling_factor,
                          a.sf_degree + b.sf_degree, a.slots)

    def _mk_mul_relin(self, level: int):
        crt = self.crt

        ev = weakref.proxy(self)

        def impl(a0, a1, b0, b1, kb, ka):
            pa0, pa1, pb0, pb1 = (RnsPoly(d, level, 0, True)
                                  for d in (a0, a1, b0, b1))
            c0 = P.mul(pa0, pb0, crt)
            c1 = P.add(P.mul(pa0, pb1, crt), P.mul(pa1, pb0, crt), crt)
            c2 = P.mul(pa1, pb1, crt)
            s0, s1 = ev._switch_key(ev._key_of(kb, ka), c2)
            return P.add(s0, c0, crt).data, P.add(s1, c1, crt).data

        return self._lift(impl, refs=(4, 5))

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.mul(a, a)

    # -- rescale / scale management -------------------------------------

    @timed("CKKS::rescale")
    def rescale(self, a: Ciphertext) -> Ciphertext:
        assert a.level > 1
        fn = self._get_jit(("rs", a.level), self._mk_rescale, a.level)
        d0, d1 = fn(a.c0.data, a.c1.data)
        return Ciphertext(RnsPoly(d0, a.level - 1, 0, True),
                          RnsPoly(d1, a.level - 1, 0, True),
                          a.scaling_factor / self.params.scaling_factor,
                          a.sf_degree - 1, a.slots)

    def _mk_rescale(self, level: int):
        crt = self.crt

        def impl(c0, c1):
            return (P.rescale(RnsPoly(c0, level, 0, True), crt).data,
                    P.rescale(RnsPoly(c1, level, 0, True), crt).data)

        return self._lift(impl)

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

    @timed("CKKS::rotate", keyswitch=True)
    def rotate(self, a: Ciphertext, rotation: int) -> Ciphertext:
        """Slot rotation: keyswitch c1, add c0, then automorphism
        (Fast_rotate, ckks_evaluator.c:507-545). One program per
        (automorphism index, level)."""
        if rotation == 0:
            return a
        return self._rotate_by(a, *self.keygen.rot_key(rotation))

    @timed("CKKS::conjugate", keyswitch=True)
    def conjugate(self, a: Ciphertext) -> Ciphertext:
        """Conjugation: key switch, then automorphism 2N-1, through the
        rotate program."""
        return self._rotate_by(a, *self.keygen.conj_key())

    def _rotate_by(self, a: Ciphertext, auto_idx: int,
                   key: SwitchKey) -> Ciphertext:
        level = a.level
        pkey = ("rot", auto_idx, level)
        fn = self._get_jit(pkey, self._mk_rotate, auto_idx, level)
        # the key's own fetch made it the LRU's newest: it cannot have
        # been evicted, so the program needs no _run check
        kb, ka = self._key_raw(key)
        d0, d1 = fn(a.c0.data, a.c1.data, kb, ka)
        return Ciphertext(RnsPoly(d0, level, 0, True),
                          RnsPoly(d1, level, 0, True),
                          a.scaling_factor, a.sf_degree, a.slots)

    def _mk_rotate(self, auto_idx: int, level: int):
        crt = self.crt

        ev = weakref.proxy(self)

        def impl(c0, c1, kb, ka):
            s0, s1 = ev._switch_key(ev._key_of(kb, ka),
                                      RnsPoly(c1, level, 0, True))
            t0 = P.add(s0, RnsPoly(c0, level, 0, True), crt)
            return (P.automorphism(t0, auto_idx, crt).data,
                    P.automorphism(s1, auto_idx, crt).data)

        return self._lift(impl, refs=(2, 3))

    @timed("CKKS::rotations_hoisted", keyswitch=True)
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

    def _ext_rotations(self, cin0: RnsPoly, cin1: RnsPoly, auto_idxs,
                       keys: list) -> tuple:
        """The QP-basis rotations of (cin0, cin1) by each automorphism of
        auto_idxs (keys: the switching key of each, None at index 1), as
        two lists (c0, c1) of data tensors [LK, N]: one digit
        decompose/mod-up and one P*c0 shared by all rotations; each
        key-switches c1 into QP, adds P*c0, then applies its automorphism.
        Index 1 is the plain embedding _p_scale(., True). The ext
        rotation of every bundle."""
        crt = self.crt
        ext0, ext1 = [], []
        digits = c0p = None
        for ai, key in zip(auto_idxs, keys):
            if ai == 1:
                ext0.append(self._p_scale(cin0, True).data)
                ext1.append(self._p_scale(cin1, True).data)
                continue
            if digits is None:
                digits = self._switch_key_digits(cin1)
                c0p = self._p_scale(cin0).data
            e0, e1 = self._switch_key_ext(key, digits, cin0.num_q)
            order = crt.auto_order(ai)
            ext0.append(self._add_p_c0(e0, c0p).index_select(1, order))
            ext1.append(e1.data.index_select(1, order))
        return ext0, ext1

    # -- op programs ---------------------------------------------------------

    def _get_jit(self, key, builder, *args):
        """The op program cached under `key`, built by builder(*args) on
        a miss (ace_tpu's _get_jit)."""
        if key not in self._jit_cache:
            self._jit_cache[key] = builder(*args)
        return self._jit_cache[key]

    def _graph_pool(self) -> GraphPool:
        """The programs' GraphPool, made at first use."""
        if self._pool is None:
            self._pool = GraphPool(self.crt.device)
        return self._pool

    def _lift(self, impl, refs=()):
        """impl as an op program (its arguments at `refs` read by
        reference), or impl itself with programs off."""
        if not self.programs:
            return impl
        return lift_graph(impl, self._graph_pool(), refs)

    def _run(self, pkey, fn, keys: list, *args):
        """fn(*args) for the program cached under pkey that reads the
        switching keys `keys`. When the LRU evicted one of them while this
        op fetched the others (a bundle with more keys than the LRU
        holds), the program is dropped after the call, so that it never
        keeps a key the LRU let go."""
        out = fn(*args)
        if any(k.evicted for k in keys):
            self._jit_cache.pop(pkey, None)
        return out

    def _drop_key_programs(self, key: SwitchKey) -> None:
        """Drop every program that captured `key` (the LRU evicted it)."""
        ids = {id(p.data) for p in (*key.b, *key.a)}
        for k in [k for k, p in self._jit_cache.items()
                  if isinstance(p, Program) and p.holds(ids)]:
            del self._jit_cache[k]

    def program_stats(self) -> dict:
        """Programs cached, and the pool's counts (GraphPool.stats):
        programs lifted, programs captured, capture seconds, graph
        segments captured, replays, staging and graph-pool bytes; and
        the message stacks that kept_msgs built and reused."""
        if self._pool is None:
            st = dict(programs=0, captures=0, capture_s=0.0, segments=0,
                      replays=0, staging_bytes=0, pool_bytes=None)
        else:
            st = self._pool.stats()
        return dict(st, cached=len(self._jit_cache), **self._stack_counts)

    def kept_msgs(self, memo: dict, key, build) -> torch.Tensor:
        """memo[key], made by build() at the first call: the [G, R, N]
        message stack of one MAC-bundle call site (a conv of a compiled
        graph, a BSGS level of a bootstrap), whose weights, tables and
        scales are fixed, so later calls encode and stack nothing. The
        caller owns the memo; the counts are program_stats'."""
        msgs = memo.get(key)
        if msgs is None:
            msgs = memo[key] = build()
            self._stack_counts["stacks_built"] += 1
        else:
            self._stack_counts["stacks_reused"] += 1
        return msgs

    def program_segments(self) -> dict:
        """Program kind (its key's first item) -> the graph segments of
        each cached program that has run, in cache order: 1 for a
        program without a collective, one more than its collectives
        under a mesh."""
        out = {}
        for key, p in self._jit_cache.items():
            if isinstance(p, Program) and p.segments is not None:
                out.setdefault(key[0], []).append(p.segments)
        return out

    def _key_raw(self, key: SwitchKey):
        """Full key digit planes as raw tensors (program arguments read
        by reference; _switch_key_ext does the per-level slicing)."""
        return [kb.data for kb in key.b], [ka.data for ka in key.a]

    def _key_of(self, kb: list, ka: list) -> SwitchKey:
        """The SwitchKey over raw digit planes (_key_raw's inverse)."""
        crt = self.crt
        return SwitchKey(
            [RnsPoly(d, crt.num_q, crt.num_p, True) for d in kb],
            [RnsPoly(d, crt.num_q, crt.num_p, True) for d in ka])

    def _keys_of(self, auto_idxs, keys_b: list, keys_a: list) -> list:
        """One SwitchKey per automorphism of auto_idxs from the raw planes
        of the non-identity ones, None at index 1."""
        it = iter(zip(keys_b, keys_a))
        return [None if ai == 1 else self._key_of(*next(it))
                for ai in auto_idxs]

    def _rot_keys(self, rots: list) -> tuple:
        """(automorphism index per rotation, 1 for rotation 0; the
        switching keys of the others, in order), fetched in that order."""
        auto_idxs, keys = [], []
        for r in rots:
            if r == 0:
                auto_idxs.append(1)
                continue
            ai, key = self.keygen.rot_key(r)
            auto_idxs.append(ai)
            keys.append(key)
        return auto_idxs, keys

    def _raw_planes(self, keys: list) -> tuple:
        """(b planes, a planes) of each key: the programs' key lists."""
        raw = [self._key_raw(k) for k in keys]
        return [kb for kb, _ in raw], [ka for _, ka in raw]

    # -- the two bundles of the conv path ---------------------------------

    @timed("CKKS::rot_sum_jit", keyswitch=True)
    def rot_sum_jit(self, items: list) -> Ciphertext:
        """sum_i rot(ct_i, r_i) with one trailing mod-down per chunk of
        max_bundle rotations (mod-down hoisting across different inputs,
        the Add_ciphertext-in-QP pattern of ut_ksw_opt.cxx:349-375), one
        program per (automorphisms, level)."""
        if len(items) > self.max_bundle:
            acc = None
            for s in range(0, len(items), self.max_bundle):
                part = self.rot_sum_jit(items[s:s + self.max_bundle])
                acc = part if acc is None else self.add(acc, part)
            return acc
        level = items[0][0].level
        for ct, _ in items:
            assert ct.level == level, "rot_sum inputs must share a level"
        auto_idxs, keys = self._rot_keys([r for _, r in items])
        pkey = ("rsum", tuple(auto_idxs), level)
        fn = self._get_jit(pkey, self._mk_rot_sum, tuple(auto_idxs), level)
        cs = [(ct.c0.data, ct.c1.data) for ct, _ in items]
        d0, d1 = self._run(pkey, fn, keys, cs, *self._raw_planes(keys))
        ct0 = items[0][0]
        return Ciphertext(RnsPoly(d0, level, 0, True),
                          RnsPoly(d1, level, 0, True),
                          ct0.scaling_factor, ct0.sf_degree, ct0.slots)

    def _mk_rot_sum(self, auto_idxs: tuple, level: int):
        crt = self.crt
        num_p = crt.num_p

        ev = weakref.proxy(self)

        def impl(cs, keys_b, keys_a):
            keys = ev._keys_of(auto_idxs, keys_b, keys_a)
            acc0 = acc1 = None
            for (c0, c1), ai, key in zip(cs, auto_idxs, keys):
                (d0,), (d1,) = ev._ext_rotations(
                    RnsPoly(c0, level, 0, True), RnsPoly(c1, level, 0, True),
                    [ai], [key])
                e0 = RnsPoly(d0, level, num_p, True)
                e1 = RnsPoly(d1, level, num_p, True)
                acc0 = e0 if acc0 is None else P.add(acc0, e0, crt)
                acc1 = e1 if acc1 is None else P.add(acc1, e1, crt)
            return P.mod_down(acc0, crt).data, P.mod_down(acc1, crt).data

        return self._lift(impl, refs=(1, 2))

    @timed("CKKS::rot_ext_mac_groups_jit", keyswitch=True)
    def rot_ext_mac_groups_jit(self, ct: Ciphertext, rots: list,
                               plain_groups: list) -> list:
        """[sum_i rot(ct, rots[i]) * plain_groups[g][i] for g], with the
        plaintexts given as extended-basis Plaintexts (or None where a
        group does not use a rotation): one digit decompose/mod-up for
        all rotations, the MACs in the QP basis, one mod-down per group
        and component, as one program per (automorphisms, usage pattern,
        level). Rotation sets beyond max_bundle are chunked and the
        mod-downed partials summed, as in ace_tpu; a group with no
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
        level = ct.level
        auto_idxs, keys = self._rot_keys(rots)
        pattern = tuple(tuple(p is not None for p in grp)
                        for grp in plain_groups)
        pkey = ("rmg", tuple(auto_idxs), pattern, level)
        fn = self._get_jit(pkey, self._mk_rot_mac_groups, tuple(auto_idxs),
                           pattern, level)
        pls = [p.poly.data for grp in plain_groups for p in grp
               if p is not None]
        raw = self._run(pkey, fn, keys, ct.c0.data, ct.c1.data,
                        *self._raw_planes(keys), pls)
        outs = []
        for grp, (d0, d1) in zip(plain_groups, raw):
            pl_scale = next(p.scaling_factor for p in grp if p is not None)
            outs.append(Ciphertext(RnsPoly(d0, level, 0, True),
                                   RnsPoly(d1, level, 0, True),
                                   ct.scaling_factor * pl_scale,
                                   ct.sf_degree + 1, ct.slots))
        return outs

    def _mk_rot_mac_groups(self, auto_idxs: tuple, pattern: tuple,
                           level: int):
        """auto_idxs[i]: automorphism index per rotation (1 = identity,
        no key switch); pattern[g][i]: whether group g uses rotation i."""
        crt = self.crt
        num_p = crt.num_p

        ev = weakref.proxy(self)

        def impl(c0, c1, keys_b, keys_a, pls):
            ext0, ext1 = ev._ext_rotations(
                RnsPoly(c0, level, 0, True), RnsPoly(c1, level, 0, True),
                auto_idxs, ev._keys_of(auto_idxs, keys_b, keys_a))
            pl_it = iter(pls)
            outs = []
            for uses in pattern:
                acc0 = acc1 = None
                for e0, e1, used in zip(ext0, ext1, uses):
                    if not used:
                        continue
                    p = RnsPoly(next(pl_it), level, num_p, True)
                    t0 = P.mul(RnsPoly(e0, level, num_p, True), p, crt)
                    t1 = P.mul(RnsPoly(e1, level, num_p, True), p, crt)
                    acc0 = t0 if acc0 is None else P.add(acc0, t0, crt)
                    acc1 = t1 if acc1 is None else P.add(acc1, t1, crt)
                outs.append((P.mod_down(acc0, crt).data,
                             P.mod_down(acc1, crt).data))
            return outs

        return self._lift(impl, refs=(2, 3))

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
        lifted = lift.lift_msgs(msgs, qk, muh, mulo).reshape(r * len(idx), n)
        pn = ntt.ntt_fwd(lifted, crt.tables_for(idx * r)).view(r, len(idx), n)
        return (_sum_mod(pm.barrett_mul(pn, ext0, qk, muh, mulo), qk),
                _sum_mod(pm.barrett_mul(pn, ext1, qk, muh, mulo), qk))

    @timed("CKKS::rot_mac_groups_msgs_jit", keyswitch=True)
    def rot_mac_groups_msgs_jit(self, ct: Ciphertext, rots: list,
                                msgs: torch.Tensor) -> list:
        """[sum_i rot(ct, rots[i]) * encode(msgs[g, i]) for g] with the
        plaintexts given as level-independent int64 messages [G, R, N]
        (dense; zero rows contribute exact zeros): one digit
        decompose/mod-up for all rotations, the plaintext lift + NTT and
        the MACs in the QP basis, one mod-down per group and component,
        as one program per (automorphisms, G, level).

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
        level = ct.level
        auto_idxs, keys = self._rot_keys(rots)
        G = int(msgs.shape[0])
        pkey = ("rmgm", tuple(auto_idxs), G, level)
        fn = self._get_jit(pkey, self._mk_rot_mac_groups_msgs,
                           tuple(auto_idxs), level)
        outs = self._run(pkey, fn, keys, ct.c0.data, ct.c1.data,
                         *self._raw_planes(keys), msgs)
        pl_scale = self.params.scaling_factor
        return [Ciphertext(RnsPoly(o0, level, 0, True),
                           RnsPoly(o1, level, 0, True),
                           ct.scaling_factor * pl_scale, ct.sf_degree + 1,
                           ct.slots) for o0, o1 in outs]

    def _mk_rot_mac_groups_msgs(self, auto_idxs: tuple, level: int):
        """The bundle of rot_mac_groups_msgs_jit: the plaintext lift
        reproduces encoder.encode bit-exactly (lift.lift_msgs, then the
        same NTT tables); ace_tpu's lax.scan over groups is a loop."""
        crt = self.crt
        num_p = crt.num_p
        idx = crt.local(crt.limbs(level, num_p))

        ev = weakref.proxy(self)

        def impl(c0, c1, keys_b, keys_a, msgs):
            ext0, ext1 = (torch.stack(e) for e in  # [R, LK, N]
                          ev._ext_rotations(
                              RnsPoly(c0, level, 0, True),
                              RnsPoly(c1, level, 0, True), auto_idxs,
                              ev._keys_of(auto_idxs, keys_b, keys_a)))
            outs = []
            for g in range(msgs.shape[0]):
                acc0, acc1 = ev._mac_msgs(msgs[g], ext0, ext1, idx)
                outs.append((
                    P.mod_down(RnsPoly(acc0, level, num_p, True), crt).data,
                    P.mod_down(RnsPoly(acc1, level, num_p, True), crt).data))
            return outs

        return self._lift(impl, refs=(2, 3))

    # -- the bootstrap's BSGS level ---------------------------------------

    @timed("CKKS::bsgs_iter_jit", keyswitch=True)
    def bsgs_iter_jit(self, ct: Ciphertext, baby_rots: list,
                      giant_rots: list, msgs: torch.Tensor) -> Ciphertext:
        """One collapsed-FFT level of the bootstrap as baby-step/giant-step
        rotations (Rotate_iteration, ckks_bootstrap_context.c:1237-1383)
        as one program per (baby automorphisms, giant automorphisms,
        level); msgs: [len(giant_rots), len(baby_rots), N] int64
        messages. See _mk_bsgs_iter."""
        level = ct.level
        baby_idxs, baby_keys = self._rot_keys(baby_rots)
        giant_idxs, giant_keys = self._rot_keys(giant_rots)
        pkey = ("bsgs", tuple(baby_idxs), tuple(giant_idxs), level)
        fn = self._get_jit(pkey, self._mk_bsgs_iter, tuple(baby_idxs),
                           tuple(giant_idxs), level)
        d0, d1 = self._run(pkey, fn, baby_keys + giant_keys, ct.c0.data,
                           ct.c1.data, *self._raw_planes(baby_keys),
                           *self._raw_planes(giant_keys), msgs)
        return Ciphertext(RnsPoly(d0, level, 0, True),
                          RnsPoly(d1, level, 0, True),
                          ct.scaling_factor * self.params.scaling_factor,
                          ct.sf_degree + 1, ct.slots)

    def _mk_bsgs_iter(self, baby_idxs: tuple, giant_idxs: tuple,
                      level: int):
        """ace_tpu's _mk_bsgs_iter bookkeeping: baby rotations share one
        digit decompose/mod-up and stay in the QP basis (index 1 is the
        plain embedding _p_scale(., True)); group i's MACs against the
        messages msgs[i] accumulate in QP; group i's c0 joins the
        extended `first` accumulator by automorphism alone, and only its
        c1 is mod-downed and key-switched for the giant rotation; one
        final mod-down per component. The giant keys are taken in order
        for the giant steps after the first, as in ace_tpu (the first
        giant step is rotation 0). The baby keys are read one at a time
        (never stacked); each group's MACs are one _mac_msgs call."""
        crt = self.crt
        num_p = crt.num_p
        idx = crt.local(crt.limbs(level, num_p))

        ev = weakref.proxy(self)

        def impl(c0, c1, baby_kb, baby_ka, giant_kb, giant_ka, msgs):
            ext0, ext1 = (torch.stack(e) for e in  # [g, LK, N]
                          ev._ext_rotations(
                              RnsPoly(c0, level, 0, True),
                              RnsPoly(c1, level, 0, True), baby_idxs,
                              ev._keys_of(baby_idxs, baby_kb, baby_ka)))
            first = out0 = out1 = None
            gi = 0
            for i, gai in enumerate(giant_idxs):
                acc0, acc1 = (RnsPoly(d, level, num_p, True) for d in
                              ev._mac_msgs(msgs[i], ext0, ext1, idx))
                if i == 0:
                    first, out1 = acc0, acc1
                elif gai != 1:
                    gkey = ev._key_of(giant_kb[gi], giant_ka[gi])
                    gi += 1
                    c1q = P.mod_down(acc1, crt)
                    first = P.add(first, P.automorphism(acc0, gai, crt),
                                  crt)
                    e0, e1 = ev._switch_key_ext(
                        gkey, ev._switch_key_digits(c1q), level)
                    a0 = P.automorphism(e0, gai, crt)
                    out0 = a0 if out0 is None else P.add(out0, a0, crt)
                    out1 = P.add(out1, P.automorphism(e1, gai, crt), crt)
                else:
                    first = P.add(first, acc0, crt)
                    out1 = P.add(out1, acc1, crt)
            out0 = first if out0 is None else P.add(out0, first, crt)
            return P.mod_down(out0, crt).data, P.mod_down(out1, crt).data

        return self._lift(impl, refs=(2, 3, 4, 5))


def _sum_mod(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """x[0] + ... + x[k-1] mod q by a pairwise add_mod tree (ceil(log2 k)
    launches)."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        s = modops.add_mod(x[:h], x[h:2 * h], q)
        x = torch.cat([s, x[2 * h:]]) if x.shape[0] % 2 else s
    return x[0]
