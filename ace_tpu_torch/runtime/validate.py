"""Runtime validation: shadow plaintext execution next to cipher ops.

The `ace_tpu.runtime.validate` analog of the reference's `-VEC:rtt`
machinery (the `*_MSG` shadow ops + CORE VALIDATE statements, rtlib
cipher_valid.c:20-165): every slot-VM op runs both encrypted and in the
clear; `check()` decrypts the ciphertext on the context's device, decodes
it and compares against the shadow message within epsilon, raising on
divergence with the op that produced it. Like FheContext.handle_output
(and unlike ace_tpu's check), it first drops the ciphertext to the
decode floor: the decoded values are the same, and the host's exact-CRT
work of a check no longer grows with the ciphertext's level.

The backend has no rot_ext_mac_groups or rot_sum, so a validated conv
takes packing's unfused path: the shadow sees every rotation.
"""

from __future__ import annotations

import numpy as np

from ace_tpu_torch.compiler.packing import PlainBackend


class ValidationError(AssertionError):
    pass


class Shadow:
    """A (ciphertext, plain message) pair flowing through the slot VM."""

    __slots__ = ("ct", "msg")

    def __init__(self, ct, msg):
        self.ct = ct
        self.msg = msg


class ValidatingBackend:
    """Slot backend running FheBackend and PlainBackend in lockstep.

    check_every: validate after every op (expensive, like per-op
    VALIDATE statements); otherwise only on explicit check() calls.
    """

    def __init__(self, fhe_backend, epsilon: float = 1e-2,
                 check_every: bool = False, trace=None):
        self.fhe = fhe_backend
        self.plain = PlainBackend(fhe_backend.n_slots)
        self.n_slots = fhe_backend.n_slots
        self.epsilon = epsilon
        self.check_every = check_every
        self.trace = trace or (lambda s: None)
        self._op_count = 0

    # -- validation -------------------------------------------------------

    def check(self, s: Shadow, what: str = "") -> None:
        """Validate(ciph, msg, len, epsilon) (cipher_valid.c:20-53)."""
        ev = self.fhe.ev
        ct = ev.mod_switch_to_decode_floor(s.ct)
        got = ev.encoder.decode(ev.decrypt(ct)).real
        want = np.asarray(s.msg)[:len(got)]
        err = np.max(np.abs(got[:len(want)] - want))
        self.trace(f"[VALIDATE] {what or self._op_count}: max_err={err:.3e}")
        if not np.isfinite(err) or err > self.epsilon:
            bad = int(np.argmax(np.abs(got[:len(want)] - want)))
            raise ValidationError(
                f"validation failed at op {what or self._op_count}: "
                f"slot {bad} got {got[bad]} want {want[bad]} "
                f"(max_err {err:.3e} > eps {self.epsilon})")

    def _wrap(self, name, ct, msg) -> Shadow:
        s = Shadow(ct, msg)
        self._op_count += 1
        if self.check_every:
            self.check(s, name)
        return s

    # -- slot VM ops (both worlds) ----------------------------------------

    def rotate(self, s: Shadow, k: int) -> Shadow:
        return self._wrap("rotate", self.fhe.rotate(s.ct, k),
                          self.plain.rotate(s.msg, k))

    def add(self, a: Shadow, b: Shadow) -> Shadow:
        return self._wrap("add", self.fhe.add(a.ct, b.ct), a.msg + b.msg)

    def sub(self, a: Shadow, b: Shadow) -> Shadow:
        return self._wrap("sub", self.fhe.sub(a.ct, b.ct), a.msg - b.msg)

    def mul(self, a: Shadow, b: Shadow) -> Shadow:
        return self._wrap("mul", self.fhe.mul(a.ct, b.ct), a.msg * b.msg)

    def square(self, a: Shadow) -> Shadow:
        return self._wrap("square", self.fhe.square(a.ct), a.msg * a.msg)

    def mul_plain(self, s: Shadow, w: np.ndarray) -> Shadow:
        return self._wrap("mul_plain", self.fhe.mul_plain(s.ct, w),
                          self.plain.mul_plain(s.msg, w))

    def add_plain(self, s: Shadow, w: np.ndarray) -> Shadow:
        return self._wrap("add_plain", self.fhe.add_plain(s.ct, w),
                          self.plain.add_plain(s.msg, w))

    def rotations_hoisted(self, s: Shadow, ks) -> list:
        cts = self.fhe.rotations_hoisted(s.ct, ks)
        return [self._wrap("rot_hoisted", ct, self.plain.rotate(s.msg, k))
                for ct, k in zip(cts, ks)]

    def _norm(self, s: Shadow) -> Shadow:
        return Shadow(self.fhe._norm(s.ct), s.msg)

    def relu(self, s: Shadow, value_range: float = 3.0,
             mul_depth: int = 13, bootstrap: bool = False) -> Shadow:
        return self._wrap(
            "relu", self.fhe.relu(s.ct, value_range, mul_depth, bootstrap),
            np.maximum(s.msg, 0))
