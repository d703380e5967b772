"""Exact level-consumption oracle: run the real op-stream builders
against a simulated evaluator that only tracks (level, sf_degree).

The reference hard-codes depth constants (relu 9/11/13, bootstrap 15/19
— scheme_info.cxx:30-36) that must be kept in sync with its runtime by
hand. We instead *execute* our own ReLU composite / Chebyshev /
bootstrap schedules on a fake ciphertext, so the parameter policy can
never drift from the kernels' true rescale counts.
"""

from __future__ import annotations

import dataclasses
import functools

_BIG = 1000


@dataclasses.dataclass
class SimCipher:
    level: int
    sf_degree: int
    slots: int = 0

    @property
    def scaling_factor(self):
        return 2.0 ** (40 * self.sf_degree)


class SimEvaluator:
    """Level/scale-only mirror of ckks.evaluator.Evaluator."""

    def _adjust(self, a, b):
        lv = min(a.level, b.level)
        return (SimCipher(lv, a.sf_degree, a.slots),
                SimCipher(lv, b.sf_degree, b.slots))

    def add(self, a, b):
        a, b = self._adjust(a, b)
        assert a.sf_degree == b.sf_degree, "scale mismatch in sim add"
        return SimCipher(a.level, a.sf_degree, a.slots)

    sub = add

    def add_const(self, a, v):
        return SimCipher(a.level, a.sf_degree, a.slots)

    def mul(self, a, b):
        a, b = self._adjust(a, b)
        return SimCipher(a.level, a.sf_degree + b.sf_degree, a.slots)

    def square(self, a):
        return self.mul(a, a)

    def mul_const(self, a, v):
        return SimCipher(a.level, a.sf_degree + 1, a.slots)

    def mul_integer(self, a, k):
        return SimCipher(a.level, a.sf_degree, a.slots)

    def mul_plain(self, a, p):
        return SimCipher(a.level, a.sf_degree + 1, a.slots)

    def rescale(self, a):
        assert a.level > 1, "sim: out of levels"
        return SimCipher(a.level - 1, a.sf_degree - 1, a.slots)

    def mod_switch(self, a):
        return SimCipher(a.level - 1, a.sf_degree, a.slots)

    def rotate(self, a, k):
        return SimCipher(a.level, a.sf_degree, a.slots)

    def conjugate(self, a):
        return SimCipher(a.level, a.sf_degree, a.slots)

    def rotations_hoisted(self, a, ks):
        return [SimCipher(a.level, a.sf_degree, a.slots) for _ in ks]

    def mul_by_monomial(self, a, p):
        return SimCipher(a.level, a.sf_degree, a.slots)


@functools.lru_cache(maxsize=None)
def chebyshev_depth(coeffs: tuple) -> int:
    """Levels consumed by ChebyEvaluator.eval_chebyshev on these coeffs."""
    from ace_tpu_torch.ckks.cheby import ChebyEvaluator
    ev = SimEvaluator()
    out = ChebyEvaluator(ev).eval_chebyshev(SimCipher(_BIG, 1), list(coeffs))
    # normalize the tail scale too: consumers rescale to sf 1
    while out.sf_degree > 1:
        out = ev.rescale(out)
    return _BIG - out.level


@functools.lru_cache(maxsize=None)
def relu_depth(mul_depth: int = 13, value_range: float = 3.0) -> int:
    """Levels consumed by ckks.relu.relu (prescale + sign chain + merge)."""
    from ace_tpu_torch.ckks import relu as relu_mod
    ev = SimEvaluator()
    out = relu_mod.relu(ev, SimCipher(_BIG, 1), value_range, mul_depth)
    while out.sf_degree > 1:
        out = ev.rescale(out)
    return _BIG - out.level


@functools.lru_cache(maxsize=None)
def bootstrap_depth(hamming_weight: int, budget_enc: int = 3,
                    budget_dec: int = 3) -> int:
    """Levels consumed by BootstrapContext.bootstrap after mod-raise.

    Structure mirrors ckks.bootstrap.BootstrapContext.bootstrap:
    CoeffsToSlots (budget_enc rescales + 1 trailing), approx-mod
    (Chebyshev sine + double-angle squarings), SlotsToCoeffs
    (budget_dec + trailing rescale to sf 1).
    """
    from ace_tpu_torch.ckks import bootstrap as B
    if 0 < hamming_weight <= 192:
        sine = tuple(B.SINE_COEFFS_HW_192)
        r = B.R_UNIFORM_HW_192
    else:
        sine = tuple(B.SINE_COEFFS_UNIFORM)
        r = B.R_UNIFORM
    cheby = chebyshev_depth(sine)
    # each C2S/S2C collapsed level = one mul_plain + rescale
    return budget_enc + cheby + r + budget_dec + 1


class SimBackend:
    """Slot-VM backend over SimCipher: symbolically executes the packed
    program to measure exact level consumption per bootstrap segment
    (the forward analog of the reference's demand-driven SSA level
    analysis, core/src/ctx_param_ana.cxx:40-60 + Handle_bootstrap)."""

    def __init__(self, n_slots: int, relu_bootstrap_depth: int = 0):
        self.n_slots = n_slots
        self.ev = SimEvaluator()
        self.segments = []          # levels consumed between resets
        self._start = _BIG
        self.bts_depth = relu_bootstrap_depth

    def _norm(self, ct):
        while ct.sf_degree > 1:
            ct = self.ev.rescale(ct)
        return ct

    def pack(self, flat):
        return SimCipher(_BIG, 1)

    def rotate(self, ct, k):
        return ct

    def rotations_hoisted(self, ct, ks):
        return [ct for _ in ks]

    def add(self, a, b):
        if a.sf_degree != b.sf_degree:
            a, b = self._norm(a), self._norm(b)
        return self.ev.add(a, b)

    sub = add

    def add_plain(self, ct, w):
        return ct

    def mul_plain(self, ct, w):
        return self.ev.mul_plain(self._norm(ct), w)

    def mul(self, a, b):
        return self.ev.mul(self._norm(a), self._norm(b))

    def square(self, a):
        a = self._norm(a)
        return self.ev.mul(a, a)

    def relu(self, ct, value_range=3.0, mul_depth=13, bootstrap=False):
        from ace_tpu_torch.ckks import relu as relu_mod
        ct = self._norm(ct)
        if bootstrap:
            self.segments.append(self._start - ct.level)
            ct = SimCipher(_BIG, 1, ct.slots)
            self._start = _BIG
        return relu_mod.relu(self.ev, ct, value_range, mul_depth)

    def finish(self, ct):
        ct = self._norm(ct)
        self.segments.append(self._start - ct.level)
        return max(self.segments)


def segment_levels(graph, n_slots: int, relu_ranges=None,
                   relu_range_default: float = 3.0,
                   relu_mul_depth: int = 13,
                   use_bootstrap: bool = True) -> list:
    """Exact per-bootstrap-segment level consumption of the packed
    program: segments[0] is input->first bootstrap (which bounds the
    minimal encryption level), the max bounds the q-chain."""
    from ace_tpu_torch.compiler.lowering import GraphRunner
    be = SimBackend(n_slots)
    runner = GraphRunner(graph, be, relu_ranges=relu_ranges,
                         relu_range_default=relu_range_default,
                         relu_mul_depth=relu_mul_depth,
                         bootstrap_before_relu=use_bootstrap)
    out = runner.run(be.pack(None))
    be.finish(out)
    return list(be.segments)


def required_levels(graph, n_slots: int, relu_ranges=None,
                    relu_range_default: float = 3.0,
                    relu_mul_depth: int = 13,
                    use_bootstrap: bool = True) -> int:
    """Exact max bootstrap-segment consumption of the packed program."""
    return max(segment_levels(
        graph, n_slots, relu_ranges=relu_ranges,
        relu_range_default=relu_range_default,
        relu_mul_depth=relu_mul_depth, use_bootstrap=use_bootstrap))
