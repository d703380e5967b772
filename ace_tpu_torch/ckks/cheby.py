"""Chebyshev-series evaluation on ciphertexts (Paterson-Stockmeyer).

Replicates the reference's OpenFHE-style algorithm
(fhe-cmplr/rtlib/ant/src/util/ckks_chebyshev.c): degree-split table
(Compute_degree_ps :74), Chebyshev-basis long division
(Long_div_chebyshev :121), baby/giant power ladders with the even-poly
optimization, and the recursive inner evaluation (:330-587). Used by
the ReLU sign composite and the bootstrap sine approximation.
"""

from __future__ import annotations

import math

import numpy as np

from ace_tpu_torch.ckks.cipher import Ciphertext

_UPPER_BOUND_PS = 2204


def _populate_param_ps() -> np.ndarray:
    ranges = [2, 11, 13, 17, 55, 59, 76, 239, 247, 284, 991, 1007, 1083,
              2015, 2031, _UPPER_BOUND_PS]
    values = [1, 2, 3, 2, 3, 4, 3, 4, 5, 4, 5, 6, 5, 6, 7, 6]
    out = np.zeros(_UPPER_BOUND_PS)
    j = 0
    for r, v in zip(ranges, values):
        out[j:r] = v
        j = r
    return out


_PARAM_PS = _populate_param_ps()


def degree_of(coeffs) -> int:
    deg = 1
    for i in range(len(coeffs) - 1, 0, -1):
        if coeffs[i] == 0:
            deg += 1
        else:
            break
    return len(coeffs) - deg


def is_even_poly(coeffs) -> bool:
    d = degree_of(coeffs)
    return all(coeffs[i] == 0 for i in range(1, d + 1, 2))


def compute_degree_ps(n: int) -> tuple[int, int]:
    assert n > 0
    if n <= _UPPER_BOUND_PS:
        m = int(_PARAM_PS[n - 1])
        k = n // ((1 << m) - 1) + 1
        return k, m
    raise NotImplementedError("degree > 2204")


def _is_not_one(v: float) -> bool:
    prec = 2.0 ** -20
    return (1 - prec >= v) or (1 + prec <= v)


def long_div_chebyshev(f: list[float], g: list[float]
                       ) -> tuple[list[float], list[float]]:
    """f = q*g + r in the Chebyshev basis; all coefficient lists use
    the PLAIN series convention (c0 means c0, not c0/2).

    Correct product-rule division replacing the ckks_chebyshev.c:121-228
    port: that code stores the quotient's constant doubled AND is later
    fed its own quotient back as a divisor, which mis-divides whenever
    the divisor's low-order coefficients get touched — latent for every
    polynomial the reference routes through this path (its depth-13
    chain peaks at degree 27), but wrong at e.g. degrees 21 and 29
    (the depth-9 pair's top degree). Subtracting
    c * T_{n-k} * g termwise via T_a T_b = (T_{a+b} + T_{|a-b|})/2 is
    exact for every degree, verified against chebval identities.
    """
    n = degree_of(f)
    k = degree_of(g)
    r = list(f[:n + 1]) + [0.0] * max(0, 0)
    if n < k:
        return [0.0], list(r)
    q = [0.0] * (n - k + 1)
    while n >= k:
        d = n - k
        lead_factor = 0.5 if (d > 0 and k > 0) else 1.0
        c = r[n] / (g[k] * lead_factor)
        q[d] += c
        # r -= c * T_d * g
        for j in range(k + 1):
            if g[j] == 0.0:
                continue
            if d == 0 or j == 0:
                r[max(d, j)] -= c * g[j]
            else:
                half = 0.5 * c * g[j]
                r[d + j] -= half
                r[abs(d - j)] -= half
        r[n] = 0.0  # exact cancellation by construction
        while n > 0 and r[n] == 0.0:
            n -= 1
        r = r[:n + 1]
        if n == 0 and r[0] == 0.0:
            break
    return q, r


class ChebyEvaluator:
    """Ciphertext Chebyshev-series evaluation bound to an Evaluator."""

    def __init__(self, ev):
        self.ev = ev

    # -- ciphertext helpers ---------------------------------------------

    def _align(self, a: Ciphertext, level: int) -> Ciphertext:
        while a.level > level:
            a = self.ev.mod_switch(a)
        return a

    def _double_rescale(self, prod: Ciphertext) -> Ciphertext:
        """rescale(prod + prod) — the 2*T_a*T_b step."""
        return self.ev.rescale(self.ev.add(prod, prod))

    def _linear_wsum(self, ciphs, weights) -> Ciphertext:
        """sum_i w_i * c_i with a single trailing rescale
        (Eval_linear_wsum_mutable, ckks_chebyshev.c:243-268)."""
        out = None
        for c, w in zip(ciphs, weights):
            if w == 0.0:
                continue
            t = self.ev.mul_const(c, float(w))
            out = t if out is None else self.ev.add(out, t)
        assert out is not None
        return self.ev.rescale(out)

    def _eval_small(self, coeffs, t_list, k) -> Ciphertext:
        """Evaluate a degree<=k series against the baby list T_1..T_k
        (plain-convention c0).

        The leading coefficient of a PS quotient/remainder is a small
        integer (2^j from the Chebyshev division rule / 1 for monic
        remainders) multiplying the LARGEST baby step; it must be
        applied by exact ciphertext additions at the ladder's own
        scale. Routing it through mul_const+rescale would re-scale the
        dominant term by Delta/q_level — a ~2^-20 relative drift that,
        multiplied by |T_K| values far outside [-1,1] (the composite
        stages legitimately reach +-1.8), wrecks the final cancellation
        (observed: 3.6 absolute error at d=15, |u|<=1.83). This is the
        real reason for Eval_quot_or_rem's checking-and-summing comment
        (ckks_chebyshev.c:334-340)."""
        ev = self.ev
        dg = degree_of(coeffs)
        assert 1 <= dg <= k, (dg, k)
        lead = float(coeffs[dg])
        exact_lead = lead.is_integer() and 1 <= lead <= 64
        body = list(coeffs[1:dg]) if exact_lead else coeffs[1:dg + 1]
        out = None
        if any(w != 0.0 for w in body):
            out = self._linear_wsum(t_list[:len(body)], body)
        if exact_lead:
            s = t_list[dg - 1]
            n = int(lead)
            acc = None
            while n:
                if n & 1:
                    acc = s if acc is None else ev.add(acc, s)
                n >>= 1
                if n:
                    s = ev.add(s, s)
            out = acc if out is None else ev.add(out, acc)
        return ev.add_const(out, coeffs[0])

    def _inner(self, coeffs, k, m, t_list, t2_list) -> Ciphertext:
        """Paterson-Stockmeyer recursion, rebuilt from the identity
        (replaces the Inner_eval_chebyshev_ps port, whose
        doubled-constant bookkeeping mis-evaluated many degrees — see
        long_div_chebyshev's docstring):

          f = q * T_K + r                 (K = k*2^(m-1))
          r - T_{K-k} = c * q + s'        (deg c < k)
          f = (T_K + c) * q + (s' + T_{K-k})

        with q and s = s' + T_{K-k} both of degree K-k = the m-1
        recursion shape, evaluated recursively; c and any deg<=k piece
        evaluated directly against the baby list."""
        ev = self.ev
        if degree_of(coeffs) <= k:
            return self._eval_small(coeffs, t_list, k)
        K = k * (1 << (m - 1))
        tK = [0.0] * (K + 1)
        tK[-1] = 1.0
        div_q, div_r = long_div_chebyshev(coeffs, tK)

        r2 = list(div_r) + [0.0] * max(0, K - k + 1 - len(div_r))
        r2[K - k] -= 1.0
        r2 = r2[:degree_of(r2) + 1]
        c, s2r = long_div_chebyshev(r2, div_q)
        s2 = list(s2r) + [0.0] * max(0, K - k + 1 - len(s2r))
        s2[K - k] += 1.0
        s2 = s2[:degree_of(s2) + 1]

        qu = self._inner(div_q, k, m - 1, t_list, t2_list)
        su = self._inner(s2, k, m - 1, t_list, t2_list)

        dc = degree_of(c)
        cu = None
        if dc >= 1:
            cu = self._linear_wsum(t_list[:dc], c[1:dc + 1])
            cu = ev.add_const(cu, c[0])
        elif c[0] != 0.0:
            cu = None  # constant folded below

        t2m1 = t2_list[m - 1]
        if cu is not None:
            cu = self._align(cu, t2m1.level)
            out = ev.add(t2m1, cu)
        else:
            out = ev.add_const(t2m1, c[0])
        out = ev.rescale(ev.mul(out, qu))
        out = ev.add(out, su)
        return out

    # -- public entry ----------------------------------------------------

    def eval_chebyshev(self, ct: Ciphertext, coeffs, a: float = -1.0,
                       b: float = 1.0) -> Ciphertext:
        """Eval_chebyshev_ps (ckks_chebyshev.c:431-587)."""
        ev = self.ev
        coeffs = [float(c) for c in coeffs]
        # public contract (reference ckks_chebyshev.c:227,323): the
        # caller's constant term is stored DOUBLED; internal math is
        # plain-convention, so halve it here
        coeffs[0] = coeffs[0] / 2
        n = degree_of(coeffs)
        even = is_even_poly(coeffs)
        f2 = list(coeffs[:n + 1] if coeffs[-1] == 0 else coeffs)
        k, m = compute_degree_ps(n)
        if even and k % 2 == 1:
            k += 1

        # baby steps T_1..T_k
        t_list: list[Ciphertext] = [None] * k
        if abs(a + 1) < 1e-10 and abs(b - 1) < 1e-10:
            t_list[0] = ct
        else:
            alpha = 2.0 / (b - a)
            beta = alpha * a
            t0 = ev.rescale(ev.mul_const(ct, alpha))
            t_list[0] = ev.add_const(t0, -1.0 - beta)
        y = t_list[0]
        for i in range(2, k + 1):
            j = i - 1
            if (i & (i - 1)) == 0:  # power of two: T_2a = 2 T_a^2 - 1
                th = t_list[i // 2 - 1]
                tj = self._double_rescale(ev.mul(th, th))
                t_list[j] = ev.add_const(tj, -1.0)
            elif i % 2 == 1:
                if even:
                    continue
                prod = ev.mul(t_list[i // 2 - 1], t_list[i // 2])
                tj = self._double_rescale(prod)
                t_list[j] = ev.sub(tj, self._align(y, tj.level))
            else:
                ih1 = i // 2
                if even and ih1 % 2 == 1:
                    ih1 += 1
                ih2 = i - ih1
                prod = ev.mul(t_list[ih1 - 1], t_list[ih2 - 1])
                tj = self._double_rescale(prod)
                if ih1 == ih2:
                    t_list[j] = ev.add_const(tj, -1.0)
                else:
                    t_list[j] = ev.sub(tj, self._align(t_list[1], tj.level))

        # align all baby steps to T_k's level
        tk_level = t_list[k - 1].level
        for i in range(1, k):
            if even and i % 2 == 1:
                continue
            t_list[i - 1] = self._align(t_list[i - 1], tk_level)

        # giant steps T_{k*2^i}
        t2_list = [t_list[k - 1]]
        for i in range(1, m):
            prod = ev.mul(t2_list[i - 1], t2_list[i - 1])
            t2i = ev.add_const(self._double_rescale(prod), -1.0)
            t2_list.append(t2i)

        # T_{k*(2^m - 1)}
        t2km1 = t2_list[0]
        for i in range(1, m):
            dr = self._double_rescale(ev.mul(t2km1, t2_list[i]))
            t2km1 = ev.sub(dr, self._align(t2_list[0], dr.level))

        k2m2k = k * (1 << (m - 1)) - k
        f2 = f2 + [0.0] * (2 * k2m2k + k + 1 - len(f2))
        f2[-1] = 1.0

        out = self._inner(f2, k, m, t_list, t2_list)
        out = ev.sub(out, self._align(t2km1, out.level))
        return out
