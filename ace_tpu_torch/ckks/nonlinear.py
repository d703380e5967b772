"""Nonlinear FHE primitives beyond ReLU: exp, reciprocal, rsqrt, and
slot-block reductions/broadcasts.

These extend the scheme layer past the reference's capability set (the
reference's only approximated nonlinearity is the composite-sign ReLU,
fhe-cmplr/util/src/app_composite_poly.cxx) to what an encrypted
transformer block needs: softmax = exp + reciprocal, RMSNorm = rsqrt.

All approximations are Chebyshev interpolants evaluated with the
Paterson-Stockmeyer engine (`ckks/cheby.py`, the Eval_chebyshev_ps
analog) plus Goldschmidt/Newton refinement where a known output
identity lets one cheap iteration buy several polynomial degrees.

The same functions as `ace_tpu.ckks.nonlinear`, over the port's
evaluator and encoder: they compose existing ops (square, mul,
mul_const, add_const, mul_plain, rotate, rescale, encode_cached) and
run on the device of the evaluator they are given.
"""

from __future__ import annotations

import numpy as np
from numpy.polynomial import chebyshev as _cheb

from ace_tpu_torch.ckks.cheby import ChebyEvaluator


def chebyshev_coeffs(fn, a: float, b: float, degree: int) -> list:
    """Chebyshev interpolant coefficients of fn on [a, b] in the
    convention eval_chebyshev consumes: the constant term is stored
    DOUBLED (evaluation uses coeffs[0]/2, matching the reference's
    tables — ckks_chebyshev.c:227,323)."""
    c = _cheb.Chebyshev.interpolate(fn, degree, domain=[a, b])
    out = [float(v) for v in c.coef]
    out[0] *= 2.0
    return out


def eval_fn(ev, ct, fn, a: float, b: float, degree: int):
    """Evaluate an arbitrary scalar function elementwise on the slots
    of `ct` (valid for slot values in [a, b])."""
    coeffs = chebyshev_coeffs(fn, a, b, degree)
    return ChebyEvaluator(ev).eval_chebyshev(ct, coeffs, a, b)


def exp(ev, ct, a: float, b: float, degree: int = 13):
    """e^x for slot values in [a, b]."""
    return eval_fn(ev, ct, np.exp, a, b, degree)


def reciprocal(ev, ct, x_max: float, iters: int = 3):
    """1/x for slot values in (0, x_max] via Goldschmidt iteration
    (Cheon et al., "Numerical Method for Comparison on Homomorphically
    Encrypted Numbers", Algorithm Inv): with t = x/x_max in (0, 1],
      e_0 = 1 - t,  y_0 = 2 - t,
      y_{k+1} = y_k (1 + e_k^{2^{k+1}}) via e_{k+1} = e_k^2,
    converging to 1/t; divide by x_max at the end (folded into the
    last multiplication's plaintext scale).

    Depth: 2 per iteration + 1. Relative error <= e_0^(2^(iters+1)),
    so accuracy is set by how far x/x_max stays above 0.
    """
    if iters < 1:
        raise ValueError(
            "reciprocal needs iters >= 1: the 1/x_max fold happens in "
            "the last iteration, so iters=0 would return ~x_max/x")
    inv_max = 1.0 / x_max
    t_neg = ev.mul_const(ct, -inv_max)          # -t
    t_neg = ev.rescale(t_neg)
    e = ev.add_const(t_neg, 1.0)                # e = 1 - t
    y = ev.add_const(t_neg, 2.0)                # y = 2 - t
    for k in range(iters):
        e = ev.rescale(ev.square(e))            # e <- e^2
        step = ev.add_const(e, 1.0)             # 1 + e
        if k == iters - 1:
            step = ev.rescale(ev.mul_const(step, inv_max))
        y = ev.rescale(ev.mul(y, step))         # mul level-adjusts
    return y


def rsqrt(ev, ct, lo: float, hi: float, degree: int = 15,
          newton_iters: int = 1):
    """1/sqrt(x) for slot values in [lo, hi] (lo > 0): Chebyshev
    initial estimate + Newton steps y <- y (3 - x y^2) / 2."""
    y = eval_fn(ev, ct, lambda v: 1.0 / np.sqrt(v), lo, hi, degree)
    for _ in range(newton_iters):
        y2 = ev.rescale(ev.square(y))
        xy2 = ev.rescale(ev.mul(ct, y2))
        half = ev.rescale(ev.mul_const(xy2, -0.5))
        corr = ev.add_const(half, 1.5)           # (3 - x y^2)/2
        y = ev.rescale(ev.mul(y, corr))
    return y


# -- slot-block reductions / broadcasts ------------------------------------

def block_sum(ev, ct, block: int):
    """Sum over contiguous aligned blocks of `block` slots; the total
    lands in the FIRST slot of each block (other in-block slots hold
    partial/cross-block sums — mask before use). log2(block) rotations.
    """
    step = 1
    while step < block:
        ct = ev.add(ct, ev.rotate(ct, step))
        step *= 2
    return ct


def broadcast_first(ev, ct, block: int, total: int, encoder, *,
                    mask_scale=None):
    """Replicate each block's first slot across its block: mask column
    0 of every block (depth 1), then log2(block) negative rotations.
    `total` = number of live slots (seq*block); mask zeroes the rest.
    mask_scale: optional per-block scalar (or vector over blocks)
    folded into the mask plaintext for free."""
    n_blocks = total // block
    mask = np.zeros(total, np.complex128)
    scale = np.ones(n_blocks) if mask_scale is None else \
        np.broadcast_to(np.asarray(mask_scale, np.float64), (n_blocks,))
    mask[np.arange(n_blocks) * block] = scale
    pt = encoder.encode_cached(mask, level=ct.level, slots=len(mask))
    ct = ev.rescale(ev.mul_plain(ct, pt))
    step = 1
    while step < block:
        ct = ev.add(ct, ev.rotate(ct, -step))
        step *= 2
    return ct


def block_sum_replicated(ev, ct, block: int, total: int, encoder, *,
                         mask_scale=None):
    """Each slot gets (scaled) sum of its block: block_sum then
    broadcast. 2*log2(block) rotations, depth 1."""
    return broadcast_first(ev, block_sum(ev, ct, block), block, total,
                           encoder, mask_scale=mask_scale)


def mask_mul(ev, ct, mask_values, encoder):
    """Multiply by a plaintext 0/1 (or scaled) mask. Depth 1."""
    vals = np.asarray(mask_values, np.complex128)
    pt = encoder.encode_cached(vals, level=ct.level, slots=len(vals))
    return ev.rescale(ev.mul_plain(ct, pt))
