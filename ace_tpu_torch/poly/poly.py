"""RNS polynomial ops on [num_limbs, N] int64 residue tensors.

The POLYNOMIAL layer of `ace_tpu.poly.poly` (the reference's
polynomial.c) as plain functions on torch tensors; `RnsPoly` carries the
data and its static (num_q, num_p, is_ntt).

Exact-semantics sources:
  add/sub/mul:        polynomial.c (elementwise per limb, canonical mod q)
  automorphism:       polynomial.c:299-360, number_theory.c:201-226
  fast base conv:     polynomial.c:755-846 (Shoup premul, 128-bit
                      accumulation, Barrett-128 reduction)
  decompose/mod-up:   polynomial.c:848-926 (digit extract + raise to
                      complement basis, NTT splice)
  mod-down:           polynomial.c:928-966 (P->Q conv, (x - conv) * P^-1)
  mod-raise:          ckks_bootstrap_context.c:1527-1550 (centered lift
                      of the last tower to the whole chain)
  rescale:            polynomial.c:1097-1196 (NTT path: switch-modulus of
                      the dropped limb + per-limb correction)

Kernels: `mul` and mod-down's P^-1 product go through K1
(modops.barrett_mul_d), `mul_scalars` and rescale's q_l^-1 product
through K2 (modops.shoup_mul_d), every NTT through K3/K4.

Limb shard (CrtContext.shard): a poly's data holds this rank's rows
only. Elementwise ops, `mul_scalars`, the NTTs and `automorphism` run on
them with no communication (the automorphism permutes coefficients, not
limbs). Only the conversions that contract over limbs communicate, and
they gather the source rows rather than sum the target rows: mod-up
gathers its digit's rows, mod-down the P rows, rescale and mod-raise
take one row from its owner. Each rank then converts into the rows it
owns, so every row is computed as without the shard.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ace_tpu_torch.ops import modops, ntt
from ace_tpu_torch.poly.rns import CrtContext


@dataclasses.dataclass
class RnsPoly:
    """RNS polynomial: data [num_q + num_p, N] int64 canonical residues."""
    data: torch.Tensor
    num_q: int
    num_p: int
    is_ntt: bool

    @property
    def degree(self) -> int:
        return self.data.shape[-1]


def _limb_indices(p: RnsPoly, ctx: CrtContext) -> list[int]:
    """Global limbs of p's local rows."""
    return ctx.local(ctx.limbs(p.num_q, p.num_p))


def _mods(p: RnsPoly, ctx: CrtContext):
    return ctx.mod_arrays(_limb_indices(p, ctx))


def add(a: RnsPoly, b: RnsPoly, ctx: CrtContext) -> RnsPoly:
    assert a.num_q == b.num_q and a.num_p == b.num_p and a.is_ntt == b.is_ntt
    q, _, _ = _mods(a, ctx)
    return RnsPoly(modops.add_mod(a.data, b.data, q), a.num_q, a.num_p,
                   a.is_ntt)


def sub(a: RnsPoly, b: RnsPoly, ctx: CrtContext) -> RnsPoly:
    assert a.num_q == b.num_q and a.num_p == b.num_p and a.is_ntt == b.is_ntt
    q, _, _ = _mods(a, ctx)
    return RnsPoly(modops.sub_mod(a.data, b.data, q), a.num_q, a.num_p,
                   a.is_ntt)


def neg(a: RnsPoly, ctx: CrtContext) -> RnsPoly:
    q, _, _ = _mods(a, ctx)
    return RnsPoly(modops.neg_mod(a.data, q), a.num_q, a.num_p, a.is_ntt)


def mul(a: RnsPoly, b: RnsPoly, ctx: CrtContext) -> RnsPoly:
    """Pointwise product (NTT form = negacyclic polynomial product)."""
    assert a.is_ntt and b.is_ntt
    assert a.num_q == b.num_q and a.num_p == b.num_p
    q, mu_hi, mu_lo = _mods(a, ctx)
    return RnsPoly(modops.barrett_mul_d(a.data, b.data, q, mu_hi, mu_lo),
                   a.num_q, a.num_p, a.is_ntt)


def mac(acc: RnsPoly, a: RnsPoly, b: RnsPoly, ctx: CrtContext) -> RnsPoly:
    """acc + a*b (pointwise, NTT form)."""
    return add(acc, mul(a, b, ctx), ctx)


def _shoup_cols(ctx: CrtContext, vals, qs):
    """(w, w_prec) [len, 1] device columns for per-limb scalars."""
    ws = [v % q for v, q in zip(vals, qs)]
    return (ctx.column(ws),
            ctx.column([modops.precompute_shoup(w, q)
                        for w, q in zip(ws, qs)]))


def mul_scalars(a: RnsPoly, scalars: list[int], ctx: CrtContext) -> RnsPoly:
    """Per-limb constant multiply with Shoup precompute; `scalars` has
    one entry per limb of a (all of them, the shard picks its own)."""
    scalars = ctx.select(scalars, ctx.limbs(a.num_q, a.num_p))
    idx = _limb_indices(a, ctx)
    qs = [ctx.all_primes[i] for i in idx]
    w, w_prec = _shoup_cols(ctx, scalars, qs)
    q, _, _ = _mods(a, ctx)
    return RnsPoly(modops.shoup_mul_d(a.data, w, w_prec, q),
                   a.num_q, a.num_p, a.is_ntt)


# ---------------------------------------------------------------------------
# NTT conversions
# ---------------------------------------------------------------------------

def to_ntt(a: RnsPoly, ctx: CrtContext) -> RnsPoly:
    assert not a.is_ntt
    t = ctx.tables_for(_limb_indices(a, ctx))
    return RnsPoly(ntt.ntt_fwd(a.data, t), a.num_q, a.num_p, True)


def from_ntt(a: RnsPoly, ctx: CrtContext) -> RnsPoly:
    assert a.is_ntt
    t = ctx.tables_for(_limb_indices(a, ctx))
    return RnsPoly(ntt.ntt_inv(a.data, t), a.num_q, a.num_p, False)


# ---------------------------------------------------------------------------
# Automorphism (rotation / conjugation)
# ---------------------------------------------------------------------------

def automorphism(a: RnsPoly, auto_idx: int, ctx: CrtContext) -> RnsPoly:
    """Galois automorphism x -> x^auto_idx.

    NTT form: pure slot permutation (number_theory.c:207-214). Coeff
    form: index permutation with sign flip, canonical residues
    (number_theory.c:216-224; -0 is canonicalized to 0)."""
    n = a.degree
    if a.is_ntt:
        order = ctx.auto_order(auto_idx)
        return RnsPoly(a.data.index_select(1, order), a.num_q, a.num_p,
                       True)
    m = 2 * n
    shift = (np.arange(n, dtype=np.int64) * auto_idx) % m
    dest = np.where(shift < n, shift, shift - n)
    negate_dest = shift >= n
    # build gather map: res[dest[j]] = ±a[j]
    gather = np.zeros(n, dtype=np.int64)
    gather[dest] = np.arange(n)
    negate = np.zeros(n, dtype=bool)
    negate[dest] = negate_dest
    q, _, _ = _mods(a, ctx)
    dev = a.data.device
    vals = a.data.index_select(1, torch.as_tensor(gather, device=dev))
    return RnsPoly(torch.where(torch.as_tensor(negate, device=dev)[None, :],
                               modops.neg_mod(vals, q), vals),
                   a.num_q, a.num_p, False)


# ---------------------------------------------------------------------------
# Fast base conversion
# ---------------------------------------------------------------------------

def _base_conv_data(old_data, old_qs: list[int], new_qs: list[int],
                    hat_inv: list[int], hat_mod_new, ctx: CrtContext):
    """Core of Fast_base_conv (polynomial.c:755-808), coefficient form.

    old_data: [O, N]; hat_inv[o] = (M/q_o)^-1 mod q_o;
    hat_mod_new[n][o] = (M/q_o) mod p_n.
    Returns [len(new_qs), N] canonical residues.
    """
    O = len(old_qs)
    old_q = ctx.column(old_qs)
    inv, inv_prec = _shoup_cols(ctx, hat_inv, old_qs)
    tmp = modops.shoup_mul(old_data, inv, inv_prec, old_q)  # [O, N]

    key = ("hatmat", tuple(old_qs), tuple(new_qs), tuple(hat_inv))
    mat = ctx.const(key, lambda: modops.np_u64(hat_mod_new).reshape(
        len(new_qs), O))  # [new, O]
    acc_hi = torch.zeros((len(new_qs), old_data.shape[-1]), dtype=torch.int64,
                         device=old_data.device)
    acc_lo = torch.zeros_like(acc_hi)
    for o in range(O):
        p_hi, p_lo = modops.mul_128(tmp[o][None, :], mat[:, o:o + 1])
        new_lo = acc_lo + p_lo
        carry = modops._ult(new_lo, p_lo).to(torch.int64)
        acc_hi = acc_hi + p_hi + carry
        acc_lo = new_lo
    mus = [modops.precompute_barrett128(q) for q in new_qs]
    return modops.barrett_reduce_128(
        acc_hi, acc_lo, ctx.column(new_qs), ctx.column([m[0] for m in mus]),
        ctx.column([m[1] for m in mus]))


# ---------------------------------------------------------------------------
# Hybrid key-switching support: decompose, mod-up, mod-down
# ---------------------------------------------------------------------------

def decompose(a: RnsPoly, ctx: CrtContext, part_idx: int) -> RnsPoly:
    """Extract KSW digit `part_idx` (polynomial.c:848-884)."""
    num_decomp = ctx.num_decomp(a.num_q)
    per = ctx.per_part_size
    start = per * part_idx
    if part_idx == num_decomp - 1:
        length = a.num_q - start
    else:
        length = len(ctx.parts[part_idx])
    data = a.data[ctx.q_rows(start):ctx.q_rows(start + length)]
    return RnsPoly(data, length, 0, a.is_ntt)


def mod_up(part: RnsPoly, ctx: CrtContext, num_q_live: int,
           part_idx: int) -> RnsPoly:
    """Raise digit to the full Q_level ∪ P basis (polynomial.c:877-926).

    part: the decomposed digit (level = digit size, num_p = 0).
    Result: [num_q_live + K, N] in the same NTT-ness as the input.
    """
    level = num_q_live - 1
    per = ctx.per_part_size
    start = per * part_idx
    sz = part.num_q
    part_qs = ctx.parts[part_idx][:sz]
    digit = range(start, start + sz)
    compl_all = ctx.compl_indices[level][part_idx]
    own = [i for i, g in enumerate(compl_all) if ctx.owns(g)]
    compl_idx = [compl_all[i] for i in own]
    compl_qs = [ctx.all_primes[g] for g in compl_idx]
    hat_inv = ctx.part_hat_inv_mod_q[part_idx][sz - 1]
    # part_hat_mod_compl[level][part][i][j] -> transpose to [compl][part_i]
    mat = ctx.part_hat_mod_compl[level][part_idx]
    mat_t = [[mat[i][j] for i in range(sz)] for j in own]

    if part.is_ntt:
        part_tables = ctx.tables_for(ctx.local(digit))
        coeff_data = ntt.ntt_inv(part.data, part_tables)
    else:
        coeff_data = part.data
    # the whole digit, for the conversion into this rank's complement rows
    coeff_data = ctx.gather(coeff_data, digit)
    ext = _base_conv_data(coeff_data, part_qs, compl_qs, hat_inv, mat_t, ctx)
    if part.is_ntt:
        ext = ntt.ntt_fwd(ext, ctx.tables_for(compl_idx))

    # splice by global index: [ext below the digit, the digit, ext above]
    # (polynomial.c:916-922 — the digit's own limbs stay untouched)
    k = ctx.q_rows(start)
    data = torch.cat([ext[:k], part.data, ext[k:]], dim=0)
    return RnsPoly(data, num_q_live, ctx.num_p, part.is_ntt)


def mod_down(a: RnsPoly, ctx: CrtContext) -> RnsPoly:
    """Scale down by P: Q_level ∪ P -> Q_level (polynomial.c:928-966)."""
    assert a.num_p == ctx.num_p
    level = a.num_q
    kq = ctx.q_rows(level)
    p_part = a.data[kq:]
    p_idx = [ctx.num_q + j for j in range(ctx.num_p)]
    if a.is_ntt:
        p_part = ntt.ntt_inv(p_part, ctx.tables_for(ctx.local(p_idx)))
    p_part = ctx.gather(p_part, p_idx)
    q_idx = ctx.local(range(level))
    conv = _base_conv_data(
        p_part, ctx.p_primes, [ctx.q_primes[g] for g in q_idx],
        ctx.p_hat_inv_mod_p, [ctx.p_hat_mod_q[g] for g in q_idx], ctx)
    if a.is_ntt:
        conv = ntt.ntt_fwd(conv, ctx.tables_for(q_idx))
    q, mu_hi, mu_lo = ctx.mod_arrays(q_idx)
    diff = modops.sub_mod(a.data[:kq], conv, q)
    p_inv = ctx.column([ctx.p_inv_mod_q[g] for g in q_idx])
    out = modops.barrett_mul_d(diff, p_inv, q, mu_hi, mu_lo)
    return RnsPoly(out, level, 0, a.is_ntt)


def _switch_modulus_cols(ctx: CrtContext, old_q: int, new_qs: list[int]):
    diffs = [qi - old_q if qi > old_q else qi - (old_q % qi)
             for qi in new_qs]
    return ctx.column(diffs), ctx.column(new_qs)


def switch_modulus_data(data, old_q: int, new_qs: list[int],
                        ctx: CrtContext):
    """Centered base switch of [1, N] residues mod old_q to each new
    modulus (fhe_utils.h:352-377 Switch_modulus), vectorized over the
    target limb axis. Returns [len(new_qs), N]."""
    diff, new_q = _switch_modulus_cols(ctx, old_q, new_qs)
    sm = data + torch.where(data > (old_q >> 1), diff, 0)
    return torch.where(sm >= new_q, sm % new_q, sm)


def mod_raise(a: RnsPoly, ctx: CrtContext, target_level: int) -> RnsPoly:
    """Raise a level-1 coefficient-form poly to target_level limbs by
    centered lifting mod each q_i (Transform_values_from_level0,
    ckks_bootstrap_context.c:1527-1550)."""
    assert not a.is_ntt and a.num_q == 1 and a.num_p == 0
    q0 = ctx.q_primes[0]
    # limb 0 from its owner; a.data holds it there and nothing elsewhere
    row0 = ctx.bcast_row(a.data if ctx.owns(0) else None, 0)
    rest = switch_modulus_data(
        row0, q0, [ctx.q_primes[g] for g in ctx.local(range(1, target_level))],
        ctx)
    return RnsPoly(torch.cat([a.data, rest], dim=0), target_level, 0, False)


# ---------------------------------------------------------------------------
# Rescale
# ---------------------------------------------------------------------------

def rescale(a: RnsPoly, ctx: CrtContext) -> RnsPoly:
    """Drop the last limb and divide by its prime (polynomial.c:1097-1176,
    NTT-form path)."""
    assert a.is_ntt and a.num_p == 0
    level = a.num_q
    assert level > 1
    qs = ctx.q_primes
    last_q = qs[level - 1]
    k = level - 2

    # the dropped limb, from its owner (its last local row there)
    rem = ctx.q_rows(level - 1)
    last = None
    if ctx.owns(level - 1):
        last = ntt.ntt_inv(a.data[rem:rem + 1], ctx.tables_for([level - 1]))
    last = ctx.bcast_row(last, level - 1)

    rem_idx = ctx.local(range(level - 1))
    rem_qs = [qs[g] for g in rem_idx]
    # Switch_modulus (fhe_utils.h:352-377), vectorized over target limbs
    sm = switch_modulus_data(last, last_q, rem_qs, ctx)
    new_q = ctx.column(rem_qs)

    qlql_w, qlql_prec = _shoup_cols(
        ctx, [ctx.ql_ql_inv_mod_ql_div_ql_mod_qi[k][g] for g in rem_idx],
        rem_qs)
    corr = modops.shoup_mul(sm, qlql_w, qlql_prec, new_q)
    corr = ntt.ntt_fwd(corr, ctx.tables_for(rem_idx))

    inv_w, inv_prec = _shoup_cols(
        ctx, [ctx.ql_inv_mod_qi[k][g] for g in rem_idx], rem_qs)
    scaled = modops.shoup_mul_d(a.data[:rem], inv_w, inv_prec, new_q)
    return RnsPoly(modops.add_mod(scaled, corr, new_q), level - 1, 0, True)
