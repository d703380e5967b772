"""Slot-sharded negacyclic NTT over the mesh's 'slot' axis.

`ace_tpu.parallel.sharded_ntt` on torch.distributed: the ring is viewed
as [R, C] with the C (column) axis cut into s slot shards, one per rank
of a digit row. Each of the two ladders is shard-local (every shard
holds whole rows or whole columns), and the two transposes between the
stages are all_to_all exchanges over the row (mesh.all_to_all_slot).
Same tables, butterflies and output order as ops/ntt4.py and
ops/ntt.py:

  fwd:  x*psi^b -> NegaCT_R (local) -> *T2 (local) -> all_to_all
        transpose -> NegaCT_C (local) -> all_to_all transpose back

The ladders' twiddle products are per-row constants over [rows, C/s]
and go through kernel K2 (pallas_modops.shoup_mul) on the card; the
column tables (psi^b, T2 and their inverses) multiply elementwise in
plain PyTorch, as they are jnp code in ace_tpu. Every product is
canonical, so the residues are the same either way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ace_tpu_torch.ops import modops, pallas_modops as pm
from ace_tpu_torch.ops.ntt import _bit_reverse_indices, pow_table, \
    shoup_table
from ace_tpu_torch.utils import number_theory as nt

# tables whose last axis is the C columns, cut into slot shards
COLUMN_TABLES = ("p1", "p1_prec", "t2", "t2_prec", "d2i", "d2i_prec",
                 "fin", "fin_prec")


class ShardedNttTables(NamedTuple):
    """int64 tables (uint64 bit patterns), one row set per limb. The
    COLUMN_TABLES shard with the data; the ladder tables stay whole."""
    q: torch.Tensor           # [L, 1, 1]
    p1: torch.Tensor          # [L, 1, C]  psi^b
    p1_prec: torch.Tensor
    t2: torch.Tensor          # [L, R, C]
    t2_prec: torch.Tensor
    rr: torch.Tensor          # [L, logR, R]  per-stage row twiddles
    rr_prec: torch.Tensor
    rc: torch.Tensor          # [L, logC, C]
    rc_prec: torch.Tensor
    d2i: torch.Tensor         # [L, R, C]  t2^-1
    d2i_prec: torch.Tensor
    fin: torch.Tensor         # [L, 1, C]  p1^-1 * n^-1 (final scale)
    fin_prec: torch.Tensor
    rri: torch.Tensor         # [L, logR, R]  inverse ladder twiddles
    rri_prec: torch.Tensor
    rci: torch.Tensor         # [L, logC, C]
    rci_prec: torch.Tensor

    @property
    def shape_rc(self) -> tuple:
        return self.t2.shape[1], self.t2.shape[2]

    def rows(self, sl: slice) -> "ShardedNttTables":
        """The tables of the limbs in `sl`."""
        return self._make(f[sl] for f in self)

    def shard(self, slot: int, num_slot: int) -> "ShardedNttTables":
        """The column tables cut to slot shard `slot` of `num_slot`."""
        cl = self.t2.shape[2] // num_slot
        cols = slice(slot * cl, (slot + 1) * cl)
        return self._replace(**{k: getattr(self, k)[..., cols]
                                for k in COLUMN_TABLES})


def _ladder(psi_r: int, q: int, r: int) -> np.ndarray:
    """[log r, r] stage twiddles: stage s gives row i rou[m + i // (r/m)]
    with m = 2^s and rou[bitrev(j)] = psi_r^j."""
    rou = np.empty(r, dtype=object)
    rou[_bit_reverse_indices(r)] = pow_table(psi_r, q, r)
    return np.stack([np.repeat(rou[m:2 * m], r // m)
                     for m in (1 << s for s in range(r.bit_length() - 1))])


def make_sharded_ntt_tables(primes, degree: int,
                            device=None) -> ShardedNttTables:
    """Host precompute (Python ints) for each prime, moved to `device`.
    The inverse tables are the powers of psi^-1, which are the entrywise
    inverses ace_tpu computes one mod_inv at a time."""
    n = degree
    logn = n.bit_length() - 1
    r = 1 << ((logn + 1) // 2)
    c = n // r
    m = 2 * n
    rev_r = _bit_reverse_indices(r)
    tabs = {k: [] for k in ShardedNttTables._fields if k != "q"}
    for q in primes:
        psi = nt.root_of_unity(m, q)
        psi_inv = nt.mod_inv(psi, q)
        t2 = np.empty((r, c), dtype=object)
        d2i = np.empty((r, c), dtype=object)
        for u in range(r):
            e = (2 * u - r) % m
            t2[rev_r[u]] = pow_table(pow(psi, e, q), q, c)
            d2i[rev_r[u]] = pow_table(pow(psi_inv, e, q), q, c)
        ninv = nt.mod_inv(n, q)
        vals = {
            "p1": pow_table(psi, q, c)[None, :],
            "t2": t2,
            "rr": _ladder(pow(psi, c, q), q, r),
            "rc": _ladder(pow(psi, r, q), q, c),
            "d2i": d2i,
            "fin": (pow_table(psi_inv, q, c) * ninv % q)[None, :],
            "rri": _ladder(pow(psi_inv, c, q), q, r),
            "rci": _ladder(pow(psi_inv, r, q), q, c),
        }
        for k, v in vals.items():
            tabs[k].append(v.astype(np.uint64))
            tabs[k + "_prec"].append(shoup_table(v, q))

    def dev(a):
        return modops.to_torch(a, device)

    return ShardedNttTables(
        q=dev(modops.np_u64([[[q]] for q in primes])),
        **{k: dev(np.stack(v)) for k, v in tabs.items()})


def _negact_local(x, w, w_prec, q):
    """CT ladder over axis -2 of [L, R, Cl]. Stage s pairs row i with
    row i + R/(2m) inside blocks of R/m rows that share one twiddle:
    ace_tpu's roll/select form, written as a block view."""
    L, R, Cl = x.shape
    q4 = q[..., None]
    d = x
    for s in range(R.bit_length() - 1):
        m = 1 << s
        half = R // (2 * m)
        d = d.reshape(L, m, 2, half, Cl)
        om = w[:, s, ::2 * half].reshape(L, m, 1, 1)
        omp = w_prec[:, s, ::2 * half].reshape(L, m, 1, 1)
        xv = d[:, :, 0]
        wy = pm.shoup_mul(d[:, :, 1], om, omp, q4)
        d = torch.stack([modops.add_mod(xv, wy, q4),
                         modops.sub_mod(xv, wy, q4)], dim=2)
    return d.reshape(L, R, Cl)


def _negact_inv_local(x, wi, wi_prec, q):
    """Inverse of _negact_local: GS butterflies, reversed stages,
    inverse twiddles. The per-stage 1/2 factors are not applied here:
    n^-1 is folded into the final scale table."""
    L, R, Cl = x.shape
    q4 = q[..., None]
    d = x
    for s in reversed(range(R.bit_length() - 1)):
        m = 1 << s
        half = R // (2 * m)
        d = d.reshape(L, m, 2, half, Cl)
        om = wi[:, s, ::2 * half].reshape(L, m, 1, 1)
        omp = wi_prec[:, s, ::2 * half].reshape(L, m, 1, 1)
        xv, yv = d[:, :, 0], d[:, :, 1]
        ny = pm.shoup_mul(modops.sub_mod(xv, yv, q4), om, omp, q4)
        d = torch.stack([modops.add_mod(xv, yv, q4), ny], dim=2)
    return d.reshape(L, R, Cl)


def _xpose(y, mesh):
    """[L, A, B/s] -> [L, B, A/s] over the slot axis: one all_to_all
    (jax.lax.all_to_all(split_axis=1, concat_axis=2, tiled=False))."""
    L, A, Bl = y.shape
    s = mesh.num_slot
    send = y.reshape(L, s, A // s, Bl).permute(1, 0, 2, 3).contiguous()
    got = mesh.all_to_all_slot(send)               # [s, L, A/s, Bl]
    y = got.permute(1, 2, 0, 3).reshape(L, A // s, s * Bl)
    return y.transpose(1, 2)


def ntt_fwd_local(xl, t: ShardedNttTables, mesh):
    """Shard-local forward 4-step body: [L, R, C/s] in, same layout out;
    `t` holds this shard's columns (ShardedNttTables.shard)."""
    q = t.q
    y = modops.shoup_mul(xl, t.p1, t.p1_prec, q)
    y = _negact_local(y, t.rr, t.rr_prec, q)
    y = modops.shoup_mul(y, t.t2, t.t2_prec, q)
    y = _xpose(y, mesh)
    y = _negact_local(y, t.rc, t.rc_prec, q)
    return _xpose(y, mesh)


def ntt_inv_local(xl, t: ShardedNttTables, mesh):
    """Shard-local inverse 4-step body (the mirror network)."""
    q = t.q
    y = _xpose(xl, mesh)
    y = _negact_inv_local(y, t.rci, t.rci_prec, q)
    y = _xpose(y, mesh)
    y = modops.shoup_mul(y, t.d2i, t.d2i_prec, q)
    y = _negact_inv_local(y, t.rri, t.rri_prec, q)
    return modops.shoup_mul(y, t.fin, t.fin_prec, q)


def _global(local_fn, x, t: ShardedNttTables, mesh):
    L, n = x.shape
    R, C = t.shape_rc
    k, s = mesh.slot, mesh.num_slot
    cl = C // s
    xl = x.reshape(L, R, C)[:, :, k * cl:(k + 1) * cl]
    y = local_fn(xl, t.shard(k, s), mesh)
    return mesh.all_gather_slot(y, dim=2).reshape(L, n)


def sharded_ntt_fwd(x: torch.Tensor, t: ShardedNttTables, mesh
                    ) -> torch.Tensor:
    """Forward NTT of [L, N] with the columns sharded over the mesh's
    slot axis: the full [L, N] in on every rank, the full [L, N] out
    (ace_tpu's global array). Two all_to_all transposes; every butterfly
    is shard-local."""
    return _global(ntt_fwd_local, x, t, mesh)


def sharded_ntt_inv(x: torch.Tensor, t: ShardedNttTables, mesh
                    ) -> torch.Tensor:
    """Inverse of sharded_ntt_fwd: the same exchanges, GS butterflies
    with inverse twiddles, n^-1 folded into the final scale."""
    return _global(ntt_inv_local, x, t, mesh)
