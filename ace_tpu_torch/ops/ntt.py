"""Negacyclic NTT/iNTT over stacked RNS limbs.

Transform layout of `ace_tpu.ops.ntt` (OpenFHE-style, the reference's
ntt.c): twiddles rou[bitrev(i)] = psi^i for a primitive 2N-th root psi;
forward Cooley-Tukey from natural order into the bit-reversed "NTT
form"; inverse Gentleman-Sande back to natural order with N^-1 folded
into the first (pairwise) stage. Butterflies use Shoup products.

`ntt_fwd`/`ntt_inv` dispatch on the data's device: CUDA tensors go to
kernels K3/K4 (ops/ntt4.py), CPU tensors to the plain 1-step ladders
`ntt_fwd_plain`/`ntt_inv_plain` below.

Tables: `NttTables` holds the full-chain tables on one device plus
`rows`, the table row of each data limb. `gather_tables` only swaps
`rows`, so selecting limbs never copies a table; the kernels index the
full tables by row, and the plain ladders gather them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ace_tpu_torch.ops import modops
from ace_tpu_torch.utils import number_theory as nt


class NttTables(NamedTuple):
    """Full-chain tables ([Lfull, N] twiddles and Shoup precomputes,
    [Lfull, 1] per-limb constants) and the selected rows [L]."""
    q: torch.Tensor
    rou: torch.Tensor
    rou_prec: torch.Tensor
    rou_inv: torch.Tensor
    rou_inv_prec: torch.Tensor
    n_inv: torch.Tensor
    n_inv_prec: torch.Tensor
    mu_hi: torch.Tensor
    mu_lo: torch.Tensor
    rows: torch.Tensor

    @property
    def degree(self) -> int:
        return self.rou.shape[-1]

    def sel(self, name: str) -> torch.Tensor:
        """Table `name` restricted to the selected rows."""
        return getattr(self, name).index_select(0, self.rows)


def _bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def pow_table(base: int, q: int, n: int) -> np.ndarray:
    """[base^0, ..., base^(n-1)] mod q as Python-int object array, by
    doubling (each step multiplies the known prefix by base^len)."""
    tab = np.array([1], dtype=object)
    step = base % q
    while len(tab) < n:
        tab = np.concatenate([tab, (tab * step) % q])
        step = step * step % q
    return tab[:n]


def shoup_table(w: np.ndarray, q: int) -> np.ndarray:
    """floor(w * 2^64 / q) per entry (object array in, uint64 out)."""
    return ((w.astype(object) << 64) // q).astype(np.uint64)


def make_ntt_tables(primes: list[int], degree: int,
                    device=None) -> NttTables:
    """Host precompute of every twiddle table for the prime chain, moved
    to `device` (numpy and Python ints; no native helper)."""
    n = degree
    rev = _bit_reverse_indices(n)
    rou_all, rou_prec_all, roui_all, roui_prec_all = [], [], [], []
    for q in primes:
        psi = nt.root_of_unity(2 * n, q)
        rou = np.empty(n, dtype=object)
        roui = np.empty(n, dtype=object)
        rou[rev] = pow_table(psi, q, n)
        roui[rev] = pow_table(nt.mod_inv(psi, q), q, n)
        rou_all.append(rou.astype(np.uint64))
        roui_all.append(roui.astype(np.uint64))
        rou_prec_all.append(shoup_table(rou, q))
        roui_prec_all.append(shoup_table(roui, q))
    ninv = [nt.mod_inv(n, q) for q in primes]
    mus = [modops.precompute_barrett128(q) for q in primes]
    u64 = modops.np_u64

    def dev(a):
        return modops.to_torch(a, device)

    return NttTables(
        q=dev(u64([[q] for q in primes])),
        rou=dev(np.stack(rou_all)),
        rou_prec=dev(np.stack(rou_prec_all)),
        rou_inv=dev(np.stack(roui_all)),
        rou_inv_prec=dev(np.stack(roui_prec_all)),
        n_inv=dev(u64([[v] for v in ninv])),
        n_inv_prec=dev(u64([[modops.precompute_shoup(v, q)]
                            for v, q in zip(ninv, primes)])),
        mu_hi=dev(u64([[m[0]] for m in mus])),
        mu_lo=dev(u64([[m[1]] for m in mus])),
        rows=torch.arange(len(primes), dtype=torch.int64, device=device),
    )


def gather_tables(tables: NttTables, idx) -> NttTables:
    """Tables for an arbitrary list of limb indices (rows of the full
    chain when `tables` is full-chain; rows of its selection otherwise)."""
    idx = torch.as_tensor(list(idx), dtype=torch.int64)
    rows = tables.rows.index_select(0, idx.to(tables.rows.device))
    return tables._replace(rows=rows)


def ntt_fwd_plain(coeffs: torch.Tensor, t: NttTables) -> torch.Tensor:
    """The plain version of K3: the 1-step CT ladder of
    ace_tpu.ops.ntt.ntt_fwd. coeffs [L, N] natural -> NTT form."""
    L, n = coeffs.shape
    q = t.sel("q")[:, :, None]  # [L,1,1] for [L,m,half] stage views
    rou, rou_prec = t.sel("rou"), t.sel("rou_prec")
    d = coeffs
    m = 1
    while m < n:
        half = n // (2 * m)
        d = d.reshape(L, m, 2, half)
        omega = rou[:, m:2 * m, None]
        omega_prec = rou_prec[:, m:2 * m, None]
        x = d[:, :, 0, :]
        y = modops.shoup_mul(d[:, :, 1, :], omega, omega_prec, q)
        d = torch.stack(
            [modops.add_mod(x, y, q), modops.sub_mod(x, y, q)], dim=2)
        m *= 2
    return d.reshape(L, n)


def ntt_inv_plain(values: torch.Tensor, t: NttTables) -> torch.Tensor:
    """The plain version of K4: the 1-step GS ladder of
    ace_tpu.ops.ntt.ntt_inv. values [L, N] NTT form -> natural."""
    L, n = values.shape
    q = t.sel("q")[:, :, None]
    rou, rou_prec = t.sel("rou_inv"), t.sel("rou_inv_prec")
    d = values
    m = n // 2
    first = True
    while m >= 1:
        half = n // (2 * m)
        d = d.reshape(L, m, 2, half)
        omega = rou[:, m:2 * m, None]
        omega_prec = rou_prec[:, m:2 * m, None]
        lo = d[:, :, 0, :]
        hi = d[:, :, 1, :]
        s = modops.add_mod(lo, hi, q)
        df = modops.shoup_mul(modops.sub_mod(lo, hi, q), omega, omega_prec,
                              q)
        if first:
            # N^-1 folded into the pairwise stage (ntt.c:281-317)
            ninv = t.sel("n_inv")[:, :, None]
            ninv_prec = t.sel("n_inv_prec")[:, :, None]
            s = modops.shoup_mul(s, ninv, ninv_prec, q)
            df = modops.shoup_mul(df, ninv, ninv_prec, q)
            first = False
        d = torch.stack([s, df], dim=2)
        m //= 2
    return d.reshape(L, n)


def ntt_fwd(coeffs: torch.Tensor, t: NttTables) -> torch.Tensor:
    """Forward negacyclic NTT: K3 on the card, the plain ladder on CPU."""
    from ace_tpu_torch.ops import ntt4
    return ntt4.ntt4_fwd(coeffs, t)


def ntt_inv(values: torch.Tensor, t: NttTables) -> torch.Tensor:
    """Inverse negacyclic NTT: K4 on the card, the plain ladder on CPU."""
    from ace_tpu_torch.ops import ntt4
    return ntt4.ntt4_inv(values, t)
