"""PyTorch port: a numpy model of the schedule of kernels K3/K4
(ace_tpu_torch/csrc/ntt.cu), held against the plain ladders and against
ace_tpu's Pallas four-step kernels (interpret mode on the CPU).

The model follows the kernel's index arithmetic: which block of the
cluster and which register set holds which word at each stage group,
the swizzled shared-memory slot of every word, and the twiddle index of
every butterfly. Its arithmetic is the port's plain modops, so a wrong
index shows here as a wrong residue. It also checks what the kernel's
speed rests on: every word is loaded and stored once, every twiddle
entry 1 .. N-1 is read, no half-warp's 64-bit shared-memory access
falls twice on one bank pair, and the chunk loads and stores move
words i, i + 1 (i even) as one 16-byte vector: in device memory and in
one aligned slot pair of shared memory, with no quarter-warp falling
twice on one group of four banks.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ace_tpu.ops import ntt4
from ace_tpu.utils import number_theory as nt
from ace_tpu_torch.ops import modops as TM
from ace_tpu_torch.ops import ntt as TN

from tests.torch_port_util import to_np, to_t

RNG = np.random.default_rng(47)


K = 3  # the kernel's register radix (csrc/ntt.cu K)


def swz(i, k=K):
    """Shared-memory slot of chunk word i under radix k (csrc/ntt.cu
    swz)."""
    return i ^ ((i >> k) & 15)


def groups(lc, logn, k):
    """The in-chunk stage groups [sa, sa + kk) in forward order: sizes
    aligned to the end, the first group the short one."""
    out, sa, kk = [], lc, (logn - lc - 1) % k + 1
    while sa < logn:
        out.append((sa, kk))
        sa, kk = sa + kk, k
    return out


class Schedule:
    """K3/K4 on [L, N] with clusters of 2^lc blocks and register radix k;
    `tw_reads` collects every twiddle index read, `loads`/`stores` every
    device-memory word index moved (per limb)."""

    def __init__(self, t, lc, k):
        self.t, self.lc, self.k = t, lc, k
        self.logn = t.degree.bit_length() - 1
        self.M = 1 << (self.logn - lc)
        self.q = t.sel("q")  # [L, 1]
        self.tw_reads, self.loads, self.stores = [], [], []

    def tw(self, tab, idx):
        """Twiddles and Shoup precomputes at idx (array) for every limb."""
        idx = np.asarray(idx).reshape(-1)
        self.tw_reads.append(idx)
        ix = torch.as_tensor(idx)
        return (self.t.sel(tab)[:, ix],
                self.t.sel(tab + "_prec")[:, ix])

    def check_banks(self, slots):
        """slots [nsets]: the slots one access of the 2^k set loop hits;
        consecutive sets run on consecutive threads."""
        s = np.asarray(slots)
        for h in range(0, len(s) - len(s) % 16, 16):
            assert len(set((s[h:h + 16] % 16).tolist())) == 16, s[h:h + 16]

    def slot(self, i):
        return swz(i, self.k)

    def pair_slots(self, j):
        """j [npairs], even: the words j, j + 1 that one thread moves as a
        16-byte vector (csrc/ntt.cu ld_pair / st_pair); consecutive pairs
        on consecutive threads. Returns the slot-pair index of each."""
        j = np.asarray(j)
        assert (j % 2 == 0).all()
        lo, hi = self.slot(j), self.slot(j + 1)
        np.testing.assert_array_equal(lo ^ 1, hi)
        ps = lo >> 1
        for h in range(0, len(ps) - len(ps) % 8, 8):
            assert len(set((ps[h:h + 8] % 8).tolist())) == 8, ps[h:h + 8]
        return ps

    def bfly(self, inv, x, y, w, wp):
        q = self.q
        if not inv:
            t = TM.shoup_mul(y, w, wp, q)
            return TM.add_mod(x, t, q), TM.sub_mod(x, t, q)
        return (TM.add_mod(x, y, q),
                TM.shoup_mul(TM.sub_mod(x, y, q), w, wp, q))

    def cross(self, inv, x0):
        """The lc cross-chunk stages on the columns' registers, x0[r]
        [L, ncols] the word of row r."""
        C, lc = 1 << self.lc, self.lc
        tab = "rou_inv" if inv else "rou"
        order = range(lc - 1, -1, -1) if inv else range(lc)
        for st in order:
            h = C >> (st + 1)
            for jj in range(C // 2):
                lo = (jj // h) * 2 * h + jj % h
                w, wp = self.tw(tab, [(1 << st) + (lo >> (lc - st))])
                x0[lo], x0[lo + h] = self.bfly(inv, x0[lo], x0[lo + h], w,
                                               wp)

    def group(self, inv, S, b, sa, kk):
        """One stage group on block b's chunk S[b] ([L, M] by slot)."""
        logn, lc = self.logn, self.lc
        ls = logn - sa - kk
        u = np.arange(1 << (logn - lc - kk))
        r, G = u & ((1 << ls) - 1), u >> ls
        base = (G << (ls + kk)) + r
        tab = "rou_inv" if inv else "rou"
        W = {}
        for i in range(kk):
            st = sa + i
            o = (1 << st) + (b << (st - lc)) + (G << i)
            assert (o % (1 << i) == 0).all()  # aligned for vector loads
            for c in range(1 << i):
                W[i, c] = self.tw(tab, o + c)
        slots = [self.slot(base + (t << ls)) for t in range(1 << kk)]
        for sl in slots:
            self.check_banks(sl)
        v = [S[b][:, torch.as_tensor(sl)] for sl in slots]
        for kx in range(kk):
            i = kk - 1 - kx if inv else kx
            h = 1 << (kk - 1 - i)
            for j in range(1 << (kk - 1)):
                c = j >> (kk - 1 - i)
                lo = (c << (kk - i)) | (j & (h - 1))
                w, wp = W[i, c]
                v[lo], v[lo + h] = self.bfly(inv, v[lo], v[lo + h], w, wp)
                if inv and kx == 0 and sa + kk == logn:  # N^-1 fold
                    ni, nip = self.t.sel("n_inv"), self.t.sel("n_inv_prec")
                    v[lo] = TM.shoup_mul(v[lo], ni, nip, self.q)
                    v[lo + h] = TM.shoup_mul(v[lo + h], ni, nip, self.q)
        for sl, val in zip(slots, v):
            S[b][:, torch.as_tensor(sl)] = val

    def columns(self, b):
        cols = self.M >> self.lc
        return b * cols + np.arange(cols)

    def run(self, x, inv):
        C, M = 1 << self.lc, self.M
        L = x.shape[0]
        S = [torch.zeros(L, M, dtype=torch.int64) for _ in range(C)]
        out = torch.empty_like(x)
        gs = groups(self.lc, self.logn, self.k)
        if not inv:
            for b in range(C):
                j = self.columns(b)
                self.check_banks(self.slot(j))
                x0 = [x[:, torch.as_tensor(r * M + j)] for r in range(C)]
                self.loads += [r * M + j for r in range(C)]
                self.cross(False, x0)
                for r in range(C):
                    S[r][:, torch.as_tensor(self.slot(j))] = x0[r]
            for sa, kk in gs:
                for b in range(C):
                    self.group(False, S, b, sa, kk)
            p = np.arange(M)
            self.pair_slots(p[::2])
            for b in range(C):
                out[:, torch.as_tensor(b * M + p)] = \
                    S[b][:, torch.as_tensor(self.slot(p))]
                self.stores.append(b * M + p)
        else:
            p = np.arange(M)
            self.pair_slots(p[::2])
            for b in range(C):
                S[b][:, torch.as_tensor(self.slot(p))] = \
                    x[:, torch.as_tensor(b * M + p)]
                self.loads.append(b * M + p)
            for sa, kk in reversed(gs):
                for b in range(C):
                    self.group(True, S, b, sa, kk)
            for b in range(C):
                j = self.columns(b)
                self.check_banks(self.slot(j))
                x0 = [S[r][:, torch.as_tensor(self.slot(j))]
                      for r in range(C)]
                self.cross(True, x0)
                for r in range(C):
                    out[:, torch.as_tensor(r * M + j)] = x0[r]
                    self.stores.append(r * M + j)
        return out


def _case(n, n_limbs=3):
    primes = nt.generate_q_primes(n_limbs + 1, 50, 40, n)
    t = TN.gather_tables(TN.make_ntt_tables(primes, n, device="cpu"),
                         [n_limbs, 0, 2][:n_limbs])
    sel = [primes[i] for i in to_np(t.rows).tolist()]
    x = np.stack([RNG.integers(0, q, n, dtype=np.uint64) for q in sel])
    return t, x


def _each_word_once(idx, n):
    got = np.sort(np.concatenate(idx))
    np.testing.assert_array_equal(got, np.arange(n))


def _params():
    """(logn, lc) at N = 64 .. 4096: clusters of 1, 2 and 4 blocks
    throughout, and of 8 and 16 where a block has 16 columns or more."""
    out = [(logn, lc) for logn in (6, 8, 10, 12) for lc in (0, 1, 2)]
    return out + [(10, 3), (12, 3), (12, 4)]


@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("logn,lc", _params())
def test_schedule_matches_plain(logn, lc, k):
    n = 1 << logn
    t, x = _case(n)
    xt = to_t(x)
    want_f = TN.ntt_fwd_plain(xt, t)
    sch = Schedule(t, lc, k)
    got_f = sch.run(xt, inv=False)
    np.testing.assert_array_equal(to_np(got_f), to_np(want_f))
    _each_word_once(sch.loads, n)
    _each_word_once(sch.stores, n)
    assert set(np.concatenate(sch.tw_reads).tolist()) == set(range(1, n))
    sch = Schedule(t, lc, k)
    got_i = sch.run(want_f, inv=True)
    np.testing.assert_array_equal(to_np(got_i),
                                  to_np(TN.ntt_inv_plain(want_f, t)))
    np.testing.assert_array_equal(to_np(got_i), x)
    _each_word_once(sch.loads, n)
    _each_word_once(sch.stores, n)
    assert set(np.concatenate(sch.tw_reads).tolist()) == set(range(1, n))


def test_launch_schedule_at_full_size_bank_free():
    """The kernel's own shapes from N = 2^15 to 2^17 (clusters of 8, and
    of 16 for a launch of a few limbs; radix 2^K): swizzled slots form a
    permutation of the chunk, every group's half-warp access is
    conflict-free, and so is every 16-byte access of the chunk loads
    and stores. Index arithmetic only; the residues are checked at small N
    above."""
    for logn, lc in ((15, 3), (15, 4), (16, 3), (16, 4), (17, 3), (17, 4)):
        k = K
        M = 1 << (logn - lc)
        p = np.arange(M)
        np.testing.assert_array_equal(np.sort(swz(p)), p)
        lo, hi = swz(p[::2]), swz(p[1::2])
        np.testing.assert_array_equal(lo ^ 1, hi)
        assert all(len(set((lo[h:h + 8] >> 1) % 8)) == 8
                   for h in range(0, len(lo), 8))
        for sa, kk in groups(lc, logn, k):
            ls = logn - sa - kk
            u = np.arange(M >> kk)
            base = ((u >> ls) << (ls + kk)) + (u & ((1 << ls) - 1))
            for tt in range(1 << kk):
                s = swz(base + (tt << ls)) % 16
                assert all(len(set(s[h:h + 16].tolist())) == 16
                           for h in range(0, len(s), 16))


@pytest.mark.parametrize("n,lc", [(256, 2)])
def test_schedule_matches_pallas_four_step(n, lc):
    """The schedule's output == ace_tpu ntt4_fwd / ntt4_inv (interpret)."""
    primes = nt.generate_q_primes(2, 50, 40, n)
    t4 = ntt4.make_ntt4_tables(primes, n)
    t = TN.make_ntt_tables(primes, n, device="cpu")
    x = np.stack([RNG.integers(0, q, n, dtype=np.uint64) for q in primes])
    fwd = Schedule(t, lc, 4).run(to_t(x), inv=False)
    np.testing.assert_array_equal(
        to_np(fwd), np.asarray(ntt4.ntt4_fwd(jnp.asarray(x), t4)))
    np.testing.assert_array_equal(
        to_np(Schedule(t, lc, 3).run(fwd, inv=True)),
        np.asarray(ntt4.ntt4_inv(jnp.asarray(to_np(fwd)), t4)))
