"""PyTorch port: the CUDA kernels K1-K4 against their plain versions on
the card. Each test needs a CUDA card and skips without one. This file
imports neither jax nor ace_tpu, so it also runs on a machine that has
only PyTorch:

    python -m pytest tests/test_torch_kernels.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from ace_tpu_torch.ops import modops as TM
from ace_tpu_torch.ops import ntt as TN
from ace_tpu_torch.ops import ntt4 as TN4
from ace_tpu_torch.ops import pallas_modops as TPM
from ace_tpu_torch.utils import number_theory as nt

RNG = np.random.default_rng(61)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _residues(primes, n):
    return TM.to_torch(np.stack([RNG.integers(0, q, n, dtype=np.uint64)
                                 for q in primes]))


def _cols(vals):
    return TM.to_torch(TM.np_u64([[v] for v in vals]))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(4, 4096), (2, 3, 1024)])
def test_k1_k2_match_plain(shape):
    """K1 (full and per-row b, 2-D and batched) and K2 on the card equal
    their plain versions word for word."""
    _card()
    n, rows = shape[-1], int(np.prod(shape[:-1]))
    primes = nt.generate_q_primes(shape[-2], 60, 56, n)
    a = _residues(primes, n).expand(*shape).contiguous()
    b = _residues(primes, n)
    q = _cols(primes)
    mus = [TM.precompute_barrett128(p) for p in primes]
    mh, ml = _cols([m[0] for m in mus]), _cols([m[1] for m in mus])
    ws = [int(RNG.integers(1, p)) for p in primes]
    w = _cols(ws)
    wp = _cols([TM.precompute_shoup(v, p) for v, p in zip(ws, primes)])
    dev = [t.cuda() for t in (a, b, q, mh, ml, w, wp)]
    for args_c, args_g in (((a, b, q, mh, ml), dev[:5]),
                           ((a, w, q, mh, ml),
                            (dev[0], dev[5], dev[2], dev[3], dev[4]))):
        np.testing.assert_array_equal(TM.to_numpy(TPM.barrett_mul(*args_g)),
                                      TM.to_numpy(TPM.barrett_mul(*args_c)))
    np.testing.assert_array_equal(
        TM.to_numpy(TPM.shoup_mul(dev[0], dev[5], dev[6], dev[2])),
        TM.to_numpy(TPM.shoup_mul(a, w, wp, q)))
    assert rows * n == a.numel()


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << e for e in range(1, 18)])
def test_k3_k4_match_plain(n):
    """K3/K4 on the card == the plain ladders at every degree the
    launcher takes (one block up to N = 2^11, clusters of 2, 4 and 8
    blocks above, 16 from 2^15 for these 3 limbs), on a gathered limb
    subset, and K4(K3(x)) == x."""
    _card()
    primes = nt.generate_q_primes(4, 60, 56, n)
    tc = TN.gather_tables(TN.make_ntt_tables(primes, n, device="cpu"),
                          [3, 0, 2])
    tg = TN.gather_tables(TN.make_ntt_tables(primes, n, device="cuda"),
                          [3, 0, 2])
    x = _residues([primes[i] for i in (3, 0, 2)], n)
    f = TN.ntt_fwd(x, tc)
    fg = TN4.ntt4_fwd(x.cuda(), tg)
    np.testing.assert_array_equal(TM.to_numpy(fg), TM.to_numpy(f))
    np.testing.assert_array_equal(TM.to_numpy(TN4.ntt4_inv(f.cuda(), tg)),
                                  TM.to_numpy(x))
    np.testing.assert_array_equal(TM.to_numpy(TN4.ntt4_inv(fg, tg)),
                                  TM.to_numpy(TN.ntt_inv(f, tc)))


@pytest.fixture(scope="module")
def chain_2p15():
    """A 46-prime chain at N = 2^15 (ResNet-20's 34 q + 12 P primes),
    tables on the CPU and on the card."""
    _card()
    n = 1 << 15
    primes = nt.generate_q_primes(46, 60, 56, n)
    return (n, primes, TN.make_ntt_tables(primes, n, device="cpu"),
            TN.make_ntt_tables(primes, n, device="cuda"))


@pytest.mark.gpu
@pytest.mark.parametrize("L", [1, 12, 46])
def test_k3_k4_path_limb_counts(chain_2p15, L):
    """The limb counts the slice launches at N = 2^15 (rescale's 1 limb,
    a digit or the P part's 12, the whole chain's 46), on a permuted row
    subset of the full tables: word for word against the plain ladders,
    and the round trip, including in place (input == output)."""
    n, primes, tc_full, tg_full = chain_2p15
    rows = np.random.default_rng(L).permutation(len(primes))[:L].tolist()
    tc = TN.gather_tables(tc_full, rows)
    tg = TN.gather_tables(tg_full, rows)
    x = _residues([primes[i] for i in rows], n)
    f = TN.ntt_fwd(x, tc)
    fg = TN4.ntt4_fwd(x.cuda(), tg)
    np.testing.assert_array_equal(TM.to_numpy(fg), TM.to_numpy(f))
    ig = TN4.ntt4_inv(fg, tg)
    np.testing.assert_array_equal(TM.to_numpy(ig), TM.to_numpy(x))
    from ace_tpu_torch.ops import kernels
    y = x.cuda()
    lib = kernels.lib("ntt")
    st = kernels.stream_ptr(y)
    kernels.check(lib.ace_k3_ntt_fwd(
        y.data_ptr(), y.data_ptr(), tg.rou.data_ptr(),
        tg.rou_prec.data_ptr(), tg.q.data_ptr(), tg.rows.data_ptr(), L, 15,
        st), "K3 in place")
    np.testing.assert_array_equal(TM.to_numpy(y), TM.to_numpy(f))
    kernels.check(lib.ace_k4_ntt_inv(
        y.data_ptr(), y.data_ptr(), tg.rou_inv.data_ptr(),
        tg.rou_inv_prec.data_ptr(), tg.q.data_ptr(), tg.n_inv.data_ptr(),
        tg.n_inv_prec.data_ptr(), tg.rows.data_ptr(), L, 15, st),
        "K4 in place")
    np.testing.assert_array_equal(TM.to_numpy(y), TM.to_numpy(x))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [2, 1 << 11, 1 << 15, 1 << 17])
def test_k3_k4_one_launch_per_call(n):
    """Each K3 or K4 call is one kernel launch (torch.profiler's CUDA
    kernel events), with the launch shape the launcher reports."""
    _card()
    from torch.profiler import ProfilerActivity, profile
    primes = nt.generate_q_primes(2, 60, 56, n)
    t = TN.make_ntt_tables(primes, n, device="cuda")
    x = _residues(primes, n).cuda()
    TN4.ntt4_inv(TN4.ntt4_fwd(x, t), t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        TN4.ntt4_inv(TN4.ntt4_fwd(x, t), t)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names, "the profiler recorded no device activity"
    assert sum("ntt_cluster" in k for k in names) == 2, names
    shape = TN4.launch_shape(2, n)
    assert shape["blocks"] == 2 * shape["cluster"]
    assert shape["smem_bytes"] * shape["cluster"] == 8 * n


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 17])
def test_k3_k4_cluster_of_16_and_of_8(n):
    """Around the launcher's switch between clusters (csrc/ntt.cu
    cluster_log): 16 blocks for as many limbs as clusters of 16 fit at
    one block per SM (those resident at 4 blocks per SM, over 4), 8 from
    one limb more; both word for word against the plain ladders on the
    card, and the round trip."""
    _card()
    one = TN4.launch_shape(1, n)
    assert one["cluster"] == 16
    most = min(one["resident_k3"], one["resident_k4"]) // 4
    assert most >= 1
    primes = nt.generate_q_primes(most + 1, 60, 56, n)
    tg_full = TN.make_ntt_tables(primes, n, device="cuda")
    for L, cluster in ((most, 16), (most + 1, 8)):
        assert TN4.launch_shape(L, n)["cluster"] == cluster
        rows = list(range(L))[::-1]
        tg = TN.gather_tables(tg_full, rows)
        x = _residues([primes[i] for i in rows], n).cuda()
        f = TN4.ntt4_fwd(x, tg)
        assert torch.equal(f, TN.ntt_fwd_plain(x, tg))
        assert torch.equal(TN4.ntt4_inv(x, tg), TN.ntt_inv_plain(x, tg))
        assert torch.equal(TN4.ntt4_inv(f, tg), x)


@pytest.mark.gpu
def test_ntt_wrappers_raise_for_misaligned_data():
    """K3/K4 move 16-byte vectors: data that starts 8 bytes off a 16-byte
    boundary raises in the wrapper, and the C launcher refuses it."""
    _card()
    n = 1 << 12
    primes = nt.generate_q_primes(1, 60, 56, n)
    t = TN.make_ntt_tables(primes, n, device="cuda")
    x = torch.zeros(n + 1, dtype=torch.int64, device="cuda")[1:].view(1, n)
    assert x.is_contiguous() and x.data_ptr() % 16 == 8
    with pytest.raises(ValueError):
        TN4.ntt4_fwd(x, t)
    with pytest.raises(ValueError):
        TN4.ntt4_inv(x, t)
    from ace_tpu_torch.ops import kernels
    rc = kernels.lib("ntt").ace_k3_ntt_fwd(
        x.data_ptr(), x.data_ptr(), t.rou.data_ptr(), t.rou_prec.data_ptr(),
        t.q.data_ptr(), t.rows.data_ptr(), 1, 12, kernels.stream_ptr(x))
    assert rc != 0


@pytest.mark.gpu
def test_wrappers_reject_bad_cuda_input():
    _card()
    x = torch.zeros((2, 12), dtype=torch.int64, device="cuda")
    q = torch.ones((2, 1), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        TPM.barrett_mul(x, x, q, q, q)
    with pytest.raises(TypeError):
        TPM.shoup_mul(x.float(), q, q, q)


@pytest.mark.gpu
def test_ntt_wrappers_raise_for_untaken_degree():
    """N = 2^18 is beyond what the launcher takes (8 blocks of 128 KB):
    the wrappers raise and launch nothing; no fallback runs."""
    _card()
    n = 1 << 18
    t = TN.NttTables(*(torch.zeros((1, w), dtype=torch.int64,
                                   device="cuda")
                       for w in (1, n, n, n, n, 1, 1, 1, 1)),
                     rows=torch.zeros(1, dtype=torch.int64, device="cuda"))
    x = torch.zeros((1, n), dtype=torch.int64, device="cuda")
    before = (TN4.ntt4_fwd.launches, TN4.ntt4_inv.launches)
    with pytest.raises(ValueError):
        TN4.ntt4_fwd(x, t)
    with pytest.raises(ValueError):
        TN4.ntt4_inv(x, t)
    assert (TN4.ntt4_fwd.launches, TN4.ntt4_inv.launches) == before
    from ace_tpu_torch.ops import kernels
    rc = kernels.lib("ntt").ace_k3_ntt_fwd(
        x.data_ptr(), x.data_ptr(), t.rou.data_ptr(), t.rou_prec.data_ptr(),
        t.q.data_ptr(), t.rows.data_ptr(), 1, 18, kernels.stream_ptr(x))
    assert rc != 0
