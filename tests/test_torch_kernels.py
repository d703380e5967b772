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
@pytest.mark.parametrize("n", [64, 4096, 8192, 32768, 65536])
def test_k3_k4_match_plain(n):
    """K3/K4 on the card == the plain ladders, on both sides of the
    one-pass/two-pass split at N = 4096, on a gathered limb subset."""
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


@pytest.mark.gpu
def test_wrappers_reject_bad_cuda_input():
    _card()
    x = torch.zeros((2, 12), dtype=torch.int64, device="cuda")
    q = torch.ones((2, 1), dtype=torch.int64, device="cuda")
    with pytest.raises(ValueError):
        TPM.barrett_mul(x, x, q, q, q)
    with pytest.raises(TypeError):
        TPM.shoup_mul(x.float(), q, q, q)
