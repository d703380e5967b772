"""PyTorch port: NTT tables and the plain versions of kernels K3/K4,
bit for bit against ace_tpu.ops.ntt, the Pallas four-step kernels
(interpret mode on the CPU) and the reference binary's vectors."""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp

from ace_tpu.ops import ntt, ntt4
from ace_tpu.utils import number_theory as nt
from ace_tpu_torch.ops import ntt as TN
from ace_tpu_torch.ops import ntt4 as TN4

from tests.torch_port_util import to_np, to_t

RNG = np.random.default_rng(43)
VEC = os.path.join(os.path.dirname(__file__), "vectors", "ref_vectors.json")


def _data(primes, n):
    return np.stack([RNG.integers(0, q, n, dtype=np.uint64) for q in primes])


def test_tables_match():
    n = 1024
    primes = nt.generate_q_primes(3, 50, 40, n)
    ref = ntt.make_ntt_tables(primes, n, four_step=False)
    got = TN.make_ntt_tables(primes, n, device="cpu")
    for name in ("q", "rou", "rou_prec", "rou_inv", "rou_inv_prec",
                 "n_inv", "n_inv_prec", "mu_hi", "mu_lo"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("n", [64, 1024, 4096])
def test_fwd_inv_match_1step(n):
    primes = nt.generate_q_primes(3, 50, 40, n)
    ref_t = ntt.make_ntt_tables(primes, n, four_step=False)
    t = TN.make_ntt_tables(primes, n, device="cpu")
    x = _data(primes, n)
    fwd = TN.ntt_fwd(to_t(x), t)
    np.testing.assert_array_equal(
        to_np(fwd), np.asarray(ntt.fwd(jnp.asarray(x), ref_t)))
    np.testing.assert_array_equal(
        to_np(TN.ntt_inv(to_t(x), t)),
        np.asarray(ntt.inv(jnp.asarray(x), ref_t)))
    np.testing.assert_array_equal(to_np(TN.ntt_inv(fwd, t)), x)


@pytest.mark.parametrize("n,bits", [(1024, (50, 40)), (2048, (45, 40))])
def test_match_pallas_four_step(n, bits):
    """K3/K4's plain versions == ntt4_fwd/ntt4_inv (interpret mode),
    including the odd log2 N = 11 split (R=64, C=32)."""
    primes = nt.generate_q_primes(2, bits[0], bits[1], n)
    t4 = ntt4.make_ntt4_tables(primes, n)
    t = TN.make_ntt_tables(primes, n, device="cpu")
    x = _data(primes, n)
    fwd = TN4.ntt4_fwd(to_t(x), t)
    np.testing.assert_array_equal(
        to_np(fwd), np.asarray(ntt4.ntt4_fwd(jnp.asarray(x), t4)))
    np.testing.assert_array_equal(
        to_np(TN4.ntt4_inv(fwd, t)),
        np.asarray(ntt4.ntt4_inv(jnp.asarray(to_np(fwd)), t4)))


def test_gather_tables_match():
    n = 256
    primes = nt.generate_q_primes(4, 50, 40, n)
    ref = ntt.gather_tables(ntt.make_ntt_tables(primes, n, four_step=False),
                            [3, 1])
    t = TN.gather_tables(TN.make_ntt_tables(primes, n, device="cpu"), [3, 1])
    x = _data([primes[3], primes[1]], n)
    np.testing.assert_array_equal(
        to_np(TN.ntt_fwd(to_t(x), t)),
        np.asarray(ntt.fwd(jnp.asarray(x), ref)))
    # a selection of a selection indexes the full chain
    t2 = TN.gather_tables(t, [1])
    assert to_np(t2.rows).tolist() == [1]


def test_ref_vectors_bit_exact():
    """The reference binary's NTT vectors (test_ref_vectors.py:82)."""
    with open(VEC) as f:
        vec = json.load(f)
    n = vec["fixture"]["degree"]
    for l, rec in enumerate(vec["ntt"]):
        t = TN.make_ntt_tables([rec["q"]], n, device="cpu")
        x = to_t(np.asarray(rec["input"], np.uint64)[None, :])
        np.testing.assert_array_equal(
            to_np(TN.ntt_fwd(x, t))[0], np.asarray(rec["fwd"], np.uint64),
            err_msg=f"fwd, prime {l}")
        y = to_t(np.asarray(rec["fwd"], np.uint64)[None, :])
        np.testing.assert_array_equal(
            to_np(TN.ntt_inv(y, t))[0],
            np.asarray(rec["inv_roundtrip"], np.uint64),
            err_msg=f"inv, prime {l}")


def test_no_launch_on_cpu():
    n = 64
    primes = nt.generate_q_primes(2, 50, 40, n)
    t = TN.make_ntt_tables(primes, n, device="cpu")
    before = (TN4.ntt4_fwd.launches, TN4.ntt4_inv.launches)
    TN.ntt_inv(TN.ntt_fwd(to_t(_data(primes, n)), t), t)
    assert (TN4.ntt4_fwd.launches, TN4.ntt4_inv.launches) == before
