"""PyTorch port: the CRT context and RNS polynomial ops, bit for bit
against ace_tpu.poly (mod-up, mod-down, rescale, automorphism,
decompose, base conversion, scalar products)."""

import numpy as np
import pytest
import jax.numpy as jnp

from ace_tpu.poly import poly as P
from ace_tpu.poly.poly import RnsPoly
from ace_tpu.poly.rns import CrtContext
from ace_tpu_torch.poly import poly as TP
from ace_tpu_torch.poly.rns import CrtContext as TCrt

from tests.torch_port_util import assert_poly_equal, port_poly, to_np

RNG = np.random.default_rng(47)
N = 64


@pytest.fixture(scope="module")
def crts():
    args = (7, 50, 40, N, 3)
    return CrtContext(*args), TCrt(*args, device="cpu")


def _rand(crt, num_q, num_p=0, is_ntt=True) -> RnsPoly:
    primes = crt.q_primes[:num_q] + crt.p_primes[:num_p]
    data = np.stack([RNG.integers(0, q, N, dtype=np.uint64)
                     for q in primes])
    return RnsPoly(jnp.asarray(data), num_q, num_p, is_ntt)


def test_crt_tables_match(crts):
    ref, got = crts
    assert got.q_primes == ref.q_primes and got.p_primes == ref.p_primes
    for name in ("q_hat_inv_mod_q", "ql_inv_mod_qi", "p_hat_mod_q",
                 "part_hat_inv_mod_q", "compl_indices",
                 "part_hat_mod_compl", "ql_ql_inv_mod_ql_div_ql_mod_qi"):
        assert getattr(got, name) == getattr(ref, name), name
    assert [got.num_decomp(l) for l in range(1, 8)] == \
        [ref.num_decomp(l) for l in range(1, 8)]


@pytest.mark.parametrize("num_p", [0, 4])
def test_add_sub_neg_mul_match(crts, num_p):
    ref, got = crts
    num_p = min(num_p, ref.num_p)
    a, b = _rand(ref, 5, num_p), _rand(ref, 5, num_p)
    ta, tb = port_poly(a), port_poly(b)
    assert_poly_equal(TP.add(ta, tb, got), P.add(a, b, ref))
    assert_poly_equal(TP.sub(ta, tb, got), P.sub(a, b, ref))
    assert_poly_equal(TP.neg(ta, got), P.neg(a, ref))
    assert_poly_equal(TP.mul(ta, tb, got), P.mul(a, b, ref))


def test_mul_scalars_match(crts):
    ref, got = crts
    a = _rand(ref, 6)
    scal = [int(RNG.integers(0, 2**62)) for _ in range(6)]
    assert_poly_equal(TP.mul_scalars(port_poly(a), scal, got),
                      P.mul_scalars(a, scal, ref))


def test_ntt_roundtrip_match(crts):
    ref, got = crts
    a = _rand(ref, 7, ref.num_p, is_ntt=False)
    f = TP.to_ntt(port_poly(a), got)
    assert_poly_equal(f, P.to_ntt(a, ref))
    assert_poly_equal(TP.from_ntt(f, got), a)


@pytest.mark.parametrize("is_ntt", [True, False])
def test_automorphism_match(crts, is_ntt):
    ref, got = crts
    a = _rand(ref, 4, 0, is_ntt)
    for idx in (5, 25, 2 * N - 1):
        assert_poly_equal(TP.automorphism(port_poly(a), idx, got),
                          P.automorphism(a, idx, ref))


@pytest.mark.parametrize("level", [7, 5])
def test_decompose_mod_up_match(crts, level):
    ref, got = crts
    a = _rand(ref, level)
    ta = port_poly(a)
    for part in range(ref.num_decomp(level)):
        d, td = P.decompose(a, ref, part), TP.decompose(ta, got, part)
        assert_poly_equal(td, d)
        assert_poly_equal(TP.mod_up(td, got, level, part),
                          P.mod_up(d, ref, level, part))


@pytest.mark.parametrize("is_ntt", [True, False])
def test_mod_down_match(crts, is_ntt):
    ref, got = crts
    a = _rand(ref, 6, ref.num_p, is_ntt)
    assert_poly_equal(TP.mod_down(port_poly(a), got), P.mod_down(a, ref))


@pytest.mark.parametrize("level", [7, 3])
def test_rescale_match(crts, level):
    ref, got = crts
    a = _rand(ref, level)
    assert_poly_equal(TP.rescale(port_poly(a), got), P.rescale(a, ref))


def test_base_conv_and_switch_modulus_match(crts):
    ref, got = crts
    a = _rand(ref, 1, 0, is_ntt=False)
    np.testing.assert_array_equal(
        to_np(TP.switch_modulus_data(port_poly(a).data, ref.q_primes[0],
                                     ref.q_primes[1:5], got)),
        np.asarray(P.switch_modulus_data(a.data, ref.q_primes[0],
                                         ref.q_primes[1:5])))
    src = _rand(ref, 3, 0, is_ntt=False)
    old_qs, new_qs = ref.q_primes[:3], ref.q_primes[3:6]
    hat_inv = [int(RNG.integers(1, q)) for q in old_qs]
    mat = [[int(RNG.integers(0, q)) for _ in old_qs] for q in new_qs]
    want = P._base_conv_data(src.data, old_qs, new_qs, hat_inv, mat)
    have = TP._base_conv_data(port_poly(src).data, old_qs, new_qs, hat_inv,
                              mat, got)
    np.testing.assert_array_equal(to_np(have), np.asarray(want))
