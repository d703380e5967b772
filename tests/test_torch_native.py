"""PyTorch port: the native C library (ace_tpu_torch/ops/native.py over
ace_tpu_torch/native/ckks_core.c), bit for bit against ace_tpu.native on
the same seeded inputs, against the port's numpy table builders
(ops/ntt.py pow_table, shoup_table, make_ntt_tables) and against the
plain NTT ladders of kernels K3/K4."""

import os

import numpy as np
import pytest

from ace_tpu import native as ace_native
from ace_tpu.utils import number_theory as nt
from ace_tpu_torch.ops import modops, native, ntt

from tests.torch_port_util import to_np, to_t

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1 << 10
PRIMES = nt.generate_q_primes(3, 60, 56, N)


def _u64p(arrays):
    import ctypes
    return [a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
            for a in arrays]


def _residues(rng, q, n=N):
    return rng.integers(0, q, n, dtype=np.uint64)


def test_source_is_ace_tpus_but_for_its_header():
    """The C code below the header comment is ace_tpu's, byte for byte."""
    def body(path):
        with open(path) as f:
            src = f.read()
        return src[src.index("#include <stdint.h>"):]
    assert body(os.path.join(REPO, "ace_tpu_torch", "native",
                             "ckks_core.c")) == \
        body(os.path.join(REPO, "ace_tpu", "native", "ckks_core.c"))


@pytest.mark.parametrize("q", PRIMES)
def test_pow_table_and_shoup_prec(q):
    psi = nt.root_of_unity(2 * N, q)
    got = native.pow_table(psi, q, N)
    np.testing.assert_array_equal(got, ace_native.pow_table(psi, q, N))
    np.testing.assert_array_equal(got, ntt.pow_table(psi, q, N)
                                  .astype(np.uint64))
    prec = native.shoup_prec(got, q)
    np.testing.assert_array_equal(prec, ace_native.shoup_prec(got, q))
    np.testing.assert_array_equal(prec, ntt.shoup_table(got, q))


def test_twiddle_matrix():
    q = PRIMES[0]
    base = nt.root_of_unity(64, q)
    row_order = np.random.default_rng(1).permutation(16)
    got = native.twiddle_matrix(base, q, row_order, 8)
    np.testing.assert_array_equal(
        got, ace_native.twiddle_matrix(base, q, row_order, 8))
    want = np.empty((16, 8), dtype=np.uint64)
    for u in range(16):
        want[row_order[u]] = [pow(base, u * b, q) for b in range(8)]
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        native.twiddle_matrix(base, q, np.array([0, 2]), 8)


@pytest.mark.parametrize("q", PRIMES)
def test_elementwise_products_and_mac(q):
    """ckks_modadd, ckks_modmul_barrett and ckks_mac against ace_tpu's
    library on the same inputs, and against Python integers."""
    rng = np.random.default_rng(q % 1000)
    a, b, acc = (_residues(rng, q) for _ in range(3))
    mu_hi, mu_lo = modops.precompute_barrett128(q)
    lib = ace_native.get_lib()

    want_add = np.empty_like(a)
    lib.ckks_modadd(*_u64p([want_add, a, b]), q, N)
    np.testing.assert_array_equal(native.modadd(a, b, q), want_add)

    want_mul = np.empty_like(a)
    lib.ckks_modmul_barrett(*_u64p([want_mul, a, b]), q, mu_hi, mu_lo, N)
    got_mul = native.modmul_barrett(a, b, q, mu_hi, mu_lo)
    np.testing.assert_array_equal(got_mul, want_mul)
    np.testing.assert_array_equal(
        got_mul, (a.astype(object) * b.astype(object) % q).astype(np.uint64))

    want_mac = acc.copy()
    lib.ckks_mac(*_u64p([want_mac, a, b]), q, mu_hi, mu_lo, N)
    got_mac = acc.copy()
    native.mac(got_mac, a, b, q, mu_hi, mu_lo)
    np.testing.assert_array_equal(got_mac, want_mac)
    np.testing.assert_array_equal(
        got_mac, ((acc.astype(object) + a.astype(object) * b.astype(object))
                  % q).astype(np.uint64))


@pytest.mark.parametrize("q", PRIMES)
def test_ntt_inplace_equals_the_plain_ladders(q):
    """One limb at N = 2^10 under make_ntt_tables' tables: the C forward
    NTT equals ntt_fwd_plain (K3's plain version), the C inverse equals
    ntt_inv_plain (K4's), and they round-trip."""
    t = ntt.make_ntt_tables([q], N, device="cpu")
    rou, rou_prec, roui, roui_prec = (to_np(getattr(t, k))[0].copy() for k in
                                      ("rou", "rou_prec", "rou_inv",
                                       "rou_inv_prec"))
    n_inv, n_inv_prec = int(to_np(t.n_inv)[0, 0]), \
        int(to_np(t.n_inv_prec)[0, 0])
    x = _residues(np.random.default_rng(7), q)
    fwd = x.copy()
    native.ntt_fwd_inplace(fwd, rou, rou_prec, q)
    np.testing.assert_array_equal(fwd, to_np(ntt.ntt_fwd_plain(
        to_t(x[None]), t))[0])
    inv = fwd.copy()
    native.ntt_inv_inplace(inv, roui, roui_prec, n_inv, n_inv_prec, q)
    np.testing.assert_array_equal(inv, x)
    np.testing.assert_array_equal(
        to_np(ntt.ntt_inv_plain(to_t(fwd[None]), t))[0], inv)


def test_arguments_are_checked_before_the_pointers_pass():
    q = PRIMES[0]
    rou = np.zeros(N, dtype=np.uint64)
    with pytest.raises(TypeError):
        native.ntt_fwd_inplace(np.zeros(N, dtype=np.int64), rou, rou, q)
    with pytest.raises(ValueError):
        native.ntt_fwd_inplace(np.zeros(N // 2, dtype=np.uint64), rou, rou,
                               q)
    with pytest.raises(ValueError):
        native.modadd(rou, rou[:4].copy(), q)


def test_library_builds_into_the_build_directory():
    from ace_tpu_torch.ops import kernels
    native.get_lib()
    assert os.path.dirname(native.lib_path()) == kernels.build_dir()
    assert os.path.exists(native.lib_path())
    assert native.build() is False  # built once, then loaded
