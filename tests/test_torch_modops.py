"""PyTorch port: modular arithmetic and the plain versions of kernels
K1 (Barrett product) and K2 (Shoup product), bit for bit against
ace_tpu.ops.modops and the Pallas kernels (interpret mode on the CPU)."""

import numpy as np
import pytest
import jax.numpy as jnp

from ace_tpu.ops import modops as M
from ace_tpu.ops import pallas_modops as PM
from ace_tpu.utils import number_theory as nt
from ace_tpu_torch.ops import modops as TM
from ace_tpu_torch.ops import pallas_modops as TPM

from tests.torch_port_util import to_np, to_t

RNG = np.random.default_rng(41)
QBITS = [30, 50, 59, 60]


def _ctx(qbits, shape=(3, 256)):
    q = nt.gen_first_prime(128, qbits)
    a = RNG.integers(0, q, size=shape, dtype=np.uint64)
    b = RNG.integers(0, q, size=shape, dtype=np.uint64)
    mu_hi, mu_lo = M.precompute_barrett128(q)
    col = (shape[0], 1)
    qa = np.full(col, q, np.uint64)
    mh = M.np_u64([[mu_hi]] * shape[0])
    ml = M.np_u64([[mu_lo]] * shape[0])
    return q, a, b, qa, mh, ml


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


@pytest.mark.parametrize("qbits", QBITS)
def test_add_sub_neg_match(qbits):
    q, a, b, qa, _, _ = _ctx(qbits)
    a[0, :4] = 0
    ja, jb, jq = _j(a, b, qa)
    ta, tb, tq = to_t(a), to_t(b), to_t(qa)
    for ref, got in ((M.add_mod(ja, jb, jq), TM.add_mod(ta, tb, tq)),
                     (M.sub_mod(ja, jb, jq), TM.sub_mod(ta, tb, tq)),
                     (M.neg_mod(ja, jq), TM.neg_mod(ta, tq))):
        np.testing.assert_array_equal(to_np(got), np.asarray(ref))


def test_mul_hi64_and_mul_128_full_range():
    a = RNG.integers(0, 2**64 - 1, size=4096, dtype=np.uint64)
    b = RNG.integers(0, 2**64 - 1, size=4096, dtype=np.uint64)
    a[:3] = [0, 2**64 - 1, 2**63]
    b[:3] = [2**64 - 1, 2**64 - 1, 2**63]
    ja, jb = _j(a, b)
    hi, lo = TM.mul_128(to_t(a), to_t(b))
    rhi, rlo = M.mul_128(ja, jb)
    np.testing.assert_array_equal(to_np(hi), np.asarray(rhi))
    np.testing.assert_array_equal(to_np(lo), np.asarray(rlo))
    np.testing.assert_array_equal(to_np(TM.mul_hi64(to_t(a), to_t(b))),
                                  np.asarray(M.mul_hi64(ja, jb)))


@pytest.mark.parametrize("qbits", QBITS)
def test_shoup_mul_matches(qbits):
    q, a, _, qa, _, _ = _ctx(qbits)
    ws = [int(RNG.integers(1, q)) for _ in range(3)]
    w = M.np_u64([[v] for v in ws])
    wp = M.np_u64([[M.precompute_shoup(v, q)] for v in ws])
    ref = M.shoup_mul(*_j(a, w, wp, qa))
    got = TM.shoup_mul(to_t(a), to_t(w), to_t(wp), to_t(qa))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


@pytest.mark.parametrize("qbits", QBITS)
def test_barrett_mul_matches(qbits):
    _, a, b, qa, mh, ml = _ctx(qbits)
    ref = M.barrett_mul(*_j(a, b, qa, mh, ml))
    got = TM.barrett_mul(*(to_t(x) for x in (a, b, qa, mh, ml)))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


@pytest.mark.parametrize("qbits", QBITS)
def test_barrett_full_u64_input(qbits):
    """mod_u64 and barrett_reduce_128 on full-range 64/128-bit inputs
    (tests/test_modops.py:75 for the JAX package)."""
    _, _, _, qa, mh, ml = _ctx(qbits)
    x = RNG.integers(0, 2**64 - 1, size=(3, 512), dtype=np.uint64)
    x[0, :2] = [2**64 - 1, 0]
    ref = M.mod_u64(*_j(x, qa, mh, ml))
    got = TM.mod_u64(*(to_t(v) for v in (x, qa, mh, ml)))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    # 128-bit value v_hi:v_lo with v_hi < q (a product of residues)
    q = int(qa[0, 0])
    hi = RNG.integers(0, q, size=(3, 512), dtype=np.uint64)
    ref = M.barrett_reduce_128(*_j(hi, x, qa, mh, ml))
    got = TM.barrett_reduce_128(*(to_t(v) for v in (hi, x, qa, mh, ml)))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    assert (to_np(got) < q).all()


@pytest.mark.parametrize("qbits", QBITS)
def test_k1_plain_matches_pallas_barrett(qbits):
    """Kernel K1's plain version == ace_tpu's Pallas barrett_mul."""
    _, a, b, qa, mh, ml = _ctx(qbits, shape=(2, 256))
    ref = PM.barrett_mul(*_j(a, b, qa, mh, ml))
    got = TPM.barrett_mul(*(to_t(x) for x in (a, b, qa, mh, ml)))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))
    # per-row b broadcast (mod-down's P^-1 product)
    ref = M.barrett_mul(*_j(a, b[:, :1], qa, mh, ml))
    got = TPM.barrett_mul(*(to_t(x) for x in (a, b[:, :1], qa, mh, ml)))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


@pytest.mark.parametrize("qbits", [59, 60])
def test_k2_plain_matches_pallas_shoup(qbits):
    """Kernel K2's plain version == ace_tpu's Pallas shoup_mul."""
    q, a, _, qa, _, _ = _ctx(qbits, shape=(2, 256))
    ws = [int(RNG.integers(1, q)) for _ in range(2)]
    w = M.np_u64([[v] for v in ws])
    wp = M.np_u64([[M.precompute_shoup(v, q)] for v in ws])
    ref = PM.shoup_mul(*_j(a, w, wp, qa))
    got = TPM.shoup_mul(to_t(a), to_t(w), to_t(wp), to_t(qa))
    np.testing.assert_array_equal(to_np(got), np.asarray(ref))


def test_dispatch_counts_no_launch_on_cpu():
    """CPU tensors take the plain versions: the launch counters stay."""
    _, a, b, qa, mh, ml = _ctx(50, shape=(2, 64))
    k1, k2 = TPM.barrett_mul.launches, TPM.shoup_mul.launches
    TPM.barrett_mul(*(to_t(x) for x in (a, b, qa, mh, ml)))
    TPM.shoup_mul(to_t(a), to_t(b[:, :1]), to_t(b[:, :1]), to_t(qa))
    assert (TPM.barrett_mul.launches, TPM.shoup_mul.launches) == (k1, k2)


def test_precompute_helpers_match():
    for qbits in QBITS:
        q = nt.gen_first_prime(128, qbits)
        w = int(RNG.integers(1, q))
        assert TM.precompute_shoup(w, q) == M.precompute_shoup(w, q)
        assert TM.precompute_barrett128(q) == M.precompute_barrett128(q)
    vals = [[1, 2**64 - 1], [2**63, 5]]
    np.testing.assert_array_equal(TM.np_u64(vals), M.np_u64(vals))
    x = np.array([0, 2**64 - 1, 2**63], np.uint64)
    np.testing.assert_array_equal(TM.to_numpy(TM.to_torch(x)), x)
