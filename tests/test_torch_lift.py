"""PyTorch port: kernel K6, the plaintext-message lift (csrc/lift.cu,
ops/lift.py), behind every MAC group of the hoisted conv bundles and of
the bootstrap's BSGS levels (Evaluator._mac_msgs).

The CPU tests hold a model of the kernel's word arithmetic and launch
shape, in Python integers, to the plain version (lift.lift_msgs_plain,
which lift.lift_msgs takes for CPU tensors) and to
encoder._signed_to_rns at the cell's ring and at ACE's N = 2^16
ring, on edge messages; check that CPU tensors take the plain version
without building a library; and that the wrapper refuses what K6
cannot take. The `gpu` tests hold K6 word for word to the plain
version run on the CPU, inside the bundles' captured op programs too,
and count its launches under the profiler. This file imports neither jax
nor ace_tpu, so it also runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_lift.py -m gpu --noconftest
"""

import numpy as np
import pytest
import torch

from ace_tpu_torch import interop, ops
from ace_tpu_torch.ckks import encoder as E
from ace_tpu_torch.ckks.encoder import Encoder
from ace_tpu_torch.ckks.evaluator import Evaluator
from ace_tpu_torch.ckks.keygen import KeyGenerator
from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.ops import kernels, lift, modops as TM
from ace_tpu_torch.poly.rns import CrtContext

# ResNet-20's ring (the benchmark's cells): 34 q + 12 P primes, 3 digits
CELL = dict(num_q=34, first_mod_size=60, scaling_mod_size=56,
            degree=1 << 15, num_q_parts=3)
# ACE's own ResNet-20 ring (SECURITY.md): 34 q + 11 P primes, 3 digits
ACE_2E16 = dict(num_q=34, first_mod_size=51, scaling_mod_size=50,
                degree=1 << 16, num_q_parts=3)
RINGS = {"cell": CELL, "ace_2e16": ACE_2E16}
M64 = (1 << 64) - 1
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1

_crts = {}


def _crt(ring: str, device: str = "cpu") -> CrtContext:
    key = (ring, device)
    if key not in _crts:
        _crts[key] = CrtContext(**RINGS[ring], device=device)
    return _crts[key]


def _plain(msgs, qk, muh, mulo):
    """The plain version, on CPU tensors."""
    assert not msgs.is_cuda
    return lift.lift_msgs_plain(msgs, qk, muh, mulo)


def _edge_messages(primes, n: int, seed: int) -> torch.Tensor:
    """[R, n] int64 messages: 0, +-1, +-(q - 1), +-q, +-(q + 1) of a few of
    the moduli, +-2^61, +-2^62, INT64_MAX, INT64_MIN, the rest random over
    the whole int64 range and within +-2^57 (weights at scale 2^56)."""
    edges = [0, 1, -1, 1 << 61, -(1 << 61), 1 << 62, -(1 << 62), I64_MAX,
             I64_MIN, I64_MIN + 1]
    for q in (primes[0], primes[len(primes) // 2], primes[-1], max(primes)):
        edges += [q - 1, -(q - 1), q, -q, q + 1, -(q + 1), 2 * q, -2 * q]
    rng = np.random.default_rng(seed)
    full = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64, endpoint=True)
    small = rng.integers(-(1 << 57), 1 << 57, n, dtype=np.int64)
    rows = np.stack([full, small, full[::-1].copy()])
    flat = rows.reshape(-1)
    flat[:len(edges)] = np.array(edges, dtype=np.int64)
    flat[-len(edges):] = np.array(edges[::-1], dtype=np.int64)
    return torch.from_numpy(rows)


def _k6_model(msgs: np.ndarray, qs, mus) -> np.ndarray:
    """csrc/lift.cu in Python integers: the launch's grid of (column
    blocks, messages, limb slices), each thread's two adjacent columns
    and its slice's limbs, each word by the kernel's mod_u64 (Barrett-128
    with a zero high word, 64-bit words wrapping) and the sign fix. Every
    residue is written exactly once."""
    R, n = msgs.shape
    LK = len(qs)
    assert n % lift.COLS == 0
    out = np.zeros((R, LK, n), dtype=np.uint64)
    seen = np.zeros((R, LK, n), dtype=np.int64)
    gx, gy, gz = lift.launch_shape(R, LK, n)
    assert (gy, gz) == (R, -(-LK // lift.LIMBS))
    for bx in range(gx):
        for t in range(lift.THREADS):
            col = (bx * lift.THREADS + t) * lift.COLS
            if col >= n:
                break
            for r in range(gy):
                for bz in range(gz):
                    for l in range(bz * lift.LIMBS,
                                   min(bz * lift.LIMBS + lift.LIMBS, LK)):
                        q, (mu_hi, mu_lo) = qs[l], mus[l]
                        for c in range(col, col + lift.COLS):
                            m = int(msgs[r, c])
                            mag = (-m) & M64 if m < 0 else m
                            left_h = (mag * mu_lo) >> 64
                            tmp1 = (((mag * mu_hi) & M64) + left_h) & M64
                            quot = ((mag * mu_hi) >> 64) + (tmp1 < left_h)
                            w = (mag - quot * q) & M64
                            w = w - q if w >= q else w
                            w = w - q if w >= q else w
                            assert w < q
                            out[r, l, c] = q - w if m < 0 and w else w
                            seen[r, l, c] += 1
    assert (seen == 1).all()
    return out


# ---------------------------------------------------------------------------
# CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ring", sorted(RINGS))
def test_kernel_model_matches_plain_and_encoder(ring):
    """The model of K6 equals the plain version and encoder._signed_to_rns
    at every modulus of the ring (the cell's 34 q + 12 P, ACE's 2^16
    ring's 34 q + 11 P) on edge messages: 0, +-1, +-(q - 1), +-q,
    +-(q + 1), +-2^62, INT64_MAX, INT64_MIN and random ones, over a row
    length that ends inside a block."""
    crt = _crt(ring)
    idx = list(range(len(crt.all_primes)))
    qk, muh, mulo = crt.mod_arrays(idx)
    qs = [int(q) for q in crt.all_primes]
    assert len(qs) == crt.num_q + crt.num_p == (46 if ring == "cell" else 45)
    mus = [TM.precompute_barrett128(q) for q in qs]
    msgs = _edge_messages(qs, 38, 5)
    want = TM.to_numpy(_plain(msgs, qk, muh, mulo))
    got = _k6_model(msgs.numpy(), qs, mus)
    np.testing.assert_array_equal(got, want)
    for r in range(msgs.shape[0]):
        np.testing.assert_array_equal(
            E._signed_to_rns(msgs[r].numpy(), qs), want[r])


def test_cpu_takes_the_plain_version_and_builds_nothing(monkeypatch):
    """The bundles on CPU tensors lift through the plain version: no
    kernel library is built or loaded and K6's counter stays at 0, while
    _mac_msgs is called once per MAC group."""
    def refuse(*a, **k):
        raise AssertionError("a kernel library was built or loaded")
    monkeypatch.setattr(kernels, "build_all", refuse)
    monkeypatch.setattr(kernels, "lib", refuse)
    params = CkksParams(degree=64, num_q=4, first_mod_size=60,
                        scaling_mod_size=50, num_q_parts=2, device="cpu")
    kg = KeyGenerator(params, np.random.default_rng(1))
    enc = Encoder(params)
    ev = Evaluator(params, kg, enc)
    calls = []
    mac = ev._mac_msgs
    monkeypatch.setattr(ev, "_mac_msgs",
                        lambda *a: calls.append(1) or mac(*a))
    ct = ev.encrypt(enc.encode(np.full(32, 0.25, dtype=np.complex128)))
    msgs = _edge_messages(params.crt.all_primes, 64, 2)
    ops.reset_counters()
    ev.rot_mac_groups_msgs_jit(ct, [0, 1, 2], msgs[None])
    ev.bsgs_iter_jit(ct, [0, 1], [0, 2], torch.stack([msgs[:2], msgs[1:]]))
    assert len(calls) == 3
    assert ops.read_counters()["K6"] == 0
    assert "K6" not in ops.read_limbs()


def test_wrapper_refuses_what_k6_cannot_take():
    """K6 takes [R, n] int64 messages with n even (two columns a thread)
    and one (q, mu_hi, mu_lo) triple a limb, all int64 on one card: the
    wrapper's card branch refuses CPU tensors, other dtypes and other
    shapes before anything is built, and CPU messages never reach it
    (lift_msgs returns the plain version's words for them)."""
    crt = CrtContext(4, 60, 56, 64, 2, device="cpu")
    qk, muh, mulo = crt.mod_arrays(range(4))
    msgs = torch.zeros((2, 64), dtype=torch.int64)
    with pytest.raises(TypeError, match="CUDA"):
        lift._check(msgs, qk, muh, mulo)
    with pytest.raises(TypeError, match="int64"):
        lift._check(msgs.to(torch.int32), qk, muh, mulo)
    with pytest.raises(ValueError, match=r"\[R, n\]"):
        lift._check(msgs[0], qk, muh, mulo)
    with pytest.raises(ValueError, match=r"\[R, n\]"):
        lift._check(msgs[None], qk, muh, mulo)
    with pytest.raises(ValueError, match="n even"):
        lift._check(msgs[:, :63], qk, muh, mulo)
    with pytest.raises(ValueError, match="mu word"):
        lift._check(msgs, qk, muh[:3], mulo)
    before = lift.lift_msgs.launches
    msgs = _edge_messages(crt.all_primes, 64, 4)
    assert torch.equal(lift.lift_msgs(msgs, qk, muh, mulo),
                       lift.lift_msgs_plain(msgs, qk, muh, mulo))
    assert lift.lift_msgs.launches == before


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _lift_on_card(crt_g, msgs, idx):
    """lift.lift_msgs, as Evaluator._mac_msgs calls it, on card tensors."""
    qk, muh, mulo = crt_g.mod_arrays(idx)
    return lift.lift_msgs(msgs, qk, muh, mulo)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1 << 15, 1 << 16])
@pytest.mark.parametrize("lk", [13, 22, 46])
@pytest.mark.parametrize("r", [1, 8, 12])
def test_k6_equals_plain_on_the_cpu(r, lk, n):
    """K6 on the card == the plain version on the CPU, word for word, at
    the bundles' shapes: R 1 to 12 messages (max_bundle_msg, the BSGS baby
    counts), LK 13 to 46 limbs (level 1 to 34 of the cell's ring with its
    12 P primes; the lift reads nothing of the ring but its moduli) and
    N = 2^15, 2^16; one launch each."""
    _card()
    c, g = _crt("cell"), _crt("cell", "cuda")
    # the live q limbs of a level and the P limbs, as _mac_msgs' idx
    idx = list(range(lk - c.num_p)) + list(range(c.num_q, c.num_q + c.num_p))
    msgs = _edge_messages(c.all_primes, n, r + lk)[np.arange(r) % 3]
    want = _plain(msgs, *c.mod_arrays(idx))
    before = ops.read_counters()["K6"]
    got = _lift_on_card(g, msgs.cuda(), idx)
    torch.cuda.synchronize()
    assert ops.read_counters()["K6"] == before + 1
    assert got.shape == (r, lk, n)
    np.testing.assert_array_equal(TM.to_numpy(got.cpu()), TM.to_numpy(want))


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["misaligned", "strided"])
def test_k6_takes_any_message_view(case):
    """The wrapper hands K6 its messages contiguous and 16-byte aligned: a
    message buffer 8 bytes off a 16-byte boundary and a non-contiguous
    view each equal the plain version."""
    _card()
    c, g = _crt("cell"), _crt("cell", "cuda")
    idx = list(range(20))
    base = _edge_messages(c.all_primes, 4096, 3)
    if case == "misaligned":
        flat = torch.zeros(1 + base.numel(), dtype=torch.int64, device="cuda")
        flat[1:] = base.reshape(-1).cuda()
        msgs_g, msgs = flat[1:].view(base.shape), base
        assert msgs_g.data_ptr() % 16 == 8
    else:
        msgs_g, msgs = base.cuda()[:, ::2], base[:, ::2]
    want = _plain(msgs, *c.mod_arrays(idx))
    got = _lift_on_card(g, msgs_g, idx)
    np.testing.assert_array_equal(TM.to_numpy(got.cpu()), TM.to_numpy(want))


KW = dict(degree=1 << 12, num_q=8, first_mod_size=60, scaling_mod_size=50,
          num_q_parts=3)
ROTS = [0, 1, 2, 3, 5]
BABY, GIANT = [0, 1, 2, 3], [0, 4, 8]


@pytest.fixture(scope="module")
def pair():
    """One set of keys on the CPU and the same keys on the card, with an
    Evaluator on each and an eager one (programs=False) on the card."""
    _card()
    pc = CkksParams(**KW, device="cpu")
    ckg = KeyGenerator(pc, np.random.default_rng(3))
    npk = interop.to_numpy
    rot = {}
    for r in sorted(set(ROTS + BABY + GIANT) - {0}):
        auto_idx, key = ckg.rot_key(r)
        rot[r] = (auto_idx, [npk(p) for p in key.b], [npk(p) for p in key.a])
    pg = CkksParams(**KW, device="cuda")
    gkg = interop.keygen(
        pg, ckg.sk.coeffs, npk(ckg.sk.ntt_sk), npk(ckg.pk.b), npk(ckg.pk.a),
        ([npk(p) for p in ckg.relin_key.b],
         [npk(p) for p in ckg.relin_key.a]), rot, np.random.default_rng(4))
    cenc, genc = Encoder(pc), Encoder(pg)
    return (Evaluator(pc, ckg, cenc), Evaluator(pg, gkg, genc),
            Evaluator(pg, gkg, genc, programs=False), cenc)


def _bundle_calls(ev, ct, msgs_rmg, msgs_bsgs):
    outs = ev.rot_mac_groups_msgs_jit(ct, ROTS, msgs_rmg)
    return [*outs, ev.bsgs_iter_jit(ct, BABY, GIANT, msgs_bsgs)]


def _card_ct(ct):
    return interop.ciphertext(interop.to_numpy(ct.c0), interop.to_numpy(ct.c1),
                              ct.scaling_factor, ct.sf_degree, ct.slots,
                              "cuda")


@pytest.mark.gpu
def test_bundles_on_the_card_equal_the_cpu_eager_and_replayed(pair):
    """rot_mac_groups_msgs_jit (2 groups of 5 rotations) and bsgs_iter_jit
    (4 babies, 3 giants) on the card, through their programs (call 1
    eager, 2 captured, 3 replayed) on fresh ciphertexts and messages,
    each equal word for word to the same calls on the CPU under the same
    keys; K6 counts one launch per MAC group in every call, replays
    included."""
    cev, gev, _, enc = pair
    n = KW["degree"]
    rng = np.random.default_rng(7)
    for call in range(3):
        ct = cev.encrypt(enc.encode(rng.uniform(-1, 1, n // 2)
                                    .astype(np.complex128)))
        base = _edge_messages(cev.crt.all_primes, n, 10 + call)
        m_rmg = torch.stack([base[np.arange(5) % 3],
                             base[(np.arange(5) + 1) % 3]])
        m_bsgs = base[np.arange(12) % 3].reshape(3, 4, n)
        want = _bundle_calls(cev, ct, m_rmg, m_bsgs)
        before = ops.read_counters()["K6"]
        got = _bundle_calls(gev, _card_ct(ct), m_rmg.cuda(), m_bsgs.cuda())
        torch.cuda.synchronize()
        assert ops.read_counters()["K6"] == before + 2 + 3, call
        for w, g in zip(want, got):
            for part in ("c0", "c1"):
                np.testing.assert_array_equal(
                    TM.to_numpy(getattr(g, part).data.cpu()),
                    TM.to_numpy(getattr(w, part).data), err_msg=str(call))
    st = gev.program_stats()
    assert st["captures"] == 2 and st["replays"] == 4  # calls 2 and 3


@pytest.mark.gpu
def test_one_k6_kernel_per_mac_group(pair, monkeypatch):
    """Under torch.profiler, read from the kineto events: the eager
    bundles launch one K6 kernel per _mac_msgs call, each followed by the
    forward NTT of its residues (K3) with no ATen kernel between."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cev, _, gev, enc = pair
    n = KW["degree"]
    ct = _card_ct(cev.encrypt(enc.encode(np.full(n // 2, 0.5,
                                                 dtype=np.complex128))))
    base = _edge_messages(cev.crt.all_primes, n, 20).cuda()
    m_rmg = torch.stack([base[np.arange(5) % 3]] * 2)
    m_bsgs = base[np.arange(12) % 3].reshape(3, 4, n)
    _bundle_calls(gev, ct, m_rmg, m_bsgs)  # libraries and constants first
    torch.cuda.synchronize()
    calls = []
    mac = gev._mac_msgs
    monkeypatch.setattr(gev, "_mac_msgs",
                        lambda *a: calls.append(1) or mac(*a))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _bundle_calls(gev, ct, m_rmg, m_bsgs)
        torch.cuda.synchronize()
    names = [e.name() for e in sorted(
        (e for e in prof.profiler.kineto_results.events()
         if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0),
        key=lambda e: e.start_ns())]
    at = [i for i, s in enumerate(names) if "k6_lift_msgs" in s]
    assert len(calls) == 2 + 3
    assert len(at) == len(calls), names
    for i in at:
        assert "ntt_cluster" in names[i + 1], names[i - 1:i + 2]
