"""PyTorch port: CKKS bootstrapping.

(a) The host tables (FFT parameters, collapsed diagonal matrices,
    rotation inventory, BootstrapContext's scaled tables) equal
    ace_tpu.ckks.bootstrap's exactly, at N = 2^15 and at degree 64.
(b) The port's bootstrap replayed against the reference binary's stage
    vectors (tests/vectors/ref_bootstrap.json.gz, the vectors ace_tpu is
    held to in tests/test_ref_bootstrap.py) with the dumped keys
    injected: mod-raise, the conjugate split and, with the reference's
    own diagonal plaintexts, CoeffsToSlots and SlotsToCoeffs bit-exact;
    the self-computed diagonals within one llround step; approx-mod and
    recombine within 1e-8 decoded; full and sparse bootstrap within 1e-6.
(c) conjugate, mul_by_monomial and bsgs_iter_jit on the same keys and
    ciphertexts as ace_tpu give the same residues; every collapsed level
    has at least two baby steps.
"""

import gzip
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ace_tpu.ckks import bootstrap as B
from ace_tpu.ckks.encoder import Encoder
from ace_tpu.ckks.evaluator import Evaluator
from ace_tpu.ckks.keygen import KeyGenerator
from ace_tpu.ckks.params import CkksParams
from ace_tpu_torch import interop
from ace_tpu_torch.ckks import bootstrap as TB
from ace_tpu_torch.ckks.cipher import Ciphertext as TCiphertext
from ace_tpu_torch.ckks.encoder import Encoder as TEncoder
from ace_tpu_torch.ckks.encoder import Plaintext as TPlaintext
from ace_tpu_torch.ckks.evaluator import Evaluator as TEvaluator
from ace_tpu_torch.ckks.params import CkksParams as TParams
from ace_tpu_torch.poly import poly as TP
from ace_tpu_torch.poly.poly import RnsPoly as TRnsPoly

from tests.torch_port_util import (CPU, assert_ct_equal, port_ct,
                                   port_keygen, to_np)

VEC = os.path.join(os.path.dirname(__file__), "vectors",
                   "ref_bootstrap.json.gz")


# -- (a) host tables --------------------------------------------------------

# (degree, slots): ResNet-20's ring, and the degree-64 fixture fully
# packed and sparse
SHAPES = [(32768, 16384), (64, 32), (64, 8)]


@pytest.mark.parametrize("degree,slots", SHAPES)
def test_fft_tables_equal(degree, slots):
    """select_layers and fft_params at budgets 1-3, and coeff_collapse
    (both directions, both channels) at the bootstrap's budget: exactly
    equal."""
    log_slots = int(np.log2(slots))
    m = 4 * slots
    rot_group = np.array([pow(5, i, m) for i in range(slots)], np.int64)
    ang = 2.0 * np.pi * np.arange(m + 1) / m
    ksipows = np.cos(ang) + 1j * np.sin(ang)
    ksipows[m] = ksipows[0]
    for budget in (1, 2, 3):
        assert TB.select_layers(log_slots, budget) == \
            B.select_layers(log_slots, budget)
        assert TB.fft_params(slots, budget) == B.fft_params(slots, budget)
    budget = min(3, log_slots)
    for flag in (False, True):
        for encoding in (True, False):
            got = TB.coeff_collapse(ksipows, rot_group, budget, flag,
                                    encoding)
            want = B.coeff_collapse(ksipows, rot_group, budget, flag,
                                    encoding)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("degree,slots", SHAPES)
def test_rotation_indices_equal(degree, slots):
    assert TB.bootstrap_rotation_indices(degree, slots) == \
        B.bootstrap_rotation_indices(degree, slots)


@pytest.mark.parametrize("degree,slots,hw", [(32768, 16384, 192),
                                             (64, 32, 32), (64, 8, 0)])
def test_bootstrap_context_tables_equal(degree, slots, hw):
    """BootstrapContext's scaled diagonal tables and constants: exactly
    equal. Its constructor reads only the degree, q0, the scaling
    factor and the hamming weight, given here without a key set."""
    params = SimpleNamespace(
        degree=degree, scaling_factor=float(2 ** 56), hamming_weight=hw,
        crt=SimpleNamespace(q_primes=[(1 << 60) - 93]))
    got = TB.BootstrapContext(SimpleNamespace(params=params), slots)
    want = B.BootstrapContext(SimpleNamespace(params=params), slots)
    for key in ("slots", "is_sparse", "enc_params", "dec_params",
                "scale_enc", "scale_dec", "deg", "sine_coeffs",
                "double_angle", "k_bound"):
        assert getattr(got, key) == getattr(want, key), key
    for name in ("enc_coeff", "dec_coeff"):
        a, b = getattr(got, name), getattr(want, name)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y, err_msg=name)


# -- (b) the reference binary's stage vectors ------------------------------

pytest_vec = pytest.mark.skipif(
    not os.path.exists(VEC),
    reason="ref_bootstrap vectors not generated "
           "(scripts/refvec/gen_bootstrap.sh)")


@pytest.fixture(scope="module")
def vec():
    with gzip.open(VEC, "rt") as f:
        return json.load(f)


def _arr(obj) -> np.ndarray:
    nq, np_, n = obj["num_q"], obj["num_p"], obj["degree"]
    return np.asarray(obj["data"], dtype=np.uint64).reshape(nq + np_, n)


def as_poly(obj) -> TRnsPoly:
    return interop.poly(_arr(obj), obj["num_q"], obj["num_p"],
                        bool(obj["is_ntt"]), CPU)


def as_ciph(obj) -> TCiphertext:
    return TCiphertext(as_poly(obj["c0"]), as_poly(obj["c1"]),
                       obj["scaling_factor"], obj["sf_degree"],
                       obj["slots"])


def _swk(obj) -> tuple:
    return ([_arr(p["b"]) for p in obj["parts"]],
            [_arr(p["a"]) for p in obj["parts"]])


@pytest.fixture(scope="module")
def ref(vec):
    """The port's evaluator holding the dumped keys, injected through
    interop.keygen (the conjugation key as the entry of auto index
    2N-1), and a decoder under the dumped secret."""
    fx = vec["fixture"]
    params = TParams(degree=fx["degree"], num_q=fx["num_q"],
                     first_mod_size=fx["first_mod_size"],
                     scaling_mod_size=fx["scaling_mod_size"],
                     num_q_parts=fx["num_q_parts"],
                     hamming_weight=fx["hamming_weight"], device="cpu")
    assert params.crt.q_primes == vec["q_primes"], "prime chain mismatch"
    assert params.crt.p_primes == vec["p_primes"]
    n = params.degree
    rot = {}
    for row in (vec["all_rot_keys"] + vec["rot_keys"]
                + vec["sparse_rot_keys"]):
        rot.setdefault(row["auto_idx"], (row["auto_idx"],
                                         *_swk(row["key"])))
    rot[2 * n - 1] = (2 * n - 1, *_swk(vec["conj_key"]))
    sk = _arr(vec["sk_ntt"])
    kg = interop.keygen(params, np.zeros(n, np.int64), sk,
                        sk[:params.num_q], sk[:params.num_q],
                        _swk(vec["relin_key"]), rot)
    assert 2 * n - 1 in kg._rot_keys

    def no_new_keys(*_):
        raise AssertionError("a key the vectors do not hold was asked for")
    kg._gen_switching_key = no_new_keys
    ev = TEvaluator(params, kg, TEncoder(params))
    sk_poly = as_poly(vec["sk_ntt"])

    def dec(ct):
        s = TRnsPoly(sk_poly.data[:ct.level], ct.level, 0, True)
        m = TP.add(TP.mul(ct.c1, s, params.crt), ct.c0, params.crt)
        return ev.encoder.decode(TPlaintext(m, ct.scaling_factor,
                                            ct.sf_degree, ct.slots))
    return ev, dec


@pytest.fixture(scope="module")
def bts(ref):
    return TB.BootstrapContext(ref[0])


def ct_eq(got, want, what: str) -> None:
    assert got.level == want.level, (what, got.level, want.level)
    assert got.sf_degree == want.sf_degree, what
    assert np.isclose(got.scaling_factor, want.scaling_factor,
                      rtol=1e-12), what
    np.testing.assert_array_equal(to_np(got.c0.data), to_np(want.c0.data),
                                  err_msg=what)
    np.testing.assert_array_equal(to_np(got.c1.data), to_np(want.c1.data),
                                  err_msg=what)


def ct_struct_eq(got, want, what: str) -> None:
    assert got.level == want.level, (what, got.level, want.level)
    assert got.sf_degree == want.sf_degree, what
    assert np.isclose(got.scaling_factor, want.scaling_factor,
                      rtol=1e-12), what


def ref_msg(plobj, ev) -> np.ndarray:
    """Reference plaintext -> its signed integer message (exact CRT
    center-lift over the q limbs)."""
    poly = as_poly(plobj["poly"])
    if poly.is_ntt:
        poly = TP.from_ntt(poly, ev.crt)
    data = to_np(poly.data)
    qs = ev.crt.q_primes[:poly.num_q]
    Q = 1
    for q in qs:
        Q *= q
    hats = [Q // q for q in qs]
    hinv = [pow(h % q, -1, q) for h, q in zip(hats, qs)]
    acc = np.zeros(poly.degree, dtype=object)
    for l in range(poly.num_q):
        acc += (data[l].astype(object) * hinv[l] % qs[l]) * hats[l]
    acc %= Q
    acc = np.where(acc > Q // 2, acc - Q, acc)
    return acc.astype(np.int64)


class _PlainInjector:
    """Serves the reference's dumped diagonal messages in the order
    _level_msgs requests them (levels as _transform visits them, dim2
    ascending within each)."""

    def __init__(self, plains, order, ev):
        self.queue = [ref_msg(obj, ev) for s in order for obj in plains[s]
                      if obj is not None]
        self.i = 0

    def __call__(self, values, slots=0):
        msg = self.queue[self.i]
        self.i += 1
        return torch.as_tensor(msg)


@pytest_vec
def test_stage_mod_raise_bit_exact(vec, ref, bts):
    """The mod-raise prefix of bootstrap(): last tower, iNTT, centred
    lift to the whole chain, NTT."""
    ev, _ = ref
    crt = ev.crt
    ct = as_ciph(vec["bts_input"])
    c0 = TRnsPoly(ct.c0.data[:1], 1, 0, True)
    c1 = TRnsPoly(ct.c1.data[:1], 1, 0, True)
    target = len(vec["q_primes"])
    got = TCiphertext(
        TP.to_ntt(TP.mod_raise(TP.from_ntt(c0, crt), crt, target), crt),
        TP.to_ntt(TP.mod_raise(TP.from_ntt(c1, crt), crt, target), crt),
        ct.scaling_factor, 1, ct.slots)
    ct_eq(got, as_ciph(vec["bts_raised"]), "mod-raise")


@pytest_vec
def test_stage_conj_split_bit_exact(vec, ref):
    ev, _ = ref
    m = 2 * ev.params.degree
    enc = as_ciph(vec["bts_c2s"])
    conj = ev.conjugate(enc)
    sub = ev.sub(enc, conj)
    enc = ev.add(enc, conj)
    sub = ev.mul_by_monomial(sub, 3 * m // 4)
    while enc.sf_degree > 1:
        enc = ev.rescale(enc)
        sub = ev.rescale(sub)
    ct_eq(enc, as_ciph(vec["bts_pre_mod_real"]), "conj split real")
    ct_eq(sub, as_ciph(vec["bts_pre_mod_imag"]), "conj split imag")


@pytest_vec
@pytest.mark.parametrize("encoding", [True, False], ids=["c2s", "s2c"])
def test_transform_bit_exact_with_ref_plains(vec, ref, monkeypatch,
                                             encoding):
    """With the reference's own diagonal plaintexts injected, C2S and S2C
    are bit-exact: every key switch, automorphism and mod-down of the
    BSGS levels matches the reference binary."""
    ev, _ = ref
    bts = TB.BootstrapContext(ev)
    # C2S visits its main levels descending (2, 1), then the remainder
    # level 0; S2C ascending (0, 1), then the remainder level 2
    if encoding:
        inj = _PlainInjector(vec["c2s_plains"], [2, 1, 0], ev)
        src, want, run = "bts_raised", "bts_c2s", bts.coeffs_to_slots
    else:
        inj = _PlainInjector(vec["s2c_plains"], [0, 1, 2], ev)
        src, want, run = "bts_combined", "bts_s2c", bts.slots_to_coeffs
    monkeypatch.setattr(ev.encoder, "encode_msg", inj)
    got = run(as_ciph(vec[src]))
    assert inj.i == len(inj.queue), "plaintext request order drifted"
    ct_eq(got, as_ciph(vec[want]), want)


@pytest_vec
def test_diag_tables_within_one_llround_step(vec, ref, bts):
    """The port's self-computed diagonal messages against the
    reference's: at most 16 coefficients of the whole C2S+S2C table set
    differ, each by exactly 1 (llround half-way cases; the bound of
    tests/test_ref_bootstrap.py)."""
    ev, _ = ref
    total_diff = max_diff = 0
    for plains, p, coeff, scale, enc_side in (
            (vec["c2s_plains"], bts.enc_params, bts.enc_coeff,
             bts.scale_enc, True),
            (vec["s2c_plains"], bts.dec_params, bts.dec_coeff,
             bts.scale_dec, False)):
        budget = p["level_budget"]
        flag_rem = p["flag_rem"]
        for s in range(budget):
            is_rem = flag_rem and (s == (0 if enc_side else budget - 1))
            g = p["g_rem"] if is_rem else p["g"]
            if enc_side:
                shift = 1 if is_rem else (
                    1 << ((s - flag_rem) * p["layers_coll"]
                          + p["rem_coll"]))
            else:
                shift = 1 << (s * p["layers_coll"])
            apply_scale = is_rem if flag_rem else (
                s == (0 if enc_side else budget - 1))
            sc = scale if apply_scale else 1.0
            for d2, obj in enumerate(plains[s]):
                if obj is None:
                    continue
                diag = coeff[s][d2] * sc
                rolled = np.roll(diag, (g * (d2 // g) * shift) % len(diag))
                ours = ev.encoder.encode_msg(rolled, slots=len(rolled))
                d = np.abs(ours.numpy() - ref_msg(obj, ev))
                total_diff += int(np.sum(d != 0))
                max_diff = max(max_diff, int(d.max()) if d.size else 0)
    assert total_diff <= 16, total_diff
    assert max_diff <= 1, max_diff


ATOL = 1e-8


@pytest_vec
@pytest.mark.parametrize("stage", ["c2s", "approx_mod", "recombine", "s2c"])
def test_stage_decoded(vec, ref, bts, stage):
    """Stages with the port's own tables: the reference's level and
    scale, decoded values within 1e-8."""
    ev, dec = ref
    m = 2 * ev.params.degree
    if stage == "c2s":
        got = bts.coeffs_to_slots(as_ciph(vec["bts_raised"]))
        want = as_ciph(vec["bts_c2s"])
    elif stage == "approx_mod":
        got = bts.eval_approx_mod(as_ciph(vec["bts_pre_mod_real"]))
        want = as_ciph(vec["bts_approx_real"])
    elif stage == "recombine":
        real = bts.eval_approx_mod(as_ciph(vec["bts_pre_mod_real"]))
        imag = bts.eval_approx_mod(as_ciph(vec["bts_pre_mod_imag"]))
        got = ev.add(real, ev.mul_by_monomial(imag, m // 4))
        want = as_ciph(vec["bts_combined"])
    else:
        got = bts.slots_to_coeffs(as_ciph(vec["bts_combined"]))
        want = as_ciph(vec["bts_s2c"])
    ct_struct_eq(got, want, stage)
    np.testing.assert_allclose(dec(got), dec(want), atol=ATOL)


@pytest_vec
@pytest.mark.parametrize("slots", [0, 8], ids=["full", "sparse"])
def test_bootstrap_decoded(vec, ref, bts, slots):
    """Whole bootstrap, fully packed and sparse (8 slots): the
    reference's level and scale, decoded within 1e-6 (the bootstrap's
    own precision, as in tests/test_ref_bootstrap.py)."""
    ev, dec = ref
    if slots:
        ctx = TB.BootstrapContext(ev, slots=slots)
        src, want = "bts_sparse_input", "bts_sparse_full"
    else:
        ctx, src, want = bts, "bts_input", "bts_full"
    got = ctx.bootstrap(as_ciph(vec[src]))
    ct_struct_eq(got, as_ciph(vec[want]), want)
    np.testing.assert_allclose(dec(got), dec(as_ciph(vec[want])),
                               atol=1e-6)


# -- (c) the evaluator's bootstrap ops against ace_tpu ----------------------

BABY = [0, 1, 2, 31]


@pytest.fixture(scope="module")
def pair():
    """ace_tpu's evaluator and the port's on the same keys (degree 64,
    a 6-prime chain)."""
    kw = dict(degree=64, num_q=6, first_mod_size=60, scaling_mod_size=56,
              hamming_weight=32)
    params = CkksParams(**kw)
    kg = KeyGenerator(params, np.random.default_rng(91))
    for r in BABY[1:] + [4, 8]:
        kg.rot_key(r)
    kg.conj_key()
    ev = Evaluator(params, kg, Encoder(params))
    tparams = TParams(**kw, device="cpu")
    tkg = port_keygen(tparams, kg, rng=np.random.default_rng(2))
    return ev, TEvaluator(tparams, tkg, TEncoder(tparams))


def _ct(ev, level=0, seed=0):
    rng = np.random.default_rng(seed)
    m = rng.uniform(-1, 1, 32) + 1j * rng.uniform(-1, 1, 32)
    return ev.encrypt(ev.encoder.encode(m, level=level))


@pytest.mark.parametrize("level", [6, 3])
def test_conjugate_and_monomial_match(pair, level):
    ev, tev = pair
    a = _ct(ev, level, seed=level)
    ta = port_ct(a)
    assert_ct_equal(tev.conjugate(ta), ev.conjugate(a))
    n = ev.params.degree
    for power in (3 * 2 * n // 4, 2 * n // 4, 5, n + 7):
        assert_ct_equal(tev.mul_by_monomial(ta, power),
                        ev.mul_by_monomial(a, power))


@pytest.mark.parametrize("giants", [[0, 4, 8], [0, 0, 4]],
                         ids=["giant-0-first", "giant-0-later"])
def test_bsgs_iter_match(pair, giants):
    """One BSGS level: baby rotations with a 0 (the plain QP embedding),
    giants with a 0 first (and, second case, also at a later step), a
    zero message row; residues equal to ace_tpu's."""
    ev, tev = pair
    rng = np.random.default_rng(len(giants) + giants[1])
    a = _ct(ev, 5, seed=7)
    rows = []
    for i in range(len(giants)):
        row = []
        for j in range(len(BABY)):
            if (i, j) == (len(giants) - 1, len(BABY) - 1):
                row.append(np.asarray(ev.encoder.zero_msg()))
                continue
            d = rng.uniform(-1, 1, 32) + 1j * rng.uniform(-1, 1, 32)
            row.append(np.asarray(ev.encoder.encode_msg_cached(d, 32)))
        rows.append(np.stack(row))
    msgs = np.stack(rows)
    want = ev.bsgs_iter_jit(a, BABY, giants, jnp.asarray(msgs))
    got = tev.bsgs_iter_jit(port_ct(a), BABY, giants, torch.as_tensor(msgs))
    assert_ct_equal(got, want)


@pytest.mark.parametrize("log_slots", range(1, 15))
def test_fft_params_give_two_baby_steps(log_slots):
    """Every collapsed level has g >= 2 baby steps (and g_rem >= 2 where
    a remainder level exists), at the budgets BootstrapContext uses for
    2 to 2^14 slots: _bsgs_level never meets g < 2."""
    for budget in TB.LEVEL_BUDGET:
        p = TB.fft_params(1 << log_slots, min(budget, log_slots) or 1)
        assert p["g"] >= 2
        assert p["g_rem"] >= 2 if p["flag_rem"] else p["g_rem"] == 0


def test_bsgs_level_refuses_one_baby_step(pair):
    _, tev = pair
    a = port_ct(_ct(pair[0], 4, seed=11))
    msgs = torch.zeros(4, 1, tev.params.degree, dtype=torch.int64)
    with pytest.raises(AssertionError, match="g >= 2"):
        TB.BootstrapContext(tev)._bsgs_level(a, [31, 0, 1, 2], msgs, 1, 1)
