"""PyTorch port: CKKS encoder, keys and evaluator, bit for bit against
ace_tpu with ace_tpu's keys and ciphertexts injected (tests/
torch_port_util.py), and against the reference binary's vectors."""

import json
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ace_tpu.ckks.encoder import Encoder
from ace_tpu.ckks.evaluator import Evaluator
from ace_tpu.ckks.keygen import KeyGenerator
from ace_tpu.ckks.params import CkksParams
from ace_tpu_torch import interop
from ace_tpu_torch.ckks.encoder import Encoder as TEncoder
from ace_tpu_torch.ckks.evaluator import Evaluator as TEvaluator
from ace_tpu_torch.ckks.keygen import KeyGenerator as TKeyGenerator
from ace_tpu_torch.ckks.params import CkksParams as TParams

from tests.torch_port_util import (CPU, arr, assert_ct_equal,
                                   assert_poly_equal, port_ct, port_keygen,
                                   to_np)

RNG = np.random.default_rng(53)
ROTS = [1, 3, -2, 5, 7, 2, 4]
VEC = os.path.join(os.path.dirname(__file__), "vectors", "ref_vectors.json")


@pytest.fixture(scope="module")
def ctx():
    kw = dict(degree=16, num_q=4, first_mod_size=33, scaling_mod_size=30)
    params = CkksParams(**kw)
    enc = Encoder(params)
    kg = KeyGenerator(params, np.random.default_rng(77))
    for r in ROTS:
        kg.rot_key(r)
    ev = Evaluator(params, kg, enc)
    tparams = TParams(**kw, device="cpu")
    tenc = TEncoder(tparams)
    tkg = port_keygen(tparams, kg, rng=np.random.default_rng(5))
    tev = TEvaluator(tparams, tkg, tenc)
    return ev, tev


def _ct(ev, level=0):
    n_slots = ev.params.degree // 2
    m = RNG.uniform(-1, 1, n_slots).astype(np.complex128)
    return ev.encrypt(ev.encoder.encode(m, level=level))


@pytest.mark.parametrize("level,sf,ext", [(0, 1, False), (3, 1, False),
                                          (2, 2, False), (0, 1, True)])
def test_encode_matches(ctx, level, sf, ext):
    ev, tev = ctx
    vals = RNG.uniform(-2, 2, 8) + 1j * RNG.uniform(-2, 2, 8)
    want = ev.encoder.encode(vals, level, 8, sf, ext)
    got = tev.encoder.encode(vals, level, 8, sf, ext)
    assert_poly_equal(got.poly, want.poly)
    assert got.scaling_factor == want.scaling_factor
    np.testing.assert_array_equal(
        tev.encoder.encode_msg(vals, 8).numpy(),
        np.asarray(ev.encoder.encode_msg(vals, 8)))


def test_decode_matches(ctx):
    ev, tev = ctx
    pt = ev.decrypt(_ct(ev))
    tpt = interop.plaintext(arr(pt.poly), pt.scaling_factor, pt.sf_degree,
                            pt.slots, CPU)
    np.testing.assert_array_equal(tev.encoder.decode(tpt),
                                  ev.encoder.decode(pt))


def test_mul_relin_rescale_match(ctx):
    ev, tev = ctx
    a, b = _ct(ev), _ct(ev)
    want = ev.mul(a, b)
    got = tev.mul(port_ct(a), port_ct(b))
    assert_ct_equal(got, want)
    assert_ct_equal(tev.rescale(got), ev.rescale(want))
    assert_ct_equal(tev.square(port_ct(a)), ev.square(a))


def test_mixed_level_and_plain_ops_match(ctx):
    ev, tev = ctx
    a, b = _ct(ev), _ct(ev, level=3)
    ta, tb = port_ct(a), port_ct(b)
    assert_ct_equal(tev.add(ta, tb), ev.add(a, b))
    assert_ct_equal(tev.sub(ta, tb), ev.sub(a, b))
    assert_ct_equal(tev.add_const(ta, 0.37), ev.add_const(a, 0.37))
    assert_ct_equal(tev.mul_const(ta, -1.25), ev.mul_const(a, -1.25))
    assert_ct_equal(tev.mul_integer(ta, 3), ev.mul_integer(a, 3))
    assert_ct_equal(tev.mod_switch(ta), ev.mod_switch(a))
    pt = ev.encoder.encode(RNG.uniform(-1, 1, 8), level=4)
    tpt = interop.plaintext(arr(pt.poly), pt.scaling_factor, 1, pt.slots,
                            CPU)
    assert_ct_equal(tev.mul_plain(ta, tpt), ev.mul_plain(a, pt))
    assert_ct_equal(tev.add_plain(ta, tpt), ev.add_plain(a, pt))


def test_rotate_and_hoisted_match(ctx):
    ev, tev = ctx
    a = _ct(ev)
    ta = port_ct(a)
    for r in (1, -2, 5):
        assert_ct_equal(tev.rotate(ta, r), ev.rotate(a, r))
    for got, want in zip(tev.rotations_hoisted(ta, [0, 3, 7]),
                         ev.rotations_hoisted(a, [0, 3, 7])):
        assert_ct_equal(got, want)


def test_rot_sum_match_chunked(ctx):
    """rot_sum_jit over 7 items: two chunks of at most 5 rotations."""
    ev, tev = ctx
    items = [(_ct(ev), r) for r in [0] + ROTS[:6]]
    want = ev.rot_sum_jit(items)
    got = tev.rot_sum_jit([(port_ct(c), r) for c, r in items])
    assert_ct_equal(got, want)


@pytest.mark.parametrize("chunk", [12, 2])
def test_rot_mac_groups_msgs_match(ctx, chunk, monkeypatch):
    """The conv bundle, whole and chunked into 2-rotation bundles."""
    ev, tev = ctx
    monkeypatch.setenv("ACE_TPU_MAX_BUNDLE_MSG", str(chunk))
    tev.max_bundle_msg = chunk
    a = _ct(ev)
    rots = [0, 1, 3, 5, 7]
    n_slots = 8
    groups = [[RNG.uniform(-1, 1, n_slots) for _ in rots] for _ in range(3)]
    groups[1][2] = np.zeros(n_slots)
    msgs = [[ev.encoder.encode_msg_cached(w.astype(np.complex128), n_slots)
             if np.any(w) else ev.encoder.zero_msg() for w in g]
            for g in groups]
    want = ev.rot_mac_groups_msgs_jit(a, rots, jnp.stack(
        [jnp.stack(row) for row in msgs]))
    tmsgs = torch.as_tensor(np.stack([np.stack([np.asarray(m) for m in row])
                                      for row in msgs]))
    got = tev.rot_mac_groups_msgs_jit(port_ct(a), rots, tmsgs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_ct_equal(g, w)
    tev.max_bundle_msg = 12


def test_encrypt_decrypt_and_generated_keys():
    """The port's own keys: same seed -> same secret and public key as
    ace_tpu; its relin and rotation keys decrypt correctly."""
    kw = dict(degree=16, num_q=4, first_mod_size=33, scaling_mod_size=30)
    kg = KeyGenerator(CkksParams(**kw), np.random.default_rng(3))
    tp = TParams(**kw, device="cpu")
    tkg = TKeyGenerator(tp, np.random.default_rng(3))
    np.testing.assert_array_equal(tkg.sk.coeffs, kg.sk.coeffs)
    assert_poly_equal(tkg.sk.ntt_sk, kg.sk.ntt_sk)
    assert_poly_equal(tkg.pk.b, kg.pk.b)
    assert_poly_equal(tkg.pk.a, kg.pk.a)
    enc = TEncoder(tp)
    ev = TEvaluator(tp, tkg, enc)
    m = RNG.uniform(-1, 1, 8)
    ct = ev.encrypt(enc.encode(m.astype(np.complex128)))
    np.testing.assert_allclose(enc.decode(ev.decrypt(ct)).real, m,
                               atol=1e-6)
    sq = ev.rescale(ev.mul(ct, ct))
    np.testing.assert_allclose(enc.decode(ev.decrypt(sq)).real, m * m,
                               atol=1e-4)
    rot = ev.rotate(ct, 3)
    np.testing.assert_allclose(enc.decode(ev.decrypt(rot)).real,
                               np.roll(m, -3), atol=1e-5)


def _ref(vec):
    fx = vec["fixture"]
    tp = TParams(degree=fx["degree"], num_q=fx["num_q"],
                 first_mod_size=fx["first_mod_size"],
                 scaling_mod_size=fx["scaling_mod_size"],
                 num_q_parts=fx["num_q_parts"], device="cpu")

    def poly(o):
        n = o["degree"]
        data = np.asarray(o["data"], np.uint64).reshape(-1, n)
        return interop.poly(data, o["num_q"], o["num_p"], bool(o["is_ntt"]),
                            CPU)

    def ciph(o):
        return interop.ciphertext(
            np.asarray(o["c0"]["data"], np.uint64).reshape(
                -1, o["c0"]["degree"]),
            np.asarray(o["c1"]["data"], np.uint64).reshape(
                -1, o["c1"]["degree"]),
            o["scaling_factor"], o["sf_degree"], o["slots"], CPU)

    def swk(o):
        return ([to_np(poly(p["b"]).data) for p in o["parts"]],
                [to_np(poly(p["a"]).data) for p in o["parts"]])

    sk = poly(vec["sk_ntt"])
    kg = interop.keygen(tp, np.zeros(tp.degree, np.int64), to_np(sk.data),
                        to_np(sk.data[:tp.num_q]), to_np(sk.data[:tp.num_q]),
                        swk(vec["relin_key"]),
                        {vec["rot_idx"]: (vec["auto_idx"],
                                          *swk(vec["rot_key"]))})
    return TEvaluator(tp, kg, TEncoder(tp)), poly, ciph


def test_ref_vectors_bit_exact():
    """encode, mul+relin, rescale and rotate against the reference
    binary's dumps (tests/test_ref_vectors.py)."""
    with open(VEC) as f:
        vec = json.load(f)
    ev, poly, ciph = _ref(vec)
    assert ev.crt.q_primes == vec["q_primes"]
    assert ev.crt.p_primes == vec["p_primes"]
    pt = ev.encoder.encode(np.asarray(vec["encode_msg_re"], np.float64),
                           vec["encode_poly"]["num_q"], ev.params.degree // 2)
    np.testing.assert_array_equal(to_np(pt.poly.data),
                                  to_np(poly(vec["encode_poly"]).data))
    fresh = ciph(vec["fresh_ciph"])
    for got, want in ((ev.mul(fresh, fresh), ciph(vec["mul_relin"])),
                      (ev.rescale(ciph(vec["mul_relin"])),
                       ciph(vec["rescale"])),
                      (ev.rotate(fresh, vec["rot_idx"]),
                       ciph(vec["rotate"]))):
        np.testing.assert_array_equal(to_np(got.c0.data),
                                      to_np(want.c0.data))
        np.testing.assert_array_equal(to_np(got.c1.data),
                                      to_np(want.c1.data))
        assert got.scaling_factor == want.scaling_factor
