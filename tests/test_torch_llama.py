"""PyTorch port: the LLaMA attention block (models/llama.py, the graph and
its plain executor; models/llama_fhe.py, one head encrypted) against
ace_tpu on the CPU: the graph and the plain oracles equal, the block's
helpers bit for bit with ace_tpu's keys and ciphertexts injected, the
port's whole block against the plain oracle, the same ValueErrors, and
chip_smoke.py's phase 8 rehearsed at SEQ = 4, D = 8."""

import dataclasses
import types

import numpy as np
import pytest

from ace_tpu.ckks import nonlinear as NL
from ace_tpu.ckks.encoder import Encoder
from ace_tpu.ckks.evaluator import Evaluator
from ace_tpu.ckks.keygen import KeyGenerator
from ace_tpu.ckks.params import CkksParams
from ace_tpu.models import llama as L
from ace_tpu.models import llama_fhe as LF
from ace_tpu_torch.ckks import nonlinear as TNL
from ace_tpu_torch.ckks.encoder import Encoder as TEncoder
from ace_tpu_torch.ckks.evaluator import Evaluator as TEvaluator
from ace_tpu_torch.ckks.keygen import KeyGenerator as TKeyGenerator
from ace_tpu_torch.ckks.params import CkksParams as TParams
from ace_tpu_torch.models import llama as TL
from ace_tpu_torch.models import llama_fhe as TLF

import chip_smoke

from tests.torch_port_util import assert_ct_equal, port_ct, port_keygen

SEQ, D = 4, 8  # fully packed at degree 64 (seq*d == N/2)
BLOCK_KW = dict(degree=2 * SEQ * D, num_q=50, first_mod_size=60,
                scaling_mod_size=50)


def _weights(rng, d=D, scale=0.35):
    """tests/test_llama_fhe.py's weights."""
    return {
        "rms_weight": rng.uniform(0.6, 1.4, d),
        "wq": rng.standard_normal((d, d)) * scale,
        "wk": rng.standard_normal((d, d)) * scale,
        "wv": rng.standard_normal((d, d)) * scale,
    }


# -- the graph and the plain oracles ---------------------------------------

GRAPHS = [dict(seq=SEQ, embed=D, n_heads=1, n_rep=1),
          dict(seq=3, embed=64, n_heads=4, n_rep=4),
          dict(seq=2, embed=48, n_heads=6, n_rep=6)]


@pytest.mark.parametrize("kw", GRAPHS)
def test_build_attention_block_equal(kw):
    got, want = TL.build_attention_block(**kw), L.build_attention_block(**kw)
    assert [dataclasses.asdict(o) for o in got.ops] == \
        [dataclasses.asdict(o) for o in want.ops]
    assert (got.input_name, got.input_shape, got.output_name) == \
        (want.input_name, want.input_shape, want.output_name)
    assert got.weights.keys() == want.weights.keys()
    for k, v in want.weights.items():
        assert got.weights[k].dtype == v.dtype
        np.testing.assert_array_equal(got.weights[k], v)
    x = np.random.default_rng(3).standard_normal((1, kw["seq"], kw["embed"]))
    np.testing.assert_allclose(TL.run_plain(got, x), L.run_plain(want, x),
                               rtol=0, atol=1e-12)
    assert TL.EMBED // TL.N_HEADS == TL.HEAD_DIM == L.HEAD_DIM == 128


@pytest.mark.parametrize("seq, d", [(SEQ, D), (8, 128), (128, 128)])
def test_attention_plain_equal(seq, d):
    w, x, _ = chip_smoke.attention_data(seq, d)
    got = TLF.attention_plain(x, w, seq, d)
    np.testing.assert_allclose(got, LF.attention_plain(x, w, seq, d),
                               rtol=0, atol=1e-12)
    if d == D:  # one head of the graph: the oracle equals its executor
        g = TL.build_attention_block(seq=seq, embed=d, n_heads=1, n_rep=1)
        x = np.random.default_rng(3).standard_normal((1, seq, d))
        want = np.asarray(TL.run_plain(g, x)).reshape(seq, d)
        assert np.max(np.abs(TLF.attention_plain(x[0], g.weights, seq, d)
                             - want)) < 1e-9


# -- the block's helpers, bit for bit --------------------------------------

@pytest.fixture(scope="module")
def ctx():
    kw = dict(degree=2 * SEQ * D, num_q=4, first_mod_size=60,
              scaling_mod_size=50)
    params = CkksParams(**kw)
    enc = Encoder(params)
    kg = KeyGenerator(params, np.random.default_rng(23))
    return enc, kg, Evaluator(params, kg, enc), TParams(**kw, device="cpu")


HELPERS = {
    "_matmul_plain_w": lambda lf, ev, enc, ct, w: lf._matmul_plain_w(
        ev, enc, ct, w["wq"], SEQ, D),
    "_rope": lambda lf, ev, enc, ct, w: lf._rope(ev, enc, ct, SEQ, D),
    "_bcast_rows": lambda lf, ev, enc, ct, w: lf._bcast_rows(
        ev, lf._mask(ev, enc, ct, np.repeat(np.eye(SEQ)[1], D)), D, SEQ * D),
    "_bcast_cols": lambda lf, ev, enc, ct, w: lf._bcast_cols(
        ev, lf._mask(ev, enc, ct, np.tile(np.eye(D)[0], SEQ)), D),
}


@pytest.mark.parametrize("name", list(HELPERS))
def test_helper_bit_exact(ctx, name):
    enc, kg, ev, tparams = ctx
    rng = np.random.default_rng(31 + list(HELPERS).index(name))
    w = _weights(rng)
    x = rng.standard_normal(SEQ * D) * 0.8
    ct = ev.encrypt(enc.encode(x.astype(np.complex128)))
    want = HELPERS[name](LF, ev, enc, ct, w)
    tenc = TEncoder(tparams)
    tev = TEvaluator(tparams, port_keygen(tparams, kg,
                                          rng=np.random.default_rng(5)), tenc)
    got = HELPERS[name](TLF, tev, tenc, port_ct(ct), w)
    assert_ct_equal(got, want)


# -- the whole block --------------------------------------------------------

def _block_inputs():
    """tests/test_llama_fhe.py's data (default_rng(11), weights scaled by
    0.35 at D = 8) and its certified ranges."""
    return chip_smoke.attention_data(SEQ, D, seed=11)


# the output level ace_tpu reaches on tests/test_llama_fhe.py's data
# (test_encrypted_attention_bit_exact holds the two levels equal)
ACE_TPU_OUT_LEVEL = 8


def test_encrypted_attention_port():
    """The port alone, tests/test_llama_fhe.py's setting and bound."""
    params = TParams(**BLOCK_KW, device="cpu")
    enc = TEncoder(params)
    ev = TEvaluator(params, TKeyGenerator(params, np.random.default_rng(7)),
                    enc)
    w, x, ranges = _block_inputs()
    ct = ev.encrypt(enc.encode(x.reshape(-1).astype(np.complex128)))
    out = TLF.encrypted_attention(ev, enc, ct, w, SEQ, D, **ranges)
    got = enc.decode(ev.decrypt(out)).real[:SEQ * D].reshape(SEQ, D)
    want = TLF.attention_plain(x, w, SEQ, D)
    assert np.all(np.isfinite(got))
    assert np.max(np.abs(got - want)) < 2e-2, (got[0], want[0])
    assert out.level == ACE_TPU_OUT_LEVEL


@pytest.mark.slow
def test_encrypted_attention_bit_exact():
    """The whole block, port against ace_tpu residue for residue (ace_tpu
    first, so that its key generator holds every rotation key)."""
    params = CkksParams(**BLOCK_KW)
    enc = Encoder(params)
    kg = KeyGenerator(params, np.random.default_rng(7))
    ev = Evaluator(params, kg, enc)
    w, x, ranges = _block_inputs()
    ct = ev.encrypt(enc.encode(x.reshape(-1).astype(np.complex128)))
    want = LF.encrypted_attention(ev, enc, ct, w, SEQ, D, **ranges)
    tparams = TParams(**BLOCK_KW, device="cpu")
    tenc = TEncoder(tparams)
    tev = TEvaluator(tparams, port_keygen(tparams, kg,
                                          rng=np.random.default_rng(5)), tenc)
    got = TLF.encrypted_attention(tev, tenc, port_ct(ct), w, SEQ, D,
                                  **ranges)
    assert_ct_equal(got, want)
    assert got.level == ACE_TPU_OUT_LEVEL


# -- the ValueErrors --------------------------------------------------------

class _StubCt:
    level = 50


class _StubEv:
    """Every evaluator method returns its first ciphertext: the block's
    control flow runs to its checks without any arithmetic."""

    def __init__(self, degree):
        self.params = types.SimpleNamespace(degree=degree)

    def __getattr__(self, name):
        return lambda ct, *a, **k: ct


class _StubEnc:
    def encode_cached(self, *a, **k):
        return None


ERRORS = {  # name -> (seq, d, degree, keyword arguments, message)
    "seq_over_d": (16, 8, 256, {}, "requires seq <= d"),
    "not_fully_packed": (4, 8, 128, {}, r"requires seq\*d == N/2"),
    "den_range_order": (SEQ, D, 64, {"den_range": (5.0, 1.0)},
                        "den_range must satisfy"),
    "too_many_iterations": (SEQ, D, 64, {"den_range": (1e-6, 1e3)},
                            "Goldschmidt iterations"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_value_errors_equal(monkeypatch, name):
    """The same ValueError, message for message, in both packages; the
    Chebyshev evaluations are stubbed with the evaluator."""
    seq, d, degree, kw, match = ERRORS[name]
    for nl in (NL, TNL):
        monkeypatch.setattr(nl, "eval_fn", lambda ev, ct, *a, **k: ct)
    w = _weights(np.random.default_rng(1), d)
    msgs = []
    for lf in (LF, TLF):
        with pytest.raises(ValueError, match=match) as exc:
            lf.encrypted_attention(_StubEv(degree), _StubEnc(), _StubCt(),
                                   w, seq, d, **kw)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("seq, degree", [(16, 256), (4, 128)])
def test_packing_errors_on_the_port(seq, degree):
    """The packing checks come first, on the port's own evaluator."""
    params = TParams(degree=degree, num_q=3, first_mod_size=60,
                     scaling_mod_size=50, device="cpu")
    enc = TEncoder(params)
    ev = TEvaluator(params, TKeyGenerator(params, np.random.default_rng(2)),
                    enc)
    ct = ev.encrypt(enc.encode(np.zeros(4, np.complex128)))
    with pytest.raises(ValueError, match="encrypted_attention requires"):
        TLF.encrypted_attention(ev, enc, ct, _weights(np.random.default_rng(1)),
                                seq, D)


# -- chip_smoke.py phase 8 on the CPU ---------------------------------------

def test_chip_smoke_attention_on_cpu():
    """The phase's logic and gates at SEQ = 4, D = 8 on the 50-prime chain:
    kernels and ops checked at the chain's shapes (plain against plain
    here), the block's counts, stages and output, one projection profiled.
    main(), not the phase, fails when a kernel did not launch."""
    res = chip_smoke.phase_attention(device="cpu", seq=SEQ, d=D, num_q=50)
    assert res["max_err"] < chip_smoke.ATTN_TOL
    assert res["max_err"] < 1e-6
    assert (res["rotations"], res["mul_plain"], res["keys"]) == (104, 71, 15)
    assert res["level_in"] == 50 and 0 < res["level_out"] < 50
    assert res["launches"] == {"K1": 0, "K2": 0, "K3": 0, "K4": 0,
                               "K5": 0, "K6": 0}
    assert res["peak_gib"] is None and res["projection_s"] > 0


def test_phase_attention_needs_the_card_by_default():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        chip_smoke.phase_attention(seq=SEQ, d=D, num_q=3)
