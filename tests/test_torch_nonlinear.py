"""PyTorch port: ckks/nonlinear.py (exp, Goldschmidt reciprocal, rsqrt and
the slot-block reductions and broadcasts) bit for bit against ace_tpu on
the CPU, in tests/test_nonlinear.py's context (degree 64, 24 q primes),
with ace_tpu's keys and input ciphertext injected. ace_tpu runs each case
first, so its key generator holds every rotation key the case makes on
demand; the port's key generator is then built from it."""

import numpy as np
import pytest

from ace_tpu.ckks import nonlinear as NL
from ace_tpu.ckks.encoder import Encoder
from ace_tpu.ckks.evaluator import Evaluator
from ace_tpu.ckks.keygen import KeyGenerator
from ace_tpu.ckks.params import CkksParams
from ace_tpu_torch.ckks import nonlinear as TNL
from ace_tpu_torch.ckks.encoder import Encoder as TEncoder
from ace_tpu_torch.ckks.evaluator import Evaluator as TEvaluator
from ace_tpu_torch.ckks.params import CkksParams as TParams

from tests.torch_port_util import assert_ct_equal, port_ct, port_keygen

KW = dict(degree=64, num_q=24, first_mod_size=60, scaling_mod_size=50)
BLOCK, TOTAL = 8, 32


@pytest.fixture(scope="module")
def ctx():
    params = CkksParams(**KW)
    enc = Encoder(params)
    kg = KeyGenerator(params, np.random.default_rng(41))
    return enc, kg, Evaluator(params, kg, enc), TParams(**KW, device="cpu")


# name -> (slot values of the input, function of (NL, ev, enc, ct))
CASES = {
    "exp": ((-1.0, 1.0),
            lambda nl, ev, enc, ct: nl.exp(ev, ct, -1.0, 1.0, degree=7)),
    "reciprocal_iters1": ((0.4, 8.0),
                          lambda nl, ev, enc, ct: nl.reciprocal(
                              ev, ct, 8.0, iters=1)),
    "reciprocal_iters2": ((0.4, 8.0),
                          lambda nl, ev, enc, ct: nl.reciprocal(
                              ev, ct, 8.0, iters=2)),
    "rsqrt": ((0.3, 4.0),
              lambda nl, ev, enc, ct: nl.rsqrt(ev, ct, 0.3, 4.0, degree=7,
                                               newton_iters=1)),
    "block_sum": ((-1.0, 1.0),
                  lambda nl, ev, enc, ct: nl.block_sum(ev, ct, BLOCK)),
    "broadcast_first": ((-1.0, 1.0),
                        lambda nl, ev, enc, ct: nl.broadcast_first(
                            ev, ct, BLOCK, TOTAL, enc)),
    "broadcast_first_mask_scale": (
        (-1.0, 1.0),
        lambda nl, ev, enc, ct: nl.broadcast_first(
            ev, ct, BLOCK, TOTAL, enc,
            mask_scale=np.linspace(0.5, 2.0, TOTAL // BLOCK))),
    "block_sum_replicated": ((-1.0, 1.0),
                             lambda nl, ev, enc, ct: nl.block_sum_replicated(
                                 ev, ct, BLOCK, TOTAL, enc,
                                 mask_scale=1.0 / BLOCK)),
    "mask_mul": ((-1.0, 1.0),
                 lambda nl, ev, enc, ct: nl.mask_mul(
                     ev, ct, np.tile([1.0, 0.0, 0.5, -2.0], TOTAL // 4), enc)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_nonlinear_bit_exact(ctx, name):
    enc, kg, ev, tparams = ctx
    (lo, hi), fn = CASES[name]
    rng = np.random.default_rng(9 + list(CASES).index(name))
    x = rng.uniform(lo, hi, TOTAL)
    ct = ev.encrypt(enc.encode(x.astype(np.complex128)))
    want = fn(NL, ev, enc, ct)
    tenc = TEncoder(tparams)
    tev = TEvaluator(tparams, port_keygen(tparams, kg,
                                          rng=np.random.default_rng(5)), tenc)
    got = fn(TNL, tev, tenc, port_ct(ct))
    assert_ct_equal(got, want)


@pytest.mark.parametrize("fn, a, b, degree", [
    (np.exp, -5.0, 0.5, 27), (lambda v: 1.0 / np.sqrt(v), 0.3, 4.0, 29),
    (np.tanh, -2.0, 2.0, 7)])
def test_chebyshev_coeffs_equal(fn, a, b, degree):
    """Same floats, the constant term doubled in both."""
    got = TNL.chebyshev_coeffs(fn, a, b, degree)
    assert got == NL.chebyshev_coeffs(fn, a, b, degree)
    assert len(got) == degree + 1


def test_reciprocal_needs_one_iteration(ctx):
    enc, kg, ev, tparams = ctx
    tenc = TEncoder(tparams)
    tev = TEvaluator(tparams, port_keygen(tparams, kg,
                                          rng=np.random.default_rng(5)), tenc)
    ct = tev.encrypt(tenc.encode(np.full(TOTAL, 0.5, np.complex128)))
    with pytest.raises(ValueError, match="iters >= 1"):
        TNL.reciprocal(tev, ct, 8.0, iters=0)
