"""PyTorch port: the scalar encoders (Encoder.encode_value and
encode_value_with_scale) and SwitchKey.nbytes, bit for bit against
ace_tpu at degree 64."""

import numpy as np
import pytest

from ace_tpu.ckks.encoder import Encoder
from ace_tpu.ckks.keygen import KeyGenerator, switch_key_nbytes
from ace_tpu.ckks.params import CkksParams
from ace_tpu_torch.ckks.encoder import Encoder as TEncoder
from ace_tpu_torch.ckks.keygen import (KeyGenerator as TKeyGenerator,
                                       switch_key_nbytes as t_nbytes)
from ace_tpu_torch.ckks.params import CkksParams as TParams

from tests.torch_port_util import assert_poly_equal, port_keygen

KW = dict(degree=64, num_q=5, first_mod_size=40, scaling_mod_size=30,
          num_q_parts=2)


@pytest.fixture(scope="module")
def pair():
    params = CkksParams(**KW)
    tparams = TParams(**KW, device="cpu")
    return params, tparams, Encoder(params), TEncoder(tparams)


@pytest.mark.parametrize("value,level,sf", [(0.75, 5, 1), (-1.3125, 3, 1),
                                            (0.75, 5, 2), (2.5, 3, 2)])
def test_encode_value_matches(pair, value, level, sf):
    _, _, enc, tenc = pair
    want = enc.encode_value(value, level, sf)
    got = tenc.encode_value(value, level, sf)
    assert_poly_equal(got.poly, want.poly)
    assert (got.scaling_factor, got.sf_degree, got.slots) == \
        (want.scaling_factor, want.sf_degree, want.slots)
    # the value cache hands back the same object
    assert tenc.encode_value(value, level, sf) is got
    assert tenc.encode_value(value, level, sf + 1) is not got


@pytest.mark.parametrize("value,level,scale", [(0.5, 5, 2.0 ** 30),
                                               (-3.25, 2, 2.0 ** 37 + 5)])
def test_encode_value_with_scale_matches(pair, value, level, scale):
    _, _, enc, tenc = pair
    want = enc.encode_value_with_scale(value, level, scale)
    got = tenc.encode_value_with_scale(value, level, scale)
    assert_poly_equal(got.poly, want.poly)
    assert (got.scaling_factor, got.sf_degree, got.slots) == \
        (want.scaling_factor, want.sf_degree, want.slots)


def test_switch_key_nbytes_matches(pair):
    params, tparams, _, _ = pair
    kg = KeyGenerator(params, np.random.default_rng(3))
    kg.rot_key(1)
    injected = port_keygen(tparams, kg)
    own = TKeyGenerator(tparams, np.random.default_rng(4))
    want = kg.relin_key.nbytes
    assert want == switch_key_nbytes(params) == t_nbytes(tparams)
    assert injected.relin_key.nbytes == want
    assert own.relin_key.nbytes == want
    assert injected.rot_key(1)[1].nbytes == kg.rot_key(1)[1].nbytes == want
