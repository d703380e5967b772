"""PyTorch port: the evaluator's off-path methods (negate, sub_plain,
upscale, downscale, to_ext, switch_key_precompute, rotate_ext,
mod_down_ciph, rot_ext_mac_groups_jit), bit for bit against ace_tpu with
ace_tpu's keys, ciphertexts and plaintexts injected (tests/
torch_port_util.py), at degree 32 over a 5-prime chain."""

import numpy as np
import pytest

from ace_tpu.ckks.encoder import Encoder
from ace_tpu.ckks.evaluator import Evaluator
from ace_tpu.ckks.keygen import KeyGenerator
from ace_tpu.ckks.params import CkksParams
from ace_tpu_torch import interop
from ace_tpu_torch.ckks.encoder import Encoder as TEncoder
from ace_tpu_torch.ckks.evaluator import Evaluator as TEvaluator
from ace_tpu_torch.ckks.params import CkksParams as TParams

from tests.torch_port_util import (CPU, arr, assert_ct_equal,
                                   assert_poly_equal, port_ct, port_keygen)

ROTS = [1, 2, 3, 5, -1, 4, 6]   # more than max_bundle (5)
N_SLOTS = 16


@pytest.fixture(scope="module")
def pair():
    kw = dict(degree=32, num_q=5, first_mod_size=33, scaling_mod_size=30)
    params = CkksParams(**kw)
    kg = KeyGenerator(params, np.random.default_rng(17))
    for r in ROTS:
        kg.rot_key(r)
    ev = Evaluator(params, kg, Encoder(params))
    tparams = TParams(**kw, device="cpu")
    tkg = port_keygen(tparams, kg, rng=np.random.default_rng(3))
    return ev, TEvaluator(tparams, tkg, TEncoder(tparams))


def _msg(rng):
    return rng.uniform(-1, 1, N_SLOTS) + 1j * rng.uniform(-1, 1, N_SLOTS)


def _port_pt(pt):
    return interop.plaintext(arr(pt.poly), pt.scaling_factor, pt.sf_degree,
                             pt.slots, CPU, num_p=pt.poly.num_p)


def _groups(ev, level, rng):
    """Three groups over ROTS: one dense, one with gaps, one dead."""
    def pt():
        return ev.encoder.encode(_msg(rng), level=level, extended=True)
    dense = [pt() for _ in ROTS]
    gaps = [pt() if i % 3 else None for i in range(len(ROTS))]
    return [dense, gaps, [None] * len(ROTS)]


def _case(name, ev, ct, rng):
    """(ace_tpu function, port function) of one ciphertext each."""
    if name == "negate":
        return (lambda e, c: e.negate(c),) * 2
    if name == "sub_plain":
        pt = ev.encoder.encode(_msg(rng), level=ct.level)
        tpt = _port_pt(pt)
        return (lambda e, c: e.sub_plain(c, pt),
                lambda e, c: e.sub_plain(c, tpt))
    if name == "upscale":
        return (lambda e, c: e.upscale(c, 16),) * 2
    if name == "downscale":
        return (lambda e, c: e.downscale(c, 24),) * 2
    if name == "to_ext":
        return (lambda e, c: e.to_ext(c),) * 2
    if name == "switch_key_precompute":
        return (lambda e, c: e.switch_key_precompute(c.c1),) * 2
    if name == "rotate_ext":
        return (lambda e, c: [e.rotate_ext(c, 3),
                              e.rotate_ext(c, -1, add_first=False)],) * 2
    if name == "rotate_ext_shared_digits":
        def f(e, c):
            digits = e.switch_key_precompute(c.c1)
            return [e.rotate_ext(c, r, digits) for r in (1, 2, 5)]
        return (f, f)
    if name == "mod_down_ciph":
        return (lambda e, c: e.mod_down_ciph(e.rotate_ext(c, 2)),) * 2
    if name == "rot_ext_mac_groups_jit":
        groups = _groups(ev, ct.level, rng)
        tgroups = [[None if p is None else _port_pt(p) for p in grp]
                   for grp in groups]
        rots = [0] + ROTS[:-1]
        return (lambda e, c: e.rot_ext_mac_groups_jit(c, rots, groups),
                lambda e, c: e.rot_ext_mac_groups_jit(c, rots, tgroups))
    raise KeyError(name)


def _assert_equal(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
    elif hasattr(want, "c0"):
        assert got.slots == want.slots
        assert_ct_equal(got, want)
    else:
        assert_poly_equal(got, want)


@pytest.mark.parametrize("name", [
    "negate", "sub_plain", "upscale", "downscale", "to_ext",
    "switch_key_precompute", "rotate_ext", "rotate_ext_shared_digits",
    "mod_down_ciph", "rot_ext_mac_groups_jit"])
def test_off_path_method_matches(pair, name):
    ev, tev = pair
    rng = np.random.default_rng(sum(map(ord, name)))
    ct = ev.encrypt(ev.encoder.encode(_msg(rng), level=4))
    f, tf = _case(name, ev, ct, rng)
    _assert_equal(tf(tev, port_ct(ct)), f(ev, ct))


def test_rot_ext_mac_groups_refuses_empty(pair):
    _, tev = pair
    ct = port_ct(pair[0].encrypt(pair[0].encoder.encode(
        _msg(np.random.default_rng(0)))))
    for groups in ([], [[None, None]]):
        with pytest.raises(ValueError, match="non-None"):
            tev.rot_ext_mac_groups_jit(ct, [1, 2], groups)
