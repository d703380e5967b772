"""PyTorch port: SpmdEvaluator (ace_tpu_torch/parallel/spmd_eval.py) on a
2 x 2 gloo world of spawned CPU ranks, with ace_tpu's keys and
ciphertexts injected: tests/test_spmd_eval.py's three cases (rotate, mul
and relinearize; the conv slice with a square; the fallback below the
digit count) bit for bit against ace_tpu's single-device Evaluator, and
the key-residency report equal to ace_tpu's SpmdEvaluator's for the
same keys at the same levels."""

import numpy as np
import pytest

from ace_tpu.ckks.params import CkksParams
from ace_tpu.parallel.spmd import make_digit_slot_mesh
from ace_tpu.runtime.context import FheContext
from ace_tpu_torch.parallel.mesh import file_rendezvous, run_world

from tests import torch_spmd_worker as W
from tests.torch_port_util import arr, key_arrays, one_thread

KW = dict(degree=1 << 10, num_q=6, first_mod_size=60, scaling_mod_size=56,
          hamming_weight=16, num_q_parts=2)
SEED = 11
N = KW["degree"] // 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ctx = FheContext(CkksParams(**KW), seed=SEED)
    ev, enc = ctx.evaluator, ctx.encoder
    ct = ctx.prepare_input(np.random.default_rng(0).uniform(-1, 1, N), "x")
    low = ctx.prepare_input(np.linspace(-0.5, 0.5, N), "low", level=2)
    want = {"rotate": ev.rotate(ct, 3), "mul": ev.mul(ct, ct),
            "relinearize": ev.relinearize(ev.mul3(ct, ct)),
            "conv": W.conv_slice(ev, enc, ct, N),
            "low_rotate": ev.rotate(low, 1)}
    case = {"params": KW, "keys": key_arrays(ctx.keygen), "digits": 2,
            "slots": 2, "ct": (arr(ct.c0), arr(ct.c1)),
            "meta": (ct.scaling_factor, ct.sf_degree, ct.slots),
            "ct_low": (arr(low.c0), arr(low.c1)),
            "meta_low": (low.scaling_factor, low.sf_degree, low.slots)}
    with file_rendezvous(str(tmp_path_factory.mktemp("rdv"))) as rdv, \
            one_thread():
        ranks = run_world(W.jobs, 2, 2, "gloo", "cpu", rdv,
                          ([("spmd_evaluator", (case,))],))
    return {"ctx": ctx, "ct": ct, "want": want,
            "ranks": [r[0] for r in ranks]}


@pytest.mark.parametrize("op", ["rotate", "mul", "relinearize"])
def test_rotate_mul_relinearize_bit_exact(world, op):
    want = world["want"][op]
    for rank in world["ranks"]:
        np.testing.assert_array_equal(rank[op][0], arr(want.c0))
        np.testing.assert_array_equal(rank[op][1], arr(want.c1))


def test_conv_slice_bit_exact_and_decodes(world):
    want = world["want"]["conv"]
    for rank in world["ranks"]:
        np.testing.assert_array_equal(rank["conv"][0], arr(want.c0))
        np.testing.assert_array_equal(rank["conv"][1], arr(want.c1))
        # every key switch went through SpmdKeySwitch: rotate, mul and
        # relinearize, then the conv slice's two rotations and its
        # square one level down
        assert rank["switches"] == 6
    ctx = world["ctx"]
    ctx.set_output_data("y", want)
    img = np.random.default_rng(0).uniform(-1, 1, N)
    plain = (img * 0.25 + np.roll(img, -1) * -0.5
             + np.roll(img, -2) * 0.125) ** 2
    assert np.allclose(ctx.handle_output("y", N), plain, atol=1e-2)


def test_falls_back_below_digit_count(world):
    want = world["want"]["low_rotate"]
    for rank in world["ranks"]:
        assert rank["low_is_fallback"]
        np.testing.assert_array_equal(rank["low_rotate"][0], arr(want.c0))
        np.testing.assert_array_equal(rank["low_rotate"][1], arr(want.c1))


def test_key_residency_report_equals_ace_tpu(world):
    """ace_tpu's SpmdEvaluator on a 2 x 2 virtual mesh, holding the keys
    the ranks used at the levels they used them (level 6: rotations 3,
    1, 2 and the relinearization key; level 5: the relinearization key
    of the conv slice's square), reports the same bytes per device."""
    ctx = FheContext(CkksParams(**KW), seed=SEED,
                     digit_mesh=make_digit_slot_mesh(2, 2))
    ev = ctx.evaluator
    for level, rots in ((6, (3, 1, 2)), (5, ())):
        ksw = ev._ksw(level)
        ksw._key_stack(ctx.keygen.relin_key)
        for r in rots:
            ksw._key_stack(ctx.keygen.rot_key(r)[1])
    for rank in world["ranks"]:
        assert rank["report"] == ev.key_residency_report()
