"""PyTorch port: op programs under the meshes (utils/liftgraph.py split at
the collectives of parallel/mesh.py) on 2 x 2 gloo worlds of spawned CPU
ranks, with ace_tpu's keys and ciphertexts injected, at the small ring of
tests/test_torch_spmd_eval.py (degree 1024, 6 q primes, 2 digits):

- the digit x slot mesh: SpmdEvaluator's rotate, mul, relinearize and
  the conv slice, each called three times on three ciphertexts, bit for
  bit against ace_tpu's Evaluator; each SpmdKeySwitch caches the
  programs "rot" and "relin", ace_tpu's keys
  (ace_tpu/parallel/spmd.py:319-345);
- the dp x limb mesh: the limb-sharded Evaluator's rotate, mul, rescale
  and rot_ext_mac_groups, each three times, bit for bit, under
  ace_tpu's program keys for the same ops;
- the collective schedule: the same on every rank and at every call,
  and a program whose schedule changes raises;
- rank drift: one rank's program dropped and rebuilt while the others
  replay theirs, and the world still completes bit-exact;
- the counters: `switches` and the mesh's `collectives` count every
  call.

On the CPU a program runs its function at every call, its collectives
checked against call 1's schedule; tests/test_torch_graphs.py captures
and replays them on the card."""

import numpy as np
import pytest

from ace_tpu.ckks.params import CkksParams
from ace_tpu.compiler.packing import FheBackend
from ace_tpu.runtime.context import FheContext
from ace_tpu_torch.parallel.mesh import (DIGIT_SLOT, DP_LIMB,
                                         file_rendezvous, run_world)

from tests import torch_mesh_program_worker as W
from tests.torch_port_util import arr, key_arrays, one_thread
from tests.torch_spmd_worker import conv_slice

KW = dict(degree=1 << 10, num_q=6, first_mod_size=60, scaling_mod_size=56,
          hamming_weight=16, num_q_parts=2)
SEED = 13
N = KW["degree"] // 2
CALLS = 3


@pytest.fixture(scope="module")
def ace(tmp_path_factory):
    """ace_tpu's side: three ciphertexts, each op's result on each, the
    program keys the limb ops make (run first, on a fresh cache), and the
    case the ranks take (the keys after every op)."""
    ctx = FheContext(CkksParams(**KW), seed=SEED)
    ev, enc = ctx.evaluator, ctx.encoder
    rng = np.random.default_rng(5)
    cts = [ctx.prepare_input(rng.uniform(-1, 1, N), f"x{i}")
           for i in range(CALLS)]
    be = FheBackend(ev, enc)
    w = np.ones(N)
    limb = {"rotate": [ev.rotate(c, 3) for c in cts],
            "mul": [ev.mul(c, c) for c in cts],
            "rescale": [ev.rescale(ev.mul(c, c)) for c in cts],
            "mac": [be._norm(be.rot_ext_mac_groups(
                c, W.MAC_ROTS, [[w, w, None]])[0]) for c in cts]}
    limb_keys = set(ev._jit_cache)
    digit = {"rotate": [ev.rotate(c, 3) for c in cts],
             "mul": [ev.mul(c, c) for c in cts],
             "relinearize": [ev.relinearize(ev.mul3(c, c)) for c in cts],
             "conv": [conv_slice(ev, enc, c, N) for c in cts]}
    case = {"params": KW, "keys": key_arrays(ctx.keygen),
            "cts": [(arr(c.c0), arr(c.c1)) for c in cts],
            "meta": (cts[0].scaling_factor, cts[0].sf_degree, cts[0].slots)}
    return {"limb": limb, "limb_keys": limb_keys, "digit": digit,
            "case": case}


def _world(tmp_path_factory, axes, calls):
    with file_rendezvous(str(tmp_path_factory.mktemp("rdv"))) as rdv, \
            one_thread():
        return run_world(W.jobs, 2, 2, "gloo", "cpu", rdv, (calls,),
                         axes=axes)


@pytest.fixture(scope="module")
def digit(ace, tmp_path_factory):
    return _world(tmp_path_factory, DIGIT_SLOT,
                  [("digit_programs", (ace["case"],)),
                   ("schedule_guards", ())])


@pytest.fixture(scope="module")
def limb(ace, tmp_path_factory):
    return [r[0] for r in _world(tmp_path_factory, DP_LIMB,
                                 [("limb_programs", (ace["case"],))])]


def _equal(got, want):
    np.testing.assert_array_equal(got[0], arr(want.c0))
    np.testing.assert_array_equal(got[1], arr(want.c1))


@pytest.mark.parametrize("op", ["rotate", "mul", "relinearize", "conv"])
def test_digit_mesh_every_call_bit_exact(ace, digit, op):
    """Each call of the op on the 2 x 2 digit x slot mesh (its programs'
    calls 1, 2 and 3, and later ones) equals ace_tpu's single-device
    result on the same ciphertext, on every rank."""
    for rank, _ in digit:
        for got, want in zip(rank["ops"][op], ace["digit"][op]):
            _equal(got["out"], want)


def test_digit_mesh_program_keys_and_switches(digit):
    """Each SpmdKeySwitch (the top level and the conv slice's square one
    level down) caches exactly ace_tpu's keys "rot" and "relin"; the
    switches count every call: 3 x (rotate, mul, relinearize, and the
    conv slice's two rotations and its square)."""
    for rank, _ in digit:
        assert rank["keys"] == {6: ["relin", "rot"], 5: ["relin"]}
        assert rank["switches"] == CALLS * 6 + 1  # + the drift rotate
        # 2 all_to_all for each of the six sharded NTTs, the digit sum
        # and the slot gather: 14 collectives, 15 segments
        assert rank["segments"]["spmd rot"] == [15]
        assert rank["segments"]["spmd relin"] == [15, 15]


def test_digit_mesh_schedule_same_on_every_rank_and_call(digit):
    """The programs' schedules are equal on every rank; each call of an
    op ran the same collectives (method, axis, source, shape) in the same
    order, and as many as the mesh's `collectives` counted."""
    ranks = [r for r, _ in digit]
    assert all(r["schedules"] == ranks[0]["schedules"] for r in ranks)
    sched = ranks[0]["schedules"][6]
    rot = [tuple(e) for e in sched["rot"]]
    # the digit's iNTT and NTT (4 all_to_all), the digit sum, the two
    # mod-downs' iNTTs and NTTs (8), the slot gather
    assert [e[:2] for e in rot] == [("all_to_all", "slot")] * 4 + [
        ("all_reduce", "digit")] + [("all_to_all", "slot")] * 8 + [
        ("all_gather", "slot")]
    for r in ranks:
        ran = r["ran"]
        for op in ("rotate", "mul", "relinearize", "conv"):
            calls = [ran[(op, i)] for i in range(CALLS)]
            assert all(c == calls[0] for c in calls)
            assert [x["collectives"] for x in r["ops"][op]] == \
                [len(calls[0])] * CALLS
        assert ran[("rotate", 0)] == rot == ran["drift"]


def test_digit_mesh_rank_drift(ace, digit):
    """Rank 0 dropped its "rot" program after the three calls and rebuilt
    it (call 1 again, eager) while ranks 1-3 replayed theirs (call 10):
    the collectives still paired up and every rank's rotate is
    bit-exact."""
    for i, (rank, _) in enumerate(digit):
        _equal(rank["drift"], ace["digit"]["rotate"][0])
        before, after = rank["drift_calls"]
        assert before == 9 and after == (1 if i == 0 else 10)


@pytest.mark.parametrize("guard", ["method", "fewer", "more",
                                   "sum_over_world", "nested"])
def test_schedule_guards_raise(digit, guard):
    """A call whose collectives differ from call 1's (another method, one
    fewer, one more) raises on every rank, as do sum_over_world and a
    program called inside a program; the world then goes on (the next
    guard's collectives pair up)."""
    for _, errors in digit:
        assert guard in errors
    assert "call 1" in digit[0][1]["method"]


@pytest.mark.parametrize("op", ["rotate", "mul", "rescale", "mac"])
def test_limb_mesh_every_call_bit_exact(ace, limb, op):
    """Each call on the 2 x 2 dp x limb mesh, gathered, equals ace_tpu's
    unsharded result on the same ciphertext, on every rank."""
    for rank in limb:
        for got, want in zip(rank["ops"][op], ace["limb"][op]):
            _equal(got["out"], want)


def test_limb_mesh_program_keys_equal_ace_tpus(ace, limb):
    """The limb-sharded evaluator caches ace_tpu's program keys for the
    same ops, with the rotate program rebuilt on rank 0 after the
    drift."""
    for rank in limb:
        assert set(rank["keys"]) == ace["limb_keys"]


def test_limb_mesh_schedule_and_counts(limb):
    """Every rank holds the same schedules; each call of an op ran the
    same collectives as its first and as many as `collectives` counted;
    calls 2 and 3 made no new device constant (on the card a capture
    forbids the host-to-device copy)."""
    assert all(r["schedules"] == limb[0]["schedules"] for r in limb)
    for r in limb:
        ran = r["ran"]
        for op in ("rotate", "mul", "rescale", "mac"):
            calls = [ran[(op, i)] for i in range(CALLS)]
            assert calls[0] and all(c == calls[0] for c in calls)
            assert [x["collectives"] for x in r["ops"][op]] == \
                [len(calls[0])] * CALLS
        assert r["new_consts"][1::CALLS] == [0] * 4
        assert r["new_consts"][2::CALLS] == [0] * 4
        assert ran[("rotate", 0)] == ran["drift"]
    rot = [s for k, s in limb[0]["schedules"].items() if "'rot'" in k][0]
    # the rotate: one gather for each of the two digits' mod-up and one
    # for each mod-down's P limbs
    assert [e[0] for e in rot] == ["all_gather"] * 4
    assert all(r["segments"]["rs"] == [3] for r in limb)  # two broadcasts


def test_limb_mesh_rank_drift(ace, limb):
    """Rank 0 rebuilt its rotate program (call 1) while the others replayed
    theirs (call 4): every rank's rotate is bit-exact."""
    for i, rank in enumerate(limb):
        _equal(rank["drift"], ace["limb"]["rotate"][0])
        before, after = rank["drift_calls"]
        assert before == CALLS and after == (1 if i == 0 else CALLS + 1)
