"""PyTorch port: SpmdKeySwitch (ace_tpu_torch/parallel/spmd.py) on a
gloo world of spawned CPU ranks, with ace_tpu's keys and ciphertexts
injected, bit for bit against ace_tpu's Evaluator at
tests/test_spmd_ksw.py's cases (2 digits x 2 slots here), the short last
digit, a 4-digit case and a 1-digit x 4-slot case; against ace_tpu's own SpmdKeySwitch on
conftest's 8-device virtual mesh where ACE_SPMD says. Also the window
constants and the digit sum past 2^63.

One 4-rank world serves the file (module fixture); the ranks run
tests/torch_spmd_worker.py and exchange numpy arrays with the parent."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ace_tpu.ckks.params import CkksParams
from ace_tpu.parallel.spmd import SpmdKeySwitch, make_digit_slot_mesh
from ace_tpu.runtime.context import FheContext
from ace_tpu_torch.ckks.params import CkksParams as TCkksParams
from ace_tpu_torch.ops import modops as TM
from ace_tpu_torch.parallel import spmd as TS
from ace_tpu_torch.parallel.mesh import file_rendezvous, run_world

from tests import torch_spmd_worker as W
from tests.torch_port_util import arr, key_arrays, one_thread

# (degree, num_q, parts, slots, seed, rotation, mod_switches)
CASES = {
    "1024-6-2x2": (1 << 10, 6, 2, 2, 11, 5, 0),
    "4096-8-2x2": (1 << 12, 8, 2, 2, 11, 5, 0),
    "short-last-digit": (1 << 10, 7, 2, 2, 12, 3, 1),
    "4-digits": (1 << 10, 8, 4, 1, 11, 5, 0),
    "1-digit-4-slots": (1 << 10, 6, 2, 4, 11, 5, 3),
}
# ace_tpu's SpmdKeySwitch compiles its shard_map body per op (9-14 s
# each here): it runs at the case its own tests lack; every case is held
# against ace_tpu's Evaluator, which tests/test_spmd_ksw.py and
# tests/test_spmd_eval.py hold equal to its SpmdKeySwitch.
ACE_SPMD = ("4-digits",)


def _params(degree, num_q, parts):
    return dict(degree=degree, num_q=num_q, first_mod_size=60,
                scaling_mod_size=56, hamming_weight=16, num_q_parts=parts)


def _case(degree, num_q, parts, slots, seed, rotation, switches):
    """ace_tpu's side of one case: its ciphertext, 3-term product, keys
    and single-device results, and the worker's inputs."""
    kw = _params(degree, num_q, parts)
    ctx = FheContext(CkksParams(**kw), seed=seed)
    ct = ctx.prepare_input(np.linspace(-1, 1, degree // 2), "x")
    for _ in range(switches):
        ct = ctx.evaluator.mod_switch(ct)
    ev = ctx.evaluator
    c3 = ev.mul3(ct, ct)
    want = {"rotate": ev.rotate(ct, rotation), "relinearize":
            ev.relinearize(c3)}
    meta = (ct.scaling_factor, ct.sf_degree, ct.slots)
    worker = {"params": kw, "keys": key_arrays(ctx.keygen),
              "digits": ctx.params.crt.num_decomp(ct.level), "slots": slots,
              "ct": (arr(ct.c0), arr(ct.c1)), "meta": meta,
              "c3": (arr(c3.c0), arr(c3.c1), arr(c3.c2)),
              "meta3": (c3.scaling_factor, c3.sf_degree, c3.slots),
              "rotation": rotation}
    return {"ctx": ctx, "ct": ct, "c3": c3, "want": want, "worker": worker}


def _ace_spmd(case):
    """ace_tpu's SpmdKeySwitch on a virtual mesh of the same shape."""
    ctx, ct, w = case["ctx"], case["ct"], case["worker"]
    mesh = make_digit_slot_mesh(w["digits"], w["slots"])
    ksw = SpmdKeySwitch(ctx.params, ct.level, mesh)
    rot = ksw.rotate(ct, w["rotation"], ctx.keygen)
    rel = ksw.relinearize(case["c3"], ctx.keygen)
    return {"rotate": rot, "relinearize": rel,
            "resident": ksw.key_memory_resident_bytes()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    cases = {k: _case(*v) for k, v in CASES.items()}
    calls = [("key_switches", ([c["worker"] for c in cases.values()],))]
    with ThreadPoolExecutor(1) as pool, one_thread():
        with file_rendezvous(str(tmp_path_factory.mktemp("rdv"))) as rdv:
            ranks = pool.submit(run_world, W.jobs, 2, 2, "gloo", "cpu", rdv,
                                (calls,))
            ace = {k: _ace_spmd(cases[k]) for k in ACE_SPMD}
            ranks = ranks.result()
    return {"cases": cases, "ranks": [r[0] for r in ranks], "ace": ace}


def _eq(got: tuple, want) -> None:
    np.testing.assert_array_equal(got[0], arr(want.c0))
    np.testing.assert_array_equal(got[1], arr(want.c1))


@pytest.mark.parametrize("op", ["rotate", "relinearize"])
@pytest.mark.parametrize("name", list(CASES))
def test_key_switch_bit_exact(world, name, op):
    """Every rank returns ace_tpu's single-device result (and its
    SpmdKeySwitch's, where it ran)."""
    i = list(CASES).index(name)
    want = world["cases"][name]["want"][op]
    if name in world["ace"]:
        _eq((arr(world["ace"][name][op].c0),
             arr(world["ace"][name][op].c1)), want)
    for rank in world["ranks"]:
        assert rank[i]["switches"] == 2
        _eq(rank[i][op], want)


@pytest.mark.parametrize("name", ACE_SPMD)
def test_resident_key_bytes_equal_ace_tpu(world, name):
    """Each rank holds 1/(D*s) of the rotation and relinearization keys:
    ace_tpu's per-device figure."""
    i = list(CASES).index(name)
    for rank in world["ranks"]:
        assert rank[i]["resident"] == world["ace"][name]["resident"]


def test_four_digit_case_has_four_digits(world):
    c = world["cases"]["4-digits"]
    assert c["worker"]["digits"] == 4
    assert c["ct"].level == 8


def test_four_slot_case_has_one_digit(world):
    """Three mod_switches leave 3 of 6 limbs: one digit, so the 4-rank
    world is one digit row of 4 slots (the slot all_gather's dim-3
    order and the slot-ordered key blocks at s = 4)."""
    c = world["cases"]["1-digit-4-slots"]
    assert (c["worker"]["digits"], c["worker"]["slots"]) == (1, 4)
    assert c["ct"].level == 3


@pytest.mark.parametrize("name", list(CASES))
def test_window_constants_equal_ace_tpu(world, name):
    """The per-digit window constants of every digit equal ace_tpu's
    (its SpmdKeySwitch builds them for the whole digit axis)."""
    case = world["cases"][name]
    ctx, ct = case["ctx"], case["ct"]
    mesh = make_digit_slot_mesh(case["worker"]["digits"], 1)
    ace = SpmdKeySwitch(ctx.params, ct.level, mesh)
    got = TS.window_constants(
        TCkksParams(**case["worker"]["params"], device="cpu").crt, ct.level)
    for k in ("hat_inv", "hat_prec", "mat"):
        np.testing.assert_array_equal(got[k], np.asarray(getattr(ace, k)))
    np.testing.assert_array_equal(got["part_q"],
                                  np.asarray(ace.part_q)[:, :, 0, 0])


def test_digit_sum_past_two_to_the_63():
    """Sums of D canonical terms wrap modulo 2^64 in int64; the
    reduction compares as unsigned, so a sum in [2^63, 2^64) (16 digits
    of 60-bit primes reach it) comes back exact where a signed compare
    would leave it negative."""
    q = (1 << 60) - 93
    rng = np.random.default_rng(5)
    terms = rng.integers(q - 1000, q, (16, 64), dtype=np.uint64)
    total = terms.astype(object).sum(axis=0)
    assert (total >= 1 << 63).all() and (total < 1 << 64).all()
    e = TM.to_torch((total % (1 << 64)).astype(np.uint64), "cpu")
    qt = torch.tensor([q], dtype=torch.int64)
    got = TM.to_numpy(TS.reduce_digit_sum(e, qt, 16))
    np.testing.assert_array_equal(got, (total % q).astype(np.uint64))
