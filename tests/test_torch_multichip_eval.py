"""PyTorch port: the limb-sharded evaluator (FheContext(mesh=...),
CrtContext.shard) on 4-rank gloo worlds of spawned CPU ranks, bit for
bit against ace_tpu's unsharded evaluator with ace_tpu's keys and
ciphertexts injected: tests/test_multichip_eval.py's three cases at its
sizes on a 1 x 4 mesh (rotate + mul + rescale; the hoisted MAC groups;
the bootstrap), and the dry run's dp x limb step
(__graft_entry__.dryrun_multichip) on a 2 x 2 mesh with a different
message on each dp row. Degree 2^10 with 8 q primes in 3 digits splits
the 8 + 4 limbs 3/3/3/3 and each level's unevenly.

The bootstrap is `slow`: ace_tpu's side alone compiles for minutes."""

import numpy as np
import pytest

from ace_tpu.ckks.params import CkksParams
from ace_tpu.compiler.packing import FheBackend
from ace_tpu.runtime.context import FheContext
from ace_tpu_torch.parallel.mesh import DP_LIMB, file_rendezvous, run_world

from tests import torch_limb_worker as W
from tests.torch_port_util import arr, key_arrays, one_thread

KW = dict(degree=1 << 10, num_q=8, first_mod_size=60, scaling_mod_size=56,
          hamming_weight=16, num_q_parts=3)
BTS_KW = dict(KW, num_q=19, hamming_weight=192)
N = KW["degree"] // 2


def _case(ctx, ct, n):
    return {"params": {k: getattr(ctx.params, k) for k in KW},
            "keys": key_arrays(ctx.keygen), "n": n,
            "ct": (arr(ct.c0), arr(ct.c1)),
            "meta": (ct.scaling_factor, ct.sf_degree, ct.slots)}


def _run(tmp_path_factory, calls):
    with file_rendezvous(str(tmp_path_factory.mktemp("rdv"))) as rdv, \
            one_thread():
        return run_world(W.jobs, 1, 4, "gloo", "cpu", rdv, (calls,),
                         axes=DP_LIMB)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """ace_tpu's unsharded results and the ranks' gathered ones."""
    ctx = FheContext(CkksParams(**KW), seed=7)
    ev = ctx.evaluator
    msg = np.linspace(-1, 1, N)
    ct = ctx.prepare_input(msg, "x")
    r = ev.rotate(ct, 3)
    sq = ev.mul(r, r)
    want = {"rotate": r, "mul": sq, "rescale": ev.rescale(sq)}
    vals = [np.linspace(-0.5, 0.5, N), np.cos(np.arange(N))]
    msgs = np.stack([np.asarray(ctx.encoder.encode_msg(v)) for v in vals])
    want["off"] = {
        "mul_by_monomial": ev.mul_by_monomial(ct, 7),
        "add_const": ev.add_const(ct, 0.25),
        "mul_integer": ev.mul_integer(ct, 3),
        "mod_switch": ev.mod_switch(ct),
        "conjugate": ev.conjugate(ct),
        "rot_sum": ev.rot_sum_jit([(ct, 1), (ct, 2)]),
        "rotate_ext": ev.mod_down_ciph(ev.rotate_ext(ct, 1)),
        "msgs": ev.rot_mac_groups_msgs_jit(ct, [1, 2], msgs[None])[0]}
    for i, c in enumerate(ev.rotations_hoisted(ct, [1, 2])):
        want["off"][f"hoisted{i}"] = c
    mac_msg = np.arange(N) / N
    ct_mac = ctx.prepare_input(mac_msg, "m")
    be = FheBackend(ev, ctx.encoder)
    w = np.ones(N)
    want["mac"] = be._norm(be.rot_ext_mac_groups(ct_mac, [1, 2, 5],
                                                 [[w, w, None]])[0])
    # the dry run's step: one ciphertext per dp row, different messages
    msgs = [np.linspace(-1, 1, N) * (0.5 + i) / 2 for i in range(2)]
    cts = [ctx.prepare_input(m, f"d{i}") for i, m in enumerate(msgs)]
    pt = ctx.encoder.encode(np.full(N, 0.5, np.complex128),
                            level=cts[0].level)
    want["dry"] = [ev.rescale(ev.mul_plain(ev.add(ev.rotate(c, 1), c), pt))
                   for c in cts]
    case = _case(ctx, ct, N)
    mac_case = dict(case, ct=(arr(ct_mac.c0), arr(ct_mac.c1)))
    dry_case = dict(case, level=cts[0].level,
                    batch=(np.stack([arr(c.c0) for c in cts]),
                           np.stack([arr(c.c1) for c in cts])))
    calls = [("rotate_mul_rescale", (case,)), ("mac_groups", (mac_case,)),
             ("on_mesh", ((2, 2), "dryrun_step", dry_case)),
             ("off_path_ops", (dict(case, msg_values=vals),))]
    ranks = _run(tmp_path_factory, calls)
    return {"ranks": ranks, "want": want, "msg": msg, "mac_msg": mac_msg,
            "msgs": msgs}


def _equal(got, want):
    np.testing.assert_array_equal(got[0], arr(want.c0))
    np.testing.assert_array_equal(got[1], arr(want.c1))


@pytest.mark.parametrize("op", ["rotate", "mul", "rescale"])
def test_rotate_mul_rescale_bit_exact(world, op):
    """Hybrid key switch (rotate), mul + relinearize, rescale: every
    rank's gathered residues equal ace_tpu's unsharded evaluator's."""
    for rank in world["ranks"]:
        _equal(rank[0][op], world["want"][op])


def test_rotate_mul_rescale_decodes(world):
    want = np.roll(world["msg"], -3) ** 2
    for rank in world["ranks"]:
        assert np.allclose(rank[0]["decoded"], want, atol=1e-2)
        assert rank[0]["stats"]["collectives"] > 0
    # each rank holds its own limbs only: of the 7 after the rescale,
    # {0, 4}, {1, 5}, {2, 6} and {3}
    assert [r[0]["rows"][0] for r in world["ranks"]] == [2, 2, 2, 1]


def test_hoisted_mac_groups_sharded(world):
    """FheBackend.rot_ext_mac_groups (the conv path's bundle) reaches only
    sharded evaluator methods: bit-exact, and decodes to the rotations'
    sum."""
    m = world["mac_msg"]
    for rank in world["ranks"]:
        _equal(rank[1]["out"], world["want"]["mac"])
        assert np.allclose(rank[1]["decoded"],
                           np.roll(m, -1) + np.roll(m, -2), atol=1e-2)


def test_dryrun_step_dp_by_limb(world):
    """The dry run's step on a 2 x 2 mesh: each dp row's gathered output
    equals ace_tpu's single-device step on that row's message."""
    for r, rank in enumerate(world["ranks"]):
        got = rank[2]
        assert got["dp"] == r // 2
        _equal(got["out"], world["want"]["dry"][got["dp"]])
    assert not np.array_equal(world["ranks"][0][2]["out"][0],
                              world["ranks"][2][2]["out"][0])


OFF_PATH = ["mul_by_monomial", "add_const", "mul_integer", "mod_switch",
            "conjugate", "rot_sum", "rotate_ext", "msgs", "hoisted0",
            "hoisted1"]


@pytest.mark.parametrize("op", OFF_PATH)
def test_other_evaluator_methods_sharded(world, op):
    """The evaluator's other methods (the monomial and constant products,
    the level drop, conjugation, rot_sum_jit, the extended-basis rotation
    with its mod-down, rot_mac_groups_msgs_jit on integer messages, the
    hoisted rotations) on a 1 x 4 mesh: gathered, ace_tpu's residues."""
    for rank in world["ranks"]:
        _equal(rank[3][op], world["want"]["off"][op])


@pytest.mark.slow
def test_bootstrap_sharded_bit_exact(tmp_path_factory):
    """A full (sparse) bootstrap at degree 2^10, 19 q primes, hw 192 on a
    1 x 4 mesh (a level-1 ciphertext leaves three ranks without a row)
    equals ace_tpu's unsharded bootstrap bit for bit."""
    ctx = FheContext(CkksParams(**BTS_KW), seed=3)
    msg = np.linspace(-0.4, 0.4, 64)
    ct = ctx.prepare_input(msg, "x", level=2)
    out = ctx.bootstrap(ctx.evaluator.rescale(
        ctx.evaluator.mul_const(ct, 1.0)))
    ranks = _run(tmp_path_factory, [("bootstrap", (_case(ctx, ct, 64),))])
    for rank in ranks:
        assert rank[0]["level"] == out.level
        _equal(rank[0]["out"], out)
        assert np.allclose(rank[0]["decoded"], msg, atol=2e-2)
