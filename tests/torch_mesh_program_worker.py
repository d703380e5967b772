"""Rank functions of the mesh-program tests (tests/test_torch_mesh_programs.py
on the CPU, tests/test_torch_graphs.py on the card). The ranks are spawned
processes that import this module by name, so it imports torch and the
port only, never jax: the tests compute ace_tpu's side in the parent and
pass numpy arrays in and out."""

import numpy as np
import torch

from ace_tpu_torch import interop, ops
from ace_tpu_torch.ckks.encoder import Encoder
from ace_tpu_torch.ckks.evaluator import Evaluator
from ace_tpu_torch.ckks.params import CkksParams
from ace_tpu_torch.compiler.packing import FheBackend
from ace_tpu_torch.parallel.mesh import make_mesh
from ace_tpu_torch.parallel.spmd import SpmdKeySwitch
from ace_tpu_torch.parallel.spmd_eval import SpmdEvaluator
from ace_tpu_torch.runtime.context import FheContext
from ace_tpu_torch.utils.liftgraph import GraphPool, lift_graph

from tests.torch_limb_worker import gathered
from tests.torch_spmd_worker import conv_slice, ct_arrays

CPU = torch.device("cpu")
MAC_ROTS = [1, 2, 5]


class CollectiveLog:
    """Every collective `mesh` runs, as (method, axis, src, input shape),
    grouped by `mark`: the schedule that the ranks actually ran."""

    def __init__(self, mesh):
        self.calls, self._run = {}, mesh.run_collective
        self._cur = None
        mesh.run_collective = self._log

    def _log(self, op, x, axis, src=None):
        self.calls.setdefault(self._cur, []).append(
            (op, axis, src, tuple(x.shape)))
        return self._run(op, x, axis, src)

    def mark(self, name) -> None:
        self._cur = name


def _cts(case, params):
    return [interop.ciphertext(*c, *case["meta"], params.device,
                               crt=params.crt) for c in case["cts"]]


def _schedules(programs: dict) -> dict:
    return {str(k): [list(e) for e in p.schedule]
            for k, p in programs.items() if getattr(p, "schedule", None)}


def _three_calls(mesh, log, ops_, cts, gather):
    """Each op of `ops_` (name -> f(ct)) called on each ciphertext of cts
    in turn (calls 1, 2 and 3 of its programs): the gathered results and
    the mesh's collectives in each call."""
    out = {}
    for name, f in ops_.items():
        res = []
        for i, ct in enumerate(cts):
            log.mark((name, i))
            n0 = mesh.collectives
            got = f(ct)
            n = mesh.collectives - n0
            log.mark(None)  # gather may run collectives of its own
            res.append({"out": gather(got), "collectives": n})
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# the digit x slot mesh: SpmdEvaluator with programs on
# ---------------------------------------------------------------------------

def digit_programs(mesh, case):
    """rotate, mul, relinearize and the conv slice through SpmdEvaluator
    (programs on) three times each on the case's three ciphertexts; then
    rank 0 drops its "rot" program and rebuilds it while the others
    replay theirs. Returns the results, each SpmdKeySwitch's program keys
    and schedules, the collectives each call ran, and the switches."""
    params = CkksParams(**case["params"], device="cpu")
    kg = interop.keygen(params, *case["keys"])
    ev = SpmdEvaluator(params, kg, Encoder(params), mesh)
    log = CollectiveLog(mesh)
    cts = _cts(case, params)
    n = params.degree // 2
    out = _three_calls(mesh, log, {
        "rotate": lambda c: ev.rotate(c, 3),
        "mul": lambda c: ev.mul(c, c),
        "relinearize": lambda c: ev.relinearize(ev.mul3(c, c)),
        "conv": lambda c: conv_slice(ev, ev.encoder, c, n)}, cts, ct_arrays)
    top = ev._ksw(cts[0].level)
    calls = top._jit_cache["rot"].calls
    if mesh.rank == 0:
        del top._jit_cache["rot"]
    log.mark("drift")
    drift = ev.rotate(cts[0], 3)
    log.mark(None)
    return {"ops": out, "drift": ct_arrays(drift),
            "drift_calls": (calls, top._jit_cache["rot"].calls),
            "keys": {lv: sorted(k._jit_cache) for lv, k in ev._spmd.items()
                     if k is not None},
            "schedules": {lv: _schedules(k._jit_cache)
                          for lv, k in ev._spmd.items() if k is not None},
            "segments": ev.program_segments(),
            "ran": dict(log.calls),
            "switches": ev.spmd_switches, "coords": mesh.coords}


# ---------------------------------------------------------------------------
# the dp x limb mesh: the limb-sharded Evaluator with programs on
# ---------------------------------------------------------------------------

def limb_programs(mesh, case):
    """rotate, mul, rescale and FheBackend.rot_ext_mac_groups over
    MAC_ROTS through the limb-sharded Evaluator (programs on) three times
    each on the case's three ciphertexts; then rank 0 drops its rotate
    program and rebuilds it while the others replay theirs. Returns the
    gathered results, the program keys and schedules, the collectives
    each call ran, and how many device constants calls 2 and 3 added."""
    params = CkksParams(**case["params"], device="cpu")
    params.crt.shard(mesh)
    kg = interop.keygen(params, *case["keys"])
    enc = Encoder(params)
    ev = Evaluator(params, kg, enc)
    be = FheBackend(ev, enc)
    log = CollectiveLog(mesh)
    cts = _cts(case, params)
    crt = params.crt
    w = np.ones(params.degree // 2)
    consts = []

    def counted(f):
        def g(c):
            n0 = len(crt._const_cache)
            r = f(c)
            consts.append(len(crt._const_cache) - n0)
            return r
        return g

    out = _three_calls(mesh, log, {
        "rotate": counted(lambda c: ev.rotate(c, 3)),
        "mul": counted(lambda c: ev.mul(c, c)),
        "rescale": counted(lambda c: ev.rescale(ev.mul(c, c))),
        "mac": counted(lambda c: be._norm(be.rot_ext_mac_groups(
            c, MAC_ROTS, [[w, w, None]])[0]))},
        cts, lambda c: gathered(crt, c))
    rot = [k for k in ev._jit_cache if k[0] == "rot" and k[2]
           == cts[0].level and k[1] == kg.rot_key(3)[0]][0]
    calls = ev._jit_cache[rot].calls
    if mesh.rank == 0:
        del ev._jit_cache[rot]
    log.mark("drift")
    drift = ev.rotate(cts[0], 3)
    log.mark(None)
    return {"ops": out, "drift": gathered(crt, drift),
            "drift_calls": (calls, ev._jit_cache[rot].calls),
            "keys": list(ev._jit_cache),
            "schedules": _schedules(ev._jit_cache),
            "segments": ev.program_segments(),
            "ran": dict(log.calls),
            "new_consts": consts, "coords": mesh.coords}


# ---------------------------------------------------------------------------
# the schedule's guards
# ---------------------------------------------------------------------------

def schedule_guards(mesh):
    """Programs over the mesh's digit axis whose calls change their
    collectives (another method, one fewer, one more), sum_over_world
    inside a program, and a program called inside another: each raises,
    on every rank at the same point, so the world stays in step."""
    pool = GraphPool(CPU)
    x = torch.arange(6, dtype=torch.int64).reshape(2, 3)
    errors = {}
    for name, plans in (("method", (["r"], ["g"])),
                        ("fewer", (["r", "r"], ["r"])),
                        ("more", (["r"], ["r", "r"]))):
        it = iter(plans)

        def fn(t, _it=it):
            for c in next(_it):
                t = (mesh.all_reduce(t, "digit") if c == "r"
                     else mesh.all_gather(t, "digit")[0])
            return t
        p = lift_graph(fn, pool)
        p(x)
        try:
            p(x)
        except RuntimeError as e:
            errors[name] = str(e)
    inner = lift_graph(lambda t: t + 1, pool)
    for name, fn in (("sum_over_world", lambda t: t + mesh.sum_over_world(
            [1])[0]), ("nested", lambda t: inner(t))):
        try:
            lift_graph(fn, pool)(x)
        except RuntimeError as e:
            errors[name] = str(e)
    return errors


# ---------------------------------------------------------------------------
# on the card (tests/test_torch_graphs.py)
# ---------------------------------------------------------------------------

def _eager_vs_programs(run_prog, run_eager, make, sync):
    """Three calls through programs (eager, captured, replayed) against
    the eager path on fresh inputs: outputs word for word and the kernel
    counters' growth equal."""
    for call in range(3):
        args = make(call)
        got = []
        for run in (run_prog, run_eager):
            ops.reset_counters()
            outs = run(*args)
            sync()
            got.append((outs, ops.counter_state()))
        (a, ca), (b, cb) = got
        assert ca == cb, (call, ca, cb)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), call


def card_programs(mesh, kw, seed):
    """A 1 x 2 digit x slot world on one card: SpmdKeySwitch.rotate at a
    one-digit level through its program and eagerly; then a 1 x 2 limb
    mesh over the same world: Evaluator.rescale through its program and
    eagerly. Returns each program's segments and the pools' stats."""
    dev = mesh.device

    def sync():
        torch.cuda.synchronize(dev)

    ctx = FheContext(CkksParams(**kw, device=dev), seed=seed)
    level = ctx.params.crt.per_part_size
    prog = SpmdKeySwitch(ctx.params, level, mesh)
    eager = SpmdKeySwitch(ctx.params, level, mesh, programs=False)
    rng = np.random.default_rng(seed)
    n = kw["degree"] // 2
    kg = ctx.keygen
    kg.rot_key(1)

    def rot(k):
        def run(ct):
            r = k.rotate(ct, 1, kg)
            return r.c0.data, r.c1.data
        return run

    _eager_vs_programs(rot(prog), rot(eager), lambda _: (ctx.prepare_input(
        rng.uniform(-1, 1, n), "x", level=level),), sync)
    out = {"spmd_segments": prog._jit_cache["rot"].segments,
           "spmd_switches": prog.switches, "spmd": prog.pool.stats()}
    limb = make_mesh(1, mesh.num_slot, "gloo", dev)
    lctx = FheContext(CkksParams(**kw, device=dev), seed=seed, mesh=limb)
    lev = lctx.evaluator
    leager = Evaluator(lctx.params, lctx.keygen, lctx.encoder,
                       programs=False)

    def rescale(e):
        def run(ct):
            r = e.rescale(ct)
            return r.c0.data, r.c1.data
        return run

    _eager_vs_programs(rescale(lev), rescale(leager), lambda _: (
        lctx.prepare_input(rng.uniform(-1, 1, n), "y"),), sync)
    out["limb_segments"] = lev.program_segments()
    out["limb"] = lev.program_stats()
    return out


def jobs(mesh, calls):
    """Run several of the functions above in one world: calls is a list
    of (function name, args); returns their results in order."""
    return [globals()[name](mesh, *args) for name, args in calls]
