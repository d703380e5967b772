"""PyTorch port: the evaluator's op programs (ckks/evaluator.py _get_jit
and the _mk_* builders, utils/liftgraph.py, runtime/precompile.py)
against ace_tpu's jitted bundles and its program inventory, on the CPU,
where a Program runs its function directly with the same bookkeeping:

(1) the tiny CNN with a bootstrap (tests/test_torch_slice.py's) calls
    the same program keys the same number of times in both packages;
(2) every program kind is bit-exact against ace_tpu and against the
    port's eager path (programs=False) over three calls on different
    inputs (warm-up, capture and replay on the card);
(3) a rotation key evicted by the LRU takes its programs with it, and
    its next use rebuilds them;
(4) precompile.inventory gives ace_tpu's inventory records, and
    precompile.prepare leaves image 0 replaying every program;
(5) mul through ("mulrl", level) equals mul3 + relinearize.
"""

import collections
import dataclasses
import json
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ace_tpu.ckks.encoder import Encoder
from ace_tpu.ckks.evaluator import Evaluator
from ace_tpu.ckks.keygen import KeyGenerator
from ace_tpu.ckks.params import CkksParams
from ace_tpu.compiler import scheme_info as S
from ace_tpu.models import resnet as M
from ace_tpu.runtime import precompile as PC
from ace_tpu_torch import interop, ops
from ace_tpu_torch.ckks.encoder import Encoder as TEncoder
from ace_tpu_torch.ckks.evaluator import Evaluator as TEvaluator
from ace_tpu_torch.ckks.keygen import KeyGenerator as TKeyGenerator
from ace_tpu_torch.ckks.params import CkksParams as TParams
from ace_tpu_torch.compiler import scheme_info as TS
from ace_tpu_torch.models import resnet as TM
from ace_tpu_torch.runtime import precompile as TPC
from ace_tpu_torch.runtime.context import FheContext as TFheContext
from ace_tpu_torch.utils.liftgraph import GraphPool, Program, lift_graph

from tests.torch_port_util import (CPU, arr, assert_ct_equal, port_ct,
                                   port_keygen)

KW = dict(degree=32, num_q=5, first_mod_size=33, scaling_mod_size=30)
ROTS = [1, 2, 3, 6]
N_SLOTS = 16


# -- (1) and (4): the tiny CNN with a bootstrap ------------------------------

def _tiny_cfg(mod):
    """tests/test_e2e_tiny.py's encrypted configuration: degree 64, a
    bootstrap before the ReLU."""
    return mod.SchemeConfig(security_level=0, hamming_weight=32,
                            relu_value_range=2.0, relu_mul_depth=13)


def _tiny():
    from tests.test_e2e_tiny import tiny_cnn
    g = tiny_cnn()
    tg = interop.nngraph([dataclasses.asdict(op) for op in g.ops],
                         g.weights, g.input_name, g.input_shape,
                         g.output_name)
    x = np.random.default_rng(5).uniform(-1, 1, (1, 4, 4))
    return g, tg, x


@pytest.fixture(scope="module")
def ace_inventory():
    """ace_tpu's own inventory of one tiny-CNN inference: its
    patch_encoder and patch_inventory (stub programs that record each
    key, argument shapes and calls), as its precompile does."""
    g, _, x = _tiny()
    model = M.compile_model(g, _tiny_cfg(S), num_classes=2)
    PC.patch_encoder(model.ctx.encoder)
    records = []
    PC.patch_inventory(model.ctx.evaluator, records)
    M.infer_encrypted(model, x)
    return records


def _calls(records) -> dict:
    return {TPC.program_key(r): r["calls"] for r in records}


def test_program_keys_and_calls_equal_ace_tpu(ace_inventory):
    """One real inference of the tiny CNN through the port, its
    evaluator's _get_jit wrapped to count each program's calls: the
    same program keys, each called as often as in ace_tpu."""
    _, tg, x = _tiny()
    tmodel = TM.compile_model(tg, _tiny_cfg(TS), num_classes=2,
                              device="cpu")
    ev = tmodel.ctx.evaluator
    assert ev.programs
    calls = collections.Counter()
    real = ev._get_jit

    def counting(key, builder, *args):
        fn = real(key, builder, *args)

        def call(*a):
            calls[key] += 1
            return fn(*a)
        return call

    ev._get_jit = counting
    dec = TM.infer_encrypted(tmodel, x)
    want = _calls(ace_inventory)
    assert len(want) == 96 and sum(want.values()) == 233
    assert dict(calls) == want
    plain = TM.infer_plain(tg, x, n_slots=32)[:2]
    assert np.max(np.abs(dec - plain)) < 5e-2, (dec, plain)


def _as_port_shapes(record):
    """ace_tpu's arg_shapes as the port records them: int64 for uint64,
    and bsgs's stacked baby key planes [nb, D, LK, N] (a [0] array when
    every baby rotation is 0) as nb lists of D planes [LK, N], since the
    port reads each baby key in place instead of stacking it."""
    def dtype(x):
        if isinstance(x, list):
            return [dtype(v) for v in x]
        return {"s": x["s"], "d": x["d"].replace("uint64", "int64")}
    shapes = dtype(record["arg_shapes"])
    if record["kind"] == "bsgs":
        for i in (2, 3):
            s = shapes[i]["s"]
            shapes[i] = [] if s == [0] else \
                [[{"s": s[2:], "d": "int64"}] * s[1]] * s[0]
    return shapes


def test_inventory_equals_ace_tpu(ace_inventory):
    """precompile.inventory on the tiny CNN: ace_tpu's records in its
    order (kind, builder_args, calls, argument shapes up to the dtype
    and bsgs's baby-key stacking)."""
    _, tg, x = _tiny()
    header, records = TPC.inventory(tg, _tiny_cfg(TS), x, num_classes=2,
                                    device="cpu")
    assert header["degree"] == 64 and header["kind"] == "header"
    assert len(records) == len(ace_inventory)
    for got, want in zip(records, ace_inventory):
        assert (got["kind"], got["builder_args"], got["calls"]) == \
            (want["kind"], want["builder_args"], want["calls"])
        assert got["arg_shapes"] == _as_port_shapes(want)
    json.dumps(records)  # the JSONL schema


def test_prepare_then_image_zero_replays():
    """precompile.prepare on a fresh context: every recorded program is
    warmed up and captured (two calls) before image 0, which then calls
    every program a third time or more and decodes as infer_plain."""
    _, tg, x = _tiny()
    _, records = TPC.inventory(tg, _tiny_cfg(TS), x, num_classes=2,
                               device="cpu")
    tmodel = TM.compile_model(tg, _tiny_cfg(TS), num_classes=2,
                              device="cpu")
    ev = tmodel.ctx.evaluator
    done = TPC.prepare(tmodel.ctx, records)
    assert done["programs"] == len(records) == len(ev._jit_cache)
    assert {p.calls for p in ev._jit_cache.values()} == {2}
    dec = TM.infer_encrypted(tmodel, x)
    assert {TPC.program_key(r) for r in records} == set(ev._jit_cache)
    assert min(p.calls for p in ev._jit_cache.values()) >= 3
    plain = TM.infer_plain(tg, x, n_slots=32)[:2]
    assert np.max(np.abs(dec - plain)) < 5e-2, (dec, plain)


# -- (2): every kind bit-exact ----------------------------------------------

@pytest.fixture(scope="module")
def trio():
    """ace_tpu's evaluator and the port's with programs on and off, on
    ace_tpu's keys (degree 32, 5 primes)."""
    params = CkksParams(**KW)
    kg = KeyGenerator(params, np.random.default_rng(23))
    for r in ROTS:
        kg.rot_key(r)
    kg.conj_key()
    ev = Evaluator(params, kg, Encoder(params))
    tparams = TParams(**KW, device="cpu")
    tkg = port_keygen(tparams, kg, rng=np.random.default_rng(4))
    tenc = TEncoder(tparams)
    return (ev, TEvaluator(tparams, tkg, tenc),
            TEvaluator(tparams, tkg, tenc, programs=False))


def _port_pt(pt):
    return interop.plaintext(arr(pt.poly), pt.scaling_factor, pt.sf_degree,
                             pt.slots, CPU, num_p=pt.poly.num_p)


def _msgs(rng, g, r):
    """int64 messages [g, r, N] (the scale of encoded weights)."""
    m = rng.integers(-(1 << 40), 1 << 40, (g, r, KW["degree"]))
    return jnp.asarray(m), torch.as_tensor(m)


def _case(kind, ev, rng):
    """(ace_tpu call, port call, program key kind) for one kind, on a
    fresh ciphertext."""
    def msg():
        return rng.uniform(-1, 1, N_SLOTS) + 1j * rng.uniform(-1, 1, N_SLOTS)
    ct = ev.encrypt(ev.encoder.encode(msg()))
    ct2 = ev.encrypt(ev.encoder.encode(msg()))
    t, t2 = port_ct(ct), port_ct(ct2)
    if kind == "rot":
        return (lambda e: e.rotate(ct, 3), lambda e: e.rotate(t, 3))
    if kind == "conj":
        return (lambda e: e.conjugate(ct), lambda e: e.conjugate(t))
    if kind == "mulrl":
        return (lambda e: e.mul(ct, ct2), lambda e: e.mul(t, t2))
    if kind == "rs":
        return (lambda e: e.rescale(ct), lambda e: e.rescale(t))
    if kind == "mp":
        pt = ev.encoder.encode(msg(), level=ct.level)
        tpt = _port_pt(pt)
        return (lambda e: e.mul_plain(ct, pt), lambda e: e.mul_plain(t, tpt))
    if kind == "addc":
        v = float(rng.uniform(-1, 1))
        return (lambda e: e.add_const(ct, v), lambda e: e.add_const(t, v))
    if kind == "rsum":
        return (lambda e: e.rot_sum_jit([(ct, 1), (ct2, 0), (ct, 6)]),
                lambda e: e.rot_sum_jit([(t, 1), (t2, 0), (t, 6)]))
    if kind == "rmg":
        groups = [[ev.encoder.encode(msg(), level=ct.level, extended=True)
                   if (g + i) % 3 else None for i in range(3)]
                  for g in range(2)]
        tgroups = [[None if p is None else _port_pt(p) for p in grp]
                   for grp in groups]
        return (lambda e: e.rot_ext_mac_groups_jit(ct, [0, 2, 3], groups),
                lambda e: e.rot_ext_mac_groups_jit(t, [0, 2, 3], tgroups))
    if kind == "rmgm":
        jm, tm = _msgs(rng, 2, 3)
        return (lambda e: e.rot_mac_groups_msgs_jit(ct, [0, 1, 2], jm),
                lambda e: e.rot_mac_groups_msgs_jit(t, [0, 1, 2], tm))
    assert kind == "bsgs"
    jm, tm = _msgs(rng, 3, 3)
    return (lambda e: e.bsgs_iter_jit(ct, [0, 1, 2], [0, 3, 6], jm),
            lambda e: e.bsgs_iter_jit(t, [0, 1, 2], [0, 3, 6], tm))


def _assert_equal(got, want):
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_ct_equal(g, w)
    else:
        assert_ct_equal(got, want)


KINDS = {"rot": "rot", "conj": "rot", "mulrl": "mulrl", "rs": "rs",
         "mp": "mp", "addc": "addc", "rsum": "rsum", "rmg": "rmg",
         "rmgm": "rmgm", "bsgs": "bsgs"}


@pytest.mark.parametrize("kind", list(KINDS))
def test_each_kind_bit_exact(trio, kind):
    """Three calls of the kind's program on three fresh ciphertexts (the
    warm-up, capture and replay calls on the card): each equal residue
    for residue to ace_tpu's bundle and to the port's eager path."""
    ev, tev, eager = trio
    rng = np.random.default_rng(sorted(KINDS).index(kind))
    before = {k for k in tev._jit_cache if k[0] == KINDS[kind]}
    for _ in range(3):
        want_f, got_f = _case(kind, ev, rng)
        want = want_f(ev)
        _assert_equal(got_f(tev), want)
        _assert_equal(got_f(eager), want)
    (key,) = {k for k in tev._jit_cache if k[0] == KINDS[kind]} - before
    prog = tev._jit_cache[key]
    assert isinstance(prog, Program) and prog.calls == 3
    assert not isinstance(eager._jit_cache[key], Program)


# -- (3): eviction ----------------------------------------------------------

def _own(max_rot_keys):
    params = TParams(**KW, device="cpu")
    kg = TKeyGenerator(params, np.random.default_rng(9),
                       max_rot_keys=max_rot_keys)
    enc = TEncoder(params)
    return TEvaluator(params, kg, enc), enc


def test_eviction_drops_and_rebuilds_programs():
    """max_rot_keys=2: rotating by 1 three times captures the program of
    rotation 1 with its key; rotations 2 and 3 evict that key, which
    drops the program; rotating by 1 again makes a new key and a new
    program, and decodes right."""
    ev, enc = _own(2)
    rng = np.random.default_rng(2)
    m = rng.uniform(-1, 1, N_SLOTS)
    ct = ev.encrypt(enc.encode(m.astype(np.complex128)))

    def rot_prog(r):
        ai, _ = ev.keygen.rot_key(r)
        return ev._jit_cache.get(("rot", ai, ct.level))

    for _ in range(3):
        ev.rotate(ct, 1)
    ai1, key1 = ev.keygen.rot_key(1)
    prog = ev._jit_cache[("rot", ai1, ct.level)]
    assert prog.calls == 3 and prog.holds({id(key1.b[0].data)})
    ev.rotate(ct, 2)
    ev.rotate(ct, 3)
    assert key1.evicted
    assert ("rot", ai1, ct.level) not in ev._jit_cache
    out = ev.rotate(ct, 1)
    assert rot_prog(1).calls == 1 and rot_prog(1) is not prog
    assert ev.keygen.rot_key(1)[1] is not key1
    dec = enc.decode(ev.decrypt(out)).real
    assert np.max(np.abs(dec - np.roll(m, -1))) < 1e-3


def test_bundle_beyond_the_lru_is_not_kept():
    """A rot_sum over three rotations with room for two keys: fetching
    its keys evicts one of them, so its program is dropped after each
    call and never captures a key the LRU let go; the results still
    decode."""
    ev, enc = _own(2)
    m = np.random.default_rng(3).uniform(-1, 1, N_SLOTS)
    ct = ev.encrypt(enc.encode(m.astype(np.complex128)))
    want = np.roll(m, -1) + np.roll(m, -2) + np.roll(m, -3)
    for _ in range(3):
        out = ev.rot_sum_jit([(ct, 1), (ct, 2), (ct, 3)])
        assert not any(k[0] == "rsum" for k in ev._jit_cache)
        dec = enc.decode(ev.decrypt(out)).real
        assert np.max(np.abs(dec - want)) < 1e-3


def test_stale_key_raises():
    """A program handed other key tensors than it captured raises."""
    ev, enc = _own(0)
    ct = ev.encrypt(enc.encode(np.zeros(N_SLOTS, np.complex128)))
    for _ in range(2):
        ev.rotate(ct, 1)
    ai, key = ev.keygen.rot_key(1)
    prog = ev._jit_cache[("rot", ai, ct.level)]
    kb, ka = ev._key_raw(key)
    with pytest.raises(RuntimeError, match="stale"):
        prog(ct.c0.data, ct.c1.data, [t.clone() for t in kb], ka)


def test_swapped_keygen_drops_programs():
    """A key generator swapped onto an evaluator whose mul and rotate
    programs captured the old one's keys drops those programs: the next
    mul and rotate rebuild them on the new keys, equal to an eager
    evaluator on the new key generator (no stale-key error)."""
    ev, enc = _own(0)
    rng = np.random.default_rng(11)
    a, b = (ev.encrypt(enc.encode(rng.uniform(-1, 1, N_SLOTS)
                                  .astype(np.complex128)))
            for _ in range(2))
    for _ in range(3):
        ev.mul(a, b)
        ev.rotate(a, 1)
    assert ev._jit_cache[("mulrl", KW["num_q"])].calls == 3
    kg = TKeyGenerator(ev.params, np.random.default_rng(12))
    ev.keygen = kg
    assert not ev._jit_cache
    eager = TEvaluator(ev.params, kg, enc, programs=False)
    for _ in range(3):
        for op in (lambda e: e.mul(a, b), lambda e: e.rotate(a, 1)):
            got, want = op(ev), op(eager)
            assert torch.equal(got.c0.data, want.c0.data)
            assert torch.equal(got.c1.data, want.c1.data)
    assert ev._jit_cache[("mulrl", KW["num_q"])].calls == 3
    ev.keygen = kg  # the same one again keeps the programs
    assert ev._jit_cache


def test_inventory_defaults_to_the_card(monkeypatch):
    """inventory() and the inventory command resolve no device to the
    card, as every entry point of the port does."""
    seen = {}
    monkeypatch.setattr(TPC, "run_inventory",
                        lambda args: seen.setdefault("device", args.device))
    TPC.main(["inventory", "--out", "inv.jsonl"])
    assert seen == {"device": None}
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    _, tg, x = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TPC.inventory(tg, _tiny_cfg(TS), x, num_classes=2)


# -- (5) mulrl --------------------------------------------------------------

def test_mul_equals_mul3_relinearize():
    """mul, one ("mulrl", level) program, equals mul3 then relinearize
    residue for residue, at every call."""
    ev, enc = _own(0)
    rng = np.random.default_rng(7)
    for _ in range(3):
        a, b = (ev.encrypt(enc.encode(rng.uniform(-1, 1, N_SLOTS)
                                      .astype(np.complex128)))
                for _ in range(2))
        got = ev.mul(a, b)
        want = ev.relinearize(ev.mul3(a, b))
        for part in ("c0", "c1"):
            assert torch.equal(getattr(got, part).data,
                               getattr(want, part).data)
    assert ev._jit_cache[("mulrl", KW["num_q"])].calls == 3


# -- the program layer ------------------------------------------------------

def test_program_bookkeeping_on_the_cpu():
    """A Program on the CPU calls its function every time, counts its
    calls, takes its by-reference tensors at call 2 and checks them
    after, refuses other input shapes, and records zero counter deltas
    (no kernel runs on the CPU)."""
    pool = GraphPool("cpu")
    seen = []

    def fn(x, k):
        seen.append(x)
        return x + k[0], [x * 2]

    prog = lift_graph(fn, pool, refs=(1,))
    k = [torch.ones(3, dtype=torch.int64)]
    for i in range(3):
        a, (b,) = prog(torch.full((3,), i), k)
        assert torch.equal(a, torch.full((3,), i + 1))
        assert torch.equal(b, torch.full((3,), 2 * i))
    assert prog.calls == 3 and len(seen) == 3
    assert prog.holds({id(k[0])}) and not prog.holds({id(seen[0])})
    assert set(prog._delta.values()) == {0}
    with pytest.raises(ValueError, match="shapes"):
        prog(torch.zeros(4, dtype=torch.int64), k)
    with pytest.raises(RuntimeError, match="stale"):
        prog(torch.zeros(3, dtype=torch.int64), [k[0].clone()])
    st = pool.stats()
    assert (st["programs"], st["captures"], st["pool_bytes"]) == (1, 0, None)


def test_staging_bytes_count_every_live_buffer():
    """GraphPool.stats' staging bytes count an outgrown staging buffer
    while something (a program that captured with it) still holds it,
    and stop counting it once it is freed."""
    pool = GraphPool("cpu")
    old = pool.staging(100)
    new = pool.staging(1000)
    assert new is pool.staging(500) and new.numel() == 1000
    assert pool.stats()["staging_bytes"] == (100 + 1000) * 8
    del old
    assert pool.stats()["staging_bytes"] == 1000 * 8


def test_counter_bookkeeping_round_trip():
    """counter_delta, add_counters and restore_counters: a replay's
    deltas add to the wrappers' counters, and a capture leaves them
    as they were."""
    before = ops.counter_state()
    delta = {k: i + 1 for i, k in enumerate(before)}
    ops.add_counters(delta)
    try:
        assert ops.counter_delta(before) == delta
    finally:
        ops.restore_counters(before)
    assert ops.counter_state() == before


def test_programs_on_under_every_mesh():
    """FheContext runs op programs on one device, under a limb mesh and
    under a digit mesh (split at their collectives there, as ace_tpu
    jits every bundle under either mesh); the SPMD evaluator's key
    switches share its GraphPool."""
    kw = dict(degree=32, num_q=5, first_mod_size=33, scaling_mod_size=30,
              device="cpu")
    assert TFheContext(TParams(**kw)).evaluator.programs
    limb = types.SimpleNamespace(device=torch.device("cpu"), n_limb=1,
                                 limb=0)
    assert TFheContext(TParams(**kw), mesh=limb).evaluator.programs
    spmd = TFheContext(TParams(**kw), digit_mesh=object()).evaluator
    assert spmd.programs and type(spmd).__name__ == "SpmdEvaluator"


def test_chip_smoke_programs_phase_on_cpu():
    """chip_smoke.py's phase 11 on the CPU at the tiny CNN's ring (degree
    64): phase 4's part played by the tiny CNN's two inferences, phase
    5's by two bootstraps of a level-2 ciphertext on its context; every
    kind equal to the eager path at each of its three calls, the
    bootstrap and the model's output replayed equal. main(), not the
    phase, holds the launch gate."""
    import chip_smoke
    from ace_tpu_torch.ops import modops
    _, tg, x = _tiny()
    model = TM.compile_model(tg, _tiny_cfg(TS), num_classes=2, device="cpu")
    ctx = model.ctx
    TM.infer_encrypted(model, x)
    out = ctx.get_output_data("output")
    res = {"model": model, "input": ctx.get_input_data("input"),
           "residues": (modops.to_numpy(out.c0.data),
                        modops.to_numpy(out.c1.data))}
    TM.infer_encrypted(model, x)
    msg = np.random.default_rng(1).uniform(-0.1, 0.1, 32)
    ct = ctx.evaluator.encrypt(ctx.encoder.encode(msg.astype(np.complex128),
                                                  level=2))
    for _ in range(2):
        ctx.bootstrap(ct)
    got = chip_smoke.phase_programs(ctx, res, {"input": ct, "msg": msg},
                                    reps=1)
    assert set(got["kinds"]) == set(KINDS)
    assert all(b["max_err"] < 2e-2 for b in got["bootstrap"].values())
    assert set(got["launches_programs"].values()) <= {0}


def test_a_dropped_evaluator_frees_without_the_collector():
    """Programs hold their evaluator weakly and the key generator holds
    its eviction hooks weakly, so a context whose programs ran is freed
    (its keys, graphs and pool with it) as soon as it is dropped, with
    the cyclic garbage collector off."""
    import gc
    import weakref
    ev, enc = _own(2)
    ct = ev.encrypt(enc.encode(np.zeros(N_SLOTS, np.complex128)))
    for r in (1, 1, 1, 2, 3):
        ev.rescale(ev.mul(ev.rotate(ct, r), ct))
    ev.rot_sum_jit([(ct, 1), (ct, 0)])
    ref = weakref.ref(ev)
    gc.disable()
    try:
        del ev
        assert ref() is None
    finally:
        gc.enable()
