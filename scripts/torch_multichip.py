#!/usr/bin/env python3
"""ace_tpu's __graft_entry__.dryrun_multichip on torch.distributed, on
worlds of ranks, each phase held bit-exact against the single-device
port: phase 1 and a bootstrap on a dp x limb world (the limb-sharded
evaluator, FheContext(mesh=...)), phases 2-5 on a digit x slot world (the
SPMD key switch, FheContext(digit_mesh=...)).

    python3 scripts/torch_multichip.py --digits 3 --slots 2
    python3 scripts/torch_multichip.py --dp 2 --limb 2
        [--backend gloo|nccl] [--device cuda:0|cpu] [--degree N]

--dp/--limb run the dp x limb world, --digits/--slots the digit x slot
world; given both, both run; given neither, the digit x slot world of
2 x 2 runs. On the dp x limb world (3 q parts):
  1. the dry run's step: a batch of one ciphertext per dp row, with a
     different message on each (encrypted by the parent, which holds the
     same seeded keys), enters the ranks through put_limb(batched=True);
     each dp row computes rescale(mul_plain(add(rotate(c, 1), c), 0.5))
     at N = 2^13, 12 q primes, seed 5; each row's gathered residues must
     equal the single-device step on its message.
  4L. phase 4's bootstrap below through FheContext(mesh=...), every rank
     encrypting the message itself; gathered, bit-identical to the
     single-device bootstrap.
On the digit x slot world:

  2. one SpmdKeySwitch rotate (by 7) at N = 2^13, 12 q primes, seed 5;
     decodes to roll(m, -7) within 1e-2.
  3. FheContext(digit_mesh=...): a 3-tap conv slice (rotations 1, 8), a
     square and a degree-4 chain at N = 2^12, 8 q primes, seed 9;
     decodes to conv^4 within 1e-2.
  4. a bootstrap at N = 2^12, 19 q primes, seed 11, of 64 values in
     [-0.4, 0.4] encrypted at level 2 (then mul_const(1) and rescale);
     decodes within 2e-2.
  5. a tiny ResNet (conv, ReLU, conv, residual add, global average pool,
     gemm) through GraphRunner at N = 2^12, 22 q primes, seed 13; argmax
     equal to the plain oracle's.

Each phase's q-part count is --digits. The parent computes each
single-device result on --device after the world of --digits x --slots
ranks has computed it through the mesh (the same seeds, hence the same keys
on every rank); every rank's residues must equal the parent's, every
phase must take at least one SPMD key switch, and any failure exits
non-zero. --device is every rank's device under gloo (the default: the
card, all ranks sharing cuda:0; "cpu" runs the plain versions); under
nccl rank r runs on cuda:r. --degree N runs every phase at ring degree N
(a rehearsal on the CPU: --degree 1024).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def _params(degree, num_q, digits, hw, device):
    from ace_tpu_torch.ckks.params import CkksParams
    return CkksParams(degree=degree, num_q=num_q, first_mod_size=60,
                      scaling_mod_size=56, hamming_weight=hw,
                      num_q_parts=digits, device=device)


def _ctx(params, seed, mesh):
    """A context on `mesh`: a LimbMesh shards it (mesh=), a DigitSlotMesh
    routes its key switches (digit_mesh=)."""
    from ace_tpu_torch.parallel.mesh import LimbMesh
    from ace_tpu_torch.runtime.context import FheContext
    if isinstance(mesh, LimbMesh):
        return FheContext(params, seed=seed, mesh=mesh)
    return FheContext(params, seed=seed, digit_mesh=mesh)


def _result(ctx, out, length, switches=0):
    """out's residues (every limb, gathered under a limb mesh), its
    decode and level."""
    from ace_tpu_torch.ops import modops
    crt = ctx.params.crt
    ctx.set_output_data("y", out)
    return {"c0": modops.to_numpy(crt.gather_poly(out.c0)),
            "c1": modops.to_numpy(crt.gather_poly(out.c1)),
            "decoded": ctx.handle_output("y", length), "level": out.level,
            "switches": switches,
            "key_bytes": sum(k.nbytes for k in ctx.keygen.all_keys())}


def _switches(ctx) -> int:
    return getattr(ctx.evaluator, "spmd_switches", 0)


DRY_PARTS = 3  # the dp x limb world's q parts (ResNet-20's)


def dry_messages(n, n_dp):
    """One message per dp row."""
    return [np.linspace(-1, 1, n // 2) * (0.5 + i) / 2 for i in range(n_dp)]


def _dry_ctx(n, device, mesh):
    """Phase 1's context, its rotation key made before any encryption
    (so the parent's encryptions leave the ranks' keys as the parent's)."""
    ctx = _ctx(_params(n, 12, DRY_PARTS, 32, device), 5, mesh)
    ctx.keygen.rot_key(1)
    return ctx


def dry_step(ctx, ct):
    """The dry run's step (__graft_entry__.dryrun_multichip, one_image)."""
    ev = ctx.evaluator
    w = ctx.encoder.encode(np.full(ctx.params.degree // 2, 0.5,
                                   np.complex128), level=ct.level)
    return ev.rescale(ev.mul_plain(ev.add(ev.rotate(ct, 1), ct), w))


def dry_batch(n, n_dp, device) -> dict:
    """The single-device side of phase 1: the batch of ciphertexts (one
    per dp row, [n_dp, L, N] uint64 per component) and each row's step."""
    from ace_tpu_torch.ops import modops
    ctx = _dry_ctx(n, device, None)
    cts = [ctx.prepare_input(m, f"x{i}")
           for i, m in enumerate(dry_messages(n, n_dp))]
    ct = cts[0]
    return {"batch": [np.stack([modops.to_numpy(getattr(c, k).data)
                                for c in cts]) for k in ("c0", "c1")],
            "meta": (ct.level, ct.scaling_factor, ct.sf_degree, ct.slots),
            "rows": [_result(ctx, dry_step(ctx, c), 64) for c in cts]}


def phase_dry(n, mesh, batch, meta) -> dict:
    """Phase 1 on this rank: its dp row's ciphertext of the batch,
    limb-sharded by put_limb(batched=True), through the step."""
    from ace_tpu_torch.ckks.cipher import Ciphertext
    from ace_tpu_torch.ops import modops
    from ace_tpu_torch.parallel.mesh import put_limb
    from ace_tpu_torch.poly.poly import RnsPoly
    ctx = _dry_ctx(n, mesh.device, mesh)
    level, *rest = meta
    rows = ctx.params.crt.limbs(level, 0)
    c0, c1 = (RnsPoly(put_limb(modops.to_torch(b, mesh.device), mesh, rows,
                               batched=True)[0], level, 0, True)
              for b in batch)
    return _result(ctx, dry_step(ctx, Ciphertext(c0, c1, *rest)), 64)


def phase_keyswitch(n, digits, device, mesh=None) -> dict:
    """The dry run's phase 2: one rotate by 7 at the top of the chain."""
    from ace_tpu_torch.parallel.spmd import SpmdKeySwitch
    params = _params(n, 12, digits, 32, device)
    ctx = _ctx(params, 5, None)
    ct = ctx.prepare_input(np.linspace(-1, 1, n // 2), "x")
    if mesh is None:
        return _result(ctx, ctx.evaluator.rotate(ct, 7), 64)
    ksw = SpmdKeySwitch(params, ct.level, mesh)
    return _result(ctx, ksw.rotate(ct, 7, ctx.keygen), 64, ksw.switches)


def expect_keyswitch(n):
    return np.roll(np.linspace(-1, 1, n // 2), -7)[:64], 1e-2


CONV_TAPS = ((0, 0.25), (1, -0.5), (8, 0.125))  # (rotation, weight)


def conv_slice(ctx, ct):
    """The dry run's conv slice on ct: the CONV_TAPS MAC, rescale,
    square, rescale, square, rescale (chip_smoke.py's phase 9a runs it
    too)."""
    ev, enc = ctx.evaluator, ctx.encoder
    acc = None
    for r, wv in CONV_TAPS:
        term = ev.rotate(ct, r) if r else ct
        pl = enc.encode(np.full(ctx.params.degree // 2, wv, np.complex128),
                        level=ct.level)
        term = ev.mul_plain(term, pl)
        acc = term if acc is None else ev.add(acc, term)
    acc = ev.rescale(acc)
    sq = ev.rescale(ev.mul(acc, acc))
    return ev.rescale(ev.mul(sq, sq))


def conv_plain(img):
    """conv_slice's plain values."""
    return sum(wv * np.roll(img, -r) for r, wv in CONV_TAPS) ** 4


def phase_conv(n, digits, device, mesh=None) -> dict:
    """The dry run's phase 3: conv_slice at the top of the chain."""
    ctx = _ctx(_params(n, 8, digits, 32, device), 9, mesh)
    ct = ctx.prepare_input(np.linspace(-1, 1, n // 2), "x")
    return _result(ctx, conv_slice(ctx, ct), 64, _switches(ctx))


def expect_conv(n):
    return conv_plain(np.linspace(-1, 1, n // 2))[:64], 1e-2


BOOT_MSG = np.linspace(-0.4, 0.4, 64)


def phase_bootstrap(n, digits, device, mesh=None) -> dict:
    """The dry run's phase 4: a bootstrap from level 2."""
    ctx = _ctx(_params(n, 19, digits, 192, device), 11, mesh)
    ev = ctx.evaluator
    ct = ctx.prepare_input(BOOT_MSG, "x", level=2)
    ct = ev.rescale(ev.mul_const(ct, 1.0))
    return _result(ctx, ctx.bootstrap(ct), 64, _switches(ctx))


def expect_bootstrap(n):
    return BOOT_MSG, 2e-2


def tiny_resnet():
    """The dry run's phase-5 graph (seeded weights) and image."""
    from ace_tpu_torch.compiler.onnx_front import NNGraph, NNOp
    rng = np.random.default_rng(3)
    c, hw, classes = 2, 8, 4
    w1 = rng.normal(0, 0.3, (c, c, 3, 3))
    b1 = rng.normal(0, 0.05, c)
    w2 = rng.normal(0, 0.3, (c, c, 3, 3))
    b2 = rng.normal(0, 0.05, c)
    fcw = rng.normal(0, 0.5, (classes, c))
    conv = {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1], "strides": [1, 1],
            "group": 1, "dilations": [1, 1]}
    sh = (1, c, hw, hw)
    ops = [
        NNOp("Conv", "/c1", ["input", "c1.w", "c1.b"], ["t1"], conv, sh, sh),
        NNOp("Relu", "/r1", ["t1"], ["t2"], {}, sh, sh),
        NNOp("Conv", "/c2", ["t2", "c2.w", "c2.b"], ["t3"], conv, sh, sh),
        NNOp("Add", "/add", ["t3", "t1"], ["t4"], {}, sh, sh),
        NNOp("GlobalAveragePool", "/gap", ["t4"], ["t5"], {}, sh,
             (1, c, 1, 1)),
        NNOp("Reshape", "/rs", ["t5", "shape"], ["t6"], {}, (1, c, 1, 1),
             (1, c)),
        NNOp("Gemm", "/fc", ["t6", "fc.w", "fc.b"], ["out"],
             {"alpha": 1.0, "beta": 1.0, "transB": 1}, (1, c), (1, classes)),
    ]
    weights = {"c1.w": w1, "c1.b": b1, "c2.w": w2, "c2.b": b2, "fc.w": fcw,
               "fc.b": np.zeros(classes),
               "shape": np.array([1, -1], dtype=np.int64)}
    g = NNGraph(ops, weights, "input", sh, "out")
    return g, rng.uniform(-0.5, 0.5, (c, hw, hw)), classes


def phase_resnet(n, digits, device, mesh=None) -> dict:
    """The dry run's phase 5: the tiny ResNet through GraphRunner."""
    from ace_tpu_torch.compiler import packing as pk
    from ace_tpu_torch.compiler.lowering import GraphRunner
    g, img, classes = tiny_resnet()
    ctx = _ctx(_params(n, 22, digits, 32, device), 13, mesh)
    runner = GraphRunner(g, pk.FheBackend(ctx.evaluator, ctx.encoder),
                         relu_range_default=2.0, relu_mul_depth=9,
                         bootstrap_before_relu=False)
    out = runner.run(ctx.prepare_input(np.asarray(img).reshape(-1), "x"))
    return _result(ctx, out, classes, _switches(ctx))


def expect_resnet(n):
    from ace_tpu_torch.models.resnet import infer_plain
    g, img, classes = tiny_resnet()
    return infer_plain(g, img, n_slots=n // 2)[:classes], None


PHASES = {
    2: ("SPMD key switch", phase_keyswitch, expect_keyswitch, 1 << 13),
    3: ("conv slice + square chain", phase_conv, expect_conv, 1 << 12),
    4: ("bootstrap", phase_bootstrap, expect_bootstrap, 1 << 12),
    5: ("tiny ResNet graph", phase_resnet, expect_resnet, 1 << 12),
}


DRY_N = 1 << 13
LIMB_PHASES = {1: "dp x limb step", "4L": "limb-mesh bootstrap"}


def _timed(mesh, k, name, n, fn) -> dict:
    """fn() on this rank with its launches, collectives and seconds;
    rank 0 prints."""
    from ace_tpu_torch.ops import read_counters, reset_counters
    reset_counters()
    mesh.reset_stats()
    t0 = time.perf_counter()
    r = fn()
    r.update(seconds=time.perf_counter() - t0, mesh=mesh.stats(),
             launches=read_counters())
    if mesh.rank == 0:
        print(f"[phase {k}] rank 0: {name} at N = {n}, level "
              f"{r['level']}: {r['seconds']:.2f} s, {r['switches']} SPMD "
              f"key switches, key bytes held {r['key_bytes']}, collectives "
              f"{json.dumps(r['mesh'])}, launches {r['launches']}",
              flush=True)
    return r


def on_rank(mesh, degree: int) -> dict:
    """Every digit x slot phase through the mesh on this rank."""
    return {k: _timed(mesh, k, name, degree or n,
                      lambda: fn(degree or n, mesh.num_digits, mesh.device,
                                 mesh))
            for k, (name, fn, _, n) in PHASES.items()}


def on_limb_rank(mesh, degree: int, batch, meta) -> dict:
    """Phases 1 and 4L through the limb mesh on this rank."""
    n1, n4 = degree or DRY_N, degree or PHASES[4][3]
    return {1: _timed(mesh, 1, LIMB_PHASES[1], n1,
                      lambda: phase_dry(n1, mesh, batch, meta)),
            "4L": _timed(mesh, "4L", LIMB_PHASES["4L"], n4,
                         lambda: phase_bootstrap(n4, DRY_PARTS, mesh.device,
                                                 mesh))}


def check(k, ref, ranks: list, degree: int) -> list:
    """Failures of phase k: residues against the single-device result
    (`ref`, or for phase 1 a list of them, one per dp row, each rank
    held to its row's), the decoded values against the plain
    expectation, and the SPMD key switches taken on the digit x slot
    world."""
    if k == 1:
        name, n = LIMB_PHASES[1], DRY_N
        expect = None
    elif k == "4L":
        name, (_, _, expect, n) = LIMB_PHASES[k], PHASES[4]
    else:
        name, _, expect, n = PHASES[k]
    bad = []
    for r, res in enumerate(ranks):
        got = res[k]
        want_r = ref[r // (len(ranks) // len(ref))] if k == 1 else ref
        if not (np.array_equal(got["c0"], want_r["c0"])
                and np.array_equal(got["c1"], want_r["c1"])):
            bad.append(f"phase {k} ({name}): rank {r} differs from the "
                       f"single-device result")
        if k not in LIMB_PHASES and got["switches"] <= 0:
            bad.append(f"phase {k} ({name}): rank {r} took no SPMD key "
                       f"switch")
    if k == 1:
        n = degree or n
        errs = []
        for i, (row, m) in enumerate(zip(ref, dry_messages(n, len(ref)))):
            want = (0.5 * (np.roll(m, -1) + m))[:64]
            errs.append(float(np.max(np.abs(row["decoded"] - want))))
        if not max(errs) <= 1e-2:
            bad.append(f"phase 1 ({name}): decode errors {errs} > 1e-2")
        print(f"[phase 1] {name}: {len(ranks)} ranks, each dp row == the "
              f"single-device step on its message (level "
              f"{ref[0]['level']}, {ref[0]['seconds']:.2f} s alone); max "
              f"decode errors {errs} (limit 1e-2)", flush=True)
        return bad
    want, tol = expect(degree or n)
    dec = ranks[0][k]["decoded"]
    err = float(np.max(np.abs(dec - want)))
    if tol is None and int(np.argmax(dec)) != int(np.argmax(want)):
        bad.append(f"phase {k} ({name}): argmax {np.argmax(dec)} != plain "
                   f"{np.argmax(want)}")
    if tol is not None and not err <= tol:
        bad.append(f"phase {k} ({name}): decodes with error {err} > {tol}")
    print(f"[phase {k}] {name}: {len(ranks)} ranks == single-device "
          f"(level {ref['level']}, {ref['seconds']:.2f} s alone); max "
          f"decode error {err:.3e}" + (f" (limit {tol})" if tol else
                                       " (argmax checked)"), flush=True)
    return bad


def _device(device):
    import torch
    from ace_tpu_torch import resolve_device
    from ace_tpu_torch.ops import kernels
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels.build_all()  # once, before the ranks load the libraries
        if dev.index is None:
            dev = torch.device("cuda", 0)
    return dev


def _seconds(fn, *args) -> dict:
    t1 = time.perf_counter()
    r = fn(*args)
    r["seconds"] = time.perf_counter() - t1
    return r


def run(digits: int, slots: int, backend: str, device, degree: int = 0
        ) -> dict:
    """The digit x slot world runs phases 2-5 through its mesh, then the
    parent the single-device references; raises AssertionError listing
    every failure."""
    from ace_tpu_torch.ops import kernels
    from ace_tpu_torch.parallel.mesh import file_rendezvous, run_world
    dev = _device(device)
    t0 = time.perf_counter()
    with file_rendezvous(kernels.build_dir()) as rdv:
        ranks = run_world(on_rank, digits, slots, backend, str(dev), rdv,
                          (degree,))
    refs = {k: _seconds(fn, degree or n, digits, dev)
            for k, (_, fn, _, n) in PHASES.items()}
    bad = []
    for k in PHASES:
        bad += check(k, refs[k], ranks, degree)
    if bad:
        raise AssertionError("\n".join(bad))
    return {"ranks": ranks, "refs": refs,
            "seconds": time.perf_counter() - t0}


def run_limb(n_dp: int, n_limb: int, backend: str, device, degree: int = 0
             ) -> dict:
    """Phase 1's batch from the parent, then the dp x limb world runs
    phases 1 and 4L through its mesh and the parent phase 4L's
    single-device reference; raises AssertionError listing every
    failure."""
    from ace_tpu_torch.ops import kernels
    from ace_tpu_torch.parallel.mesh import (DP_LIMB, file_rendezvous,
                                             run_world)
    dev = _device(device)
    t0 = time.perf_counter()
    dry = _seconds(dry_batch, degree or DRY_N, n_dp, dev)
    for row in dry["rows"]:
        row["seconds"] = dry["seconds"]  # the batch's, keys included
    with file_rendezvous(kernels.build_dir()) as rdv:
        ranks = run_world(on_limb_rank, n_dp, n_limb, backend, str(dev), rdv,
                          (degree, dry["batch"], dry["meta"]), axes=DP_LIMB)
    refs = {1: dry["rows"],
            "4L": _seconds(phase_bootstrap, degree or PHASES[4][3],
                           DRY_PARTS, dev)}
    bad = []
    for k in LIMB_PHASES:
        bad += check(k, refs[k], ranks, degree)
    if bad:
        raise AssertionError("\n".join(bad))
    return {"ranks": ranks, "refs": refs,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--digits", type=int, default=None,
                    help="digit x slot world (2 x 2 when no world is named)")
    ap.add_argument("--slots", type=int, default=None)
    ap.add_argument("--dp", type=int, default=None, help="dp x limb world")
    ap.add_argument("--limb", type=int, default=None)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:0); cpu for the plain "
                         "versions")
    ap.add_argument("--degree", type=int, default=0,
                    help="ring degree of every phase (0: their own)")
    a = ap.parse_args(argv)
    limb = a.dp is not None or a.limb is not None
    digit = a.digits is not None or a.slots is not None or not limb
    summary = {"backend": a.backend}
    try:
        worlds = []
        if limb:
            worlds.append(("limb", {"dp": a.dp or 1, "limb": a.limb or 1},
                           run_limb(a.dp or 1, a.limb or 1, a.backend,
                                    a.device, a.degree)))
        if digit:
            d, s = a.digits or 2, a.slots or 2
            worlds.append(("digit", {"digits": d, "slots": s},
                           run(d, s, a.backend, a.device, a.degree)))
    except Exception:  # noqa: BLE001 — any failure fails the run
        import traceback
        traceback.print_exc()
        return 1
    for name, shape, res in worlds:
        world = dict(shape, seconds=res["seconds"], phases={
            str(k): {"seconds": v["seconds"], "switches": v["switches"],
                     "key_bytes": v["key_bytes"], **v["mesh"]}
            for k, v in res["ranks"][0].items()})
        # the digit x slot world's keys at the top, as before the limb world
        summary.update(world) if name == "digit" else \
            summary.update(limb_world=world)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
