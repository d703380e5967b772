#!/usr/bin/env python3
"""The port's digit x slot SPMD key switch through the model path, on a
world of ranks: ace_tpu's __graft_entry__.dryrun_multichip phases 2-5 on
torch.distributed, at their own sizes, each held bit-exact against the
single-device port.

    python3 scripts/torch_multichip.py --digits 3 --slots 2
        [--backend gloo|nccl] [--device cuda:0|cpu] [--degree N]

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
(a rehearsal on the CPU: --degree 1024). Phase 1 of the dry run (dp x
limb under GSPMD) has no counterpart yet.
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
    from ace_tpu_torch.runtime.context import FheContext
    return FheContext(params, seed=seed, digit_mesh=mesh)


def _result(ctx, out, length, switches=0):
    from ace_tpu_torch.ops import modops
    ctx.set_output_data("y", out)
    return {"c0": modops.to_numpy(out.c0.data),
            "c1": modops.to_numpy(out.c1.data),
            "decoded": ctx.handle_output("y", length), "level": out.level,
            "switches": switches}


def _switches(ctx) -> int:
    return getattr(ctx.evaluator, "spmd_switches", 0)


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


def on_rank(mesh, degree: int) -> dict:
    """Every phase through the mesh on this rank; rank 0 prints."""
    from ace_tpu_torch.ops import read_counters, reset_counters
    out = {}
    for k, (name, fn, _, n) in PHASES.items():
        reset_counters()
        mesh.reset_stats()
        t0 = time.perf_counter()
        r = fn(degree or n, mesh.num_digits, mesh.device, mesh)
        r.update(seconds=time.perf_counter() - t0, mesh=mesh.stats(),
                 launches=read_counters())
        out[k] = r
        if mesh.rank == 0:
            print(f"[phase {k}] rank 0: {name} at N = {degree or n}, "
                  f"level {r['level']}: {r['seconds']:.2f} s, "
                  f"{r['switches']} SPMD key switches, collectives "
                  f"{json.dumps(r['mesh'])}, launches {r['launches']}",
                  flush=True)
    return out


def check(k: int, ref: dict, ranks: list, degree: int) -> list:
    """Failures of phase k: residues against the single-device result,
    the decoded values against the plain expectation, and the SPMD key
    switches taken."""
    name, _, expect, n = PHASES[k]
    bad = []
    for r, res in enumerate(ranks):
        got = res[k]
        if not (np.array_equal(got["c0"], ref["c0"])
                and np.array_equal(got["c1"], ref["c1"])):
            bad.append(f"phase {k} ({name}): rank {r} differs from the "
                       f"single-device result")
        if got["switches"] <= 0:
            bad.append(f"phase {k} ({name}): rank {r} took no SPMD key "
                       f"switch")
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


def run(digits: int, slots: int, backend: str, device, degree: int = 0
        ) -> dict:
    """The world runs the mesh versions, then the parent the single-device
    references; raises AssertionError listing every failure."""
    import torch
    from ace_tpu_torch import resolve_device
    from ace_tpu_torch.ops import kernels
    from ace_tpu_torch.parallel.mesh import file_rendezvous, run_world
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels.build_all()  # once, before the ranks load the libraries
        if dev.index is None:
            dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    with file_rendezvous(kernels.build_dir()) as rdv:
        ranks = run_world(on_rank, digits, slots, backend, str(dev), rdv,
                          (degree,))
    refs = {}
    for k, (_, fn, _, n) in PHASES.items():
        t1 = time.perf_counter()
        refs[k] = fn(degree or n, digits, dev)
        refs[k]["seconds"] = time.perf_counter() - t1
    bad = []
    for k in PHASES:
        bad += check(k, refs[k], ranks, degree)
    if bad:
        raise AssertionError("\n".join(bad))
    return {"ranks": ranks, "refs": refs,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--digits", type=int, default=2)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default=None,
                    help="default: the card (cuda:0); cpu for the plain "
                         "versions")
    ap.add_argument("--degree", type=int, default=0,
                    help="ring degree of every phase (0: their own)")
    a = ap.parse_args(argv)
    try:
        res = run(a.digits, a.slots, a.backend, a.device, a.degree)
    except Exception:  # noqa: BLE001 — any failure fails the run
        import traceback
        traceback.print_exc()
        return 1
    r0 = res["ranks"][0]
    print(json.dumps({"digits": a.digits, "slots": a.slots,
                      "backend": a.backend, "seconds": res["seconds"],
                      "phases": {k: {"seconds": v["seconds"],
                                     "switches": v["switches"],
                                     **v["mesh"]} for k, v in r0.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
