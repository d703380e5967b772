#!/usr/bin/env python3
"""CKKS op-level microbenchmarks of the PyTorch port (ace_tpu_torch), the
counterpart of bench_micro.py (the ut_ckks_perf analog).

Times add / add_plain / mul_plain / mul(+relin) / rescale / rotate /
NTT / iNTT, and with --bootstrap / --sparse-slots the full and sparse
bootstrap, at the given ring, with bench_micro.py's flags, op names,
inputs and JSON keys. The NTT ops run ops.ntt.ntt_fwd / ntt_inv over the
whole q chain (kernels K3 and K4 on the card). Each op's time is the
mean over --iters calls after 2 warm-up calls, the card synchronized
after the warm-up and after the last call.

Usage: python3 bench_micro_torch.py [--degree 65536] [--num-q 24]
           [--first-mod-size 60] [--scaling-mod-size 56] [--iters 10]
           [--bootstrap] [--sparse-slots K] [--json out.json]
           [--device cpu]

--device defaults to the card and raises without one; --device cpu runs
the plain PyTorch versions (for the tests, at a small --degree). The
JSON holds bench_micro.py's keys (`backend` is the torch device type)
plus `card`, the card's `name, power.limit` as nvidia-smi gives them
(null on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 7           # bench_micro.py's FheContext seed
HAMMING_WEIGHT = 192
BTS_LEVEL = 2      # bootstrap inputs are encrypted at this level
WARMUP = 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--degree", type=int, default=1 << 16)
    ap.add_argument("--num-q", type=int, default=24)
    ap.add_argument("--first-mod-size", type=int, default=60)
    ap.add_argument("--scaling-mod-size", type=int, default=56)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--bootstrap", action="store_true")
    ap.add_argument("--sparse-slots", type=int, default=0,
                    help="also time a sparse bootstrap at this slot "
                         "count (ut_ckks_perf times full AND sparse)")
    ap.add_argument("--json", type=str, default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def timed(fn, out_leaf, iters: int, sync, warmup: int = WARMUP) -> float:
    """Mean seconds per call of fn over `iters` calls after `warmup`
    calls; `sync` waits for the device (bench_micro.py's
    block_until_ready on out_leaf of the last result)."""
    for _ in range(warmup):
        r = fn()
    out_leaf(r)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        r = fn()
    out_leaf(r)
    sync()
    return (time.perf_counter() - t0) / iters


def make_context(degree: int, num_q: int, first_mod_size: int,
                 scaling_mod_size: int, device=None):
    """bench_micro.py's context: CkksParams at hamming weight 192 with
    the default digit count, FheContext(seed=7)."""
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.runtime.context import FheContext
    params = CkksParams(degree=degree, num_q=num_q,
                        first_mod_size=first_mod_size,
                        scaling_mod_size=scaling_mod_size,
                        hamming_weight=HAMMING_WEIGHT, device=device)
    return FheContext(params, seed=SEED)


def operands(ctx, rng) -> dict:
    """bench_micro.py's inputs: msg uniform(-1, 1) in every slot (from
    rng), two encryptions of it and its plaintext; the rotation key of 1
    made ahead."""
    ev, enc = ctx.evaluator, ctx.encoder
    msg = rng.uniform(-1, 1, ctx.params.degree // 2).astype(np.complex128)
    ops = {"msg": msg, "ct1": ev.encrypt(enc.encode(msg)),
           "ct2": ev.encrypt(enc.encode(msg)), "pt": enc.encode(msg)}
    ctx.keygen.rot_key(1)
    return ops


def c0_data(r):
    return r.c0.data


def op_table(ctx, o: dict) -> list:
    """(name, fn, out_leaf) of bench_micro.py's ops, in its order."""
    from ace_tpu_torch.ops import ntt
    from ace_tpu_torch.poly import poly as P
    ev, crt = ctx.evaluator, ctx.params.crt
    ct1, ct2, pt = o["ct1"], o["ct2"], o["pt"]
    sub = ntt.gather_tables(crt.ntt_tables, list(range(crt.num_q)))
    coeffs = P.from_ntt(ct1.c0, crt)
    same = lambda r: r  # noqa: E731
    return [
        ("add", lambda: ev.add(ct1, ct2), c0_data),
        ("add_plain", lambda: ev.add_plain(ct1, pt), c0_data),
        ("mul_plain", lambda: ev.mul_plain(ct1, pt), c0_data),
        ("mul_relin", lambda: ev.mul(ct1, ct2), c0_data),
        ("rescale", lambda: ev.rescale(ev.mul_plain(ct1, pt)), c0_data),
        ("rotate", lambda: ev.rotate(ct1, 1), c0_data),
        ("ntt_fwd", lambda: ntt.ntt_fwd(coeffs.data, sub), same),
        ("ntt_inv", lambda: ntt.ntt_inv(ct1.c0.data, sub), same),
    ]


def bootstrap_input(ctx, values, slots: int):
    """An encryption of `values` in `slots` slots at level BTS_LEVEL."""
    enc = ctx.encoder
    return ctx.evaluator.encrypt(enc.encode(values, level=BTS_LEVEL,
                                            slots=slots))


def bootstrap_cases(ctx, o: dict, rng, full: bool, sparse_slots: int):
    """(name, fn, out_leaf, input message) of the bootstraps, as
    bench_micro.py builds them: the full one of msg * 0.1 in every slot,
    the sparse one of uniform(-0.1, 0.1) in `sparse_slots` slots (from
    rng, after msg). Each fn runs bootstrap_precom (its tables, made on
    the first call) and the bootstrap."""
    cases = []
    if full:
        n_slots = ctx.params.degree // 2
        low = bootstrap_input(ctx, o["msg"] * 0.1, n_slots)
        cases.append(("bootstrap_full",
                      lambda: ctx.bootstrap_precom(n_slots).bootstrap(low),
                      c0_data, o["msg"] * 0.1))
    if sparse_slots:
        sp = sparse_slots
        sp_msg = rng.uniform(-0.1, 0.1, sp).astype(np.complex128)
        low_sp = bootstrap_input(ctx, sp_msg, sp)
        cases.append((f"bootstrap_sparse_{sp}",
                      lambda: ctx.bootstrap_precom(sp).bootstrap(low_sp),
                      c0_data, sp_msg))
    return cases


def main(argv=None) -> int:
    args = parse_args(argv)
    from ace_tpu_torch import resolve_device
    from ace_tpu_torch.utils.card import card, syncer

    dev = resolve_device(args.device)
    sync = syncer(dev)
    name_power = card() if dev.type == "cuda" else None
    print(f"# backend={dev.type} N={args.degree} num_q={args.num_q} "
          f"card={name_power}", file=sys.stderr)
    t0 = time.time()
    ctx = make_context(args.degree, args.num_q, args.first_mod_size,
                       args.scaling_mod_size, dev)
    sync()
    print(f"# context ready in {time.time() - t0:.1f}s", file=sys.stderr)

    rng = np.random.default_rng(0)
    o = operands(ctx, rng)
    results = {}

    def run(name, fn, out_leaf):
        dt = timed(fn, out_leaf, args.iters, sync)
        results[name] = dt
        print(f"{name:24s} {dt * 1e3:10.3f} ms", flush=True)

    for name, fn, leaf in op_table(ctx, o):
        run(name, fn, leaf)
    for name, fn, leaf, _ in bootstrap_cases(ctx, o, rng, args.bootstrap,
                                             args.sparse_slots):
        run(name, fn, leaf)

    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "backend": dev.type,
                "degree": args.degree, "num_q": args.num_q,
                "first_mod_size": args.first_mod_size,
                "scaling_mod_size": args.scaling_mod_size,
                "iters": args.iters,
                "seconds": results,
                "key_switches_per_s": round(1.0 / results["rotate"], 1)
                if "rotate" in results else None,
                "card": name_power,
            }, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
