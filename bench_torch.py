#!/usr/bin/env python3
"""Headline benchmark of the PyTorch port (ace_tpu_torch), the counterpart
of bench.py.

    python3 bench_torch.py [--ntt] [--device cpu]

Prints ONE JSON line on stdout, in bench.py's schema:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}
and everything else (the card's `name, power.limit`, pass times) on
stderr.

Default: encrypted ResNet-20 seconds per image on this card, the median
of the steady-state images (every image after image 0, which makes the
keys and the bootstrap tables) in results/torch_resnet20_cifar10.json,
the rows of `python3 run_resnet_torch.py --images 3 --json
results/torch_resnet20_cifar10.json`. Every row must record this card's
name (its `card`); a file that does not is refused. vs_baseline = the
ACE reference binary's 1453.96 s/image on one Xeon thread / ours. The
rows' op-program counts (programs, capture seconds, graph-pool bytes)
go to stderr.

--ntt: the negacyclic NTT at N = 2^16 over 8 limbs of
generate_q_primes(8, 60, 56, N), data from default_rng(0), through
ops.ntt.ntt_fwd (kernel K3 on the card). Calls are chained (each output
is the next input), 30 to a pass, the card synchronized once per pass;
the value is the median of 3 passes in limb-NTTs per second.
vs_baseline divides it by the port's single-thread C NTT
(ace_tpu_torch/native/ckks_core.c) at q0 = gen_first_prime(N, 56) on
this host.

--device defaults to the card and raises without one; --device cpu runs
the plain PyTorch version (for the tests, with a small --degree).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N = 1 << 16
LIMBS = 8          # limbs per call
STEADY_ITERS = 30  # chained calls per pass
PASSES = 3
CPU_ITERS = 20

RESNET20_BASELINE_S = 1453.96  # scripts/ace_pre.log:28 (Xeon, 1 thread)
RESULT_JSON = os.path.join(ROOT, "results", "torch_resnet20_cifar10.json")


def err(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def ntt_inputs(degree: int = N, limbs: int = LIMBS, device=None):
    """bench.py's primes, tables and data: (primes, tables, x [limbs,
    degree] on `device`)."""
    from ace_tpu_torch.ops import modops, ntt
    from ace_tpu_torch.utils import number_theory as nt
    primes = nt.generate_q_primes(limbs, 60, 56, degree)
    tables = ntt.make_ntt_tables(primes, degree, device)
    rng = np.random.default_rng(0)
    data = np.stack([rng.integers(0, q, size=degree, dtype=np.uint64)
                     for q in primes])
    return primes, tables, modops.to_torch(data, device)


def chain(x, tables, links: int = STEADY_ITERS):
    """`links` forward NTTs, each on the previous one's output."""
    from ace_tpu_torch.ops import ntt
    r = x
    for _ in range(links):
        r = ntt.ntt_fwd(r, tables)
    return r


def bench_device(degree: int = N, limbs: int = LIMBS, device=None) -> dict:
    """NTT/s of the chained passes: the median of PASSES host-clock
    passes (`ntt_per_s`, each `rates`), plus one pass between CUDA
    events on the card (`pass_event_ms`, None on the CPU)."""
    import torch
    from ace_tpu_torch import resolve_device
    from ace_tpu_torch.utils.card import syncer
    dev = resolve_device(device)
    gpu = dev.type == "cuda"
    sync = syncer(dev)
    _, tables, x = ntt_inputs(degree, limbs, dev)
    chain(x, tables, 1)  # builds and loads the kernel
    sync()
    rates = []
    for _ in range(PASSES):
        t0 = time.perf_counter()
        chain(x, tables)
        sync()
        dt = (time.perf_counter() - t0) / STEADY_ITERS
        rates.append(limbs / dt)
    event_ms = None
    if gpu:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        chain(x, tables)
        b.record()
        b.synchronize()
        event_ms = a.elapsed_time(b)
    return {"ntt_per_s": statistics.median(rates), "rates": rates,
            "pass_event_ms": event_ms}


def bench_cpu_baseline(degree: int = N) -> dict:
    """Single-thread C NTT/s at q0 = gen_first_prime(degree, 56), data
    default_rng(1), the mean over CPU_ITERS transforms of a copy each."""
    from ace_tpu_torch.ops import modops, native, ntt
    from ace_tpu_torch.utils import number_theory as nt
    q = nt.gen_first_prime(degree, 56)
    t = ntt.make_ntt_tables([q], degree, "cpu")
    rou = modops.to_numpy(t.rou)[0].copy()
    rou_prec = modops.to_numpy(t.rou_prec)[0].copy()
    data = np.random.default_rng(1).integers(0, q, size=degree,
                                             dtype=np.uint64)
    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    native.ntt_fwd_inplace(data.copy(), rou, rou_prec, q)  # warm
    t0 = time.perf_counter()
    for _ in range(CPU_ITERS):
        native.ntt_fwd_inplace(data.copy(), rou, rou_prec, q)
    dt = (time.perf_counter() - t0) / CPU_ITERS
    return {"ntt_per_s": 1.0 / dt, "ms": dt * 1e3, "q0": q,
            "build_s": build_s}


def ntt_metric(device_rate: float, cpu_rate: float) -> dict:
    return {"metric": "ntt_2^16_per_s_per_chip",
            "value": round(device_rate, 2), "unit": "ntt/s",
            "vs_baseline": round(device_rate / cpu_rate, 3)}


def card_name(card: str) -> str:
    """The name in nvidia-smi's `name, power.limit`."""
    return card.rsplit(",", 1)[0].strip()


def resnet20_metric(rows: list, card: str) -> dict:
    """bench.py's ResNet-20 line from run_resnet_torch.py's rows: the
    median steady-state image (images after image 0; image 0 alone when
    it is the only one). Raises ValueError when the rows are empty or a
    row does not record `card`'s name."""
    if not rows:
        raise ValueError("no images in the result rows")
    want = card_name(card)
    other = sorted({str(r.get("card")) for r in rows
                    if not r.get("card") or card_name(r["card"]) != want})
    if other:
        raise ValueError(f"rows record {other}, not the present card "
                         f"{want!r}: measure again on this card")
    rows = sorted(rows, key=lambda r: r["image"])
    steady = rows[1:] if len(rows) > 1 else rows
    secs = sorted(r["seconds"] for r in steady)
    s_img = secs[len(secs) // 2]
    return {"metric": "resnet20_cifar10_encrypted_s_per_image",
            "value": round(s_img, 2), "unit": "s/image",
            "vs_baseline": round(RESNET20_BASELINE_S / s_img, 2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ntt", action="store_true",
                    help="NTT(2^16) throughput against the C baseline")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--degree", type=int, default=N, help="tests only")
    a = ap.parse_args(argv)

    from ace_tpu_torch import resolve_device
    from ace_tpu_torch.utils.card import card
    dev = resolve_device(a.device)
    here = card() if dev.type == "cuda" else None
    err(f"# device {dev}: {here or 'no card (plain PyTorch versions)'}")
    if not a.ntt:
        if here is None:
            raise SystemExit("the ResNet-20 figure is a card's: run on the "
                             "card, or give --ntt")
        with open(RESULT_JSON) as f:
            rows = json.load(f)
        line = resnet20_metric(rows, here)
        err(f"# {RESULT_JSON}: median steady-state image on {here}")
        for r in sorted(rows, key=lambda r: r["image"]):
            err(f"# image {r['image']}: {r['seconds']:.2f} s, op programs "
                f"{r.get('programs', 'not recorded')}")
        print(json.dumps(line))
        return 0
    cpu = bench_cpu_baseline(a.degree)
    err(f"# CPU baseline: one-thread C NTT at N = {a.degree}, q0 = "
        f"{cpu['q0']}: {cpu['ms']:.4f} ms = {cpu['ntt_per_s']:.1f} NTT/s "
        f"(library load/build {cpu['build_s']:.2f} s)")
    d = bench_device(a.degree, LIMBS, dev)
    ev = (f"; one pass between CUDA events {d['pass_event_ms']:.4f} ms = "
          f"{d['pass_event_ms'] / STEADY_ITERS * 1e3:.2f} us a call"
          if d["pass_event_ms"] is not None else "")
    err(f"# [{LIMBS}, {a.degree}] x {STEADY_ITERS} chained calls: "
        f"passes {[round(r, 1) for r in d['rates']]} NTT/s{ev}")
    print(json.dumps(ntt_metric(d["ntt_per_s"], cpu["ntt_per_s"])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
