#!/usr/bin/env python3
"""Render RESULTS_TORCH.md from the port's committed result files — the
counterpart of scripts/report.py for ace_tpu_torch.

    python3 scripts/torch_report.py [--out RESULTS_TORCH.md]

Reads results/torch_<model>.json (the rows of scripts/torch_zoo.py and
run_resnet_torch.py: one per image, each with its `card`, the card's
name and power limit as nvidia-smi gives them, its
`max_memory_allocated` and, where recorded, its `max_memory_reserved`,
which counts the graph pool too), results/torch_accuracy_*.json (the summaries
of scripts/torch_accuracy.py and the zoo) and
results/torch_bench_micro_*.json (bench_micro_torch.py's op times, one
table per file beside its `card`, as scripts/report.py renders
bench_micro.py's). Every time and memory figure
stands in a row beside the card it was measured on. The reference column
is the ACE reference binary's seconds per image on one thread of a Xeon
8369B CPU (scripts/ace_pre.log, as scripts/report.py has them).
RESULTS.md, rendered by scripts/report.py, stays the JAX package's.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the ACE reference binary, seconds per image on one Xeon 8369B thread
REF_SECONDS = {
    "resnet20_cifar10": 1453.96,
    "resnet32_cifar10": 2259.27,
    "resnet32_cifar100": 2327.27,
    "resnet44_cifar10": 3044.98,
    "resnet56_cifar10": 3907.68,
    "resnet110_cifar10": 7531.12,
}
GIB = 2 ** 30


def _load(path):
    with open(path) as f:
        return json.load(f)


def _gib(b) -> str:
    return f"{b / GIB:.2f}" if b else "-"


def _params(p) -> str:
    if not isinstance(p, dict) or not p.get("N"):
        return "-"
    return f"N=2^{p['N'].bit_length() - 1} L={p['L']}"


def latency_rows(root: str = ROOT) -> list:
    """One row per (model, card) of results/torch_<model>.json."""
    rows = []
    for path in sorted(glob.glob(os.path.join(root, "results", "torch_*.json"))):
        name = os.path.splitext(os.path.basename(path))[0][len("torch_"):]
        if name.startswith(("accuracy_", "bench_micro_")):
            continue
        data = _load(path)
        if not isinstance(data, list):
            continue
        by_card = {}
        for r in data:
            if "seconds" in r:
                by_card.setdefault(r.get("card") or "card not recorded",
                                   []).append(r)
        for card, rs in by_card.items():
            secs = [r["seconds"] for r in rs]
            rows.append({
                "model": name, "card": card, "images": len(rs),
                "best": min(secs), "mean": sum(secs) / len(secs),
                "agree": sum(1 for r in rs if r.get("argmax_agree")),
                "max_err": max(r.get("max_err", 0.0) for r in rs),
                "params": _params(next((r["params"] for r in rs
                                        if r.get("params")), None)),
                "peak": max(r.get("max_memory_allocated") or 0 for r in rs),
                "reserved": max(r.get("max_memory_reserved") or 0
                                for r in rs),
                "ref": REF_SECONDS.get(name)})
    return rows


def accuracy_rows(root: str = ROOT) -> list:
    """One row per results/torch_accuracy_*.json."""
    rows = []
    for path in sorted(glob.glob(os.path.join(
            root, "results", "torch_accuracy_*.json"))):
        d = _load(path)
        secs = [r["seconds"] for r in d.get("per_image", [])
                if "seconds" in r]
        rows.append({
            "file": os.path.basename(path), "model": d["model"],
            "relu_depth": d.get("relu_depth", "-"), "images": d["images"],
            "agree": d["agree"], "max_err": d["max_err"],
            "gates_failed": d.get("gates_failed"),
            "seconds": sum(secs) / len(secs) if secs else None,
            "card": d.get("card") or "card not recorded",
            "peak": d.get("max_memory_allocated")})
    return rows


def micro_tables(root: str = ROOT) -> list:
    """One (file, summary) per results/torch_bench_micro_*.json."""
    out = []
    for path in sorted(glob.glob(os.path.join(
            root, "results", "torch_bench_micro_*.json"))):
        d = _load(path)
        if isinstance(d, dict) and d.get("seconds"):
            out.append((os.path.basename(path), d))
    return out


def render(root: str = ROOT) -> str:
    lines = ["# Results of the PyTorch/CUDA port", "",
             "Rendered by `scripts/torch_report.py` from `results/torch_*.json`."
             " Each row names the card it ran on (name, power limit).", ""]
    lat = latency_rows(root)
    if lat:
        lines += ["## Encrypted inference latency", "",
                  "| model | card | images | best s/img | mean s/img "
                  "| argmax agree | max err | params | peak device memory "
                  "GiB (allocated) | peak reserved GiB (graph pool "
                  "included) | ACE reference s/img (1-thread Xeon 8369B "
                  "CPU) | reference / best |",
                  "|---|---|---|---|---|---|---|---|---|---|---|---|"]
        for r in lat:
            ref = f"{r['ref']:.2f}" if r["ref"] else "-"
            ratio = f"{r['ref'] / r['best']:.1f}x" if r["ref"] else "-"
            lines.append(
                f"| {r['model']} | {r['card']} | {r['images']} "
                f"| {r['best']:.1f} | {r['mean']:.1f} "
                f"| {r['agree']}/{r['images']} | {r['max_err']:.4f} "
                f"| {r['params']} | {_gib(r['peak'])} "
                f"| {_gib(r['reserved'])} | {ref} | {ratio} |")
        lines.append("")
    acc = accuracy_rows(root)
    if acc:
        lines += ["## Encrypted-vs-plain agreement", "",
                  "| file | model | relu depth | images | argmax agreement "
                  "| max err | gates failed | card | mean s/img "
                  "| peak device memory GiB |",
                  "|---|---|---|---|---|---|---|---|---|---|"]
        for r in acc:
            gates = ("-" if r["gates_failed"] is None
                     else ", ".join(r["gates_failed"]) or "none")
            secs = f"{r['seconds']:.1f}" if r["seconds"] else "-"
            lines.append(
                f"| {r['file']} | {r['model']} | {r['relu_depth']} "
                f"| {r['images']} | {r['agree']}/{r['images']} "
                f"| {r['max_err']:.4f} | {gates} | {r['card']} | {secs} "
                f"| {_gib(r['peak'])} |")
        lines.append("")
    micro = micro_tables(root)
    for fname, d in micro:
        card = d.get("card") or "card not recorded"
        lines += [f"## Op microbenchmarks (bench_micro_torch.py): "
                  f"N={d.get('degree')} num_q={d.get('num_q')} "
                  f"({d.get('first_mod_size')}/{d.get('scaling_mod_size')}"
                  f"-bit primes), {d.get('iters')} iterations", "",
                  "| file | card | op | ms | ops/s |",
                  "|---|---|---|---|---|"]
        for op, sec in d["seconds"].items():
            lines.append(f"| {fname} | {card} | {op} | {sec * 1e3:.3f} "
                         f"| {1.0 / sec:.1f} |")
        if d.get("key_switches_per_s"):
            lines.append(f"| {fname} | {card} | (key switches/s) | - "
                         f"| {d['key_switches_per_s']} |")
        lines.append("")
    if not lat and not acc and not micro:
        lines.append("(no result files: run scripts/torch_zoo.py or "
                     "scripts/torch_accuracy.py first)")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "RESULTS_TORCH.md"))
    a = ap.parse_args(argv)
    text = render()
    with open(a.out, "w") as f:
        f.write(text)
    print(text, end="")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
