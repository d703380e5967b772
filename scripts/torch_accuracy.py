"""Encrypted-vs-plain agreement harness through the PyTorch port
(ace_tpu_torch) — the counterpart of scripts/accuracy.py.

Runs N images through both the packed-plain oracle and the encrypted
path and records argmax agreement and the max logit error. Inputs are
synthetic, default_rng(1).uniform(-1.5, 1.5), unless --cifar gives a
CIFAR batch file, in which case label accuracy is also recorded. The
ReLU ranges are a uniform --relu-range widened for the actual inputs.
The file is rewritten after every image, so an interrupted run still
reports; it holds accuracy.py's keys plus the ReLU settings
(`relu_depth`, `relu_range`), the card's `name, power.limit` (`card`)
and the process's peak device memory (`max_memory_allocated`), and each
row also the image's run counters (`stats`, see scripts/torch_zoo.py).
scripts/torch_zoo.py writes its summary to the same default path, so an
existing file that records other ReLU settings is not replaced: the run
stops before it starts and asks for another --out.

Usage:
  python scripts/torch_accuracy.py --model resnet20_cifar10 --images 10 \
      [--cifar batch.bin] [--relu-depth 13] [--relu-range 16] \
      [--out results/torch_accuracy_<model>.json] [--device cpu]

--device defaults to the CUDA card and fails without one; --device cpu
runs the plain PyTorch versions of the kernels.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from ace_tpu_torch.utils.scripts import load_script  # noqa: E402

Z = load_script("torch_zoo")

ROW_KEYS = ("image", "seconds", "max_err", "argmax_agree", "card",
            "max_memory_allocated", "stats")


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet20_cifar10")
    ap.add_argument("--images", type=int, default=10)
    ap.add_argument("--cifar", default="")
    ap.add_argument("--relu-depth", type=int, default=13)
    ap.add_argument("--relu-range", type=float, default=16.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def run_accuracy(name, graph, imgs, labels, path, relu_depth=13,
                 relu_range=16.0, device=None, trace=None,
                 **scheme) -> dict:
    """Calibrate the ranges on `imgs`, compile `graph` on its own context
    and run every image encrypted and plain, rewriting `path` after each
    image. `scheme` goes to torch_zoo.cfg_for (the scheme's sizes).
    Refuses to replace a file at `path` that records other ReLU settings
    (torch_zoo.py's summary shares the default path). Returns the file's
    contents."""
    from ace_tpu_torch.compiler.scheme_info import select_params

    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
        had = (old.get("relu_depth"), old.get("relu_range"))
        if had != (relu_depth, relu_range):
            raise FileExistsError(
                f"{path} holds a run at relu depth, range {had}, not "
                f"{(relu_depth, relu_range)}: give another --out")
    classes = Z.classes_of(name)
    cfg = Z.cfg_for(name, graph, imgs, relu_depth=relu_depth,
                    relu_range=relu_range, **scheme)
    _, ctx = Z.shared_context({name: select_params(graph, cfg)},
                              device=device)

    def result(rows):
        out = dict(model=name, images=len(rows),
                   agree=sum(r["argmax_agree"] for r in rows),
                   max_err=max(r["max_err"] for r in rows),
                   per_image=[{k: r[k] for k in ROW_KEYS} for r in rows],
                   synthetic=labels is None, relu_depth=relu_depth,
                   relu_range=relu_range, card=rows[-1]["card"],
                   max_memory_allocated=rows[-1]["max_memory_allocated"])
        if labels is not None:
            for r in out["per_image"]:
                r["label"] = int(labels[r["image"]])
        return out

    def flush(rows):
        row = rows[-1]
        print(f"image {row['image']}: agree={row['argmax_agree']} "
              f"err={row['max_err']:.3e} ({row['seconds']:.1f}s)",
              flush=True)
        Z.write_json(path, result(rows), indent=1)

    rows = Z.run_model(name, graph, cfg, ctx, imgs, classes, trace=trace,
                       on_row=flush)
    out = result(rows)
    if labels is not None:
        for key, which in (("accuracy_encrypted", "argmax"),
                           ("accuracy_plain", "plain_argmax")):
            out[key] = sum(r["stats"][which] == labels[r["image"]]
                           for r in rows) / len(rows)
        Z.write_json(path, out, indent=1)
    return out


def main(argv=None):
    args = parse_args(argv)
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.runtime.timing import TIMING

    TIMING.enabled = True
    g = M.load_model(args.model)
    if args.cifar:
        imgs, labels = M.read_cifar_batch(args.cifar, args.images,
                                          Z.classes_of(args.model))
    else:
        imgs, labels = Z.zoo_images(args.images), None
    path = args.out or os.path.join(
        ROOT, "results", f"torch_accuracy_{args.model}.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    out = run_accuracy(
        args.model, g, imgs, labels, path, device=args.device,
        trace=lambda m: print(f"# {m}", file=sys.stderr, flush=True),
        relu_depth=args.relu_depth, relu_range=args.relu_range)
    print(f"agreement {out['agree']}/{out['images']}, max_err "
          f"{out['max_err']:.3e} -> {path}")


if __name__ == "__main__":
    main()
