"""The composite-sign ReLU's share of an encrypted model's error, on the
CPU in seconds.

Runs a zoo model's plain packed-slot inference twice: with exact ReLUs
(infer_plain) and with every ReLU replaced by the polynomial the
encrypted path evaluates (ckks/relu.py: relu(x) = x * (sign(x / range)
+ 1) / 2 with the composite sign of SIGN_TABLES at the relu depth, at
each ReLU's range), with no encryption, noise or bootstrap. The
difference between the two is the approximation's error alone; an
encrypted run whose max_err matches it carries no other error of note.
The ranges come from scripts/torch_zoo.py's cfg_for on the zoo's
synthetic images: --relu-range 0 takes the model's tuned ranges as
scripts/torch_zoo.py does, --relu-range 16 the uniform range of
scripts/torch_accuracy.py; both are widened on the images.

Usage:
  python3 scripts/torch_relu_error.py [--model resnet110_cifar10]
      [--images 1] [--relu-depth 9] [--relu-range 0]
"""

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def approx_relu(v, value_range: float, mul_depth: int):
    """ckks/relu.py's relu on plain values: the sign stages' Chebyshev
    series (their constant terms are 0, so the doubled-c0 contract of
    eval_chebyshev changes nothing) at x / range."""
    from numpy.polynomial import chebyshev as C
    from ace_tpu_torch.ckks.relu import SIGN_TABLES
    y = v / value_range
    for coeffs in SIGN_TABLES[mul_depth]:
        y = C.chebval(y, np.asarray(coeffs, np.float64))
    return v * 0.5 * (y + 1.0)


def approx_logits(graph, cfg, image, n_slots: int = 1 << 14):
    """Plain inference of `graph` with cfg's approximate ReLUs."""
    from ace_tpu_torch.compiler import packing as pk
    from ace_tpu_torch.compiler.lowering import GraphRunner

    class ApproxBackend(pk.PlainBackend):
        def relu(self, v, value_range=3.0, mul_depth=13, bootstrap=False):
            return approx_relu(v, value_range, mul_depth)

    be = ApproxBackend(n_slots)
    runner = GraphRunner(graph, be, relu_ranges=cfg.relu_ranges,
                         relu_range_default=cfg.relu_value_range,
                         relu_mul_depth=cfg.relu_mul_depth)
    return runner.run(be.pack(np.asarray(image).reshape(-1)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="resnet110_cifar10")
    ap.add_argument("--images", type=int, default=1)
    ap.add_argument("--relu-depth", type=int, default=9)
    ap.add_argument("--relu-range", type=float, default=0.0)
    args = ap.parse_args(argv)
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.utils.scripts import load_script

    Z = load_script("torch_zoo")

    g = M.load_model(args.model)
    classes = Z.classes_of(args.model)
    imgs = Z.zoo_images(args.images)
    cfg = Z.cfg_for(args.model, g, imgs, relu_depth=args.relu_depth,
                    relu_range=args.relu_range)
    for i, img in enumerate(imgs):
        plain = M.infer_plain(g, img)[:classes]
        approx = approx_logits(g, cfg, img)[:classes]
        print(f"{args.model} image {i} relu depth {args.relu_depth} range "
              f"{args.relu_range or 'tuned'}: max_err "
              f"{float(np.max(np.abs(approx - plain))):.10e} of max|plain| "
              f"{float(np.max(np.abs(plain))):.4f}; argmax "
              f"{int(np.argmax(approx))} (plain {int(np.argmax(plain))})",
              flush=True)


if __name__ == "__main__":
    main()
