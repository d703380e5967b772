"""Encrypted ResNet-20 inference through the PyTorch port (ace_tpu_torch).

The port's counterpart of run_resnet.py: build the graph -> select CKKS
parameters -> keys -> encode+encrypt the image -> run the encrypted graph
(a bootstrap before every ReLU) -> decrypt -> compare against the plain
packed-slot inference, with the runtime timing buckets at the end.

The graph is build_resnet_cifar(3) (seeded weights calibrated to the
reference's ReLU ranges); the images are synthetic,
default_rng(0).uniform(-1.5, 1.5), and the ReLU ranges are calibrated
against them as run_resnet.py does.

Usage:
  python run_resnet_torch.py [--layers K] [--images 1] [--device cpu]
      [--json out.json]

--device defaults to the CUDA card and fails without one; --device cpu
runs the plain PyTorch versions of the kernels (slow at N = 2^15: use
--layers to cut the graph).
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=0,
                    help="truncate the graph to its first K ops (0 = all)")
    ap.add_argument("--images", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", default="", help="write per-image rows here")
    args = ap.parse_args()

    os.environ.setdefault("RTLIB_TIMING_OUTPUT", "1")
    import torch
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    from ace_tpu_torch.compiler.scheme_info import SchemeConfig
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.runtime.timing import TIMING

    def trace(msg):
        print(f"# {msg}", file=sys.stderr, flush=True)

    g = M.build_resnet_cifar(3)
    if args.layers:
        g.ops = g.ops[:args.layers]
        g.output_name = g.ops[-1].outputs[0]
    imgs = np.random.default_rng(0).uniform(-1.5, 1.5,
                                            (args.images, 3, 32, 32))
    vr_default, vr = ranges_for("resnet20_cifar10")
    vr_default, vr = M.calibrate_relu_ranges(g, imgs, vr_default, vr,
                                             trace=trace)
    cfg = SchemeConfig(security_level=0, hamming_weight=192,
                       first_mod_size=60, scaling_mod_size=56,
                       relu_mul_depth=9, relu_value_range=vr_default,
                       relu_ranges=vr,
                       use_bootstrap=any(op.op_type == "Relu"
                                         for op in g.ops))
    t0 = time.time()
    model = M.compile_model(g, cfg, trace=trace, device=args.device)
    si = model.scheme
    trace(f"params: N=2^{si.poly_degree.bit_length() - 1} "
          f"L={si.mul_level} input_level={si.input_level} on "
          f"{model.ctx.device} (context {time.time() - t0:.1f}s)")

    def sync():
        if model.ctx.device.type == "cuda":
            torch.cuda.synchronize()

    results = []
    for i in range(args.images):
        plain = M.infer_plain(g, imgs[i], n_slots=si.poly_degree // 2)
        t0 = time.time()
        logits = M.infer_encrypted(model, imgs[i])
        sync()
        dt = time.time() - t0
        k = min(len(logits), len(plain))
        err = float(np.max(np.abs(logits[:k] - plain[:k])))
        agree = bool(np.argmax(logits[:k]) == np.argmax(plain[:k]))
        results.append(dict(image=i, seconds=dt, max_err=err,
                            argmax_agree=agree,
                            params=dict(N=si.poly_degree, L=si.mul_level,
                                        hamming_weight=si.hamming_weight)))
        print(f"image {i}: {dt:.1f}s max_err={err:.3e} "
              f"argmax_agree={agree}", flush=True)
    print(TIMING.report(), file=sys.stderr)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f)


if __name__ == "__main__":
    main()
