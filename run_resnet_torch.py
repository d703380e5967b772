"""Encrypted ResNet inference through the PyTorch port (ace_tpu_torch).

The port's counterpart of run_resnet.py: load the model -> select CKKS
parameters -> keys -> encode+encrypt the image -> run the encrypted graph
(a bootstrap before every ReLU) -> decrypt -> compare against the plain
packed-slot inference, with the runtime timing buckets at the end.

The default graph is build_resnet_cifar(3), ResNet-20 with seeded weights
calibrated to the reference's ReLU ranges; --model names a reference
model instead (resnet110_cifar10 is built natively, the others load the
reference's ONNX export from --model-dir, default model/ in this
repository, and fail with the missing file's name where it is absent).
Images are synthetic, default_rng(0).uniform(-1.5, 1.5), unless --cifar
gives a CIFAR batch file; the ReLU ranges are calibrated against them as
run_resnet.py does.

Usage:
  python run_resnet_torch.py [--model NAME] [--model-dir DIR] [--layers K]
      [--images 1] [--device cpu] [--rtt] [--checkpoint PATH]
      [--json out.json] [--cifar batch.bin] [--hamming-weight 192]
      [--relu-depth 9] [--relu-range R] [--mul-level L] [--max-rot-keys K]

--device defaults to the CUDA card and fails without one; --device cpu
runs the plain PyTorch versions of the kernels (slow at N = 2^15: use
--layers to cut the graph). --rtt decrypts and checks every op against a
plaintext shadow. --checkpoint saves the live ciphertexts after every op
to <PATH>.img<i>.npz and resumes an image from it; --json keeps the
finished images' rows and skips them when run again. Each row holds
run_resnet.py's keys plus the card's `name, power.limit` (`card`, as
nvidia-smi gives them), the process's peak device memory so far
(`max_memory_allocated`, and `max_memory_reserved`, which also counts
the graph pool's segments that replays use outside the allocator), null
on the CPU, and the evaluator's op programs so far (`programs`, Evaluator.program_stats: programs cached
and lifted, graphs captured, seconds in captures, replays, staging and
graph-pool bytes; the pool's bytes are null on the CPU).
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
    ap.add_argument("--model", default="",
                    help="reference model name (default: the native "
                         "build_resnet_cifar(3) ResNet-20)")
    ap.add_argument("--model-dir", default="",
                    help="directory of the reference's ONNX exports "
                         "(default: model/ in this repository)")
    ap.add_argument("--layers", type=int, default=0,
                    help="truncate the graph to its first K ops (0 = all)")
    ap.add_argument("--images", type=int, default=1)
    ap.add_argument("--cifar", default="", help="CIFAR batch .bin path")
    ap.add_argument("--hamming-weight", type=int, default=192)
    ap.add_argument("--relu-depth", type=int, default=9,
                    help="composite sign depth (reference default 9)")
    ap.add_argument("--relu-range", type=float, default=0.0,
                    help="uniform ReLU input range override; 0 = the "
                         "reference's per-ReLU tuned ranges")
    ap.add_argument("--mul-level", type=int, default=0,
                    help="force the q-chain length")
    ap.add_argument("--rtt", action="store_true",
                    help="runtime validation: plaintext shadow checks "
                         "after every op (the -VEC:rtt analog)")
    ap.add_argument("--checkpoint", default="",
                    help="per-op resume file prefix: image i resumes from "
                         "<prefix>.img<i>.npz if it exists")
    ap.add_argument("--max-rot-keys", type=int, default=0,
                    help="rotation-key LRU capacity (0 = size from the "
                         "default device-memory budget)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--json", default="",
                    help="per-image rows; finished images are skipped")
    args = ap.parse_args()

    os.environ.setdefault("RTLIB_TIMING_OUTPUT", "1")
    import torch
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    from ace_tpu_torch.compiler.scheme_info import (SchemeConfig,
                                                    security_posture,
                                                    select_params)
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.runtime.context import FheContext
    from ace_tpu_torch.utils.card import card

    def trace(msg):
        print(f"# {msg}", file=sys.stderr, flush=True)

    name = args.model or "resnet20_cifar10"
    g = (M.load_model(args.model, args.model_dir or M.MODEL_DIR)
         if args.model else M.build_resnet_cifar(3))
    if args.layers:
        g.ops = g.ops[:args.layers]
        g.output_name = g.ops[-1].outputs[0]
    classes = 100 if "cifar100" in name else 10
    if args.cifar:
        imgs, labels = M.read_cifar_batch(args.cifar, args.images, classes)
    else:
        imgs = np.random.default_rng(0).uniform(-1.5, 1.5,
                                                (args.images, 3, 32, 32))
        labels = None
    vr_default, vr = ranges_for(name)
    if args.relu_range:
        vr_default, vr = args.relu_range, {}
    vr_default, vr = M.calibrate_relu_ranges(g, imgs, vr_default, vr,
                                             trace=trace)
    cfg = SchemeConfig(security_level=0, hamming_weight=args.hamming_weight,
                       first_mod_size=60, scaling_mod_size=56,
                       relu_mul_depth=args.relu_depth,
                       relu_value_range=vr_default, relu_ranges=vr,
                       use_bootstrap=any(op.op_type == "Relu"
                                         for op in g.ops))
    t0 = time.time()
    ctx = None
    if args.mul_level:
        info = select_params(g, cfg)
        info.mul_level = args.mul_level
        ctx = FheContext(scheme_info=info,
                         max_rot_keys=args.max_rot_keys or 100,
                         device=args.device)
    model = M.compile_model(g, cfg, ctx=ctx, num_classes=classes,
                            check_every=args.rtt,
                            max_rot_keys=args.max_rot_keys, trace=trace,
                            device=args.device)
    si = model.scheme
    sec = security_posture(si)
    trace(f"params: N=2^{si.poly_degree.bit_length() - 1} "
          f"L={si.mul_level} input_level={si.input_level} on "
          f"{model.ctx.device} (context {time.time() - t0:.1f}s)")
    trace(f"security: {sec['detail']}"
          + ("" if sec["compliant"] else " [perf-evaluation config — "
             "see SECURITY.md]"))

    gpu = model.ctx.device.type == "cuda"
    name_power = card() if gpu else None

    def sync():
        if gpu:
            torch.cuda.synchronize()

    # resume: finished images live in the json, an image in flight in
    # its checkpoint file
    results = []
    if args.json and os.path.exists(args.json):
        with open(args.json) as f:
            results = json.load(f)
        if results:
            trace(f"resuming: images {sorted(r['image'] for r in results)} "
                  f"already done in {args.json}")
    done = {r["image"] for r in results}

    def flush():
        if args.json:
            with open(args.json + ".tmp", "w") as f:
                json.dump(results, f)
            os.replace(args.json + ".tmp", args.json)

    params_row = dict(N=si.poly_degree, L=si.mul_level,
                      hamming_weight=si.hamming_weight,
                      security=sec["detail"])
    for i in range(args.images):
        if i in done:
            continue
        plain = M.infer_plain(g, imgs[i], n_slots=si.poly_degree // 2)
        ck = f"{args.checkpoint}.img{i}.npz" if args.checkpoint else ""
        t0 = time.time()
        logits = M.infer_encrypted(model, imgs[i], checkpoint=ck)
        sync()
        dt = time.time() - t0
        if ck and os.path.exists(ck):
            os.remove(ck)
        k = min(len(logits), len(plain))
        err = float(np.max(np.abs(logits[:k] - plain[:k])))
        agree = bool(np.argmax(logits[:k]) == np.argmax(plain[:k]))
        row = dict(image=i, seconds=dt, max_err=err, argmax_agree=agree,
                   params=params_row, card=name_power,
                   max_memory_allocated=(torch.cuda.max_memory_allocated()
                                         if gpu else None),
                   max_memory_reserved=(torch.cuda.max_memory_reserved()
                                        if gpu else None),
                   programs=model.ctx.evaluator.program_stats())
        if labels is not None:
            row["label_match"] = bool(np.argmax(logits[:k]) == labels[i])
        results.append(row)
        flush()
        print(f"image {i}: {dt:.1f}s max_err={err:.3e} "
              f"argmax_agree={agree}", flush=True)
    print(model.ctx.finalize(), file=sys.stderr)
    flush()


if __name__ == "__main__":
    main()
