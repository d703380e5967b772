"""Error of one bootstrap and of one bootstrap followed by a ReLU, against
the input's magnitude, at the zoo's CKKS parameters (N = 2^15, 60-bit
q0, 56-bit scale, hamming weight 192, 3 digits).

An encrypted ResNet bootstraps every pre-activation before its ReLU,
and its pre-activations reach |x| = 9 (ResNet-20) to 17 (ResNet-110) on
the zoo's images. For each amplitude a it encrypts uniform(-a, a) in
N/2 slots at level 2 and prints the bootstrap's max error; then, for
each relu depth (9 on 34 q primes, 13 on 38, the chains select_params
picks for them), it runs bootstrap + ReLU at range R on uniform(-0.9 R,
0.9 R) and prints the max error against the exact ReLU and against the
ReLU polynomial evaluated in plain arithmetic
(scripts/torch_relu_error.py's approx_relu).

Usage:
  python3 scripts/torch_bootstrap_error.py [--amplitudes 0.7,2,4,8,16]
      [--relu-range 16] [--device cpu]

--device defaults to the CUDA card; on the CPU a bootstrap at N = 2^15
takes many minutes.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

DEGREE = 1 << 15


def context(num_q: int, device):
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.runtime.context import FheContext
    params = CkksParams(degree=DEGREE, num_q=num_q, first_mod_size=60,
                        scaling_mod_size=56, hamming_weight=192,
                        num_q_parts=3, device=device)
    return FheContext(params)


def bootstrapped(ctx, msg):
    ct = ctx.evaluator.encrypt(ctx.encoder.encode(
        msg.astype(np.complex128), level=2))
    return ctx.bootstrap(ct)


def decoded(ctx, ct):
    ctx.set_output_data("out", ct)
    return ctx.handle_output("out")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--amplitudes", default="0.7,2,4,8,16")
    ap.add_argument("--relu-range", type=float, default=16.0)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    from ace_tpu_torch.ckks import relu as relu_mod
    from ace_tpu_torch.utils.scripts import load_script

    RE = load_script("torch_relu_error")

    rng = np.random.default_rng(20261017)
    R = args.relu_range
    for depth, num_q in ((9, 34), (13, 38)):
        t0 = time.perf_counter()
        ctx = context(num_q, args.device)
        for a in (float(x) for x in args.amplitudes.split(",")):
            msg = rng.uniform(-a, a, DEGREE // 2)
            out = bootstrapped(ctx, msg)
            err = float(np.max(np.abs(decoded(ctx, out) - msg)))
            print(f"{num_q} q primes: bootstrap of uniform(-{a}, {a}): "
                  f"level 2 -> {out.level}, max_err {err:.4e} "
                  f"({err / a:.3e} of the amplitude)", flush=True)
        msg = rng.uniform(-0.9 * R, 0.9 * R, DEGREE // 2)
        out = relu_mod.relu(ctx.evaluator, bootstrapped(ctx, msg), R, depth)
        dec = decoded(ctx, out)
        exact = float(np.max(np.abs(dec - np.maximum(msg, 0))))
        poly = float(np.max(np.abs(dec - RE.approx_relu(msg, R, depth))))
        plain = float(np.max(np.abs(RE.approx_relu(msg, R, depth)
                                    - np.maximum(msg, 0))))
        print(f"{num_q} q primes: bootstrap + ReLU (depth {depth}, range "
              f"{R}) of uniform(-{0.9 * R}, {0.9 * R}): level {out.level}; "
              f"max_err {exact:.4e} against the exact ReLU, {poly:.4e} "
              f"against its polynomial in plain arithmetic (whose own "
              f"error is {plain:.4e}); {time.perf_counter() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main()
