#!/usr/bin/env python3
"""Per-op error of ResNet-20's first residual block under the port's
run-time validator (--rtt), on one CUDA card.

    python3 scripts/torch_rtt_prefix.py

Runs ops[:6] of build_resnet_cifar(3) (Conv, ReLU, Conv, ReLU, Conv, Add)
at chip_smoke.py phase 4's parameters (N = 2^15, 34 q primes, no
bootstrap, the same image and calibrated ReLU ranges) through
compile_model(check_every=True) with the validator's epsilon raised from
1e-2 to 1.0, so that every op runs and is checked. Prints, per graph op,
its checks, seconds and largest check error (decrypted and decoded ciphertext
against the plaintext shadow): the longest prefix whose every error is
within 1e-2 is the prefix chip_smoke.py phase 7 validates. The last line
is one JSON object.
"""

from __future__ import annotations

import json
import os
import re
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPSILON = 1e-2  # ValidatingBackend's default


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_rtt_prefix: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    from ace_tpu_torch.compiler.scheme_info import (SchemeConfig,
                                                    select_params)
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.runtime.context import FheContext

    g = M.build_resnet_cifar(3)
    g.ops = g.ops[:6]
    g.output_name = g.ops[-1].outputs[0]
    img = np.random.default_rng(0).uniform(-1.5, 1.5, (1, 3, 32, 32))[0]
    vr_default, vr = M.calibrate_relu_ranges(
        g, [img], *ranges_for("resnet20_cifar10"))
    cfg = SchemeConfig(security_level=0, hamming_weight=192,
                       first_mod_size=60, scaling_mod_size=56,
                       relu_mul_depth=9, relu_value_range=vr_default,
                       relu_ranges=vr, use_bootstrap=False)
    info = select_params(g, cfg)
    info.mul_level = 33
    ctx = FheContext(scheme_info=info, max_rot_keys=100)
    model = M.compile_model(g, cfg, ctx=ctx, num_classes=16 * 32 * 32,
                            check_every=True)
    be = model.runner.be
    be.epsilon = 1.0
    cur = {"checks": 0, "max_err": 0.0}
    rows = []

    def on_check(msg):
        err = float(re.search(r"max_err=(\S+)", msg).group(1))
        cur["checks"] += 1
        cur["max_err"] = max(cur["max_err"], err)

    def on_op(msg):
        m = re.match(r"\[(\d+)/\d+\] (\S+) (\S+): (\S+)s", msg)
        rows.append({"op": int(m.group(1)), "type": m.group(2),
                     "name": m.group(3), "seconds": float(m.group(4)),
                     **cur})
        print(f"[{m.group(1)}/6] {m.group(2)} {m.group(3)}: "
              f"{cur['checks']} checks, {m.group(4)} s, max_err "
              f"{cur['max_err']:.4e}", flush=True)
        cur.update(checks=0, max_err=0.0)

    be.trace = on_check
    model.runner.trace = on_op
    t0 = time.perf_counter()
    M.infer_encrypted(model, img)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    prefix = 0
    for r in rows:
        if r["max_err"] > EPSILON:
            break
        prefix = r["op"]
    print(f"output check max_err {cur['max_err']:.4e}; {be._op_count + 1} "
          f"checks in {wall:.1f} s; longest prefix within {EPSILON}: "
          f"ops[:{prefix}]", flush=True)
    print(json.dumps({"ops": rows, "output_max_err": cur["max_err"],
                      "seconds": wall, "prefix_within_epsilon": prefix,
                      "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
