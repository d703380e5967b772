#!/usr/bin/env python3
"""Time the port's key generation, conv bundle and ResNet-20's first
residual block on one CUDA card, for comparing two checkouts of the port.

    python3 scripts/torch_host_ab.py [--tree DIR]

DIR (default: this checkout) is the checkout whose ace_tpu_torch is
imported. At ResNet-20's ring (N = 2^15, 34 q primes, 3 digits) it times:
  keygen   seconds per rotation key (_gen_switching_key), 8 keys after
           one warm-up key;
  bundle   one rot_mac_groups_msgs_jit at level 34, 12 rotations (0 among
           them), 4 message groups, keys held: median of 5 calls, and the
           K1-K4 launches of one call;
  ops[:6]  ResNet-20's first residual block through compile_model and
           infer_encrypted, set up as chip_smoke.py phase 4: the cold
           inference (keys made on demand) and the median of 3 warm ones.
Every time is host wall time with the card synchronised. The last line is
one JSON object. Run two checkouts in one call in the order A, B, B, A
and compare within that call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

DEGREE, NUM_Q, Q_PARTS = 32768, 34, 3
DEVICE = "cuda"
HW = 192
SEED = 20261016


def launches() -> dict:
    from ace_tpu_torch.ops import ntt4, pallas_modops as pm
    return {"K1": pm.barrett_mul.launches, "K2": pm.shoup_mul.launches,
            "K3": ntt4.ntt4_fwd.launches, "K4": ntt4.ntt4_inv.launches}


def timed(fn) -> float:
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def keygen_and_bundle() -> dict:
    import torch
    from ace_tpu_torch.ckks.params import CkksParams
    from ace_tpu_torch.runtime.context import FheContext

    params = CkksParams(degree=DEGREE, num_q=NUM_Q, first_mod_size=60,
                        scaling_mod_size=56, hamming_weight=HW,
                        num_q_parts=Q_PARTS, device=DEVICE)
    ctx = FheContext(params, seed=SEED)
    kg, ev = ctx.keygen, ctx.evaluator
    timed(lambda: kg.rot_key(1))
    per_key = [timed(lambda r=r: kg.rot_key(r)) for r in range(2, 10)]

    rng = np.random.default_rng(SEED)
    m = rng.uniform(-1, 1, DEGREE // 2).astype(np.complex128)
    ct = ev.encrypt(ctx.encoder.encode(m))
    assert ct.level == NUM_Q
    rots = list(range(12))
    msgs = torch.as_tensor(rng.integers(-2**55, 2**55, (4, 12, DEGREE)),
                           device=DEVICE)
    timed(lambda: ev.rot_mac_groups_msgs_jit(ct, rots, msgs))
    before = launches()
    bundle = [timed(lambda: ev.rot_mac_groups_msgs_jit(ct, rots, msgs))]
    after = launches()
    bundle += [timed(lambda: ev.rot_mac_groups_msgs_jit(ct, rots, msgs))
               for _ in range(4)]
    return {"keygen_s_per_key": statistics.mean(per_key),
            "bundle_s": statistics.median(bundle),
            "bundle_launches": {k: after[k] - before[k] for k in after}}


def first_block() -> dict:
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    from ace_tpu_torch.compiler.scheme_info import SchemeConfig, select_params
    from ace_tpu_torch.models import resnet as M
    from ace_tpu_torch.runtime.context import FheContext

    g = M.build_resnet_cifar(3)
    g.ops = g.ops[:6]
    g.output_name = g.ops[-1].outputs[0]
    img = np.random.default_rng(0).uniform(-1.5, 1.5, (1, 3, 32, 32))[0]
    vr_default, vr = ranges_for("resnet20_cifar10")
    vr_default, vr = M.calibrate_relu_ranges(g, [img], vr_default, vr)
    cfg = SchemeConfig(security_level=0, hamming_weight=192,
                       first_mod_size=60, scaling_mod_size=56,
                       relu_mul_depth=9, relu_value_range=vr_default,
                       relu_ranges=vr, use_bootstrap=False)
    info = select_params(g, cfg)
    info.mul_level = NUM_Q - 1
    ctx = FheContext(scheme_info=info, max_rot_keys=100, device=DEVICE)
    out_len = 16 * 32 * 32
    model = M.compile_model(g, cfg, ctx=ctx, num_classes=out_len)
    outs = []
    cold = timed(lambda: outs.append(M.infer_encrypted(model, img)))
    warm = [timed(lambda: outs.append(M.infer_encrypted(model, img)))
            for _ in range(3)]
    plain = M.infer_plain(g, img, n_slots=DEGREE // 2)[:out_len]
    err = max(float(np.max(np.abs(o - plain))) for o in outs)
    assert err <= 5e-2 * float(np.max(np.abs(plain))), err
    return {"ops6_cold_s": cold, "ops6_warm_s": statistics.median(warm),
            "ops6_warm_all_s": warm, "ops6_max_err": err}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    import ace_tpu_torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(ace_tpu_torch.__file__))
    assert here == tree, (here, tree)
    # its own query, not ace_tpu_torch.utils.card: an older tree lacks it
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    res = {"tree": tree, "card": card}
    res.update(keygen_and_bundle())
    res.update(first_block())
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
