"""Compile driver — the fhe_cmplr analog (`ace_tpu.driver` in the port).

The reference compiles `model.onnx` + option groups into a generated C
program plus a `.msg` weight file (scripts/build_resnet20_cifar10.sh:
33-42). Here the "compiled program" is (a) a parameter/rotation manifest
(JSON) produced by the analysis passes, and (b) the LUT weight data
file; FheContext.from_manifest rebuilds a runtime context from both and
the graph runner executes the model. The manifest and the weight file
equal ace_tpu's driver's for the same model and flags.

Usage:
  python -m ace_tpu_torch.driver model.onnx -CKKS:sk_hw=192:q0=60:sf=56 \
      -SIHE:relu_vr=/relu/Relu=4 -P2C:df=weights.msg -o model.manifest.json
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time

import numpy as np


def compile_model_artifacts(onnx_path: str, cfg, weights_path: str = "",
                            manifest_path: str = "") -> dict:
    from ace_tpu_torch.compiler.onnx_front import load_onnx
    from ace_tpu_torch.compiler.scheme_info import select_params
    from ace_tpu_torch.compiler import level_sim
    from ace_tpu_torch.runtime.rt_data import RtDataWriter

    t0 = time.time()
    g = load_onnx(onnx_path)
    info = select_params(g, cfg)

    # rotation-index inventory (CTX_PARAM's Add_rotate_index analog):
    # symbolically execute the packed program recording rotations
    rots = set()

    class RecordingBackend(level_sim.SimBackend):
        def rotate(self, ct, k):
            rots.add(int(k))
            return ct

        def rotations_hoisted(self, ct, ks):
            rots.update(int(k) for k in ks)
            return [ct for _ in ks]

    from ace_tpu_torch.compiler.lowering import GraphRunner
    be = RecordingBackend(info.poly_degree // 2)
    GraphRunner(g, be, relu_ranges=cfg.relu_ranges,
                relu_range_default=cfg.relu_value_range,
                relu_mul_depth=cfg.relu_mul_depth,
                bootstrap_before_relu=cfg.use_bootstrap).run(be.pack(None))

    if weights_path:
        w = RtDataWriter()
        for name, arr in g.weights.items():
            w.append(name, np.asarray(arr, np.float32).reshape(-1))
        w.write(weights_path)

    if cfg.use_bootstrap:
        from ace_tpu_torch.ckks.bootstrap import bootstrap_rotation_indices
        rots.update(bootstrap_rotation_indices(info.poly_degree))

    manifest = {
        "model": onnx_path,
        "scheme": dataclasses.asdict(info),
        "config": dataclasses.asdict(cfg),
        "rotate_indices": sorted(rots),
        "num_ops": len(g.ops),
        "weights_file": weights_path,
        "compile_seconds": round(time.time() - t0, 3),
    }
    if manifest_path:
        with open(manifest_path, "w") as f:
            json.dump(manifest, f, indent=1)
    return manifest


def main(argv=None):
    from ace_tpu_torch.utils.options import parse_args

    argv = list(argv if argv is not None else sys.argv[1:])
    out_path = ""
    if "-o" in argv:  # global -o <file> (global_config.h:21-52)
        i = argv.index("-o")
        out_path = argv[i + 1]
        del argv[i:i + 2]
    cfg, glob, extras = parse_args(argv)
    glob.output = glob.output or out_path
    inputs = extras.get("inputs", [])
    if not inputs:
        print("usage: python -m ace_tpu_torch.driver model.onnx "
              "[-CKKS:...] [-SIHE:...] [-P2C:df=weights.msg] "
              "[-o manifest.json]", file=sys.stderr)
        return 2
    out = glob.output
    if not out:
        out = inputs[0] + ".manifest.json"
    df = extras.get("p2c", {}).get("df", "")
    m = compile_model_artifacts(inputs[0], cfg, weights_path=df,
                                manifest_path=out)
    print(json.dumps({k: m[k] for k in
                      ("scheme", "rotate_indices", "compile_seconds")}
                     | {"manifest": out}, default=str)[:800])
    return 0


if __name__ == "__main__":
    sys.exit(main())
