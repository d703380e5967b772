"""ResNet model family for CIFAR: graphs, compile, plain and encrypted
inference.

The `ace_tpu.models.resnet` flow (the reference's
dataset/resnet_cifar.main.inc:35-119): image -> encode+encrypt -> run the
encrypted graph -> decrypt+decode, beside the packed-slot plain oracle.
`build_resnet_cifar` makes the same graph and the same seeded weights as
the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ace_tpu_torch.compiler.onnx_front import NNGraph
from ace_tpu_torch.compiler.lowering import GraphRunner
from ace_tpu_torch.compiler import packing as pk
from ace_tpu_torch.compiler.scheme_info import SchemeConfig, select_params
from ace_tpu_torch.runtime.timing import TIMING


def build_resnet_cifar(blocks_per_stage: int, classes: int = 10,
                       seed: int = 110) -> NNGraph:
    """CIFAR ResNet graph built natively (BN-pre-folded form, identical
    op/naming pattern to the reference's *_pre.onnx exports).

    Used for resnet110: the reference ships only the generated program
    with `extern` weight declarations (rtlib/ant/dataset/
    resnet110_cifar10_train.onnx.inc) — the trained weight VALUES live
    in a build-time .msg file that is not in the repo. Weights here are
    He-initialized from a fixed seed: encrypted-inference TIMING (the
    ace_pre.log:11-18 comparison row) is weight-value independent, and
    encrypted-vs-plain agreement remains a full correctness check.
    """
    from ace_tpu_torch.compiler.onnx_front import NNOp

    rng = np.random.default_rng(seed)
    ops, weights = [], {}

    def conv(name, src, cin, cout, hw_in, k, stride):
        wname, bname = f"{name}.w", f"{name}.b"
        fan_in = cin * k * k
        weights[wname] = rng.normal(
            0.0, np.sqrt(2.0 / fan_in),
            (cout, cin, k, k)).astype(np.float32)
        weights[bname] = rng.normal(0.0, 0.02, cout).astype(np.float32)
        hw_out = hw_in // stride
        pads = [1, 1, 1, 1] if k == 3 else [0, 0, 0, 0]
        ops.append(NNOp(
            "Conv", name, [src, wname, bname], [f"{name}_output_0"],
            {"dilations": [1, 1], "group": 1, "kernel_shape": [k, k],
             "pads": pads, "strides": [stride, stride]},
            (1, cin, hw_in, hw_in), (1, cout, hw_out, hw_out)))
        return f"{name}_output_0"

    def relu(name, src, c, hw):
        ops.append(NNOp("Relu", name, [src], [f"{name}_output_0"], {},
                        (1, c, hw, hw), (1, c, hw, hw)))
        return f"{name}_output_0"

    def add(name, a, b, c, hw):
        ops.append(NNOp("Add", name, [a, b], [f"{name}_output_0"], {},
                        (1, c, hw, hw), (1, c, hw, hw)))
        return f"{name}_output_0"

    x = conv("/conv1/Conv", "input", 3, 16, 32, 3, 1)
    x = relu("/relu/Relu", x, 16, 32)
    cin, hw = 16, 32
    for stage, cout in ((1, 16), (2, 32), (3, 64)):
        for b in range(blocks_per_stage):
            p = f"/layer{stage}/layer{stage}.{b}"
            stride = 2 if (stage > 1 and b == 0) else 1
            hw_out = hw // stride
            y = conv(f"{p}/conv1/Conv", x, cin, cout, hw, 3, stride)
            y = relu(f"{p}/relu/Relu", y, cout, hw_out)
            y = conv(f"{p}/conv2/Conv", y, cout, cout, hw_out, 3, 1)
            if stride != 1 or cin != cout:
                sc = conv(f"{p}/downsample/downsample.0/Conv", x,
                          cin, cout, hw, 1, stride)
            else:
                sc = x
            y = add(f"{p}/Add", y, sc, cout, hw_out)
            x = relu(f"{p}/relu_1/Relu", y, cout, hw_out)
            cin, hw = cout, hw_out
    ops.append(NNOp("GlobalAveragePool", "/avgpool/GlobalAveragePool",
                    [x], ["/avgpool/GlobalAveragePool_output_0"], {},
                    (1, 64, hw, hw), (1, 64, 1, 1)))
    ops.append(NNOp("Reshape", "/Reshape",
                    ["/avgpool/GlobalAveragePool_output_0",
                     "/Constant_output_0"],
                    ["/Reshape_output_0"], {}, (1, 64, 1, 1), (1, 64)))
    weights["/Constant_output_0"] = np.array([1, -1], dtype=np.int64)
    weights["fc.weight"] = rng.normal(
        0.0, np.sqrt(1.0 / 64), (classes, 64)).astype(np.float32)
    weights["fc.bias"] = np.zeros(classes, dtype=np.float32)
    ops.append(NNOp("Gemm", "/fc/Gemm",
                    ["/Reshape_output_0", "fc.weight", "fc.bias"],
                    ["/fc/Gemm_output_0"],
                    {"alpha": 1.0, "beta": 1.0, "transB": 1},
                    (1, 64), (1, classes)))
    g = NNGraph(ops, weights, "input", (1, 3, 32, 32),
                "/fc/Gemm_output_0")
    _calibrate_to_relu_ranges(g, rng)
    return g


def _calibrate_to_relu_ranges(g: NNGraph, rng) -> None:
    """Rescale each conv's (w, b) so every ReLU input stays inside the
    reference's tuned per-ReLU value range for this model (the
    -SIHE:relu_vr contract the encrypted lowering certifies). He-init
    without batch-norm diverges over deep residual stacks; the
    encrypted composite-sign ReLU is only valid on [-range, range], so
    uncalibrated weights would break encrypted-vs-plain agreement."""
    from ace_tpu_torch.compiler.relu_ranges import ranges_for
    dflt, vr = ranges_for("resnet110_cifar10")
    # which ReLU consumes each op output
    consumer = {}
    for op in g.ops:
        if op.op_type == "Relu":
            consumer[op.inputs[0]] = vr.get(op.name, dflt)
    batch = rng.uniform(-1.5, 1.5, (4, 3, 32, 32))
    acts = {g.input_name: batch}

    def conv_np(x, w, b, stride, pads):
        n, cin, h, wd = x.shape
        cout, _, kh, kw = w.shape
        ph = pads[0]
        xp = np.pad(x, ((0, 0), (0, 0), (ph, ph), (ph, ph)))
        oh, ow = h // stride, wd // stride
        out = np.zeros((n, cout, oh, ow))
        for i in range(kh):
            for j in range(kw):
                patch = xp[:, :, i:i + h:stride, j:j + wd:stride]
                out += np.einsum("ncij,oc->noij",
                                 patch[:, :, :oh, :ow], w[:, :, i, j])
        return out + b[None, :, None, None]

    for op in g.ops:
        if op.op_type == "Conv":
            w = g.weights[op.inputs[1]]
            b = g.weights[op.inputs[2]]
            x = acts[op.inputs[0]]
            y = conv_np(x, w.astype(np.float64), b.astype(np.float64),
                        op.attrs["strides"][0], op.attrs["pads"])
            target = consumer.get(op.outputs[0])
            if target is not None:
                m = np.max(np.abs(y)) or 1.0
                s = 0.6 * target / m
                g.weights[op.inputs[1]] = (w * s).astype(np.float32)
                g.weights[op.inputs[2]] = (b * s).astype(np.float32)
                y = y * s
            acts[op.outputs[0]] = y
        elif op.op_type == "Relu":
            acts[op.outputs[0]] = np.maximum(acts[op.inputs[0]], 0.0)
        elif op.op_type == "Add":
            a, c = acts[op.inputs[0]], acts[op.inputs[1]]
            y = a + c
            target = consumer.get(op.outputs[0])
            if target is not None:
                m = np.max(np.abs(y))
                if m > 0.9 * target:
                    # shrink the residual-branch conv (inputs[0] is
                    # conv2's output) to fit the post-add range
                    conv2 = next(o for o in g.ops
                                 if o.outputs[0] == op.inputs[0])
                    s = max(0.0, (0.8 * target - np.max(np.abs(c)))
                            / (np.max(np.abs(a)) or 1.0))
                    s = min(1.0, s)
                    g.weights[conv2.inputs[1]] = (
                        g.weights[conv2.inputs[1]] * s)
                    g.weights[conv2.inputs[2]] = (
                        g.weights[conv2.inputs[2]] * s)
                    y = a * s + c
            acts[op.outputs[0]] = y
        elif op.op_type == "GlobalAveragePool":
            acts[op.outputs[0]] = acts[op.inputs[0]].mean(
                axis=(2, 3), keepdims=True)
        elif op.op_type == "Reshape":
            acts[op.outputs[0]] = acts[op.inputs[0]].reshape(
                acts[op.inputs[0]].shape[0], -1)
        elif op.op_type == "Gemm":
            wt = g.weights[op.inputs[1]].astype(np.float64)
            acts[op.outputs[0]] = acts[op.inputs[0]] @ wt.T


@dataclasses.dataclass
class CompiledModel:
    """An ONNX model bound to CKKS parameters and a runtime context."""
    graph: NNGraph
    scheme: object
    ctx: object
    runner: GraphRunner
    num_classes: int


# rotation-key LRU budget of compile_model: the keys of a full ResNet
# (~227 rotations at ~70 MB each at N=2^15) leave room on an 80 GB card
# for the caches, the bundle workspace and the live ciphertexts
ROT_KEY_BUDGET_BYTES = 40 << 30


def compile_model(g: NNGraph, cfg: SchemeConfig | None = None,
                  ctx=None, num_classes: int = 10,
                  max_rot_keys: int = 0, trace=None,
                  device=None) -> CompiledModel:
    """NN graph -> params -> runtime context ->
    encrypted executable (GraphRunner over the FheBackend). device: None
    runs on the card; "cpu" runs the plain versions."""
    from ace_tpu_torch.runtime.context import FheContext

    cfg = cfg or SchemeConfig()
    if cfg.use_bootstrap:
        raise NotImplementedError(
            "bootstrapping is not ported yet: use SchemeConfig("
            "use_bootstrap=False) on graphs that fit the modulus chain")
    scheme = select_params(g, cfg)
    if ctx is None:
        ctx = FheContext(scheme_info=scheme, max_rot_keys=max_rot_keys,
                         rot_key_budget_bytes=0 if max_rot_keys
                         else ROT_KEY_BUDGET_BYTES, device=device)
    if trace:
        trace(ctx.hbm_plan())
    be = pk.FheBackend(ctx.evaluator, ctx.encoder)
    runner = GraphRunner(
        g, be, relu_ranges=cfg.relu_ranges,
        relu_range_default=cfg.relu_value_range,
        relu_mul_depth=cfg.relu_mul_depth,
        bootstrap_before_relu=cfg.use_bootstrap, trace=trace)
    return CompiledModel(g, scheme, ctx, runner, num_classes)


def infer_plain(graph: NNGraph, image: np.ndarray,
                n_slots: int = 1 << 15) -> np.ndarray:
    """Packed-slot plain inference (the rt_validate oracle path)."""
    be = pk.PlainBackend(n_slots)
    runner = GraphRunner(graph, be)
    return runner.run(be.pack(np.asarray(image).reshape(-1)))


def calibrate_relu_ranges(graph: NNGraph, images,
                          vr_default: float, vr: dict,
                          margin: float = 1.25,
                          n_slots: int = 1 << 14,
                          trace=None) -> tuple[float, dict]:
    """Widen the per-ReLU value ranges to cover the ACTUAL inputs.

    The reference's shipped ranges (build_resnet*.sh -SIHE:relu_vr_def)
    were calibrated on CIFAR batches; inputs outside that distribution
    (e.g. synthetic images) can push a pre-ReLU activation beyond its
    range, and the composite sign polynomial then explodes like
    (y + sqrt(y^2-1))^k.
    This runs the plain oracle over the images, records each ReLU's
    peak |input| (GraphRunner.relu_observe), and returns ranges
    max(tuned, observed * margin). Depth, and therefore timing, is
    unchanged — only the normalization constant moves."""
    be = pk.PlainBackend(n_slots)
    runner = GraphRunner(graph, be, relu_ranges=vr,
                         relu_range_default=vr_default)
    observed: dict = {}
    runner.relu_observe = observed
    for img in images:
        runner.run(be.pack(np.asarray(img).reshape(-1)))
    out = dict(vr)
    for op in graph.ops:
        if op.op_type != "Relu":
            continue
        tuned = vr.get(op.name, vr_default)
        need = observed.get(op.name, 0.0) * margin
        if need > tuned:
            out[op.name] = float(np.ceil(need))
            if trace:
                trace(f"relu range calibrated {op.name}: {tuned} -> "
                      f"{out[op.name]} (observed {observed[op.name]:.2f})")
    return vr_default, out


def infer_encrypted(model: CompiledModel, image: np.ndarray) -> np.ndarray:
    """One encrypted inference; returns the first num_classes decrypted
    output values."""
    ctx = model.ctx
    ctx.prepare_input(image, "input", level=model.scheme.input_level)
    x = ctx.get_input_data("input")
    with TIMING.tm("RTM_MAIN_GRAPH"):
        out = model.runner.run(x)
    ctx.set_output_data("output", out)
    return ctx.handle_output("output", model.num_classes)
