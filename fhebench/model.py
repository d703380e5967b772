"""The benchmark's own ResNet: layer list, seeded weights and their
calibration, made by the harness and handed alike to the program and to
the plain reference.

The layers follow He et al., "Deep Residual Learning for Image
Recognition" (CVPR 2016, sec. 4.2): the 6n+2 CIFAR networks with
batch-norm folded into the convolutions, 16/32/64 channels at 32/16/8
pixels, a 1x1 stride-2 projection where a stage widens, global average
pooling and one fully connected layer. Names follow the ONNX exports of
ACE's models (`/layer1/layer1.0/conv1/Conv`, ...).

The trained weights are not in the repository, so weights are
He-initialised from the configuration's seed, in a few large draws of a
`torch.Generator` on the run's device, and each convolution is then
rescaled so that every ReLU input stays inside its calibration target on
a fixed calibration batch: 0.6 of the target after a convolution, 0.8 of
it after a residual add whose sum would pass 0.9 of it (the residual
branch is shrunk). The encrypted ReLU is a polynomial that holds only on
[-range, range], so unscaled He weights would leave it; timing does not
depend on the values. This module imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass
class Layer:
    op: str                     # conv, relu, add, gap, reshape, gemm
    name: str
    inputs: list                # names of the tensors read
    output: str
    cin: int = 0
    cout: int = 0
    k: int = 0
    stride: int = 1
    hw: int = 0                 # input height = width


def layers(arch: dict) -> list:
    """The network of `arch` (the configuration's "architecture"), in
    execution order. arch["ops"], if present, keeps only the first ops."""
    out = []
    c0, hw0 = arch["image"][0], arch["image"][1]

    def conv(name, src, cin, cout, hw, k, stride):
        out.append(Layer("conv", name, [src], f"{name}_output_0", cin, cout,
                         k, stride, hw))
        return out[-1].output

    def relu(name, src, c, hw):
        out.append(Layer("relu", name, [src], f"{name}_output_0", c, c,
                         hw=hw))
        return out[-1].output

    w0 = arch["widths"][0]
    x = conv("/conv1/Conv", "input", c0, w0, hw0, 3, 1)
    x = relu("/relu/Relu", x, w0, hw0)
    cin, hw = w0, hw0
    for stage, cout in enumerate(arch["widths"], start=1):
        for b in range(arch["blocks_per_stage"]):
            p = f"/layer{stage}/layer{stage}.{b}"
            stride = 2 if (stage > 1 and b == 0) else 1
            y = conv(f"{p}/conv1/Conv", x, cin, cout, hw, 3, stride)
            y = relu(f"{p}/relu/Relu", y, cout, hw // stride)
            y = conv(f"{p}/conv2/Conv", y, cout, cout, hw // stride, 3, 1)
            sc = x
            if stride != 1 or cin != cout:
                sc = conv(f"{p}/downsample/downsample.0/Conv", x, cin, cout,
                          hw, 1, stride)
            out.append(Layer("add", f"{p}/Add", [y, sc], f"{p}/Add_output_0",
                             cout, cout, hw=hw // stride))
            x = relu(f"{p}/relu_1/Relu", out[-1].output, cout, hw // stride)
            cin, hw = cout, hw // stride
    out.append(Layer("gap", "/avgpool/GlobalAveragePool", [x],
                     "/avgpool/GlobalAveragePool_output_0", cin, cin, hw=hw))
    out.append(Layer("reshape", "/Reshape", [out[-1].output],
                     "/Reshape_output_0", cin, cin))
    out.append(Layer("gemm", "/fc/Gemm", [out[-1].output],
                     "/fc/Gemm_output_0", cin, arch["classes"]))
    if arch.get("ops"):
        out = out[:arch["ops"]]
    return out


def make_weights(net: list, seed: int, device) -> dict:
    """He-initialised float32 weights from `seed`: one draw for every
    convolution kernel, one for the biases, one for the classifier.
    {layer name: (weight, bias)}."""
    g = torch.Generator(device=device).manual_seed(seed)
    convs = [ly for ly in net if ly.op == "conv"]
    sizes = [ly.cout * ly.cin * ly.k * ly.k for ly in convs]
    kern = torch.randn(sum(sizes), generator=g, device=device)
    bias = torch.randn(sum(ly.cout for ly in convs), generator=g,
                       device=device) * 0.02
    out, ko, bo = {}, 0, 0
    for ly, n in zip(convs, sizes):
        w = kern[ko:ko + n].view(ly.cout, ly.cin, ly.k, ly.k) \
            * math.sqrt(2.0 / (ly.cin * ly.k * ly.k))
        out[ly.name] = (w, bias[bo:bo + ly.cout])
        ko, bo = ko + n, bo + ly.cout
    for ly in net:
        if ly.op == "gemm":
            w = torch.randn(ly.cout * ly.cin, generator=g, device=device) \
                .view(ly.cout, ly.cin) * math.sqrt(1.0 / ly.cin)
            out[ly.name] = (w, torch.zeros(ly.cout, device=device))
    return out


def draw_images(gen: torch.Generator, count: int, image: list, low: float,
                high: float, device) -> torch.Tensor:
    """`count` float64 images uniform in [low, high), drawn in one call."""
    u = torch.rand((count, *image), generator=gen, dtype=torch.float64,
                   device=device)
    return u * (high - low) + low


def calibrate(net: list, weights: dict, batch: torch.Tensor,
              targets: dict, default: float) -> dict:
    """Rescale the convolutions so that every ReLU input of `batch`
    stays inside its target range (see the module docstring). Returns
    the rescaled weights as a new dict."""
    w = dict(weights)
    consumer = {}
    for ly in net:
        if ly.op == "relu":
            consumer[ly.inputs[0]] = targets.get(ly.name, default)
    producer = {ly.output: ly for ly in net}
    acts = {"input": batch}
    for ly in net:
        x = acts[ly.inputs[0]]
        if ly.op == "conv":
            wt, b = (t.double() for t in w[ly.name])
            y = conv(x, wt, b, ly)
            t = consumer.get(ly.output)
            if t is not None:
                s = 0.6 * t / (float(y.abs().max()) or 1.0)
                w[ly.name] = (w[ly.name][0] * s, w[ly.name][1] * s)
                y = y * s
            acts[ly.output] = y
        elif ly.op == "add":
            a, c = x, acts[ly.inputs[1]]
            y = a + c
            t = consumer.get(ly.output)
            if t is not None and float(y.abs().max()) > 0.9 * t:
                branch = producer[ly.inputs[0]]
                s = (0.8 * t - float(c.abs().max())) \
                    / (float(a.abs().max()) or 1.0)
                s = min(1.0, max(0.0, s))
                w[branch.name] = (w[branch.name][0] * s,
                                  w[branch.name][1] * s)
                y = a * s + c
            acts[ly.output] = y
        else:
            acts[ly.output] = step(ly, x, None, w)
    return w


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, ly: Layer):
    """'same' convolution of a batch, stride ly.stride."""
    return F.conv2d(x, w, b, stride=ly.stride, padding=ly.k // 2)


def step(ly: Layer, x: torch.Tensor, y, weights: dict) -> torch.Tensor:
    """One layer on a float batch (y: the add's second operand)."""
    if ly.op == "conv":
        wt, b = weights[ly.name]
        return conv(x, wt.to(x.dtype), b.to(x.dtype), ly)
    if ly.op == "relu":
        return torch.clamp_min(x, 0.0)
    if ly.op == "add":
        return x + y
    if ly.op == "gap":
        return x.mean(dim=(2, 3), keepdim=True)
    if ly.op == "reshape":
        return x.reshape(x.shape[0], -1)
    if ly.op == "gemm":
        wt, b = weights[ly.name]
        return x @ wt.to(x.dtype).T + b.to(x.dtype)
    raise ValueError(f"unknown layer kind {ly.op!r}")
