"""The plain reference: the benchmark's ResNet (model.py) as a float64
PyTorch forward pass, with exact ReLUs and no encryption, packing,
kernels or caches. It reads the weights and images that the harness made
and hands to the program too, and imports nothing of the program.

`precision` below float64 computes the same pass in a lower precision:
those are the controls that `correct` has to fail (see control.py).
"""

from __future__ import annotations

import torch

from fhebench import model

# dtype each precision computes in, and the format it rounds every
# weight and every layer's output to
PRECISIONS = {
    "float64": (torch.float64, torch.float64),
    "float32": (torch.float32, torch.float32),
    "bfloat16": (torch.bfloat16, torch.bfloat16),
    "float8_e4m3": (torch.float32, torch.float8_e4m3fn),
}


def forward(net: list, weights: dict, images: torch.Tensor, outputs: int,
            precision: str = "float64") -> torch.Tensor:
    """The first `outputs` values of the network's flattened output for
    each image of `images` [B, C, H, W], as float64 [B, outputs]. Runs
    layer by layer over the batch."""
    dtype, fmt = PRECISIONS[precision]

    def rnd(t):
        return t.to(fmt).to(dtype)

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        w = {k: (rnd(a), rnd(b)) for k, (a, b) in weights.items()}
        acts = {"input": rnd(images)}
        for ly in net:
            y = acts[ly.inputs[1]] if ly.op == "add" else None
            acts[ly.output] = rnd(model.step(ly, acts[ly.inputs[0]], y, w))
        out = acts[net[-1].output]
        return out.reshape(out.shape[0], -1)[:, :outputs].to(torch.float64)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
