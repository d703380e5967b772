"""ace_tpu_torch — the CKKS FHE framework of `ace_tpu`, in PyTorch and CUDA.

The same layers as `ace_tpu` (ops -> poly -> ckks -> compiler -> runtime
-> models), written as plain functions on torch tensors. Six kernels are
hand-written CUDA for Hopper (`csrc/`, built at first use by
`ops/kernels.py`): K1/K2 (`ops/pallas_modops.py`) and K3/K4
(`ops/ntt4.py`) in place of `ace_tpu`'s four Pallas kernels, K5
(`ops/baseconv.py`) and K6 (`ops/lift.py`) in place of jnp code. Each
kernel's module holds the kernel's plain PyTorch version and chooses on
the tensor's device: the plain version on the CPU, the kernel on a
card. Every other device op is plain PyTorch.

Residue convention. Polynomials are RNS residue tensors [limbs, N] of
dtype torch.int64 holding canonical residues in [0, q). Every prime is
below 2^61, so residues, their sums and their differences never touch
the sign bit. The 64-bit precomputes (Shoup w' = floor(w*2^64/q) and the
Barrett words of floor(2^128/q)) use all 64 bits: they are stored as the
int64 bit pattern of the unsigned value. The plain versions treat them
as unsigned through 32-bit halves; the CUDA kernels reinterpret the
storage as uint64_t. torch has no add, shift or compare for uint64 on
the CPU, hence int64 storage.

Device. Entry points (FheContext, KeyGenerator, compile_model) take a
`device`; None means "cuda", and raises when no card is present. Pass
device="cpu" to run the plain PyTorch versions of the kernels.

This package imports neither jax nor anything of `ace_tpu`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` as given, else the
    card. Raises instead of silently falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ace_tpu_torch: no CUDA device; pass device='cpu' to run "
                "the plain PyTorch versions")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ace_tpu_torch: CUDA requested but not available")
    return dev
