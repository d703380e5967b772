"""The card a measurement runs on: its name as the records give it, and
a wait for the work queued on it."""

from __future__ import annotations

import subprocess


def card() -> str:
    """`name, power.limit` of the first card as nvidia-smi gives them
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"). Raises when nvidia-smi
    fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def syncer(device):
    """A function that waits for `device`: torch.cuda.synchronize for a
    CUDA device, nothing for the CPU."""
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.synchronize
    return lambda: None
