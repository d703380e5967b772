"""Kernel K6 (the plaintext-message lift): wrapper and launch shape.

K6 replaces no kernel of ace_tpu, whose lift is jnp code inside its
hoisted MAC bundles; on the card its plain version, `lift_msgs_plain`
(a Barrett-128 chain in 32-bit halves), was some 107 int64 ATen
launches per MAC group. The CUDA source is csrc/lift.cu: one launch per
lift, each message word read once and each residue written once; its
note gives the design and the bound.

`lift_msgs` takes the plain version only for tensors on the CPU; for
CUDA tensors it launches K6 or raises. `launches` counts the launches
(one per Evaluator._mac_msgs call); a lift of no messages, limbs or
columns launches nothing. K6 has no `limbs` counter: that counter is
the NTT kernels' alone.
"""

from __future__ import annotations

import torch

from ace_tpu_torch.ops import modops

THREADS = 128  # csrc/lift.cu K6_THREADS: threads per block
COLS = 2       # K6_COLS: adjacent columns per thread (one 16-byte store)
LIMBS = 8      # K6_LIMBS: the most limbs a block writes


def launch_shape(r: int, lk: int, n: int) -> tuple:
    """K6's grid (column blocks, messages, limb slices) for r messages
    of n columns lifted to lk limbs."""
    return -(-n // (THREADS * COLS)), r, -(-lk // LIMBS)


def lift_msgs_plain(msgs: torch.Tensor, q, mu_hi, mu_lo) -> torch.Tensor:
    """The plain version of K6: int64 messages [..., n] -> canonical
    residues [..., LK, n] at the moduli q [LK, 1] as PyTorch int64 ops
    (mod_u64's Barrett-128 in 32-bit halves), on any device; bit-exact
    encoder._signed_to_rns."""
    neg = msgs < 0
    mag = torch.where(neg, -msgs, msgs)
    r = modops.mod_u64(mag[..., None, :], q, mu_hi, mu_lo)
    return torch.where(neg[..., None, :] & (r != 0), q - r, r)


def _check(msgs, q, mu_hi, mu_lo) -> None:
    """Refuse what K6 cannot take: anything but [R, n] messages with n
    even and one mu word pair a modulus, all int64 on one card."""
    if msgs.dim() != 2 or msgs.shape[1] % COLS:
        raise ValueError(f"K6 takes [R, n] messages with n even, not "
                         f"{tuple(msgs.shape)}")
    lk = q.numel()
    if mu_hi.numel() != lk or mu_lo.numel() != lk:
        raise ValueError(f"K6 takes one mu word pair a modulus: {lk} moduli, "
                         f"{mu_hi.numel()} / {mu_lo.numel()} words")
    for t in (msgs, q, mu_hi, mu_lo):
        if not t.is_cuda or t.dtype != torch.int64:
            raise TypeError(f"K6 takes int64 CUDA tensors, got {t.dtype} on "
                            f"{t.device}")
        if t.device != msgs.device:
            raise TypeError(f"K6 takes tensors on one card, got {t.device} "
                            f"and {msgs.device}")


def lift_msgs(msgs: torch.Tensor, q: torch.Tensor, mu_hi: torch.Tensor,
              mu_lo: torch.Tensor) -> torch.Tensor:
    """K6: int64 messages [R, n] to canonical residues [R, LK, n] at the
    moduli q, with mu = floor(2^128 / q) as (mu_hi, mu_lo): LK words each
    ([LK, 1] columns, as CrtContext.mod_arrays gives them), on the same
    card; n even."""
    if not msgs.is_cuda:
        return lift_msgs_plain(msgs, q, mu_hi, mu_lo)
    _check(msgs, q, mu_hi, mu_lo)
    (r, n), lk = msgs.shape, q.numel()
    out = torch.empty((r, lk, n), dtype=torch.int64, device=msgs.device)
    if out.numel() == 0:
        return out
    msgs, q, mu_hi, mu_lo = (t.contiguous() for t in (msgs, q, mu_hi, mu_lo))
    if msgs.data_ptr() % 16:  # the kernel loads two words at a time
        msgs = msgs.clone()
    from ace_tpu_torch.ops import kernels
    rc = kernels.lib("lift").ace_k6_lift_msgs(
        msgs.data_ptr(), q.data_ptr(), mu_hi.data_ptr(), mu_lo.data_ptr(),
        out.data_ptr(), r, lk, n, kernels.stream_ptr(msgs))
    kernels.check(rc, "K6 lift_msgs")
    lift_msgs.launches += 1
    return out


lift_msgs.launches = 0
