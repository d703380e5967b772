"""Kernel K5 (fast base conversion): wrapper and constants.

K5 replaces no kernel of ace_tpu, whose base conversion is jnp code
(ace_tpu/poly/poly.py _base_conv_data); on the card its plain PyTorch
counterpart was some 500 int64 ATen launches per conversion. The CUDA
source is csrc/baseconv.cu: one launch per conversion, each source word
read once and each target word written once; its note gives the design
and the bound.

`constants` packs one conversion's constants into the uint64 vector the
kernel reads; poly/poly.py caches it on the device per conversion
(CrtContext.const), so a call copies nothing from the host and an op
program can capture it. `base_conv` takes the plain version,
`base_conv_plain`, which reads the same vector, only for tensors on the
CPU; for CUDA tensors it launches K5 or raises. `launches` counts the
launches (one a conversion); a target of no rows (a rank's empty share
of a limb-sharded poly) launches nothing. K5 has no `limbs` counter:
that counter is the NTT kernels' alone.
"""

from __future__ import annotations

import numpy as np
import torch

from ace_tpu_torch.ops import modops

ROWS = 17  # csrc/baseconv.cu K5_ROWS: the most target rows a block takes
ROW_STEPS = (1, 2, 4, 6, 8, 10, 12, 14, ROWS)  # csrc/baseconv.cu K5_R
# The most source rows a launch takes: a block of ROWS target rows stages
# (3 + ROWS) words a source row and 3 * ROWS more in 48 KB of shared
# memory.
MAX_OLD = (48 * 1024 // 8 - 3 * ROWS) // (3 + ROWS)


def slice_rows(num_new: int) -> int:
    """Target rows per block of K5's launch (csrc/baseconv.cu
    ace_k5_base_conv): the smallest of ROW_STEPS that holds an even share
    of num_new over the fewest slices of at most ROWS."""
    slices = -(-num_new // ROWS)
    share = -(-num_new // slices)
    return next(r for r in ROW_STEPS if r >= share)


def accumulator_bound(old_qs, hat_mod_new) -> int:
    """The largest 128-bit sum a conversion can make:
    O * (max q_o - 1) * (max matrix entry). K5 and the plain version are
    exact while it is below 2^128."""
    top = max((int(v) for row in hat_mod_new for v in row), default=0)
    return len(old_qs) * (max(int(q) for q in old_qs) - 1) * top


def constants(old_qs, new_qs, hat_inv, hat_mod_new) -> np.ndarray:
    """The packed uint64 constants of one conversion, in the kernel's
    order: q_o, hat_inv_o mod q_o, its Shoup word (O each), the matrix
    hat_mod_new [new][O] by rows, then p_j, mu_hi_j, mu_lo_j (new each).
    Raises ValueError for a conversion K5 cannot take exactly."""
    old_qs = [int(q) for q in old_qs]
    new_qs = [int(p) for p in new_qs]
    if not 0 < len(old_qs) <= MAX_OLD:
        raise ValueError(f"K5 takes 1 to {MAX_OLD} source rows, not "
                         f"{len(old_qs)}")
    if accumulator_bound(old_qs, hat_mod_new) >= 1 << 128:
        raise ValueError("K5's 128-bit accumulator could overflow for "
                         f"{len(old_qs)} source primes of up to "
                         f"{max(old_qs).bit_length()} bits")
    inv = [int(w) % q for w, q in zip(hat_inv, old_qs)]
    mat = [int(v) for row in hat_mod_new for v in row]
    assert len(mat) == len(old_qs) * len(new_qs), (len(mat), len(new_qs))
    mus = [modops.precompute_barrett128(p) for p in new_qs]
    return modops.np_u64(
        old_qs + inv
        + [modops.precompute_shoup(w, q) for w, q in zip(inv, old_qs)]
        + mat + new_qs + [m[0] for m in mus] + [m[1] for m in mus])


def base_conv_plain(x: torch.Tensor, consts: torch.Tensor, num_new: int
                    ) -> torch.Tensor:
    """The plain version of K5 as PyTorch int64 ops, on any device: the
    Shoup pre-multiply by hat_inv, the 128-bit product-sum over the O
    source rows in 32-bit halves, then Barrett-128, reading the packed
    `constants` at the kernel's offsets."""
    old = x.shape[0]
    c = consts.reshape(-1)
    q, inv, inv_prec = (c[k * old:(k + 1) * old, None] for k in range(3))
    mat = c[3 * old:(3 + num_new) * old].view(num_new, old)
    p, mu_hi, mu_lo = (c[(3 + num_new) * old + k * num_new:
                         (3 + num_new) * old + (k + 1) * num_new, None]
                       for k in range(3))
    tmp = modops.shoup_mul(x, inv, inv_prec, q)  # [O, n]
    acc_hi = torch.zeros((num_new, x.shape[-1]), dtype=torch.int64,
                         device=x.device)
    acc_lo = torch.zeros_like(acc_hi)
    for o in range(old):
        p_hi, p_lo = modops.mul_128(tmp[o][None, :], mat[:, o:o + 1])
        new_lo = acc_lo + p_lo
        carry = modops._ult(new_lo, p_lo).to(torch.int64)
        acc_hi = acc_hi + p_hi + carry
        acc_lo = new_lo
    return modops.barrett_reduce_128(acc_hi, acc_lo, p, mu_hi, mu_lo)


def base_conv(x: torch.Tensor, consts: torch.Tensor, num_new: int
              ) -> torch.Tensor:
    """K5: [O, n] residues to [num_new, n] canonical residues, with the
    conversion's packed `constants` on the same card."""
    if not x.is_cuda:
        return base_conv_plain(x, consts, num_new)
    for t in (x, consts):
        if not t.is_cuda or t.dtype != torch.int64:
            raise TypeError(f"K5 takes int64 CUDA tensors, got {t.dtype} on "
                            f"{t.device}")
    if x.dim() != 2:
        raise ValueError(f"K5 takes [O, n] data, not {tuple(x.shape)}")
    old, n = x.shape
    if consts.numel() != 3 * old + (old + 3) * num_new:
        raise ValueError(f"{consts.numel()} constants do not fit a "
                         f"conversion of {old} into {num_new} rows")
    x = x.contiguous()
    out = torch.empty((num_new, n), dtype=torch.int64, device=x.device)
    if num_new == 0 or n == 0:
        return out
    from ace_tpu_torch.ops import kernels
    rc = kernels.lib("baseconv").ace_k5_base_conv(
        x.data_ptr(), consts.data_ptr(), out.data_ptr(), old, num_new, n,
        kernels.stream_ptr(x))
    kernels.check(rc, "K5 base_conv")
    base_conv.launches += 1
    return out


base_conv.launches = 0
