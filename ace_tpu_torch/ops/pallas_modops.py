"""Kernels K1 (Barrett product) and K2 (Shoup product): wrappers and
plain versions.

K1 `barrett_mul` replaces ace_tpu/ops/pallas_modops.py barrett_mul
(_barrett_vals through _elementwise_call); K2 `shoup_mul` replaces
pallas_modops.py shoup_mul (_shoup_vals). The CUDA sources are
csrc/modmul.cu (with csrc/modarith.cuh); their notes give the bound.

Each wrapper takes the plain version (ops/modops.py) only for tensors
on the CPU; for CUDA tensors it launches the kernel or raises. `launches`
on each wrapper counts kernel launches. Data with no rows (a rank's
empty share of a limb-sharded poly) launches nothing.
"""

from __future__ import annotations

import torch

from ace_tpu_torch.ops import modops


def _check_cuda(*ts):
    for t in ts:
        if not t.is_cuda or t.dtype != torch.int64:
            raise TypeError("expected int64 CUDA tensors, got "
                            f"{t.dtype} on {t.device}")


def _log2(n: int) -> int:
    if n <= 0 or n & (n - 1):
        raise ValueError(f"last dimension {n} is not a power of two")
    return n.bit_length() - 1


def _per_row(c: torch.Tensor, lead: tuple) -> torch.Tensor:
    """A per-row constant ([..., 1], broadcastable to lead + (1,)) as a
    contiguous vector with one entry per row of the flattened data."""
    return c.expand(*lead, 1).reshape(-1).contiguous()


def barrett_mul(a, b, q, mu_hi, mu_lo):
    """(a*b) mod q elementwise over [..., N]. b is [..., N] or a per-row
    constant [..., 1]; q, mu_hi, mu_lo are per-row [..., 1]."""
    if not a.is_cuda:
        return modops.barrett_mul(a, b, q, mu_hi, mu_lo)
    _check_cuda(a, b, q, mu_hi, mu_lo)
    lead = tuple(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
    n = a.shape[-1]
    logn = _log2(n)
    a_ = a.expand(*lead, n).contiguous()
    per_row = b.shape[-1] == 1 and n != 1
    b_ = _per_row(b, lead) if per_row else b.expand(*lead, n).contiguous()
    qs, mh, ml = (_per_row(v, lead) for v in (q, mu_hi, mu_lo))
    out = torch.empty_like(a_)
    rows = a_.numel() >> logn
    if rows == 0:  # a rank's empty limb shard: nothing to launch
        return out
    from ace_tpu_torch.ops import kernels
    rc = kernels.lib("modmul").ace_k1_barrett_mul(
        a_.data_ptr(), b_.data_ptr(), qs.data_ptr(), mh.data_ptr(),
        ml.data_ptr(), out.data_ptr(), rows, logn, int(per_row),
        kernels.stream_ptr(a_))
    kernels.check(rc, "K1 barrett_mul")
    barrett_mul.launches += 1
    return out


def shoup_mul(x, w, w_prec, q):
    """x*w mod q elementwise over [..., N] with per-row w, w_prec, q."""
    if not x.is_cuda:
        return modops.shoup_mul(x, w, w_prec, q)
    _check_cuda(x, w, w_prec, q)
    lead = tuple(x.shape[:-1])
    logn = _log2(x.shape[-1])
    x_ = x.contiguous()
    ws, wps, qs = (_per_row(v, lead) for v in (w, w_prec, q))
    out = torch.empty_like(x_)
    if x_.numel() == 0:
        return out
    from ace_tpu_torch.ops import kernels
    rc = kernels.lib("modmul").ace_k2_shoup_mul(
        x_.data_ptr(), ws.data_ptr(), wps.data_ptr(), qs.data_ptr(),
        out.data_ptr(), x_.numel() >> logn, logn, kernels.stream_ptr(x_))
    kernels.check(rc, "K2 shoup_mul")
    shoup_mul.launches += 1
    return out


barrett_mul.launches = 0
shoup_mul.launches = 0
