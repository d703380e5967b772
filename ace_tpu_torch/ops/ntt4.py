"""Kernels K3 (forward NTT) and K4 (inverse NTT): wrappers.

K3 `ntt4_fwd` replaces ace_tpu/ops/ntt4.py ntt4_fwd, K4 `ntt4_inv`
replaces ntt4.py ntt4_inv. The CUDA source is csrc/ntt.cu: one launch
per transform, one thread-block cluster per limb whose blocks together
hold the limb in shared memory, so each word is read from and written to
device memory once; its note gives the design and the bound. The
launcher picks the cluster from (L, N): 8 blocks at N = 2^15 for most
launches, 16 for a launch of a few limbs. The kernels read the same
tables as the 1-step ladders (ops/ntt.py NttTables, indexed by `rows`),
so the TPU kernel's four-step diagonal and u32-plane tables have no
counterpart here. N runs from 2 to 2^17 (LOGN_MAX); any other degree
raises, and so does data that does not start on a 16-byte boundary (the
kernels move it as 16-byte vectors).

Each wrapper takes the plain version (ops/ntt.py ntt_fwd_plain /
ntt_inv_plain) only for tensors on the CPU; for CUDA tensors it launches
the kernel or raises. `launches` counts wrapper calls that launched the
kernel (one launch each), `limbs` the limbs those launches transformed.
"""

from __future__ import annotations

import ctypes

import torch

from ace_tpu_torch.ops import ntt as _ntt

LOGN_MAX = 17  # csrc/ntt.cu LOGN_MAX: 8 blocks of 128 KB at N = 2^17


def _prep(x: torch.Tensor, t: "_ntt.NttTables"):
    if not x.is_cuda or x.dtype != torch.int64:
        raise TypeError(f"expected an int64 CUDA tensor, got {x.dtype} on "
                        f"{x.device}")
    if x.dim() != 2 or x.shape[0] != t.rows.shape[0] \
            or x.shape[1] != t.degree:
        raise ValueError(f"data {tuple(x.shape)} does not match tables "
                         f"[{t.rows.shape[0]}, {t.degree}]")
    if t.rou.device != x.device:
        raise ValueError("tables and data lie on different devices")
    n = x.shape[1]
    if n < 2 or n & (n - 1) or n > 1 << LOGN_MAX:
        raise ValueError(f"degree {n} is not a power of two in "
                         f"[2, 2^{LOGN_MAX}]")
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("K3/K4 move data as 16-byte vectors: the tensor "
                         "must start on a 16-byte boundary")
    return x, n.bit_length() - 1


def launch_shape(L: int, n: int) -> dict:
    """The launch shape K3/K4 take for [L, n] (from csrc/ntt.cu, so it
    needs the built library and a card): blocks per cluster, threads per
    block, dynamic shared memory per block in bytes, blocks in the grid,
    and how many such clusters the card holds at once for K3 and K4."""
    from ace_tpu_torch.ops import kernels
    out = (ctypes.c_int * 6)()
    kernels.check(kernels.lib("ntt").ace_ntt_shape(L, n.bit_length() - 1,
                                                   out), "ntt launch shape")
    return dict(zip(("cluster", "threads", "smem_bytes", "blocks",
                     "resident_k3", "resident_k4"), out))


def ntt4_fwd(coeffs: torch.Tensor, t: "_ntt.NttTables") -> torch.Tensor:
    """Forward negacyclic NTT of [L, N] natural-order residues into the
    1-step path's bit-reversed NTT form."""
    if not coeffs.is_cuda:
        return _ntt.ntt_fwd_plain(coeffs, t)
    x, logn = _prep(coeffs, t)
    out = torch.empty_like(x)
    from ace_tpu_torch.ops import kernels
    rc = kernels.lib("ntt").ace_k3_ntt_fwd(
        x.data_ptr(), out.data_ptr(), t.rou.data_ptr(),
        t.rou_prec.data_ptr(), t.q.data_ptr(), t.rows.data_ptr(),
        x.shape[0], logn, kernels.stream_ptr(x))
    kernels.check(rc, "K3 ntt4_fwd")
    ntt4_fwd.launches += 1
    ntt4_fwd.limbs += x.shape[0]
    return out


def ntt4_inv(values: torch.Tensor, t: "_ntt.NttTables") -> torch.Tensor:
    """Inverse negacyclic NTT of [L, N] NTT-form residues into natural
    order."""
    if not values.is_cuda:
        return _ntt.ntt_inv_plain(values, t)
    x, logn = _prep(values, t)
    out = torch.empty_like(x)
    from ace_tpu_torch.ops import kernels
    rc = kernels.lib("ntt").ace_k4_ntt_inv(
        x.data_ptr(), out.data_ptr(), t.rou_inv.data_ptr(),
        t.rou_inv_prec.data_ptr(), t.q.data_ptr(), t.n_inv.data_ptr(),
        t.n_inv_prec.data_ptr(), t.rows.data_ptr(), x.shape[0], logn,
        kernels.stream_ptr(x))
    kernels.check(rc, "K4 ntt4_inv")
    ntt4_inv.launches += 1
    ntt4_inv.limbs += x.shape[0]
    return out


ntt4_fwd.launches = ntt4_fwd.limbs = 0
ntt4_inv.launches = ntt4_inv.limbs = 0
