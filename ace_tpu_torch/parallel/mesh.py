"""Two-axis process meshes on torch.distributed.

The counterparts of the JAX package's two meshes: `make_mesh(n_dp,
n_limb)` of `ace_tpu.parallel.mesh` (axes ('dp', 'limb'), the
limb-sharded evaluator behind FheContext(mesh=...)) and
`ace_tpu.parallel.spmd.make_digit_slot_mesh` (axes ('digit', 'slot'),
the SPMD key switch behind FheContext(digit_mesh=...)). Both are a
`ProcessMesh`: n0 * n1 ranks laid out row-major, rank = i0 * n1 + i1, as
np.reshape(devices, (n0, n1)) lays out a JAX mesh. Each rank holds its
coordinate on both axes and the process group of each axis (the ranks
that differ from it on that axis only). The collectives that JAX names
by axis are methods here:

  all_to_all_slot   jax.lax.all_to_all over 'slot'  (sharded_ntt._xpose)
  all_reduce_digit  jax.lax.psum over 'digit'       (the digit-MAC sum)
  all_gather_slot   jax.lax.all_gather over 'slot'  (the automorphism)
  all_gather_limb   the rows of a base conversion's source limbs, which
                    GSPMD gathers inside a jitted bundle
  broadcast_limb    one limb's row from its owner (rescale, mod-raise)

This module is the only one of the port that calls torch.distributed.

The backend is the caller's choice, never picked by catching an error:
  "gloo": the CPU, or one card shared by every rank (NCCL refuses two
          ranks on one device). Card tensors are staged to the host and
          back around each collective; the mesh counts the staged bytes
          and the seconds the copies took.
  "nccl": one card per rank (rank r on cuda:r); device tensors go to
          the collectives as they are.

Sums of int64 tensors wrap modulo 2^64, i.e. they are the low word of
the unsigned sum; spmd.py reads them as unsigned.
"""

from __future__ import annotations

import contextlib
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")
WORLD_TIMEOUT_S = 1800.0  # run_world stops a world that outlives this
DIGIT_SLOT = ("digit", "slot")
DP_LIMB = ("dp", "limb")


class ProcessMesh:
    """This rank's place in an n0 x n1 world with named axes. Every rank
    must construct its mesh at the same point of its program (each
    dist.new_group call is collective over the whole world)."""

    def __init__(self, axes: tuple, sizes: tuple, backend: str, device):
        world = dist.get_world_size()
        n0, n1 = sizes
        if world != n0 * n1:
            raise ValueError(f"a {n0} x {n1} mesh needs {n0 * n1} ranks, "
                             f"the world has {world}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        self.axes = tuple(axes)
        self.sizes = dict(zip(self.axes, sizes))
        self.backend = backend
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.coords = dict(zip(self.axes, divmod(self.rank, n1)))
        # the group along axis 1 (fixed i0), then along axis 0 (fixed i1)
        self.groups = {}
        for i0 in range(n0):
            g = dist.new_group([i0 * n1 + k for k in range(n1)])
            if i0 == self.coords[self.axes[0]]:
                self.groups[self.axes[1]] = g
        for i1 in range(n1):
            g = dist.new_group([d * n1 + i1 for d in range(n0)])
            if i1 == self.coords[self.axes[1]]:
                self.groups[self.axes[0]] = g
        self._stage = backend == "gloo" and self.device.type == "cuda"
        self.timeline = {}  # run_world's ranks: wall-clock marks of start-up
        self.reset_stats()

    def _skip(self, size: int) -> bool:
        """A one-rank axis under staging would only copy the tensor to
        the host and back: skip it. (NCCL and the CPU run it.)"""
        return size == 1 and self._stage

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX Mesh's `shape`."""
        return dict(self.sizes)

    def group_ranks(self) -> dict:
        """The global ranks of this rank's group on each axis."""
        return {a: dist.get_process_group_ranks(self.groups[a])
                for a in reversed(self.axes)}

    # -- statistics -------------------------------------------------------

    def reset_stats(self) -> None:
        self.collectives = 0        # collective calls made
        self.collective_s = 0.0     # seconds inside them (host clock)
        self.staged_bytes = 0       # bytes copied card -> host -> card
        self.staged_s = 0.0         # seconds those copies took

    def stats(self) -> dict:
        return {"collectives": self.collectives,
                "collective_s": self.collective_s,
                "staged_bytes": self.staged_bytes,
                "staged_s": self.staged_s}

    # -- collectives --------------------------------------------------------

    def _copy(self, x: torch.Tensor, device) -> torch.Tensor:
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        y = x.to(device)
        torch.cuda.synchronize(self.device)
        self.staged_s += time.perf_counter() - t0
        self.staged_bytes += x.numel() * x.element_size()
        return y

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        """A tensor of our own for the collective to read and write."""
        if self._stage:
            return self._copy(x, "cpu")
        return x.clone(memory_format=torch.contiguous_format)

    def _from_wire(self, x: torch.Tensor) -> torch.Tensor:
        return self._copy(x, self.device) if self._stage else x

    def _run(self, op, *a, **kw) -> None:
        t0 = time.perf_counter()
        op(*a, **kw)
        self.collectives += 1
        self.collective_s += time.perf_counter() - t0

    def all_to_all(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """x [n, ...] over an axis of n ranks: chunk j goes to the rank
        at coordinate j; returns [n, ...] whose chunk i came from i."""
        n = self.sizes[axis]
        if self._skip(n):
            return x
        assert x.shape[0] == n, x.shape
        w = self._to_wire(x)
        out = torch.empty_like(w)
        self._run(dist.all_to_all_single, out, w, group=self.groups[axis])
        return self._from_wire(out)

    def all_reduce(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """The sum over the axis (int64: modulo 2^64)."""
        if self._skip(self.sizes[axis]):
            return x
        w = self._to_wire(x)
        self._run(dist.all_reduce, w, group=self.groups[axis])
        return self._from_wire(w)

    def all_gather(self, x: torch.Tensor, axis: str) -> torch.Tensor:
        """[n, *x.shape]: every rank's x along the axis, in coordinate
        order (x has the same shape on every rank)."""
        n = self.sizes[axis]
        if self._skip(n):
            return x[None]
        w = self._to_wire(x)
        parts = [torch.empty_like(w) for _ in range(n)]
        self._run(dist.all_gather, parts, w, group=self.groups[axis])
        return self._from_wire(torch.stack(parts))

    def broadcast(self, x: torch.Tensor, axis: str, src: int) -> torch.Tensor:
        """The rank at coordinate `src` of the axis sends x; every rank of
        the axis passes a tensor of x's shape and gets x back."""
        if self._skip(self.sizes[axis]):
            return x
        w = self._to_wire(x)
        root = dist.get_global_rank(self.groups[axis], src)
        self._run(dist.broadcast, w, src=root, group=self.groups[axis])
        return self._from_wire(w)

    def sum_over_world(self, values: list) -> list:
        """Integers summed over every rank of the world (one all_reduce
        of the default group), e.g. per-rank counters."""
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor(values, dtype=torch.int64, device=dev)
        self._run(dist.all_reduce, t)
        return t.tolist()


class DigitSlotMesh(ProcessMesh):
    """The ('digit', 'slot') mesh of the SPMD key switch (spmd.py)."""

    def __init__(self, num_digits: int, num_slot: int, backend: str,
                 device):
        super().__init__(DIGIT_SLOT, (num_digits, num_slot), backend, device)
        self.num_digits, self.num_slot = num_digits, num_slot
        self.digit, self.slot = self.coords["digit"], self.coords["slot"]
        self.slot_group = self.groups["slot"]
        self.digit_group = self.groups["digit"]

    def all_to_all_slot(self, x: torch.Tensor) -> torch.Tensor:
        """x [s, ...]: chunk j goes to slot rank j; returns [s, ...]
        whose chunk i came from slot rank i."""
        return self.all_to_all(x, "slot")

    def all_reduce_digit(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the digit column (int64: modulo 2^64)."""
        return self.all_reduce(x, "digit")

    def all_gather_slot(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The slot shards concatenated along `dim` in slot order."""
        if self._skip(self.num_slot):
            return x
        return torch.cat(list(self.all_gather(x, "slot")), dim=dim)


class LimbMesh(ProcessMesh):
    """The ('dp', 'limb') mesh of the limb-sharded evaluator. Limb g of
    the chain (q_i is g = i, p_j is g = num_q + j) belongs to the rank
    at limb coordinate g mod n_limb of each dp row; the dp rows hold the
    same limbs and run independent ciphertexts."""

    def __init__(self, n_dp: int, n_limb: int, backend: str, device):
        super().__init__(DP_LIMB, (n_dp, n_limb), backend, device)
        self.n_dp, self.n_limb = n_dp, n_limb
        self.dp, self.limb = self.coords["dp"], self.coords["limb"]

    def owns(self, g: int) -> bool:
        return g % self.n_limb == self.limb

    def all_gather_limb(self, x: torch.Tensor, rows: int) -> torch.Tensor:
        """[n_limb, rows, ...]: each limb rank's x ([k, ...], k <= rows,
        k may differ between ranks) zero-padded to `rows`."""
        if x.shape[0] < rows:
            pad = x.new_zeros((rows - x.shape[0],) + tuple(x.shape[1:]))
            x = torch.cat([x, pad])
        return self.all_gather(x, "limb")

    def broadcast_limb(self, x: torch.Tensor, owner: int) -> torch.Tensor:
        """x from the limb rank `owner`; the others pass a buffer of x's
        shape."""
        return self.broadcast(x, "limb", owner)


def make_mesh(n_dp: int = 1, n_limb: int = 1, backend: str = "gloo",
              device="cpu") -> LimbMesh:
    """This rank's ('dp', 'limb') mesh (ace_tpu.parallel.mesh.make_mesh)
    over the initialized world of n_dp * n_limb ranks."""
    return LimbMesh(n_dp, n_limb, backend, device)


# ---------------------------------------------------------------------------
# Limb placement: put_limb and the sharding specs of ace_tpu.parallel.mesh.
# Where JAX returns a NamedSharding, these return this rank's own rows.
# ---------------------------------------------------------------------------

def put_limb(data, mesh, rows=None, batched: bool = False):
    """This rank's rows of `data` [..., L, N] along the limb axis (-2),
    whose rows are the global limbs `rows` (default 0..L-1); with
    batched=True, data is [B, L, N] and the rank's dp row also takes its
    B / n_dp slice of the batch. Without a mesh, data as it is. The
    single chokepoint through which keys, plaintexts and fresh
    ciphertexts enter a rank limb-sharded (ace_tpu's put_limb)."""
    if mesh is None:
        return data
    if batched:
        b = data.shape[0]
        if b % mesh.n_dp:
            raise ValueError(f"a batch of {b} does not split over "
                             f"{mesh.n_dp} dp rows")
        k = b // mesh.n_dp
        data = data[mesh.dp * k:(mesh.dp + 1) * k]
    rows = range(data.shape[-2]) if rows is None else rows
    own = [i for i, g in enumerate(rows) if mesh.owns(g)]
    if isinstance(data, torch.Tensor):
        return data.index_select(-2, torch.as_tensor(
            own, dtype=torch.int64, device=data.device))
    return data[..., own, :]


class LimbSharding:
    """The counterpart of a NamedSharding over ('dp', 'limb'): calling
    it on data gives this rank's part."""

    def __init__(self, mesh, batched: bool = False, replicate: bool = False):
        self.mesh, self.batched, self.replicate = mesh, batched, replicate

    def __call__(self, data):
        if self.replicate:
            return data
        return put_limb(data, self.mesh, batched=self.batched)


def limb_sharding(mesh, batched: bool = False) -> LimbSharding:
    """Poly data [L, N], or [B, L, N] with batched=True."""
    return LimbSharding(mesh, batched)


def shard_poly(mesh, poly_data, batched: bool = False):
    return limb_sharding(mesh, batched)(poly_data)


def replicated(mesh) -> LimbSharding:
    return LimbSharding(mesh, replicate=True)


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def file_rendezvous(directory: str):
    """A fresh `file://` rendezvous in a new directory under `directory`,
    removed afterwards."""
    os.makedirs(directory, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=directory, prefix="world-") as d:
        yield "file://" + os.path.join(d, "store")


def _rank_device(backend: str, device, rank: int) -> torch.device:
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device(device)


def _check_world(world: int, backend: str, device) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for and none is present")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("nccl runs on CUDA devices only")
        if torch.cuda.device_count() < world:
            raise RuntimeError(
                f"nccl needs one card per rank: {world} ranks, "
                f"{torch.cuda.device_count()} cards (use gloo to share one)")


_MESHES = {DIGIT_SLOT: DigitSlotMesh, DP_LIMB: LimbMesh}


def _rank_main(rank, fn, n0, n1, axes, backend, device, rendezvous, inbox,
               results):
    try:
        args = inbox.get()
        t_start = time.time()
        # the ranks share the host's cores with each other and with the
        # parent: torch's default of one intra-op thread per core in every
        # rank oversubscribes them, and its spinning threads then slow the
        # host many times over
        world = n0 * n1
        torch.set_num_threads(1)
        dev = _rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=rendezvous, world_size=world, rank=rank,
            timeout=timedelta(minutes=20),
            device_id=dev if backend == "nccl" else None)
        t_group = time.time()
        mesh = _MESHES[tuple(axes)](n0, n1, backend, dev)
        mesh.timeline = {"start": t_start, "process_group": t_group,
                         "mesh": time.time()}
        out = fn(mesh, *args)
        dist.barrier()
        msg = (rank, True, out)
    except BaseException:  # noqa: BLE001 — reported to the parent
        msg = (rank, False, traceback.format_exc())
    results.put(msg)
    if dist.is_initialized() and msg[1]:
        dist.destroy_process_group()


def run_world(fn, n0: int, n1: int, backend: str, device, rendezvous: str,
              args: tuple = (), axes: tuple = DIGIT_SLOT) -> list:
    """Run fn(mesh, *args) on every rank of an n0 x n1 world of spawned
    processes and return the ranks' results in rank order. `axes` picks
    the mesh: DIGIT_SLOT (a DigitSlotMesh of n0 digits x n1 slots, the
    default) or DP_LIMB (a LimbMesh of n0 dp rows x n1 limb ranks).

    fn is a module-level function (the ranks import it by name); args
    and results cross as pickles. `device` is every rank's device under
    gloo ("cpu", or one card shared by all ranks, e.g. "cuda:0"); under
    nccl rank r runs on cuda:r. `rendezvous` is the explicit init method
    (file:// or tcp://127.0.0.1:<port>). A rank that raises or dies, or
    a world that outlives WORLD_TIMEOUT_S, stops every rank and raises
    here with the failing rank's traceback."""
    if tuple(axes) not in _MESHES:
        raise ValueError(f"axes {axes!r} are not one of {list(_MESHES)}")
    world = n0 * n1
    _check_world(world, backend, device)
    ctx = mp.get_context("spawn")
    # args go through a queue, not the process object: spawn writes the
    # pickled process object into a pipe that the child drains only as it
    # unpickles (importing torch on the way), so a payload larger than
    # the pipe's buffer would make each start wait for the rank before
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, fn, n0, n1, tuple(axes), backend,
                               device, rendezvous, inbox, results))
             for r in range(world)]
    out = [None] * world
    pending = set(range(world))
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    try:
        for p in procs:
            p.start()
            inbox.put(args)
        while pending:
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in sorted(pending)
                        if procs[r].exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} exited with code "
                        f"{procs[dead[0]].exitcode} and no result")
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"ranks {sorted(pending)} of {world} still running "
                        f"after {WORLD_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            out[rank] = payload
            pending.discard(rank)
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            if p.pid is None:  # never started (an earlier start raised)
                continue
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        inbox.cancel_join_thread()  # a rank that died leaves args unread
        inbox.close()
        results.close()
    return out
