"""The ('digit', 'slot') process mesh on torch.distributed.

The counterpart of `ace_tpu.parallel.spmd.make_digit_slot_mesh` and the
JAX Mesh it returns: D*s ranks laid out row-major as (digit, slot), rank
= digit * s + slot, as np.reshape(devices, (D, s)) lays out the JAX
mesh. Each rank holds one (digit, slot) coordinate, the process group
of its digit row (the ranks that share its digit, over which 'slot'
collectives run) and that of its slot column ('digit' collectives). The
collectives that shard_map names by axis are methods here:

  all_to_all_slot   jax.lax.all_to_all over 'slot'  (sharded_ntt._xpose)
  all_reduce_digit  jax.lax.psum over 'digit'       (the digit-MAC sum)
  all_gather_slot   jax.lax.all_gather over 'slot'  (the automorphism)

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


class DigitSlotMesh:
    """This rank's place in a num_digits x num_slot world. Every rank
    must construct its mesh at the same point of its program (each
    dist.new_group call is collective over the whole world)."""

    def __init__(self, num_digits: int, num_slot: int, backend: str,
                 device):
        world = dist.get_world_size()
        if world != num_digits * num_slot:
            raise ValueError(f"a {num_digits} x {num_slot} mesh needs "
                             f"{num_digits * num_slot} ranks, the world "
                             f"has {world}")
        if backend not in BACKENDS:
            raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
        self.num_digits, self.num_slot = num_digits, num_slot
        self.backend = backend
        self.device = torch.device(device)
        self.rank = dist.get_rank()
        self.digit, self.slot = divmod(self.rank, num_slot)
        self.slot_group = self.digit_group = None
        for d in range(num_digits):
            g = dist.new_group([d * num_slot + k for k in range(num_slot)])
            if d == self.digit:
                self.slot_group = g
        for k in range(num_slot):
            g = dist.new_group([d * num_slot + k for d in range(num_digits)])
            if k == self.slot:
                self.digit_group = g
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
        return {"digit": self.num_digits, "slot": self.num_slot}

    def group_ranks(self) -> dict:
        """The global ranks of this rank's two groups."""
        return {"slot": dist.get_process_group_ranks(self.slot_group),
                "digit": dist.get_process_group_ranks(self.digit_group)}

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

    def all_to_all_slot(self, x: torch.Tensor) -> torch.Tensor:
        """x [s, ...]: chunk j goes to slot rank j; returns [s, ...]
        whose chunk i came from slot rank i."""
        if self._skip(self.num_slot):
            return x
        assert x.shape[0] == self.num_slot, x.shape
        w = self._to_wire(x)
        out = torch.empty_like(w)
        self._run(dist.all_to_all_single, out, w, group=self.slot_group)
        return self._from_wire(out)

    def all_reduce_digit(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the digit column (int64: modulo 2^64)."""
        if self._skip(self.num_digits):
            return x
        w = self._to_wire(x)
        self._run(dist.all_reduce, w, group=self.digit_group)
        return self._from_wire(w)

    def all_gather_slot(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The slot shards concatenated along `dim` in slot order."""
        if self._skip(self.num_slot):
            return x
        w = self._to_wire(x)
        parts = [torch.empty_like(w) for _ in range(self.num_slot)]
        self._run(dist.all_gather, parts, w, group=self.slot_group)
        return self._from_wire(torch.cat(parts, dim=dim))


    def sum_over_world(self, values: list) -> list:
        """Integers summed over every rank of the world (one all_reduce
        of the default group), e.g. per-rank counters."""
        dev = self.device if self.backend == "nccl" else "cpu"
        t = torch.tensor(values, dtype=torch.int64, device=dev)
        self._run(dist.all_reduce, t)
        return t.tolist()


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


def _rank_main(rank, fn, num_digits, num_slot, backend, device, rendezvous,
               inbox, results):
    try:
        args = inbox.get()
        t_start = time.time()
        # the ranks share the host's cores with each other and with the
        # parent: torch's default of one intra-op thread per core in every
        # rank oversubscribes them, and its spinning threads then slow the
        # host many times over
        world = num_digits * num_slot
        torch.set_num_threads(1)
        dev = _rank_device(backend, device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=rendezvous, world_size=world, rank=rank,
            timeout=timedelta(minutes=20),
            device_id=dev if backend == "nccl" else None)
        t_group = time.time()
        mesh = DigitSlotMesh(num_digits, num_slot, backend, dev)
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


def run_world(fn, num_digits: int, num_slot: int, backend: str, device,
              rendezvous: str, args: tuple = ()) -> list:
    """Run fn(mesh, *args) on every rank of a num_digits x num_slot world
    of spawned processes and return the ranks' results in rank order.

    fn is a module-level function (the ranks import it by name); args
    and results cross as pickles. `device` is every rank's device under
    gloo ("cpu", or one card shared by all ranks, e.g. "cuda:0"); under
    nccl rank r runs on cuda:r. `rendezvous` is the explicit init method
    (file:// or tcp://127.0.0.1:<port>). A rank that raises or dies, or
    a world that outlives WORLD_TIMEOUT_S, stops every rank and raises
    here with the failing rank's traceback."""
    world = num_digits * num_slot
    _check_world(world, backend, device)
    ctx = mp.get_context("spawn")
    # args go through a queue, not the process object: spawn writes the
    # pickled process object into a pipe that the child drains only as it
    # unpickles (importing torch on the way), so a payload larger than
    # the pipe's buffer would make each start wait for the rank before
    inbox, results = ctx.Queue(), ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, fn, num_digits, num_slot, backend, device,
                               rendezvous, inbox, results))
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
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        inbox.cancel_join_thread()  # a rank that died leaves args unread
        inbox.close()
        results.close()
    return out
