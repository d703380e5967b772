"""Op programs: one evaluator op run as one captured CUDA graph.

The counterpart of `ace_tpu.utils.liftjit` (ace_tpu/utils/liftjit.py:57-161).
There, each evaluator op bundle is one jitted XLA program, prepared once
per static key and then called with the ciphertexts, plaintexts and keys
as arguments. Here the same function of tensors is captured once into a
`torch.cuda.CUDAGraph` and replayed: one launch from the host for the
whole op instead of one per PyTorch kernel.

`lift_graph(fn, pool, refs)` returns a `Program`, called like `fn` on
tensors or (nested) lists and tuples of tensors. The arguments at the
positions `refs` are read by reference: the graph reads their memory in
place, so every later call must hand it the very tensors it captured
(the switching keys; Evaluator._key_raw). Every other tensor is an
input, copied into the program's static buffer at each call; nothing an
op is called with is baked into the graph.

- Call 1 runs `fn` eagerly. It is also the warm-up that a capture needs:
  it fills the caches that copy from host to device (CrtContext's
  columns, Barrett words, gathered NTT tables and automorphism orders),
  loads the kernel libraries and raises K3/K4's shared-memory limit, and
  records the kernel wrappers' counter deltas of one run and the shapes
  of the outputs. A program called once (most of an attention block's
  rotations) costs no capture.
- Call 2 copies the inputs into static buffers and captures `fn` on the
  pool's side stream into a graph that draws on the pool's one shared
  memory pool (`torch.cuda.graph_pool_handle()`), then replays it. The
  capture is in PyTorch's default "global" mode: no other thread of the
  port touches the card (the weight file's prefetch thread reads host
  memory only), so none can invalidate it.
- Call 3 and later check the by-reference tensors, copy the inputs in,
  replay, and clone the outputs out.

A replay launches no Python wrapper, so each replay adds the counter
deltas recorded at call 1 to the wrappers' `launches` and `limbs`
(ops.add_counters); the capture itself launches nothing and leaves them
as they were.

Memory. Every program of a pool shares one static staging buffer
(inputs, then outputs, at 512-byte boundaries) and one graph memory
pool: what a graph allocates while captured is freed when the capture
ends, so the next capture reuses it. That is safe because programs
replay one at a time on one stream, and each call copies its inputs in
just before its replay and clones its outputs out just after it: no
program's buffers have to outlive its own call. The pool and the staging
buffer thus stay near the largest program's scratch, inputs and outputs,
whatever the number of programs; a staging buffer outgrown by a later
program lives on in the programs that captured with it, so the buffers
add up to under three times the largest (GraphPool.stats counts every
live one). The pool's segments stay reserved after the captures end and
replays use them outside the allocator, so
`torch.cuda.max_memory_allocated` misses them and
`max_memory_reserved` does not. Clone-out also keeps an output from
aliasing another program's scratch.

Split programs. A function that calls a mesh collective (the SPMD key
switch's all_to_all, all_reduce and all_gather, the limb mesh's gathers
and broadcasts, parallel/mesh.py) becomes a chain of graph segments with
the collectives run eagerly between their replays: a gloo collective is
staged through the host and an NCCL one runs on its own stream, and
neither can sit inside a capture. Every collective goes through
`ProcessMesh._collective`, which hands it to the running program
(`running()`):
- Call 1 runs it and records the program's collective schedule: each
  collective's method, axis, source rank and input shape, in order,
  and its output shape.
- Call 2 captures. At a collective it copies the input into the
  collective's static input buffer (still inside the segment), ends the
  segment's graph, hands the function the collective's static output
  buffer and begins the next segment's graph in the same pool on the
  same side stream; the collective itself does not run. Then the
  program replays once.
- A replay runs the segments in order and, between segment k and k + 1,
  collective k through the same ProcessMesh method, from its static
  input into its static output, so the mesh's counters (collectives,
  staged bytes and seconds) go on counting.
Invariant: every call of a program, in any of its phases, runs its
collectives once each and in call 1's order. Ranks whose programs are
at different calls (one rank's program dropped and rebuilt while the
others replay) therefore stay in step. A schedule that differs from call
1's raises; so does a collective reached inside a segment without a
running program, or a host synchronisation inside a segment (CUDA
refuses it during a capture).
Memory: the collectives' static buffers are further regions of the
shared staging buffer, after the inputs and outputs. The argument above
still holds for the segments: programs replay one at a time, and between
two segments of one replay only the collective runs, which reads and
writes staging memory and allocates outside the graph pool (no capture
is under way then). A tensor that one segment makes and a later one
reads stays referenced by the function until the capture ends, so no
segment in between is given its memory; each replay rewrites it before
it is read. A program without a collective is one graph, as before. A
split program captures in "thread_local" mode: an NCCL process group's
watchdog thread queries CUDA events while the segments capture.

A capture or replay that fails raises; nothing falls back to the eager
path. On the CPU (a pool on a CPU device) a Program calls `fn` directly
at every call with the same bookkeeping (calls, counter deltas, the
by-reference tensors from call 2 on, the collective schedule checked
at every call after the first): the plain version the tests use.
"""

from __future__ import annotations

import time
import weakref

import torch

# static buffers start at 512-byte boundaries (the kernels move 16-byte
# vectors; the caching allocator's own alignment is 512 bytes)
_ALIGN = 64  # int64 words

# the Program whose function is running: the collectives it reaches sit
# deep in poly/ and parallel/ code, which takes no program argument, so
# the mesh's chokepoint looks it up here (programs run one at a time)
_running = None


def running():
    """The Program whose function is running (its collectives go through
    Program.collective), or None."""
    return _running


def _flatten(x, leaves: list):
    """The tensors of x (a tensor or nested lists/tuples) in order, and
    its structure for _unflatten."""
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        return None
    if isinstance(x, (list, tuple)):
        return (type(x), [_flatten(v, leaves) for v in x])
    raise TypeError(f"a program takes and returns tensors and lists of "
                    f"them, not {type(x).__name__}")


def _unflatten(spec, leaves):
    if spec is None:
        return next(leaves)
    kind, items = spec
    return kind(_unflatten(s, leaves) for s in items)


class GraphPool:
    """What the programs of one evaluator share: the device, the graph
    memory pool and the side stream captures run on (None on the CPU),
    the staging buffer, and counts for the reports."""

    def __init__(self, device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self.handle = torch.cuda.graph_pool_handle() if cuda else None
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self._staging = None
        self._buffers = []    # weak references to every staging buffer
        self.programs = 0     # Programs lifted
        self.captures = 0     # graphs captured
        self.capture_s = 0.0  # host seconds in captures (call 2 alone)
        self.segments = 0     # graphs captured (a split program's each)
        self.replays = 0

    def staging(self, words: int) -> torch.Tensor:
        """A flat int64 buffer of at least `words` words. It grows by
        half again when too small; a program keeps the buffer it captured
        with, so an outgrown one lives on while such programs do."""
        if self._staging is None or self._staging.numel() < words:
            have = 0 if self._staging is None else self._staging.numel()
            self._staging = torch.empty(max(words, have + have // 2),
                                        dtype=torch.int64,
                                        device=self.device)
            self._buffers.append(weakref.ref(self._staging))
        return self._staging

    def staging_bytes(self) -> int:
        """Bytes of every live staging buffer: the current one and the
        outgrown ones that programs still hold."""
        live = [b() for b in self._buffers]
        self._buffers = [r for r, b in zip(self._buffers, live)
                         if b is not None]
        return sum(b.numel() * 8 for b in live if b is not None)

    def pool_bytes(self):
        """Bytes the card's allocator holds for the graph memory pool
        (its segments' total size), or None where that cannot be read
        (the CPU)."""
        if self.handle is None:
            return None
        want = tuple(self.handle)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == want)

    def stats(self) -> dict:
        return {"programs": self.programs, "captures": self.captures,
                "capture_s": self.capture_s, "segments": self.segments,
                "replays": self.replays,
                "staging_bytes": self.staging_bytes(),
                "pool_bytes": self.pool_bytes()}


class Program:
    """fn as a captured CUDA graph, or a chain of them split at its
    collectives (see the module docstring)."""

    def __init__(self, fn, pool: GraphPool, refs=()):
        self.fn = fn
        self.pool = pool
        self.refs = frozenset(refs)
        self.calls = 0
        self._delta = None     # kernel-counter deltas of one run
        self._in_shapes = None
        self._out_spec = None  # (structure, shapes) of the outputs
        self._held = None      # the by-reference tensors, from call 2
        self._graphs = None    # the captured segments, in order
        self._static = None    # (input views, output views, buffer)
        # the collective schedule of call 1: (method, axis, src, input
        # shape) of each collective in order, with its output shape and
        # mesh; the static (input, output) views of each from call 2
        self.schedule = []
        self._step_out = []
        self._meshes = []
        self._steps = None
        self._next = None      # the next collective's index in this call
        self._capturing = None  # [current graph, finished graphs]

    @property
    def segments(self):
        """Graph segments: one more than the collectives (None before
        call 1)."""
        return None if self._delta is None else len(self.schedule) + 1

    def _split(self, args):
        inputs, held = [], []
        for i, a in enumerate(args):
            _flatten(a, held if i in self.refs else inputs)
        return inputs, held

    def holds(self, ids) -> bool:
        """True when a by-reference tensor of this program has its id in
        `ids` (the program captured it, or took it at call 2 on the
        CPU)."""
        return self._held is not None and any(id(t) in ids
                                              for t in self._held)

    def __call__(self, *args):
        from ace_tpu_torch import ops
        self.calls += 1
        inputs, held = self._split(args)
        shapes = [tuple(t.shape) for t in inputs]
        if self.calls == 1:
            before = ops.counter_state()
            out = self._run_fn(args)
            self._delta = ops.counter_delta(before)
            self._in_shapes = shapes
            leaves = []
            spec = _flatten(out, leaves)
            self._out_spec = (spec, [tuple(t.shape) for t in leaves])
            return out
        if shapes != self._in_shapes:
            raise ValueError(f"program input shapes {shapes} differ from "
                             f"those of its first call {self._in_shapes}")
        if self.calls == 2:
            self._held = held
            if self.pool.handle is None:
                return self._run_fn(args)
            return self._capture(args, inputs)
        if len(held) != len(self._held) or any(
                a is not b for a, b in zip(held, self._held)):
            raise RuntimeError("program handed other by-reference tensors "
                               "than it captured (a stale switching key)")
        if self.pool.handle is None:
            return self._run_fn(args)
        return self._replay(inputs)

    def _run_fn(self, args):
        """fn(*args) with this program running: call 1 records the
        collective schedule, every later call is held to it."""
        global _running
        if _running is not None:
            raise RuntimeError("a program was called inside another "
                               "program's function")
        _running, self._next = self, 0
        try:
            out = self.fn(*args)
        finally:
            _running = None
        if self.calls > 1 and self._next != len(self.schedule):
            raise RuntimeError(f"call {self.calls} of the program ran "
                               f"{self._next} collectives, call 1 "
                               f"{len(self.schedule)}")
        return out

    def collective(self, mesh, op: str, x: torch.Tensor, axis: str,
                   src=None) -> torch.Tensor:
        """Collective `op` of `mesh` reached by this program's function
        (ProcessMesh._collective): run and recorded at call 1, checked
        against the schedule at every later call, run on the CPU and
        left to the replays under a capture."""
        entry = (op, axis, src, tuple(x.shape))
        k = self._next
        self._next += 1
        if self.calls == 1:
            out = mesh.run_collective(op, x, axis, src)
            self.schedule.append(entry)
            self._step_out.append(tuple(out.shape))
            self._meshes.append(mesh)
            return out
        if k >= len(self.schedule) or self.schedule[k] != entry \
                or self._meshes[k] is not mesh:
            want = self.schedule[k] if k < len(self.schedule) else None
            raise RuntimeError(f"collective {k} of call {self.calls} is "
                               f"{entry}, call 1's was {want}")
        if self._capturing is None:
            return mesh.run_collective(op, x, axis, src)
        if x.dtype != torch.int64:
            raise TypeError(f"a captured collective's input must be int64, "
                            f"got {x.dtype}")
        step_in, step_out = self._steps[k]
        step_in.copy_(x)
        self._next_segment()
        return step_out

    def _begin_segment(self) -> None:
        graph = torch.cuda.CUDAGraph()
        mode = "thread_local" if self.schedule else "global"
        self._capturing[0] = graph
        graph.capture_begin(pool=self.pool.handle, capture_error_mode=mode)

    def _next_segment(self) -> None:
        graph, done = self._capturing
        graph.capture_end()
        done.append(graph)
        self._begin_segment()

    def _capture(self, args, inputs):
        from ace_tpu_torch import ops
        pool = self.pool
        dtypes = {t.dtype for t in inputs} | {torch.int64}
        if dtypes != {torch.int64}:
            raise TypeError(f"program inputs must be int64, got {dtypes}")
        spec, out_shapes = self._out_spec
        step_shapes = [s for e, o in zip(self.schedule, self._step_out)
                       for s in (e[3], o)]
        all_shapes = self._in_shapes + out_shapes + step_shapes
        sizes = [int(torch.Size(s).numel()) for s in all_shapes]
        offs, end = [], 0
        for n in sizes:
            offs.append(end)
            end += -(-n // _ALIGN) * _ALIGN
        buf = pool.staging(end)
        views = [buf[o:o + n].view(s) for o, n, s in zip(
            offs, sizes, all_shapes)]
        n_in, n_out = len(inputs), len(out_shapes)
        ins, outs = views[:n_in], views[n_in:n_in + n_out]
        steps = views[n_in + n_out:]
        self._steps = list(zip(steps[::2], steps[1::2]))
        it = iter(ins)
        sargs = [a if i in self.refs else _unflatten(_flatten(a, []), it)
                 for i, a in enumerate(args)]
        t0 = time.perf_counter()
        torch.cuda.synchronize(pool.device)
        before = ops.counter_state()
        self._capturing = [None, []]
        try:
            with torch.cuda.stream(pool.stream):
                self._begin_segment()
                try:
                    leaves = []
                    _flatten(self._run_fn(sargs), leaves)
                    got = [tuple(t.shape) for t in leaves]
                    if got != out_shapes or any(t.dtype != torch.int64
                                                for t in leaves):
                        raise RuntimeError(f"captured outputs {got} differ "
                                           f"from the first call's "
                                           f"{out_shapes} or are not int64")
                    for o, t in zip(outs, leaves):
                        o.copy_(t)
                    del leaves
                except BaseException:
                    # end the capture before the error propagates; the
                    # error of the capture itself would only hide the
                    # first one
                    try:
                        self._capturing[0].capture_end()
                    except RuntimeError:
                        pass
                    raise
                self._capturing[0].capture_end()
            graphs = self._capturing[1] + [self._capturing[0]]
        finally:
            self._capturing = None
        captured = ops.counter_delta(before)
        ops.restore_counters(before)
        if captured != self._delta:
            raise RuntimeError(f"the capture launched {captured}, the "
                               f"eager run {self._delta}")
        self._graphs = graphs
        self._static = (ins, outs, buf)
        pool.captures += 1
        pool.segments += len(graphs)
        pool.capture_s += time.perf_counter() - t0
        return self._replay(inputs)

    def _replay(self, inputs):
        from ace_tpu_torch import ops
        ins, outs, _ = self._static
        for s, t in zip(ins, inputs):
            s.copy_(t)
        self._graphs[0].replay()
        for graph, entry, mesh, (step_in, step_out) in zip(
                self._graphs[1:], self.schedule, self._meshes, self._steps):
            op, axis, src, _ = entry
            step_out.copy_(mesh.run_collective(op, step_in, axis, src))
            graph.replay()
        ops.add_counters(self._delta)
        self.pool.replays += 1
        return _unflatten(self._out_spec[0], iter([o.clone() for o in outs]))


def lift_graph(fn, pool: GraphPool, refs=()) -> Program:
    """fn as an op program on `pool`; `refs`: positions of the arguments
    read by reference."""
    pool.programs += 1
    return Program(fn, pool, refs)
