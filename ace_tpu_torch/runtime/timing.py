"""The port's spans: named, nested regions of the runtime, timed on the
host and on the card.

The rtlib timing subsystem of `ace_tpu.runtime.timing` (the reference's
rtlib_timing.h:30-115), reported in the `Tensor::conv` / `FHE::relu`
bucket style that the reference's perf harness parses
(scripts/perf.py:60-70), grown into the port's one tracing system.

`TIMING.tm(name)` opens a span, in one of three states decided when it
opens:
- recorded, while a `torch.profiler` session records: the span opens the
  annotation "ace/<name>" (what `torch.profiler.record_function` opens,
  through its faster C++ form), so that it sits on the profiler's clock
  beside the kernels it enqueues, and keeps a record (`Span`, read by
  `records()`): its name, its parent span, its host start and end, and
  its device-stream seconds, taken from two CUDA events recorded on the
  current stream at its ends and resolved once the card has passed them
  (never by a synchronize of the span's own; in a process that has not
  initialized CUDA, the host's seconds). A span during which the
  profiler was stopped or started is dropped and counted (`dropped`),
  not recorded; such a change is seen by the next span that opens or
  closes.
- counted, while `TIMING.enabled` is set (RTLIB_TIMING_OUTPUT=1, or by
  assignment) and no profiler records: its count and host seconds by
  name, for `snapshot()` and `report()`, as TIMING always kept them; no
  annotation, no CUDA event, no record.
- off otherwise: one check of two flags.

Set-up regions (`setup=True`: contexts, keys, bootstrap tables, encodes)
are counted always, on or off, and on a card also timed on the device
stream by two CUDA events each (`device_seconds()`): their host clock
times the enqueue of the work inside them, not the work. They run a few
hundred times a run, so this costs nothing measurable.

Spans sit at or above the op-program boundary: inside a program's
function (utils/liftgraph.py) or a stream capture a span makes no event
and no record, and only a set-up region is counted.
"""

from __future__ import annotations

import functools
import os
import time

import torch

from ace_tpu_torch.utils import liftgraph

_profiling = torch._C._autograd._profiler_enabled

# span name -> nesting level in report() (RTLIB_TIMING_ALL()); other
# names (the graph runner's Tensor::<op> / FHE::relu, the evaluator's
# CKKS::<op>) at level 1
RTM_LEVELS = {
    "RTM_PREPARE_CONTEXT": 0,
    "RTM_INFER": 0,
    "RTM_ENCODE_ARRAY": 1,
    "RTM_MAIN_GRAPH": 1,
    "RTM_ROT_KEY_REGEN": 1,
    "RTM_KEYGEN": 2,
    "RTM_PT_ENCODE": 2,
    "RTM_RELU": 2,
    "RTM_BOOTSTRAP": 2,
    "RTM_BS_SETUP": 3,
    "RTM_BS_MOD_RAISE": 3,
    "RTM_BS_PARTIAL_SUM": 3,
    "RTM_BS_COEFF_TO_SLOT": 3,
    "RTM_BS_APPROX_MOD": 3,
    "RTM_BS_SLOT_TO_COEFF": 3,
}

# spans closed with CUDA events between two reads of those the card has
# passed (their events are then reused)
_SWEEP = 1024


class Span:
    """The record of one span. `parent` is the enclosing recorded span's
    record (None at the top), which may itself have been dropped;
    `keyswitch` marks an evaluator op that key-switches."""

    __slots__ = ("name", "parent", "keyswitch", "start", "end", "device_s",
                 "child_s", "_events")

    def __init__(self, name, parent=None, keyswitch=False):
        self.name = name
        self.parent = parent
        self.keyswitch = keyswitch
        self.start = self.end = 0.0
        self.device_s = None   # set when resolved
        self.child_s = 0.0     # device seconds of resolved children
        self._events = None

    @property
    def host_s(self) -> float:
        return self.end - self.start

    @property
    def self_s(self):
        """Device seconds not covered by a recorded child span (children
        do not overlap: they run one after another on one stream)."""
        return None if self.device_s is None else self.device_s - self.child_s


class _Off:
    """The context of a span that is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Count:
    """The context of a counted span: its host seconds, and with
    `device` its device-stream seconds too."""

    __slots__ = ("t", "rec", "device")

    def __init__(self, t, name, device):
        self.t, self.rec, self.device = t, Span(name), device

    def __enter__(self):
        if self.device:
            self.t._start(self.rec)
        self.rec.start = time.perf_counter()

    def __exit__(self, *exc):
        t, rec = self.t, self.rec
        rec.end = time.perf_counter()
        t._add(rec.name, rec.host_s)
        if self.device:
            t._stop(rec)
        return False


class _On:
    """The context of a recorded span."""

    __slots__ = ("t", "rec", "setup", "epoch", "note")

    def __init__(self, t, name, keyswitch, setup):
        stack = t._stack
        self.t, self.setup, self.epoch = t, setup, t._epoch
        self.rec = Span(name, stack[-1] if stack else None, keyswitch)

    def __enter__(self):
        t, rec = self.t, self.rec
        self.note = torch._C._profiler._RecordFunctionFast("ace/" + rec.name)
        self.note.__enter__()
        t._start(rec)
        t._stack.append(rec)
        rec.start = time.perf_counter()

    def __exit__(self, *exc):
        t, rec = self.t, self.rec
        rec.end = time.perf_counter()
        if t._stack and t._stack[-1] is rec:
            t._stack.pop()
        prof = t._observe()
        kept = t._epoch == self.epoch
        if kept or not prof:
            self.note.__exit__(*exc)
        else:
            # another profiler session records now: ending the
            # annotation would write into the stopped session's freed
            # records, so it is left open
            t._unclosed.append(self.note)
        if kept or self.setup:
            t._add(rec.name, rec.host_s)
            t._stop(rec)
        if kept:
            t._records.append(rec)
        else:
            t.dropped += 1
            if rec._events is not None and not self.setup:
                t._free.append(rec._events[0])
        return False


class RtTiming:
    """The span system: see the module docstring."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("RTLIB_TIMING_OUTPUT", "") not in (
                "", "0", "off")
        self.enabled = enabled
        self.dropped = 0        # spans dropped for a profiler change
        self._prof = False      # the profiler's state last seen
        self._epoch = 0         # profiler changes seen
        self._stack = []        # open recorded spans
        self._records = []
        self._pending = []      # spans whose CUDA events are unread
        self._free = []         # CUDA events to reuse
        self._closed = 0        # spans closed with CUDA events
        self._streams = (None, None)  # (current stream's id, Stream)
        self._unclosed = []     # annotations left open (see _On)
        self._acc: dict[str, float] = {}
        self._count: dict[str, int] = {}
        self._dev: dict[str, float] = {}

    def _observe(self) -> bool:
        """The profiler's state, counting each change seen."""
        p = _profiling()
        if p is not self._prof:
            self._prof = p
            self._epoch += 1
        return p

    def tm(self, name: str, keyswitch: bool = False, setup: bool = False):
        """The span `name` as a context manager. keyswitch: an evaluator
        op that key-switches; setup: a set-up region, counted and timed
        on the device even while spans are off."""
        p = self._observe()
        if not (p or self.enabled or setup):
            return _OFF
        if (p or setup) and (liftgraph._running is not None or (
                torch.cuda.is_initialized()
                and torch.cuda.is_current_stream_capturing())):
            return _Count(self, name, False) if (
                setup or self.enabled) else _OFF
        if p:
            return _On(self, name, keyswitch, setup)
        return _Count(self, name, setup)

    def _add(self, name: str, seconds: float) -> None:
        self._acc[name] = self._acc.get(name, 0.0) + seconds
        self._count[name] = self._count.get(name, 0) + 1

    def _stream(self):
        """The current CUDA stream, its Python object made once per
        stream (torch.cuda.current_stream() makes one at each call)."""
        key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
        if key != self._streams[0]:
            self._streams = (key, torch.cuda.Stream(
                stream_id=key[0], device_index=key[1], device_type=key[2]))
        return self._streams[1]

    def _event(self):
        if self._free:
            return self._free.pop()
        return torch.cuda.Event(enable_timing=True)

    def _start(self, rec: Span) -> None:
        """The device clock of `rec` starts: a CUDA event on the current
        stream, where a card is in use."""
        if torch.cuda.is_initialized():
            ev = self._event()
            ev.record(self._stream())
            rec._events = (ev, None)

    def _stop(self, rec: Span) -> None:
        """The device clock of `rec` stops; its seconds are resolved once
        the card passes its end (the host's seconds without a card)."""
        if rec._events is None:
            self._resolved(rec, rec.host_s)
            return
        ev = self._event()
        ev.record(self._stream())
        rec._events = (rec._events[0], ev)
        self._pending.append(rec)
        self._closed += 1
        if self._closed % _SWEEP == 0:
            self._resolve()

    def _resolved(self, rec: Span, seconds: float) -> None:
        rec.device_s = seconds
        self._dev[rec.name] = self._dev.get(rec.name, 0.0) + seconds
        if rec.parent is not None:
            rec.parent.child_s += seconds

    def _resolve(self) -> None:
        """Read the CUDA events the card has passed, in the order the
        spans closed (the order their ends complete on the stream), up to
        the first it has not passed."""
        k = 0
        for rec in self._pending:
            a, b = rec._events
            if not b.query():
                break
            self._resolved(rec, a.elapsed_time(b) / 1e3)
            rec._events = None
            self._free += (a, b)
            k += 1
        del self._pending[:k]

    def reset(self):
        self._acc.clear()
        self._count.clear()
        self._dev.clear()
        self._records.clear()
        self._pending.clear()
        self.dropped = 0

    def seconds(self, name: str) -> float:
        """Host seconds in spans `name` so far."""
        return self._acc.get(name, 0.0)

    def device_seconds(self, name: str) -> float:
        """Device-stream seconds of the spans `name` so far that the card
        has passed: the set-up regions' always, the others' while
        recorded."""
        if self._pending:
            self._resolve()
        return self._dev.get(name, 0.0)

    def count(self, name: str) -> int:
        return self._count.get(name, 0)

    def snapshot(self) -> dict:
        """{name: (count, host seconds)} of every span so far."""
        return {n: (self._count[n], self._acc[n]) for n in self._acc}

    def records(self) -> list:
        """The records of the spans recorded so far (Span), in the order
        they closed, with the device seconds of those the card has
        passed."""
        if self._pending:
            self._resolve()
        return list(self._records)

    def report(self, counters: dict | None = None) -> str:
        """RTLIB_TM_REPORT analog; returns the formatted table of every
        span so far, with its device seconds where it has them, or of
        `counters` ({name: (count, seconds)}, as snapshot() gives them;
        no device column)."""
        dev = None
        if counters is None:
            counters = self.snapshot()
            if self._pending:
                self._resolve()
            dev = self._dev
        lines = ["[RT_TIMING] name count total_sec device_sec"]
        for name in sorted(counters, key=lambda n: -counters[n][1]):
            lvl = RTM_LEVELS.get(name, 1)
            count, secs = counters[name]
            d = "%12.6f" % dev[name] if dev and name in dev else "%12s" % "-"
            lines.append("[RT_TIMING] %s%-24s %6d %12.6f %s"
                         % ("  " * lvl, name, count, secs, d))
        return "\n".join(lines)


TIMING = RtTiming()


def timed(name: str, keyswitch: bool = False, setup: bool = False):
    """Decorator: every call of the function is the span `name` (see
    RtTiming.tm for keyswitch and setup)."""
    def wrap(fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with TIMING.tm(name, keyswitch, setup):
                return fn(*args, **kwargs)
        return spanned
    return wrap
