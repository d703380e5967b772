"""Reduction of a torch.profiler trace to the benchmark's device
readings: busy seconds, kernel time by name, and the idle gaps with the
host's layer beside each.

Device events (kernels, copies, sets) are read straight from the
profiler's kineto events, not through key_averages(), which first builds
a Python tree over every runtime call. Busy time is the union of the
device events' intervals. An idle gap is a stretch between two device
events; the host activity beside it is the innermost "fhb/..." annotation
(the harness's spans and operation wrappers) open when the gap starts,
on the same clock. The annotations' own copies on the device's timeline
are left out of the device events.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses

ANNOTATION = "fhb/"
# kernels of PyTorch itself: its elementwise, reduction, copy and sort
# kernels and the CUB/Thrust ones it calls
ATEN_MARKERS = ("at::native::", "at::cuda::", "at_cuda_detail", "cub::",
                "thrust::")


@dataclasses.dataclass
class DeviceTrace:
    busy_s: float
    by_name: dict               # kernel or copy name -> seconds
    gaps: list                  # [(label, seconds)], longest first
    events: int

    def seconds(self, pred) -> float:
        return sum(s for name, s in self.by_name.items() if pred(name))


def is_aten(name: str) -> bool:
    return any(m in name for m in ATEN_MARKERS)


def _dev(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else False


def reduce(events, top_gaps: int = 10) -> DeviceTrace | None:
    """The readings of an iterable of kineto events, or None when no
    device event was recorded."""
    spans, notes = [], []
    for e in events:
        name, d = e.name(), e.duration_ns()
        if d <= 0:
            continue
        # the profiler also projects each annotation onto the device's
        # timeline: those are not device work
        if name.startswith(ANNOTATION):
            if not _dev(e):
                notes.append((e.start_ns(), e.start_ns() + d,
                              name[len(ANNOTATION):]))
        elif _dev(e) and not _annotation(e):
            spans.append((e.start_ns(), e.start_ns() + d, name))
    if not spans:
        return None
    spans.sort()
    by_name = collections.Counter()
    busy, gaps = 0, []
    cur_s, cur_e = spans[0][0], spans[0][1]
    for s, e, name in spans:
        by_name[name] += (e - s) / 1e9
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((s - cur_e, cur_e, name))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    gaps.sort(reverse=True)
    notes.sort()
    starts = [n[0] for n in notes]
    out = []
    for dur, at, after in gaps[:top_gaps]:
        out.append((f"host in {_innermost(notes, starts, at)}; before "
                    f"{short(after)}", dur / 1e9))
    return DeviceTrace(busy / 1e9, dict(by_name), out, len(spans))


def merge(traces: list, top_gaps: int = 10) -> DeviceTrace | None:
    """The readings of several profiled spans together: busy time and
    kernel time summed, the longest gaps of all; None where no span
    recorded a device event. The time between spans is no gap."""
    traces = [t for t in traces if t is not None]
    if not traces:
        return None
    by_name = collections.Counter()
    for t in traces:
        by_name.update(t.by_name)
    gaps = sorted((g for t in traces for g in t.gaps),
                  key=lambda g: g[1], reverse=True)[:top_gaps]
    return DeviceTrace(sum(t.busy_s for t in traces), dict(by_name), gaps,
                       sum(t.events for t in traces))


def _innermost(notes: list, starts: list, t: int) -> str:
    """The shortest annotation open at time t, or "no span"."""
    best = None
    for s, e, name in notes[:bisect.bisect_right(starts, t)]:
        if e >= t and (best is None or e - s < best[0]):
            best = (e - s, name)
    return best[1] if best else "no span"


def short(name: str, width: int = 96) -> str:
    """A kernel name without its return type, cut to `width`."""
    return name.removeprefix("void ")[:width]


def top_ops(trace: DeviceTrace, k: int = 10) -> list:
    """[[short name, seconds]] of the k device operations that took most
    time, summed over names that shorten alike."""
    agg = collections.Counter()
    for name, s in trace.by_name.items():
        agg[short(name)] += s
    return [[n, s] for n, s in agg.most_common(k)]
