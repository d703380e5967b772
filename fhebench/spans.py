"""The program's own spans, as the per-layer readers take them: the
records and set-up counters of `ace_tpu_torch.runtime.timing` (TIMING).
After port.py, the only module of the harness that imports the program.

The program records its spans exactly while a profiler records (the
profiled spans of run.trace_segments), so its records are those of the
profiled window. Its set-up regions it times on the device stream always.
A program without span records (one from before them) gives None, and
its readers report nothing.
"""

from __future__ import annotations


def timing():
    """The program's TIMING where it keeps span records, else None."""
    from ace_tpu_torch.runtime import timing as t
    return t.TIMING if callable(getattr(t.TIMING, "records", None)) else None


def outermost(pred):
    """pred, held only by records with no enclosing record that holds it
    too (a recursive op counted once)."""
    def test(rec):
        if not pred(rec):
            return False
        p = rec.parent
        while p is not None:
            if pred(p):
                return False
            p = p.parent
        return True
    return test


def named(*names):
    return outermost(lambda rec: rec.name in names)


def share(run, pred):
    """The device-stream seconds of the recorded spans that hold `pred`,
    counted once where they nest, as a share of the profiled seconds
    (run.trace_window_s), in %; None without a card, a profiled window
    or span records."""
    t = timing()
    if not run.cuda or not run.trace_window_s or t is None:
        return None
    s = sum(r.device_s for r in t.records()
            if r.device_s is not None and pred(r))
    return 100.0 * s / run.trace_window_s


def setup_seconds(run, name: str):
    """Device-stream seconds of the set-up spans `name` over the whole run
    (the program times them with its spans off too); None without a card
    or span records."""
    t = timing()
    if not run.cuda or t is None:
        return None
    return t.device_seconds(name)
