"""Runtime timing counters.

The rtlib timing subsystem of `ace_tpu.runtime.timing` (the reference's
rtlib_timing.h:30-115): named nested counters accumulated per op class,
reported in the `Tensor::conv` / `FHE::relu` bucket style that the
reference's perf harness parses (scripts/perf.py:60-70).

Host wall clock: device work is asynchronous, so a region measures what
the host waited for; callers that want device time synchronize first.
Enabled by RTLIB_TIMING_OUTPUT=1 or by setting TIMING.enabled.
"""

from __future__ import annotations

import contextlib
import os
import time

# counter name -> nesting level, mirroring RTLIB_TIMING_ALL()
RTM_LEVELS = {
    "RTM_PREPARE_CONTEXT": 0,
    "RTM_FINALIZE_CONTEXT": 0,
    "RTM_ENCODE_ARRAY": 0,
    "RTM_ENCODE_VALUE": 0,
    "RTM_NTT": 0,
    "RTM_INTT": 0,
    "RTM_MAIN_GRAPH": 0,
    "RTM_DECOMP": 1,
    "RTM_MOD_DOWN": 1,
    "RTM_MOD_UP": 1,
    "RTM_RESCALE_POLY": 1,
    "RTM_BOOTSTRAP": 1,
    "RTM_BS_SETUP": 2,
    "RTM_BS_KEYGEN": 2,
    "RTM_BS_EVAL": 2,
    "RTM_BS_PARTIAL_SUM": 3,
    "RTM_BS_COEFF_TO_SLOT": 3,
    "RTM_BS_APPROX_MOD": 3,
    "RTM_BS_SLOT_TO_COEFF": 3,
    "RTM_PT_ENCODE": 1,
    "RTM_PT_GET": 1,
}


class RtTiming:
    """Accumulating named timers with nesting levels."""

    def __init__(self, enabled: bool | None = None):
        if enabled is None:
            enabled = os.environ.get("RTLIB_TIMING_OUTPUT", "") not in (
                "", "0", "off")
        self.enabled = enabled
        self._acc: dict[str, float] = {}
        self._count: dict[str, int] = {}

    @contextlib.contextmanager
    def tm(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._count[name] = self._count.get(name, 0) + 1

    def add(self, name: str, seconds: float, count: int = 1):
        self._acc[name] = self._acc.get(name, 0.0) + seconds
        self._count[name] = self._count.get(name, 0) + count

    def reset(self):
        self._acc.clear()
        self._count.clear()

    def seconds(self, name: str) -> float:
        return self._acc.get(name, 0.0)

    def count(self, name: str) -> int:
        return self._count.get(name, 0)

    def snapshot(self) -> dict:
        """{name: (count, seconds)} of every counter so far."""
        return {n: (self._count[n], self._acc[n]) for n in self._acc}

    def report(self, counters: dict | None = None) -> str:
        """RTLIB_TM_REPORT analog; returns the formatted table of every
        counter so far, or of `counters` ({name: (count, seconds)}, as
        snapshot() gives them)."""
        counters = self.snapshot() if counters is None else counters
        lines = ["[RT_TIMING] name count total_sec"]
        for name in sorted(counters, key=lambda n: -counters[n][1]):
            lvl = RTM_LEVELS.get(name, 1)
            count, secs = counters[name]
            lines.append("[RT_TIMING] %s%-24s %6d %12.6f"
                         % ("  " * lvl, name, count, secs))
        return "\n".join(lines)


TIMING = RtTiming()
