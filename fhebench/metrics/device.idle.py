"""device.idle: the share of the profiled span in which no kernel, copy
or set ran on the device."""


def read(run):
    if not run.cuda or run.trace is None or not run.trace_window_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace_window_s)
