"""aten.share: PyTorch's own kernels' share of the device's busy time in
the profiled span: the elementwise, reduction and copy kernels that base
conversion and the modular arithmetic of poly/poly.py and ops/modops.py
run, against the port's K1-K4."""

from fhebench import devtrace


def read(run):
    if not run.cuda or run.trace is None or run.trace.busy_s <= 0:
        return None
    return 100.0 * run.trace.seconds(devtrace.is_aten) / run.trace.busy_s
