"""ntt_roofline: the NTT kernels' (K3, K4) share of their roofline over
the profiled span: the limbs they transformed there (the program's
kernel counters) times the least time of one limb transform at the
ring's degree (work.ntt_least_s: input, output and twiddle words once,
over the card's bandwidth), over their device time by kernel name."""

from fhebench import devtrace, port, work


def read(run):
    if not run.cuda or run.trace is None or not run.ntt_limbs:
        return None
    t = run.trace.seconds(
        lambda n: devtrace.short(n).startswith(port.NTT_KERNEL_PREFIX))
    if t <= 0:
        return None
    return 100.0 * work.ntt_least_s(run.ntt_limbs, run.ring.degree) / t
