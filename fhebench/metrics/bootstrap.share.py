"""bootstrap.share: the bootstraps' device-stream seconds in the
profiled spans (the program's RTM_BOOTSTRAP spans, runtime/context.py),
as a share of the profiled seconds."""

from fhebench import spans


def read(run):
    return spans.share(run, spans.named("RTM_BOOTSTRAP"))
