"""bootstrap.evalmod.share: the bootstraps' approximate modular
reduction (the program's RTM_BS_APPROX_MOD spans, ckks/bootstrap.py),
its device-stream seconds in the profiled spans as a share of the
profiled seconds."""

from fhebench import spans


def read(run):
    return spans.share(run, spans.named("RTM_BS_APPROX_MOD"))
