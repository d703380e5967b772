"""bootstrap.s2c.share: the bootstraps' slots-to-coefficients stage
(the program's RTM_BS_SLOT_TO_COEFF spans, ckks/bootstrap.py), its
device-stream seconds in the profiled spans as a share of the profiled
seconds."""

from fhebench import spans


def read(run):
    return spans.share(run, spans.named("RTM_BS_SLOT_TO_COEFF"))
