"""bootstrap.c2s.share: the bootstraps' coefficients-to-slots stage
(the program's RTM_BS_COEFF_TO_SLOT spans, ckks/bootstrap.py), its
device-stream seconds in the profiled spans as a share of the profiled
seconds."""

from fhebench import spans


def read(run):
    return spans.share(run, spans.named("RTM_BS_COEFF_TO_SLOT"))
