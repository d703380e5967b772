"""relu.share: the ReLU's composite-sign polynomial without the
bootstrap before it (the program's RTM_RELU spans, ckks/relu.py), its
device-stream seconds in the profiled spans as a share of the profiled
seconds."""

from fhebench import spans


def read(run):
    return spans.share(run, spans.named("RTM_RELU"))
