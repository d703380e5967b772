"""conv.share: the graph runner's convolutions (the program's
Tensor::conv spans, compiler/lowering.py), their device-stream seconds in
the profiled spans as a share of the profiled seconds."""

from fhebench import spans


def read(run):
    return spans.share(run, spans.named("Tensor::conv"))
