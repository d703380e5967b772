"""setup.encode_s: device-stream seconds the program spent encoding
plaintexts and messages over the whole run (its RTM_PT_ENCODE spans,
ckks/encoder.py: the cached encodes' misses and each image's input; two
CUDA events an encode, so the card's stream from the encode's start to
its end, host work it waits for included)."""

from fhebench import spans


def read(run):
    return spans.setup_seconds(run, "RTM_PT_ENCODE")
