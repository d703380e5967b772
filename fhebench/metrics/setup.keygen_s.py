"""setup.keygen_s: device-stream seconds the program spent generating
switching keys over the whole run (its RTM_KEYGEN spans, ckks/keygen.py:
the relinearization key and every rotation and conjugation key, each
with the secret's image it is made from; two CUDA events a key, so the
card's work and not the host's enqueue)."""

from fhebench import spans


def read(run):
    return spans.setup_seconds(run, "RTM_KEYGEN")
