"""keyswitch.share: the evaluator's key-switching operations (the
program's CKKS::<op> spans marked keyswitch, ckks/evaluator.py: mul's
relinearization, rotate, conjugate and the rotation bundles), the
outermost of them where they nest, their device-stream seconds in the
profiled spans as a share of the profiled seconds."""

from fhebench import spans


def read(run):
    return spans.share(run, spans.outermost(lambda rec: rec.keyswitch))
