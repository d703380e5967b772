"""bootstrap.s_per_image: device seconds per image in the bootstraps
(ckks/bootstrap.py BootstrapContext.bootstrap), from CUDA events
recorded before and after each call, summed per image and averaged over
the window's images."""


def read(run):
    if not run.cuda or not run.spans:
        return None
    return sum(s["bootstrap"] for s in run.spans) / len(run.spans)
