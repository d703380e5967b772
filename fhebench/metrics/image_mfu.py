"""image_mfu: the least time one image's homomorphic operations need on
one H100 (work.py: the larger of their bytes over 3.35 TB/s and their
32-bit IMADs over 16.7 T/s, counted from the traced window's op log),
over the traced window's seconds per image by the host's clock (the
profiler's starts and stops left out; its recording and the op log's
wrappers left in, so the share reads a little low), as a share."""


def read(run):
    if not run.cuda or not run.s_per_image:
        return None
    least, _ = run.work.least_s(run.ring)
    if least <= 0:
        return None
    return 100.0 * least / run.s_per_image
