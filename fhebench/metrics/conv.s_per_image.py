"""conv.s_per_image: device seconds per image in the graph runner's
convolutions (compiler/packing.py conv2d), from CUDA events recorded
before and after each call, summed per image and averaged over the
window's images."""


def read(run):
    if not run.cuda or not run.spans:
        return None
    return sum(s["conv"] for s in run.spans) / len(run.spans)
