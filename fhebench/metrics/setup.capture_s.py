"""setup.capture_s: host seconds the op programs spent in their CUDA
graph captures over the whole run (Evaluator.program_stats: capture_s)."""


def read(run):
    if not run.cuda:
        return None
    return run.programs.get("capture_s")
