"""programs.pool_gib: the op programs' graph pool and staging buffer
after the window (Evaluator.program_stats: pool_bytes + staging_bytes),
in GiB. The pool has no size off the card."""


def read(run):
    pool = run.programs.get("pool_bytes")
    if pool is None:
        return None
    return (pool + run.programs["staging_bytes"]) / float(1 << 30)
