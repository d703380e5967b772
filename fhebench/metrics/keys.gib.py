"""keys.gib: evaluation-key bytes held after the window
(FheContext.key_memory_bytes), in GiB."""


def read(run):
    if not run.cuda:
        return None
    return run.key_bytes / float(1 << 30)
