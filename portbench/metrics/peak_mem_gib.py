"""peak_mem_gib: ``torch.cuda.max_memory_reserved()`` from the process's
start to the window's end, in GiB (graph pools and caches included)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
