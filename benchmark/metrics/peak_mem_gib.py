"""peak_mem_gib (GiB, host clock of the allocator): torch's
``max_memory_allocated`` over set-up and the window, the fullest rank's."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
