"""peak_mem_gib: torch.cuda.max_memory_allocated() over set-up and window."""


def read(r):
    return None if r.peak_bytes is None else r.peak_bytes / 2**30
