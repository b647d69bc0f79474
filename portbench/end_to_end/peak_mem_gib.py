"""The device allocator's peak over set-up and window
(``torch.cuda.max_memory_allocated``), read before any reference work."""


def read(run):
    return run["peak_bytes"] / 2**30
