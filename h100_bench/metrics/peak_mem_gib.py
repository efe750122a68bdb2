"""peak_mem_gib: the most device memory the port held at once during the
window (``torch.cuda.max_memory_allocated``, reset as the window opens),
in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30
