"""The allocator's peak of device memory over set-up and the window
(``torch.cuda.max_memory_allocated``), in GiB."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
