"""peak_device_gb: the fullest card's ``torch.cuda.max_memory_allocated``
over set-up and the window, in 1e9 bytes; none off the card."""


def read(run):
    return run.peak_bytes / 1e9 if run.peak_bytes is not None else None
