"""GiB at the device's peak (``torch.cuda.max_memory_allocated``) over
the program's set-up and the window."""


def read(rec):
    if rec.device_peak_bytes is None:
        return None
    return rec.device_peak_bytes / 2 ** 30
