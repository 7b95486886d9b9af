"""The device's peak allocated memory over the window, in GiB (reset at its
start, read at its end, before the reference runs)."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes else None
