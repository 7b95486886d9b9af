"""Session-frames delivered over the whole window's time (divided by 12.5,
the conversations the card carries at this batch)."""

from portbench.lib.stats import rate


def read(run):
    return rate(len(run.step_ms) * run.sessions, run.window_s)
