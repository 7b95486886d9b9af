"""95th percentile (nearest rank) of every step of the window, in ms: a
batched tick is one sample standing for each of its sessions' frames."""

from portbench.lib.stats import percentile


def read(run):
    return percentile(run.step_ms, 0.95)
