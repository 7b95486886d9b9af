"""Share of the traced window, in %, in which no device event ran."""

from portbench.lib.trace import busy_us


def read(run):
    if not run.events or run.trace_wall_us <= 0:
        return None
    return 100.0 * (1.0 - busy_us(run.events) / run.trace_wall_us)
