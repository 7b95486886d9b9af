"""Device events (kernels, copies, fills) a serving step, from the traced
steps' profiler window."""


def read(run):
    return len(run.events) / run.trace_steps if run.events else None
