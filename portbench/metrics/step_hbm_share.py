"""The least bytes of the traced serving steps (every weight once in its
stored dtype, the rings at the positions the sessions held in each of those
steps) over what HBM moves in the steps' device busy time, in %."""

from portbench.lib.trace import busy_us


def read(run):
    busy_s = busy_us(run.events) / 1e6
    if not run.traced_positions or busy_s <= 0:
        return None
    nbytes = sum(run.counts.step(run.z, run.cfg, run.sessions, p, run.ring_bytes)[0]
                 for p in run.traced_positions)
    return 100.0 * nbytes / (run.counts.HBM_BYTES_PER_S * busy_s)
