"""Model operations of the traced serving steps (at the positions the
sessions held in each) over the card's bf16 dense peak in the steps' device
busy time, in %."""

from portbench.lib.trace import busy_us


def read(run):
    busy_s = busy_us(run.events) / 1e6
    if not run.traced_positions or busy_s <= 0:
        return None
    flops = sum(run.counts.step(run.z, run.cfg, run.sessions, p, run.ring_bytes)[1]
                for p in run.traced_positions)
    return 100.0 * flops / (run.counts.PEAK_FLOPS["bf16"] * busy_s)
