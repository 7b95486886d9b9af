"""K2 (``csrc/gating_ffn_step.cu``: gate/value, down and split-sum
launches): the bound of the traced steps' depformer FFN calls (one a layer
and codebook, over every session's row, in the dtype the backbone's output
had) over their measured device time, in %."""

NAMES = ("gate_value_mma", "down_mma", "sum_splits", "gate_value_kernel", "down_kernel")


def read(run):
    z, c = run.z, run.counts
    spent = sum(e - s for name, s, e in run.events if any(n in name for n in NAMES))
    if not spent:
        return None
    call = c.bound_s(*c.k2_call(z, run.sessions, run.hidden_dtype, run.cfg["lm_dtype"]), "bf16")
    calls = z["dep_q"] * z["dep_layers"] * run.trace_steps
    return 100.0 * call * calls / (spent / 1e6)
