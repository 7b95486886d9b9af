"""K1-int8 (``csrc/depformer_step.cu``, ``dep_step_kernel``): the bound of
the traced steps' depformer micro-steps over their measured device time, in
%. Batch 1, int8 weights with float32 row scales, a cache in the dtype the
backbone's output had."""

NAMES = ("dep_step_kernel",)


def read(run):
    z, c = run.z, run.counts
    spent = sum(e - s for name, s, e in run.events if any(n in name for n in NAMES))
    if not spent:
        return None
    bound = sum(c.bound_s(*c.k1_call(z, cb, True, run.hidden_dtype, "int8"), "bf16")
                for cb in range(z["dep_q"]))
    return 100.0 * bound * run.trace_steps / (spent / 1e6)
