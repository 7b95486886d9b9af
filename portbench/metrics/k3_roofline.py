"""K3 (``csrc/rvq_encode.cu``): the bound of the traced steps' residual-VQ
encodes (the semantic level, then the acoustic levels, over every session's
row) over their measured device time, in %."""

NAMES = ("rvq_split_kernel", "rvq_tiled_kernel", "codeword_sq_norms")


def read(run):
    z, c = run.z, run.counts
    spent = sum(e - s for name, s, e in run.events if any(n in name for n in NAMES))
    if not spent:
        return None
    n = run.sessions
    unit = c.k3_unit(n)
    bound = c.bound_s(*c.k3_call(z, n, 1), unit) + c.bound_s(
        *c.k3_call(z, n, z["num_codebooks"] - 1), unit)
    return 100.0 * bound * run.trace_steps / (spent / 1e6)
