"""The modules a benchmark process must never hold: JAX and the JAX package
this program was ported from, compared by whole top-level name (the port's
own name begins with the JAX package's)."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "rstnet_tpu"})


def forbidden_loaded() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)
