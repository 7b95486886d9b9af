"""Seeded random weights, drawn on the device in a few large calls.

Every tensor of the layout (``reference/layout.py``) is a view into one flat
buffer per (dtype, draw): one uniform draw and one normal draw for each
dtype, in the layout's order, from one ``torch.Generator`` seeded with the
run's seed. The same seed gives the same tensors on the same device, so the
program's modules get them at set-up and the reference draws them again
after the window, with nothing passed between the two.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def draw(spec: list, seed: int, device) -> dict:
    """{name: tensor} for every entry of ``spec``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    out = {}
    for dtype in sorted({e[2] for e in spec}):
        for kind in ("uniform", "normal"):
            entries = [e for e in spec if e[2] == dtype and e[3] == kind]
            if not entries:
                continue
            total = sum(_numel(e[1]) for e in entries)
            flat = torch.empty(total, dtype=DTYPES[dtype], device=device)
            if kind == "uniform":
                flat.uniform_(-1.0, 1.0, generator=g)
            else:
                flat.normal_(generator=g)
            at = 0
            for name, shape, _, _, scale in entries:
                n = _numel(shape)
                view = flat[at : at + n].view(shape)
                if scale is not None:
                    view.mul_(scale)
                out[name] = view
                at += n
    for name, shape, dtype, kind, scale in spec:
        if kind in ("ones", "zeros", "const"):
            value = {"ones": 1.0, "zeros": 0.0}.get(kind, scale)
            out[name] = torch.full(shape, value, dtype=DTYPES[dtype], device=device)
    return {name: out[name] for name, *_ in spec}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


@torch.no_grad()
def load(module: torch.nn.Module, weights: dict, prefix: str) -> None:
    """Copy ``weights[prefix + name]`` into every parameter and buffer of
    ``module``, which must hold exactly those names, shapes and dtypes."""
    own = dict(module.state_dict(keep_vars=True))
    theirs = {k[len(prefix):]: v for k, v in weights.items() if k.startswith(prefix)}
    if own.keys() != theirs.keys():
        raise ValueError(f"{type(module).__name__}: the layout lacks "
                         f"{sorted(own.keys() - theirs.keys())[:8]} and has extra "
                         f"{sorted(theirs.keys() - own.keys())[:8]}")
    for name, t in own.items():
        src = theirs[name]
        if t.shape != src.shape or t.dtype != src.dtype:
            raise ValueError(f"{prefix}{name}: {tuple(t.shape)} {t.dtype} in the program, "
                             f"{tuple(src.shape)} {src.dtype} in the layout")
        t.copy_(src)
