"""Parameter helpers and the numpy bridge to the JAX package's pytrees.

Counterpart of ``rstnet_tpu/core.py``. A JAX param pytree is a nested dict
(and list) of arrays; ``flatten_dict`` there joins its paths with ``.``. Every
module of this package names its parameters so that ``state_dict()`` keys are
exactly those paths, which makes the bridge a key-by-key copy.

The bridge takes numpy arrays or torch tensors (the checkpoint converter's
trees, ``models/convert.py``), gives numpy arrays, and never imports JAX.
JAX's bf16 arrays reach numpy as ``ml_dtypes.bfloat16``; they cross bit for
bit through a 16-bit integer view, never through float32. Where the port keeps one module
per layer and JAX stacks the layers along a leading axis (the backbone's
``blocks``), ``stacked`` names the prefixes whose JAX leaves are split
(``blocks.attn.weight [L, ...]`` -> ``blocks.{i}.attn.weight``) on the way
in and stacked again on the way out.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def new_param(data: torch.Tensor) -> nn.Parameter:
    """Inference parameter: no autograd tracking."""
    return nn.Parameter(data, requires_grad=False)


def default_generator(generator: torch.Generator | None, device) -> torch.Generator:
    """The caller's generator, or a fresh one seeded 0 on ``device`` (on the
    CPU for a ``meta`` build, which draws nothing)."""
    if generator is not None:
        return generator
    device = torch.device(device or "cpu")
    return torch.Generator(device="cpu" if device.type == "meta" else device).manual_seed(0)


def uniform(shape, bound: float, generator, device=None, dtype=torch.float32):
    """U(-bound, bound), the JAX package's linear/conv init."""
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.uniform_(-bound, bound, generator=generator)


def normal(shape, generator, device=None, dtype=torch.float32):
    t = torch.empty(shape, device=device, dtype=dtype)
    return t.normal_(generator=generator)


def container(**params: torch.Tensor) -> nn.Module:
    """A bare module holding the given tensors as parameters (a JAX
    sub-dict such as ``{"weight": w}``)."""
    m = nn.Module()
    for name, value in params.items():
        m.register_parameter(name, new_param(value))
    return m


def fold_in(seed: int, i: int) -> int:
    """A new 63-bit seed from ``seed`` and ``i`` (splitmix64 of their mix):
    the port's counterpart of ``jax.random.fold_in``, for seeding one
    ``torch.Generator`` per dropout site. It gives other bits than JAX."""
    z = (seed * 0x9E3779B97F4A7C15 + i + 1) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (z ^ (z >> 31)) >> 1


def lora_dropout(x: torch.Tensor, drop) -> torch.Tensor:
    """Dropout on a LoRA branch input (counterpart of the JAX function; the
    reference's ``LoRALinear`` drops x before the A matrix). ``drop`` is a
    ``(rate, torch.Generator)`` pair on x's device, or None: None or rate 0
    is the identity. Inverted dropout: kept elements are divided by the keep
    rate in x's dtype, so eval needs no rescale."""
    if drop is None or drop[0] == 0.0:
        return x
    rate, generator = drop
    keep = 1.0 - rate
    mask = _whole_batch_rand(x, generator) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _whole_batch_rand(x: torch.Tensor, generator) -> torch.Tensor:
    """``torch.rand`` of x's shape; where the ambient mesh splits the batch
    (rows over ``data`` x ``fsdp``, dim 1 of a 3+-dim x over ``seq``), this
    rank's part of the draw over the whole batch, so that its mask is the
    one-process mask's rows. (A pipeline's microbatches each draw their own.)"""
    from rstnet_tpu_torch.parallel.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None or mesh.world == 1:
        return torch.rand(x.shape, generator=generator, device=x.device)
    n_rows, n_seq = mesh.size("data") * mesh.size("fsdp"), mesh.size("seq")
    row = mesh.coord("data") * mesh.size("fsdp") + mesh.coord("fsdp")
    n_seq = n_seq if x.dim() >= 3 else 1
    shape = (x.shape[0] * n_rows, *((x.shape[1] * n_seq,) if x.dim() >= 2 else ()),
             *x.shape[2:])
    whole = torch.rand(shape, generator=generator, device=x.device)
    part = whole.narrow(0, row * x.shape[0], x.shape[0])
    if n_seq > 1:
        part = part.narrow(1, mesh.coord("seq") * x.shape[1], x.shape[1])
    return part


def fold_drop(drop, i: int):
    """Site ``i`` under a model's ``(rate, seed)`` dropout pair (``jax.random.fold_in``
    of the JAX key), or None."""
    return None if drop is None else (drop[0], fold_in(drop[1], i))


def dropout_pair(drop, device):
    """A ``(rate, seed)`` pair as :func:`lora_dropout`'s ``(rate,
    torch.Generator)`` on ``device``, or None. The generator is made from the
    seed at each use, so a recomputed block (remat) draws the same masks."""
    if drop is None:
        return None
    return drop[0], torch.Generator(device=device).manual_seed(drop[1])


def _to_torch(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def flatten_dict(tree, prefix: str = "", sep: str = "."):
    """Yield (dotted path, leaf) pairs from a nested dict/list tree (a copy
    of the JAX package's ``core.flatten_dict``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flatten_dict(v, f"{prefix}{sep}{k}" if prefix else str(k), sep)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from flatten_dict(v, f"{prefix}{sep}{i}" if prefix else str(i), sep)
    else:
        yield prefix, tree


def unstack_layers(flat: dict[str, np.ndarray], stacked=()) -> dict[str, np.ndarray]:
    """Split the leaves under each ``stacked`` prefix along their first axis."""
    out = {}
    for name, a in flat.items():
        prefix = next((p for p in stacked if name.startswith(p + ".")), None)
        if prefix is None:
            out[name] = a
            continue
        rest = name[len(prefix) + 1:]
        for i in range(np.shape(a)[0]):
            out[f"{prefix}.{i}.{rest}"] = a[i]
    return out


def stack_layers(flat: dict[str, np.ndarray], stacked=()) -> dict[str, np.ndarray]:
    """Inverse of :func:`unstack_layers`."""
    out, layers = {}, {}
    for name, a in flat.items():
        prefix = next((p for p in stacked if name.startswith(p + ".")), None)
        if prefix is None:
            out[name] = a
            continue
        index, rest = name[len(prefix) + 1:].split(".", 1)
        layers.setdefault(f"{prefix}.{rest}", {})[int(index)] = a
    for name, by_index in layers.items():
        out[name] = np.stack([by_index[i] for i in range(len(by_index))])
    return out


def from_jax_params(flat: dict, module: nn.Module, stacked=(), buffers: dict | None = None
                    ) -> nn.Module:
    """Load ``{dotted JAX path: numpy array or tensor}`` into ``module`` in
    place.

    Keys, shapes and dtypes must match the module's ``state_dict()`` exactly
    (after splitting the ``stacked`` prefixes per layer); bf16 arrays are
    carried bit for bit. ``buffers``: the flat tree of a JAX module's
    non-trainable state (the codec's EMA codebook statistics), which the
    port keeps as buffers of the same module, named by the same paths.
    Leaves that are not arrays (``None``, static entries of a JAX tree) are
    skipped."""
    flat = {k: v for k, v in {**flat, **(buffers or {})}.items() if v is not None}
    flat = unstack_layers(flat, stacked)
    own = module.state_dict()
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, target in own.items():
            src = _to_torch(flat[name])
            if tuple(src.shape) != tuple(target.shape) or src.dtype != target.dtype:
                raise ValueError(
                    f"{name}: got {src.dtype}{tuple(src.shape)}, "
                    f"module holds {target.dtype}{tuple(target.shape)}"
                )
            target.copy_(src)
    return module


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy (bf16 as ``ml_dtypes.bfloat16``, bit for bit)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_numpy(module: nn.Module, stacked=(), part: str = "all") -> dict[str, np.ndarray]:
    """``state_dict()`` as numpy arrays keyed by dotted JAX path (bf16 arrays
    as ``ml_dtypes.bfloat16``, bit for bit; ``stacked`` prefixes restacked).
    ``part``: "all", "params" (the parameters only) or "buffers" (the
    buffers only: the JAX buffer tree)."""
    if part not in ("all", "params", "buffers"):
        raise ValueError(f"unknown part {part!r}")
    names = None
    if part != "all":
        named = module.named_parameters() if part == "params" else module.named_buffers()
        names = {n for n, _ in named}
    return stack_layers({name: tensor_to_numpy(t) for name, t in module.state_dict().items()
                         if names is None or name in names}, stacked)
