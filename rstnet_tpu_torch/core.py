"""Parameter helpers and the numpy bridge to the JAX package's pytrees.

Counterpart of ``rstnet_tpu/core.py``. A JAX param pytree is a nested dict
(and list) of arrays; ``flatten_dict`` there joins its paths with ``.``. Every
module of this package names its parameters so that ``state_dict()`` keys are
exactly those paths, which makes the bridge a key-by-key copy.

The bridge takes and gives numpy arrays and never imports JAX. JAX's bf16
arrays reach numpy as ``ml_dtypes.bfloat16``; they cross bit for bit through a
16-bit integer view, never through float32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def new_param(data: torch.Tensor) -> nn.Parameter:
    """Inference parameter: no autograd tracking."""
    return nn.Parameter(data, requires_grad=False)


def default_generator(generator: torch.Generator | None, device) -> torch.Generator:
    """The caller's generator, or a fresh one seeded 0 on ``device``."""
    if generator is not None:
        return generator
    return torch.Generator(device=torch.device(device or "cpu")).manual_seed(0)


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


def _to_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_jax_params(flat: dict[str, np.ndarray], module: nn.Module) -> nn.Module:
    """Load ``{dotted JAX path: numpy array}`` into ``module`` in place.

    Keys, shapes and dtypes must match the module's ``state_dict()`` exactly;
    bf16 arrays are carried bit for bit."""
    own = module.state_dict()
    missing = sorted(set(own) - set(flat))
    extra = sorted(set(flat) - set(own))
    if missing or extra:
        raise KeyError(f"param trees differ: missing {missing}, unexpected {extra}")
    with torch.no_grad():
        for name, target in own.items():
            src = _to_torch(np.asarray(flat[name]))
            if tuple(src.shape) != tuple(target.shape) or src.dtype != target.dtype:
                raise ValueError(
                    f"{name}: got {src.dtype}{tuple(src.shape)}, "
                    f"module holds {target.dtype}{tuple(target.shape)}"
                )
            target.copy_(src)
    return module


def to_numpy(module: nn.Module) -> dict[str, np.ndarray]:
    """``state_dict()`` as numpy arrays keyed by dotted path (bf16 arrays as
    ``ml_dtypes.bfloat16``, bit for bit)."""
    out = {}
    for name, t in module.state_dict().items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            out[name] = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            out[name] = t.numpy()
    return out
