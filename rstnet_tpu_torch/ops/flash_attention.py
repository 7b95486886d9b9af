"""Flash attention for the backbone's training forwards (counterpart of
``rstnet_tpu/ops/flash_attention.py``).

The JAX package routes a training forward through jax's Pallas splash
kernel when the config enables it and the shape qualifies; the port routes
it through K6 (``ops/cuda_flash.py``, ``csrc/flash_attention.cu``): O(T)
memory instead of the ``[B, H, T, T]`` logits. The routing is the same:
causal attention, or local attention with ``delta < context`` when
``context < T``; GQA inside the kernels (K/V at their own head count, dK/dV
summed over each group in the kernel; the plain reference repeats K/V and
autograd of the repeat sums the groups); q scaled in its own dtype before
the kernel; T >= 512, T % 512 == 0 and no softcap
(:func:`flash_qualifies`). ``enabled`` carries the device condition: the
trainer enables flash only on a CUDA device, as the JAX trainer does only
on a TPU.
"""

from __future__ import annotations

import torch

from rstnet_tpu_torch.ops.cuda_flash import flash_attention_kernel, masked_logits, repeat_kv

BLOCK = 512  # the splash kernel's default block: T must be a multiple


def attention_window(T: int, context: int | None) -> int:
    """Keys visible to a query: ``delta < context`` when ``context < T``
    (the local mask), else the whole causal past."""
    return context if context is not None and context < T else T


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, context: int | None,
                    scale: float) -> torch.Tensor:
    """q [B, H, T, D]; k, v [B, Hkv, T, D] -> [B, H, T, D] in q's dtype,
    through the kernels on a CUDA tensor and their plain versions on a CPU
    tensor (same autograd function). K and V go in unrepeated."""
    q = (q * scale).to(q.dtype)
    return flash_attention_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                                  attention_window(q.shape[2], context))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                              context: int | None, scale: float) -> torch.Tensor:
    """Plain version, differentiated by autograd: the same q pre-scale in
    q's dtype, a float32 masked softmax, then the weights in v's dtype times
    v (``tests/test_flash_attention.py::_reference`` with the pre-scale)."""
    k, v = repeat_kv(q, k, v)
    q = (q * scale).to(q.dtype)
    att = torch.softmax(masked_logits(q, k, attention_window(q.shape[2], context)), dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", att.to(v.dtype), v)


def flash_qualifies(T: int, context: int | None, softcap: float | None, enabled: bool) -> bool:
    """Static predicate: route this attention call through K6?"""
    return enabled and softcap is None and T >= BLOCK and T % BLOCK == 0
