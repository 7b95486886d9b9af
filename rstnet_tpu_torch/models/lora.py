"""LoRA on the backbone and the streaming transformer (counterpart of
``rstnet_tpu/models/lora.py``).

The factors are parameters of small submodules under the JAX dict's names:
``lora`` (``A [r, in]``, ``B [out, r]``) beside a linear's ``weight``,
``lora_q`` / ``lora_k`` / ``lora_v`` inside the packed ``attn`` linear, and
``lora_in_proj`` / ``lora_out_proj`` (``A``, ``B`` and ``scaling``, stacked
over the layers) inside a ``StreamingTransformer``'s ``layers``. So a module's
``state_dict`` names are the JAX overlay's dotted paths (the backbone's
``blocks`` split per layer, ``core.unstack_layers``), and a JAX overlay
crosses the numpy bridge unchanged.

An overlay here is a flat ``{state_dict name: tensor}`` dict:
:func:`init_lora` and :func:`init_lora_streaming_transformer` make one,
:func:`attach_lora` adds it to a module in place, :func:`strip_lora` takes
every factor away again, :func:`lora_filter` keeps only the factors of a
``state_dict``. The trainable set is ``requires_grad``
(:func:`lora_trainable_mask`); :func:`merge_lora` returns merged weights and
leaves the module as it is.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rstnet_tpu_torch.core import container, default_generator, new_param, uniform
from rstnet_tpu_torch.models.config import Config


def _ab_init(prefix: str, r: int, in_dim: int, out_dim: int, g, device, dtype,
             lead: tuple = ()) -> dict[str, torch.Tensor]:
    # the reference's init: A kaiming-uniform, B zeros, so the delta starts at 0
    return {f"{prefix}.A": uniform(lead + (r, in_dim), 1.0 / math.sqrt(in_dim), g, device, dtype),
            f"{prefix}.B": torch.zeros(lead + (out_dim, r), device=device, dtype=dtype)}


def init_lora(cfg: Config, generator=None, dtype=torch.float32, device=None
              ) -> dict[str, torch.Tensor]:
    """An overlay for a ``Backbone`` of ``cfg`` (``blocks.{i}.attn.lora_q.A``,
    ...): q/k/v, projection, MLP and head factors as the config's
    ``lora_*`` flags ask."""
    if cfg.lora_r <= 0:
        raise ValueError("init_lora needs config.lora_r > 0")
    g = default_generator(generator, device)
    r, n_embd, hs = cfg.lora_r, cfg.n_embd, cfg.head_size
    out: dict[str, torch.Tensor] = {}
    for i in range(cfg.n_layer):
        b = f"blocks.{i}"
        if cfg.lora_query:
            out.update(_ab_init(f"{b}.attn.lora_q", r, n_embd, cfg.n_head * hs, g, device, dtype))
        if cfg.lora_key:
            out.update(_ab_init(f"{b}.attn.lora_k", r, n_embd, cfg.n_query_groups * hs, g,
                                device, dtype))
        if cfg.lora_value:
            out.update(_ab_init(f"{b}.attn.lora_v", r, n_embd, cfg.n_query_groups * hs, g,
                                device, dtype))
        if cfg.lora_projection:
            out.update(_ab_init(f"{b}.proj.lora", r, cfg.n_head * hs, n_embd, g, device, dtype))
        if cfg.lora_mlp:
            names = ("fc", "proj") if cfg.mlp_class_name == "GptNeoxMLP" else ("fc_1", "fc_2",
                                                                               "proj")
            for name in names:
                into = name != "proj"
                out.update(_ab_init(f"{b}.mlp.{name}.lora", r,
                                    n_embd if into else cfg.intermediate_size,
                                    cfg.intermediate_size if into else n_embd, g, device, dtype))
    if cfg.lora_head:
        out.update(_ab_init("lm_head.lora", r, n_embd, cfg.padded_vocab_size, g, device, dtype))
    return out


def init_lora_streaming_transformer(transformer, generator=None, r: int = 8, alpha: int = 16,
                                    dtype=torch.float32, device=None) -> dict[str, torch.Tensor]:
    """An overlay for a ``StreamingTransformer`` (LoRA-Moshi fine-tuning):
    factors on every layer's packed ``in_proj`` and ``out_proj``, stacked
    ``[L, ...]`` as the layer weights are, each with its ``scaling``
    ``alpha / r``."""
    if transformer.weights_per_step:
        raise ValueError("LoRA on per-step weights is not supported")
    g = default_generator(generator, device)
    L, d = transformer.num_layers, transformer.d_model
    out: dict[str, torch.Tensor] = {}
    for name, out_dim in (("lora_in_proj", 3 * d), ("lora_out_proj", d)):
        out.update(_ab_init(f"layers.{name}", r, d, out_dim, g, device, dtype, lead=(L,)))
        out[f"layers.{name}.scaling"] = torch.full((L,), alpha / r, device=device, dtype=dtype)
    return out


def is_lora_path(name: str) -> bool:
    """Whether a dotted parameter name lies under a LoRA factor module."""
    return any(part == "lora" or part.startswith("lora_") for part in name.split("."))


def attach_lora(module: nn.Module, overlay: dict[str, torch.Tensor]) -> nn.Module:
    """Add the overlay's factors to ``module`` in place, each under its
    dotted name (the factor modules are made where missing; an existing
    factor is replaced). Returns ``module``."""
    for name, value in overlay.items():
        path, leaf = name.rsplit(".", 1)
        parent_path, factor = path.rsplit(".", 1) if "." in path else ("", path)
        if not is_lora_path(path):
            raise KeyError(f"{name} is not a LoRA factor")
        parent = module.get_submodule(parent_path) if parent_path else module
        if factor not in parent._modules:
            parent.add_module(factor, container())
        parent._modules[factor].register_parameter(leaf, new_param(value))
    return module


def strip_lora(module: nn.Module) -> nn.Module:
    """Take every LoRA factor module out of ``module``, in place."""
    for child in list(module.modules()):
        for name in [n for n in child._modules if is_lora_path(n)]:
            del child._modules[name]
    return module


def lora_trainable_mask(module: nn.Module) -> dict[str, bool]:
    """``{parameter name: trainable}``, True only under LoRA factors (the
    reference's ``mark_only_lora_as_trainable``)."""
    return {name: is_lora_path(name) for name, _ in module.named_parameters()}


def lora_filter(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The LoRA factors of a ``state_dict``-like dict: the PEFT checkpoint
    (the reference's ``lora_filter``)."""
    return {name: t for name, t in params.items() if is_lora_path(name)}


@torch.no_grad()
def merge_lora(cfg: Config, module: nn.Module) -> dict[str, torch.Tensor]:
    """The backbone's ``state_dict`` with every factor folded into its base
    weight (``W + B A alpha / r``, q/k/v deltas scattered into the packed
    grouped QKV rows) and the factors dropped. ``module`` is not changed."""
    scaling = cfg.lora_alpha / cfg.lora_r
    sd = {name: t for name, t in module.state_dict().items() if not is_lora_path(name)}
    for name, child in module.named_modules():
        prefix = f"{name}." if name else ""
        factors = {n: m for n, m in child._modules.items() if is_lora_path(n)}
        if not factors or "weight" not in child._parameters:
            continue
        W = child.weight
        if "lora" in factors:
            lora = factors["lora"]
            W = W + ((lora.B @ lora.A) * scaling).to(W.dtype)
        # q/k/v deltas into the packed grouped rows [G x (q_per_kv q, 1 k, 1 v)] x hs
        G, hs = cfg.n_query_groups, cfg.head_size
        q_per_kv = cfg.n_head // G
        slots = {"lora_q": slice(0, q_per_kv), "lora_k": slice(q_per_kv, q_per_kv + 1),
                 "lora_v": slice(q_per_kv + 1, q_per_kv + 2)}
        if any(n in factors for n in slots):
            Wv = W.reshape(G, q_per_kv + 2, hs, W.shape[-1]).clone()
            for n, rows in slots.items():
                if n in factors:
                    delta = (factors[n].B @ factors[n].A) * scaling
                    Wv[:, rows] += delta.reshape(G, -1, hs, W.shape[-1]).to(W.dtype)
            W = Wv.reshape(W.shape)
        sd[f"{prefix}weight"] = W
    return sd
