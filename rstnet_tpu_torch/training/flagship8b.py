"""Flagship-scale (8B) PEFT training construction (counterpart of
``rstnet_tpu/training/flagship8b.py``).

The reference's flagship recipe trains a Llama-3.1-8B backbone with LoRA.
Here the frozen backbone is held in weight-only int8
(``models/backbone.py::quantize_backbone_int8``) and only the LoRA factors
and the new speech modules (codecformer, audio embeddings and heads) train,
through the partitioned step (``training/train_step.py``): no 8B-sized
gradient or optimizer buffer ever exists.

:func:`abstract_peft_8b` builds the model on the ``meta`` device (shapes and
dtypes, no storage) through the same steps as a real build: init, LoRA
attached, the backbone quantized. :func:`materialize_random` then fills it
leaf by leaf on the target device from a seeded ``torch.Generator``, so the
bf16 base tree (16 GB) is never held: each int8 leaf is born int8. Step time
and memory depend only on shapes and dtypes, not values.

``build_peft_8b(..., mesh=)`` is the multi-rank path, as JAX's: the meta model
is placed by ``parallel/sharding.py::shard_params`` (``spec_for`` of every
leaf) before any storage exists, and each leaf is then drawn whole, one at a
time, and only this rank's shard of it kept: the values equal the
one-device build's, and a rank never holds more than its shards and one
leaf. ``shard_bytes(infer_param_placements(mesh, model), ...)`` is the
per-rank budget of a mesh, from the shapes alone.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rstnet_tpu_torch.core import new_param
from rstnet_tpu_torch.models.backbone import quantize_backbone_int8
from rstnet_tpu_torch.models.config import Config
from rstnet_tpu_torch.models.lm import SpeechTextLM
from rstnet_tpu_torch.models.lora import attach_lora, init_lora, lora_trainable_mask
from rstnet_tpu_torch.parallel.mesh import Mesh
from rstnet_tpu_torch.parallel.sharding import local, local_shard, shard_params
from rstnet_tpu_torch.training.train_step import partition_params


def flagship_8b_config(lora_r: int = 16, lora_alpha: int = 32, device="cuda",
                       **overrides) -> Config:
    """Llama-3.1-8B backbone + the Moshi-scale codecformer (1024 x 6), LoRA
    fields set, remat on; flash attention where ``device`` is a card, as
    the JAX function turns it on where the backend is a TPU."""
    kw = dict(
        context=3000, audio_card=2048, n_q=8, dep_q=8,
        codecformer_dim=1024, codecformer_heads=16, codecformer_layers=6,
        codecformer_dim_feedforward=1024,
        lora_r=lora_r, lora_alpha=lora_alpha,
        remat=True,
        use_flash_attention=torch.device(device).type == "cuda",
    )
    kw.update(overrides)
    return Config.from_name("Llama-3.1-8B", **kw)


def peft_8b_mask(model: nn.Module) -> dict[str, bool]:
    """Trainable mask of the flagship PEFT split: inside the backbone only
    LoRA factors train; every other tree (codecformer, audio embeddings and
    heads) is new and trains whole."""
    return {name: train or not name.startswith("backbone.")
            for name, train in lora_trainable_mask(model).items()}


def abstract_peft_8b(cfg: Optional[Config] = None, base_int8: bool = True,
                     dtype=torch.bfloat16) -> tuple[SpeechTextLM, dict[str, bool]]:
    """(model on the ``meta`` device, trainable mask): init, LoRA attached,
    and the backbone quantized when ``base_int8`` (the factors stay float,
    the walk swaps only each linear's weight). Nothing is materialized."""
    cfg = cfg or flagship_8b_config()
    model = SpeechTextLM(cfg, device="meta", dtype=dtype)
    attach_lora(model.backbone, init_lora(cfg, dtype=dtype, device="meta"))
    if base_int8:
        quantize_backbone_int8(model.backbone)
    return model, peft_8b_mask(model)


@torch.no_grad()
def materialize_random(model: nn.Module, generator: torch.Generator, device) -> nn.Module:
    """Give every parameter of a ``meta`` model storage on ``device``, leaf
    by leaf, in place: int8 leaves uniform random bytes, other integer
    leaves zeros, float leaves N(0, 0.02) (the model's init scale, so losses
    stay finite). ``generator`` lives on ``device``."""
    for module in model.modules():
        for name, p in list(module._parameters.items()):
            if p is None:
                continue
            if p.dtype == torch.int8:
                t = torch.randint(-128, 128, p.shape, generator=generator, device=device,
                                  dtype=torch.int8)
            elif not p.is_floating_point():
                t = torch.zeros(p.shape, dtype=p.dtype, device=device)
            else:
                t = torch.empty(p.shape, dtype=p.dtype, device=device)
                t.normal_(0.0, 0.02, generator=generator)
            module._parameters[name] = new_param(t)
    return model


def bytes_table(params: dict[str, torch.Tensor]) -> dict:
    """Total bytes by dtype, in GiB: the memory budget's accounting."""
    total, by = 0, {}
    for t in params.values():
        b = t.numel() * t.element_size()
        total += b
        key = str(t.dtype).removeprefix("torch.")
        by[key] = by.get(key, 0) + b
    return {"total_gb": round(total / 2**30, 3),
            **{f"{k}_gb": round(v / 2**30, 3) for k, v in by.items()}}


@torch.no_grad()
def materialize_sharded(model: nn.Module, generator: torch.Generator, device) -> nn.Module:
    """:func:`materialize_random` for a meta model placed by
    ``shard_params``: storage for this rank's shards only, each leaf drawn
    whole in the one-device order (the blocks of other pipeline stages
    too, to keep the draws aligned) and its local shard kept."""
    layout = model._shard_layout
    model.to_empty(device=device)
    own = dict(model.named_parameters())
    for name, shape in layout.shapes.items():
        dtype = layout.dtypes[name]
        if dtype == torch.int8:
            t = torch.randint(-128, 128, shape, generator=generator, device=device,
                              dtype=torch.int8)
        elif not dtype.is_floating_point:
            t = torch.zeros(shape, dtype=dtype, device=device)
        else:
            t = torch.empty(shape, dtype=dtype, device=device)
            t.normal_(0.0, 0.02, generator=generator)
        if name in own:
            local(own[name]).copy_(local_shard(t, layout.placements[name].spec, layout.mesh))
    return model


def build_peft_8b(generator: torch.Generator, cfg: Optional[Config] = None,
                  base_int8: bool = True, dtype=torch.bfloat16, device="cuda",
                  mesh: Optional[Mesh] = None):
    """(model, trainable, frozen, mask) materialized with random values on
    ``device``, the frozen backbone already int8 under ``base_int8``, and
    ``requires_grad`` set along the mask. With a ``mesh`` every leaf is
    placed by ``spec_for`` as it is created (this rank's shards only)."""
    model, mask = abstract_peft_8b(cfg, base_int8, dtype)
    if mesh is None or mesh.world == 1:
        materialize_random(model, generator, device)
    else:
        shard_params(mesh, model)
        materialize_sharded(model, generator, device)
        mask = {n: v for n, v in mask.items() if n in dict(model.named_parameters())}
    trainable, frozen = partition_params(model, mask)
    return model, trainable, frozen, mask
