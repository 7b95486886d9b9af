"""Decoder-only LLM backbone, offline forward and streaming step (counterpart
of ``rstnet_tpu/models/backbone.py``).

MHA/GQA/MQA in one packed QKV layout, partial rotary with the Llama-3.1
adjustment, per-layer sliding windows, attention and final logit softcaps,
post-norms, parallel or sequential residual, and the GptNeox, LLaMA and
Gemma MLPs. Training forwards route attention through the flash kernel K6
(``ops/flash_attention.py``) where the JAX package routes it through splash;
everything else takes the masked grouped-einsum path, as in JAX.

The JAX package stacks the blocks along a leading layer axis; here each block
is its own module (``blocks.{i}.attn.weight``), so each layer's parameters
and gradients are separate tensors. ``STACKED`` names that prefix for the
numpy bridge (``core.from_jax_params(..., stacked=)``), which splits and
restacks the JAX leaves. ``remat`` checkpoints every block
(``torch.utils.checkpoint``, non-reentrant): the backward recomputes the
block from its input, as ``jax.checkpoint`` does; what is saved differs, the
values do not.

Streaming: ``init_state`` builds the ring KV (stacked ``[L, ...]`` or one ring
per layer, float or int8 with per-step scales) and ``step`` runs a chunk
through it, looping over the layers in both layouts and writing the rings in
place. A residual that turns float32 after layer 0 (bf16 weights over a
float32 ring) is carried as in the JAX per-layer loop. In ``step`` only, a
LLaMAMLP inside the envelope of the fused gated-FFN kernels (no bias, N = B*T
<= 64 rows, C and H multiples of 128, all three weights float or all three
int8) goes through K4 (``ops/cuda_ffn.py::gating_ffn``) or K5
(``gating_ffn_int8``): on every device, the kernel on the card (one stream of
the weights through the tensor cores for all N rows) and its plain version on
the CPU. They keep the gate, value and hidden in float32 where the JAX
``_mlp`` rounds them to the activation dtype (see ``ops/cuda_ffn.py``).

int8 (``quantize_backbone_int8``, in place): a linear's ``weight`` becomes
``w_int8`` and ``scale``, the JAX dict's names; ``linear`` dequantizes in
x's dtype, as JAX does, through an autograd function that saves the codes
and dequantizes again in the backward (a frozen int8 base under LoRA keeps
no float copy of its weights for the backward).

LoRA (``models/lora.py``): a linear's ``lora`` factors add ``(x A^T) B^T
alpha / r`` after the base product; the packed ``attn`` takes q/k/v deltas
(``lora_q``, ``lora_k``, ``lora_v``) from one dropped input. LoRA-branch
dropout (``config.lora_dropout``) runs when the training forward is given a
``dropout_rng`` (a CPU ``torch.Generator``): it draws a seed a layer and one
for the head, and each dropout site seeds its own generator from them
(``core.fold_drop``, ``core.dropout_pair``), so a recomputed block draws
the same masks. MoE (``LLaMAMoE``): a router top-k, a float32 softmax over
the k, and a dense combine over all experts, as in JAX.

Under an ambient mesh (``parallel/mesh.py::set_mesh``) and a model placed by
``parallel/sharding.py::shard_params``, the training forward routes as the
JAX one does:

* ``seq`` > 1: this rank holds a time slice; positions start at its offset
  and attention is ``ops/context_parallel.py`` (a ring of K/V blocks, GQA
  heads repeated first), ahead of K6.
* ``pipe`` > 1 with the blocks held by stages: the layer loop is the GPipe
  schedule of ``parallel/pipeline.py`` over ``pipeline_microbatches`` (one
  microbatch when the rows do not divide: the plain loop, run stage by
  stage), each layer's body checkpointed under ``remat``.
* ``tensor`` > 1: attention and the MLP run Megatron-style on the local
  shards (column-parallel QKV and up-projections, row-parallel output
  projections, one all-reduce a sublayer); q/k/v reach K6 as plain local
  tensors of whole heads. Every other sharded weight is gathered where it
  is used.
* ``expert`` > 1: each rank runs its experts of the ``[E, ...]`` stacks and
  the mixture is summed over the ``expert`` axis.

The streaming ``step`` runs Megatron-style on the local shards too, under
``tensor`` > 1 (the serving frame; see ``parallel/sharding.py::serving_view``):
``init_state`` holds this rank's ``G/T`` KV groups when ``T`` divides ``G``
(else all ``G``, the QKV output gathered as in training), QKV is
column-parallel and writes the ring with its heads, ``proj`` is row-parallel,
the decode MLP runs K4 on the local ``[H/T, C]``/``[C, H/T]`` shards into a
float32 partial that is summed over ``tensor`` (one rounding to the
activation dtype, as one process rounds), ``embed`` is vocab-parallel and
``logits`` column-parallel with the row gathered for sampling. The only
per-frame collectives are those sums and that gather.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rstnet_tpu_torch.core import (
    container,
    default_generator,
    dropout_pair,
    fold_drop,
    lora_dropout,
    new_param,
    normal,
    uniform,
)
from rstnet_tpu_torch.models.config import Config, rope_extra_config
from rstnet_tpu_torch.modules.transformer import quantize_weight_int8
from rstnet_tpu_torch.ops.attention import ring_kv_buffers, ring_kv_update
from rstnet_tpu_torch.ops.context_parallel import context_parallel_attention
from rstnet_tpu_torch.ops.cuda_ffn import FFN_MAX_ROWS, gating_ffn, gating_ffn_int8
from rstnet_tpu_torch.ops.flash_attention import flash_attention, flash_qualifies
from rstnet_tpu_torch.ops.rope import apply_rope_halved, build_rope_cache
from rstnet_tpu_torch.parallel.comm import (
    chunk_of,
    copy_to,
    gather_dim,
    gather_replicated,
    reduce_from,
    table_rows,
)
from rstnet_tpu_torch.parallel.mesh import current_mesh
from rstnet_tpu_torch.parallel.pipeline import spmd_pipeline
from rstnet_tpu_torch.parallel.sharding import dense, is_dtensor, local, row_split_group

STACKED = ("blocks",)
_FLOAT = (torch.float32, torch.bfloat16)


class _Int8Matmul(torch.autograd.Function):
    """``x (w_int8 scale)^T`` with the weight dequantized in x's dtype;
    the backward dequantizes it again instead of keeping the forward's copy
    (the codes and scales are frozen: no gradient for them)."""

    @staticmethod
    def forward(ctx, x, w_int8, scale):
        ctx.save_for_backward(w_int8, scale)
        return x @ (w_int8 * scale.to(x.dtype)[:, None]).T

    @staticmethod
    def backward(ctx, dy):
        w_int8, scale = ctx.saved_tensors
        dx = dy @ (w_int8 * scale.to(dy.dtype)[:, None]) if ctx.needs_input_grad[0] else None
        return dx, None, None


def linear(p: nn.Module, x: torch.Tensor, scaling: float = 1.0, drop=None) -> torch.Tensor:
    """``x W^T (+ b)`` with the weight taken in x's dtype; an int8 linear
    (``w_int8`` and a per-row ``scale``) dequantizes in x's dtype first. A
    ``lora`` factor module adds ``(x_d A^T) B^T scaling``, x_d the input
    after LoRA-branch dropout (``drop``: a ``(rate, seed)`` pair or None)."""
    if "w_int8" in p._parameters:
        y = _Int8Matmul.apply(x, p.w_int8, p.scale)
    else:
        y = x @ dense(p.weight).T.to(x.dtype)
    lora = p._modules.get("lora")
    if lora is not None:
        xd = lora_dropout(x, dropout_pair(drop, x.device))
        y = y + (xd @ dense(lora.A).T.to(x.dtype)) @ dense(lora.B).T.to(x.dtype) * scaling
    if "bias" in p._parameters:
        y = y + dense(p.bias).to(x.dtype)
    return y


def _tp_sharded(*linears: nn.Module) -> bool:
    """Whether every one of the linears has a tensor-sharded float weight
    (the Megatron path; an int8 or indivisible weight stays whole)."""
    return all(is_dtensor(p._parameters.get("weight")) for p in linears)


def column_linear(p: nn.Module, x: torch.Tensor, tp, scaling: float = 1.0, drop=None
                  ) -> torch.Tensor:
    """Column-parallel ``linear``: x whole (it entered through ``copy_to``),
    this rank's output features out. The replicated bias and LoRA A go
    through ``copy_to`` as well, so their gradients are summed over the
    ranks' partial ones; LoRA B is sharded with the weight's rows."""
    y = x @ local(p.weight).T.to(x.dtype)
    lora = p._modules.get("lora")
    if lora is not None:
        xd = lora_dropout(x, dropout_pair(drop, x.device))
        a = copy_to(dense(lora.A), tp)
        y = y + (xd @ a.T.to(x.dtype)) @ local(lora.B).T.to(x.dtype) * scaling
    if "bias" in p._parameters:
        y = y + chunk_of(copy_to(dense(p.bias), tp), 0, tp).to(x.dtype)
    return y


def row_linear(p: nn.Module, x: torch.Tensor, tp, scaling: float = 1.0, drop=None
               ) -> torch.Tensor:
    """Row-parallel ``linear``: this rank's input features in, the whole
    output out (the partial products summed over ``tp``). A LoRA branch
    runs on the whole input, gathered: the same on every rank."""
    y = reduce_from(x @ local(p.weight).T.to(x.dtype), tp)
    lora = p._modules.get("lora")
    if lora is not None:
        x_all = gather_replicated(x, -1, tp)
        xd = lora_dropout(x_all, dropout_pair(drop, x.device))
        y = y + (xd @ dense(lora.A).T.to(x.dtype)) @ dense(lora.B).T.to(x.dtype) * scaling
    if "bias" in p._parameters:
        y = y + dense(p.bias).to(x.dtype)
    return y


QUANTIZED_LINEARS = ("attn", "proj", "fc", "fc_1", "fc_2", "lm_head", "gate")


@torch.no_grad()
def quantize_linear_int8(p: nn.Module) -> nn.Module:
    """Per-output-row symmetric int8 of a linear, in place: ``weight``
    becomes ``w_int8`` and float32 ``scale`` (codes and scales equal to the
    JAX function's); a bias stays as it is, and so does a linear that is
    already int8."""
    if "weight" in p._parameters:
        q = quantize_weight_int8(p._parameters.pop("weight"))
        p.w_int8, p.scale = q.w_int8, q.scale
    return p


@torch.no_grad()
def quantize_backbone_int8(module: nn.Module) -> nn.Module:
    """Quantize the backbone's big linears (attention, projections, MLP,
    ``lm_head``) for serving, in place, by the JAX function's name walk;
    norms, embeddings and biases keep their dtype."""
    for name, child in module.named_children():
        weight = child._parameters.get("weight")
        if name in QUANTIZED_LINEARS and weight is not None and weight.dim() >= 2:
            quantize_linear_int8(child)
        else:
            quantize_backbone_int8(child)
    return module


def _linear(out_dim, in_dim, use_bias, g, device, dtype) -> nn.Module:
    bound = 1.0 / math.sqrt(in_dim)
    params = {"weight": uniform((out_dim, in_dim), bound, g, device, dtype)}
    if use_bias:
        params["bias"] = uniform((out_dim,), bound, g, device, dtype)
    return container(**params)


def _norm(cfg: Config, device, dtype) -> nn.Module:
    params = {"weight": torch.ones(cfg.n_embd, device=device, dtype=dtype)}
    if cfg.norm_class_name != "RMSNorm":
        params["bias"] = torch.zeros(cfg.n_embd, device=device, dtype=dtype)
    return container(**params)


def norm_apply(cfg: Config, p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """RMSNorm (Gemma: scale ``1 + w``) or LayerNorm, in float32, cast back."""
    xf = x.float()
    if cfg.norm_class_name == "RMSNorm":
        normed = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + cfg.norm_eps)
        w = p.weight.float()
        if "Gemma" in cfg.name or "gemma" in cfg.name:
            w = 1.0 + w
        return (normed * w).to(x.dtype)
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + cfg.norm_eps)
    return (normed * p.weight.float() + p.bias.float()).to(x.dtype)


class Block(nn.Module):
    def __init__(self, cfg: Config, g, device, dtype):
        super().__init__()
        qkv = (cfg.n_head + 2 * cfg.n_query_groups) * cfg.head_size
        self.norm_1 = _norm(cfg, device, dtype)
        self.attn = _linear(qkv, cfg.n_embd, cfg.attn_bias or cfg.bias, g, device, dtype)
        self.proj = _linear(cfg.n_embd, cfg.head_size * cfg.n_head, cfg.bias, g, device, dtype)
        mlp = nn.Module()
        if cfg.mlp_class_name == "GptNeoxMLP":
            mlp.fc = _linear(cfg.intermediate_size, cfg.n_embd, cfg.bias, g, device, dtype)
            mlp.proj = _linear(cfg.n_embd, cfg.intermediate_size, cfg.bias, g, device, dtype)
        elif cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP"):
            mlp.fc_1 = _linear(cfg.intermediate_size, cfg.n_embd, cfg.bias, g, device, dtype)
            mlp.fc_2 = _linear(cfg.intermediate_size, cfg.n_embd, cfg.bias, g, device, dtype)
            mlp.proj = _linear(cfg.n_embd, cfg.intermediate_size, cfg.bias, g, device, dtype)
        elif cfg.mlp_class_name == "LLaMAMoE":
            E, H, C = cfg.n_expert, cfg.intermediate_size, cfg.n_embd
            mlp.gate = _linear(E, C, False, g, device, dtype)
            mlp.experts = nn.Module()  # [E, ...] stacks, as the JAX vmap builds them
            mlp.experts.fc_1 = container(weight=uniform((E, H, C), C**-0.5, g, device, dtype))
            mlp.experts.fc_2 = container(weight=uniform((E, H, C), C**-0.5, g, device, dtype))
            mlp.experts.proj = container(weight=uniform((E, C, H), H**-0.5, g, device, dtype))
        else:
            raise NotImplementedError(f"{cfg.mlp_class_name} is not ported yet")
        self.mlp = mlp
        if not cfg.shared_attention_norm:
            self.norm_2 = _norm(cfg, device, dtype)
        if cfg.post_attention_norm:
            self.post_attention_norm = _norm(cfg, device, dtype)
        if cfg.post_mlp_norm:
            self.post_mlp_norm = _norm(cfg, device, dtype)


class Backbone(nn.Module):
    """The temporal transformer over embeddings; ``wte`` for text-only use."""

    def __init__(self, config: Config, *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        cfg = self.config = config
        g = default_generator(generator, device)
        self.blocks = nn.ModuleList(Block(cfg, g, device, dtype) for _ in range(cfg.n_layer))
        self.wte = new_param(normal((cfg.padded_vocab_size, cfg.n_embd), g, device, dtype) * 0.02)
        self.ln_f = _norm(cfg, device, dtype)
        self.lm_head = _linear(cfg.padded_vocab_size, cfg.n_embd, cfg.lm_head_bias, g, device,
                               dtype)

    @property
    def cfg(self) -> Config:
        return self.config

    def rope(self, positions: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        return build_rope_cache(0, cfg.rope_n_elem, base=cfg.rope_base,
                                condense_ratio=cfg.rope_condense_ratio,
                                extra_config=rope_extra_config(cfg), positions=positions.float())

    def layers(self) -> list[tuple[int, Block]]:
        """(layer index, block) of the blocks this rank holds: all of them,
        or a pipeline stage's (``backbone.blocks`` keyed by layer index)."""
        if isinstance(self.blocks, nn.ModuleDict):
            return sorted((int(i), b) for i, b in self.blocks.items())
        return list(enumerate(self.blocks))

    def layer_windows(self) -> list[int]:
        """Per-layer sliding window (0 = none; config.context still applies)."""
        cfg = self.cfg
        return [cfg.sliding_window_size
                if cfg.sliding_window_size is not None
                and i % cfg.sliding_window_layer_stride == 0 else 0
                for i in range(cfg.n_layer)]

    # -- attention ------------------------------------------------------------

    @property
    def lora_scaling(self) -> float:
        cfg = self.cfg
        return cfg.lora_alpha / cfg.lora_r if cfg.lora_r else 1.0

    def _qkv(self, block: Block, x: torch.Tensor, drop=None, tp=None):
        """q [B, H, T, hs], k and v [B, G, T, hs]. Under ``tp`` (x entered
        through ``copy_to``) the heads are this rank's: the fused weight is
        split along its output rows, G/T whole groups a rank when T divides
        G; otherwise the rows are gathered and every rank holds all heads."""
        cfg = self.cfg
        B, T, _ = x.shape
        scaling = self.lora_scaling
        q_per_kv = cfg.n_head // cfg.n_query_groups
        G, split = cfg.n_query_groups, False
        if tp is None:
            qkv = linear(block.attn, x, scaling, drop)
        else:
            qkv = column_linear(block.attn, x, tp, scaling, drop)
            n_tp = torch.distributed.get_world_size(tp)
            split = G % n_tp == 0
            if split:
                G = G // n_tp
            else:
                # the split cuts a head group: every rank takes all heads
                # (gathered; the gradient sums the ranks' parts)
                qkv = gather_dim(qkv, -1, tp)
        H = G * q_per_kv
        qkv = qkv.reshape(B, T, G, q_per_kv + 2, cfg.head_size)
        qkv = qkv.permute(0, 2, 3, 1, 4)  # [B, G, q_per_kv + 2, T, hs]
        q = qkv[:, :, :q_per_kv].reshape(B, H, T, cfg.head_size)
        k = qkv[:, :, q_per_kv].reshape(B, G, T, cfg.head_size)
        v = qkv[:, :, q_per_kv + 1].reshape(B, G, T, cfg.head_size)
        factors = block.attn._modules
        if not any(f"lora_{n}" in factors for n in "qkv"):
            return q, k, v
        # one dropped input for q, k and v (the reference's LoRAQKVLinear
        # feeds the packed A from a single dropout)
        xd = lora_dropout(x, dropout_pair(drop, x.device))

        def factor(t, rows: bool):
            if tp is None:
                return dense(t)
            if not rows:
                return copy_to(dense(t), tp)  # A: the ranks' gradients summed
            if split:
                return local(t)
            return gather_dim(local(t), 0, tp) if is_dtensor(t) else copy_to(t, tp)

        def delta(lp, heads):
            d = (xd @ factor(lp.A, False).T.to(x.dtype)) @ factor(lp.B, True).T.to(x.dtype)
            return (d * scaling).reshape(B, T, heads, cfg.head_size).transpose(1, 2)

        if "lora_q" in factors:
            q = q + delta(factors["lora_q"], H)
        if "lora_k" in factors:
            k = k + delta(factors["lora_k"], G)
        if "lora_v" in factors:
            v = v + delta(factors["lora_v"], G)
        return q, k, v

    def _rope_qk(self, q, k, cos, sin):
        n = self.cfg.rope_n_elem
        q = torch.cat([apply_rope_halved(q[..., :n], cos, sin), q[..., n:]], -1)
        k = torch.cat([apply_rope_halved(k[..., :n], cos, sin), k[..., n:]], -1)
        return q, k

    def _attention(self, q, k, v, pos_q, pos_k, window: int, allow_flash: bool = False,
                   min_pos=None, kv_scales=(None, None)):
        """Windowed-causal attention with GQA, float32 softmax and optional
        logit softcap. Training forwards take K6 when the config enables it
        and the shape qualifies. ``min_pos`` ([B], optional) hides keys at
        positions below ``min_pos[b]`` from row b; ``kv_scales`` are an int8
        ring's per-step scales, folded into the float32 logits (K) and into
        the weights in q's dtype (V), as in JAX."""
        cfg = self.cfg
        scale = 1.0 / math.sqrt(cfg.attention_scores_scalar or cfg.head_size)
        mesh = current_mesh()
        if allow_flash and mesh is not None and mesh.size("seq") > 1:
            # this rank holds a time slice: the ring is the only attention
            # that sees the whole sequence (JAX, whose activations stay
            # global, routes by the flag and keeps the pipeline dense only
            # because shard_maps do not nest)
            if not cfg.sequence_parallel:
                raise ValueError(f"the mesh splits the sequence over seq={mesh.size('seq')} "
                                 "but config.sequence_parallel is off")
            if k.shape[1] != q.shape[1]:
                rep = q.shape[1] // k.shape[1]
                k = k.repeat_interleave(rep, dim=1)
                v = v.repeat_interleave(rep, dim=1)
            return context_parallel_attention(q, k, v, context=cfg.context, scale=scale,
                                              softcap=cfg.attention_logit_softcapping,
                                              window=window, group=mesh.group("seq"))
        if allow_flash and cfg.sliding_window_size is None and flash_qualifies(
                q.shape[2], cfg.context, cfg.attention_logit_softcapping,
                cfg.use_flash_attention):
            return flash_attention(q, k, v, cfg.context, scale)
        B, H, Tq, D = q.shape
        Hkv = k.shape[1]
        k_scale, v_scale = kv_scales
        # GQA as a grouped contraction: the repeated K/V are never built
        qg = q.reshape(B, Hkv, H // Hkv, Tq, D)
        logits = torch.einsum("bhgtd,bhsd->bhgts", qg.float(), k.to(q.dtype).float()) * scale
        if k_scale is not None:
            logits = logits * k_scale.float()[:, :, None, None, :]
        if cfg.attention_logit_softcapping is not None:
            cap = cfg.attention_logit_softcapping
            logits = torch.tanh(logits / cap) * cap
        delta = pos_q[:, None] - pos_k[None, :]
        mask = (pos_k[None, :] >= 0) & (delta >= 0)
        if cfg.context is not None:
            mask = mask & (delta < cfg.context)
        if window > 0:
            mask = mask & (delta < window)
        if min_pos is not None:
            mask = (mask[None] & (pos_k[None, None, :] >= min_pos[:, None, None]))[:, None, None]
        av_dtype = q.dtype if v_scale is not None else v.dtype
        att = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1).to(av_dtype)
        if v_scale is not None:
            att = att * v_scale.to(av_dtype)[:, :, None, None, :]
        return torch.einsum("bhgts,bhsd->bhgtd", att, v.to(av_dtype)).reshape(B, H, Tq, D)

    # -- block ------------------------------------------------------------------

    def _fused_mlp(self, mlp: nn.Module, x: torch.Tensor, tp=None) -> torch.Tensor | None:
        """The decode MLP through K4 (float weights) or K5 (int8 weights)
        when it lies in their envelope (no bias, no LoRA factors), else None.
        The choice depends on the config, shapes and dtypes only, never on
        the device. Under ``tp`` K4 runs on this rank's shards (``fc_1`` and
        ``fc_2`` ``[H/T, C]``, ``proj`` ``[C, H/T]``, the envelope read on
        ``H/T``) into a float32 partial of the down product, summed over
        ``tp`` and then rounded to x's dtype."""
        if self.cfg.mlp_class_name != "LLaMAMLP":
            return None
        B, T, C = x.shape
        lins = (mlp.fc_1, mlp.fc_2, mlp.proj)
        int8 = ["w_int8" in p._parameters for p in lins]
        H = (lins[0].w_int8 if int8[0] else local(lins[0].weight)).shape[0]
        if (B * T > FFN_MAX_ROWS or C % 128 or H % 128 or x.dtype not in _FLOAT
                or any("bias" in p._parameters or "lora" in p._modules for p in lins)):
            return None
        rows = x.reshape(B * T, C)
        if all(int8):
            out = gating_ffn_int8(rows, *(t for p in lins for t in (p.w_int8, p.scale)))
        elif any(int8) or any(p.weight.dtype not in _FLOAT for p in lins):
            return None
        elif tp is not None:
            part = gating_ffn(rows, *(local(p.weight) for p in lins), out_dtype=torch.float32)
            out = reduce_from(part, tp).to(x.dtype)
        else:
            out = gating_ffn(rows, *(p.weight for p in lins))
        return out.reshape(B, T, C)

    def _mlp(self, mlp: nn.Module, x: torch.Tensor, decode: bool = False,
             drop=None) -> torch.Tensor:
        """The block's MLP; ``decode`` (the streaming step) tries the fused
        kernels first. ``drop``: the MLP's LoRA-dropout pair (sub-site i of
        it for its i-th linear)."""
        cfg = self.cfg
        if cfg.mlp_class_name == "LLaMAMoE":
            return self._moe(mlp, x)
        ups = (mlp.fc,) if cfg.mlp_class_name == "GptNeoxMLP" else (mlp.fc_1, mlp.fc_2)
        tp = self._tp_group(*ups, mlp.proj)
        if decode:
            out = self._fused_mlp(mlp, x, tp)
            if out is not None:
                return out
        scaling = self.lora_scaling
        if tp is not None:
            x = copy_to(x, tp)

        def lin(p, h, i):
            if tp is None:
                return linear(p, h, scaling, fold_drop(drop, i))
            par = row_linear if p is mlp.proj else column_linear
            return par(p, h, tp, scaling, fold_drop(drop, i))

        approx = "tanh" if cfg.gelu_approximate != "none" else "none"
        if cfg.mlp_class_name == "GptNeoxMLP":
            return lin(mlp.proj, F.gelu(lin(mlp.fc, x, 0), approximate=approx), 1)
        if cfg.mlp_class_name == "LLaMAMLP":
            h = F.silu(lin(mlp.fc_1, x, 0)) * lin(mlp.fc_2, x, 1)
        else:  # GemmaMLP
            h = F.gelu(lin(mlp.fc_1, x, 0), approximate=approx) * lin(mlp.fc_2, x, 1)
        return lin(mlp.proj, h, 2)

    def _tp_group(self, *linears: nn.Module):
        """The ambient mesh's ``tensor`` group when it is > 1 and the given
        linears are tensor-sharded (the Megatron path), else None."""
        mesh = current_mesh()
        if mesh is None or mesh.size("tensor") <= 1 or not _tp_sharded(*linears):
            return None
        return mesh.group("tensor")

    def _expert_weights(self, e: nn.Module, dtype) -> tuple[list[torch.Tensor], int, object]:
        """(fc_1, fc_2, proj stacks of the experts this rank runs, the index
        of its first expert, the ``expert`` group or None). A stack sharded on
        ``tensor`` too is gathered over ``tensor`` (the mixture is the same
        on every tensor rank)."""
        mesh = current_mesh()
        ws = [e.fc_1.weight, e.fc_2.weight, e.proj.weight]
        on_expert = is_dtensor(ws[0]) and "expert" in ws[0].device_mesh.mesh_dim_names
        if mesh is None or mesh.size("expert") <= 1 or not on_expert:
            return [dense(w).to(dtype) for w in ws], 0, None
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for w in ws:
            if w.device_mesh.ndim > 1:  # [expert, tensor]
                w = w.redistribute(w.device_mesh, [Shard(0), Replicate()])
            out.append(w.to_local().to(dtype))
        return out, mesh.coord("expert") * out[0].shape[0], mesh.group("expert")

    def _moe(self, mlp: nn.Module, x: torch.Tensor) -> torch.Tensor:
        """Dense top-k mixture of experts (``LLaMAMoE``): the router's top k
        logits, a float32 softmax over them, and every expert's gated MLP
        combined by a dense ``[N, E]`` weight matrix, as in JAX."""
        cfg = self.cfg
        B, T, C = x.shape
        flat = x.reshape(-1, C)
        probs, indices = torch.topk(linear(mlp.gate, flat), cfg.n_expert_per_token)
        probs = torch.softmax(probs.float(), dim=-1).to(x.dtype)
        combine = (F.one_hot(indices, cfg.n_expert).to(x.dtype) * probs[..., None]).sum(1)
        (w1, w2, w3), first, ep = self._expert_weights(mlp.experts, x.dtype)
        # under ``expert`` each rank mixes its experts; the partial mixtures
        # are summed, and the inputs' gradients summed back
        flat, combine = copy_to(flat, ep), copy_to(combine, ep)[:, first:first + w1.shape[0]]
        h1 = torch.einsum("nd,eid->nei", flat, w1)
        h2 = torch.einsum("nd,eid->nei", flat, w2)
        y = torch.einsum("nei,edi->ned", F.silu(h1) * h2, w3)
        return reduce_from(torch.einsum("ned,ne->nd", y, combine), ep).reshape(B, T, C)

    def _block(self, block: Block, x, cos, sin, pos, window: int, kv_cache: dict | None = None,
               offset: int = 0, min_pos=None, drop=None) -> torch.Tensor:
        """One block; with ``kv_cache`` (the streaming step) the new keys and
        values go into the layer's ring in place and attention reads it.
        ``drop``: the layer's LoRA-dropout ``(rate, seed)`` pair, or None;
        sites 0, 1 and 2 are attention's input, the projection and the MLP."""
        cfg = self.cfg
        B, T, _ = x.shape
        x_normed = norm_apply(cfg, block.norm_1, x)
        tp = self._tp_group(block.attn, block.proj)
        q, k, v = self._qkv(block, copy_to(x_normed, tp), fold_drop(drop, 0), tp)
        q, k = self._rope_qk(q, k, cos, sin)
        pos_k, kv_scales = pos, (None, None)
        if kv_cache is not None:
            kv_cache, pos_k, _ = ring_kv_update(kv_cache, offset, k, v)
            k, v = kv_cache["k"], kv_cache["v"]
            kv_scales = (kv_cache.get("k_scale"), kv_cache.get("v_scale"))
        y = self._attention(q, k, v, pos, pos_k, window, allow_flash=kv_cache is None,
                            min_pos=min_pos, kv_scales=kv_scales)
        y = y.transpose(1, 2).reshape(B, T, cfg.head_size * q.shape[1])
        if tp is None:
            attn_out = linear(block.proj, y, self.lora_scaling, fold_drop(drop, 1))
        else:
            if q.shape[1] == cfg.n_head:  # all heads on every rank: keep this rank's
                y = chunk_of(y, -1, tp)
            attn_out = row_linear(block.proj, y, tp, self.lora_scaling, fold_drop(drop, 1))
        if cfg.post_attention_norm:
            attn_out = norm_apply(cfg, block.post_attention_norm, attn_out)
        decode, mlp_drop = kv_cache is not None, fold_drop(drop, 2)
        if cfg.parallel_residual:
            mlp_in = x_normed if cfg.shared_attention_norm else norm_apply(cfg, block.norm_2, x)
            return self._mlp(block.mlp, mlp_in, decode, mlp_drop) + attn_out + x
        x = attn_out + x
        h = self._mlp(block.mlp, norm_apply(cfg, block.norm_2, x), decode, mlp_drop)
        if cfg.post_mlp_norm:
            h = norm_apply(cfg, block.post_mlp_norm, h)
        return h + x

    # -- forward ------------------------------------------------------------------

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """``wte`` rows of ``tokens`` (``parallel/comm.py::table_rows``)."""
        x = table_rows(self.wte, tokens)
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.n_embd**0.5, dtype=x.dtype)
        return x

    def _dropout(self, dropout_rng: torch.Generator | None, n: int) -> list:
        """n ``(rate, seed)`` LoRA-dropout pairs drawn from ``dropout_rng``,
        or n Nones when dropout is off (no generator, no LoRA, or rate 0)."""
        cfg = self.cfg
        if dropout_rng is None or cfg.lora_r <= 0 or cfg.lora_dropout <= 0.0:
            return [None] * n
        seeds = torch.randint(0, 2**62, (n,), generator=dropout_rng).tolist()
        return [(cfg.lora_dropout, seed) for seed in seeds]

    def forward(self, x: torch.Tensor, dropout_rng: torch.Generator | None = None
                ) -> torch.Tensor:
        """Offline forward over embeddings: [B, T, D] -> [B, T, D] (post
        ln_f). ``dropout_rng`` (a CPU generator) turns on LoRA-branch dropout
        for training forwards; None is deterministic."""
        cfg = self.cfg
        T = x.shape[1]
        mesh = current_mesh()
        # under ``seq`` this rank's slice starts at its offset
        start = mesh.coord("seq") * T if mesh is not None and mesh.size("seq") > 1 else 0
        positions = torch.arange(T, device=x.device) + start
        cos, sin = self.rope(positions)
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        remat = cfg.remat and torch.is_grad_enabled()
        drops = self._dropout(dropout_rng, cfg.n_layer)
        windows = self.layer_windows()

        def body(h, layer):
            block, window, drop = layer
            if remat:
                return checkpoint(self._block, block, h, cos, sin, positions, window, None, 0,
                                  None, drop, use_reentrant=False)
            return self._block(block, h, cos, sin, positions, window, drop=drop)

        layers = [(block, windows[i], drops[i]) for i, block in self.layers()]
        if isinstance(self.blocks, nn.ModuleDict) and mesh is not None and mesh.size("pipe") > 1:
            # the blocks are held by stages: the layer loop is the pipeline
            # (one microbatch when the rows do not divide, which is the
            # plain loop run stage by stage)
            n_pipe = mesh.size("pipe")
            n_micro = cfg.pipeline_microbatches or n_pipe
            if not cfg.pipeline_parallel or x.shape[0] % n_micro:
                n_micro = 1
            x = spmd_pipeline(body, x, layers, n_stages=n_pipe, n_micro=n_micro,
                              group=mesh.group("pipe"))
        else:
            for layer in layers:
                x = body(x, layer)
        return norm_apply(cfg, self.ln_f, x)

    def logits(self, hidden: torch.Tensor, dropout_rng: torch.Generator | None = None
               ) -> torch.Tensor:
        """The text head. A ``lm_head`` split by rows over ``tensor`` (no
        LoRA factors) runs column-parallel outside autograd (the serving
        step): this rank's ``V/T`` logits, gathered into the whole row that
        sampling needs; a training forward gathers the weight."""
        (drop,) = self._dropout(dropout_rng, 1)
        head = self.lm_head
        group = row_split_group(head._parameters.get("weight"))
        if group is not None and "lora" not in head._modules and not torch.is_grad_enabled():
            out = gather_dim(hidden @ local(head.weight).T.to(hidden.dtype), -1, group)
            if "bias" in head._parameters:
                out = out + dense(head.bias).to(out.dtype)
        else:
            out = linear(head, hidden, self.lora_scaling, drop)
        if self.cfg.final_logit_softcapping is not None:
            cap = self.cfg.final_logit_softcapping
            out = torch.tanh(out / cap) * cap
        return out

    def forward_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.logits(self(self.embed(tokens)))

    # -- streaming ----------------------------------------------------------------

    def init_state(self, batch_size: int, dtype=torch.bfloat16, chunk_size: int = 1,
                   kv_int8: bool = False, kv_unstacked: bool = False, device=None) -> dict:
        """Ring KV of ``context + chunk_size - 1`` slots: stacked ``[L, B, G,
        cap, hs]`` buffers, or one ring per layer (``kv_unstacked``);
        ``kv_int8`` stores K/V as int8 codes with per-step scales."""
        cfg = self.cfg
        if cfg.context is None:
            raise ValueError("streaming needs config.context to bound the KV ring")
        shape = (batch_size, self._ring_groups(), cfg.context + chunk_size - 1, cfg.head_size)
        if kv_unstacked:
            kv = [ring_kv_buffers(shape, dtype, device, kv_int8) for _ in range(cfg.n_layer)]
        else:
            kv = ring_kv_buffers((cfg.n_layer, *shape), dtype, device, kv_int8)
        # a device scalar: the step reads nothing back (CUDA-graph capturable)
        return {"kv": kv, "offset": torch.zeros((), dtype=torch.long, device=device)}

    def _ring_groups(self) -> int:
        """KV groups a ring holds on this rank: ``G/T`` under ``tensor`` =
        T > 1 over sharded attention weights when T divides G, else G."""
        G = self.cfg.n_query_groups
        layers = self.layers()
        tp = self._tp_group(layers[0][1].attn, layers[0][1].proj) if layers else None
        if tp is None:
            return G
        n_tp = torch.distributed.get_world_size(tp)
        return G // n_tp if G % n_tp == 0 else G

    def step(self, state: dict, x: torch.Tensor, min_pos: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, dict]:
        """Streaming chunk over embeddings [B, T, D] -> ([B, T, D] post ln_f,
        state), the rings written in place. ``min_pos`` ([B]): per-row floor
        on the attended key positions (multi-session batched decode)."""
        cfg = self.cfg
        T = x.shape[1]
        kv = state["kv"]
        unstacked = isinstance(kv, list)
        cap = (kv[0] if unstacked else kv)["k"].shape[-2]
        if T > cap - cfg.context + 1:
            raise ValueError(
                f"chunk of {T} steps exceeds the ring's chunk_size ({cap - cfg.context + 1}): "
                "older in-window keys would be evicted; init_state with a larger chunk_size")
        offset = state["offset"]
        positions = torch.arange(T, device=x.device) + offset
        cos, sin = self.rope(positions)
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        windows = self.layer_windows()
        for i, block in self.layers():
            window = windows[i]
            layer_kv = kv[i] if unstacked else {name: buf[i] for name, buf in kv.items()}
            x = self._block(block, x, cos, sin, positions, window, layer_kv, offset, min_pos)
        return norm_apply(cfg, self.ln_f, x), {"kv": kv, "offset": offset + T}
