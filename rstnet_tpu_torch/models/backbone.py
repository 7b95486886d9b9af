"""Decoder-only LLM backbone, offline forward (counterpart of
``rstnet_tpu/models/backbone.py``).

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

Not ported yet: the streaming ``step`` and ring KV, MoE, LoRA and its
dropout, int8 linears, sequence and pipeline parallelism.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from rstnet_tpu_torch.core import container, default_generator, new_param, normal, uniform
from rstnet_tpu_torch.models.config import Config, rope_extra_config
from rstnet_tpu_torch.ops.flash_attention import flash_attention, flash_qualifies
from rstnet_tpu_torch.ops.rope import apply_rope_halved, build_rope_cache

STACKED = ("blocks",)


def linear(p: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``x W^T (+ b)`` with the weight taken in x's dtype."""
    y = x @ p.weight.T.to(x.dtype)
    if "bias" in p._parameters:
        y = y + p.bias.to(x.dtype)
    return y


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
        if cfg.n_expert or cfg.lora_r:
            raise NotImplementedError("MoE and LoRA backbones are not ported yet")
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

    def layer_windows(self) -> list[int]:
        """Per-layer sliding window (0 = none; config.context still applies)."""
        cfg = self.cfg
        return [cfg.sliding_window_size
                if cfg.sliding_window_size is not None
                and i % cfg.sliding_window_layer_stride == 0 else 0
                for i in range(cfg.n_layer)]

    # -- attention ------------------------------------------------------------

    def _qkv(self, block: Block, x: torch.Tensor):
        cfg = self.cfg
        B, T, _ = x.shape
        q_per_kv = cfg.n_head // cfg.n_query_groups
        qkv = linear(block.attn, x).reshape(B, T, cfg.n_query_groups, q_per_kv + 2, cfg.head_size)
        qkv = qkv.permute(0, 2, 3, 1, 4)  # [B, G, q_per_kv + 2, T, hs]
        q = qkv[:, :, :q_per_kv].reshape(B, cfg.n_head, T, cfg.head_size)
        k = qkv[:, :, q_per_kv].reshape(B, cfg.n_query_groups, T, cfg.head_size)
        v = qkv[:, :, q_per_kv + 1].reshape(B, cfg.n_query_groups, T, cfg.head_size)
        return q, k, v

    def _rope_qk(self, q, k, cos, sin):
        n = self.cfg.rope_n_elem
        q = torch.cat([apply_rope_halved(q[..., :n], cos, sin), q[..., n:]], -1)
        k = torch.cat([apply_rope_halved(k[..., :n], cos, sin), k[..., n:]], -1)
        return q, k

    def _attention(self, q, k, v, pos_q, pos_k, window: int, allow_flash: bool = False):
        """Windowed-causal attention with GQA, float32 softmax and optional
        logit softcap. Training forwards take K6 when the config enables it
        and the shape qualifies."""
        cfg = self.cfg
        scale = 1.0 / math.sqrt(cfg.attention_scores_scalar or cfg.head_size)
        if allow_flash and cfg.sliding_window_size is None and flash_qualifies(
                q.shape[2], cfg.context, cfg.attention_logit_softcapping,
                cfg.use_flash_attention):
            return flash_attention(q, k, v, cfg.context, scale)
        B, H, Tq, D = q.shape
        Hkv = k.shape[1]
        # GQA as a grouped contraction: the repeated K/V are never built
        qg = q.reshape(B, Hkv, H // Hkv, Tq, D)
        logits = torch.einsum("bhgtd,bhsd->bhgts", qg.float(), k.to(q.dtype).float()) * scale
        if cfg.attention_logit_softcapping is not None:
            cap = cfg.attention_logit_softcapping
            logits = torch.tanh(logits / cap) * cap
        delta = pos_q[:, None] - pos_k[None, :]
        mask = (pos_k[None, :] >= 0) & (delta >= 0)
        if cfg.context is not None:
            mask = mask & (delta < cfg.context)
        if window > 0:
            mask = mask & (delta < window)
        att = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1).to(v.dtype)
        return torch.einsum("bhgts,bhsd->bhgtd", att, v).reshape(B, H, Tq, D)

    # -- block ------------------------------------------------------------------

    def _mlp(self, mlp: nn.Module, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        approx = "tanh" if cfg.gelu_approximate != "none" else "none"
        if cfg.mlp_class_name == "GptNeoxMLP":
            return linear(mlp.proj, F.gelu(linear(mlp.fc, x), approximate=approx))
        if cfg.mlp_class_name == "LLaMAMLP":
            h = F.silu(linear(mlp.fc_1, x)) * linear(mlp.fc_2, x)
        else:  # GemmaMLP
            h = F.gelu(linear(mlp.fc_1, x), approximate=approx) * linear(mlp.fc_2, x)
        return linear(mlp.proj, h)

    def _block(self, block: Block, x, cos, sin, pos, window: int) -> torch.Tensor:
        cfg = self.cfg
        B, T, _ = x.shape
        x_normed = norm_apply(cfg, block.norm_1, x)
        q, k, v = self._qkv(block, x_normed)
        q, k = self._rope_qk(q, k, cos, sin)
        y = self._attention(q, k, v, pos, pos, window, allow_flash=True)
        y = y.transpose(1, 2).reshape(B, T, cfg.head_size * cfg.n_head)
        attn_out = linear(block.proj, y)
        if cfg.post_attention_norm:
            attn_out = norm_apply(cfg, block.post_attention_norm, attn_out)
        if cfg.parallel_residual:
            mlp_in = x_normed if cfg.shared_attention_norm else norm_apply(cfg, block.norm_2, x)
            return self._mlp(block.mlp, mlp_in) + attn_out + x
        x = attn_out + x
        h = self._mlp(block.mlp, norm_apply(cfg, block.norm_2, x))
        if cfg.post_mlp_norm:
            h = norm_apply(cfg, block.post_mlp_norm, h)
        return h + x

    # -- forward ------------------------------------------------------------------

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.wte[tokens]
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.n_embd**0.5, dtype=x.dtype)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Offline forward over embeddings: [B, T, D] -> [B, T, D] (post ln_f)."""
        T = x.shape[1]
        positions = torch.arange(T, device=x.device)
        cos, sin = self.rope(positions)
        cos, sin = cos.to(x.dtype), sin.to(x.dtype)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for block, window in zip(self.blocks, self.layer_windows()):
            if remat:
                x = checkpoint(self._block, block, x, cos, sin, positions, window,
                               use_reentrant=False)
            else:
                x = self._block(block, x, cos, sin, positions, window)
        return norm_apply(self.cfg, self.ln_f, x)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        out = linear(self.lm_head, hidden)
        if self.cfg.final_logit_softcapping is not None:
            cap = self.cfg.final_logit_softcapping
            out = torch.tanh(out / cap) * cap
        return out

    def forward_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.logits(self(self.embed(tokens)))
