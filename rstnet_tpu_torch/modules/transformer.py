"""Streaming transformer with ring KV cache and per-step (depformer) weights
(counterpart of ``rstnet_tpu/modules/transformer.py``).

Layer parameters stay stacked along a leading layer axis, as in the JAX
pytree (``layers.in_proj`` is ``[L, mult*3*d, d]``); the layer loop slices
them. ``weights_per_step > 0`` gives every time step its own projections and
FFN (the depth transformer over codebooks). Streaming state is
``{"kv": ring buffers, "offset": int}``; ``step`` writes the ring in place.

The JAX package's opt-in Pallas FFN branch (``use_pallas_ffn``) and the int8
weights are not ported yet (ROADMAP kernel queue K2, int8 serving).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from rstnet_tpu_torch.core import default_generator, new_param, uniform
from rstnet_tpu_torch.ops.attention import (
    masked_attention,
    multi_linear,
    ring_kv_buffers,
    ring_kv_update,
)
from rstnet_tpu_torch.ops.gating import ActivationGating, gated_ffn, get_activation
from rstnet_tpu_torch.ops.norms import LayerScale, Norm
from rstnet_tpu_torch.ops.rope import apply_rope_interleaved


def create_sin_embedding(positions: torch.Tensor, dim: int, max_period: float = 10_000.0
                         ) -> torch.Tensor:
    """Sinusoidal positional embedding, [*, T] positions -> [*, T, dim]."""
    half = dim // 2
    positions = positions.float()[..., None]
    adim = torch.arange(half, dtype=torch.float32, device=positions.device)
    phase = positions / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


def resolve_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The weight in the activation dtype (int8 serving weights wait)."""
    return w.to(dtype)


class StreamingTransformer(nn.Module):
    """Causal transformer with streaming ring-KV state."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 dim_feedforward: int = 2048, causal: bool = False, context: int | None = None,
                 gating: str = "none", norm: str = "layer_norm",
                 positional_embedding: str = "sin", max_period: float = 10_000.0,
                 positional_scale: float = 1.0, layer_scale: float | None = None,
                 weights_per_step: int = 0, activation: str = "gelu",
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be a multiple of num_heads")
        if positional_embedding not in ("sin", "rope", "sin_rope", "none"):
            raise ValueError(f"unknown positional embedding {positional_embedding!r}")
        if gating == "none" and weights_per_step:
            raise ValueError("weights_per_step requires gating")
        self.d_model, self.num_heads, self.num_layers = d_model, num_heads, num_layers
        self.dim_feedforward, self.causal, self.context = dim_feedforward, causal, context
        self.gating, self.norm = gating, norm
        self.positional_embedding, self.max_period = positional_embedding, max_period
        self.positional_scale, self.weights_per_step = positional_scale, weights_per_step
        self.activation = activation

        g = default_generator(generator, device)
        d, L, mult = d_model, num_layers, max(1, weights_per_step)
        bound = 1.0 / math.sqrt(d)
        layers = nn.Module()
        layers.norm1 = Norm(norm, d, stack=(L,), device=device, dtype=dtype)
        layers.norm2 = Norm(norm, d, stack=(L,), device=device, dtype=dtype)
        layers.in_proj = new_param(uniform((L, mult * 3 * d, d), bound, g, device, dtype))
        layers.out_proj = new_param(uniform((L, mult * d, d), bound, g, device, dtype))
        if gating == "none":
            layers.linear1 = new_param(uniform((L, dim_feedforward, d), bound, g, device, dtype))
            layers.linear2 = new_param(uniform(
                (L, d, dim_feedforward), 1.0 / math.sqrt(dim_feedforward), g, device, dtype))
        else:
            stack = (L, weights_per_step) if weights_per_step else (L,)
            layers.gating = ActivationGating(d, dim_feedforward, gating, stack=stack,
                                             device=device, dtype=dtype, generator=g)
        if layer_scale is not None:
            layers.layer_scale_1 = LayerScale(d, layer_scale, stack=(L,), device=device,
                                              dtype=dtype)
            layers.layer_scale_2 = LayerScale(d, layer_scale, stack=(L,), device=device,
                                              dtype=dtype)
        self.layers = layers
        self.has_layer_scale = layer_scale is not None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def norm_eps(self) -> float:
        return self.layers.norm1.eps

    @property
    def kv_capacity(self) -> int:
        if self.context is not None:
            return self.context
        if self.weights_per_step:
            return self.weights_per_step
        raise ValueError("streaming needs a context (or weights_per_step) to bound the KV cache")

    # -- layer body ---------------------------------------------------------

    def _project_qkv(self, i: int, x: torch.Tensor, offset: int):
        B, T, d = x.shape
        w_in = resolve_weight(self.layers.in_proj[i], x.dtype)
        if self.weights_per_step:
            projected = multi_linear(w_in.reshape(self.weights_per_step, 3 * d, d), x, offset)
        else:
            projected = x @ w_in.T
        # (p h d) packing with p=3 -> [3, B, H, T, Dh]
        proj = projected.reshape(B, T, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        return proj[0], proj[1], proj[2]

    def _out_proj(self, i: int, x: torch.Tensor, offset: int) -> torch.Tensor:
        w_out = resolve_weight(self.layers.out_proj[i], x.dtype)
        if self.weights_per_step:
            w = w_out.reshape(self.weights_per_step, self.d_model, self.d_model)
            return multi_linear(w, x, offset)
        return x @ w_out.T

    def _ffn(self, i: int, x: torch.Tensor, offset: int) -> torch.Tensor:
        layers = self.layers
        h = layers.norm2(x, i)
        if self.gating == "none":
            act = get_activation(self.activation)
            w1 = resolve_weight(layers.linear1[i], h.dtype)
            w2 = resolve_weight(layers.linear2[i], h.dtype)
            update = act(h @ w1.T) @ w2.T
        elif self.weights_per_step:
            T = x.shape[1]
            steps = (torch.arange(T, device=x.device) + offset).clamp(
                0, self.weights_per_step - 1)
            w_in = resolve_weight(layers.gating.linear_in[i], h.dtype)[steps]
            w_out = resolve_weight(layers.gating.linear_out[i], h.dtype)[steps]
            gate, val = torch.einsum("btd,thd->bth", h, w_in).chunk(2, dim=-1)
            gated = get_activation(self.gating)(gate) * val
            update = torch.einsum("bth,tdh->btd", gated, w_out)
        else:
            update = gated_ffn(h, resolve_weight(layers.gating.linear_in[i], h.dtype),
                               resolve_weight(layers.gating.linear_out[i], h.dtype),
                               self.gating)
        if self.has_layer_scale:
            update = layers.layer_scale_2(update, i)
        return x + update

    def _attn(self, i: int, x: torch.Tensor, offset: int, kv_cache: dict | None,
              min_pos: torch.Tensor | None = None) -> torch.Tensor:
        h = self.layers.norm1(x, i)
        q, k, v = self._project_qkv(i, h, offset)
        B, T = x.shape[:2]
        if self.positional_embedding in ("rope", "sin_rope"):
            q, k = apply_rope_interleaved(q, k, offset, self.max_period)
        pos_q = torch.arange(T, device=x.device) + offset
        if kv_cache is None:
            # keys live at the same absolute positions as the queries
            attn = masked_attention(q, k, v, pos_q, pos_q, self.context, self.causal)
        else:
            if not self.causal:
                raise ValueError("streaming only for causal attention")
            kv_cache, pos_k, _ = ring_kv_update(kv_cache, offset, k, v)
            attn = masked_attention(q, kv_cache["k"], kv_cache["v"], pos_q, pos_k,
                                    self.context, True, min_pos=min_pos)
        attn = attn.transpose(1, 2).reshape(B, T, self.d_model)
        update = self._out_proj(i, attn, offset)
        if self.has_layer_scale:
            update = self.layers.layer_scale_1(update, i)
        return x + update

    def _layer(self, i, x, offset, kv_cache, min_pos=None):
        x = self._attn(i, x, offset, kv_cache, min_pos)
        return self._ffn(i, x, offset)

    def _add_sin(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        if self.positional_embedding not in ("sin", "sin_rope"):
            return x
        positions = torch.arange(x.shape[1], device=x.device) + offset
        pos_emb = create_sin_embedding(positions, x.shape[2], self.max_period)[None]
        return x + self.positional_scale * pos_emb.to(x.dtype)

    # -- offline ------------------------------------------------------------

    def forward(self, x: torch.Tensor, offset: int = 0) -> torch.Tensor:
        """Offline forward, [B, T, C] -> [B, T, C] (full causal mask)."""
        x = self._add_sin(x, offset)
        for i in range(self.num_layers):
            x = self._layer(i, x, offset, None)
        return x

    # -- streaming ----------------------------------------------------------

    def init_state(self, batch_size: int, dtype=torch.bfloat16, chunk_size: int = 1,
                   kv_unstacked: bool = False, device=None) -> dict:
        """Ring of ``context + chunk_size - 1`` slots, so the earliest query
        of a chunk still sees its full window. ``kv_unstacked`` keeps one
        ring per layer instead of a stacked ``[L, ...]`` pair."""
        cap = self.kv_capacity + chunk_size - 1
        shape = (batch_size, self.num_heads, cap, self.head_dim)
        if kv_unstacked:
            kv = [ring_kv_buffers(shape, dtype, device) for _ in range(self.num_layers)]
        else:
            kv = ring_kv_buffers((self.num_layers, *shape), dtype, device)
        return {"kv": kv, "offset": 0}

    def step(self, state: dict, x: torch.Tensor, min_pos: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, dict]:
        """Streaming chunk of T steps (T=1 for generation). ``min_pos`` ([B]):
        per-row attention lookback floor (see ``masked_attention``)."""
        T = x.shape[1]
        kv = state["kv"]
        unstacked = isinstance(kv, list)
        cap = (kv[0] if unstacked else kv)["k"].shape[-2]
        if T > cap - self.kv_capacity + 1:
            raise ValueError(
                f"chunk of {T} steps exceeds the ring's chunk_size "
                f"({cap - self.kv_capacity + 1}): init_state with a larger chunk_size")
        offset = state["offset"]
        x = self._add_sin(x, offset)
        for i in range(self.num_layers):
            layer_kv = kv[i] if unstacked else {"k": kv["k"][i], "v": kv["v"][i]}
            x = self._layer(i, x, offset, layer_kv, min_pos)
        return x, {"kv": kv, "offset": offset + T}


class ProjectedTransformer(nn.Module):
    """Transformer with input/output projections and an optional ``[B, C, T]``
    conv layout."""

    def __init__(self, transformer: StreamingTransformer, input_dimension: int,
                 output_dimensions: tuple[int, ...], conv_layout: bool = False,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.transformer = transformer
        self.output_dimensions = tuple(output_dimensions)
        self.conv_layout = conv_layout
        g = default_generator(generator, device)
        d = transformer.d_model
        if d != input_dimension:
            self.input_proj = new_param(uniform(
                (d, input_dimension), 1.0 / math.sqrt(input_dimension), g, device, dtype))
        for i, od in enumerate(self.output_dimensions):
            if od != d:
                self.register_parameter(f"output_proj_{i}", new_param(uniform(
                    (od, d), 1.0 / math.sqrt(d), g, device, dtype)))

    def _pre(self, x):
        if self.conv_layout:
            x = x.transpose(1, 2)
        if "input_proj" in self._parameters:
            x = x @ self.input_proj.T
        return x

    def _post(self, z):
        ys = []
        for i in range(len(self.output_dimensions)):
            w = self._parameters.get(f"output_proj_{i}")
            y = z if w is None else z @ w.T
            ys.append(y.transpose(1, 2) if self.conv_layout else y)
        return tuple(ys)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        return self._post(self.transformer(self._pre(x)))

    def init_state(self, batch_size: int, dtype=torch.bfloat16, chunk_size: int = 1,
                   device=None) -> dict:
        return self.transformer.init_state(batch_size, dtype, chunk_size, device=device)

    def step(self, state: dict, x: torch.Tensor, min_pos=None):
        z, state = self.transformer.step(state, self._pre(x), min_pos=min_pos)
        return self._post(z), state
