"""Streaming transformer with ring KV cache and per-step (depformer) weights
(counterpart of ``rstnet_tpu/modules/transformer.py``).

Layer parameters stay stacked along a leading layer axis, as in the JAX
pytree (``layers.in_proj`` is ``[L, mult*3*d, d]``); the layer loop slices
them. ``weights_per_step > 0`` gives every time step its own projections and
FFN (the depth transformer over codebooks). Streaming state is
``{"kv": ring buffers, "offset": ...}``; ``step`` writes the ring in place.
The offset is a 0-dim int64 tensor on the state's device, so a step reads
nothing back to the host and a CUDA graph can replay it; with per-step
weights it is a Python int instead, since there it is the codebook index
that selects the step's weights.

A per-step FFN at T == 1 inside K2's envelope (plain weights, hidden and
d_model multiples of 128, SiLU gating) goes through
:func:`~rstnet_tpu_torch.ops.cuda_ffn.gating_ffn_step`: the CUDA kernel on
the card, its plain version on CPU tensors. The JAX package gates that
branch behind ``RSTNET_PALLAS_FFN=1``; the port takes it whenever the shapes
allow.

LoRA (``models/lora.py::init_lora_streaming_transformer``): ``layers.lora_in_proj``
and ``layers.lora_out_proj`` factor modules add low-rank branches to the
packed input and the output projections; the offline forward takes a
``dropout_rng`` (a CPU generator) for LoRA-branch dropout at
``lora_dropout``, one seed a layer, as in JAX.

On a model placed over several ranks, ``step`` runs over
``parallel/sharding.py::serving_view``'s replica, whose weights are whole
plain tensors (K2 at B > 1 as on one process); ``resolve_weight`` refuses a
``DTensor``.

Serving weights may be weight-only int8 (``quantize_transformer_int8``, in
place): an :class:`Int8Weight` in a parameter's place, whose ``state_dict``
keys are the JAX dict's paths (``...in_proj.w_int8``, ``...in_proj.scale``).
``resolve_weight`` dequantizes it in the activation dtype, as JAX does; an
int8 per-step FFN takes the gather path, not K2, as in JAX.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from rstnet_tpu_torch.core import (
    default_generator,
    dropout_pair,
    fold_drop,
    lora_dropout,
    new_param,
    uniform,
)
from rstnet_tpu_torch.ops.attention import (
    masked_attention,
    multi_linear,
    ring_kv_buffers,
    ring_kv_update,
)
from rstnet_tpu_torch.ops.cuda_ffn import clamp_step, gating_ffn_step
from rstnet_tpu_torch.ops.gating import ActivationGating, gated_ffn, get_activation
from rstnet_tpu_torch.ops.norms import LayerScale, Norm
from rstnet_tpu_torch.ops.rope import apply_rope_interleaved
from rstnet_tpu_torch.parallel.sharding import dense, is_dtensor


def create_sin_embedding(positions: torch.Tensor, dim: int, max_period: float = 10_000.0
                         ) -> torch.Tensor:
    """Sinusoidal positional embedding, [*, T] positions -> [*, T, dim]."""
    half = dim // 2
    positions = positions.float()[..., None]
    adim = torch.arange(half, dtype=torch.float32, device=positions.device)
    phase = positions / (max_period ** (adim / (half - 1)))
    return torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)


class QuantizedSlice(NamedTuple):
    """An index into an :class:`Int8Weight`: int8 rows and their scales."""

    w_int8: torch.Tensor
    scale: torch.Tensor

    @property
    def shape(self) -> torch.Size:
        return self.w_int8.shape

    def __getitem__(self, idx) -> "QuantizedSlice":
        return QuantizedSlice(self.w_int8[idx], self.scale[idx])


class Int8Weight(nn.Module):
    """Weight-only int8 serving weight (the JAX ``{w_int8, scale}`` dict):
    ``w_int8 [..., out, in]`` int8 and ``scale [..., out]`` float32 per
    output row. Indexing slices both, as a stacked parameter is sliced."""

    def __init__(self, w_int8: torch.Tensor, scale: torch.Tensor):
        super().__init__()
        self.w_int8 = new_param(w_int8)
        self.scale = new_param(scale)

    @property
    def shape(self) -> torch.Size:
        return self.w_int8.shape

    def __getitem__(self, idx) -> QuantizedSlice:
        return QuantizedSlice(self.w_int8[idx], self.scale[idx])


def is_int8(w) -> bool:
    return isinstance(w, (Int8Weight, QuantizedSlice))


def step_gated_ffn(h: torch.Tensor, lin_in, lin_out, step: int, activation: str) -> torch.Tensor:
    """One step's gated FFN of a per-step weight stack (``lin_in [S, 2H,
    C]``, ``lin_out [S, C, H]``, plain or int8) over h [B, T, C]: the step
    clamped to [0, S-1] and its slices taken as views, no gather of the
    stack. The T == 1 case that K2 does not take (int8 weights, widths off
    its grid)."""
    s = clamp_step(step, lin_in.shape[0])
    return gated_ffn(h, resolve_weight(lin_in[s], h.dtype), resolve_weight(lin_out[s], h.dtype),
                     activation)


def quantize_param_int8(module: nn.Module, name: str) -> None:
    """Replace the plain weight ``module.<name>`` by its int8 serving form;
    a name that holds no plain weight (absent, or already int8) stays."""
    if name in module._parameters:
        setattr(module, name, quantize_weight_int8(module._parameters.pop(name)))


def resolve_weight(w, dtype: torch.dtype) -> torch.Tensor:
    """The weight in the activation dtype. An int8 weight dequantizes as in
    JAX: the scale is rounded to ``dtype`` first, the product taken in it.
    One mixed-dtype multiply does it: the codes convert exactly to ``dtype``
    inside the kernel, so no converted copy of the codes is written. A
    sharded weight (``DTensor``) is refused: a serving step reads the depth
    side from ``parallel/sharding.py::serving_view``'s whole replica, and a
    training forward gathers it first."""
    if is_dtensor(w):
        raise TypeError("resolve_weight got a sharded DTensor: serve a placed model through "
                        "parallel.sharding.depth_side (its whole replica), or gather it first")
    if is_int8(w):
        return w.w_int8 * w.scale.to(dtype)[..., None]
    return w.to(dtype)


@torch.no_grad()
def quantize_weight_int8(w: torch.Tensor) -> Int8Weight:
    """Per-output-row symmetric int8 of ``[..., out, in]``, with the JAX
    function's float32 operations, so codes and scales are equal. Done one
    leading slice at a time, so a large stack needs no float32 copy."""
    def rows(wf: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        s = torch.clamp_min(wf.abs().amax(-1) / 127.0, 1e-8)
        return torch.clamp(torch.round(wf / s[..., None]), -127, 127).to(torch.int8), s

    if w.dim() <= 2:
        return Int8Weight(*rows(w.float()))
    w_int8 = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty(w.shape[:-1], dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        w_int8[i], scale[i] = rows(w[i].float())
    return Int8Weight(w_int8, scale)


@torch.no_grad()
def quantize_transformer_int8(transformer: "StreamingTransformer") -> "StreamingTransformer":
    """Quantize a transformer's projections and FFN weights for serving, in
    place (counterpart of the JAX function on its params). Weights that are
    already int8 stay as they are."""
    layers = transformer.layers
    for name in ("in_proj", "out_proj", "linear1", "linear2"):
        quantize_param_int8(layers, name)
    if hasattr(layers, "gating"):
        quantize_param_int8(layers.gating, "linear_in")
        quantize_param_int8(layers.gating, "linear_out")
    return transformer


@torch.no_grad()
def pad_codecformer_gating(transformer: "StreamingTransformer", multiple: int = 128
                           ) -> "StreamingTransformer":
    """Pad the per-step gating hidden dim to a multiple of ``multiple`` so
    that K2 applies, in place (counterpart of the JAX function on a
    transformer's params). Zero rows are inert: the value half multiplies
    the gate half to zero, so nothing changes numerically on either FFN
    path. ``linear_in [L, S, 2H, C]`` becomes ``[gate; 0; value; 0]`` and
    ``linear_out [L, S, C, H]`` gains zero columns."""
    gating = getattr(transformer.layers, "gating", None)
    if gating is None or not transformer.weights_per_step or is_int8(gating.linear_in):
        return transformer
    lin_in, lin_out = gating.linear_in, gating.linear_out
    H = lin_in.shape[-2] // 2
    pad = (-H) % multiple
    if pad == 0:
        return transformer
    zrow = lin_in.new_zeros(lin_in.shape[:-2] + (pad, lin_in.shape[-1]))
    gating.linear_in = new_param(torch.cat([lin_in[..., :H, :], zrow, lin_in[..., H:, :], zrow],
                                           dim=-2))
    gating.linear_out = new_param(torch.nn.functional.pad(lin_out, (0, pad)))
    gating.hidden = H + pad
    return transformer


class StreamingTransformer(nn.Module):
    """Causal transformer with streaming ring-KV state."""

    def __init__(self, d_model: int, num_heads: int, num_layers: int,
                 dim_feedforward: int = 2048, causal: bool = False, context: int | None = None,
                 gating: str = "none", norm: str = "layer_norm",
                 positional_embedding: str = "sin", max_period: float = 10_000.0,
                 positional_scale: float = 1.0, layer_scale: float | None = None,
                 weights_per_step: int = 0, activation: str = "gelu", remat: bool = False,
                 lora_dropout: float = 0.0,
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
        # training forwards checkpoint each layer (recomputed in backward)
        self.remat = remat
        self.lora_dropout = lora_dropout  # LoRA-branch dropout rate (training forwards)

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

    def _lora(self, i: int, name: str, x: torch.Tensor, drop=None):
        """Layer i's low-rank branch on projection ``name`` (``lora_in_proj``
        or ``lora_out_proj``), or 0 without one; ``drop``: a ``(rate, seed)``
        dropout pair for its input, or None."""
        lp = self.layers._modules.get(f"lora_{name}")
        if lp is None:
            return 0.0
        xd = lora_dropout(x, dropout_pair(drop, x.device))
        a, b = dense(lp.A)[i], dense(lp.B)[i]
        return (xd @ a.T.to(x.dtype)) @ b.T.to(x.dtype) * lp.scaling[i].to(x.dtype)

    def _project_qkv(self, i: int, x: torch.Tensor, offset: int, drop=None):
        B, T, d = x.shape
        w_in = resolve_weight(self.layers.in_proj[i], x.dtype)
        if self.weights_per_step:
            projected = multi_linear(w_in.reshape(self.weights_per_step, 3 * d, d), x, offset)
        else:
            projected = x @ w_in.T + self._lora(i, "in_proj", x, drop)
        # (p h d) packing with p=3 -> [3, B, H, T, Dh]
        proj = projected.reshape(B, T, 3, self.num_heads, self.head_dim).permute(2, 0, 3, 1, 4)
        return proj[0], proj[1], proj[2]

    def _out_proj(self, i: int, x: torch.Tensor, offset: int, drop=None) -> torch.Tensor:
        w_out = resolve_weight(self.layers.out_proj[i], x.dtype)
        if self.weights_per_step:
            w = w_out.reshape(self.weights_per_step, self.d_model, self.d_model)
            return multi_linear(w, x, offset)
        return x @ w_out.T + self._lora(i, "out_proj", x, drop)

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
            lin_in, lin_out = layers.gating.linear_in[i], layers.gating.linear_out[i]
            hidden = lin_in.shape[-2] // 2
            if (T == 1 and self.gating == "silu" and hidden % 128 == 0
                    and self.d_model % 128 == 0 and not is_int8(lin_in)):
                # K2 reads only the step's weight slice: no gather of the stack
                update = gating_ffn_step(h[:, 0, :], lin_in, lin_out, offset)[:, None, :]
            elif T == 1:
                update = step_gated_ffn(h, lin_in, lin_out, offset, self.gating)
            else:
                steps = (torch.arange(T, device=x.device) + offset).clamp(
                    0, self.weights_per_step - 1)
                w_in = resolve_weight(lin_in[steps], h.dtype)
                w_out = resolve_weight(lin_out[steps], h.dtype)
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
              min_pos: torch.Tensor | None = None, drop=None) -> torch.Tensor:
        h = self.layers.norm1(x, i)
        q, k, v = self._project_qkv(i, h, offset, fold_drop(drop, 0))
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
                                    self.context, True, min_pos=min_pos,
                                    k_scale=kv_cache.get("k_scale"),
                                    v_scale=kv_cache.get("v_scale"))
        attn = attn.transpose(1, 2).reshape(B, T, self.d_model)
        update = self._out_proj(i, attn, offset, fold_drop(drop, 1))
        if self.has_layer_scale:
            update = self.layers.layer_scale_1(update, i)
        return x + update

    def _layer(self, i, x, offset, kv_cache, min_pos=None, drop=None):
        x = self._attn(i, x, offset, kv_cache, min_pos, drop)
        return self._ffn(i, x, offset)

    def _add_sin(self, x: torch.Tensor, offset: int) -> torch.Tensor:
        if self.positional_embedding not in ("sin", "sin_rope"):
            return x
        positions = torch.arange(x.shape[1], device=x.device) + offset
        pos_emb = create_sin_embedding(positions, x.shape[2], self.max_period)[None]
        return x + self.positional_scale * pos_emb.to(x.dtype)

    # -- offline ------------------------------------------------------------

    def forward(self, x: torch.Tensor, offset: int = 0,
                dropout_rng: torch.Generator | None = None) -> torch.Tensor:
        """Offline forward, [B, T, C] -> [B, T, C] (full causal mask); with
        ``remat`` and autograd on, each layer is checkpointed. ``dropout_rng``
        (a CPU generator) turns on LoRA-branch dropout at ``lora_dropout``."""
        x = self._add_sin(x, offset)
        remat = self.remat and torch.is_grad_enabled()
        drops = [None] * self.num_layers
        if dropout_rng is not None and self.lora_dropout > 0.0:
            seeds = torch.randint(0, 2**62, (self.num_layers,), generator=dropout_rng).tolist()
            drops = [(self.lora_dropout, seed) for seed in seeds]
        for i in range(self.num_layers):
            if remat:
                x = checkpoint(self._layer, i, x, offset, None, None, drops[i],
                               use_reentrant=False)
            else:
                x = self._layer(i, x, offset, None, drop=drops[i])
        return x

    # -- streaming ----------------------------------------------------------

    def init_state(self, batch_size: int, dtype=torch.bfloat16, chunk_size: int = 1,
                   kv_unstacked: bool = False, device=None, kv_int8: bool = False) -> dict:
        """Ring of ``context + chunk_size - 1`` slots, so the earliest query
        of a chunk still sees its full window. ``kv_unstacked`` keeps one
        ring per layer instead of a stacked ``[L, ...]`` pair; ``kv_int8``
        stores K/V as int8 codes with per-step scales. The offset is a 0-dim
        int64 tensor on ``device``, or the int 0 with per-step weights (the
        step index selects weights on the host)."""
        cap = self.kv_capacity + chunk_size - 1
        shape = (batch_size, self.num_heads, cap, self.head_dim)
        if kv_unstacked:
            kv = [ring_kv_buffers(shape, dtype, device, kv_int8) for _ in range(self.num_layers)]
        else:
            kv = ring_kv_buffers((self.num_layers, *shape), dtype, device, kv_int8)
        offset = 0 if self.weights_per_step else torch.zeros((), dtype=torch.long, device=device)
        return {"kv": kv, "offset": offset}

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
            layer_kv = kv[i] if unstacked else {name: buf[i] for name, buf in kv.items()}
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
