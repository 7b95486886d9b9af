"""SEANet causal convolutional encoder/decoder (counterpart of
``rstnet_tpu/modules/seanet.py``).

Parameters are a flat ``layers`` list with one entry per parameterized
sublayer, aligned with a static layout plan in which activations are
interleaved, exactly as in the JAX param pytree.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rstnet_tpu_torch.core import default_generator
from rstnet_tpu_torch.ops.conv import StreamingConv1d, StreamingConvTranspose1d

_ACT = {
    "ELU": lambda x: F.elu(x, 1.0),
    "elu": lambda x: F.elu(x, 1.0),
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "Tanh": torch.tanh,
    "tanh": torch.tanh,
    "snake": lambda x: x + torch.sin(x) ** 2,
}


class SEANetResnetBlock(nn.Module):
    """act -> conv(k, dilation) -> act -> conv(1) with identity skip."""

    def __init__(self, dim: int, kernel_sizes=(3, 1), dilations=(1, 1),
                 activation: str = "ELU", norm: str = "none", causal: bool = False,
                 pad_mode: str = "constant", compress: int = 2, true_skip: bool = True,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.activation = activation
        hidden = dim // compress
        n = len(kernel_sizes)
        kw = dict(norm=norm, causal=causal, pad_mode=pad_mode, device=device, dtype=dtype,
                  generator=generator)
        self.block = nn.ModuleList(
            StreamingConv1d(dim if i == 0 else hidden, dim if i == n - 1 else hidden, k,
                            dilation=d, **kw)
            for i, (k, d) in enumerate(zip(kernel_sizes, dilations))
        )
        self.shortcut = None if true_skip else StreamingConv1d(dim, dim, 1, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        u = x if self.shortcut is None else self.shortcut(x)
        v = x
        for conv in self.block:
            v = conv(_ACT[self.activation](v))
        return u + v

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        s = {"block": [c.init_state(batch_size, dtype, device) for c in self.block]}
        if self.shortcut is not None:
            s["shortcut"] = self.shortcut.init_state(batch_size, dtype, device)
        return s

    def step(self, state: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        new_state = {"block": []}
        if self.shortcut is None:
            u = x
        else:
            u, new_state["shortcut"] = self.shortcut.step(state["shortcut"], x)
        v = x
        for conv, s in zip(self.block, state["block"]):
            v, s = conv.step(s, _ACT[self.activation](v))
            new_state["block"].append(s)
        return u + v, new_state


class _SEANetStack(nn.Module):
    """A plan of ("act",) entries and parameterized layers run in order."""

    def _set_plan(self, plan: list, final_activation=None):
        self.plan = [e if e == "act" else None for e in plan]
        self.layers = nn.ModuleList(e for e in plan if e != "act")
        self.final_activation = final_activation

    def _run(self, x, states=None):
        act = _ACT[self.activation]
        layers = iter(self.layers)
        new_states = []
        i = 0
        for entry in self.plan:
            if entry == "act":
                x = act(x)
                continue
            layer = next(layers)
            if states is None:
                x = layer(x)
            else:
                x, s = layer.step(states["layers"][i], x)
                new_states.append(s)
            i += 1
        if self.final_activation is not None:
            x = _ACT[self.final_activation](x)
        return x, ({"layers": new_states} if states is not None else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._run(x)[0]

    def init_state(self, batch_size: int, dtype=torch.float32, device=None) -> dict:
        return {"layers": [m.init_state(batch_size, dtype, device) for m in self.layers]}

    def step(self, state: dict, x: torch.Tensor) -> tuple[torch.Tensor, dict]:
        return self._run(x, state)


class SEANetEncoder(_SEANetStack):
    """[B, channels, T] audio -> [B, dimension, T/hop] latents."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 3, ratios=(8, 5, 4, 2), activation: str = "ELU",
                 norm: str = "none", kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2, causal: bool = False,
                 pad_mode: str = "constant", true_skip: bool = True, compress: int = 2,
                 disable_norm_outer_blocks: int = 0,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.activation, self.dimension, self.ratios = activation, dimension, tuple(ratios)
        g = default_generator(generator, device)
        kw = dict(causal=causal, pad_mode=pad_mode, device=device, dtype=dtype, generator=g)
        dno = disable_norm_outer_blocks
        n_blocks = len(ratios) + 2
        mult = 1
        plan = [StreamingConv1d(channels, n_filters, kernel_size,
                                norm="none" if dno >= 1 else norm, **kw)]
        for i, ratio in enumerate(reversed(self.ratios)):
            block_norm = "none" if dno >= i + 2 else norm
            for j in range(n_residual_layers):
                plan.append(SEANetResnetBlock(
                    mult * n_filters, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base**j, 1), activation=activation,
                    norm=block_norm, compress=compress, true_skip=true_skip, **kw))
            plan.append("act")
            plan.append(StreamingConv1d(mult * n_filters, mult * n_filters * 2,
                                        kernel_size=ratio * 2, stride=ratio,
                                        norm=block_norm, **kw))
            mult *= 2
        plan.append("act")
        plan.append(StreamingConv1d(mult * n_filters, dimension, last_kernel_size,
                                    norm="none" if dno == n_blocks else norm, **kw))
        self._set_plan(plan)

    @property
    def hop_length(self) -> int:
        out = 1
        for r in self.ratios:
            out *= r
        return out


class SEANetDecoder(_SEANetStack):
    """[B, dimension, T] latents -> [B, channels, T*hop] audio."""

    def __init__(self, channels: int = 1, dimension: int = 128, n_filters: int = 32,
                 n_residual_layers: int = 3, ratios=(8, 5, 4, 2), activation: str = "ELU",
                 final_activation: str | None = None, norm: str = "none",
                 kernel_size: int = 7, last_kernel_size: int = 7,
                 residual_kernel_size: int = 3, dilation_base: int = 2, causal: bool = False,
                 pad_mode: str = "constant", true_skip: bool = True, compress: int = 2,
                 disable_norm_outer_blocks: int = 0, trim_right_ratio: float = 1.0,
                 *, device=None, dtype=torch.float32, generator=None):
        super().__init__()
        self.activation, self.dimension, self.ratios = activation, dimension, tuple(ratios)
        g = default_generator(generator, device)
        kw = dict(causal=causal, device=device, dtype=dtype, generator=g)
        dno = disable_norm_outer_blocks
        n_blocks = len(ratios) + 2
        mult = int(2 ** len(ratios))
        plan = [StreamingConv1d(dimension, mult * n_filters, kernel_size,
                                norm="none" if dno == n_blocks else norm,
                                pad_mode=pad_mode, **kw)]
        for i, ratio in enumerate(self.ratios):
            block_norm = "none" if dno >= n_blocks - (i + 1) else norm
            plan.append("act")
            plan.append(StreamingConvTranspose1d(
                mult * n_filters, mult * n_filters // 2, kernel_size=ratio * 2,
                stride=ratio, norm=block_norm, trim_right_ratio=trim_right_ratio, **kw))
            for j in range(n_residual_layers):
                plan.append(SEANetResnetBlock(
                    mult * n_filters // 2, kernel_sizes=(residual_kernel_size, 1),
                    dilations=(dilation_base**j, 1), activation=activation,
                    norm=block_norm, pad_mode=pad_mode, compress=compress,
                    true_skip=true_skip, **kw))
            mult //= 2
        plan.append("act")
        plan.append(StreamingConv1d(n_filters, channels, last_kernel_size,
                                    norm="none" if dno >= 1 else norm, pad_mode=pad_mode,
                                    **kw))
        self._set_plan(plan, final_activation)
