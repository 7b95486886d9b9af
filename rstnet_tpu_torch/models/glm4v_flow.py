"""GLM-4-Voice flow decoder: semantic tokens -> 22.05 kHz mel (counterpart
of ``rstnet_tpu/models/glm4v_flow.py``).

The CosyVoice conditional-flow-matching stack that GLM-4-Voice's decoder
runs: a block-causal conformer over the token embeddings (espnet or wenet
relative positions), a nearest-interpolation length regulator, and a
10-step Euler solve of a 1D U-Net velocity estimator with classifier-free
guidance (both guidance rows stacked into one estimator call per step).

Parameters are named by the JAX param tree's paths (``encoder.layers.0.q.w``).
Linear weights keep the JAX layout ``[in, out]``; conv weights are held in
torch's layouts (``[out, in/groups, width]``, and ``[in, out, width]``
unflipped for a transposed conv), so :func:`load_jax_tree` rewrites those
leaves of a JAX tree (``[width, in, out]``, a transposed conv's kernel
stored flipped) on the way in. Activations are ``[B, T, C]`` as in JAX and
go channel-first only around a conv. Everything runs in float32.

Two masks, kept apart as in JAX: the conformer sets masked scores to -inf
and zero-fills the softmax (a fully masked row gives 0), while the U-Net's
transformer blocks add the {0,1} pad-mask outer product to the scores as a
bias (diffusers semantics; a no-op but for rounding at full length).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rstnet_tpu_torch.core import default_generator, flatten_dict, from_jax_params, new_param
from rstnet_tpu_torch.core import normal as _normal
from rstnet_tpu_torch.core import uniform
from rstnet_tpu_torch.serving.graphs import CapturedStep, capture_stream

# -- parameter holders and helpers --------------------------------------------


class Linear(nn.Module):
    """``w [in, out]`` (the JAX layout) and ``b``, U(+-1/sqrt(in)) and zeros
    as the JAX init draws them."""

    def __init__(self, d_in: int, d_out: int, bias: bool = True, *, device=None, generator=None):
        super().__init__()
        g = default_generator(generator, device)
        self.w = new_param(uniform((d_in, d_out), 1.0 / math.sqrt(d_in), g, device))
        self.b = new_param(torch.zeros(d_out, device=device)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.w.T, self.b)


class Conv(nn.Module):
    """A conv's ``w`` in torch's layout (``[out, in/groups, width]``, or
    ``[in, out, width]`` with ``transposed``) and ``b``; U(+-1/sqrt(fan_in))
    and zeros as the JAX init draws them."""

    def __init__(self, width: int, d_in: int, d_out: int, bias: bool = True, groups: int = 1,
                 transposed: bool = False, *, device=None, generator=None, std=None):
        super().__init__()
        g = default_generator(generator, device)
        self.transposed = transposed
        shape = (d_in, d_out, width) if transposed else (d_out, d_in // groups, width)
        if std is None:
            w = uniform(shape, 1.0 / math.sqrt(d_in // groups * width), g, device)
        else:
            w = _normal(shape, g, device) * std
        self.w = new_param(w)
        self.b = new_param(torch.zeros(d_out, device=device)) if bias else None


class Norm(nn.Module):
    """``scale`` and ``bias`` of a layer or group norm."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = new_param(torch.ones(d, device=device))
        self.bias = new_param(torch.zeros(d, device=device))


def jax_conv_weight(w, transposed: bool) -> torch.Tensor:
    """A JAX conv kernel ``[width, in, out]`` in torch's layout; a transposed
    conv's JAX kernel is stored flipped, torch's is not."""
    w = w if isinstance(w, torch.Tensor) else torch.from_numpy(np.array(w))
    if transposed:
        return w.flip(0).permute(1, 2, 0).contiguous()
    return w.permute(2, 1, 0).contiguous()


def load_jax_tree(module: nn.Module, tree) -> nn.Module:
    """Load a JAX param tree (numpy arrays or tensors, JAX layouts) into
    ``module`` in place: every :class:`Conv`'s kernel is rewritten to
    torch's layout, the rest is copied by path (``core.from_jax_params``)."""
    flat = {k: v for k, v in flatten_dict(tree)}
    for name, m in module.named_modules():
        if isinstance(m, Conv):
            flat[f"{name}.w"] = jax_conv_weight(flat[f"{name}.w"], m.transposed)
    return from_jax_params(flat, module)


def same_padding(length: int, width: int, stride: int = 1, dilation: int = 1) -> tuple[int, int]:
    """JAX's ``SAME`` padding (left, right): the output is ceil(T / stride)
    long and the extra pad of an even total goes on the right."""
    eff = (width - 1) * dilation + 1
    out = -(-length // stride)
    total = max((out - 1) * stride + eff - length, 0)
    return total // 2, total - total // 2


def conv1d(p: Conv, x: torch.Tensor, stride: int = 1, padding="SAME", groups: int = 1,
           dilation: int = 1) -> torch.Tensor:
    """x ``[B, C, T]`` channel-first -> ``[B, C', T']``; ``padding`` is
    ``"SAME"``, ``"VALID"`` or a (left, right) pair, as JAX's."""
    if padding == "SAME":
        padding = same_padding(x.shape[-1], p.w.shape[-1], stride, dilation)
    elif padding == "VALID":
        padding = (0, 0)
    if padding[0] != padding[1]:
        x = F.pad(x, padding)
        padding = (0, 0)
    return F.conv1d(x, p.w, p.b, stride=stride, padding=padding[0], dilation=dilation,
                    groups=groups)


def conv_transpose1d(p: Conv, x: torch.Tensor, stride: int, torch_padding: int) -> torch.Tensor:
    """``torch.nn.ConvTranspose1d``: x ``[B, C, T]`` -> ``[B, C', (T-1)*stride
    - 2*torch_padding + width]`` (JAX: an input-dilated conv with the
    flipped kernel)."""
    return F.conv_transpose1d(x, p.w, p.b, stride=stride, padding=torch_padding)


def layer_norm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Over the last axis (one fused call where JAX writes out the mean and
    variance)."""
    return F.layer_norm(x, x.shape[-1:], p.scale, p.bias, eps)


def group_norm(p: Norm, x: torch.Tensor, groups: int, eps: float = 1e-5) -> torch.Tensor:
    """x ``[B, C, T]``: statistics over (C/groups, T) per group."""
    return F.group_norm(x, groups, p.scale, p.bias, eps)


def mish(x: torch.Tensor) -> torch.Tensor:
    """x tanh(softplus(x))."""
    return F.mish(x)


def sinusoid_table(max_len: int, d: int) -> np.ndarray:
    """The sin/cos interleaved table ``[max_len, d]`` (wenet's layout),
    computed in float64 and rounded to float32."""
    pos = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d, 2, dtype=np.float64) * -(math.log(10000.0) / d))
    pe = np.zeros((max_len, d), np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe.astype(np.float32)


# -- block-causal conformer -----------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConformerConfig:
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    block_size: int = 10            # grid width of the block-causal mask
    pos_enc: str = "rel_pos_espnet"  # or "rel_pos" (wenet legacy, no shift)
    macaron_style: bool = True
    use_cnn_module: bool = True
    cnn_kernel: int = 15
    cnn_causal: bool = False
    cnn_norm: str = "batch_norm"    # or "layer_norm"
    key_bias: bool = True

    @property
    def head_dim(self) -> int:
        return self.output_size // self.attention_heads


class FFN(nn.Module):
    def __init__(self, d: int, hidden: int, *, device=None, generator=None):
        super().__init__()
        self.w1 = Linear(d, hidden, device=device, generator=generator)
        self.w2 = Linear(hidden, d, device=device, generator=generator)

    def forward(self, x):
        return self.w2(F.silu(self.w1(x)))


class BatchNormStats(nn.Module):
    """Running-stat batch norm: ``scale``, ``bias``, ``mean``, ``var``."""

    def __init__(self, d: int, *, device=None):
        super().__init__()
        self.scale = new_param(torch.ones(d, device=device))
        self.bias = new_param(torch.zeros(d, device=device))
        self.mean = new_param(torch.zeros(d, device=device))
        self.var = new_param(torch.ones(d, device=device))


class ConformerLayer(nn.Module):
    def __init__(self, cfg: ConformerConfig, *, device=None, generator=None):
        super().__init__()
        d, kw = cfg.output_size, dict(device=device, generator=generator)
        g = default_generator(generator, device)
        self.norm_mha = Norm(d, device=device)
        self.q = Linear(d, d, **kw)
        self.k = Linear(d, d, bias=cfg.key_bias, **kw)
        self.v = Linear(d, d, **kw)
        self.o = Linear(d, d, **kw)
        self.pos = Linear(d, d, bias=False, **kw)
        self.pos_bias_u = new_param(_normal((cfg.attention_heads, cfg.head_dim), g, device) * 0.02)
        self.pos_bias_v = new_param(_normal((cfg.attention_heads, cfg.head_dim), g, device) * 0.02)
        self.norm_ff = Norm(d, device=device)
        self.ffn = FFN(d, cfg.linear_units, **kw)
        if cfg.macaron_style:
            self.norm_ff_macaron = Norm(d, device=device)
            self.ffn_macaron = FFN(d, cfg.linear_units, **kw)
        if cfg.use_cnn_module:
            self.norm_conv = Norm(d, device=device)
            self.norm_final = Norm(d, device=device)
            self.pw1 = Conv(1, d, 2 * d, **kw)
            self.dw = Conv(cfg.cnn_kernel, d, d, groups=d, **kw)
            self.pw2 = Conv(1, d, d, **kw)
            if cfg.cnn_norm == "batch_norm":
                self.bn = BatchNormStats(d, device=device)
            else:
                self.cn_ln = Norm(d, device=device)


def block_grid_mask(T: int, block: int, device=None) -> torch.Tensor:
    """``[T, T]`` bool: causal OR same block (each position sees every
    earlier block and the whole of its own)."""
    pos = torch.arange(T, device=device)
    return (pos[:, None] >= pos[None, :]) | ((pos[:, None] // block) == (pos[None, :] // block))


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """Espnet's rel-shift: ``[B, H, T, 2T-1]`` -> ``[B, H, T, T]``."""
    B, H, T, P = x.shape
    xp = torch.cat([x.new_zeros(B, H, T, 1), x], dim=-1).reshape(B, H, P + 1, T)
    return xp[:, :, 1:].reshape(B, H, T, P)[..., : P // 2 + 1]


def conformer_attention(cfg: ConformerConfig, p: ConformerLayer, x, pos_emb, mask):
    """Relative-position MHA: ((q+u)k^T + shift((q+v)p^T)) / sqrt(dk), masked
    by pad AND grid to -inf, the softmax zero-filled where masked."""
    B, T, D = x.shape
    H, hd = cfg.attention_heads, cfg.head_dim
    q = p.q(x).reshape(B, T, H, hd)
    k = p.k(x).reshape(B, T, H, hd).transpose(1, 2)
    v = p.v(x).reshape(B, T, H, hd).transpose(1, 2)
    pe = p.pos(pos_emb).reshape(-1, H, hd).permute(1, 2, 0)  # [H, hd, P]
    qu = (q + p.pos_bias_u).transpose(1, 2)
    qv = (q + p.pos_bias_v).transpose(1, 2)
    ac = qu @ k.transpose(-1, -2)
    bd = qv @ pe
    if bd.shape != ac.shape:  # espnet's 2T-1 table
        bd = rel_shift(bd)
    scores = (ac + bd) / math.sqrt(hd)
    scores = scores.masked_fill(~mask[:, None], float("-inf"))
    attn = torch.softmax(scores, dim=-1).masked_fill(~mask[:, None], 0.0)
    out = (attn @ v).transpose(1, 2).reshape(B, T, D)
    return p.o(out)


def conformer_conv(cfg: ConformerConfig, p: ConformerLayer, x, pad_mask):
    """The convolution module: pointwise, GLU, depthwise, norm, silu,
    pointwise; ``[B, T, C]`` in and out."""
    m = pad_mask[:, None, :].to(x.dtype)
    x = x.transpose(1, 2) * m
    x = conv1d(p.pw1, x, padding="VALID")
    a, b = x.chunk(2, dim=1)
    x = a * torch.sigmoid(b)
    pad = (cfg.cnn_kernel - 1, 0) if cfg.cnn_causal else "SAME"
    x = conv1d(p.dw, x, padding=pad, groups=cfg.output_size)
    if cfg.cnn_norm == "batch_norm":
        bn = p.bn
        x = ((x - bn.mean[:, None]) * torch.rsqrt(bn.var[:, None] + 1e-5) * bn.scale[:, None]
             + bn.bias[:, None])
    else:
        x = layer_norm(p.cn_ln, x.transpose(1, 2)).transpose(1, 2)
    x = conv1d(p.pw2, F.silu(x), padding="VALID")
    return (x * m).transpose(1, 2)


class Embed(nn.Module):
    def __init__(self, d_in: int, d: int, *, device=None, generator=None):
        super().__init__()
        self.lin = Linear(d_in, d, device=device, generator=generator)
        self.ln = Norm(d, device=device)


class Conformer(nn.Module):
    """x ``[B, T, input_size]``, pad_mask ``[B, T]`` bool -> ``[B, T,
    output_size]``."""

    def __init__(self, cfg: ConformerConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        d = cfg.output_size
        self.embed = Embed(cfg.input_size, d, device=device, generator=generator)
        self.after_norm = Norm(d, device=device)
        self.layers = nn.ModuleList(ConformerLayer(cfg, device=device, generator=generator)
                                    for _ in range(cfg.num_blocks))

    def pos_emb(self, T: int, device) -> torch.Tensor:
        d = self.cfg.output_size
        table = sinusoid_table(T, d)
        if self.cfg.pos_enc == "rel_pos_espnet":
            # positions T-1 .. -(T-1): the flipped table, then the negative
            # tail (sin is odd, cos even)
            neg = table.copy()
            neg[:, 0::2] *= -1.0
            table = np.concatenate([table[::-1], neg[1:]], 0)
        return torch.from_numpy(np.ascontiguousarray(table)).to(device)

    def forward(self, x: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        T = x.shape[1]
        x = layer_norm(self.embed.ln, self.embed.lin(x)) * math.sqrt(cfg.output_size)
        pos_emb = self.pos_emb(T, x.device)
        mask = pad_mask[:, None, :] & block_grid_mask(T, cfg.block_size, x.device)[None]
        ff_scale = 0.5 if cfg.macaron_style else 1.0
        for layer in self.layers:
            if cfg.macaron_style:
                x = x + 0.5 * layer.ffn_macaron(layer_norm(layer.norm_ff_macaron, x))
            x = x + conformer_attention(cfg, layer, layer_norm(layer.norm_mha, x), pos_emb, mask)
            if cfg.use_cnn_module:
                x = x + conformer_conv(cfg, layer, layer_norm(layer.norm_conv, x), pad_mask)
            x = x + ff_scale * layer.ffn(layer_norm(layer.norm_ff, x))
            if cfg.use_cnn_module:
                x = layer_norm(layer.norm_final, x)
        return layer_norm(self.after_norm, x)


# -- nearest-interpolation length regulator ----------------------------------------


class Regulator(nn.Module):
    """Nearest interpolation to ``out_len`` frames (index floor(i*T/out)),
    then conv -> GroupNorm(1) -> mish stages and a 1x1 conv."""

    def __init__(self, channels: int, n_stages: int, out_channels: int, *, device=None,
                 generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.convs = nn.ModuleList(Conv(3, channels, channels, **kw) for _ in range(n_stages))
        self.norms = nn.ModuleList(Norm(channels, device=device) for _ in range(n_stages))
        self.out = Conv(1, channels, out_channels, **kw)

    def forward(self, x: torch.Tensor, out_len: int) -> torch.Tensor:
        T = x.shape[1]
        idx = torch.arange(out_len, device=x.device) * T // out_len
        x = x[:, idx].transpose(1, 2)
        for conv, norm in zip(self.convs, self.norms):
            x = mish(group_norm(norm, conv1d(conv, x), groups=1))
        return conv1d(self.out, x, padding="VALID").transpose(1, 2)


# -- U-Net velocity estimator ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 320          # x(80) + mu(80) + spks(80) + cond(80)
    out_channels: int = 80
    channels: tuple = (256, 256)
    attention_head_dim: int = 64
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    act_fn: str = "gelu"

    @property
    def time_embed_dim(self) -> int:
        return self.channels[0] * 4


class ResNet1D(nn.Module):
    def __init__(self, d_in: int, d_out: int, t_dim: int, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.mlp = Linear(t_dim, d_out, **kw)
        self.b1_conv = Conv(3, d_in, d_out, **kw)
        self.b1_gn = Norm(d_out, device=device)
        self.b2_conv = Conv(3, d_out, d_out, **kw)
        self.b2_gn = Norm(d_out, device=device)
        self.res = Conv(1, d_in, d_out, **kw)

    def forward(self, x, m, t_emb):
        """x ``[B, C, T]``, m ``[B, 1, T]``."""
        h = block1d(self.b1_conv, self.b1_gn, x, m)
        h = h + self.mlp(mish(t_emb))[:, :, None]
        h = block1d(self.b2_conv, self.b2_gn, h, m)
        return h + conv1d(self.res, x * m, padding="VALID")


def block1d(conv: Conv, gn: Norm, x, m):
    return mish(group_norm(gn, conv1d(conv, x * m), groups=8)) * m


class TxBlock(nn.Module):
    """Matcha's BasicTransformerBlock: self-attention (bias-free q/k/v),
    layer norms, a GELU feed-forward."""

    def __init__(self, cfg: UNetConfig, dim: int, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        inner = cfg.num_heads * cfg.attention_head_dim
        self.ln1 = Norm(dim, device=device)
        self.to_q = Linear(dim, inner, bias=False, **kw)
        self.to_k = Linear(dim, inner, bias=False, **kw)
        self.to_v = Linear(dim, inner, bias=False, **kw)
        self.to_out = Linear(inner, dim, **kw)
        self.ln3 = Norm(dim, device=device)
        self.ff_in = Linear(dim, dim * 4, **kw)
        self.ff_out = Linear(dim * 4, dim, **kw)

    def forward(self, cfg: UNetConfig, x, attn_bias):
        """x ``[B, T, C]``; attn_bias ``[B, T, T]`` added to the scores."""
        B, T, _ = x.shape
        H, hd = cfg.num_heads, cfg.attention_head_dim
        h = layer_norm(self.ln1, x)
        q = self.to_q(h).reshape(B, T, H, hd).transpose(1, 2)
        k = self.to_k(h).reshape(B, T, H, hd).transpose(1, 2)
        v = self.to_v(h).reshape(B, T, H, hd).transpose(1, 2)
        scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)
        if attn_bias is not None:
            scores = scores + attn_bias[:, None]
        out = (torch.softmax(scores, dim=-1) @ v).transpose(1, 2).reshape(B, T, H * hd)
        x = x + self.to_out(out)
        h = self.ff_in(layer_norm(self.ln3, x))
        h = F.gelu(h, approximate="tanh" if cfg.act_fn == "gelu-approximate" else "none")
        return x + self.ff_out(h)


class UNetBlock(nn.Module):
    """A resnet and ``n_blocks`` transformer blocks; a down or up block also
    holds its resampling conv (``down`` or ``up``)."""

    def __init__(self, cfg: UNetConfig, d_in: int, d_out: int, *, device=None, generator=None):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.resnet = ResNet1D(d_in, d_out, cfg.time_embed_dim, **kw)
        self.tx = nn.ModuleList(TxBlock(cfg, d_out, **kw) for _ in range(cfg.n_blocks))

    def run(self, cfg: UNetConfig, h, m, t_emb):
        """resnet then the transformer blocks; h ``[B, C, T]``."""
        h = self.resnet(h, m, t_emb).transpose(1, 2)
        m2 = m[:, 0]
        bias = m2[:, :, None] * m2[:, None, :]
        for tx in self.tx:
            h = tx(cfg, h, bias)
        return h.transpose(1, 2)


class TimeMLP(nn.Module):
    def __init__(self, d_in: int, t_dim: int, *, device=None, generator=None):
        super().__init__()
        self.lin1 = Linear(d_in, t_dim, device=device, generator=generator)
        self.lin2 = Linear(t_dim, t_dim, device=device, generator=generator)


class FinalBlock(nn.Module):
    def __init__(self, ch: int, *, device=None, generator=None):
        super().__init__()
        self.conv = Conv(3, ch, ch, device=device, generator=generator)
        self.gn = Norm(ch, device=device)


class UNet(nn.Module):
    """The velocity estimator: ``forward(x, mask, mu, t, spks, cond)`` with
    x/mu/cond ``[B, T, 80]``, mask ``[B, T]`` float, t a scalar or ``[B]``,
    spks ``[B, 80]`` -> ``[B, T, 80]``."""

    def __init__(self, cfg: UNetConfig, *, device=None, generator=None):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, generator=generator)
        t_dim = cfg.time_embed_dim
        self.time_mlp = TimeMLP(cfg.in_channels, t_dim, **kw)
        self.down = nn.ModuleList()
        out_ch = cfg.in_channels
        for ch in cfg.channels:
            blk = UNetBlock(cfg, out_ch, ch, **kw)
            blk.down = Conv(3, ch, ch, **kw)
            self.down.append(blk)
            out_ch = ch
        self.mid = nn.ModuleList(UNetBlock(cfg, cfg.channels[-1], cfg.channels[-1], **kw)
                                 for _ in range(cfg.num_mid_blocks))
        up_chs = cfg.channels[::-1] + (cfg.channels[0],)
        self.up = nn.ModuleList()
        for i in range(len(up_chs) - 1):
            last = i == len(up_chs) - 2
            blk = UNetBlock(cfg, up_chs[i] * 2, up_chs[i + 1], **kw)
            # the last block's is a stride-1 conv, the others' a stride-2
            # transposed conv of width 4
            blk.up = Conv(3 if last else 4, up_chs[i + 1], up_chs[i + 1], transposed=not last,
                          **kw)
            self.up.append(blk)
        self.final_block = FinalBlock(up_chs[-1], **kw)
        self.final_proj = Conv(1, up_chs[-1], cfg.out_channels, **kw)

    def time_embedding(self, t: torch.Tensor) -> torch.Tensor:
        """SinusoidalPosEmb at scale 1000, then linear/silu/linear."""
        t = torch.atleast_1d(t)
        half = self.cfg.in_channels // 2
        freqs = torch.exp(torch.arange(half, device=t.device, dtype=torch.float32)
                          * -(math.log(10000.0) / (half - 1)))
        ang = 1000.0 * t[:, None] * freqs[None, :]
        emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
        return self.time_mlp.lin2(F.silu(self.time_mlp.lin1(emb)))

    def forward(self, x, mask, mu, t, spks=None, cond=None):
        cfg = self.cfg
        B, T, _ = x.shape
        t_emb = self.time_embedding(t)
        if t_emb.shape[0] == 1 and B > 1:
            t_emb = t_emb.expand(B, -1)
        feats = [x, mu]
        if spks is not None:
            feats.append(spks[:, None, :].expand(B, T, spks.shape[-1]))
        if cond is not None:
            feats.append(cond)
        h = torch.cat(feats, dim=-1).transpose(1, 2)  # [B, C, T]

        hiddens, masks = [], [mask[:, None, :]]
        for i, blk in enumerate(self.down):
            m = masks[-1]
            h = blk.run(cfg, h, m, t_emb)
            hiddens.append(h)
            if i == len(self.down) - 1:
                h = conv1d(blk.down, h * m)
            else:
                h = conv1d(blk.down, h * m, stride=2, padding=(1, 1))
                m = m[:, :, ::2]
            masks.append(m)
        masks = masks[:-1]
        m = masks[-1]
        for blk in self.mid:
            h = blk.run(cfg, h, m, t_emb)
        for i, blk in enumerate(self.up):
            m = masks.pop()
            skip = hiddens.pop()
            h = torch.cat([h[:, :, : skip.shape[2]], skip], dim=1)
            h = blk.run(cfg, h, m, t_emb)
            if i == len(self.up) - 1:
                h = conv1d(blk.up, h * m)
            else:
                h = conv_transpose1d(blk.up, h * m, stride=2, torch_padding=1)
        fb = self.final_block
        h = block1d(fb.conv, fb.gn, h, m)
        out = conv1d(self.final_proj, h * m, padding="VALID")
        return (out * mask[:, None, :]).transpose(1, 2)


# -- conditional flow matching --------------------------------------------------------


def cfm_solve(unet: UNet, z, mu, mask, spks, cond, n_timesteps: int = 10,
              inference_cfg_rate: float = 0.7, t_scheduler: str = "cosine",
              cuda_graph: bool = True) -> torch.Tensor:
    """Euler solve with classifier-free guidance, the conditional and the
    unconditional rows stacked into one estimator call a step. z/mu/cond
    ``[B, T, 80]``; mask ``[B, T]``; spks ``[B, 80]``.

    On a CUDA device, unless ``cuda_graph`` is False (the eager reference),
    the estimator call is a CUDA graph over the solve's fixed conditions
    (``serving/graphs.py``'s :class:`CapturedStep`, on the device's
    :func:`capture_stream`): the first step runs it eagerly, the second
    captures it, the rest replay it, so the host launches the U-Net's
    kernels twice a solve instead of ``n_timesteps`` times (a streamed
    decode, host-bound, halves its wall time)."""
    t_span = torch.linspace(0.0, 1.0, n_timesteps + 1, device=z.device, dtype=torch.float32)
    if t_scheduler == "cosine":
        t_span = 1.0 - torch.cos(t_span * 0.5 * math.pi)
    x2, t = torch.cat([z, z], 0), t_span[0].clone()  # the estimator's inputs, written in place
    inputs = (x2, torch.cat([mask, mask], 0), torch.cat([mu, torch.zeros_like(mu)], 0), t,
              torch.cat([spks, torch.zeros_like(spks)], 0),
              torch.cat([cond, torch.zeros_like(cond)], 0))
    if cuda_graph and z.is_cuda:
        estimate = CapturedStep(lambda state, *a: (unet(*a), state), {}, inputs,
                                stream=capture_stream(z.device), name="cfm_solve's U-Net")
    else:
        def estimate():
            return unet(*inputs)
    x = z
    for i in range(n_timesteps):
        x2.copy_(torch.cat([x, x], 0))
        t.copy_(t_span[i])
        v, v_u = estimate().chunk(2, dim=0)
        if inference_cfg_rate > 0:
            v = (1.0 + inference_cfg_rate) * v - inference_cfg_rate * v_u
        x = x + (t_span[i + 1] - t_span[i]) * v
    return x


# -- token -> mel ------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GLM4VFlowConfig:
    vocab_size: int = 16384
    input_size: int = 512
    output_size: int = 80           # mel bins
    spk_embed_dim: int = 192
    input_frame_rate: float = 12.5  # GLM-4-Voice semantic token rate
    mel_sample_rate: int = 22050
    mel_hop: int = 256
    regulator_stages: int = 4
    encoder: ConformerConfig = dataclasses.field(default_factory=ConformerConfig)
    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    n_timesteps: int = 10
    inference_cfg_rate: float = 0.7
    sigma_min: float = 1e-6

    def mel_len(self, token_len: int) -> int:
        return int(token_len / self.input_frame_rate * self.mel_sample_rate / self.mel_hop)


class GLM4VFlow(nn.Module):
    """CosyVoice's token -> mel flow (``MaskedDiffWithXvec.inference``)."""

    def __init__(self, config: GLM4VFlowConfig = GLM4VFlowConfig(), *, device=None,
                 generator=None):
        super().__init__()
        cfg = self.config = config
        g = default_generator(generator, device)
        kw = dict(device=device, generator=g)
        self.input_embedding = new_param(_normal((cfg.vocab_size, cfg.input_size), g, device)
                                         * 0.02)
        self.spk_affine = Linear(cfg.spk_embed_dim, cfg.output_size, **kw)
        self.encoder = Conformer(cfg.encoder, **kw)
        self.encoder_proj = Linear(cfg.encoder.output_size, cfg.output_size, **kw)
        self.regulator = Regulator(cfg.output_size, cfg.regulator_stages, cfg.output_size, **kw)
        self.unet = UNet(cfg.unet, **kw)

    @torch.no_grad()
    def inference(self, token: torch.Tensor, z: torch.Tensor,
                  embedding: Optional[torch.Tensor] = None,
                  prompt_feat: Optional[torch.Tensor] = None,
                  n_timesteps: Optional[int] = None) -> torch.Tensor:
        """token ``[B, T_tok]``, z ``[B, T_mel, 80]`` the source noise,
        embedding ``[B, spk_embed_dim]`` or None (a zero x-vector, as
        GLM-4-Voice passes), prompt_feat ``[B, T_prompt, 80]`` the streaming
        mel prompt, written into the conditions. -> mel ``[B, T_mel, 80]``,
        the prompt region not trimmed."""
        cfg = self.config
        B, T_tok = token.shape
        if embedding is None:
            embedding = torch.zeros(B, cfg.spk_embed_dim, device=z.device)
        norm = torch.linalg.vector_norm(embedding, dim=-1, keepdim=True)
        spks = self.spk_affine(embedding / torch.clamp(norm, min=1e-12))
        x = self.input_embedding[torch.clamp(token, min=0)]
        pad_mask = torch.ones(B, T_tok, dtype=torch.bool, device=z.device)
        h = self.encoder_proj(self.encoder(x, pad_mask))
        T_mel = z.shape[1]
        h = self.regulator(h, T_mel)
        conds = torch.zeros(B, T_mel, cfg.output_size, device=z.device)
        if prompt_feat is not None and prompt_feat.shape[1] > 0:
            conds[:, : prompt_feat.shape[1]] = prompt_feat
        mask = torch.ones(B, T_mel, device=z.device)
        return cfm_solve(self.unet, z, h, mask, spks, conds,
                         n_timesteps=n_timesteps or cfg.n_timesteps,
                         inference_cfg_rate=cfg.inference_cfg_rate)
