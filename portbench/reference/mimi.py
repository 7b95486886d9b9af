"""Mimi in plain PyTorch, offline over whole sessions.

SEANet encoder (causal convs, ELU, one residual block per ratio) -> an
8-layer transformer (LayerNorm, interleaved RoPE, causal attention over
``context`` positions, GELU FFN, layer scales) -> a learnt stride-2
downsample (replicate left pad) -> split residual VQ (one semantic level,
then acoustic levels), and the mirror path for decoding: codewords summed
and projected, a channel-wise transposed-conv upsample, the transformer,
the SEANet decoder. Convolutions are causal: the left pad is the kernel's
reach minus the stride, and a transposed conv drops its last
``kernel - stride`` samples. Arithmetic is float32; ``tf32`` lets the
matrix products and convolutions run in TF32 instead.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from portbench.reference.moshi import rope


@contextlib.contextmanager
def tf32_mode(enabled: bool):
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _elu(x):
    return F.elu(x, 1.0)


class MimiReference:
    def __init__(self, weights: dict, z: dict, tf32: bool = False):
        self.W, self.z, self.tf32 = weights, z, tf32

    def w(self, name: str) -> torch.Tensor:
        return self.W["mimi." + name]

    # -- convolutions -----------------------------------------------------

    def conv(self, x, name, stride=1, dilation=1, pad_mode="constant", groups=1):
        weight = self.w(name + ".weight")
        bias = self.W.get(f"mimi.{name}.bias")
        k = (weight.shape[-1] - 1) * dilation + 1
        length = x.shape[-1]
        extra = (math.ceil((length - k + (k - stride)) / stride + 1) - 1) * stride + stride - length
        x = F.pad(x, (k - stride, extra), mode=pad_mode)
        return F.conv1d(x, weight, bias, stride=stride, dilation=dilation, groups=groups)

    def convtr(self, x, name, stride, groups=1):
        weight = self.w(name + ".weight")
        y = F.conv_transpose1d(x, weight, self.W.get(f"mimi.{name}.bias"), stride=stride,
                               groups=groups)
        trim = weight.shape[-1] - stride
        return y[..., : y.shape[-1] - trim] if trim else y

    def resblock(self, x, name):
        v = self.conv(_elu(x), name + ".block.0")
        return x + self.conv(_elu(v), name + ".block.1")

    def seanet_encode(self, x):
        x = self.conv(x, "encoder.layers.0")
        i = 0
        for r in reversed(self.z["ratios"]):
            x = self.resblock(x, f"encoder.layers.{i + 1}")
            x = self.conv(_elu(x), f"encoder.layers.{i + 2}", stride=r)
            i += 2
        return self.conv(_elu(x), f"encoder.layers.{i + 1}")

    def seanet_decode(self, x):
        x = self.conv(x, "decoder.layers.0")
        i = 0
        for r in self.z["ratios"]:
            x = self.convtr(_elu(x), f"decoder.layers.{i + 1}", stride=r)
            x = self.resblock(x, f"decoder.layers.{i + 2}")
            i += 2
        return self.conv(_elu(x), f"decoder.layers.{i + 1}")

    # -- transformer ------------------------------------------------------

    def transformer(self, x: torch.Tensor, side: str) -> torch.Tensor:
        """[B, D, T] -> [B, D, T] through the encoder or decoder transformer."""
        z = self.z
        p = f"{side}_transformer.transformer.layers."
        x = x.transpose(1, 2)
        B, T, D = x.shape
        H = z["mimi_heads"]
        pos = torch.arange(T, device=x.device)
        delta = pos[:, None] - pos[None, :]
        mask = (delta >= 0) & (delta < z["mimi_context"])
        for i in range(z["mimi_layers"]):
            h = F.layer_norm(x, (D,), self.w(p + "norm1.weight")[i], self.w(p + "norm1.bias")[i],
                             1e-5)
            qkv = (h @ self.w(p + "in_proj")[i].T).reshape(B, T, 3, H, D // H)
            qkv = qkv.permute(2, 0, 3, 1, 4)
            q, k = rope(qkv[0], pos, 10000.0), rope(qkv[1], pos, 10000.0)
            logits = (q @ k.transpose(-1, -2)) / math.sqrt(D // H)
            att = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
            a = (att @ qkv[2]).transpose(1, 2).reshape(B, T, D)
            x = x + self.w(p + "layer_scale_1.scale")[i] * (a @ self.w(p + "out_proj")[i].T)
            h = F.layer_norm(x, (D,), self.w(p + "norm2.weight")[i], self.w(p + "norm2.bias")[i],
                             1e-5)
            ff = F.gelu(h @ self.w(p + "linear1")[i].T, approximate="tanh")
            x = x + self.w(p + "layer_scale_2.scale")[i] * (ff @ self.w(p + "linear2")[i].T)
        return x.transpose(1, 2)

    # -- quantizer ---------------------------------------------------------

    def codebooks(self) -> list[tuple[str, torch.Tensor]]:
        """(rvq name, centroids [levels, bins, dim]) for the levels used."""
        n = self.z["num_codebooks"]
        out = []
        for rvq, levels in (("rvq_first", 1), ("rvq_rest", n - 1)):
            p = f"quantizer.{rvq}.layers."
            emb = self.w(p + "embedding_sum")[:levels]
            usage = self.w(p + "cluster_usage")[:levels]
            out.append((rvq, emb / usage.clamp_min(1e-5)[..., None]))
        return out

    @torch.no_grad()
    def latent(self, pcm: torch.Tensor) -> torch.Tensor:
        """[B, 1, samples] -> [B, D, frames] unquantized latents."""
        with tf32_mode(self.tf32):
            emb = self.transformer(self.seanet_encode(pcm), "encoder")
            return self.conv(emb, "downsample", stride=self.z["resample"], pad_mode="replicate")

    @torch.no_grad()
    def projected(self, latent: torch.Tensor) -> list[torch.Tensor]:
        """Each RVQ's input: [B, frames, q_dim], first then rest."""
        with tf32_mode(self.tf32):
            return [latent.transpose(1, 2) @ self.w(f"quantizer.{rvq}.input_proj").T
                    for rvq in ("rvq_first", "rvq_rest")]

    @torch.no_grad()
    def encode(self, pcm: torch.Tensor) -> torch.Tensor:
        """[B, 1, samples] -> codes [B, num_codebooks, frames], each level the
        nearest centroid (first index on ties) of the running residual."""
        codes = []
        with tf32_mode(self.tf32):
            for x, (_, cb) in zip(self.projected(self.latent(pcm)), self.codebooks()):
                r = x
                for level in range(cb.shape[0]):
                    c = cb[level]
                    dist = c.square().sum(-1) - 2.0 * (r @ c.T)
                    idx = dist.argmin(-1)
                    codes.append(idx)
                    r = r - c[idx]
        return torch.stack(codes, dim=1)

    @torch.no_grad()
    def decode(self, codes: torch.Tensor, warm_frames: int = 0) -> torch.Tensor:
        """codes [B, num_codebooks, frames] -> audio [B, 1, samples] of the
        frames after the first ``warm_frames``. The warm frames are decoded
        with fresh convolution states and only feed the transformer's keys,
        as a session's delay warm-up frames do on the serving path that keeps
        them; the rest start from fresh convolution states again."""
        with tf32_mode(self.tf32):
            q = 0.0
            level = 0
            for rvq, cb in self.codebooks():
                s = sum(cb[i][codes[:, level + i]] for i in range(cb.shape[0]))
                q = q + s @ self.w(f"quantizer.{rvq}.output_proj").T
                level += cb.shape[0]
            lat = q.transpose(1, 2)
            s, D = self.z["resample"], lat.shape[1]
            parts = [lat[..., :warm_frames], lat[..., warm_frames:]] if warm_frames else [lat]
            up = torch.cat([self.convtr(p, "upsample", stride=s, groups=D) for p in parts], -1)
            emb = self.transformer(up, "decoder")[..., warm_frames * s :]
            return self.seanet_decode(emb)
