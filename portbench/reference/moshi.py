"""Moshi's RQ-Transformer in plain PyTorch, teacher-forced over whole
sessions (no cache, no kernels, no batching tricks).

The temporal transformer (RMS norms in float32, interleaved RoPE, causal
attention over ``context`` positions, SiLU-gated FFN) runs once over a
session's backbone inputs; the depth transformer (per-step weights, causal
over the ``dep_q`` codebooks of one frame) runs over the served tokens of
every frame at once. Arithmetic is float32 with TF32 off, on weights held in
their stored dtype and widened one layer at a time.

``formats`` ({matrix or embedding table name: "int8", "int4" or "fp8"})
rounds those tensors per output row (a table: per token): to integers
(symmetric, scale ``max |w| / (2**(bits-1) - 1)``, the rule the int8 serving
weights use) or to float8 e4m3 (scale ``max |w| / 448``, and a matrix's
input rows alike: a float8 product takes both operands in float8); ``kv``
("int8" or "int4") stores the backbone's keys and values as integers per
position and head with a bf16 scale, as the int8 ring does. ``backbone_inputs`` rebuilds, from the tokens a session generated and
the codes its audio gave, the frame that the streaming engine feeds the
backbone at each step: with per-stream delays, the initial token until a
stream's delay has passed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

MATRICES = ("transformer.layers.in_proj", "transformer.layers.out_proj",
            "transformer.layers.gating.linear_in", "transformer.layers.gating.linear_out",
            "depformer.layers.in_proj", "depformer.layers.out_proj",
            "depformer.layers.gating.linear_in", "depformer.layers.gating.linear_out",
            "depformer_in", "linears.weight")
TABLES = ("emb", "text_emb", "depformer_emb", "depformer_text_emb")  # embedding tables


def quantize_rows(w: torch.Tensor, fmt: str) -> torch.Tensor:
    """Per-output-row rounding of ``[..., out, in]`` to ``fmt`` ("int8",
    "int4": symmetric integers; "fp8": float8 e4m3), back in float32."""
    wf = w.float()
    if fmt == "fp8":
        s = torch.clamp_min(wf.abs().amax(-1) / 448.0, 1e-12)[..., None]
        return (wf / s).to(torch.float8_e4m3fn).float() * s
    qmax = {"int8": 127, "int4": 7}[fmt]
    s = torch.clamp_min(wf.abs().amax(-1) / qmax, 1e-8)
    return torch.clamp(torch.round(wf / s[..., None]), -qmax, qmax) * s[..., None]


def quantize_kv(x: torch.Tensor, fmt: str = "int8") -> torch.Tensor:
    """Integers per position and head over the head dim, scale kept in bf16."""
    qmax = {"int8": 127, "int4": 7}[fmt]
    s = torch.clamp_min(x.abs().amax(-1), 1e-8) / qmax
    q = torch.clamp(torch.round(x / s[..., None]), -qmax, qmax)
    return q * s.to(torch.bfloat16).float()[..., None]


def rms_norm(x: torch.Tensor, alpha: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x * (alpha.float() * torch.rsqrt(eps + x.square().mean(-1, keepdim=True)))


def rope(x: torch.Tensor, positions: torch.Tensor, max_period: float) -> torch.Tensor:
    """Interleaved rotary embedding of [B, H, T, D] at ``positions`` [T]."""
    D = x.shape[-1]
    freqs = torch.exp(torch.arange(D // 2, dtype=torch.float32, device=x.device)
                      * (-math.log(max_period) * 2 / D))
    ang = positions.float()[:, None] * freqs[None]
    c, s = torch.cos(ang), torch.sin(ang)
    xr, xi = x[..., 0::2], x[..., 1::2]
    return torch.stack([xr * c - xi * s, xr * s + xi * c], dim=-1).flatten(-2)


def attention(q, k, v, context: int | None) -> torch.Tensor:
    """Causal softmax attention over [B, H, T, D], keys within ``context``."""
    T = q.shape[2]
    pos = torch.arange(T, device=q.device)
    delta = pos[:, None] - pos[None, :]
    mask = delta >= 0
    if context is not None:
        mask &= delta < context
    logits = (q @ k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.softmax(logits, dim=-1) @ v


class MoshiReference:
    def __init__(self, weights: dict, z: dict, formats: dict | None = None,
                 kv: str | None = None):
        self.W, self.z, self.formats, self.kv = weights, z, formats or {}, kv

    def w(self, name: str, *index) -> torch.Tensor:
        t = self.W["lm." + name]
        for i in index:
            t = t[i]
        if name in self.formats:
            return quantize_rows(t, self.formats[name])
        return t.float()

    def rows(self, name: str, tokens: torch.Tensor, *index) -> torch.Tensor:
        """The rows of embedding table ``name`` that ``tokens`` look up."""
        t = self.W["lm." + name]
        for i in index:
            t = t[i]
        e = t[tokens]
        return quantize_rows(e, self.formats[name]) if name in self.formats else e.float()

    def a(self, x: torch.Tensor, name: str) -> torch.Tensor:
        """The input of matrix ``name``: a float8 product takes both operands
        in float8, so where the matrix is "fp8" its input rows are too."""
        return quantize_rows(x, "fp8") if self.formats.get(name) == "fp8" else x

    # -- inputs -----------------------------------------------------------

    def backbone_inputs(self, gen: torch.Tensor, user: torch.Tensor) -> torch.Tensor:
        """[B, 1+n_q, T] backbone inputs from the generated tokens ``gen``
        [B, dep_q+1, T] (text, then audio; step t's in column t) and the
        user's codes ``user`` [B, n_q-dep_q, T] (frame t's in column t)."""
        z = self.z
        B, _, T = gen.shape
        K = z["n_q"] + 1
        initial = torch.tensor([z["text_card"]] + [z["card"]] * z["n_q"], device=gen.device)
        out = initial[None, :, None].repeat(B, 1, T)
        for k in range(K):
            d = z["delays"][k]
            src = gen[:, k] if k <= z["dep_q"] else user[:, k - z["dep_q"] - 1]
            shift = 1 if k <= z["dep_q"] else d  # generated: last step's; user: frame t-d
            t0 = d + 1
            if t0 < T:
                out[:, k, t0:] = src[:, t0 - shift : T - shift]
        return out

    # -- temporal transformer ---------------------------------------------

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        z = self.z
        x = 0.0
        for k in range(z["n_q"]):
            tok = tokens[:, k + 1]
            e = self.rows("emb", tok.clamp(0, z["card"]), k)
            x = x + torch.where((tok == -1)[..., None], 0.0, e)
        text = tokens[:, 0]
        te = self.rows("text_emb", text.clamp(0, z["text_card"]))
        return x + torch.where((text == -1)[..., None], 0.0, te)

    @torch.no_grad()
    def backbone(self, tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, 1+n_q, T] inputs -> (hidden [B, T, dim], text logits [B, T, V])."""
        z = self.z
        x = self.embed(tokens)
        B, T, d = x.shape
        H = z["num_heads"]
        pos = torch.arange(T, device=x.device)
        p = "transformer.layers."
        for i in range(z["num_layers"]):
            h = rms_norm(x, self.w(p + "norm1.alpha", i))
            qkv = self.a(h, p + "in_proj") @ self.w(p + "in_proj", i).T
            qkv = qkv.reshape(B, T, 3, H, d // H).permute(2, 0, 3, 1, 4)
            q = rope(qkv[0], pos, z["max_period"])
            k = rope(qkv[1], pos, z["max_period"])
            v = qkv[2]
            if self.kv:
                k, v = quantize_kv(k, self.kv), quantize_kv(v, self.kv)
            a = attention(q, k, v, z["context"]).transpose(1, 2).reshape(B, T, d)
            x = x + self.a(a, p + "out_proj") @ self.w(p + "out_proj", i).T
            h = rms_norm(x, self.w(p + "norm2.alpha", i))
            gate, val = (self.a(h, p + "gating.linear_in")
                         @ self.w(p + "gating.linear_in", i).T).chunk(2, dim=-1)
            x = x + self.a(F.silu(gate) * val, p + "gating.linear_out") \
                @ self.w(p + "gating.linear_out", i).T
        hidden = rms_norm(x, self.w("out_norm.alpha"))
        return hidden, self.a(hidden, "text_linear.weight") @ self.w("text_linear.weight").T

    # -- depth transformer ------------------------------------------------

    @torch.no_grad()
    def depformer(self, hidden: torch.Tensor, gen: torch.Tensor) -> torch.Tensor:
        """Audio logits [B, T, dep_q, card] given the backbone's ``hidden``
        [B, T, dim] and each frame's generated tokens ``gen`` [B, dep_q+1, T]
        (text, then audio): codebook k is conditioned on tokens 0..k."""
        z = self.z
        S, dd, Hh = z["dep_q"], z["dep_dim"], z["dep_heads"]
        B, T, _ = hidden.shape
        x = torch.einsum("btd,kcd->btkc", self.a(hidden, "depformer_in"), self.w("depformer_in"))
        prev = [self.rows("depformer_text_emb", gen[:, 0].clamp(0, z["text_card"]))]
        for k in range(S - 1):
            prev.append(self.rows("depformer_emb", gen[:, k + 1].clamp(0, z["card"]), k))
        emb = torch.stack(prev, dim=2)  # [B, T, S, dd]
        keep = (gen[:, :S] != -1).permute(0, 2, 1)[..., None]
        x = (x + torch.where(keep, emb, 0.0)).reshape(B * T, S, dd)
        p = "depformer.layers."
        for i in range(z["dep_layers"]):
            h = rms_norm(x, self.w(p + "norm1.alpha", i))
            w_in = self.w(p + "in_proj", i).reshape(S, 3 * dd, dd)
            qkv = torch.einsum("nsc,soc->nso", self.a(h, p + "in_proj"), w_in)
            qkv = qkv.reshape(B * T, S, 3, Hh, dd // Hh).permute(2, 0, 3, 1, 4)
            a = attention(qkv[0], qkv[1], qkv[2], None).transpose(1, 2).reshape(B * T, S, dd)
            w_out = self.w(p + "out_proj", i).reshape(S, dd, dd)
            x = x + torch.einsum("nsc,soc->nso", self.a(a, p + "out_proj"), w_out)
            h = rms_norm(x, self.w(p + "norm2.alpha", i))
            gate, val = torch.einsum("nsc,soc->nso", self.a(h, p + "gating.linear_in"),
                                     self.w(p + "gating.linear_in", i)).chunk(2, dim=-1)
            x = x + torch.einsum("nsh,sch->nsc",
                                 self.a(F.silu(gate) * val, p + "gating.linear_out"),
                                 self.w(p + "gating.linear_out", i))
        logits = torch.einsum("nsc,svc->nsv", self.a(x, "linears.weight"),
                              self.w("linears.weight"))
        return logits.reshape(B, T, S, z["card"])
