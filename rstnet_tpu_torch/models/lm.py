"""Token conventions and the scaled embedding shared by the LMs (the part of
``rstnet_tpu/models/lm.py`` that the Moshi serving path uses; ``SpeechTextLM``
itself is not ported yet)."""

from __future__ import annotations

import torch

ZERO_TOKEN_ID = -1
UNGENERATED_TOKEN_ID = -2


def _emb_layer_norm(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    yf = y.float()
    mu = yf.mean(-1, keepdim=True)
    var = yf.var(-1, keepdim=True, unbiased=False)
    out = (yf - mu) * torch.rsqrt(var + 1e-5) * w.float() + b.float()
    return out.to(y.dtype)


def scaled_embedding(table: torch.Tensor, tokens: torch.Tensor, zero_idx: int = ZERO_TOKEN_ID,
                     norm: dict | None = None) -> torch.Tensor:
    """Embedding where ``zero_idx`` tokens give exactly 0. Indices are
    clipped into the table, as the JAX gather does; ``norm`` ({weight,
    bias}, optional) is a post-embedding layer norm applied before the mask."""
    is_zero = tokens == zero_idx
    y = table[tokens.long().clamp(0, table.shape[0] - 1)]
    if norm is not None:
        y = _emb_layer_norm(y, norm["weight"], norm["bias"])
    return torch.where(is_zero[..., None], torch.zeros((), dtype=y.dtype, device=y.device), y)
