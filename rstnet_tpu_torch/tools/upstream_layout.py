"""A model of this package written under the upstream checkpoint names: the
inverse of ``models/convert.py``.

``upstream_mimi``, ``upstream_moshi``, ``upstream_backbone`` and
``upstream_speech_lm`` give ``{upstream name: tensor}`` (views of the
module's parameters where the layout allows) in the naming of kyutai's Mimi
and Moshi checkpoints and of litgpt's ``lit_model.pth``; ``write_upstream``
writes such a dict to a ``.safetensors`` file (its own writer: the header
length, the JSON header padded to 8 bytes, then each tensor's bytes) or to
a torch ``.pth``/``.pt`` file. The tests build the upstream files both
converters read with it, and ``chip_smoke.py`` the full-width ones it serves
and trains from. Mimi's convs can be written in each of the three upstream
namings (``conv_naming``: ``plain`` ``weight``, ``weight_norm``
``weight_g``/``weight_v``, ``parametrizations``
``parametrizations.weight.original0/1``).
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import torch

from rstnet_tpu_torch.models.convert import SAFETENSORS_DTYPES, seanet_positions
from rstnet_tpu_torch.ops.conv import StreamingConvTranspose1d

CONV_NAMINGS = ("plain", "weight_norm", "parametrizations")
_DTYPE_NAMES = {v: k for k, v in SAFETENSORS_DTYPES.items()}


def _conv(out: dict, prefix: str, conv, naming: str) -> None:
    """One conv's weight (and bias) under ``prefix`` in ``naming``."""
    params = conv._parameters
    if naming == "plain":
        out[f"{prefix}.weight"] = conv.resolved_weight() if "weight_v" in params else conv.weight
    else:
        if "weight_v" in params:
            g, v = conv.weight_g, conv.weight_v
        else:
            v = conv.weight
            g = v.float().square().sum((1, 2), keepdim=True).sqrt().to(v.dtype)
        names = (("weight_g", "weight_v") if naming == "weight_norm" else
                 ("parametrizations.weight.original0", "parametrizations.weight.original1"))
        out[f"{prefix}.{names[0]}"], out[f"{prefix}.{names[1]}"] = g, v
    if params.get("bias") is not None:
        out[f"{prefix}.bias"] = conv.bias


def upstream_transformer(prefix: str, module) -> dict:
    layers, out = module.layers, {}
    S = module.weights_per_step
    for i in range(module.num_layers):
        b = f"{prefix}.layers.{i}"
        out[f"{b}.self_attn.in_proj_weight"] = layers.in_proj[i]
        out[f"{b}.self_attn.out_proj.weight"] = layers.out_proj[i]
        for n in ("norm1", "norm2"):
            norm = getattr(layers, n)
            if "alpha" in norm._parameters:
                out[f"{b}.{n}.alpha"] = norm.alpha[i].reshape(1, 1, -1)
            else:
                out[f"{b}.{n}.weight"], out[f"{b}.{n}.bias"] = norm.weight[i], norm.bias[i]
        if module.gating == "none":
            out[f"{b}.linear1.weight"] = layers.linear1[i]
            out[f"{b}.linear2.weight"] = layers.linear2[i]
        elif S:
            for s in range(S):
                out[f"{b}.gating.{s}.linear_in.weight"] = layers.gating.linear_in[i, s]
                out[f"{b}.gating.{s}.linear_out.weight"] = layers.gating.linear_out[i, s]
        else:
            out[f"{b}.gating.linear_in.weight"] = layers.gating.linear_in[i]
            out[f"{b}.gating.linear_out.weight"] = layers.gating.linear_out[i]
        if module.has_layer_scale:
            out[f"{b}.layer_scale_1.scale"] = layers.layer_scale_1.scale[i]
            out[f"{b}.layer_scale_2.scale"] = layers.layer_scale_2.scale[i]
    return out


def upstream_projected(prefix: str, module) -> dict:
    out = upstream_transformer(f"{prefix}.transformer", module.transformer)
    if "input_proj" in module._parameters:
        out[f"{prefix}.input_proj.weight"] = module.input_proj
    for i in range(len(module.output_dimensions)):
        if f"output_proj_{i}" in module._parameters:
            out[f"{prefix}.output_projs.{i}.weight"] = getattr(module, f"output_proj_{i}")
    return out


def upstream_seanet(prefix: str, module, naming: str = "plain") -> dict:
    out = {}
    for pos, layer in seanet_positions(module):
        if isinstance(layer, StreamingConvTranspose1d):
            _conv(out, f"{prefix}.model.{pos}.convtr.convtr", layer, naming)
        elif hasattr(layer, "block"):
            for j, conv in enumerate(layer.block):
                _conv(out, f"{prefix}.model.{pos}.block.{2 * j + 1}.conv.conv", conv, naming)
            if layer.shortcut is not None:
                _conv(out, f"{prefix}.model.{pos}.shortcut.conv.conv", layer.shortcut, naming)
        else:
            _conv(out, f"{prefix}.model.{pos}.conv.conv", layer, naming)
    return out


def upstream_rvq(prefix: str, module) -> dict:
    out = {}
    for name in ("input_proj", "output_proj"):
        if name in module._parameters:
            out[f"{prefix}.{name}.weight"] = getattr(module, name)[..., None]
    cb = module.layers
    for k in range(module.n_q):
        b = f"{prefix}.vq.layers.{k}._codebook"
        out[f"{b}.embedding_sum"] = cb.embedding_sum[k]
        out[f"{b}.cluster_usage"] = cb.cluster_usage[k]
        out[f"{b}._initialized"] = cb.initialized[k].reshape(1)
    return out


def upstream_mimi(model, conv_naming: str = "plain") -> dict:
    """A ``MimiModel`` under kyutai's Mimi names."""
    if conv_naming not in CONV_NAMINGS:
        raise ValueError(f"conv naming {conv_naming!r}, expected one of {CONV_NAMINGS}")
    out = {**upstream_seanet("encoder", model.encoder, conv_naming),
           **upstream_seanet("decoder", model.decoder, conv_naming),
           **upstream_projected("encoder_transformer", model.encoder_transformer),
           **upstream_projected("decoder_transformer", model.decoder_transformer),
           **upstream_rvq("quantizer.rvq_first", model.quantizer.rvq_first),
           **upstream_rvq("quantizer.rvq_rest", model.quantizer.rvq_rest)}
    if model.downsample is not None:
        _conv(out, "downsample.conv.conv.conv", model.downsample, conv_naming)
        _conv(out, "upsample.convtr.convtr.convtr", model.upsample, conv_naming)
    return out


def _linear(out: dict, prefix: str, module) -> None:
    out[f"{prefix}.weight"] = module.weight
    if module._parameters.get("bias") is not None:
        out[f"{prefix}.bias"] = module.bias


def _norm(out: dict, prefix: str, module) -> None:
    if "alpha" in module._parameters:
        out[f"{prefix}.alpha"] = module.alpha.reshape(1, 1, -1)
    else:
        _linear(out, prefix, module)


def upstream_backbone(backbone, prefix: str = "") -> dict:
    """A ``Backbone`` under litgpt's names (``lit_model.pth``)."""
    out = {f"{prefix}transformer.wte.weight": backbone.wte}
    for i, block in enumerate(backbone.blocks):
        b = f"{prefix}transformer.h.{i}"
        for name, module in block.named_children():
            if name == "mlp":
                for sub, lin in module.named_children():
                    _linear(out, f"{b}.mlp.{sub}", lin)
            elif name in ("attn", "proj"):
                _linear(out, f"{b}.attn.{name}", module)
            else:
                _linear(out, f"{b}.{name}", module)
    _linear(out, f"{prefix}transformer.ln_f", backbone.ln_f)
    _linear(out, f"{prefix}lm_head", backbone.lm_head)
    return out


def upstream_speech_lm(model) -> dict:
    """A ``SpeechTextLM`` under the flagship's names
    (``models/llama_streaming.py``)."""
    cfg = model.config
    out = {**upstream_backbone(model.backbone),
           **upstream_transformer("codecformer", model.codecformer),
           "codecformer_text_emb.weight": model.codecformer_text_emb}
    for k in range(cfg.n_q):
        out[f"input_emb.{k}.weight"] = model.input_emb[k]
    for k in range(cfg.dep_q - 1):
        out[f"codecformer_emb.{k}.weight"] = model.codecformer_emb[k]
    for k in range(model.codecformer_in.shape[0]):
        out[f"codecformer_in.{k}.weight"] = model.codecformer_in[k]
    bias = model.audio_linears._parameters.get("bias")
    for k in range(cfg.dep_q):
        out[f"audio_linears.{k}.weight"] = model.audio_linears.weight[k]
        if bias is not None:
            out[f"audio_linears.{k}.bias"] = bias[k]
    if cfg.codecformer_norm_emb:
        for w in ("weight", "bias"):
            for k in range(cfg.n_q):
                out[f"input_emb.{k}.norm.{w}"] = getattr(model.input_emb_norm, w)[k, 0]
            for k in range(cfg.dep_q - 1):
                out[f"codecformer_emb.{k}.norm.{w}"] = getattr(model.codecformer_emb_norm, w)[k]
            out[f"codecformer_text_emb.norm.{w}"] = getattr(model.codecformer_text_emb_norm, w)
    return out


def upstream_moshi(model) -> dict:
    """A ``MoshiLMModel`` under kyutai's Moshi names."""
    out = {"text_emb.weight": model.text_emb,
           "depformer_text_emb.weight": model.depformer_text_emb,
           **upstream_transformer("transformer", model.transformer),
           **upstream_transformer("depformer", model.depformer)}
    for k in range(model.n_q):
        out[f"emb.{k}.weight"] = model.emb[k]
    _linear(out, "text_linear", model.text_linear)
    _norm(out, "out_norm", model.out_norm)
    for k in range(model.depformer_in.shape[0]):
        out[f"depformer_in.{k}.weight"] = model.depformer_in[k]
    for k in range(model.dep_q - 1):
        out[f"depformer_emb.{k}.weight"] = model.depformer_emb[k]
    bias = model.linears._parameters.get("bias")
    for k in range(model.dep_q):
        out[f"linears.{k}.weight"] = model.linears.weight[k]
        if bias is not None:
            out[f"linears.{k}.bias"] = bias[k]
    return out


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    t = t.detach()
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def write_safetensors(path: str | Path, tensors: dict, dtype=None) -> int:
    """``tensors`` as a ``.safetensors`` file (float ones cast to ``dtype``
    when given), one tensor at a time, each cast and copied to the host as
    it is written; returns the bytes written."""
    header, offset = {}, 0
    for name, t in tensors.items():
        out_dtype = dtype if dtype is not None and t.is_floating_point() else t.dtype
        n = t.numel() * torch.empty((), dtype=out_dtype).element_size()
        header[name] = {"dtype": _DTYPE_NAMES[out_dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            host = _cast(t, dtype).contiguous().cpu()
            if host.numel():
                f.write(memoryview(host.reshape(-1).view(torch.uint8).numpy()))
    return 8 + len(raw) + offset


def write_upstream(path: str | Path, tensors: dict, dtype=None, wrap: bool = False) -> Path:
    """Write ``tensors`` (float ones cast to ``dtype`` when given) to
    ``path``: ``.safetensors``/``.sft``/``.sfts`` through
    :func:`write_safetensors`, else ``torch.save`` (under ``{"model": ...}``
    with ``wrap``)."""
    path = Path(path)
    if str(path).endswith((".safetensors", ".sft", ".sfts")):
        write_safetensors(path, tensors, dtype)
    else:
        sd = {k: _cast(v, dtype).contiguous().cpu().clone() for k, v in tensors.items()}
        torch.save({"model": sd} if wrap else sd, path)
    return path
