"""Checkpoint converters: public PyTorch state dicts -> this package's modules
(counterpart of ``rstnet_tpu/models/convert.py``).

Loads public checkpoints unchanged (kyutai Mimi/Moshi ``.safetensors``,
litgpt ``lit_model.pth``) by mapping the upstream module names
(``moshi/models/compression.py``, ``modules/transformer.py``,
``models/lit_model.py``) onto the JAX package's stacked parameter trees. Each
``convert_*`` builds the same ``{JAX path: tensor}`` tree as its JAX
counterpart, with torch tensors for numpy arrays; :func:`load_converted`
loads such a tree into a module of this package through the bridge
(``core.from_jax_params``).

:func:`load_torch_state_dict` reads ``.pt``/``.pth`` (unwrapping
``{"model": ...}``) and ``.safetensors``/``.sft``/``.sfts`` with its own
reader over a memory map, so a 15 GB file is never copied whole. Float
tensors come out widened to float32, as the JAX package's ``.pt`` branch
widens them, and one at a time, when the converter reads them. One
deliberate difference: the JAX package reads ``.safetensors`` through
``safetensors.numpy``, which raises on bf16 (kyutai's Moshi file) unless
``ml_dtypes`` is loaded, and then keeps it bf16; this reader takes F32, F16,
BF16 and the integer types and widens the floats as the ``.pt`` branch does.

The converters only rename, slice and stack: the tree's leaves hold the
file's values, float32 for float data. Callers cast where they want another
dtype (``load_converted(..., dtype=)``).
"""

from __future__ import annotations

import json
import mmap
import struct
from collections.abc import Mapping
from pathlib import Path

import torch
from torch import nn

from rstnet_tpu_torch.core import flatten_dict, from_jax_params, unstack_layers
from rstnet_tpu_torch.ops.conv import StreamingConvTranspose1d

SD = Mapping[str, torch.Tensor]
Tree = dict

SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def _widen(t):
    """Float tensors as float32 (the JAX ``.pt`` branch's ``.float()``)."""
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.float()
    return t


class StateDictFile(Mapping):
    """A checkpoint's ``{name: tensor}``: the raw tensors (views of a memory
    map, or of ``torch.load(mmap=True)``) widened at each read."""

    def __init__(self, raw: dict, keep_alive=None):
        self._raw, self._keep_alive = raw, keep_alive

    def __getitem__(self, name: str):
        return _widen(self._raw[name])

    def __iter__(self):
        return iter(self._raw)

    def __len__(self) -> int:
        return len(self._raw)

    def raw(self, name: str):
        """The tensor as the file holds it (no widening)."""
        return self._raw[name]


def read_safetensors(path: str | Path) -> StateDictFile:
    """A ``.safetensors`` file over a copy-on-write memory map: an 8-byte
    little-endian header length, the JSON header, then the data, each
    tensor a ``torch.frombuffer`` view (nothing is read until used)."""
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    (n,) = struct.unpack("<Q", mm[:8])
    header = json.loads(mm[8 : 8 + n])
    start = 8 + n
    raw = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in SAFETENSORS_DTYPES:
            raise TypeError(f"{path}: {name} has dtype {info['dtype']}, which this reader "
                            f"does not take ({sorted(SAFETENSORS_DTYPES)})")
        dtype = SAFETENSORS_DTYPES[info["dtype"]]
        b, e = info["data_offsets"]
        shape = tuple(info["shape"])
        if e == b:
            raw[name] = torch.empty(shape, dtype=dtype)
            continue
        count = (e - b) // torch.empty((), dtype=dtype).element_size()
        raw[name] = torch.frombuffer(mm, dtype=dtype, count=count,
                                     offset=start + b).reshape(shape)
    return StateDictFile(raw, keep_alive=mm)


def load_torch_state_dict(path: str | Path) -> StateDictFile:
    """A checkpoint file (``.safetensors``/``.sft``/``.sfts``, or torch
    ``.pt``/``.pth``) as ``{name: tensor}``, float tensors widened to
    float32 as they are read."""
    if str(path).endswith((".safetensors", ".sft", ".sfts")):
        return read_safetensors(path)
    pkg = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    if isinstance(pkg, dict) and "model" in pkg and isinstance(pkg["model"], dict):
        pkg = pkg["model"]
    return StateDictFile(dict(pkg))


def _stack(ts) -> torch.Tensor:
    return torch.stack(list(ts))


def _stack_trees(trees: list):
    """Leaves of equal-structured trees stacked along a new first axis (the
    JAX ``jax.tree.map(lambda *xs: jnp.stack(xs), *trees)``, whose dicts come
    out with their keys sorted)."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in sorted(trees[0])}
    return _stack(trees)


def _conv_params(sd: SD, prefix: str, has_bias: bool) -> Tree:
    """Conv params at ``prefix`` (e.g. ``...conv.conv``), resolving plain,
    weight_norm (weight_g/weight_v) and parametrize-style names."""
    p: Tree = {}
    if f"{prefix}.weight" in sd:
        p["weight"] = sd[f"{prefix}.weight"]
    elif f"{prefix}.weight_g" in sd:
        p["weight_g"] = sd[f"{prefix}.weight_g"]
        p["weight_v"] = sd[f"{prefix}.weight_v"]
    elif f"{prefix}.parametrizations.weight.original0" in sd:
        p["weight_g"] = sd[f"{prefix}.parametrizations.weight.original0"]
        p["weight_v"] = sd[f"{prefix}.parametrizations.weight.original1"]
    else:
        raise KeyError(f"no conv weight found under {prefix}")
    if has_bias and f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def convert_streaming_transformer(sd: SD, prefix: str, module) -> Tree:
    """Stack the upstream per-layer weights into [L, ...] params."""
    L = module.num_layers

    def stack(fmt: str) -> torch.Tensor:
        return _stack(sd[fmt.format(i=i)] for i in range(L))

    layers: Tree = {
        "in_proj": stack(f"{prefix}.layers.{{i}}.self_attn.in_proj_weight"),
        "out_proj": stack(f"{prefix}.layers.{{i}}.self_attn.out_proj.weight"),
    }
    for n in ("norm1", "norm2"):
        if f"{prefix}.layers.0.{n}.alpha" in sd:
            layers[n] = {"alpha": _stack(sd[f"{prefix}.layers.{i}.{n}.alpha"].reshape(-1)
                                         for i in range(L))}
        else:
            layers[n] = {
                "weight": stack(f"{prefix}.layers.{{i}}.{n}.weight"),
                "bias": stack(f"{prefix}.layers.{{i}}.{n}.bias"),
            }
    if module.gating == "none":
        layers["linear1"] = stack(f"{prefix}.layers.{{i}}.linear1.weight")
        layers["linear2"] = stack(f"{prefix}.layers.{{i}}.linear2.weight")
    elif module.weights_per_step:
        S = module.weights_per_step

        def per_step(name: str) -> torch.Tensor:
            return _stack(_stack(sd[f"{prefix}.layers.{i}.gating.{s}.{name}.weight"]
                                 for s in range(S)) for i in range(L))

        layers["gating"] = {"linear_in": per_step("linear_in"),
                            "linear_out": per_step("linear_out")}
    else:
        layers["gating"] = {
            "linear_in": stack(f"{prefix}.layers.{{i}}.gating.linear_in.weight"),
            "linear_out": stack(f"{prefix}.layers.{{i}}.gating.linear_out.weight"),
        }
    if module.has_layer_scale:
        layers["layer_scale_1"] = {"scale": stack(f"{prefix}.layers.{{i}}.layer_scale_1.scale")}
        layers["layer_scale_2"] = {"scale": stack(f"{prefix}.layers.{{i}}.layer_scale_2.scale")}
    return {"layers": layers}


def convert_projected_transformer(sd: SD, prefix: str, module) -> Tree:
    p = {"transformer": convert_streaming_transformer(sd, f"{prefix}.transformer",
                                                      module.transformer)}
    if f"{prefix}.input_proj.weight" in sd:
        p["input_proj"] = sd[f"{prefix}.input_proj.weight"]
    for i in range(len(module.output_dimensions)):
        name = f"{prefix}.output_projs.{i}.weight"
        if name in sd:
            p[f"output_proj_{i}"] = sd[name]
    return p


def seanet_positions(module):
    """(upstream ``model`` index, layer) for each parameterized layer of a
    SEANet stack: the upstream Sequential counts the activations too."""
    layers = iter(module.layers)
    return [(pos, next(layers)) for pos, entry in enumerate(module.plan) if entry != "act"]


def convert_seanet(sd: SD, prefix: str, module) -> Tree:
    """Map the upstream flat Sequential (activations included in indices)
    onto the parameterized-layer list."""
    layers = []
    for pos, layer in seanet_positions(module):
        if isinstance(layer, StreamingConvTranspose1d):
            layers.append(_conv_params(sd, f"{prefix}.model.{pos}.convtr.convtr",
                                       layer.bias is not None))
        elif hasattr(layer, "block"):  # resnet block = Sequential(act, conv, act, conv, ...)
            bp: Tree = {"block": [
                _conv_params(sd, f"{prefix}.model.{pos}.block.{2 * j + 1}.conv.conv", True)
                for j in range(len(layer.block))]}
            if layer.shortcut is not None:
                bp["shortcut"] = _conv_params(sd, f"{prefix}.model.{pos}.shortcut.conv.conv",
                                              True)
            layers.append(bp)
        else:
            layers.append(_conv_params(sd, f"{prefix}.model.{pos}.conv.conv",
                                       layer.bias is not None))
    return {"layers": layers}


def convert_rvq(sd: SD, prefix: str, module) -> Tree:
    p: Tree = {}
    if "input_proj" in module._parameters:
        p["input_proj"] = sd[f"{prefix}.input_proj.weight"][..., 0]
    if "output_proj" in module._parameters:
        p["output_proj"] = sd[f"{prefix}.output_proj.weight"][..., 0]

    def stack(name: str) -> torch.Tensor:
        return _stack(sd[f"{prefix}.vq.layers.{k}._codebook.{name}"]
                      for k in range(module.n_q))

    init_name = ("_initialized" if f"{prefix}.vq.layers.0._codebook._initialized" in sd
                 else "inited")
    p["layers"] = {
        "embedding_sum": stack("embedding_sum"),
        "cluster_usage": stack("cluster_usage"),
        "initialized": stack(init_name).reshape(module.n_q).float(),
    }
    return p


def convert_split_rvq(sd: SD, prefix: str, module) -> Tree:
    return {
        "rvq_first": convert_rvq(sd, f"{prefix}.rvq_first", module.rvq_first),
        "rvq_rest": convert_rvq(sd, f"{prefix}.rvq_rest", module.rvq_rest),
    }


def convert_mimi(sd: SD, model) -> Tree:
    """A whole Mimi checkpoint (e.g. kyutai's tokenizer safetensors) -> params."""
    p: Tree = {
        "encoder": convert_seanet(sd, "encoder", model.encoder),
        "decoder": convert_seanet(sd, "decoder", model.decoder),
        "encoder_transformer": convert_projected_transformer(
            sd, "encoder_transformer", model.encoder_transformer),
        "decoder_transformer": convert_projected_transformer(
            sd, "decoder_transformer", model.decoder_transformer),
        "quantizer": convert_split_rvq(sd, "quantizer", model.quantizer),
    }
    if model.downsample is not None:
        p["downsample"] = _conv_params(sd, "downsample.conv.conv.conv", False)
        p["upsample"] = _conv_params(sd, "upsample.convtr.convtr.convtr", False)
    return p


def _lin(sd: SD, prefix: str, want_bias: bool = True) -> Tree:
    """Linear at ``prefix``; resolves both plain ``X.weight`` and the
    upstream LoRALinear nesting ``X.linear.weight``."""
    for cand in (prefix, f"{prefix}.linear"):
        if f"{cand}.weight" in sd:
            p: Tree = {"weight": sd[f"{cand}.weight"]}
            if want_bias and f"{cand}.bias" in sd:
                p["bias"] = sd[f"{cand}.bias"]
            return p
    raise KeyError(f"no linear weight under {prefix}")


def _norm_sd(sd: SD, prefix: str) -> Tree:
    p: Tree = {"weight": sd[f"{prefix}.weight"]}
    if f"{prefix}.bias" in sd:
        p["bias"] = sd[f"{prefix}.bias"]
    return p


def convert_backbone(sd: SD, cfg, prefix: str = "") -> Tree:
    """litgpt-layout checkpoint (``models/lit_model.py`` naming, also the
    flagship's LoRA-nested variant) -> Backbone params, blocks stacked."""

    def block(i: int) -> Tree:
        b = f"{prefix}transformer.h.{i}"
        p: Tree = {
            "norm_1": _norm_sd(sd, f"{b}.norm_1"),
            "attn": _lin(sd, f"{b}.attn.attn"),
            "proj": _lin(sd, f"{b}.attn.proj"),
        }
        if not cfg.shared_attention_norm:
            p["norm_2"] = _norm_sd(sd, f"{b}.norm_2")
        if cfg.post_attention_norm:
            p["post_attention_norm"] = _norm_sd(sd, f"{b}.post_attention_norm")
        if cfg.post_mlp_norm:
            p["post_mlp_norm"] = _norm_sd(sd, f"{b}.post_mlp_norm")
        if cfg.mlp_class_name == "GptNeoxMLP":
            p["mlp"] = {"fc": _lin(sd, f"{b}.mlp.fc"), "proj": _lin(sd, f"{b}.mlp.proj")}
        elif cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP"):
            p["mlp"] = {name: _lin(sd, f"{b}.mlp.{name}") for name in ("fc_1", "fc_2", "proj")}
        else:  # LLaMAMoE
            p["mlp"] = {
                "gate": _lin(sd, f"{b}.mlp.gate"),
                "experts": _stack_trees([
                    {name: _lin(sd, f"{b}.mlp.experts.{e}.{name}")
                     for name in ("fc_1", "fc_2", "proj")}
                    for e in range(cfg.n_expert)]),
            }
        return p

    return {
        "wte": sd[f"{prefix}transformer.wte.weight"],
        "blocks": _stack_trees([block(i) for i in range(cfg.n_layer)]),
        "ln_f": _norm_sd(sd, f"{prefix}transformer.ln_f"),
        "lm_head": _lin(sd, f"{prefix}lm_head"),
    }


def convert_speech_lm(sd: SD, model) -> Tree:
    """Flagship GPT checkpoint (``models/llama_streaming.py`` naming) ->
    SpeechTextLM params."""
    cfg = model.config
    n_in = cfg.dep_q if cfg.codecformer_multi_linear else 1
    p: Tree = {
        "backbone": convert_backbone(sd, cfg),
        "codecformer": convert_streaming_transformer(sd, "codecformer", model.codecformer),
        "input_emb": _stack(sd[f"input_emb.{k}.weight"] for k in range(cfg.n_q)),
        "codecformer_text_emb": sd["codecformer_text_emb.weight"],
        "codecformer_emb": _stack(sd[f"codecformer_emb.{k}.weight"]
                                  for k in range(cfg.dep_q - 1)),
        "codecformer_in": _stack(_lin(sd, f"codecformer_in.{k}", False)["weight"]
                                 for k in range(n_in)),
        "audio_linears": {"weight": _stack(_lin(sd, f"audio_linears.{k}", False)["weight"]
                                           for k in range(cfg.dep_q))},
    }
    if cfg.codecformer_bias_proj:
        p["audio_linears"]["bias"] = _stack(sd[f"audio_linears.{k}.bias"]
                                            for k in range(cfg.dep_q))
    if cfg.codecformer_norm_emb:
        # post-embedding layer norms (ScaledEmbedding(norm=True))
        def norms(prefix: str, n: int, what: str) -> torch.Tensor:
            return _stack(sd[f"{prefix}.{k}.norm.{what}"] for k in range(n))

        p["input_emb_norm"] = {w: norms("input_emb", cfg.n_q, w)[:, None, :]
                               for w in ("weight", "bias")}
        p["codecformer_emb_norm"] = {w: norms("codecformer_emb", cfg.dep_q - 1, w)
                                     for w in ("weight", "bias")}
        p["codecformer_text_emb_norm"] = {w: sd[f"codecformer_text_emb.norm.{w}"]
                                          for w in ("weight", "bias")}
    return p


def _norm_params(sd: SD, prefix: str) -> Tree:
    if f"{prefix}.alpha" in sd:
        return {"alpha": sd[f"{prefix}.alpha"].reshape(-1)}
    return _norm_sd(sd, prefix)


def convert_moshi_lm(sd: SD, model) -> Tree:
    """Moshi checkpoint (kyutai ``model.safetensors`` naming,
    ``moshi/models/lm.py``) -> MoshiLMModel params."""
    n_in = model.dep_q if model.depformer_multi_linear else 1
    p: Tree = {
        "emb": _stack(sd[f"emb.{k}.weight"] for k in range(model.n_q)),
        "text_emb": sd["text_emb.weight"],
        "text_linear": _lin(sd, "text_linear"),
        "transformer": convert_streaming_transformer(sd, "transformer", model.transformer),
        "out_norm": _norm_params(sd, "out_norm"),
        "depformer_in": _stack(_lin(sd, f"depformer_in.{k}", False)["weight"]
                               for k in range(n_in)),
        "depformer_emb": _stack(sd[f"depformer_emb.{k}.weight"]
                                for k in range(model.dep_q - 1)),
        "depformer_text_emb": sd["depformer_text_emb.weight"],
        "depformer": convert_streaming_transformer(sd, "depformer", model.depformer),
        "linears": {"weight": _stack(_lin(sd, f"linears.{k}", False)["weight"]
                                     for k in range(model.dep_q))},
    }
    if "linears.0.bias" in sd:
        p["linears"]["bias"] = _stack(sd[f"linears.{k}.bias"] for k in range(model.dep_q))
    return p


def _adopt_layout(flat: dict, module: nn.Module) -> None:
    """Give ``module`` the optional parameters the converted tree holds and
    the module was built without: a bias (``linears.bias``,
    ``text_linear.bias``) or a conv's weight-norm pair (``weight_g``/
    ``weight_v`` in place of ``weight``), as the JAX modules read either."""
    own = module.state_dict()
    for name in sorted(set(flat) - set(own)):
        parent_name, _, leaf = name.rpartition(".")
        if leaf not in ("bias", "weight_g", "weight_v"):
            continue
        parent = module.get_submodule(parent_name)
        device = next(iter(parent.parameters())).device
        if leaf != "bias" and "weight" in parent._parameters:
            del parent._parameters["weight"]
        src = flat[name]
        parent.register_parameter(leaf, nn.Parameter(
            torch.empty(tuple(src.shape), dtype=src.dtype, device=device),
            requires_grad=False))


def load_converted(tree: Tree, module: nn.Module, stacked=(), dtype=None) -> nn.Module:
    """Load a converted tree into ``module`` in place: float leaves cast to
    ``dtype`` when given (else kept, float32 from the converter), the
    module given the optional parameters the tree holds (:func:`_adopt_layout`),
    ``stacked`` prefixes split per layer (``core.from_jax_params``)."""
    flat = {}
    for name, t in flatten_dict(tree):
        flat[name] = t.to(dtype) if dtype is not None and t.is_floating_point() else t
    flat = unstack_layers(flat, stacked)
    _adopt_layout(flat, module)
    return from_jax_params(flat, module)


def load_mimi(path: str | Path, model) -> nn.Module:
    """A Mimi checkpoint file loaded into ``model`` in place."""
    return load_converted(convert_mimi(load_torch_state_dict(path), model), model)


def load_moshi_lm(path: str | Path, model) -> nn.Module:
    """A Moshi checkpoint file loaded into ``model`` in place."""
    return load_converted(convert_moshi_lm(load_torch_state_dict(path), model), model)


def load_backbone(path: str | Path, backbone, dtype=None) -> nn.Module:
    """A litgpt checkpoint file loaded into ``backbone`` in place, cast to
    ``dtype`` when given."""
    from rstnet_tpu_torch.models.backbone import STACKED

    tree = convert_backbone(load_torch_state_dict(path), backbone.config)
    return load_converted(tree, backbone, stacked=STACKED, dtype=dtype)
