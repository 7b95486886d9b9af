"""Backbone configuration registry (counterpart of
``rstnet_tpu/models/config.py``, copied: the port imports nothing of the JAX
package).

One frozen dataclass describes any decoder-only LLM family of the registry
(Llama, Qwen, Gemma, Mistral, Phi, StableLM, TinyLlama) plus the speech-text
fields (LoRA, codecformer), loadable by name or from a ``model_config.yaml``.
The YAML files of this repository are flat ``key: value`` maps; the port
reads them with :func:`read_flat_yaml`, so it needs no YAML package.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional


def _yaml_scalar(text: str):
    text = text.strip()
    if text in ("", "~", "null", "Null", "NULL"):
        return None
    if text in ("true", "True", "TRUE"):
        return True
    if text in ("false", "False", "FALSE"):
        return False
    try:
        return json.loads(text)  # numbers, [flow lists], "quoted strings"
    except ValueError:
        if len(text) >= 2 and text[0] == text[-1] == "'":
            return text[1:-1]
        return text


def read_flat_yaml(path: str | Path) -> dict[str, Any]:
    """A flat YAML mapping (``key: scalar`` or ``key: [a, b]`` lines, ``#``
    comments) as a dict; anything nested raises."""
    out: dict[str, Any] = {}
    for n, line in enumerate(Path(path).read_text(encoding="utf-8").splitlines(), 1):
        stripped = line.split(" #")[0].rstrip() if not line.lstrip().startswith("#") else ""
        if not stripped.strip():
            continue
        if line[0] in " \t-" or ":" not in stripped:
            raise ValueError(f"{path}:{n}: only flat `key: value` lines are read: {line!r}")
        key, value = stripped.split(":", 1)
        if not value.strip():
            raise ValueError(f"{path}:{n}: nested value for {key!r}")
        out[key.strip()] = _yaml_scalar(value)
    return out


def write_flat_yaml(path: str | Path, d: dict[str, Any]) -> None:
    """Write a flat mapping as ``key: <JSON value>`` lines (valid YAML)."""
    lines = [f"{k}: {json.dumps(list(v) if isinstance(v, tuple) else v)}" for k, v in d.items()]
    Path(path).write_text("\n".join(lines) + "\n", encoding="utf-8")


def find_multiple(n: int, k: int) -> int:
    if n % k == 0:
        return n
    return n + k - (n % k)


@dataclasses.dataclass(frozen=True)
class Config:
    name: str = ""
    hf_name: str = ""
    # general size
    block_size: int = 4096
    n_layer: int = 16
    n_embd: int = 4096
    vocab_size: int = 50254
    padding_multiple: int = 512
    padded_vocab_size: Optional[int] = None
    # block structure / norms
    norm_class_name: str = "LayerNorm"  # {"LayerNorm", "RMSNorm"}
    norm_eps: float = 1e-5
    post_attention_norm: bool = False
    post_mlp_norm: bool = False
    parallel_residual: bool = True
    shared_attention_norm: bool = False
    # attention
    n_head: int = 32
    head_size: Optional[int] = None
    n_query_groups: Optional[int] = None
    attn_bias: bool = False
    attention_scores_scalar: Optional[int] = None
    sliding_window_size: Optional[int] = None
    sliding_window_layer_placing: Optional[str] = None  # {"all", "interleaved"}
    attention_logit_softcapping: Optional[float] = None
    # rope
    rope_base: int = 10000
    rotary_percentage: float = 0.25
    rope_condense_ratio: int = 1
    # (factor, low_freq_factor, high_freq_factor, original_max_seq_len)
    rope_adjustments: Optional[tuple[float, float, float, int]] = None
    # MLP
    intermediate_size: Optional[int] = None
    bias: bool = True
    mlp_class_name: str = "GptNeoxMLP"  # {GptNeoxMLP, LLaMAMLP, GemmaMLP, LLaMAMoE}
    gelu_approximate: str = "none"
    n_expert: int = 0
    n_expert_per_token: int = 0
    # before/after blocks
    scale_embeddings: bool = False
    lm_head_bias: bool = False
    final_logit_softcapping: Optional[float] = None
    # attention context window (framework extension: ring-KV streaming bound;
    # the reference flagship uses 3000 frames, llama_streaming.py:485)
    context: Optional[int] = 3000
    # route training forwards through the flash-attention kernel K6 when the
    # shape qualifies (no softcap, T % 512 == 0); the trainer sets it only
    # on a CUDA device (ops/flash_attention.py)
    use_flash_attention: bool = False
    # rematerialize block activations in training forwards
    # (torch.utils.checkpoint per block); trades FLOPs for device memory
    remat: bool = False
    # what remat keeps in the JAX package: "dots" or "nothing". The port's
    # checkpoint keeps only the block inputs under either name (the values
    # are the same; only what is saved differs)
    remat_policy: str = "dots"
    # remat the codecformer per layer too
    codecformer_remat: bool = True
    # shard long-sequence training activations over the mesh's `seq` axis;
    # windowed attention then exchanges only boundary KV blocks via ppermute
    # (ops/context_parallel.py). No-op when the mesh has no seq axis.
    sequence_parallel: bool = False
    # pipeline the backbone's layer scan over the mesh's `pipe` axis
    # (parallel/pipeline.py): each stage holds n_layer/P layers, microbatches
    # flow via ppermute. No-op when the mesh has no pipe axis.
    pipeline_parallel: bool = False
    # microbatch count for the pipeline schedule (0 = one per stage)
    pipeline_microbatches: int = 0

    # ---- LoRA (flagship fine-tuning, llama_streaming.py:457-467) ----------
    lora_r: int = 0
    lora_alpha: int = 1
    lora_dropout: float = 0.0
    lora_query: bool = False
    lora_key: bool = False
    lora_value: bool = False
    lora_projection: bool = False
    lora_mlp: bool = False
    lora_head: bool = False

    # ---- codecformer / speech-text (llama_streaming.py:468-485) -----------
    audio_card: int = 2048
    codecformer_dim: int = 1024
    n_q: int = 8
    dep_q: int = 8
    codecformer_heads: int = 16
    codecformer_layers: int = 6
    codecformer_dim_feedforward: int = 1024
    codecformer_norm: str = "rms_norm_f32"
    codecformer_bias_proj: bool = False
    codecformer_norm_emb: bool = False
    codecformer_multi_linear: bool = True
    codecformer_weights_per_step: bool = True
    causal: bool = True

    def __post_init__(self):
        if self.head_size is None:
            assert self.n_embd % self.n_head == 0
            object.__setattr__(self, "head_size", self.n_embd // self.n_head)
        if self.padded_vocab_size is None:
            object.__setattr__(
                self, "padded_vocab_size", find_multiple(self.vocab_size, self.padding_multiple)
            )
        else:
            object.__setattr__(self, "vocab_size", min(self.vocab_size, self.padded_vocab_size))
        if self.n_query_groups is not None:
            assert self.n_head % self.n_query_groups == 0
        else:
            object.__setattr__(self, "n_query_groups", self.n_head)
        if self.intermediate_size is None:
            if self.mlp_class_name == "LLaMAMLP":
                raise ValueError(f"config {self.name!r} needs intermediate_size")
            object.__setattr__(self, "intermediate_size", 4 * self.n_embd)

    @property
    def rope_n_elem(self) -> int:
        return int(self.rotary_percentage * self.head_size)

    @property
    def sliding_window_layer_stride(self) -> int:
        if self.sliding_window_layer_placing in (None, "all"):
            return 1
        return 2

    @classmethod
    def from_name(cls, name: str, **kwargs: Any) -> "Config":
        if name in name_to_config:
            d = dict(name_to_config[name])
        else:
            matches = [c for c in configs if c.get("hf_name") == name]
            if not matches:
                raise ValueError(f"{name!r} is not a supported config name")
            d = dict(matches[0])
        d.update(kwargs)
        if isinstance(d.get("rope_adjustments"), (list, dict)):
            d["rope_adjustments"] = _norm_rope_adjustments(d["rope_adjustments"])
        return cls(**d)

    @classmethod
    def from_file(cls, path: str | Path, **kwargs: Any) -> "Config":
        d = read_flat_yaml(path)
        if not d:
            raise ValueError(f"{path} is empty")
        d.pop("hf_config", None)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        d.update(kwargs)
        if isinstance(d.get("rope_adjustments"), (list, dict)):
            d["rope_adjustments"] = _norm_rope_adjustments(d["rope_adjustments"])
        return cls(**d)


def _norm_rope_adjustments(adj) -> tuple[float, float, float, int]:
    if isinstance(adj, dict):
        return (
            float(adj["factor"]),
            float(adj["low_freq_factor"]),
            float(adj["high_freq_factor"]),
            int(adj["original_max_seq_len"]),
        )
    return tuple(adj)  # type: ignore[return-value]


def rope_extra_config(cfg: Config) -> Optional[dict]:
    if cfg.rope_adjustments is None:
        return None
    f, lo, hi, orig = cfg.rope_adjustments
    return {
        "factor": f,
        "low_freq_factor": lo,
        "high_freq_factor": hi,
        "original_max_seq_len": orig,
    }


# ---------------------------------------------------------------------------
# Built-in registry: the families the reference advertises
# (``MLLM_v2/readme.md:47``: LLAMA, Gemma, Mistral, Phi, StableLM, Qwen).
# ---------------------------------------------------------------------------

_LLAMA31_ADJ = (8.0, 1.0, 4.0, 8192)

configs: list[dict] = [
    dict(
        name="tiny-llama-1.1b", hf_name="TinyLlama/TinyLlama-1.1B-Chat-v1.0",
        block_size=2048, vocab_size=32000, padding_multiple=64, n_layer=22,
        n_head=32, n_embd=2048, n_query_groups=4, rotary_percentage=1.0,
        parallel_residual=False, bias=False, norm_class_name="RMSNorm",
        mlp_class_name="LLaMAMLP", intermediate_size=5632,
    ),
    dict(
        name="Llama-3.2-1B", hf_name="meta-llama/Llama-3.2-1B",
        block_size=131072, vocab_size=128000, padded_vocab_size=128256,
        n_layer=16, n_embd=2048, n_head=32, n_query_groups=8,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP",
        intermediate_size=8192, rope_base=500000, rope_adjustments=_LLAMA31_ADJ,
    ),
    dict(
        name="Llama-3.2-3B", hf_name="meta-llama/Llama-3.2-3B",
        block_size=131072, vocab_size=128000, padded_vocab_size=128256,
        n_layer=28, n_embd=3072, n_head=24, n_query_groups=8,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP",
        intermediate_size=8192, rope_base=500000, rope_adjustments=_LLAMA31_ADJ,
    ),
    dict(
        name="Llama-3.1-8B", hf_name="meta-llama/Meta-Llama-3.1-8B",
        block_size=131072, vocab_size=128000, padded_vocab_size=128256,
        n_layer=32, n_embd=4096, n_head=32, n_query_groups=8,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP",
        intermediate_size=14336, rope_base=500000, rope_adjustments=_LLAMA31_ADJ,
    ),
    dict(
        name="Qwen2.5-0.5B", hf_name="Qwen/Qwen2.5-0.5B",
        block_size=32768, vocab_size=151643, padded_vocab_size=151936,
        n_layer=24, n_head=14, n_embd=896, n_query_groups=2,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        attn_bias=True, norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP",
        intermediate_size=4864, norm_eps=1e-6, rope_base=1000000,
    ),
    dict(
        name="Qwen2.5-7B", hf_name="Qwen/Qwen2.5-7B",
        block_size=131072, vocab_size=151643, padded_vocab_size=152064,
        n_layer=28, n_head=28, n_embd=3584, n_query_groups=4,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        attn_bias=True, norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP",
        intermediate_size=18944, norm_eps=1e-6, rope_base=1000000,
    ),
    dict(
        name="Gemma-2-2b", hf_name="google/gemma-2-2b",
        block_size=8192, vocab_size=256000, padding_multiple=64,
        n_layer=26, n_head=8, n_embd=2304, n_query_groups=4, head_size=256,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        norm_class_name="RMSNorm", mlp_class_name="GemmaMLP",
        gelu_approximate="tanh", intermediate_size=9216,
        post_attention_norm=True, post_mlp_norm=True, norm_eps=1e-6,
        scale_embeddings=True, attention_scores_scalar=256,
        sliding_window_size=4096, sliding_window_layer_placing="interleaved",
        final_logit_softcapping=30.0, attention_logit_softcapping=50.0,
    ),
    dict(
        name="Phi-3-mini-4k-instruct", hf_name="microsoft/Phi-3-mini-4k-instruct",
        block_size=4096, vocab_size=32000, padded_vocab_size=32064,
        n_layer=32, n_head=32, n_embd=3072, rotary_percentage=1.0,
        parallel_residual=False, bias=False, norm_class_name="RMSNorm",
        mlp_class_name="LLaMAMLP", intermediate_size=8192,
    ),
    dict(
        name="Mistral-7B-v0.3", hf_name="mistralai/Mistral-7B-v0.3",
        block_size=32768, vocab_size=32768, padding_multiple=512,
        n_layer=32, n_head=32, n_embd=4096, n_query_groups=8,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP",
        intermediate_size=14336, rope_base=1000000,
    ),
    dict(
        name="stablelm-zephyr-3b", hf_name="stabilityai/stablelm-zephyr-3b",
        block_size=4096, vocab_size=50254, padded_vocab_size=50304,
        n_layer=32, n_head=32, n_embd=2560, parallel_residual=False,
        bias=False, mlp_class_name="LLaMAMLP", intermediate_size=6912,
    ),
    dict(
        name="Mixtral-8x7B-v0.1", hf_name="mistralai/Mixtral-8x7B-v0.1",
        block_size=32768, vocab_size=32000, padding_multiple=512,
        n_layer=32, n_head=32, n_embd=4096, n_query_groups=8,
        rotary_percentage=1.0, parallel_residual=False, bias=False,
        norm_class_name="RMSNorm", mlp_class_name="LLaMAMoE",
        intermediate_size=14336, rope_base=1000000, n_expert=8,
        n_expert_per_token=2,
    ),
]

name_to_config: dict[str, dict] = {c["name"]: c for c in configs}
