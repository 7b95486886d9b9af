"""The port's backbone (``rstnet_tpu_torch/models/backbone.py``) against the
JAX ``Backbone`` on the CPU: the same params (JAX's stacked ``blocks`` split
per layer by the bridge), the same seeded tokens.

float32 logits are held to 2e-5 (the same float32 math in another summation
order; observed ~1e-6 on logits of ~3). bf16 weights and activations round
at other places in XLA:CPU and ATen, so they are held to 2e-2 of the logit
scale. The flash route on the CPU (the kernels' plain versions) against the
JAX masked path: 1e-4 (q is scaled before the product there, after it
here)."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu.models.backbone import Backbone as JaxBackbone
from rstnet_tpu.models.config import Config as JaxConfig
from rstnet_tpu.ops.rope import build_rope_cache as jax_rope_cache
from rstnet_tpu_torch.core import from_jax_params, to_numpy
from rstnet_tpu_torch.models.backbone import STACKED, Backbone
from rstnet_tpu_torch.models.config import Config
from rstnet_tpu_torch.ops.rope import build_rope_cache

TINY = dict(
    name="test-tiny", block_size=128, vocab_size=96, padded_vocab_size=96,
    n_layer=2, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64, context=None,
)
VARIANTS = {
    "llama31-gqa": dict(rope_base=500000, rope_adjustments=(8.0, 1.0, 4.0, 32), context=7),
    "gemma-like": dict(name="gemma-tiny", mlp_class_name="GemmaMLP", gelu_approximate="tanh",
                       post_attention_norm=True, post_mlp_norm=True, scale_embeddings=True,
                       head_size=16, attention_scores_scalar=16, sliding_window_size=5,
                       sliding_window_layer_placing="interleaved",
                       attention_logit_softcapping=50.0, final_logit_softcapping=30.0),
    "gptneox": dict(norm_class_name="LayerNorm", mlp_class_name="GptNeoxMLP",
                    intermediate_size=None, bias=True, parallel_residual=True,
                    rotary_percentage=0.5),
    "mqa": dict(n_query_groups=1),
}


def _pair(dtype=jnp.float32, **over):
    d = dict(TINY, **over)
    jb = JaxBackbone(JaxConfig(**d))
    params = jb.init(jax.random.PRNGKey(0), dtype)
    tb = Backbone(Config(**d), dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, tb, stacked=STACKED)
    return jb, params, tb


def _tokens(seed, B, T, vocab=96):
    return np.random.default_rng(seed).integers(0, vocab, (B, T))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_jax(variant):
    jb, params, tb = _pair(**VARIANTS[variant])
    tokens = _tokens(0, 2, 12)
    want = np.asarray(jb.forward_tokens(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tb.forward_tokens(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_forward_shapes():
    tb = Backbone(Config(**TINY), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        logits = tb.forward_tokens(torch.from_numpy(_tokens(1, 2, 10)))
    assert logits.shape == (2, 10, 96)


def test_llama31_rope_adjustments():
    adj = {"factor": 8.0, "low_freq_factor": 1.0, "high_freq_factor": 4.0,
           "original_max_seq_len": 32}
    pos = np.arange(16, dtype=np.float32)
    cos_j, sin_j = jax_rope_cache(0, 8, 10000, 1, adj, jnp.asarray(pos))
    cos_t, sin_t = build_rope_cache(0, 8, 10000, 1, adj, torch.from_numpy(pos))
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), atol=1e-6)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), atol=1e-6)
    jb, params, tb = _pair(rope_adjustments=(8.0, 1.0, 4.0, 32))
    tokens = _tokens(2, 1, 16)
    want = np.asarray(jb.forward_tokens(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tb.forward_tokens(torch.from_numpy(tokens)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_bf16_logits_close_to_jax():
    jb, params, tb = _pair(jnp.bfloat16, **VARIANTS["llama31-gqa"])
    tokens = _tokens(3, 2, 12)
    want = np.asarray(jb.forward_tokens(params, jnp.asarray(tokens)), np.float32)
    with torch.no_grad():
        got = tb.forward_tokens(torch.from_numpy(tokens)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * max(1.0, np.abs(want).max()))


def test_flash_route_matches_masked_path():
    """At T=512 with flash enabled, the backbone takes K6's route (its plain
    versions on the CPU); JAX on the CPU takes its masked path."""
    over = dict(n_embd=128, n_head=2, n_query_groups=1, intermediate_size=128, context=200)
    jb, params, tb = _pair(**over)
    tb.config = dataclasses.replace(tb.config, use_flash_attention=True)
    x = np.random.default_rng(4).standard_normal((1, 512, 128)).astype(np.float32)
    want = np.asarray(jb(params, jnp.asarray(x)))
    from rstnet_tpu_torch.ops import cuda_flash

    calls = []
    orig = cuda_flash.flash_attention_fwd_reference
    cuda_flash.flash_attention_fwd_reference = lambda *a: calls.append(1) or orig(*a)
    try:
        with torch.no_grad():
            got = tb(torch.from_numpy(x)).numpy()
    finally:
        cuda_flash.flash_attention_fwd_reference = orig
    assert len(calls) == over.get("n_layer", TINY["n_layer"])
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_remat_changes_no_value():
    """Checkpointed blocks give the same output and gradients."""
    _, _, tb = _pair(**VARIANTS["llama31-gqa"])
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((2, 9, 32)).astype(np.float32))
    results = []
    for remat in (False, True):
        tb.config = dataclasses.replace(tb.config, remat=remat)
        for p in tb.parameters():
            p.requires_grad_(True)
            p.grad = None
        tb(x).square().sum().backward()
        results.append([p.grad.clone() for p in tb.blocks.parameters()])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bridge_round_trip_is_exact():
    _, params, tb = _pair(jnp.bfloat16)
    got = to_numpy(tb, stacked=STACKED)
    want = {k: np.asarray(v) for k, v in flatten_dict(params)}
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(
            got[k].view(np.uint16) if got[k].dtype.name == "bfloat16" else got[k],
            want[k].view(np.uint16) if want[k].dtype.name == "bfloat16" else want[k]), k


@pytest.mark.parametrize("over", [dict(mlp_class_name="LLaMAMoE", n_expert=4,
                                       n_expert_per_token=2), dict(lora_r=2)])
def test_unported_options_raise(over):
    """MoE and LoRA configs, refused until they were ported, build and run
    (their parity with JAX: ``tests/test_torch_lora.py``); an MLP class the
    port does not know still raises."""
    bb = Backbone(Config(**dict(TINY, **over)))
    with torch.no_grad():
        assert torch.isfinite(bb.forward_tokens(torch.zeros((1, 4), dtype=torch.long))).all()
    with pytest.raises(NotImplementedError):
        Backbone(Config(**{**TINY, **over, "mlp_class_name": "NoSuchMLP"}))
