"""The port's quantization-quality measures (``evalsuite/quant_quality.py``)
on the CPU: mirrors of ``tests/test_quant_quality.py``'s first three tests,
and the streaming teacher-forced CE held to the JAX function's.

Tolerances: the streaming CE against the offline forward's 2e-4 relative, as
the JAX test holds it; against JAX's streaming CE 1e-5 relative in float32
(the same float32 math in another summation order; the backbone MLP runs
K4's plain version). Samples differ from JAX's (the two generators draw
other numbers), so the port's samples are held to themselves: the same seed
gives the same samples."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu_torch.core import from_jax_params
from rstnet_tpu_torch.evalsuite.quant_quality import (
    agreement,
    compare_quant_variants,
    teacher_forced_stream,
)
from rstnet_tpu_torch.losses.ce import cross_entropy_and_accuracy
from rstnet_tpu_torch.models.config import Config
from rstnet_tpu_torch.models.lm import SpeechTextLM, quantize_for_serving

CFG = dict(
    name="qq-tiny", block_size=64, vocab_size=96, padded_vocab_size=96,
    n_layer=2, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64, context=32,
    audio_card=66, n_q=4, dep_q=4, codecformer_dim=16, codecformer_heads=2,
    codecformer_layers=2, codecformer_dim_feedforward=32,
)


def _setup(dtype=torch.float32, **over):
    cfg = Config(**dict(CFG, **over))
    model = SpeechTextLM(cfg, dtype=dtype, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    B, T = 2, 12
    grid = np.concatenate([rng.integers(0, cfg.padded_vocab_size, (B, 1, T)),
                           rng.integers(0, cfg.audio_card - 2, (B, cfg.n_q, T))], axis=1)
    return cfg, model, grid


def test_streaming_tf_ce_matches_offline_forward():
    """The streaming teacher-forced CE equals the training forward's CE on
    the same grid, every position."""
    cfg, model, grid = _setup()
    r = teacher_forced_stream(model, grid, 3, state_dtype=torch.float32)
    tgt = torch.from_numpy(grid)
    with torch.no_grad():
        audio_logits, text_logits = model(tgt)
    ones = torch.ones((grid.shape[0], 1, grid.shape[2]))
    loss_a, _ = cross_entropy_and_accuracy(audio_logits, tgt[:, 1:cfg.dep_q + 1],
                                           ones.expand(-1, cfg.dep_q, -1), (1.0,) * cfg.dep_q,
                                           (-1,) * cfg.dep_q)
    loss_t, _ = cross_entropy_and_accuracy(text_logits[:, :, None, :], tgt[:, 0:1], ones, (1.0,),
                                           (-1,))
    np.testing.assert_allclose(r.ce_audio, float(loss_a) / cfg.dep_q, rtol=2e-4)
    np.testing.assert_allclose(r.ce_text, float(loss_t), rtol=2e-4)


def test_same_seed_same_samples():
    _, model, grid = _setup()
    r1 = teacher_forced_stream(model, grid, 5)
    r2 = teacher_forced_stream(model, grid, 5)
    np.testing.assert_array_equal(r1.sampled, r2.sampled)
    assert agreement(r1.sampled, r2.sampled) == 1.0
    r3 = teacher_forced_stream(model, grid, 6)
    assert agreement(r1.sampled, r3.sampled) < 1.0


def test_compare_quant_variants():
    cfg, model, grid = _setup(torch.bfloat16)
    model_q = quantize_for_serving(copy.deepcopy(model))
    out = compare_quant_variants(model, {"int8": (model_q, False), "int8+kv8": (model_q, True)},
                                 grid, 7)
    rows = out["rows"]
    assert rows["bf16"]["agree_sampled"] == 1.0
    for name in ("int8", "int8+kv8"):
        row = rows[name]
        assert np.isfinite(row["ppl_audio"]) and np.isfinite(row["ppl_text"])
        assert 0.0 < row["agree_sampled"] <= 1.0 and 0.0 < row["agree_greedy"] <= 1.0
        assert abs(row["d_ce_audio"]) < 1.0 and abs(row["d_ce_text"]) < 1.0
    assert out["results"]["bf16"].sampled.shape == (grid.shape[0], cfg.dep_q + 1, grid.shape[2])


@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8+kv8"])
def test_streaming_ce_matches_jax(int8):
    """CE and greedy tokens of the port's pass equal JAX's ``teacher_forced_stream``
    on the same float32 weights (the MLP reaches K4/K5's route at n_embd 128);
    with ``int8``, both ``quantize_for_serving`` with an int8 ring."""
    from rstnet_tpu.core import flatten_dict
    from rstnet_tpu.evalsuite.quant_quality import teacher_forced_stream as jax_stream
    from rstnet_tpu.models.config import Config as JaxConfig
    from rstnet_tpu.models.lm import SpeechTextLM as JaxLM
    from rstnet_tpu.models.lm import quantize_for_serving as jax_quantize

    over = dict(n_embd=128, intermediate_size=256)
    cfg, model, grid = _setup(**over)
    jm = JaxLM(JaxConfig(**dict(CFG, **over)))
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    if int8:
        params = jax_quantize(jm, params)
        quantize_for_serving(model)
    from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, model,
                    stacked=model.STACKED)
    want = jax_stream(jm, params, grid.astype(np.int32), jax.random.PRNGKey(3), kv_int8=int8,
                      state_dtype=jnp.float32)
    got = teacher_forced_stream(model, grid, 3, kv_int8=int8, state_dtype=torch.float32)
    np.testing.assert_allclose(got.ce_text, want.ce_text, rtol=1e-5)
    np.testing.assert_allclose(got.ce_audio, want.ce_audio, rtol=1e-5)
    np.testing.assert_array_equal(got.greedy, want.greedy)
