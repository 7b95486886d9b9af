"""The port's ``SpeechTextLM`` and its loss against the JAX package on the
CPU (mirrors of ``tests/test_speech_lm.py``), its streaming pieces
(``step_global``, ``codecformer_inputs``, ``step_codecformer``) and the
three serving quantizations.

The same params (JAX init, carried by the bridge), the same seeded token
grids. float32 logits are held to 2e-5 (the same math in another summation
order; observed ~6e-7); streamed logits against the training forward to
3e-5, as the JAX test holds them; the loss and its metrics to 1e-6
relative; int8 trees bit for bit."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu.losses.ce import cross_entropy_and_accuracy as jax_ce
from rstnet_tpu.models.config import Config as JaxConfig
from rstnet_tpu.models.lm import SpeechTextLM as JaxLM
from rstnet_tpu_torch.core import from_jax_params, to_numpy
from rstnet_tpu_torch.losses.ce import cross_entropy_and_accuracy
from rstnet_tpu_torch.models.config import Config
from rstnet_tpu_torch.models.lm import (
    SpeechTextLM,
    quantize_dep_for_serving,
    quantize_for_serving,
    quantize_head_for_serving,
)

CFG = dict(
    name="test-tiny", block_size=128, vocab_size=160, padded_vocab_size=160,
    n_layer=2, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64, context=24,
    audio_card=48, codecformer_dim=24, n_q=8, dep_q=8, codecformer_heads=4,
    codecformer_layers=2, codecformer_dim_feedforward=48,
)
LOGIT_TOL = 2e-5


def lm_pair(dtype=jnp.float32, **over):
    d = dict(CFG, **over)
    jm = JaxLM(JaxConfig(**d))
    params = jm.init(jax.random.PRNGKey(0), dtype)
    tm = SpeechTextLM(Config(**d), dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, tm, stacked=tm.STACKED)
    return jm, params, tm


def rand_sequence(seed, B, S, cfg, zero_frac=0.1):
    """[B, 1 + n_q, S] grid with some ZERO_TOKEN_ID (-1) audio entries."""
    rng = np.random.default_rng(seed)
    text = rng.integers(0, cfg["padded_vocab_size"], (B, 1, S))
    audio = rng.integers(0, cfg["audio_card"], (B, cfg["n_q"], S))
    audio[rng.random(audio.shape) < zero_frac] = -1
    return np.concatenate([text, audio], axis=1)


def test_forward_shapes():
    tm = SpeechTextLM(Config(**CFG), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        audio_logits, text_logits = tm(torch.from_numpy(rand_sequence(1, 2, 6, CFG)))
    assert audio_logits.shape == (2, 6, 8, 48)
    assert text_logits.shape == (2, 6, 160)


def test_zero_token_embeds_to_zero():
    _, params, tm = lm_pair()
    seq = torch.full((1, 9, 4), -1, dtype=torch.int64)
    seq[:, 0] = 5
    with torch.no_grad():
        x = tm.fuse_embeddings(seq)
    want = np.asarray(params["backbone"]["wte"])[np.full((1, 4), 5)]
    np.testing.assert_allclose(x.numpy(), want, atol=1e-6)
    seq[:, 0] = -1  # the text row honours the zero token too
    with torch.no_grad():
        assert not tm.fuse_embeddings(seq).any()


@pytest.mark.parametrize("over", [{}, dict(remat=True),
                                  dict(codecformer_multi_linear=False, codecformer_norm_emb=True,
                                       codecformer_bias_proj=True)])
def test_training_forward_matches_jax(over):
    jm, params, tm = lm_pair(**over)
    seq = rand_sequence(2, 2, 6, CFG)
    audio_j, text_j = jm(params, jnp.asarray(seq))
    audio_t, text_t = tm(torch.from_numpy(seq))  # autograd on: the remat route
    np.testing.assert_allclose(text_t.detach().numpy(), np.asarray(text_j), atol=LOGIT_TOL)
    np.testing.assert_allclose(audio_t.detach().numpy(), np.asarray(audio_j), atol=LOGIT_TOL)


def test_shared_codecformer_in_and_norm_emb():
    """codecformer_multi_linear=False (one shared input view) and
    codecformer_norm_emb=True (post-embedding layer norms) build and
    train-forward; the remat route gives the same gradients."""
    over = dict(codecformer_multi_linear=False, codecformer_norm_emb=True)
    _, _, tm = lm_pair(**over)
    assert tm.codecformer_in.shape[0] == 1
    assert hasattr(tm, "input_emb_norm") and hasattr(tm, "codecformer_emb_norm")
    seq = torch.from_numpy(rand_sequence(3, 2, 6, CFG))
    grads = []
    for remat in (False, True):
        tm.config = dataclasses.replace(tm.config, remat=remat)
        tm.codecformer.remat = remat
        for p in tm.parameters():
            p.requires_grad_(True)
            p.grad = None
        audio, text = tm(seq)
        assert torch.isfinite(audio).all() and torch.isfinite(text).all()
        (audio.square().mean() + text.square().mean()).backward()
        grads.append([p.grad.clone() for p in tm.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _ce_inputs(seed, B=2, T=5, K=3, V=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, T, K, V)).astype(np.float32)
    targets = rng.integers(0, V, (B, K, T))
    targets[rng.random(targets.shape) < 0.2] = 10  # the ignore id
    masks = rng.choice(np.array([0.0, 1.0, 0.25], np.float32), (B, K, T))
    return logits, targets, masks


def test_loss_semantics():
    logits, targets, masks = _ce_inputs(4)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(targets)
    ones = torch.ones(targets.shape)
    loss, metrics = cross_entropy_and_accuracy(tl, tt, ones, (2.0, 1.0, 1.0), (10, 10, 10))
    assert torch.isfinite(loss) and 0.0 <= float(metrics["acc_all"]) <= 1.0
    # a fully masked stream adds nothing
    masks0 = ones.clone()
    masks0[:, 0] = 0.0
    loss0, _ = cross_entropy_and_accuracy(tl, tt, masks0, (2.0, 1.0, 1.0), (10, 10, 10))
    loss_wo, _ = cross_entropy_and_accuracy(tl, tt, ones, (0.0, 1.0, 1.0), (10, 10, 10))
    np.testing.assert_allclose(float(loss0), float(loss_wo), rtol=1e-6)


@pytest.mark.parametrize("chunk", [None, 8])
def test_loss_and_gradient_match_jax(chunk, monkeypatch):
    """Values, accuracies and d loss / d logits against JAX, masks of 0, 1
    and 0.25, ignored targets; ``chunk`` forces several row chunks."""
    from rstnet_tpu_torch.losses import ce

    if chunk is not None:
        monkeypatch.setattr(ce, "CHUNK_ELEMENTS", chunk * 11)
    logits, targets, masks = _ce_inputs(5)
    args = ((2.0, 1.0, 1.0), (10, 10, 10))

    def jloss(lg):
        return jax_ce(lg, jnp.asarray(targets), jnp.asarray(masks), *args)

    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_()
    loss, metrics = cross_entropy_and_accuracy(tl, torch.from_numpy(targets),
                                               torch.from_numpy(masks), *args)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-6)
    for k in ("acc_all", "acc_target", "loss"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jm[k]), rtol=1e-6)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jg), atol=1e-7)


def test_bf16_logits_keep_their_dtype_through_the_loss():
    """bf16 logits: the gradient comes back in bf16, and the loss is the
    float32 CE of the bf16 values."""
    logits, targets, masks = _ce_inputs(6)
    tl = torch.from_numpy(logits).bfloat16().requires_grad_()
    loss, _ = cross_entropy_and_accuracy(tl, torch.from_numpy(targets), torch.from_numpy(masks),
                                         (1.0, 1.0, 1.0), (10, 10, 10))
    loss.backward()
    assert loss.dtype == torch.float32 and tl.grad.dtype == torch.bfloat16
    want, _ = jax_ce(jnp.asarray(np.asarray(tl.detach().float())), jnp.asarray(targets),
                     jnp.asarray(masks), (1.0, 1.0, 1.0), (10, 10, 10))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-6)


def test_bridge_carries_the_whole_tree_bit_for_bit():
    """bf16 params (the trainer's dtype), float32 codecformer norms: every
    leaf of the JAX tree, the stacked blocks included, comes back equal."""
    _, params, tm = lm_pair(jnp.bfloat16)
    got = to_numpy(tm, stacked=tm.STACKED)
    want = {k: np.asarray(v) for k, v in flatten_dict(params)}
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k
    assert {str(a.dtype) for a in want.values()} == {"bfloat16", "float32"}


# n_embd 128 and an MLP of 256: the backbone step's MLP takes K4 (its plain
# version on the CPU)
STREAM = dict(n_embd=128, intermediate_size=256)


@pytest.mark.parametrize("over", [{}, STREAM], ids=["tiny", "fused-mlp"])
def test_streaming_step_matches_training_forward(over):
    """Mirror of ``tests/test_speech_lm.py::test_streaming_step_matches_training_forward``:
    stepping frame by frame, teacher-forced, reproduces the training
    forward's logits."""
    _, _, tm = lm_pair(**over)
    S = 5
    seq = torch.from_numpy(rand_sequence(1, 1, S, CFG, zero_frac=0.0))
    with torch.no_grad():
        audio_ref, text_ref = tm(seq)
        state = tm.init_state(1, dtype=torch.float32)
        frames = torch.cat([tm.initial_frame(1), seq[:, :, :-1]], dim=2)
        audio, text = [], []
        for t in range(S):
            hidden, text_logits, state = tm.step_global(state, frames[:, :, t:t + 1])
            text.append(text_logits)
            cf_state = tm.init_codecformer_state(1, dtype=torch.float32)
            prev, step_logits = seq[:, 0, t:t + 1], []
            for cb in range(tm.config.dep_q):
                logits, cf_state = tm.step_codecformer(cf_state, cb, prev, hidden)
                step_logits.append(logits)
                prev = seq[:, 1 + cb, t:t + 1]
            audio.append(torch.stack(step_logits, dim=2))
    torch.testing.assert_close(torch.cat(text, dim=1), text_ref, rtol=0, atol=3e-5)
    torch.testing.assert_close(torch.cat(audio, dim=1), audio_ref, rtol=0, atol=3e-5)


@pytest.mark.parametrize("over", [STREAM, dict(STREAM, codecformer_multi_linear=False,
                                               codecformer_norm_emb=True,
                                               codecformer_bias_proj=True)])
def test_streaming_pieces_match_jax(over):
    """``step_global`` (per-layer rings), ``codecformer_inputs``,
    ``codecformer_step_embedding`` and ``step_codecformer`` (with and without
    the precomputed view) against JAX over 3 frames at B=2."""
    jm, params, tm = lm_pair(**over)
    seq = rand_sequence(4, 2, 3, CFG)
    jst = jm.init_state(2, jnp.float32, kv_unstacked=True)
    tst = tm.init_state(2, torch.float32, kv_unstacked=True)
    for t in range(3):
        frame = seq[:, :, t:t + 1]
        jh, jl, jst = jm.step_global(params, jst, jnp.asarray(frame))
        with torch.no_grad():
            th, tl, tst = tm.step_global(tst, torch.from_numpy(frame))
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=LOGIT_TOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL)
        jd = jm.codecformer_inputs(params, jh)
        with torch.no_grad():
            td = tm.codecformer_inputs(th)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=LOGIT_TOL)
        jcf = jm.init_codecformer_state(2, dtype=jnp.float32)
        tcf = tm.init_codecformer_state(2, dtype=torch.float32)
        for cb in range(tm.config.dep_q):
            prev = seq[:, cb, t:t + 1]
            dep_in = None if cb % 2 else jd[:, cb]
            jlog, jcf = jm.step_codecformer(params, jcf, cb, jnp.asarray(prev), jh, dep_in=dep_in)
            with torch.no_grad():
                tlog, tcf = tm.step_codecformer(tcf, cb, torch.from_numpy(prev), th,
                                                dep_in=None if cb % 2 else td[:, cb])
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=LOGIT_TOL)


@pytest.mark.parametrize("which", ["full", "dep", "head", "head+dep"])
def test_serving_quantizations_bit_equal_to_jax(which):
    """``quantize_for_serving``, ``quantize_dep_for_serving`` and
    ``quantize_head_for_serving`` (and the mixed head + dep mode) on a bf16
    model: the port's tree through the bridge equals the JAX tree bit for
    bit, and the JAX-quantized tree loads into the port's quantized model."""
    from rstnet_tpu.models import lm as jlm

    jm, params, tm = lm_pair(jnp.bfloat16, **STREAM)
    steps = {"full": [lambda p: jlm.quantize_for_serving(jm, p)],
             "dep": [jlm.quantize_dep_for_serving], "head": [jlm.quantize_head_for_serving],
             "head+dep": [jlm.quantize_head_for_serving, jlm.quantize_dep_for_serving]}[which]
    ports = {"full": [quantize_for_serving], "dep": [quantize_dep_for_serving],
             "head": [quantize_head_for_serving],
             "head+dep": [quantize_head_for_serving, quantize_dep_for_serving]}[which]
    for fj, ft in zip(steps, ports):
        params = fj(params)
        assert ft(tm) is tm
    want = {k: np.asarray(v) for k, v in flatten_dict(params)}
    got = to_numpy(tm, stacked=tm.STACKED)
    assert set(got) == set(want)
    assert any(k.endswith("w_int8") for k in got)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k
    from_jax_params(want, tm, stacked=tm.STACKED)
