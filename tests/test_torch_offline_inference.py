"""The port's ``OfflineInference`` on the CPU: mirrors of
``tests/test_offline_inference.py`` and greedy generation held token for
token to the JAX ``OfflineInference`` in float32 (teacher-forced metrics to
1e-5 relative: the same float32 math in another summation order)."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu_torch.inference.offline import OfflineInference
from tests.test_torch_speech_lm import CFG, lm_pair, rand_sequence
from tests.test_torch_generate_speech import _model


def test_teacher_forced_metrics():
    m = _model()
    seq = rand_sequence(1, 2, 6, CFG, zero_frac=0.0)
    inf = OfflineInference(m, audio_ignore_id=49, text_ignore_id=151)
    metrics = inf.teacher_forced_metrics(seq, np.ones(seq.shape, np.float32))
    assert np.isfinite(metrics["ppl_audio"]) and metrics["ppl_audio"] > 1.0
    assert np.isfinite(metrics["ppl_text"])


def test_generate_respects_prefix_and_extends():
    m = _model()
    prefix = rand_sequence(2, 1, 4, CFG, zero_frac=0.0)
    out = OfflineInference(m).generate(prefix, max_new=3,
                                       generator=torch.Generator().manual_seed(3))
    assert out.shape == (1, 9, 7)
    np.testing.assert_array_equal(out[:, :, :4], prefix)  # the forced region intact
    assert (out[:, 1:, 4:] < m.config.audio_card).all() and (out >= 0).all()


def test_partial_teacher_forcing_tts_style():
    """The text row forced past the prefix; the audio stays generated."""
    m = _model()
    prefix = rand_sequence(4, 1, 2, CFG, zero_frac=0.0)
    forced = np.full((1, 9, 6), -1, np.int64)
    forced[:, 0, :] = 7
    out = OfflineInference(m).generate(prefix, max_new=4,
                                       generator=torch.Generator().manual_seed(5), forced=forced)
    assert (out[:, 0, 2:] == 7).all()


def test_generate_duplex_config():
    """Duplex (n_q > dep_q, the port's MoshiLMModel): the user rows are re-fed
    from the prefix while it lasts and hold the initial token after."""
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    m = MoshiLMModel(
        delays=(0,) * 9, n_q=8, dep_q=4, card=16, text_card=64, dim=32, num_heads=4,
        num_layers=2, hidden_scale=4.0, norm="rms_norm_f32", gating="silu",
        positional_embedding="rope", context=16, existing_text_padding_id=3, depformer_dim=16,
        depformer_dim_feedforward=32, depformer_num_heads=2, depformer_num_layers=1,
        depformer_multi_linear=True, depformer_weights_per_step=True, depformer_pos_emb="none",
        generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, 16, (1, m.num_codebooks, 4)).astype(np.int64)
    prefix[0, 0] = rng.integers(0, 64, 4)
    out = OfflineInference(m, codec_card=16).generate(prefix, max_new=3,
                                                      generator=torch.Generator().manual_seed(3))
    assert out.shape == (1, 9, 7)
    np.testing.assert_array_equal(out[:, :, :4], prefix)
    assert (out[:, 1:m.dep_q + 1, 4:] < 16).all()
    assert (out[:, m.dep_q + 1:, 4:] == m.initial_token_id).all()


@pytest.mark.parametrize("task", ["continuation", "tts"])
def test_greedy_generate_matches_jax(task):
    """Greedy generation (float32, the stacked float32 ring, the backbone MLP
    through K4's plain version) equals the JAX ``OfflineInference.generate``
    token for token; the teacher-forced metrics agree to 1e-5 relative."""
    from rstnet_tpu.inference.offline import OfflineInference as JaxInference

    jm, params, tm = lm_pair(n_embd=128, intermediate_size=256)
    prefix = rand_sequence(6, 2, 3, CFG, zero_frac=0.0)
    forced = None
    if task == "tts":
        forced = np.full((2, 9, 8), -1, np.int64)
        forced[:, 0] = rand_sequence(7, 2, 8, CFG, zero_frac=0.0)[:, 0]
    want = JaxInference(jm, params, use_sampling=False).generate(
        prefix, 5, jax.random.PRNGKey(0), forced=forced)
    got = OfflineInference(tm, use_sampling=False).generate(prefix, 5, forced=forced)
    np.testing.assert_array_equal(got, want)
    seq = rand_sequence(8, 2, 6, CFG)
    masks = np.random.default_rng(9).choice(np.array([0.0, 1.0], np.float32), seq.shape)
    jmet = JaxInference(jm, params, audio_ignore_id=47, text_ignore_id=159).teacher_forced_metrics(
        jnp.asarray(seq), jnp.asarray(masks))
    tmet = OfflineInference(tm, audio_ignore_id=47, text_ignore_id=159).teacher_forced_metrics(
        seq, masks)
    assert set(tmet) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k], jmet[k], rtol=1e-5, err_msg=k)
