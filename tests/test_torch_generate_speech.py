"""The port's ``LMGen`` over ``SpeechTextLM`` on the CPU: mirrors of
``tests/test_generate.py``'s SpeechTextLM tests, and greedy frames held
token for token to the JAX ``LMGen`` in float32.

The port's ``step`` updates its state in place, so where a JAX test steps
two models from one state, the port steps a copy. Models come from the
port's seeded init (mirrors) or from the JAX init through the bridge
(parity). Greedy tokens are compared exactly; the soak's hidden state to
1e-5, as the JAX test holds it."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu_torch.inference.generate import LMGen
from rstnet_tpu_torch.models.config import Config
from rstnet_tpu_torch.models.lm import (
    UNGENERATED_TOKEN_ID,
    SpeechTextLM,
    quantize_dep_for_serving,
    quantize_head_for_serving,
)
from tests.test_torch_speech_lm import CFG, lm_pair


def _model(**over) -> SpeechTextLM:
    return SpeechTextLM(Config(**dict(CFG, **over)), generator=torch.Generator().manual_seed(0))


def _frames(gen, state, n, generator=None):
    outs, valids = [], []
    for _ in range(n):
        out, valid, state = gen.step(state, generator)
        outs.append(out.clone())
        valids.append(valid.clone())
    return torch.stack(outs), torch.stack(valids), state


def test_warmup_then_valid_frames():
    m = _model()
    gen = LMGen(m, delays=(0,) + (1,) * m.config.n_q, use_sampling=True)
    outs, valids, _ = _frames(gen, gen.init_state(1, torch.float32), 6,
                              torch.Generator().manual_seed(7))
    assert valids[:, 0].tolist() == [False, True, True, True, True, True]
    for out, valid in zip(outs, valids):
        if valid:
            assert (out != UNGENERATED_TOKEN_ID).all() and out.shape == (1, m.config.dep_q + 1, 1)
            assert (out[:, 1:] < m.config.audio_card).all() and (out >= 0).all()


def test_zero_delay_greedy_matches_manual_loop():
    """Greedy LMGen with no delays reproduces a hand-rolled loop over the
    model's streaming pieces."""
    m = _model()
    gen = LMGen(m, use_sampling=False)
    outs, valids, _ = _frames(gen, gen.init_state(1, torch.float32), 4)
    assert valids.all()
    lm_state = m.init_state(1, dtype=torch.float32)
    frame = m.initial_frame(1)
    manual = []
    with torch.no_grad():
        for _ in range(4):
            hidden, text_logits, lm_state = m.step_global(lm_state, frame)
            toks = [text_logits[:, -1].argmax(-1)]
            cf_state = m.init_codecformer_state(1, dtype=torch.float32)
            for cb in range(m.config.dep_q):
                logits, cf_state = m.step_codecformer(cf_state, cb, toks[-1][:, None], hidden)
                toks.append(logits[:, -1].argmax(-1))
            frame = torch.stack(toks, dim=1)[:, :, None]
            manual.append(frame[0, :, 0])
    torch.testing.assert_close(outs[:, 0, :, 0], torch.stack(manual), rtol=0, atol=0)


def test_audio_max_card_clamp():
    m = _model()
    gen = LMGen(m, use_sampling=True, audio_max_card=4, top_k=0, temp=1.0)
    outs, _, _ = _frames(gen, gen.init_state(2, torch.float32), 3,
                         torch.Generator().manual_seed(3))
    assert (outs[-1][:, 1:] < 4).all()


def test_multi_session_staggered_join_matches_solo():
    """A slot reset mid-stream behaves like a fresh solo session: its age
    masks the shared ring (``min_pos``) and restarts the delay warmup."""
    m = _model()
    gen = LMGen(m, delays=(0,) + (1,) * m.config.n_q, use_sampling=False)
    state = gen.init_state(3, torch.float32)
    _, _, state = _frames(gen, state, 4)
    state = gen.reset_slots(state, [1])
    assert int(state["age"][1]) == 0 and int(state["age"][0]) == 4
    batched, batched_valid, _ = _frames(gen, state, 6)
    solo, solo_valid, _ = _frames(gen, gen.init_state(1, torch.float32), 6)
    assert batched_valid[:, 1].tolist() == solo_valid[:, 0].tolist()
    torch.testing.assert_close(batched[:, 1], solo[:, 0], rtol=0, atol=0)


def test_multi_session_running_slot_unaffected_by_reset():
    m = _model()
    gen = LMGen(m, delays=(0,) + (1,) * m.config.n_q, use_sampling=False)
    state_a, state_b = gen.init_state(2, torch.float32), gen.init_state(2, torch.float32)
    for t in range(8):
        if t == 4:
            state_b = gen.reset_slots(state_b, [1])
        out_a, _, state_a = gen.step(state_a, None)
        out_b, _, state_b = gen.step(state_b, None)
        torch.testing.assert_close(out_b[0], out_a[0], rtol=0, atol=0)


def test_kv_int8_close_to_exact():
    """int8 ring: most greedy frames equal the exact ring's (random tiny
    models have near-tied logits)."""
    m = _model()
    gen, gen8 = LMGen(m, use_sampling=False), LMGen(m, use_sampling=False, kv_int8=True)
    state, state8 = gen.init_state(1, torch.float32), gen8.init_state(1, torch.float32)
    assert state8["lm"]["kv"]["k"].dtype == torch.int8
    outs, _, _ = _frames(gen, state, 10)
    outs8, _, _ = _frames(gen8, state8, 10)
    n_match = sum(int(torch.equal(a, b)) for a, b in zip(outs, outs8))
    assert n_match >= 7, f"only {n_match}/10 greedy frames matched the exact ring"


# the flagship of ``__graft_entry__._flagship(tiny=True)``, written out
FLAGSHIP_TINY = dict(name="graft-entry-tiny", block_size=4096, vocab_size=512,
                     padded_vocab_size=512, n_layer=2, n_head=4, n_embd=64, n_query_groups=2,
                     rotary_percentage=1.0, parallel_residual=False, bias=False,
                     norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP", intermediate_size=128,
                     context=128, audio_card=64, codecformer_dim=32, n_q=8, dep_q=8,
                     codecformer_heads=4, codecformer_layers=2, codecformer_dim_feedforward=64)


def test_head_only_int8_keeps_greedy_tokens():
    """``quantize_head_for_serving`` (int8 lm_head only): the audio path is
    bit-identical, the text argmax agrees with the float head almost
    everywhere."""
    m = SpeechTextLM(Config(**FLAGSHIP_TINY), generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    seq = torch.from_numpy(np.concatenate([rng.integers(0, 512, (2, 1, 12)),
                                           rng.integers(0, 64, (2, 8, 12))], axis=1))
    with torch.no_grad():
        audio, text = m(seq)
        audio_h, text_h = quantize_head_for_serving(copy.deepcopy(m))(seq)
    torch.testing.assert_close(audio_h, audio, rtol=0, atol=0)
    assert (text.argmax(-1) == text_h.argmax(-1)).float().mean() >= 0.9


def test_dep_int8_keeps_most_greedy_tokens():
    """``quantize_dep_for_serving``: per-frame greedy agreement with the float
    model, each int8 frame taken from the float run's state."""
    m = _model()
    m_d = quantize_dep_for_serving(copy.deepcopy(m))
    gen, gen_d = LMGen(m, use_sampling=False), LMGen(m_d, use_sampling=False)
    state = gen.init_state(1, torch.float32)
    n_tok = n_match = 0
    for _ in range(10):
        out_d, _, _ = gen_d.step(copy.deepcopy(state), None)
        out, _, state = gen.step(state, None)
        n_match += int((out == out_d).sum())
        n_tok += out.numel()
    assert n_match / n_tok >= 0.9, f"only {n_match}/{n_tok} greedy tokens matched"


def test_context_wraparound_soak():
    """A session runs 3x past the ring (context 8): tokens stay valid and in
    range, the run is deterministic, and the backbone's next hidden state
    equals a fresh state's that replays only the frames in its receptive
    field (ring eviction equals the window mask)."""
    m = _model(context=8)
    gen = LMGen(m, use_sampling=False)
    T = 3 * m.config.context + 2

    def run():
        outs, valids, state = _frames(gen, gen.init_state(1, torch.float32), T)
        assert valids.all()
        return outs[:, 0, :, 0], state

    toks_a, state_a = run()
    toks_b, _ = run()
    torch.testing.assert_close(toks_a, toks_b, rtol=0, atol=0)
    assert (toks_a >= 0).all() and (toks_a[:, 1:] < m.config.audio_card).all()
    assert (toks_a[:, 0] < m.config.padded_vocab_size).all()
    probe = toks_a[-1][None, :, None]
    receptive = m.config.n_layer * (m.config.context - 1)
    assert T - 1 >= receptive
    with torch.no_grad():
        hidden_long, _, _ = m.step_global(state_a["lm"], probe)
        fresh = m.init_state(1, torch.float32)
        for i in range(T - 1 - receptive, T - 1):
            _, _, fresh = m.step_global(fresh, toks_a[i][None, :, None])
        hidden_fresh, _, _ = m.step_global(fresh, probe)
    torch.testing.assert_close(hidden_long, hidden_fresh, rtol=0, atol=1e-5)


def test_kv_unstacked_matches_stacked():
    m = _model()
    outs = {}
    for unstacked in (False, True):
        gen = LMGen(m, use_sampling=False, kv_unstacked=unstacked)
        state = gen.init_state(2, torch.float32)
        assert isinstance(state["lm"]["kv"], list) == unstacked
        outs[unstacked], _, _ = _frames(gen, state, 6)
    torch.testing.assert_close(outs[False], outs[True], rtol=0, atol=0)


@pytest.mark.parametrize("unstacked", [False, True], ids=["stacked", "per-layer"])
@pytest.mark.parametrize("int8", [False, True], ids=["float", "int8"])
def test_greedy_frames_match_jax(unstacked, int8):
    """Greedy frames of the port's ``LMGen`` (backbone MLP through K4's or
    K5's plain version) equal the JAX ``LMGen``'s token for token: float32
    weights and state, B=2, the delay pattern of the flagship, 8 frames; with
    ``int8``, both sides ``quantize_for_serving`` and an int8 ring."""
    from rstnet_tpu.core import flatten_dict
    from rstnet_tpu.inference.generate import LMGen as JGen
    from rstnet_tpu.models import lm as jlm
    from rstnet_tpu_torch.core import from_jax_params
    from rstnet_tpu_torch.models.lm import quantize_for_serving

    jm, params, tm = lm_pair(n_embd=128, intermediate_size=256)
    if int8:
        params = jlm.quantize_for_serving(jm, params)
        from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)},
                        quantize_for_serving(tm), stacked=tm.STACKED)
    delays = (0,) + (1,) * tm.config.n_q
    jgen = JGen(jm, delays=delays, use_sampling=False, kv_unstacked=unstacked, kv_int8=int8)
    tgen = LMGen(tm, delays=delays, use_sampling=False, kv_unstacked=unstacked, kv_int8=int8)
    jstate, tstate = jgen.init_state(2, jnp.float32), tgen.init_state(2, torch.float32)
    step = jax.jit(jgen.step)
    for _ in range(8):
        jout, jvalid, jstate = step(params, jstate, jax.random.PRNGKey(0))
        tout, tvalid, tstate = tgen.step(tstate, None)
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))


def test_lmgen_takes_the_speech_model_into_k1_where_the_shapes_allow(monkeypatch):
    """At B=1 with a codecformer inside K1's envelope (128 wide, card 128,
    gating hidden 128) the micro-steps go through the K1 wrapper (its plain
    version here), once per codebook; after ``quantize_dep_for_serving`` the
    operands are K1-int8's."""
    import rstnet_tpu_torch.inference.generate as gmod

    m = _model(n_embd=128, intermediate_size=256, codecformer_dim=128, codecformer_heads=2,
               codecformer_dim_feedforward=192, audio_card=128)
    m = m.to(torch.bfloat16)
    ops = gmod.depformer_kernel_operands(m)
    assert ops is not None and ops["scales"] is None and ops["C"] == 128
    calls = []
    real = gmod.depformer_step
    monkeypatch.setattr(gmod, "depformer_step",
                        lambda *a, **k: calls.append(a[1]) or real(*a, **k))
    gen = LMGen(m, use_sampling=False)
    _frames(gen, gen.init_state(1, torch.float32), 2)
    assert calls == list(range(8)) * 2
    quantize_dep_for_serving(m)
    assert gmod.depformer_kernel_operands(m)["scales"] is not None  # K1-int8's operands
