"""The LM side of the PyTorch port and the whole serving slice against the
JAX package: ``MoshiLMModel.step_global``/``step_codecformer``, ``LMGen`` and
``ServerState._fused_frame``.

The LM weights are bf16 and its state float32, as the server runs them: the
first backbone layer computes in bf16, after which the residual stream is
float32. bf16 products round at other places in XLA:CPU and ATen, so logits
are held to 2e-2 of the logit scale (max(1, max |logit|)), hidden states to
2e-2, and audio from identical codes to 1e-3. Greedy tokens must be equal
wherever the reference's top-2 margin exceeds twice that tolerance."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu_torch.core import from_jax_params

LM_TOL = 2e-2
AUDIO_TOL = 1e-3
MOSHI = dict(delays=(0, 0) + (1,) * 7 + (0,) + (1,) * 7, n_q=16, dep_q=8, card=128,
             text_card=256, dim=64, num_heads=4, num_layers=2, hidden_scale=4.0, context=64,
             depformer_dim=128, depformer_dim_feedforward=192, depformer_num_heads=2,
             depformer_num_layers=2)


def _load(params, module):
    return from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, module)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a, np.float32)


def _close(got, want, tol=LM_TOL):
    want = _f32(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=tol * scale)


def _lm_pair(**overrides):
    from rstnet_tpu.models.moshi_lm import MoshiLMModel as JM
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    cfg = dict(MOSHI, **overrides)
    jm = JM(**cfg)
    params = jm.init(jax.random.PRNGKey(1), jnp.bfloat16)
    return jm, params, _load(params, MoshiLMModel(**cfg, dtype=torch.bfloat16))


def test_step_global_matches_jax():
    jm, params, tm = _lm_pair()
    rng = np.random.default_rng(0)
    jst = jm.init_state(2, jnp.float32, kv_unstacked=True)
    tst = tm.init_state(2, torch.float32)
    step = jax.jit(jm.step_global)
    for t in range(4):
        frame = rng.integers(0, 128, (2, 17, 1))
        frame[:, 0] = rng.integers(0, 256, (2, 1))
        frame[1, 3] = -1  # a zero token
        min_pos = np.array([0, 2]) if t > 2 else None
        jh, jl, jst = step(params, jst, jnp.asarray(frame),
                           None if min_pos is None else jnp.asarray(min_pos))
        th, tl, tst = tm.step_global(tst, torch.from_numpy(frame),
                                     None if min_pos is None else torch.from_numpy(min_pos))
        assert th.dtype == torch.float32 and jh.dtype == jnp.float32  # f32 after layer 0
        _close(th, jh)
        _close(tl, jl)


def test_step_codecformer_matches_jax():
    """The batch > 1 depformer path: per-step weights through the streaming
    transformer, then the per-codebook head."""
    jm, params, tm = _lm_pair()
    rng = np.random.default_rng(1)
    hidden = rng.normal(size=(2, 1, 64)).astype(np.float32)
    jdep = jm.codecformer_inputs(params, jnp.asarray(hidden))
    tdep = tm.codecformer_inputs(torch.from_numpy(hidden))
    _close(tdep, jdep)
    jst, tst = jm.init_codecformer_state(2, jnp.float32), tm.init_codecformer_state(2, torch.float32)
    prev = rng.integers(0, 256, (2, 1))
    for cb in range(8):
        jl, jst = jm.step_codecformer(params, jst, cb, jnp.asarray(prev), jnp.asarray(hidden),
                                      dep_in=jdep[:, cb])
        tl, tst = tm.step_codecformer(tst, cb, torch.from_numpy(prev), torch.from_numpy(hidden),
                                      dep_in=tdep[:, cb])
        _close(tl, jl)
        prev = np.array(jnp.argmax(jl[:, 0], -1))[:, None]


def test_lmgen_batched_greedy_matches_jax():
    """LMGen at batch 2 (the step_codecformer path), greedy, no user
    streams: the emitted frames agree with JAX wherever no near-tie flipped a
    token (a flip cascades, so this holds the first frames exactly and a
    high agreement overall)."""
    from rstnet_tpu.inference.generate import LMGen as JGen
    from rstnet_tpu_torch.inference.generate import LMGen

    jm, params, tm = _lm_pair(delays=(0,) + (1,) * 8, n_q=8)
    jgen = JGen(jm, delays=jm.delays, use_sampling=False, kv_unstacked=True)
    tgen = LMGen(tm, delays=tm.delays, use_sampling=False)
    jst, tst = jgen.init_state(2, jnp.float32), tgen.init_state(2, torch.float32)
    step = jax.jit(jgen.step)
    jouts, touts = [], []
    for _ in range(4):
        jo, jv, jst = step(params, jst, jax.random.PRNGKey(0))
        to, tv, tst = tgen.step(tst, None)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        jouts.append(np.asarray(jo))
        touts.append(to.numpy())
    np.testing.assert_array_equal(touts[1], jouts[1])  # the first valid frame
    assert np.mean(np.stack(touts) == np.stack(jouts)) >= 0.9


def jax_main_quantize(params, int8=False, int8_dep=False, int8_head=False):
    """The int8 block of the JAX server's ``main``
    (``rstnet_tpu/serving/server.py:635-666``) on a Moshi params tree."""
    from rstnet_tpu.modules.transformer import quantize_transformer_int8, quantize_weight_int8

    def dep_slice(p):
        p = dict(p)
        p["depformer"] = quantize_transformer_int8(p["depformer"])
        p["depformer_in"] = quantize_weight_int8(p["depformer_in"])
        p["linears"] = dict(p["linears"])
        p["linears"]["weight"] = quantize_weight_int8(p["linears"]["weight"])
        return p

    if int8:
        params = dep_slice(params)
        params["transformer"] = quantize_transformer_int8(params["transformer"])
    elif int8_dep:
        params = dep_slice(params)
    if int8_head and not int8:
        params = dict(params)
        params["text_linear"] = dict(params["text_linear"])
        params["text_linear"]["weight"] = quantize_weight_int8(params["text_linear"]["weight"])
    return params


def _slice_pair(monkeypatch, int8=False, int8_dep=False, int8_head=False, kv_int8=False):
    """JAX ServerState (K1 in Pallas interpret mode) and the port's, on the
    server's --tiny Mimi (random codebooks) and a Moshi config inside K1's
    envelope, both greedy, sharing weights. Per-layer ring KV, as the JAX
    server runs it: its stacked layer scan cannot carry the bf16 -> float32
    residual of bf16 weights over a float32 state. The int8 options quantize
    the JAX params as the JAX ``main`` does; the port's model takes the
    quantized layout from ``quantize_for_serving`` and then the JAX-quantized
    values through ``from_jax_params``."""
    from rstnet_tpu.inference.generate import LMGen as JGen
    from rstnet_tpu.models.moshi_lm import MoshiLMModel as JM
    from rstnet_tpu.serving.server import ServerState as JState
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_kernel_operands
    from rstnet_tpu_torch.serving.server import ServerState, quantize_for_serving
    from tests.test_torch_codec import _tiny_mimi_pair

    monkeypatch.setenv("RSTNET_PALLAS_DEP", "interpret")
    jmimi, mimi_params, tmimi = _tiny_mimi_pair()
    jm = JM(**MOSHI)
    lm_params = jax_main_quantize(jm.init(jax.random.PRNGKey(1), jnp.bfloat16), int8, int8_dep,
                                  int8_head)
    tm = quantize_for_serving(MoshiLMModel(**MOSHI, dtype=torch.bfloat16), int8, int8_dep,
                              int8_head)
    tm = _load(lm_params, tm)
    ops = depformer_kernel_operands(tm)
    assert ops is not None  # B=1 runs K1's wrapper
    assert (ops["scales"] is not None) == (int8 or int8_dep)
    jgen = JGen(jm, delays=jm.delays, use_sampling=False, kv_unstacked=True, kv_int8=kv_int8)
    jstate = JState(mimi=jmimi, mimi_params=mimi_params, lm_gen=jgen, lm_params=lm_params)
    tstate = ServerState(tmimi, LMGen(tm, delays=tm.delays, use_sampling=False, kv_int8=kv_int8))
    return jstate, tstate


def check_frames_teacher_forced(jstate, tstate, monkeypatch, n_frames=6):
    """``n_frames`` 80 ms frames through ServerState._fused_frame on both
    sides. The port is teacher-forced on the JAX token stream; every sampled
    logits row (text, then 8 audio codebooks, per frame) and the audio must
    agree."""
    import rstnet_tpu.inference.generate as jgen_mod
    import rstnet_tpu_torch.inference.generate as tgen_mod

    traced = []
    jsample = jgen_mod.sample_token

    def record_jax(key, logits, *args, **kwargs):
        traced.append(logits)
        return jsample(key, logits, *args, **kwargs)

    monkeypatch.setattr(jgen_mod, "sample_token", record_jax)

    def jax_frame(mp, lp, state, chunk):
        traced.clear()
        audio, out, state = jstate._fused_frame(mp, lp, state, chunk)
        return audio, out, state, list(traced)

    jframe = jax.jit(jax_frame)
    forced, recorded = [], []
    tsample = tgen_mod.sample_token

    def teacher_forced(logits, generator, *args, **kwargs):
        recorded.append((logits.float(), tsample(logits, generator, *args, **kwargs)))
        return forced.pop(0)

    monkeypatch.setattr(tgen_mod, "sample_token", teacher_forced)
    rng = np.random.default_rng(3)
    jst = jstate._state
    flips = 0
    for t in range(n_frames):
        pcm = rng.normal(0, 0.1, 1920).astype(np.float32)
        jaudio, jout, jst, jlogits = jframe(jstate.mimi_params, jstate.lm_params, jst,
                                            jnp.asarray(pcm).reshape(1, 1, -1))
        jlogits = [np.asarray(lg, np.float32) for lg in jlogits]
        assert len(jlogits) == 9  # text + 8 codebooks
        forced[:] = [torch.from_numpy(np.argmax(lg, -1)) for lg in jlogits]
        recorded.clear()
        taudio, ttok = tstate.handle_frame_array(pcm)
        assert not forced and len(recorded) == 9
        for want, (got, own_choice) in zip(jlogits, recorded):
            _close(got, want)
            top2 = np.sort(want, -1)[..., -2:]
            clear = (top2[..., 1] - top2[..., 0]) > 2 * LM_TOL * max(1.0, np.abs(want).max())
            flips += int(((own_choice.numpy() != np.argmax(want, -1)) & clear).sum())
        if t < 1:  # max_delay warmup: nothing emitted yet
            assert taudio is None
            continue
        assert ttok == int(np.asarray(jout)[0, 0, 0])
        assert taudio.shape == (1920,) and np.isfinite(taudio).all()
        np.testing.assert_allclose(taudio, np.asarray(jaudio)[0, 0], rtol=0, atol=AUDIO_TOL)
    assert flips == 0


def test_serving_frame_matches_jax_teacher_forced(monkeypatch):
    """Six 80 ms frames through ServerState._fused_frame on both sides
    (``check_frames_teacher_forced``)."""
    check_frames_teacher_forced(*_slice_pair(monkeypatch), monkeypatch)


# the per-step FFN's cases at T == 1 that K2 does not take: (rows,
# dim_feedforward, int8, dtype). dim_feedforward 192 gives a gating hidden of
# 128 (on K2's grid), 160 one of 106 (off it); int8 weights never take K2.
STEP_FFN_FALLBACKS = {"off_grid_bf16": (64, 160, False, "bf16"),
                      "off_grid": (3, 160, False, "f32"), "int8": (3, 192, True, "f32")}


@pytest.mark.parametrize("case", sorted(STEP_FFN_FALLBACKS))
def test_step_ffn_fallback_matches_jax_ffn(monkeypatch, case):
    """The depformer's per-step FFN at T == 1 where K2's route does not take
    it: a hidden off the 128 grid (bf16 at 64 rows, f32), int8 weights. The
    view-based fallback (``step_gated_ffn``) against the JAX ``_ffn`` (its
    einsum branch: ``use_pallas_ffn`` is off without a TPU), at steps inside and past
    [0, S): float32 within 1e-5 (the same float32 math summed in another
    order); bf16 within 2e-2 of the output's scale (both sides round the
    gate, the value and the hidden to bf16, from sums in other orders)."""
    import rstnet_tpu_torch.modules.transformer as tmod
    from rstnet_tpu.modules.transformer import StreamingTransformer as JT
    from rstnet_tpu.modules.transformer import quantize_transformer_int8 as jax_quantize

    rows, ff, int8, dtype = STEP_FFN_FALLBACKS[case]
    jdtype, tdtype = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (jnp.float32,
                                                                              torch.float32)
    cfg = dict(d_model=128, num_heads=2, num_layers=1, dim_feedforward=ff, causal=True,
               context=None, gating="silu", norm="rms_norm_f32", positional_embedding="none",
               weights_per_step=4)
    jm = JT(**cfg)
    params = jm.init(jax.random.PRNGKey(9), jdtype)
    tm = _load(params, tmod.StreamingTransformer(**cfg, dtype=tdtype))
    if int8:
        params = jax_quantize(params)
        tmod.quantize_transformer_int8(tm)
    layer = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    calls = []
    real = tmod.step_gated_ffn
    monkeypatch.setattr(tmod, "step_gated_ffn", lambda *a: calls.append(a[3]) or real(*a))
    monkeypatch.setattr(tmod, "gating_ffn_step", None)  # K2's route must not be taken
    x = jnp.asarray(np.random.default_rng(10).normal(size=(rows, 1, 128)), jdtype)
    for offset in (0, 3, 6):
        want = jm._ffn(layer, x, offset)
        got = tm._ffn(0, torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(tdtype), offset)
        if dtype == "bf16":
            _close(got, want)
        else:
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-5)
    assert calls == [0, 3, 6]
