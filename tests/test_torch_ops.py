"""Leaf ops of the PyTorch port against the JAX package: norms, RoPE, gating,
ring attention, sampling and the streaming convolutions. Inputs come from a
seeded numpy generator and go through both sides.

Tolerances: float32 ops that run the same arithmetic in another library
(XLA:CPU vs ATen) agree to a few float32 ulps, so 1e-5 (relative and
absolute) unless a test states otherwise; integer outputs must be equal."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu_torch.core import from_jax_params

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _load(params, module):
    return from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, module)


@pytest.mark.parametrize("kind", ["rms_norm", "rms_norm_f32", "layer_norm", "layer_norm_f32"])
def test_norms_match_jax(kind):
    from rstnet_tpu.ops.norms import LayerScale as JLS, Norm as JNorm
    from rstnet_tpu_torch.ops.norms import LayerScale, Norm

    rng = _rng(1)
    x = rng.normal(size=(2, 3, 16)).astype(np.float32)
    params = JNorm(kind, 16).init(None)
    params = {k: v + 0.1 * rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()}
    want = JNorm(kind, 16)(params, jnp.asarray(x))
    got = _load(params, Norm(kind, 16))(_t(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    ls = {"scale": rng.normal(size=(16,)).astype(np.float32)}
    np.testing.assert_allclose(_np(_load(ls, LayerScale(16))(_t(x))),
                               _np(JLS(16)(ls, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("offset", [0, 37])
def test_rope_interleaved_matches_jax(offset):
    from rstnet_tpu.ops.rope import apply_rope_interleaved as jrope
    from rstnet_tpu_torch.ops.rope import apply_rope_interleaved

    rng = _rng(2)
    q = rng.normal(size=(2, 4, 5, 16)).astype(np.float32)
    k = rng.normal(size=(2, 4, 5, 16)).astype(np.float32)
    jq, jk = jrope(jnp.asarray(q), jnp.asarray(k), offset, 10_000.0)
    tq, tk = apply_rope_interleaved(_t(q), _t(k), offset, 10_000.0)
    np.testing.assert_allclose(_np(tq), _np(jq), **TOL)
    np.testing.assert_allclose(_np(tk), _np(jk), **TOL)


@pytest.mark.parametrize("activation", ["silu", "gelu", "sigmoid", "relu", "mish"])
def test_activation_gating_matches_jax(activation):
    from rstnet_tpu.ops.gating import ActivationGating as JG, gating_hidden_dim as jhid
    from rstnet_tpu_torch.ops.gating import ActivationGating, gating_hidden_dim

    assert gating_hidden_dim(16, 64) == jhid(16, 64) and gating_hidden_dim(16, 48) == jhid(16, 48)
    params = JG(16, 48, activation).init(jax.random.PRNGKey(0))
    x = _rng(3).normal(size=(2, 3, 16)).astype(np.float32)
    want = JG(16, 48, activation)(params, jnp.asarray(x))
    got = _load(params, ActivationGating(16, 48, activation))(_t(x))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_ring_positions_match_jax():
    from rstnet_tpu.ops.attention import ring_positions as jpos
    from rstnet_tpu_torch.ops.attention import ring_positions

    for end in (0, 1, 5, 7, 8, 23):
        np.testing.assert_array_equal(ring_positions(7, end).numpy(), np.asarray(jpos(7, end)))


@pytest.mark.parametrize("chunk", [1, 2])
def test_ring_attention_stream_matches_jax(chunk):
    """Ring writes + windowed-causal attention over a stream that wraps the
    ring several times; chunk 2 uses a ring with one spare slot."""
    from rstnet_tpu.ops import attention as ja
    from rstnet_tpu_torch.ops import attention as ta

    B, H, D, context = 2, 2, 8, 5
    cap = context + chunk - 1
    rng = _rng(4)
    jcache = ja.ring_kv_buffers((B, H, cap, D), jnp.float32)
    tcache = ta.ring_kv_buffers((B, H, cap, D), torch.float32)
    end = 0
    for _ in range(9):
        q, k, v = (rng.normal(size=(B, H, chunk, D)).astype(np.float32) for _ in range(3))
        jcache, jpos_k, _ = ja.ring_kv_update(jcache, jnp.int32(end), jnp.asarray(k), jnp.asarray(v))
        tcache, tpos_k, _ = ta.ring_kv_update(tcache, end, _t(k), _t(v))
        np.testing.assert_array_equal(tpos_k.numpy(), np.asarray(jpos_k))
        pos_q = np.arange(chunk) + end
        want = ja.masked_attention(jnp.asarray(q), jcache["k"], jcache["v"], jnp.asarray(pos_q),
                                   jpos_k, context, True)
        got = ta.masked_attention(_t(q), tcache["k"], tcache["v"], torch.from_numpy(pos_q),
                                  tpos_k, context, True)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        end += chunk


def test_masked_attention_min_pos_and_gqa_match_jax():
    from rstnet_tpu.ops.attention import masked_attention as jattn
    from rstnet_tpu_torch.ops.attention import masked_attention

    rng = _rng(5)
    q = rng.normal(size=(2, 4, 1, 8)).astype(np.float32)
    k = rng.normal(size=(2, 2, 6, 8)).astype(np.float32)
    v = rng.normal(size=(2, 2, 6, 8)).astype(np.float32)
    pos_k = np.array([6, 7, 8, 9, 4, 5])
    pos_q = np.array([9])
    min_pos = np.array([0, 7])
    want = jattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos_q),
                 jnp.asarray(pos_k), 5, True, min_pos=jnp.asarray(min_pos))
    got = masked_attention(_t(q), _t(k), _t(v), torch.from_numpy(pos_q),
                           torch.from_numpy(pos_k), 5, True, min_pos=torch.from_numpy(min_pos))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


def test_masked_attention_bf16_matches_jax():
    """bf16 q against a float32 cache, as the LM's first layer runs: logits
    from bf16-rounded inputs in float32. 1e-2: the float32 output of a
    bf16-input product differs only in accumulation order."""
    from rstnet_tpu.ops.attention import masked_attention as jattn
    from rstnet_tpu_torch.ops.attention import masked_attention

    rng = _rng(6)
    q = rng.normal(size=(1, 2, 1, 16)).astype(np.float32)
    k = rng.normal(size=(1, 2, 4, 16)).astype(np.float32)
    v = rng.normal(size=(1, 2, 4, 16)).astype(np.float32)
    pos = np.arange(4)
    want = jattn(jnp.asarray(q, jnp.bfloat16), jnp.asarray(k), jnp.asarray(v),
                 jnp.asarray(pos[-1:]), jnp.asarray(pos), None, True)
    got = masked_attention(_t(q).bfloat16(), _t(k), _t(v), torch.from_numpy(pos[-1:]),
                           torch.from_numpy(pos), None, True)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-2, atol=1e-2)


def test_multi_linear_matches_jax():
    from rstnet_tpu.ops.attention import multi_linear as jml
    from rstnet_tpu_torch.ops.attention import multi_linear

    rng = _rng(7)
    w = rng.normal(size=(4, 6, 5)).astype(np.float32)
    x = rng.normal(size=(2, 3, 5)).astype(np.float32)
    for offset in (0, 2):  # offset 2: the last step clips to weight 3
        np.testing.assert_allclose(_np(multi_linear(_t(w), _t(x), offset)),
                                   _np(jml(jnp.asarray(w), jnp.asarray(x), offset)), **TOL)


def test_sampling_greedy_matches_jax_and_draws_stay_in_support():
    from rstnet_tpu.ops.sampling import sample_token as jsample
    from rstnet_tpu_torch.ops.sampling import sample_token

    rng = _rng(8)
    logits = rng.normal(size=(3, 300)).astype(np.float32)
    logits[1, [5, 9]] = 10.0  # a tie: the first index wins on both sides
    for max_card in (None, 200):
        want = jsample(jax.random.PRNGKey(0), jnp.asarray(logits), False, max_card=max_card)
        got = sample_token(_t(logits), None, False, max_card=max_card)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = torch.Generator().manual_seed(0)
    support = np.asarray(jax.lax.top_k(jnp.asarray(logits), 5)[1])
    draws = torch.stack([sample_token(_t(logits), g, True, 0.8, 5) for _ in range(200)])
    for row in range(3):
        assert set(draws[:, row].tolist()) <= set(support[row].tolist())
    assert len(set(draws[:, 0].tolist())) > 1  # it does sample
    # top-p: every draw lies in the smallest prefix of the sorted
    # probabilities whose mass reaches p (the same nucleus rule as JAX)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits) / 0.8, axis=-1))
    order = np.argsort(-probs, axis=-1)
    cum = np.cumsum(np.take_along_axis(probs, order, -1), -1)
    draws = torch.stack([sample_token(_t(logits), g, True, 0.8, top_p=0.5) for _ in range(200)])
    for row in range(3):
        nucleus = order[row, : int(np.searchsorted(cum[row], 0.5)) + 1]
        assert set(draws[:, row].tolist()) <= set(nucleus.tolist())


def _tied_logit_rows(seed, rows, card):
    """bf16-rounded normal logits: many values share a bf16 step, so ties
    straddle the k-th place of the top-k cases below."""
    x = _rng(seed).normal(size=(rows, card)).astype(np.float32)
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _jax_top_k(logits, k):
    """``rstnet_tpu/ops/sampling.py::sample_token``'s top-k selection."""
    x = jnp.asarray(logits)
    if logits.shape[-1] >= 4 * k:
        return jax.lax.approx_max_k(x, k, recall_target=0.99)
    return jax.lax.top_k(x, k)


@pytest.mark.parametrize("card,k", [(2048, 250), (2048, 25), (64, 25)])
def test_top_k_keeps_jax_indices_in_jax_order(card, k):
    """Kept set and order equal JAX's on rows whose k-th place falls inside
    a run of equal values (lower index first among ties)."""
    from rstnet_tpu_torch.ops.sampling import select_top_k

    logits = _tied_logit_rows(20 + k, 16, card)
    want_v, want_i = _jax_top_k(logits, k)
    kth = np.asarray(want_v)[:, -1:]
    assert ((logits == kth).sum(-1) > 1).any()  # a tie at the k-th place
    got_v, got_i = select_top_k(_t(logits), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


def test_top_p_sort_order_matches_jax_argsort():
    from rstnet_tpu_torch.ops.sampling import sort_descending

    probs = np.asarray(jax.nn.softmax(jnp.asarray(_tied_logit_rows(21, 16, 2048)), axis=-1))
    assert any(len(np.unique(r)) < r.size for r in probs)  # tied probabilities
    _, got = sort_descending(_t(probs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argsort(-jnp.asarray(probs), -1)))


@pytest.mark.parametrize("mode", ["top_k_250", "top_k_25", "top_p"])
def test_sample_token_picks_jax_entry_for_a_fixed_choice(monkeypatch, mode):
    """With the categorical draw fixed, the port returns the entry JAX's
    kept list holds at that place (``top_idx[choice]`` or
    ``sort_idx[choice]``)."""
    from rstnet_tpu_torch.ops import sampling

    logits = _tied_logit_rows(22, 16, 2048)
    temp = 0.8
    if mode == "top_p":
        probs = jax.nn.softmax(jnp.asarray(logits) / temp, axis=-1)
        kept = np.asarray(jnp.argsort(-probs, axis=-1))
        kwargs = dict(top_p=0.9)
    else:
        k = int(mode.rsplit("_", 1)[1])
        kept = np.asarray(_jax_top_k(logits, k)[1])
        kwargs = dict(top_k=k)
    for choice in (0, 3, 24):
        monkeypatch.setattr(sampling, "_categorical",
                            lambda x, g, c=choice: torch.full(x.shape[:-1], c, dtype=torch.long))
        got = sampling.sample_token(_t(logits), None, True, temp, **kwargs)
        np.testing.assert_array_equal(got.numpy(), kept[:, choice])


CONV_CASES = [
    dict(in_channels=3, out_channels=5, kernel_size=7),
    dict(in_channels=4, out_channels=6, kernel_size=4, stride=2),
    dict(in_channels=4, out_channels=4, kernel_size=3, dilation=2, groups=2),
    dict(in_channels=4, out_channels=4, kernel_size=4, stride=2, bias=False,
         pad_mode="replicate"),
    dict(in_channels=2, out_channels=3, kernel_size=5, norm="weight_norm"),
    dict(in_channels=3, out_channels=3, kernel_size=5, pad_mode="reflect"),
]


@pytest.mark.parametrize("cfg", CONV_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_streaming_conv1d_offline_and_steps_match_jax(cfg):
    from rstnet_tpu.ops.conv import StreamingConv1d as JC
    from rstnet_tpu_torch.ops.conv import StreamingConv1d

    jc = JC(**cfg, causal=True)
    params = jc.init(jax.random.PRNGKey(0))
    tc = _load(params, StreamingConv1d(**cfg, causal=True))
    x = _rng(9).normal(size=(2, cfg["in_channels"], 24)).astype(np.float32)
    np.testing.assert_allclose(_np(tc(_t(x))), _np(jc(params, jnp.asarray(x))), **TOL)
    js, ts = jc.init_state(2), tc.init_state(2)
    for i in range(3):
        chunk = x[..., 8 * i : 8 * (i + 1)]
        jy, js = jc.step(params, js, jnp.asarray(chunk))
        ty, ts = tc.step(ts, _t(chunk))
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)


@pytest.mark.parametrize("cfg", [dict(in_channels=4, out_channels=3, kernel_size=4, stride=2),
                                 dict(in_channels=4, out_channels=4, kernel_size=4, stride=2,
                                      groups=4, bias=False),
                                 dict(in_channels=3, out_channels=2, kernel_size=3)])
def test_streaming_conv_transpose1d_offline_and_steps_match_jax(cfg):
    from rstnet_tpu.ops.conv import StreamingConvTranspose1d as JC
    from rstnet_tpu_torch.ops.conv import StreamingConvTranspose1d

    jc = JC(**cfg, causal=True)
    params = jc.init(jax.random.PRNGKey(1))
    tc = _load(params, StreamingConvTranspose1d(**cfg, causal=True))
    x = _rng(10).normal(size=(2, cfg["in_channels"], 9)).astype(np.float32)
    np.testing.assert_allclose(_np(tc(_t(x))), _np(jc(params, jnp.asarray(x))), **TOL)
    js, ts = jc.init_state(2), tc.init_state(2)
    for i in range(3):
        chunk = x[..., 3 * i : 3 * (i + 1)]
        jy, js = jc.step(params, js, jnp.asarray(chunk))
        ty, ts = tc.step(ts, _t(chunk))
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
