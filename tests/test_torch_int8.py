"""int8 serving in the PyTorch port against the JAX package: weight-only int8
(``quantize_weight_int8``, ``quantize_transformer_int8``, ``resolve_weight``,
the int8 text head), the int8 ring K/V (``quantize_kv``, the ring update,
``masked_attention`` with scales), K1's int8 variant, ``LMGen`` with
``kv_int8`` and ``audio_max_card``, the server's int8 options, and whole solo
frames and batched ticks under them.

Tolerances. Quantized codes and scales are equal: both sides run the same
float32 operations (max, divide, round half to even, clip) on the same
numpy inputs. K1-int8's plain version is held to the Pallas kernel in
interpret mode within 2e-2, the Pallas int8 test's own tolerance (bf16
rounding of GEMV inputs under two summation orders). Whole frames are held
as in ``test_torch_moshi.py`` (logits within 2e-2 of their scale, audio
within 1e-3, greedy tokens equal past the top-2 margin): K/V come out of
matmuls summed in another order, so an int8 K/V code may differ by one at
a rounding boundary. The batched tick is float32: tokens equal, audio
within 1e-5, as in ``test_torch_batcher.py``."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu_torch.core import from_jax_params, to_numpy
from tests.test_torch_moshi import (
    MOSHI,
    _close,
    _slice_pair,
    check_frames_teacher_forced,
    jax_main_quantize,
)

K1_TOL = dict(rtol=2e-2, atol=2e-2)
AUDIO_TOL = 1e-5


def _load(params, module):
    return from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, module)


def _np(a):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) and a.is_floating_point() else a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _jax_model(cfg, dtype=jnp.bfloat16, key=1):
    from rstnet_tpu.models.moshi_lm import MoshiLMModel as JM

    jm = JM(**cfg)
    return jm, jm.init(jax.random.PRNGKey(key), dtype)


def _port_model(cfg, params, dtype=torch.bfloat16, **int8):
    """The port's MoshiLMModel in the layout of ``quantize_for_serving(**int8)``,
    holding ``params`` (quantized the same way on the JAX side)."""
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
    from rstnet_tpu_torch.serving.server import quantize_for_serving

    return _load(params, quantize_for_serving(MoshiLMModel(**cfg, dtype=dtype), **int8))


# -- weight-only int8 ----------------------------------------------------------


@pytest.mark.parametrize("shape,dtype", [((48, 32), "float32"), ((3, 40, 16), "bfloat16"),
                                         ((2, 3, 24, 32), "bfloat16")])
def test_quantize_weight_int8_and_resolve_equal_jax(shape, dtype):
    from rstnet_tpu.modules.transformer import quantize_weight_int8 as jq, resolve_weight as jr
    from rstnet_tpu_torch.modules.transformer import quantize_weight_int8, resolve_weight

    w = np.random.default_rng(0).normal(0, 0.05, shape).astype(np.float32)
    w[(0,) * (w.ndim - 1)] = 0.0  # an all-zero row takes the 1e-8 floor
    jw = jnp.asarray(w, getattr(jnp, dtype))
    tw = torch.from_numpy(np.asarray(jw.astype(jnp.float32))).to(getattr(torch, dtype))
    jd, tq = jq(jw), quantize_weight_int8(tw)
    assert tq.w_int8.dtype == torch.int8 and tq.scale.dtype == torch.float32
    np.testing.assert_array_equal(tq.w_int8.numpy(), np.asarray(jd["w_int8"]))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jd["scale"]))
    for act in ("float32", "bfloat16"):
        np.testing.assert_array_equal(_np(resolve_weight(tq, getattr(torch, act))),
                                      _np(jr(jd, getattr(jnp, act))))
    # an index of the stack resolves as the same index of the resolved stack
    np.testing.assert_array_equal(_np(resolve_weight(tq[1], torch.bfloat16)),
                                  _np(jr(jd, jnp.bfloat16)[1]))


@pytest.mark.parametrize("cfg", [
    dict(gating="silu", weights_per_step=4),  # the depformer: per-step weights
    dict(gating="silu"),  # the backbone
    dict(gating="none"),  # linear1/linear2
])
def test_quantize_transformer_int8_and_step_match_jax(cfg):
    """The quantized transformer's state_dict is the JAX quantized tree (keys
    and values), and a streaming step over it matches JAX."""
    from rstnet_tpu.modules.transformer import (
        StreamingTransformer as JT,
        quantize_transformer_int8 as jqt,
    )
    from rstnet_tpu_torch.modules.transformer import (
        StreamingTransformer,
        quantize_transformer_int8,
    )

    kw = dict(d_model=32, num_heads=4, num_layers=2, dim_feedforward=64, causal=True,
              context=8, norm="rms_norm_f32", positional_embedding="rope", **cfg)
    jt = JT(**kw)
    params = jt.init(jax.random.PRNGKey(0))
    tt = _load(params, StreamingTransformer(**kw))
    jq, tq = jqt(params), quantize_transformer_int8(tt)
    want = {k: np.asarray(v) for k, v in flatten_dict(jq)}
    got = to_numpy(tq)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    x = np.random.default_rng(1).normal(size=(2, 3, 32)).astype(np.float32)
    jst, tst = jt.init_state(2, jnp.float32), tq.init_state(2, torch.float32)
    for t in range(3):
        jy, jst = jt.step(jq, jst, jnp.asarray(x[:, t : t + 1]))
        ty, tst = tq.step(tst, torch.from_numpy(x[:, t : t + 1]))
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)


def test_int8_per_step_ffn_bypasses_k2(monkeypatch):
    """As in JAX, an int8 per-step FFN takes the dequantizing gather path,
    even at T == 1 inside K2's shape envelope."""
    import rstnet_tpu_torch.modules.transformer as tmod

    calls = []
    monkeypatch.setattr(tmod, "gating_ffn_step", lambda *a, **k: calls.append(1))
    tt = tmod.StreamingTransformer(d_model=128, num_heads=2, num_layers=1,
                                   dim_feedforward=192, causal=True, gating="silu",
                                   norm="rms_norm_f32", positional_embedding="none",
                                   weights_per_step=2)
    tmod.quantize_transformer_int8(tt)
    y, _ = tt.step(tt.init_state(2, torch.float32), torch.randn(2, 1, 128))
    assert not calls and y.shape == (2, 1, 128) and torch.isfinite(y).all()


def test_moshi_text_linear_int8_head():
    """Mirror of ``tests/test_moshi_lm.py::test_moshi_text_linear_int8_head``:
    the int8 head scales the logits after the product and stays close to the
    float head; the port's int8 logits equal JAX's to float32 rounding."""
    from rstnet_tpu_torch.serving.server import quantize_for_serving

    cfg = dict(delays=(0,) * 9, n_q=8, dep_q=4, card=16, text_card=64, dim=32, num_heads=4,
               num_layers=1, hidden_scale=4.0, context=16, existing_text_padding_id=3,
               depformer_dim=16, depformer_dim_feedforward=32, depformer_num_heads=2,
               depformer_num_layers=1)
    jm, params = _jax_model(cfg, jnp.float32, key=0)
    tm = _port_model(cfg, params, torch.float32)
    hidden = np.random.default_rng(1).normal(size=(2, 3, 32)).astype(np.float32)
    ref = tm._text_logits(torch.from_numpy(hidden))
    quantize_for_serving(tm, int8_head=True)
    got = tm._text_logits(torch.from_numpy(hidden))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=0.05, rtol=0.1)
    want = jm._text_logits(jax_main_quantize(params, int8_head=True), jnp.asarray(hidden))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# -- int8 ring K/V -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_equals_jax(dtype):
    from rstnet_tpu.ops.attention import quantize_kv as jqkv
    from rstnet_tpu_torch.ops.attention import quantize_kv

    x = np.random.default_rng(2).normal(0, 3.0, (2, 3, 5, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    (jq, js), (tq, ts) = jqkv(jx), quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_np(ts), _np(js))


def test_ring_kv_update_int8_equals_jax():
    """Single-step and chunked writes, wrapping the ring: codes and scales
    equal JAX's buffers, positions too."""
    from rstnet_tpu.ops.attention import ring_kv_buffers as jbuf, ring_kv_update as jupd
    from rstnet_tpu_torch.ops.attention import ring_kv_buffers, ring_kv_update

    shape = (2, 3, 6, 8)
    jc, tc = jbuf(shape, kv_int8=True), ring_kv_buffers(shape, kv_int8=True)
    assert {k: v.dtype for k, v in tc.items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.bfloat16, "v_scale": torch.bfloat16}
    assert tuple(tc["k_scale"].shape) == (2, 3, 6)
    rng = np.random.default_rng(3)
    end = 0
    for T in (1, 3, 1, 4, 1):
        k, v = (rng.normal(size=(2, 3, T, 8)).astype(np.float32) for _ in range(2))
        jc, jpos, _ = jupd(jc, jnp.asarray(end), jnp.asarray(k), jnp.asarray(v))
        tc, tpos, end = ring_kv_update(tc, end, torch.from_numpy(k), torch.from_numpy(v))
        np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
        for name in tc:
            np.testing.assert_array_equal(_np(tc[name]), _np(jc[name]), err_msg=name)


@pytest.mark.parametrize("q_dtype", ["float32", "bfloat16"])
def test_masked_attention_int8_matches_jax(q_dtype):
    """Scaled int8 K/V with GQA, a window and a per-row floor, against the
    JAX dtypes: float32 logits times the float32 k_scale; weights in q's
    dtype times v_scale in q's dtype. bf16 products round at other places in
    XLA and ATen: float32 within 1e-5, bf16 within 2**-7 of the scale."""
    from rstnet_tpu.ops.attention import masked_attention as jattn, quantize_kv as jqkv
    from rstnet_tpu_torch.ops.attention import masked_attention

    rng = np.random.default_rng(4)
    jdt, tdt = getattr(jnp, q_dtype), getattr(torch, q_dtype)
    q = jnp.asarray(rng.normal(size=(2, 4, 3, 16)), jdt)
    (k, ks), (v, vs) = (jqkv(jnp.asarray(rng.normal(size=(2, 2, 7, 16)))) for _ in range(2))
    pos_q, pos_k = jnp.arange(4, 7), jnp.asarray([0, 1, 2, 3, 4, 5, 6])
    min_pos = jnp.asarray([0, 3])
    want = jattn(q, k, v, pos_q, pos_k, 5, True, min_pos=min_pos, k_scale=ks, v_scale=vs)

    def t(a):
        a = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        return torch.from_numpy(a)

    got = masked_attention(t(q).to(tdt), t(k), t(v), t(pos_q), t(pos_k), 5, True,
                           min_pos=t(min_pos), k_scale=t(ks).bfloat16(), v_scale=t(vs).bfloat16())
    assert got.dtype == tdt
    tol = 1e-5 if q_dtype == "float32" else 2.0**-7
    _close(got, want, tol)


# -- K1's int8 variant ---------------------------------------------------------


def _k1_int8_models(bias=True):
    """The Moshi layout of ``tests/test_torch_depformer.py`` with its
    depformer slice quantized on both sides (``--int8-dep``)."""
    from tests.test_torch_depformer import MOSHI as DEP

    cfg = dict(DEP, bias_proj=bias)
    jm, params = _jax_model(cfg, key=0)
    if bias:
        params["linears"]["bias"] = 0.1 * jax.random.normal(
            jax.random.PRNGKey(9), params["linears"]["bias"].shape, jnp.bfloat16)
    params = jax_main_quantize(params, int8_dep=True)
    return jm, params, _port_model(cfg, params, int8_dep=True)


NAMES = ("norm1", "in_proj", "out_proj", "norm2", "gin", "gout", "head_w", "head_b")
WEIGHTS = ("in_proj", "out_proj", "gin", "gout", "head_w")


def test_kernel_operands_int8_and_mixed():
    """All five stacks int8: codes and float32 scales [..., rows, 1], equal
    to the JAX operands. Some int8: None (the step_codecformer path), as the
    JAX function (``tests/test_pallas_depformer.py:283-302``)."""
    from rstnet_tpu.ops.pallas_depformer import depformer_kernel_operands as jax_operands
    from rstnet_tpu_torch.modules.transformer import quantize_param_int8
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_kernel_operands
    from tests.test_torch_depformer import _models

    jm, params, tm = _k1_int8_models()
    jops, tops = jax_operands(jm, params), depformer_kernel_operands(tm)
    assert tops["scales"] is not None and jops["scales"] is not None
    for k in NAMES:
        np.testing.assert_array_equal(_np(tops[k]), _np(jops[k]), err_msg=k)
    for k in WEIGHTS:
        assert tops[k].dtype == torch.int8 and tops["scales"][k].dtype == torch.float32
        np.testing.assert_array_equal(tops["scales"][k].numpy(), np.asarray(jops["scales"][k]))
    _, _, mixed = _models()
    quantize_param_int8(mixed.linears, "weight")  # the head alone
    assert depformer_kernel_operands(mixed) is None


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_k1_int8_plain_matches_pallas_interpret(cache_dtype):
    """A frame of 8 micro-steps, teacher-forced: the plain int8 micro-step
    against ``depformer_step_pallas(scales=..., interpret=True)`` and against
    ``depformer_frame_reference`` on the dequantized weights (mirror of
    ``tests/test_pallas_depformer.py:216``)."""
    from rstnet_tpu.ops.pallas_depformer import (
        depformer_frame_reference,
        depformer_kernel_operands as jax_operands,
        depformer_step_pallas,
    )
    from rstnet_tpu_torch.ops.cuda_depformer import depformer_kernel_operands, depformer_step

    jm, params, tm = _k1_int8_models()
    jops, tops = jax_operands(jm, params), depformer_kernel_operands(tm)
    L, S, C = jops["L"], jops["S"], jops["C"]
    x = np.random.default_rng(5).normal(size=(S, 1, C)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jdt, tdt = getattr(jnp, cache_dtype), getattr(torch, cache_dtype)
    jkc = jvc = jnp.zeros((L, S, C), jdt)
    tkc, tvc = torch.zeros((L, S, C), dtype=tdt), torch.zeros((L, S, C), dtype=tdt)
    tlogits = []
    for cb in range(S):
        jl, jkc, jvc = depformer_step_pallas(
            xb[cb], jnp.int32(cb), *(jops[k] for k in NAMES), jkc, jvc, heads=jops["heads"],
            eps=jops["eps"], scales=jops["scales"], interpret=True)
        tl, tkc, tvc = depformer_step(
            torch.from_numpy(x[cb]).bfloat16(), cb, *(tops[k] for k in NAMES), tkc, tvc,
            heads=tops["heads"], eps=tops["eps"], scales=tops["scales"])
        np.testing.assert_allclose(_np(tl), _np(jl), **K1_TOL)
        tlogits.append(_np(tl))
    np.testing.assert_allclose(_np(tkc), _np(jkc), **K1_TOL)
    np.testing.assert_allclose(_np(tvc), _np(jvc), **K1_TOL)
    deq = {**jops, **{k: jops[k].astype(jnp.float32) * jops["scales"][k] for k in WEIGHTS}}
    ref, _, _ = depformer_frame_reference(deq, xb, jnp.zeros((L, S, C), jdt),
                                          jnp.zeros((L, S, C), jdt))
    np.testing.assert_allclose(np.stack(tlogits), _np(ref), **K1_TOL)


def test_k1_int8_cuda_operand_checks():
    """The CUDA envelope of the int8 variant: int8 weights with float32
    scales of one per row; bf16 weights with scales, or a missing scale, are
    refused."""
    from rstnet_tpu_torch.ops.cuda_depformer import _check_cuda_operands, depformer_kernel_operands

    _, _, tm = _k1_int8_models(bias=False)
    ops = depformer_kernel_operands(tm)
    L, S, C = ops["L"], ops["S"], ops["C"]
    kc = torch.zeros((L, S, C))
    args = [torch.zeros((1, C), dtype=torch.bfloat16), 0, *(ops[k] for k in NAMES), kc,
            kc.clone(), ops["heads"]]
    _check_cuda_operands(*args, scales=ops["scales"])  # the path's operands pass
    with pytest.raises(ValueError):
        _check_cuda_operands(*args)  # int8 weights without scales
    for bad in ({k: v for k, v in ops["scales"].items() if k != "gout"},
                {**ops["scales"], "gin": ops["scales"]["gin"].bfloat16()},
                {**ops["scales"], "head_w": ops["scales"]["head_w"][..., 0]}):
        with pytest.raises(ValueError):
            _check_cuda_operands(*args, scales=bad)


# -- LMGen ---------------------------------------------------------------------


@pytest.mark.parametrize("edit", ["quantize", "pad"])
def test_lmgen_follows_in_place_weight_changes(monkeypatch, edit):
    """An LMGen that has stepped, then an in-place change of the model
    (int8 quantization, or padding the gating into K1's envelope): the next
    step runs K1 on the new weights and equals a fresh LMGen over the
    changed model."""
    import rstnet_tpu_torch.inference.generate as gen_mod
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
    from rstnet_tpu_torch.modules.transformer import pad_codecformer_gating
    from rstnet_tpu_torch.serving.server import quantize_for_serving

    cfg = dict(MOSHI, depformer_dim_feedforward=192 if edit == "quantize" else 150)
    tm = MoshiLMModel(**cfg, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    seen = []  # one entry per K1 call: whether it ran the int8 variant
    real = gen_mod.depformer_step

    def spy(*args, scales=None, **kwargs):
        seen.append(scales is not None)
        return real(*args, scales=scales, **kwargs)

    monkeypatch.setattr(gen_mod, "depformer_step", spy)
    user = torch.from_numpy(np.random.default_rng(6).integers(0, 128, (2, 1, 8, 1)))
    gen = LMGen(tm, delays=tm.delays, use_sampling=False)
    state = gen.init_state(1, torch.float32)
    gen.step(state, None, user[0])
    assert seen == ([False] * 8 if edit == "quantize" else [])  # H = 100 is outside K1
    if edit == "quantize":
        quantize_for_serving(tm, int8=True)
    else:
        pad_codecformer_gating(tm.depformer)
    fresh = LMGen(tm, delays=tm.delays, use_sampling=False)
    fresh_state = copy.deepcopy(state)
    seen.clear()
    got, _, _ = gen.step(state, None, user[1])
    want, _, _ = fresh.step(fresh_state, None, user[1])
    assert seen == [edit == "quantize"] * 16  # both ran K1, int8 after quantizing
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(state["lm"]["kv"][0]["k"], fresh_state["lm"]["kv"][0]["k"],
                               rtol=0, atol=0)


def test_audio_max_card_clamp():
    """Mirror of ``tests/test_generate.py::test_audio_max_card_clamp`` on
    the Moshi family: sampled audio ids stay below ``audio_max_card``."""
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    tm = MoshiLMModel(**dict(MOSHI, delays=(0,) * 9, n_q=8),
                      generator=torch.Generator().manual_seed(0))
    gen = LMGen(tm, use_sampling=True, audio_max_card=4, top_k=0, temp=1.0)
    state = gen.init_state(2, dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        out, valid, state = gen.step(state, g)
    assert (out[:, 1:] < 4).all()


SMALL = dict(delays=(0, 0) + (1,) * 3 + (0,) + (1,) * 3, n_q=8, dep_q=4, card=32, text_card=64,
             dim=32, num_heads=4, num_layers=2, hidden_scale=4.0, context=16,
             depformer_dim=16, depformer_dim_feedforward=32, depformer_num_heads=2,
             depformer_num_layers=2)


@pytest.mark.parametrize("n_frames,min_match", [(8, 6), (10, 7)])
def test_lmgen_kv_int8_close_to_exact(n_frames, min_match):
    """Mirrors of ``tests/test_moshi_lm.py::test_moshi_lmgen_kv_int8`` (8
    frames, 6 must match) and ``tests/test_generate.py::test_kv_int8_close_to_exact``
    (10 frames, 7): greedy frames with the int8 ring against the exact ring.
    The port's int8-ring frames also equal the JAX int8-ring LMGen's on
    every frame whose greedy choices have a clear margin (here: all)."""
    from rstnet_tpu.inference.generate import LMGen as JGen
    from rstnet_tpu_torch.inference.generate import LMGen

    jm, params = _jax_model(SMALL, jnp.float32, key=0)
    tm = _port_model(SMALL, params, torch.float32)
    gen = LMGen(tm, delays=tm.delays, use_sampling=False)
    gen8 = LMGen(tm, delays=tm.delays, use_sampling=False, kv_int8=True)
    jgen8 = JGen(jm, delays=jm.delays, use_sampling=False, kv_int8=True)
    s, s8 = gen.init_state(1, torch.float32), gen8.init_state(1, torch.float32)
    assert s8["lm"]["kv"][0]["k"].dtype == torch.int8
    js8 = jgen8.init_state(1, jnp.float32)
    step8 = jax.jit(jgen8.step)
    user = np.zeros((1, gen.num_user_streams, 1), np.int64)
    n_match = n_jax = 0
    for _ in range(n_frames):
        out, _, s = gen.step(s, None, torch.from_numpy(user))
        out8, _, s8 = gen8.step(s8, None, torch.from_numpy(user))
        jout8, _, js8 = step8(params, js8, jax.random.PRNGKey(2), jnp.asarray(user, jnp.int32))
        n_match += int(torch.equal(out, out8))
        n_jax += int((out8.numpy() == np.asarray(jout8)).all())
    assert n_match >= min_match, f"only {n_match}/{n_frames} greedy frames matched exact KV"
    assert n_jax == n_frames


# -- the server's options and whole slices -------------------------------------


COMBOS = [dict(), dict(int8=True), dict(int8_dep=True), dict(int8_head=True),
          dict(int8=True, int8_head=True), dict(int8_dep=True, int8_head=True),
          dict(int8=True, int8_dep=True)]


@pytest.mark.parametrize("flags", COMBOS, ids=lambda f: "+".join(f) or "none")
def test_quantize_for_serving_matches_jax_main(flags):
    """``quantize_for_serving`` quantizes exactly what the JAX ``main`` does
    for each flag combination: the same int8 leaves, codes and scales equal,
    every other weight untouched."""
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
    from rstnet_tpu_torch.serving.server import quantize_for_serving

    _, params = _jax_model(MOSHI)
    tm = _load(params, MoshiLMModel(**MOSHI, dtype=torch.bfloat16))
    got = to_numpy(quantize_for_serving(tm, **flags))
    want = {k: np.asarray(v) for k, v in flatten_dict(jax_main_quantize(params, **flags))}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    int8 = {k.rsplit(".", 1)[0] for k in got if k.endswith(".w_int8")}
    expect = set()
    if flags.get("int8") or flags.get("int8_dep"):
        expect |= {"depformer_in", "linears.weight", "depformer.layers.in_proj",
                   "depformer.layers.out_proj", "depformer.layers.gating.linear_in",
                   "depformer.layers.gating.linear_out"}
    if flags.get("int8"):
        expect |= {"transformer.layers.in_proj", "transformer.layers.out_proj",
                   "transformer.layers.gating.linear_in", "transformer.layers.gating.linear_out"}
    elif flags.get("int8_head"):
        expect.add("text_linear.weight")
    assert int8 == expect


@pytest.mark.parametrize("argv", [["--int8", "--kv-int8"], ["--int8-dep", "--int8-head"],
                                  ["--batch", "2", "--int8", "--kv-int8"]])
def test_main_applies_int8_options(monkeypatch, argv):
    """``main`` on the tiny pair on the CPU: it quantizes through
    ``quantize_for_serving``, passes --kv-int8 to LMGen, warms up (frames
    through the int8 path) and serves the app it built."""
    import aiohttp.web

    import rstnet_tpu_torch.serving.server as server

    served = {}
    for name in ("build_app", "build_batched_app"):
        real = getattr(server, name)
        monkeypatch.setattr(server, name, lambda obj, real=real: served.update(obj=obj) or real(obj))
    monkeypatch.setattr(aiohttp.web, "run_app", lambda app, **kw: served.update(app=app))
    server.main(["--tiny", "--device", "cpu", *argv])
    lm_gen = served["obj"].lm_gen
    assert "app" in served and lm_gen.kv_int8 == ("--kv-int8" in argv)
    names = {k.rsplit(".", 1)[0] for k in lm_gen.model.state_dict() if k.endswith(".w_int8")}
    assert ("depformer.layers.in_proj" in names) and ("linears.weight" in names)
    assert ("transformer.layers.in_proj" in names) == ("--int8" in argv)
    assert ("text_linear.weight" in names) == ("--int8-head" in argv)


@pytest.mark.parametrize("flags", [dict(int8=True, kv_int8=True),
                                   dict(int8_dep=True, int8_head=True)],
                         ids=["int8+kv_int8", "int8_dep+int8_head"])
def test_serving_frame_int8_matches_jax_teacher_forced(monkeypatch, flags):
    """The solo ServerState frame under the int8 options, against the JAX
    ServerState on the same JAX-quantized params (K1-int8 in Pallas
    interpret mode there, its plain version here), greedy and
    teacher-forced: every sampled logits row, the text tokens and the
    audio agree (``check_frames_teacher_forced``)."""
    check_frames_teacher_forced(*_slice_pair(monkeypatch, **flags), monkeypatch, n_frames=4)


def test_batched_tick_int8_kv_int8_matches_jax_batcher():
    """Three slots through both batchers under --int8 --kv-int8, float32,
    greedy, the same inputs through ``_device_step``, a session joining
    late and one replaced in its slot: tokens of every active slot equal,
    audio of every valid frame within 1e-5."""
    from rstnet_tpu.inference.generate import LMGen as JGen
    from rstnet_tpu.serving.batcher import SessionBatcher as JBatcher
    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.serving.batcher import SessionBatcher
    from tests.test_torch_batcher import FRAME, MOSHI as BMOSHI, _mimi_pair, _run

    jmimi, mimi_params, tmimi = _mimi_pair()
    jlm, lm_params = _jax_model(BMOSHI, jnp.float32)
    lm_params = jax_main_quantize(lm_params, int8=True)
    tlm = _port_model(BMOSHI, lm_params, torch.float32, int8=True)
    jb = JBatcher(jmimi, mimi_params, JGen(jlm, delays=jlm.delays, use_sampling=False,
                                           kv_int8=True), lm_params, max_sessions=3,
                  dtype=jnp.float32)
    tb = SessionBatcher(tmimi, LMGen(tlm, delays=tlm.delays, use_sampling=False, kv_int8=True),
                        max_sessions=3, dtype=torch.float32)
    assert tb.lm_state["lm"]["kv"][0]["k"].dtype == torch.int8

    async def run():
        jsess, tsess = {0: jb.acquire(), 1: jb.acquire()}, {0: tb.acquire(), 1: tb.acquire()}
        rng = np.random.default_rng(7)
        n_valid = 0
        for t in range(6):
            if t == 2:
                jsess[2], tsess[2] = jb.acquire(), tb.acquire()
            if t == 4:  # a session leaves and a new one takes its slot (reset_slots)
                jb.release(jsess[0])
                tb.release(tsess[0])
                jsess[0], tsess[0] = jb.acquire(), tb.acquire()
            assert {s.slot for s in tsess.values()} == {s.slot for s in jsess.values()}
            pcm = rng.normal(0, 0.1, (3, 1, FRAME)).astype(np.float32)
            jpcm, jsnap = jb._gather_inputs()
            tpcm, tsnap = tb._gather_inputs()
            jpcm[:], tpcm[:] = pcm, pcm
            _, jaudio, jout, jvalid = jb._device_step(jpcm, jsnap)
            _, taudio, tout, tvalid = tb._device_step(tpcm, tsnap)
            np.testing.assert_array_equal(tvalid, jvalid)
            for slot in sorted(tsess):
                np.testing.assert_array_equal(tout[slot], np.asarray(jout)[slot])
                if tvalid[slot]:
                    n_valid += 1
                    np.testing.assert_allclose(taudio[slot], np.asarray(jaudio)[slot], rtol=0,
                                               atol=AUDIO_TOL)
        assert n_valid >= 8

    _run(run())
