"""The port's streaming ``Backbone.step`` (ring KV, stacked and per-layer,
``min_pos``, int8 rings, sliding windows, softcaps), its int8 linears and
the route of its decode MLP through K4/K5, against the JAX ``Backbone`` on
the CPU with the same params (the bridge splits JAX's stacked blocks).

Tolerances: float32 2e-5 (the same float32 math in another summation order;
the step's MLP runs K4/K5's plain versions, which equal the JAX float32 MLP
up to order). An int8 ring quantizes each new key and value row on both
sides; a float32 difference in the last bit can move one code by one step
(2**-7 of the row's largest value), so int8-ring steps are held to 2e-3.
bf16 weights over a float32 ring: 2e-2 of the output scale (bf16 products
round in other places in XLA:CPU and ATen). int8 codes and scales are
compared bit for bit."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu.models.backbone import Backbone as JaxBackbone
from rstnet_tpu.models.backbone import quantize_backbone_int8 as jax_quantize
from rstnet_tpu.models.config import Config as JaxConfig
from rstnet_tpu_torch.core import from_jax_params, to_numpy
from rstnet_tpu_torch.models import backbone as bmod
from rstnet_tpu_torch.models.backbone import STACKED, Backbone, quantize_backbone_int8
from rstnet_tpu_torch.models.config import Config

# n_embd 128 and an MLP of 256: inside K4/K5's envelope, so every step's MLP
# takes the fused route
STEP = dict(name="step-tiny", block_size=128, vocab_size=96, padded_vocab_size=96, n_layer=2,
            n_head=4, n_embd=128, n_query_groups=2, rotary_percentage=1.0,
            parallel_residual=False, bias=False, norm_class_name="RMSNorm",
            mlp_class_name="LLaMAMLP", intermediate_size=256, context=8)
VARIANTS = {
    "gqa": {},
    "window-softcap": dict(sliding_window_size=3, sliding_window_layer_placing="interleaved",
                           attention_logit_softcapping=5.0, final_logit_softcapping=4.0,
                           rope_base=500000, rope_adjustments=(8.0, 1.0, 4.0, 32)),
}


def _pair(cfg, dtype=jnp.float32, int8=False):
    jb = JaxBackbone(JaxConfig(**cfg))
    params = jb.init(jax.random.PRNGKey(0), dtype)
    tb = Backbone(Config(**cfg), dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    if int8:
        params = jax_quantize(params)
        quantize_backbone_int8(tb)
    from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, tb, stacked=STACKED)
    return jb, params, tb


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _inputs(seed, n, B=2, C=128):
    return np.random.default_rng(seed).normal(size=(n, B, 1, C)).astype(np.float32)


def test_streaming_equals_offline():
    """Mirror of ``tests/test_backbone.py::test_streaming_equals_offline``:
    24 single steps over a context-16 ring equal the offline forward; at
    n_embd 32 (the plain MLP) and 128 (the MLP through K4's plain version)."""
    for over in (dict(n_embd=32, intermediate_size=64), {}):
        cfg = dict(STEP, context=16, **over)
        tb = Backbone(Config(**cfg), generator=torch.Generator().manual_seed(0))
        tokens = torch.from_numpy(np.random.default_rng(1).integers(0, 96, (1, 24)))
        with torch.no_grad():
            x = tb.embed(tokens)
            want = tb(x)
            state = tb.init_state(1, dtype=torch.float32)
            got = []
            for t in range(24):
                y, state = tb.step(state, x[:, t:t + 1])
                got.append(y)
        torch.testing.assert_close(torch.cat(got, dim=1), want, rtol=0, atol=3e-5)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("unstacked", [False, True], ids=["stacked", "per-layer"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32-ring", "int8-ring"])
def test_step_matches_jax(variant, unstacked, kv_int8):
    """12 steps at B=2 over a context-8 ring (it wraps), with a per-row
    ``min_pos`` (row 1 joined at step 3), against the JAX step."""
    cfg = dict(STEP, **VARIANTS[variant])
    jb, params, tb = _pair(cfg)
    xs = _inputs(2, 12)
    jst = jb.init_state(2, jnp.float32, kv_int8=kv_int8, kv_unstacked=unstacked)
    tst = tb.init_state(2, torch.float32, kv_int8=kv_int8, kv_unstacked=unstacked)
    step = jax.jit(jb.step)
    tol = 2e-3 if kv_int8 else 2e-5
    for t in range(12):
        min_pos = np.array([0, 3 if t >= 3 else 0], np.int32)
        jy, jst = step(params, jst, jnp.asarray(xs[t]), jnp.asarray(min_pos))
        with torch.no_grad():
            ty, tst = tb.step(tst, torch.from_numpy(xs[t]), torch.from_numpy(min_pos).long())
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=tol)
    assert tst["offset"] == 12 and isinstance(tst["kv"], list) == unstacked
    with torch.no_grad():
        np.testing.assert_allclose(_np(tb.logits(ty)), _np(jb.logits(params, jy)), rtol=0,
                                   atol=10 * tol)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16], ids=["f32", "bf16"])
def test_quantize_backbone_int8_bit_equal_to_jax(dtype):
    """Every linear the JAX name walk quantizes (attention, projections, the
    MLP, lm_head), codes and scales bit for bit; norms and embeddings as
    they were."""
    _, params, tb = _pair(STEP, dtype)
    assert quantize_backbone_int8(tb) is tb
    quantize_backbone_int8(tb)  # already int8: unchanged
    got = to_numpy(tb, stacked=STACKED)
    want = {k: np.asarray(v) for k, v in flatten_dict(jax_quantize(params))}
    assert set(got) == set(want) and "lm_head.w_int8" in got and "blocks.mlp.fc_1.scale" in got
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].tobytes() == w.tobytes(), k


def test_int8_step_matches_jax():
    """int8 linears (K5 on the MLP, dequantized attention and head) over a
    float32 ring, per-layer, against the JAX int8 step."""
    jb, params, tb = _pair(STEP, int8=True)
    xs = _inputs(3, 6)
    jst = jb.init_state(2, jnp.float32, kv_unstacked=True)
    tst = tb.init_state(2, torch.float32, kv_unstacked=True)
    for t in range(6):
        jy, jst = jb.step(params, jst, jnp.asarray(xs[t]))
        with torch.no_grad():
            ty, tst = tb.step(tst, torch.from_numpy(xs[t]))
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=0, atol=2e-5)


def test_bf16_weights_over_float32_ring_promote_as_jax():
    """bf16 weights, float32 rings: the residual turns float32 after layer 0,
    as in the JAX per-layer loop (its stacked scan cannot carry the change);
    the port takes both layouts and gives the same values."""
    jb, params, tb = _pair(STEP, jnp.bfloat16)
    xs = _inputs(4, 5)
    jst = jb.init_state(1, jnp.float32, kv_unstacked=True)
    tsts = [tb.init_state(1, torch.float32, kv_unstacked=u) for u in (False, True)]
    for t in range(5):
        x = np.array(jnp.asarray(xs[t][:1], jnp.bfloat16).astype(jnp.float32))
        jy, jst = jb.step(params, jst, jnp.asarray(x, jnp.bfloat16))
        ys = []
        for i in range(2):
            with torch.no_grad():
                y, tsts[i] = tb.step(tsts[i], torch.from_numpy(x).bfloat16())
            ys.append(y)
        assert jy.dtype == jnp.float32 and ys[0].dtype == torch.float32
        torch.testing.assert_close(ys[0], ys[1], rtol=0, atol=0)
        want = _np(jy)
        np.testing.assert_allclose(_np(ys[0]), want, rtol=0, atol=2e-2 * max(1.0, np.abs(want).max()))


@pytest.fixture
def counted(monkeypatch):
    """Counts the backbone's calls of the K4 and K5 wrappers."""
    calls = {"k4": 0, "k5": 0}

    def wrap(name, fn):
        def spy(*args):
            calls[name] += 1
            return fn(*args)
        return spy

    monkeypatch.setattr(bmod, "gating_ffn", wrap("k4", bmod.gating_ffn))
    monkeypatch.setattr(bmod, "gating_ffn_int8", wrap("k5", bmod.gating_ffn_int8))
    return calls


def _run_steps(tb, B=2, T=1, n=3, chunk_size=1):
    state = tb.init_state(B, torch.float32, chunk_size=chunk_size)
    x = torch.randn((n, B, T, tb.config.n_embd), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for t in range(n):
            _, state = tb.step(state, x[t])


def test_decode_mlp_route(counted):
    """Every layer of every step inside the envelope takes K4 (float) or K5
    (all three MLP linears int8); the offline forward, a mixed quantization,
    more than 64 rows, a bias, a Gemma MLP or a width off the 128 grid keep
    the plain MLP."""
    L = STEP["n_layer"]
    tb = Backbone(Config(**STEP), generator=torch.Generator().manual_seed(0))
    _run_steps(tb)
    assert counted == {"k4": 3 * L, "k5": 0}
    _run_steps(tb, B=8, T=8, n=1, chunk_size=8)  # 64 rows: inside
    assert counted == {"k4": 4 * L, "k5": 0}
    _run_steps(tb, B=5, T=13, n=1, chunk_size=13)  # 65 rows: outside
    with torch.no_grad():
        tb(torch.randn(2, 5, 128))  # the offline forward
    assert counted == {"k4": 4 * L, "k5": 0}
    bmod.quantize_linear_int8(tb.blocks[0].mlp.fc_1)  # layer 0 mixed: plain
    _run_steps(tb, n=1)
    assert counted == {"k4": 4 * L + 1, "k5": 0}
    quantize_backbone_int8(tb)
    _run_steps(tb, n=2)
    assert counted == {"k4": 4 * L + 1, "k5": 2 * L}
    for over in (dict(bias=True), dict(mlp_class_name="GemmaMLP"), dict(intermediate_size=200),
                 dict(n_embd=64, intermediate_size=256)):
        cfg = dataclasses.replace(Config(**STEP), **over)
        _run_steps(Backbone(cfg, generator=torch.Generator().manual_seed(0)))
    assert counted == {"k4": 4 * L + 1, "k5": 2 * L}


def test_step_refuses_chunks_past_the_ring_and_unbounded_context():
    tb = Backbone(Config(**STEP), generator=torch.Generator().manual_seed(0))
    state = tb.init_state(1, torch.float32)
    with pytest.raises(ValueError):
        tb.step(state, torch.zeros(1, 2, 128))  # chunk_size 1
    with pytest.raises(ValueError):
        Backbone(Config(**dict(STEP, context=None))).init_state(1)
