"""The codec side of the PyTorch port against the JAX package: SEANet, the
resamplers, the streaming transformer, K3's plain version (RVQ encode) and
Mimi's streaming encode/decode.

Tolerances: float32 paths agree to float32 rounding compounded over the
network's depth, so 1e-4 for single modules and 1e-3 for whole codecs.
Codes are integers and must be equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu_torch.core import from_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _load(params, module):
    return from_jax_params({k: np.asarray(v) for k, v in flatten_dict(params)}, module)


SEANET = dict(channels=1, dimension=16, n_filters=4, n_residual_layers=1, ratios=(4, 2),
              kernel_size=7, last_kernel_size=3, residual_kernel_size=3, causal=True)


@pytest.mark.parametrize("which,extra", [
    ("encoder", {}), ("decoder", {}), ("encoder", {"true_skip": False}),
    ("decoder", {"final_activation": "tanh"}),
])
def test_seanet_offline_and_steps_match_jax(which, extra):
    from rstnet_tpu.modules import seanet as js
    from rstnet_tpu_torch.modules import seanet as ts

    name = "SEANetEncoder" if which == "encoder" else "SEANetDecoder"
    jm = getattr(js, name)(**SEANET, **extra)
    params = jm.init(jax.random.PRNGKey(0))
    tm = _load(params, getattr(ts, name)(**SEANET, **extra))
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 1, 64)) if which == "encoder" else rng.normal(size=(2, 16, 8)))
    x = x.astype(np.float32)
    np.testing.assert_allclose(_np(tm(_t(x))), _np(jm(params, jnp.asarray(x))), **TOL)
    jst, tst = jm.init_state(2), tm.init_state(2)
    step = x.shape[-1] // 4
    for i in range(4):
        chunk = x[..., step * i : step * (i + 1)]
        jy, jst = jm.step(params, jst, jnp.asarray(chunk))
        ty, tst = tm.step(tst, _t(chunk))
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)


@pytest.mark.parametrize("learnt,channel_wise", [(True, False), (True, True), (False, False)])
def test_resamplers_match_jax(learnt, channel_wise):
    from rstnet_tpu.modules.resample import ConvDownsample1d as JD, ConvTrUpsample1d as JU
    from rstnet_tpu_torch.modules.resample import ConvDownsample1d, ConvTrUpsample1d

    kw = dict(stride=2, dimension=6, causal=True, learnt=learnt, channel_wise=channel_wise)
    x = np.random.default_rng(1).normal(size=(2, 6, 8)).astype(np.float32)
    for J, T in ((JD, ConvDownsample1d), (JU, ConvTrUpsample1d)):
        jm = J(**kw)
        params = jm.init(jax.random.PRNGKey(2))
        tm = _load(params, T(**kw))
        np.testing.assert_allclose(_np(tm(_t(x))), _np(jm(params, jnp.asarray(x))), **TOL)
        if not learnt:
            continue
        jst, tst = jm.init_state(2), tm.init_state(2)
        for i in range(2):
            chunk = x[..., 4 * i : 4 * (i + 1)]
            jy, jst = jm.step(params, jst, jnp.asarray(chunk))
            ty, tst = tm.step(tst, _t(chunk))
            np.testing.assert_allclose(_np(ty), _np(jy), **TOL)


TRANSFORMERS = {
    "mimi": dict(d_model=16, num_heads=2, num_layers=2, dim_feedforward=32, causal=True,
                 context=6, gating="none", norm="layer_norm", positional_embedding="rope",
                 layer_scale=0.01, activation="gelu"),
    "moshi": dict(d_model=16, num_heads=2, num_layers=2, dim_feedforward=48, causal=True,
                  context=6, gating="silu", norm="rms_norm_f32", positional_embedding="rope"),
    "sin": dict(d_model=16, num_heads=4, num_layers=1, dim_feedforward=32, causal=True,
                context=6, gating="none", norm="layer_norm_f32", positional_embedding="sin"),
    "depformer": dict(d_model=16, num_heads=2, num_layers=2, dim_feedforward=48, causal=True,
                      context=None, gating="silu", norm="rms_norm_f32",
                      positional_embedding="none", weights_per_step=4),
}


@pytest.mark.parametrize("name", list(TRANSFORMERS))
@pytest.mark.parametrize("unstacked", [False, True])
def test_streaming_transformer_offline_and_steps_match_jax(name, unstacked):
    """Offline forward, and streaming steps over a ring that wraps (except
    the depformer, whose steps are bounded by its weights_per_step)."""
    from rstnet_tpu.modules.transformer import StreamingTransformer as JT
    from rstnet_tpu_torch.modules.transformer import StreamingTransformer

    cfg = TRANSFORMERS[name]
    jm = JT(**cfg)
    params = jm.init(jax.random.PRNGKey(3))
    tm = _load(params, StreamingTransformer(**cfg))
    n = 4 if cfg.get("weights_per_step") else 10
    x = np.random.default_rng(4).normal(size=(2, n, 16)).astype(np.float32)
    np.testing.assert_allclose(_np(tm(_t(x))), _np(jm(params, jnp.asarray(x))), **TOL)
    chunk = 1 if cfg.get("weights_per_step") else 2
    jst = jm.init_state(2, jnp.float32, chunk_size=chunk, kv_unstacked=unstacked)
    tst = tm.init_state(2, torch.float32, chunk_size=chunk, kv_unstacked=unstacked)
    min_pos = np.array([0, 3])
    for i in range(0, n, chunk):
        xi = x[:, i : i + chunk]
        jy, jst = jm.step(params, jst, jnp.asarray(xi), min_pos=jnp.asarray(min_pos))
        ty, tst = tm.step(tst, _t(xi), min_pos=torch.from_numpy(min_pos))
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL)
    assert tst["offset"] == int(jst["offset"])


def test_projected_transformer_matches_jax():
    from rstnet_tpu.modules.transformer import (
        ProjectedTransformer as JP,
        StreamingTransformer as JT,
    )
    from rstnet_tpu_torch.modules.transformer import ProjectedTransformer, StreamingTransformer

    cfg = TRANSFORMERS["mimi"]
    jm = JP(JT(**cfg), input_dimension=12, output_dimensions=(16, 10), conv_layout=True)
    params = jm.init(jax.random.PRNGKey(5))
    tm = _load(params, ProjectedTransformer(StreamingTransformer(**cfg), 12, (16, 10),
                                            conv_layout=True))
    x = np.random.default_rng(6).normal(size=(2, 12, 6)).astype(np.float32)
    for a, b in zip(tm(_t(x)), jm(params, jnp.asarray(x))):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_rvq_reference_codes_equal_pallas_interpret_and_jnp(monkeypatch):
    """K3's plain version against the Pallas kernel in interpret mode and
    against the jnp branch: codes exact, quantized sums to float32 rounding."""
    from rstnet_tpu.ops import pallas_rvq
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode, rvq_encode_reference

    orig = pallas_rvq.pl.pallas_call

    def interp_call(*args, **kwargs):
        kwargs["interpret"] = True
        kwargs.pop("compiler_params", None)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pallas_rvq.pl, "pallas_call", interp_call)
    rng = np.random.default_rng(7)
    books = rng.normal(size=(3, 256, 32)).astype(np.float32)
    x = rng.normal(size=(50, 32)).astype(np.float32)
    codes_p, quant_p = pallas_rvq.rvq_encode_pallas(jnp.asarray(x), jnp.asarray(books),
                                                   block_n=64)
    codes_j, quant_j = pallas_rvq.rvq_encode(jnp.asarray(x), jnp.asarray(books),
                                             use_pallas=False)
    codes_t, quant_t = rvq_encode_reference(_t(x), _t(books))
    assert codes_t.dtype == torch.int32
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_p))
    np.testing.assert_array_equal(codes_t.numpy(), np.asarray(codes_j))
    np.testing.assert_allclose(_np(quant_t), _np(quant_p), rtol=1e-6, atol=1e-6)
    # the wrapper takes the plain version for a CPU tensor, N=1 included
    codes_w, _ = rvq_encode(_t(x[:1]), _t(books))
    np.testing.assert_array_equal(codes_w.numpy(), np.asarray(codes_j)[:1])


def test_rvq_first_index_wins_ties():
    from rstnet_tpu_torch.ops.cuda_rvq import rvq_encode_reference

    books = torch.zeros((2, 8, 4))
    books[0, 3] = books[0, 5] = torch.tensor([1.0, 0, 0, 0])
    codes, quant = rvq_encode_reference(torch.tensor([[1.0, 0, 0, 0]]), books)
    assert codes.tolist() == [[3, 0]]
    assert quant.tolist() == [[1.0, 0, 0, 0]]


def _tiny_mimi_pair(seed=0):
    """The server's --tiny Mimi on both sides, with random codebooks (the
    default init leaves every codebook at zero, where every code ties)."""
    from rstnet_tpu.models.mimi import mimi_24k as jax_mimi
    from rstnet_tpu_torch.models.mimi import mimi_24k

    kw = dict(n_q_total=8, dimension=64, n_filters=8, num_layers=2, quantizer_dim=32, bins=64)
    jm = jax_mimi(**kw)
    params = jm.init(jax.random.PRNGKey(seed))
    q = params["quantizer"]
    for name in ("rvq_first", "rvq_rest"):
        layers = q[name]["layers"]
        layers["embedding_sum"] = jax.random.normal(
            jax.random.PRNGKey(seed + 1 + len(name)), layers["embedding_sum"].shape)
    return jm, params, _load(params, mimi_24k(**kw))


def test_mimi_streaming_codes_exact_and_audio_close():
    jm, params, tm = _tiny_mimi_pair()
    frames = np.random.default_rng(8).normal(0, 0.1, (4, 1, 1, 1920)).astype(np.float32)
    jenc, tenc = jm.init_encode_state(1), tm.init_encode_state(1)
    jdec, tdec = jm.init_decode_state(1), tm.init_decode_state(1)
    encode_step, decode_step = jax.jit(jm.encode_step), jax.jit(jm.decode_step)
    for pcm in frames:
        jcodes, jenc = encode_step(params, jenc, jnp.asarray(pcm))
        tcodes, tenc = tm.encode_step(tenc, _t(pcm))
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        assert len(np.unique(np.asarray(jcodes))) > 1  # the codebooks are not degenerate
        jaudio, jdec = decode_step(params, jdec, jcodes)
        taudio, tdec = tm.decode_step(tdec, tcodes)
        assert taudio.shape == (1, 1, 1920)
        np.testing.assert_allclose(_np(taudio), _np(jaudio), rtol=1e-3, atol=1e-3)


def test_mimi_streaming_equals_offline_and_jax_offline():
    jm, params, tm = _tiny_mimi_pair(seed=3)
    x = np.random.default_rng(9).normal(0, 0.1, (1, 1, 3 * 1920)).astype(np.float32)
    codes = tm.encode(_t(x))
    jcodes = jax.jit(jm.encode)(params, jnp.asarray(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    state, stream = tm.init_encode_state(1), []
    for i in range(3):
        c, state = tm.encode_step(state, _t(x[..., 1920 * i : 1920 * (i + 1)]))
        stream.append(c)
    np.testing.assert_array_equal(torch.cat(stream, -1).numpy(), codes.numpy())
    audio = tm.decode(codes)
    np.testing.assert_allclose(_np(audio), _np(jax.jit(jm.decode)(params, jcodes)),
                               rtol=1e-3, atol=1e-3)
    state, stream = tm.init_decode_state(1), []
    for i in range(3):
        a, state = tm.decode_step(state, codes[..., i : i + 1])
        stream.append(a)
    np.testing.assert_allclose(_np(torch.cat(stream, -1)), _np(audio), rtol=1e-4, atol=1e-4)


def test_mimi_mask_decode_slots_matches_jax():
    jm, params, tm = _tiny_mimi_pair()
    jdec, tdec = jm.init_decode_state(2), tm.init_decode_state(2)
    codes = np.random.default_rng(10).integers(0, 64, (2, 8, 1))
    _, jdec = jax.jit(jm.decode_step)(params, jdec, jnp.asarray(codes))
    _, tdec = tm.decode_step(tdec, torch.from_numpy(codes))
    mask = np.array([True, False])
    jdec = jm.mask_decode_slots(jdec, jnp.asarray(mask))
    tdec = tm.mask_decode_slots(tdec, torch.from_numpy(mask))
    jflat = dict(flatten_dict(jdec["decoder"]))
    tflat = dict(flatten_dict(tdec["decoder"]))
    assert sorted(jflat) == sorted(tflat)
    for k in jflat:
        np.testing.assert_allclose(_np(tflat[k]), _np(jflat[k]), **TOL)
    assert float(np.abs(_np(tflat[k])[0]).max()) == 0.0
