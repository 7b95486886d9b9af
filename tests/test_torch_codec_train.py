"""Codec training in the PyTorch port against the JAX package: the codebook's
EMA, dead-code and k-means updates, the trainable (split) RVQ through K3's
plain version, ``TrainableMimiCodec``, the six discriminators, the
generator and discriminator losses, one whole G step and D step of the
trainer, and ``codec_trainer.main`` with resume.

Weights are drawn by the port and carried to the JAX trees
(``core.to_numpy``, shaped by ``jax.eval_shape`` of the JAX init); random
draws are JAX's, given to the port (``draws``, ``dead_indices``,
``indices``). Inputs come from seeded numpy generators.

Tolerances (float32 on both sides; the largest errors observed when
written, in brackets):
- losses and forward outputs: 1e-4 relative and absolute (3.8e-6 absolute);
- EMA buffers: 1e-5 absolute (9.5e-7);
- gradients: each tensor's error norm <= 1e-3 of its own norm plus 1e-6
  (9.0e-5 of the norm; 5.9e-8 on a gradient of norm 3e-8);
- parameters after one AdamW update: 2e-6 absolute (2.5e-7), except where
  the gradient is below 1e-5 and the first step's g / |g| is rounding
  noise: 2 lr there (3.5e-5);
- codes: equal, except at a near-tie (``chip_smoke.K3_TIE_RTOL``; none
  seen).
"""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from rstnet_tpu.core import flatten_dict
from rstnet_tpu_torch.core import from_jax_params, to_numpy

TOL = dict(rtol=1e-4, atol=1e-4)
BUF_ATOL = 1e-5
TIE_RTOL = 1e-5  # chip_smoke.K3_TIE_RTOL

TINY = dict(sample_rate=2400, n_filters=4, encoder_rates=(4, 3), latent_dim=32,
            codebook_size=16, codebook_dim=8, rvq_layers=4, num_heads=2, num_layers=1,
            layer_scale=0.01, context=32, dim_feedforward=64, semantic_feature_dim=16,
            target_frame_rate=100)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(tree) if v is not None}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_tree(flat: dict, template, prefix: str = ""):
    """A JAX tree shaped as ``template`` with the leaves of ``flat``
    (dotted paths, as ``flatten_dict`` writes them)."""
    if isinstance(template, dict):
        return {k: jax_tree(flat, v, f"{prefix}.{k}" if prefix else str(k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(jax_tree(flat, v, f"{prefix}.{i}" if prefix else str(i))
                              for i, v in enumerate(template))
    if template is None:
        return None
    return jnp.asarray(np.array(flat[prefix]))  # a copy: the port's buffers change in place


def jax_state(jax_module, torch_module, with_buffers: bool = False):
    """The port module's weights (and buffers) as the JAX module's trees."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0))
    if with_buffers:
        return (jax_tree(to_numpy(torch_module, part="params"), shapes[0]),
                jax_tree(to_numpy(torch_module, part="buffers"), shapes[1]))
    return jax_tree(to_numpy(torch_module), shapes)


def _assert_codes(codes_t, codes_j, x, embeds):
    """Equal codes, except where the two candidates' squared distances to
    the level's residual are within ``TIE_RTOL`` of each other."""
    codes_t, codes_j = np.asarray(codes_t), np.asarray(codes_j)
    rows = np.nonzero((codes_t != codes_j).any(-1))
    xd, ed = np.asarray(x, np.float64), np.asarray(embeds, np.float64)
    for idx in zip(*rows):
        ct, cj = codes_t[idx], codes_j[idx]
        q = int(np.nonzero(ct != cj)[0][0])
        r = xd[idx] - sum(ed[j, ct[j]] for j in range(q))
        da, db = np.sum((r - ed[q, ct[q]]) ** 2), np.sum((r - ed[q, cj[q]]) ** 2)
        assert abs(da - db) <= TIE_RTOL * max(da, db), (idx, q, da, db)


def dead_draws(key, n_rows: int, levels: int, size: int) -> np.ndarray:
    """JAX's dead-code rows for one residual quantizer (``trainable.py``)."""
    return np.stack([np.asarray(jax.random.randint(k, (size,), 0, n_rows))
                     for k in jax.random.split(key, levels)])


def codec_draws(key, batch: int, n_rows: int, model) -> dict:
    """JAX's draws of one ``TrainableMimiCodec`` training forward."""
    k_bypass, k_vq = jax.random.split(key)
    k_first, k_rest = jax.random.split(k_vq)
    K, n_q = model["codebook_size"], model["rvq_layers"]
    keep = np.array(jax.random.uniform(k_bypass, (batch, 1, 1)) >= 0.4)[:, 0, 0]
    return {"keep": keep, "dead": {"rvq_first": dead_draws(k_first, n_rows, 1, K),
                                   "rvq_rest": dead_draws(k_rest, n_rows, n_q - 1, K)}}


# -- the codebook's training updates ------------------------------------------


def test_codebook_ema_replace_and_kmeans_match_jax():
    from rstnet_tpu.quantization.codebook import EuclideanCodebook as JC
    from rstnet_tpu.quantization.codebook import _kmeans
    from rstnet_tpu_torch.quantization.codebook import EuclideanCodebook as TC

    rng = np.random.default_rng(0)
    jc = JC(dim=8, codebook_size=16)
    tc = TC(8, 16, decay=0.99)
    params = {"embedding_sum": jnp.asarray(rng.normal(size=(16, 8)).astype(np.float32)),
              "cluster_usage": jnp.asarray(rng.uniform(0.01, 2, 16).astype(np.float32)),
              "initialized": jnp.zeros((), jnp.float32)}
    from_jax_params(_flat(params), tc)
    x = rng.normal(size=(40, 8)).astype(np.float32)
    codes_j = jax.jit(jc.quantize)(params, jnp.asarray(x))
    codes_t = tc.quantize(torch.from_numpy(x))
    _assert_codes(_np(codes_t)[:, None], np.asarray(codes_j)[:, None], x,
                  np.asarray(jc.embedding(params))[None])
    new_j, m_j = jax.jit(jc.ema_update)(params, jnp.asarray(x), codes_j)
    m_t = tc.ema_update(torch.from_numpy(x), torch.from_numpy(np.asarray(codes_j)))
    for k in ("embedding_sum", "cluster_usage"):
        np.testing.assert_allclose(_np(getattr(tc, k)), np.asarray(new_j[k]), atol=BUF_ATOL)
    np.testing.assert_allclose(float(m_t["rvq_entropy"]), float(m_j["rvq_entropy"]), rtol=1e-5)

    # dead codes: a usage below 0.1 of the mean is replaced by a batch row
    usage = np.asarray(new_j["cluster_usage"]).copy()
    usage[[1, 5, 9]] = 1e-4
    new_j["cluster_usage"] = jnp.asarray(usage)
    from_jax_params(_flat(new_j), tc)
    key = jax.random.PRNGKey(7)
    rep_j, frac_j = jax.jit(jc.replace_expired)(new_j, jnp.asarray(x), key)
    idx = np.asarray(jax.random.randint(key, (16,), 0, 40))
    frac_t = tc.replace_expired(torch.from_numpy(x), indices=torch.from_numpy(idx))
    assert float(frac_t) == float(frac_j) == 3 / 16
    for k in ("embedding_sum", "cluster_usage"):
        np.testing.assert_allclose(_np(getattr(tc, k)), np.asarray(rep_j[k]), atol=BUF_ATOL)

    # k-means over well-separated clusters: the same means as JAX's loop
    centers = rng.normal(size=(4, 8)).astype(np.float32) * 10
    samples = (centers[rng.integers(0, 4, 64)] + rng.normal(size=(64, 8)) * 0.1).astype(np.float32)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    draws = tuple(np.asarray(jax.random.randint(k, (16,), 0, 64)) for k in (k1, k2))
    means_j, bins_j = jax.jit(_kmeans, static_argnums=(1, 3))(jnp.asarray(samples), 16,
                                                               jax.random.PRNGKey(3), 5)
    fresh = TC(8, 16)
    fresh.kmeans_init(torch.from_numpy(samples), num_iters=5, indices=draws)
    np.testing.assert_allclose(_np(fresh.cluster_usage), np.asarray(bins_j))
    np.testing.assert_allclose(_np(fresh.embedding_sum),
                               np.asarray(means_j * bins_j[:, None]), atol=1e-4)
    assert float(fresh.initialized) == 1.0
    before = _np(fresh.embedding_sum).copy()
    fresh.kmeans_init(torch.from_numpy(samples), num_iters=5, indices=draws)
    np.testing.assert_array_equal(_np(fresh.embedding_sum), before)  # initialized: kept
    # JAX's axis_name psums over a mesh axis; in one process (no mesh) the
    # data axis is 1 and the update is the one without it
    named, plain = TC(8, 16), TC(8, 16)
    named.ema_update(torch.from_numpy(x), codes_t, axis_name="data")
    plain.ema_update(torch.from_numpy(x), codes_t)
    np.testing.assert_array_equal(_np(named.cluster_usage), _np(plain.cluster_usage))
    np.testing.assert_array_equal(_np(named.embedding_sum), _np(plain.embedding_sum))


# -- the trainable RVQ -----------------------------------------------------------


@pytest.fixture(scope="module")
def rvq_pair():
    from rstnet_tpu.quantization.trainable import TrainableResidualVQ as JR
    from rstnet_tpu_torch.quantization.trainable import TrainableResidualVQ as TR

    kw = dict(dim=16, codebook_dim=8, codebook_size=32, num_quantizers=4)
    jr = JR(**kw)
    tr = TR(**kw, generator=torch.Generator().manual_seed(0))
    params, buffers = jax_state(jr, tr, with_buffers=True)
    x = np.random.default_rng(1).normal(size=(2, 10, 16)).astype(np.float32)
    return jr, tr, params, buffers, x


def test_trainable_rvq_roundtrip_and_ema(rvq_pair):
    jr, tr, params, buffers, x = rvq_pair
    key = jax.random.PRNGKey(2)
    q_j, codes_j, commit_j, nb_j = jax.jit(jr.forward)(params, buffers, jnp.asarray(x), key)
    from_jax_params(_flat(params), tr, buffers=_flat(buffers))
    q_t, codes_t, commit_t = tr(torch.from_numpy(x),
                                dead_indices=dead_draws(key, 20, 4, 32))
    h = np.asarray(x @ np.asarray(params["project_in"]).T).reshape(-1, 8)
    _assert_codes(_np(codes_t).reshape(-1, 4), np.asarray(codes_j).reshape(-1, 4), h,
                  np.asarray(jr._embed(buffers)))
    assert q_t.shape == x.shape and codes_t.shape == (2, 10, 4) and codes_t.dtype == torch.int32
    np.testing.assert_allclose(_np(q_t), np.asarray(q_j), **TOL)
    np.testing.assert_allclose(float(commit_t), float(commit_j), **TOL)
    for k, v in _flat(nb_j).items():
        np.testing.assert_allclose(_np(getattr(tr, k)), v, atol=BUF_ATOL)
    assert not np.allclose(_np(tr.embed_avg), np.asarray(buffers["embed_avg"]))  # EMA moved
    codes2 = tr.encode(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(codes2),
                                  np.asarray(jax.jit(jr.encode)(params, nb_j, jnp.asarray(x))))
    dec = jax.jit(jr.decode)(params, nb_j, jnp.asarray(_np(codes2)))
    np.testing.assert_allclose(_np(tr.decode(codes2)), np.asarray(dec), **TOL)


def test_trainable_rvq_gradients_flow(rvq_pair):
    """The straight-through sum: gradients reach both projections, and the
    latent's gradient equals JAX's (Q x identity through the levels)."""
    jr, tr, params, buffers, x = rvq_pair
    from_jax_params(_flat(params), tr, buffers=_flat(buffers))

    def loss_j(p, xx):
        q, _, commit, _ = jr.forward(p, buffers, xx, update=False)
        return jnp.mean(jnp.square(q - xx)) + commit

    g_p, g_x = jax.jit(jax.grad(loss_j, argnums=(0, 1)))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    for p in tr.parameters():
        p.requires_grad_(True)
    q, _, commit = tr(xt, update=False)
    (torch.mean(torch.square(q - xt)) + commit).backward()
    for name in ("project_in", "project_out"):
        g = getattr(tr, name).grad
        assert float(g.abs().sum()) > 0
        np.testing.assert_allclose(_np(g), np.asarray(g_p[name]), **TOL)
    np.testing.assert_allclose(_np(xt.grad), np.asarray(g_x), **TOL)
    for p in tr.parameters():
        p.requires_grad_(False)
        p.grad = None


def test_split_rvq_distillation():
    from rstnet_tpu.quantization.trainable import TrainableSplitRVQ as JS
    from rstnet_tpu_torch.quantization.trainable import TrainableSplitRVQ as TS

    js = JS(input_dimension=16, dimension=8, bins=16, n_q=4)
    ts = TS(input_dimension=16, dimension=8, bins=16, n_q=4)
    params, buffers = jax_state(js, ts, with_buffers=True)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    sem = rng.normal(size=(2, 10, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    quant_j, codes_j, commit_j, sim_j, nb_j = jax.jit(js.forward)(params, buffers, jnp.asarray(x),
                                                                  jnp.asarray(sem), key)
    k1, k2 = jax.random.split(key)
    quant_t, codes_t, commit_t, sim_t = ts(
        torch.from_numpy(x), torch.from_numpy(sem),
        dead_indices={"rvq_first": dead_draws(k1, 20, 1, 16), "rvq_rest": dead_draws(k2, 20, 3, 16)})
    assert codes_t.shape == (2, 10, 4) and float(sim_t) > 0
    np.testing.assert_array_equal(_np(codes_t), np.asarray(codes_j))
    for got, want in ((quant_t, quant_j), (commit_t, commit_j), (sim_t, sim_j)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for k, v in _flat(nb_j).items():
        np.testing.assert_allclose(_np(ts.get_buffer(k)), v, atol=BUF_ATOL)


def test_trainable_rvq_sweeps_through_rvq_encode(monkeypatch):
    """The sweep is one ``rvq_encode`` call a residual quantizer (K3 on a
    CUDA tensor), with no other route: on a device without a kernel it
    raises."""
    from rstnet_tpu_torch.ops import cuda_rvq
    from rstnet_tpu_torch.quantization import trainable

    calls = []

    def fake(x, codebooks):
        calls.append((tuple(x.shape), tuple(codebooks.shape), x.dtype))
        return cuda_rvq.rvq_encode_reference(x, codebooks)

    monkeypatch.setattr(trainable, "rvq_encode", fake)
    tr = trainable.TrainableSplitRVQ(input_dimension=16, dimension=8, bins=16, n_q=4)
    tr(torch.zeros((2, 5, 16)))
    assert calls == [((10, 8), (1, 16, 8), torch.float32), ((10, 8), (3, 16, 8), torch.float32)]
    monkeypatch.undo()
    with pytest.raises(NotImplementedError):
        trainable.rvq_encode(torch.zeros((4, 8), device="meta"), torch.zeros((1, 16, 8)))


# -- the trainable codec -----------------------------------------------------------


@pytest.fixture(scope="module")
def codec():
    from rstnet_tpu.models.mimi_train import TrainableMimiCodec as JM
    from rstnet_tpu_torch.models.mimi_train import TrainableMimiCodec as TM

    jm = JM(**TINY)
    tm = TM(**TINY, generator=torch.Generator().manual_seed(0))
    params, buffers = jax_state(jm, tm, with_buffers=True)
    rng = np.random.default_rng(1)
    audio = (0.1 * rng.normal(size=(2, 1, 1200))).astype(np.float32)
    return jm, tm, params, buffers, audio


def _reload(tm, params, buffers):
    from_jax_params(_flat(params), tm, buffers=_flat(buffers))


def test_training_forward_shapes_and_losses(codec):
    jm, tm, params, buffers, audio = codec
    _reload(tm, params, buffers)
    # 100 Hz latent grid on 0.5 s of audio: 50 frames; teacher at 4x (pool 8/4)
    feats = np.random.default_rng(2).normal(size=(2, 200, 16)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    rec_j, codes_j, commit_j, sim_j, nb_j = jax.jit(jm.__call__)(params, buffers, jnp.asarray(audio),
                                                                jnp.asarray(feats), key)
    draws = codec_draws(key, 2, 100, TINY)
    rec, codes, commit, sim = tm(torch.from_numpy(audio), torch.from_numpy(feats), draws=draws)
    assert rec.shape == audio.shape and codes.shape == (2, TINY["rvq_layers"], 50)
    assert float(sim) != 0.0  # distillation on when features are given
    np.testing.assert_array_equal(_np(codes), np.asarray(codes_j))
    for got, want in ((rec, rec_j), (commit, commit_j), (sim, sim_j)):
        np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    moved = False
    for k, v in _flat(nb_j).items():
        got = _np(tm.get_buffer(k))
        np.testing.assert_allclose(got, v, atol=BUF_ATOL)
        moved |= not np.array_equal(got, _flat(buffers)[k])
    assert moved  # the EMA buffers moved


def test_no_semantic_features_means_zero_sim_loss(codec):
    jm, tm, params, buffers, audio = codec
    _reload(tm, params, buffers)
    *_, sim = tm(torch.from_numpy(audio), generator=torch.Generator().manual_seed(0))
    assert float(sim) == 0.0


def test_bypass_extremes(codec):
    """bypass 1.0 decodes the unquantized latent, 0.0 the quantized one;
    each equal to JAX's."""
    jm, tm, params, buffers, audio = codec
    _reload(tm, params, buffers)
    a = torch.from_numpy(audio)
    rec_all, *_ = tm(a, update_codebooks=False, draws={"keep": np.zeros(2, bool)})
    rec_unq = tm.decode_from_latent(tm.encode_to_latent(a))[..., :1200]
    np.testing.assert_allclose(_np(rec_all), _np(rec_unq), atol=1e-6)
    j_all, *_ = jax.jit(lambda *a: dataclasses.replace(jm, bypass_rate=1.0)(*a, update_codebooks=False))(
        params, buffers, jnp.asarray(audio), None, jax.random.PRNGKey(3))
    np.testing.assert_allclose(_np(rec_all), np.asarray(j_all), **TOL)
    rec_none, codes, *_ = tm(a, update_codebooks=False, draws={"keep": np.ones(2, bool)})
    np.testing.assert_allclose(_np(rec_none), _np(tm.decode(codes))[..., :1200], atol=1e-5)
    j_none, *_ = jax.jit(lambda *a: dataclasses.replace(jm, bypass_rate=0.0)(*a, update_codebooks=False))(
        params, buffers, jnp.asarray(audio), None, jax.random.PRNGKey(3))
    np.testing.assert_allclose(_np(rec_none), np.asarray(j_none), **TOL)
    assert not np.allclose(_np(rec_all), _np(rec_none))


def test_encode_decode_roundtrip(codec):
    jm, tm, params, buffers, audio = codec
    _reload(tm, params, buffers)
    codes = tm.encode(torch.from_numpy(audio))
    assert codes.shape[1] == TINY["rvq_layers"]
    assert int(codes.min()) >= 0 and int(codes.max()) < TINY["codebook_size"]
    np.testing.assert_array_equal(_np(codes), np.asarray(jax.jit(jm.encode)(params, buffers,
                                                                            jnp.asarray(audio))))
    rec = tm.decode(codes)
    np.testing.assert_allclose(_np(rec), np.asarray(jax.jit(jm.decode)(params, buffers,
                                                                       jnp.asarray(_np(codes)))),
                               **TOL)
    assert tm.encode(rec[..., :1200]).shape == codes.shape


def test_map_semantic_grid(codec):
    jm, tm, params, buffers, _ = codec
    _reload(tm, params, buffers)
    feats = np.random.default_rng(4).normal(size=(2, 16, 16)).astype(np.float32)
    pooled = tm.map_semantic(torch.from_numpy(feats))
    assert pooled.shape == (2, 3, TINY["latent_dim"])  # (16 - 8) // 4 + 1
    np.testing.assert_allclose(_np(pooled), np.asarray(jax.jit(jm.map_semantic)(params, jnp.asarray(feats))),
                               **TOL)


# -- the trainer ---------------------------------------------------------------------

SR = 2400


def tiny_config(batch_size: int = 2) -> dict:
    return {
        "generator": {"name": "MimiCodec", "config": {**TINY, "encoder_rates": [4, 3]}},
        "d_list": ["mfd"],
        "mfd": {"config": {"hop_lengths": [8, 16], "hidden_channels": [32, 32],
                           "domain": "double", "mel_scale": True, "sample_rate": SR}},
        "criterion": {"g_criterion": {"config": {
            "adv_criterion": "MSEGLoss", "use_feature_match": True,
            "feat_match_loss_weight": 20, "use_mel_loss": False,
            "use_full_stft_loss": True, "full_stft_loss_weight": 1,
            "full_multi_scale_stft_loss": {"fft_sizes": [64, 128], "win_sizes": [40, 80],
                                           "hop_sizes": [10, 20]},
            "use_sub_stft_loss": True, "sub_stft_loss_weight": 1,
            "sub_multi_scale_stft_loss": {"num_bands": 2, "fft_sizes": [32], "win_sizes": [20],
                                          "hop_sizes": [8]},
        }}},
        "optimizer": {"g": {"config": {"lr": 1e-4}}, "d": {"config": {"lr": 1e-4}}},
        "segment_size": 1200, "batch_size": batch_size, "num_epoches": 1,
        "checkpoint_interval": 2, "print_freq": 1, "discriminator_iter_start": 0,
    }


def test_one_g_and_d_step_match_jax():
    """One G step and then one D step from the same weights, inputs and
    draws: every loss item, the EMA buffers, the gradients (the AdamW first
    moments after one update are (1 - b1) x the gradients) and both
    models' parameters after their updates."""
    import optax

    from rstnet_tpu.training import codec_trainer as JT
    from rstnet_tpu_torch.training import codec_trainer as TT

    cfg = tiny_config()  # one MFD scale and one STFT resolution a band: a quicker JAX compile
    cfg["mfd"]["config"].update(hop_lengths=[8], hidden_channels=[32])
    crit = cfg["criterion"]["g_criterion"]["config"]
    crit["full_multi_scale_stft_loss"] = {"fft_sizes": [64], "win_sizes": [40], "hop_sizes": [10]}
    tm, td, tl = TT.build_from_config(cfg, "cpu")
    jm, jd, jl = JT.build_from_config(cfg)
    gp, gb = jax_state(jm, tm, with_buffers=True)
    dshapes = jax.eval_shape(lambda k: {n: d.init(k) for n, d in jd.items()}, jax.random.PRNGKey(0))
    dp = jax_tree(to_numpy(td), dshapes)

    def jtx():
        return optax.adamw(lambda s: 1e-4 * 0.999 ** (s / 1), b1=0.8, b2=0.99, eps=1e-6)

    g_tx, d_tx = jtx(), jtx()
    g_step, d_step, _ = JT.make_steps(jm, jd, jl, g_tx, d_tx)
    rng = np.random.default_rng(0)
    audio = (0.1 * rng.normal(size=(2, 1, 1200))).astype(np.float32)
    feats = rng.normal(size=(2, 200, 16)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    g_state = {"params": gp, "buffers": gb, "opt_state": g_tx.init(gp),
               "step": jnp.zeros((), jnp.int32)}
    d_state = {"params": dp, "opt_state": d_tx.init(dp)}
    g_state, rec_j, gi_j = g_step(g_state, d_state["params"], jnp.asarray(audio),
                                  jnp.asarray(feats), key, use_adv=True)
    d_state, di_j = d_step(d_state, jnp.asarray(audio), rec_j)

    t_tx = TT.make_tx({"lr": 1e-4}, 0.999, 1), TT.make_tx({"lr": 1e-4}, 0.999, 1)
    gs, ds, _ = TT.make_steps(tm, td, tl, *t_tx)
    state = {"opt_state": {"g": t_tx[0].init(dict(tm.named_parameters())),
                           "d": t_tx[1].init(dict(td.named_parameters()))}}
    a = torch.from_numpy(audio)
    rec_t, gi_t = gs(state, a, torch.from_numpy(feats), None, True,
                     draws=codec_draws(key, 2, 100, TINY))
    di_t = ds(state, a, rec_t)

    assert set(gi_t) == set(gi_j) and set(di_t) == set(di_j)
    for k in gi_j:
        np.testing.assert_allclose(float(gi_t[k]), float(gi_j[k]), **TOL, err_msg=k)
    for k in di_j:
        np.testing.assert_allclose(float(di_t[k]), float(di_j[k]), **TOL, err_msg=k)
    np.testing.assert_allclose(_np(rec_t), np.asarray(rec_j), **TOL)
    buffers = to_numpy(tm, part="buffers")
    for k, v in _flat(g_state["buffers"]).items():
        np.testing.assert_allclose(buffers[k], v, atol=BUF_ATOL, err_msg=k)

    def first_moments(opt_state):
        return next(s.mu for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                    if hasattr(s, "mu"))

    for side, jstate in (("g", g_state), ("d", d_state)):
        mu_j = _flat(first_moments(jstate["opt_state"]))
        mu_t = state["opt_state"][side]["mu"]
        for k, v in mu_j.items():
            err = np.linalg.norm(_np(mu_t[k]) - v)
            assert err <= 1e-3 * np.linalg.norm(v) + 1e-6, (side, k, err, np.linalg.norm(v))
    # one AdamW step moves a parameter by lr x (m / (sqrt(v) + eps) + wd x p)
    # with m / sqrt(v) = g / |g| at the first step: where |g| is near eps
    # (1e-6) or below, that ratio is a ratio of rounding noise, so such an
    # element is held within the step's bound (2 lr), every other within 2e-6
    for module, jstate, side in ((tm, g_state, "g"), (td, d_state, "d")):
        got = to_numpy(module, part="params")
        mu_j = _flat(first_moments(jstate["opt_state"]))
        for k, v in _flat(jstate["params"]).items():
            atol = np.where(np.abs(mu_j[k]) / 0.2 < 1e-5, 2.1e-4, 2e-6)
            assert (np.abs(got[k] - v) <= atol).all(), (side, k, np.abs(got[k] - v).max())


def _write_corpus(root, n_wavs: int = 4):
    from rstnet_tpu_torch.utils.audio import write_wav

    rng = np.random.default_rng(0)
    paths = []
    for i in range(n_wavs):
        p = root / f"w{i}.wav"
        write_wav(str(p), 0.2 * rng.normal(0, 1, SR).astype(np.float32), SR)
        paths.append(str(p))
    (root / "train.scp").write_text("\n".join(paths))
    return root / "train.scp"


def test_codec_trainer_end_to_end_and_resume(tmp_path):
    """Two GAN steps through the CLI on the CPU, a checkpoint, and a rerun
    that resumes from it (the parameters, buffers, both optimizer states and
    the draws' generator) and trains two more."""
    from rstnet_tpu_torch.training import codec_trainer
    from rstnet_tpu_torch.training.checkpoint import latest_checkpoint

    scp = _write_corpus(tmp_path)
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(tiny_config()))
    argv = ["--config", str(cfg), "--exp_dir", str(tmp_path / "exp"), "--train_scp", str(scp),
            "--semantic_teacher", "none", "--device", "cpu"]
    first = codec_trainer.main(argv + ["--max_steps", "2"])
    assert [s["step"] for s in first["steps"]] == [1, 2]
    assert "G_adv_mfd" not in first["steps"][0] and "G_adv_mfd" in first["steps"][1]
    assert all(np.isfinite(s["g_loss"]) and np.isfinite(s["d_loss"]) for s in first["steps"])
    ckpt = latest_checkpoint(tmp_path / "exp")
    assert ckpt.name == "ep0-iter2.checkpoint"
    saved = torch.load(ckpt / "state.pt", weights_only=True)
    assert any(k.startswith("g.quantizer.rvq_rest.embed_avg") for k in saved["params"])
    assert any(k.startswith("d.mfd.discs.") for k in saved["params"])
    assert saved["opt_state"]["g"]["count"] == saved["opt_state"]["d"]["count"] == 2

    second = codec_trainer.main(argv + ["--max_steps", "4"])
    assert [s["step"] for s in second["steps"]] == [3, 4]
    state = second["state"]
    assert state["step"] == 4 and state["opt_state"]["g"]["count"] == 4
    assert latest_checkpoint(tmp_path / "exp").name == "ep0-iter4.checkpoint"
    # the resumed lr continues the schedule (2 steps an epoch)
    np.testing.assert_allclose(second["steps"][0]["lr"], 1e-4 * 0.999 ** (2 / 2), rtol=1e-6)
    # one process: a 2-rank mesh is JAX's make_mesh error, a batch that
    # does not split is JAX's divisibility error
    with pytest.raises(ValueError, match="covers 2 devices but 1 are visible"):
        codec_trainer.main(argv + ["--dp", "2"])
    with pytest.raises(ValueError, match="not divisible by --dp 3"):
        codec_trainer.main(argv + ["--dp", "3"])
    assert codec_trainer.get_parser().parse_args(["--config", "c"]).device == "cuda"


# -- data parallelism (``--dp``) --------------------------------------------------


# ``--dp 2`` against ``--dp 1``, float32: each loss is the same sum over
# the batch taken in two halves (~1e-7 apart); the first moments are
# gradients summed over the ranks in another order, the second step's taken
# at parameters that differ where Adam turned that rounding on a near-zero
# gradient into part of an lr step (up to 3.5e-5 of a tensor's largest
# magnitude measured). A rank that kept its own half of the gradient is off
# by a share of the whole.
CODEC_DP_LOSS_RTOL = 1e-5
CODEC_DP_MU_RTOL = 1e-3


@pytest.fixture(scope="module")
def dp_ranks(tmp_path_factory):
    """``--dp 2`` on 2 gloo ranks (one torch thread each, one start for
    both tests), the ``--dp 1`` run in this process; and the EMA update
    over the data group, each rank given half of the rows."""
    from rstnet_tpu.quantization.codebook import EuclideanCodebook as JC
    from tests.torch_parallel_ranks import job_codec_train, run_ranks

    tmp = tmp_path_factory.mktemp("dp")
    scp = _write_corpus(tmp, n_wavs=8)
    cfg = tmp / "config.yaml"
    cfg.write_text(yaml.safe_dump(tiny_config(batch_size=4)))

    def argv(tag, dp):
        return ["--config", str(cfg), "--exp_dir", str(tmp / f"exp_{tag}"), "--train_scp",
                str(scp), "--semantic_teacher", "none", "--device", "cpu", "--max_steps", "2",
                "--dp", str(dp)]

    cb = JC(dim=8, codebook_size=16)
    params = cb.init(jax.random.PRNGKey(0))
    params["embedding_sum"] = jax.random.normal(jax.random.PRNGKey(1), (16, 8))
    x = jax.random.normal(jax.random.PRNGKey(2), (32, 8))
    codes = cb.quantize(params, x)
    ema = {"x": np.array(x), "codes": np.array(codes),
           "embedding_sum": np.array(params["embedding_sum"])}
    ref, _ = cb.ema_update(params, x, codes)
    ranks = run_ranks(tmp, 2, "codec_suite", argv=argv("dp2", 2), ema=ema)
    return {"dp1": job_codec_train(argv("dp1", 1)), "ranks": ranks,
            "ema_ref": {k: np.asarray(ref[k]) for k in ("cluster_usage", "embedding_sum")}}


def test_codec_trainer_mesh_invariance(dp_ranks):
    """``--dp 2`` matches the ``--dp 1`` run on the same batches and draws:
    G and D parameters and the EMA codebook buffers after 2 steps, on both
    ranks (JAX's tolerance, 5e-3). At lr 1e-4 two Adam steps move an element
    by about 2e-4 whatever its gradient, so that cannot see the gradient:
    the steps' G and D losses (the second taken after an update) and the
    G and D optimizers' first moments, a decayed sum of both steps'
    all-reduced gradients, are held to the ``--dp 1`` run's too
    (``CODEC_DP_*``)."""
    ref = dp_ranks["dp1"]
    for r in dp_ranks["ranks"]:
        for part in ("g_mu", "d_mu"):
            got = r["codec"][part]
            assert set(got) == set(ref[part])
            for k, want in ref[part].items():
                scale = float(np.max(np.abs(want))) if want.size else 0.0
                worst = float(np.max(np.abs(got[k] - want))) if want.size else 0.0
                assert worst <= CODEC_DP_MU_RTOL * scale, (part, k, worst, scale)
        np.testing.assert_allclose(r["codec"]["losses"], ref["losses"], rtol=CODEC_DP_LOSS_RTOL)
        for part in ("g_params", "g_buffers", "d_params"):
            got = r["codec"][part]
            assert set(got) == set(ref[part])
            worst = max(float(np.max(np.abs(got[k] - ref[part][k]))) if got[k].size else 0.0
                        for k in got)
            assert worst < 5e-3, (part, worst)


def test_vq_ema_allreduce_matches_global(dp_ranks):
    """``ema_update(axis_name="data")`` over 2 ranks, each with half of the
    rows, equals the JAX update over all of them."""
    for r in dp_ranks["ranks"]:
        for k, want in dp_ranks["ema_ref"].items():
            np.testing.assert_allclose(r["ema"][k], want, rtol=1e-5, atol=1e-5)
