"""LoRA, LoRA-branch dropout, the prefix-LM mask, MoE and the flagship-8B
construction of the port (``rstnet_tpu_torch/models/lora.py``,
``models/backbone.py``, ``modules/transformer.py``, ``ops/attention.py``,
``training/flagship8b.py``) against the JAX package on the CPU, float32.

JAX overlays (random A, and B made nonzero so the branch shows) cross the
numpy bridge into the port's factor modules unchanged. Tolerances: logits
2e-5 of their scale (float32 sums in another order); gradients 1e-5 of each
leaf's largest magnitude; a merged forward 2e-5, as the JAX test holds its
own. JAX's dropout bits cannot be drawn in torch: dropout parity feeds both
sides JAX's mask, and the rest is checked by its statistics."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu.models import lora as jlora
from rstnet_tpu.models.backbone import Backbone as JaxBackbone
from rstnet_tpu.models.config import Config as JaxConfig
from rstnet_tpu_torch.core import from_jax_params, lora_dropout, stack_layers, tensor_to_numpy
from rstnet_tpu_torch.models import lora
from rstnet_tpu_torch.models.backbone import STACKED, Backbone
from rstnet_tpu_torch.models.config import Config

LOGIT_TOL = 2e-5
GRAD_TOL = 1e-5
CFG = dict(
    name="test-tiny", block_size=64, vocab_size=96, padded_vocab_size=96,
    n_layer=2, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64, context=None,
    lora_r=4, lora_alpha=8, lora_query=True, lora_key=True, lora_value=True,
    lora_projection=True, lora_mlp=True, lora_head=True,
)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(tree)}


def _randomize_b(params, key):
    """Every LoRA B factor nonzero (the JAX tests' ``_randomize_b``)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for i, (path, leaf) in enumerate(leaves):
        if any(getattr(p, "key", None) == "B" for p in path):
            leaf = jax.random.normal(jax.random.fold_in(key, i), leaf.shape, leaf.dtype) * 0.1
        out.append(leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


def backbone_pair(**over):
    """(JAX backbone, its params with a JAX overlay and nonzero B, the port's
    backbone carrying the same values, factors included)."""
    d = dict(CFG, **over)
    jcfg, cfg = JaxConfig(**d), Config(**d)
    jb = JaxBackbone(jcfg)
    params = jlora.attach_lora(jb.init(jax.random.PRNGKey(0)),
                               jlora.init_lora(jcfg, jax.random.PRNGKey(1)))
    params = _randomize_b(params, jax.random.PRNGKey(2))
    tb = Backbone(cfg)
    lora.attach_lora(tb, lora.init_lora(cfg))
    from_jax_params(_flat(params), tb, stacked=STACKED)
    return jb, params, tb, cfg


def _tokens(seed, B=2, T=8, vocab=96):
    return np.random.default_rng(seed).integers(0, vocab, (B, T))


def _close(got, want, tol=LOGIT_TOL):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()))


def test_zero_init_is_identity():
    """B = 0 at init: the LoRA model is the base model; with the JAX
    overlay carried over (B nonzero), the forward equals JAX's."""
    cfg = Config(**CFG)
    tb = Backbone(cfg, generator=torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_tokens(2))
    with torch.no_grad():
        base = tb.forward_tokens(tokens)
        lora.attach_lora(tb, lora.init_lora(cfg, torch.Generator().manual_seed(1)))
        assert torch.equal(tb.forward_tokens(tokens), base)
    jb, params, tb, _ = backbone_pair()
    with torch.no_grad():
        got = tb.forward_tokens(tokens)
    _close(got, jb.forward_tokens(params, jnp.asarray(tokens.numpy())))


def test_merge_matches_unmerged_forward():
    """Merged weights (the factors folded in, q/k/v scattered into the packed
    rows) give the unmerged forward, equal JAX's ``merge_lora``, and leave
    the module as it was."""
    jb, params, tb, cfg = backbone_pair()
    tokens = torch.from_numpy(_tokens(3))
    before = {k: v.clone() for k, v in tb.state_dict().items()}
    merged = lora.merge_lora(cfg, tb)
    assert not any(lora.is_lora_path(k) for k in merged)
    assert all(torch.equal(v, tb.state_dict()[k]) for k, v in before.items())
    want = _flat(jlora.merge_lora(jb.cfg, params))
    got = stack_layers({k: tensor_to_numpy(v) for k, v in merged.items()}, STACKED)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)
    plain = Backbone(cfg)
    plain.load_state_dict(merged)
    with torch.no_grad():
        _close(plain.forward_tokens(tokens), tb.forward_tokens(tokens).numpy())


def test_trainable_mask_and_strip():
    cfg = Config(**CFG)
    tb = Backbone(cfg)
    base_names = set(tb.state_dict())
    lora.attach_lora(tb, lora.init_lora(cfg))
    mask = lora.lora_trainable_mask(tb)
    assert any(mask.values()) and not all(mask.values())
    # A and B per adapted linear: (q, k, v + proj + 3 MLP) per layer, and the head
    assert sum(mask.values()) == 2 * (3 + 1 + 3) * cfg.n_layer + 2
    lora.strip_lora(tb)
    assert set(tb.state_dict()) == base_names


def test_lora_filter_round_trip():
    """``lora_filter`` keeps exactly the factors (the JAX overlay's leaves),
    and ``attach_lora`` of them onto a fresh base rebuilds the model."""
    jb, params, tb, cfg = backbone_pair()
    adapters = lora.lora_filter(tb.state_dict())
    overlay = stack_layers({k: tensor_to_numpy(v) for k, v in adapters.items()}, STACKED)
    assert set(overlay) == set(_flat(jlora.lora_filter(params)))
    rebuilt = Backbone(cfg)
    rebuilt.load_state_dict({k: v for k, v in tb.state_dict().items()
                             if not lora.is_lora_path(k)})
    lora.attach_lora(rebuilt, {k: v.clone() for k, v in adapters.items()})
    for k, v in tb.state_dict().items():
        assert torch.equal(rebuilt.state_dict()[k], v), k


def test_lora_gradients_match_jax_grad():
    """Gradients of a loss through the LoRA forward, factors and base."""
    jb, params, tb, _ = backbone_pair()
    tokens = _tokens(4)

    def jloss(p):
        return jnp.sum(jnp.tanh(jb.forward_tokens(p, jnp.asarray(tokens))))

    want = _flat(jax.grad(jloss)(params))
    for p in tb.parameters():
        p.requires_grad_(True)
    torch.tanh(tb.forward_tokens(torch.from_numpy(tokens))).sum().backward()
    got = stack_layers({n: tensor_to_numpy(p.grad) for n, p in tb.named_parameters()}, STACKED)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_TOL * max(1e-3, np.abs(w).max()), err_msg=k)


# -- LoRA-branch dropout ------------------------------------------------------

DROP_CFG = dict(
    name="tiny", block_size=64, vocab_size=256, padded_vocab_size=256,
    n_layer=2, n_head=4, n_embd=32, n_query_groups=4, intermediate_size=64,
    norm_class_name="RMSNorm", mlp_class_name="LLaMAMLP", context=64,
    audio_card=2050, n_q=8, dep_q=8, codecformer_dim=16, codecformer_heads=2,
    codecformer_layers=1, codecformer_dim_feedforward=32,
    lora_r=4, lora_alpha=8, lora_dropout=0.5,
    lora_query=True, lora_key=True, lora_value=True, lora_projection=True,
    lora_mlp=True, lora_head=True,
)


def speech_lm(**over):
    """The port's SpeechTextLM with LoRA attached and every B nonzero."""
    from rstnet_tpu_torch.models.lm import SpeechTextLM

    cfg = Config(**dict(DROP_CFG, **over))
    m = SpeechTextLM(cfg, generator=torch.Generator().manual_seed(0))
    overlay = lora.init_lora(cfg, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    lora.attach_lora(m.backbone, {k: v if not k.endswith(".B") else
                                  torch.randn(v.shape, generator=g) * 0.1
                                  for k, v in overlay.items()})
    seq = torch.from_numpy(np.random.default_rng(3).integers(0, 200, (2, 9, 6)))
    return m, seq


def test_no_rng_is_deterministic_baseline():
    m, seq = speech_lm()
    with torch.no_grad():
        a1, t1 = m(seq)
        a2, t2 = m(seq, dropout_rng=None)
    assert torch.equal(a1, a2) and torch.equal(t1, t2)


def test_dropout_changes_output_and_varies_with_rng():
    m, seq = speech_lm()
    with torch.no_grad():
        base, text_base = m(seq)
        d1, t1 = m(seq, dropout_rng=torch.Generator().manual_seed(10))
        d1b, _ = m(seq, dropout_rng=torch.Generator().manual_seed(10))
        d2, _ = m(seq, dropout_rng=torch.Generator().manual_seed(11))
    assert not torch.allclose(base, d1) and not torch.allclose(d1, d2)
    assert torch.equal(d1, d1b)  # the same generator seed, the same masks
    assert not torch.allclose(text_base, t1)  # lora_head dropout reaches the text logits
    assert torch.isfinite(d1).all() and torch.isfinite(t1).all()


def test_rate_zero_ignores_rng():
    m, seq = speech_lm(lora_dropout=0.0)
    with torch.no_grad():
        a1, _ = m(seq)
        a2, _ = m(seq, dropout_rng=torch.Generator().manual_seed(10))
    assert torch.equal(a1, a2)


def test_lora_dropout_statistics_and_jax_mask(monkeypatch):
    """Inverted dropout: kept elements scaled by 1 / keep, the keep share
    within 4 sigma of 1 - rate, the mean kept; and, given JAX's own mask
    (``torch.rand`` patched to it), the same output as JAX's function."""
    from rstnet_tpu.core import lora_dropout as jax_dropout

    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 256)).astype(np.float32))
    rate = 0.3
    y = lora_dropout(x, (rate, torch.Generator().manual_seed(0)))
    kept = y != 0
    n = x.numel()
    assert abs(kept.float().mean().item() - (1 - rate)) < 4 * (rate * (1 - rate) / n) ** 0.5
    torch.testing.assert_close(y[kept], x[kept] / (1 - rate), rtol=1e-6, atol=0)
    assert torch.equal(lora_dropout(x, None), x) and torch.equal(lora_dropout(x, (0.0, None)), x)
    key = jax.random.PRNGKey(3)
    jmask = np.asarray(jax.random.bernoulli(key, 1 - rate, x.shape))
    monkeypatch.setattr(torch, "rand", lambda *a, **k: torch.from_numpy(
        np.where(jmask, 0.0, 1.0).astype(np.float32)))
    got = lora_dropout(x, (rate, torch.Generator()))
    want = np.asarray(jax_dropout(jnp.asarray(x.numpy()), (rate, key)))
    np.testing.assert_array_equal(got.numpy(), want)


def test_moshi_lora_dropout():
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    m = MoshiLMModel(delays=(0,) * 5, n_q=4, dep_q=2, card=64, text_card=50, dim=32,
                     num_heads=4, num_layers=2, context=32, depformer_dim=16,
                     depformer_num_heads=2, depformer_num_layers=1, lora_dropout=0.5,
                     generator=torch.Generator().manual_seed(0))
    overlay = lora.init_lora_streaming_transformer(m.transformer, torch.Generator().manual_seed(1),
                                                   r=4, alpha=8)
    g = torch.Generator().manual_seed(2)
    lora.attach_lora(m.transformer, {k: torch.randn(v.shape, generator=g) if k.endswith(".B")
                                     else v for k, v in overlay.items()})
    seq = torch.from_numpy(np.random.default_rng(3).integers(0, 40, (1, 5, 6)))
    with torch.no_grad():
        base, _ = m(seq)
        d1, _ = m(seq, dropout_rng=torch.Generator().manual_seed(10))
        d2, _ = m(seq, dropout_rng=torch.Generator().manual_seed(11))
    assert not torch.allclose(base, d1) and not torch.allclose(d1, d2)
    assert torch.isfinite(d1).all()


def test_train_step_with_dropout_seed():
    """A step with a dropout seed trains the factors (B moves from 0) and
    is deterministic in (seed, step); so is the grad-accum variant; remat
    recomputes a block with the same masks (its gradients equal the
    unrematerialized ones)."""
    from rstnet_tpu_torch.models.lm import SpeechTextLM
    from rstnet_tpu_torch.training import schedulers, train_step

    cfg = Config(**DROP_CFG)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 200, (2, 9, 6)))
    batch = {"tokens": tokens, "masks": torch.ones((2, 9, 6))}
    runs = []
    for remat, accum in ((False, 1), (True, 1), (False, 2)):
        m = SpeechTextLM(Config(**dict(DROP_CFG, remat=remat)),
                         generator=torch.Generator().manual_seed(0))
        lora.attach_lora(m.backbone, lora.init_lora(cfg, torch.Generator().manual_seed(1)))
        tx = train_step.make_optimizer(schedulers.constant_lr(1e-3))
        state = train_step.init_train_state(m, tx, lora.lora_trainable_mask(m))
        step = train_step.make_train_step(train_step.make_loss_fn(m), tx, grad_accum=accum,
                                          dropout_seed=7)
        b = batch if accum == 1 else {k: torch.stack([v, v]) for k, v in batch.items()}
        state, metrics = step(state, b)
        assert np.isfinite(float(metrics["loss"]))
        B = m.backbone.blocks[0].attn.lora_q.B
        assert B.abs().sum() > 0
        runs.append((float(metrics["loss"]), B.detach().clone()))
    assert runs[0][0] == pytest.approx(runs[1][0], rel=1e-6)
    torch.testing.assert_close(runs[1][1], runs[0][1], rtol=0, atol=1e-6)


# -- the prefix-LM mask, the streaming transformer, MoE, flagship 8B ------------


def test_prefix_lm_mask_semantics():
    from rstnet_tpu.ops.attention import prefix_lm_mask as jax_mask
    from rstnet_tpu_torch.ops.attention import prefix_lm_mask

    # prefix = 2 steps, target = 3 steps, padding = 2 steps
    loss_mask = torch.tensor([[False, False, True, True, True, False, False]])
    m = prefix_lm_mask(loss_mask)
    assert m.shape == (1, 7, 7)
    assert m[0, 0, 1] and m[0, 1, 0]  # the prefix sees itself both ways
    assert m[0, 3, 2] and not m[0, 3, 4]  # targets are causal
    assert not m[0, :, 5].any() and not m[0, :, 6].any()  # padding is never a key
    assert not prefix_lm_mask(loss_mask, prefix_lm=False)[0, 0, 1]
    rng = np.random.default_rng(0)
    masks = np.zeros((6, 12), bool)
    for row in masks:
        start = rng.integers(0, 10)
        row[start:rng.integers(start + 1, 13)] = True
    for prefix in (True, False):
        np.testing.assert_array_equal(prefix_lm_mask(torch.from_numpy(masks), prefix).numpy(),
                                      np.asarray(jax_mask(jnp.asarray(masks), prefix)))


def test_streaming_transformer_lora():
    """Zero-init B: the same output; a JAX overlay with B nonzero carried
    over: JAX's output and gradients."""
    from rstnet_tpu.modules.transformer import StreamingTransformer as JT
    from rstnet_tpu_torch.modules.transformer import StreamingTransformer

    kw = dict(d_model=32, num_heads=4, num_layers=2, dim_feedforward=64, causal=True,
              context=16, gating="silu", norm="rms_norm_f32", positional_embedding="rope")
    jt, tt = JT(**kw), StreamingTransformer(**kw, generator=torch.Generator().manual_seed(0))
    x = np.random.default_rng(2).standard_normal((2, 8, 32)).astype(np.float32)
    with torch.no_grad():
        base = tt(torch.from_numpy(x))
        lora.attach_lora(tt, lora.init_lora_streaming_transformer(
            tt, torch.Generator().manual_seed(1), r=4, alpha=8))
        assert torch.equal(tt(torch.from_numpy(x)), base)
    overlay = jlora.init_lora_streaming_transformer(jt, jax.random.PRNGKey(1), r=4, alpha=8)
    params = jlora.attach_lora(jt.init(jax.random.PRNGKey(0)), overlay)
    params = _randomize_b(params, jax.random.PRNGKey(3))
    from_jax_params(_flat(params), tt)

    def jloss(p):
        return jnp.sum(jnp.tanh(jt(p, jnp.asarray(x))))

    want_out = np.asarray(jt(params, jnp.asarray(x)))
    want = _flat(jax.grad(jloss)(params))
    for p in tt.parameters():
        p.requires_grad_(True)
    y = tt(torch.from_numpy(x))
    _close(y, want_out)
    assert not np.allclose(y.detach().numpy(), base.numpy())
    torch.tanh(y).sum().backward()
    for n, p in tt.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], rtol=0,
                                   atol=GRAD_TOL * max(1e-3, np.abs(want[n]).max()), err_msg=n)


def test_moe_forward():
    """LLaMAMoE (4 experts, top 2): logits and gradients against JAX."""
    d = dict(CFG, lora_r=0, mlp_class_name="LLaMAMoE", n_expert=4, n_expert_per_token=2)
    jb = JaxBackbone(JaxConfig(**d))
    params = jb.init(jax.random.PRNGKey(0))
    tb = from_jax_params(_flat(params), Backbone(Config(**d)), stacked=STACKED)
    tokens = _tokens(1, 2, 6)

    def jloss(p):
        return jnp.sum(jnp.tanh(jb.forward_tokens(p, jnp.asarray(tokens))))

    want = _flat(jax.grad(jloss)(params))
    for p in tb.parameters():
        p.requires_grad_(True)
    logits = tb.forward_tokens(torch.from_numpy(tokens))
    assert logits.shape == (2, 6, 96) and torch.isfinite(logits).all()
    _close(logits, jb.forward_tokens(params, jnp.asarray(tokens)))
    torch.tanh(logits).sum().backward()
    got = stack_layers({n: tensor_to_numpy(p.grad) for n, p in tb.named_parameters()}, STACKED)
    assert "blocks.mlp.experts.fc_1.weight" in got and set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0,
                                   atol=GRAD_TOL * max(1e-3, np.abs(w).max()), err_msg=k)


def test_abstract_8b_structure():
    """The meta build of the flagship PEFT model: every leaf's shape and
    dtype, and the mask, equal JAX's ``eval_shape`` tree; true 8B geometry,
    under 8 % trains, the int8 base frozen, the budget of one 80 GB card."""
    from rstnet_tpu.training.flagship8b import abstract_peft_8b as jax_abstract
    from rstnet_tpu_torch.training.flagship8b import abstract_peft_8b, bytes_table

    model, mask = abstract_peft_8b()
    _, shapes, jmask = jax_abstract()
    want = {k: (tuple(s.shape), str(s.dtype)) for k, s in flatten_dict(shapes)}
    want_mask = dict(flatten_dict(jmask))
    got, got_mask = {}, {}
    for name, p in model.named_parameters():
        assert p.device.type == "meta"
        parts = name.split(".")
        if parts[:2] == ["backbone", "blocks"]:
            key = ".".join(["backbone", "blocks", *parts[3:]])
            shape = (model.config.n_layer, *p.shape)
        else:
            key, shape = name, tuple(p.shape)
        got[key] = (shape, str(p.dtype).removeprefix("torch."))
        got_mask.setdefault(key, set()).add(mask[name])
    assert got == want
    assert {k: v.pop() for k, v in got_mask.items() if len(v) == 1} == want_mask
    trainable = {n: p for n, p in model.named_parameters() if mask[n]}
    frozen = {n: p for n, p in model.named_parameters() if not mask[n]}
    n_total = sum(p.numel() for p in model.parameters())
    assert 8.0e9 < n_total < 9.2e9
    assert sum(p.numel() for p in trainable.values()) < 0.08 * n_total
    assert any(p.dtype == torch.int8 for p in frozen.values())
    assert all(p.dtype != torch.int8 for p in trainable.values())
    fb, tb = bytes_table(frozen)["total_gb"], bytes_table(trainable)["total_gb"]
    assert fb + 3 * tb < 80 - 3.0, (fb, tb)


def test_build_peft_8b_materializes_leaf_by_leaf():
    """``build_peft_8b`` on a small config, on the CPU: every leaf leaves
    the meta device, int8 leaves random bytes, float leaves N(0, 0.02) from
    the generator (the same seed, the same values), and the split along
    the mask sets ``requires_grad``."""
    from rstnet_tpu_torch.training.flagship8b import build_peft_8b, flagship_8b_config

    cfg = flagship_8b_config(device="cpu", n_layer=1, n_embd=64, n_head=2, n_query_groups=1,
                             intermediate_size=128, padded_vocab_size=128, vocab_size=128,
                             codecformer_dim=32, codecformer_heads=2, codecformer_layers=1,
                             codecformer_dim_feedforward=64, lora_query=True)
    runs = [build_peft_8b(torch.Generator().manual_seed(5), cfg, device="cpu") for _ in range(2)]
    model, trainable, frozen, mask = runs[0]
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    w = model.backbone.blocks[0].attn.w_int8
    assert w.dtype == torch.int8 and len(torch.unique(w)) > 100
    a = model.backbone.blocks[0].attn.lora_q.A
    assert abs(a.float().std().item() - 0.02) < 0.005
    for (n, p), q in zip(model.named_parameters(), runs[1][0].parameters()):
        assert torch.equal(p, q), n


def test_8b_fsdp_sharding_math():
    """The fsdp mesh divides the 8B PEFT state (JAX
    ``test_8b_fsdp_sharding_math``): a rank's bytes of parameters plus
    Adam's two moments over the trainable ones are within twice the ideal
    whole / 8 and under 4 GiB, and the int8 QKV stack is split 8 ways. From
    the shapes alone (the meta model)."""
    from rstnet_tpu_torch.parallel.sharding import infer_param_placements, shard_bytes
    from rstnet_tpu_torch.training.flagship8b import abstract_peft_8b

    mesh = {"data": 1, "fsdp": 8, "tensor": 1}
    model, mask = abstract_peft_8b()
    placements = infer_param_placements(mesh, model)
    params = dict(model.named_parameters())
    trainable = {n: p for n, p in params.items() if mask[n]}
    frozen = {n: p for n, p in params.items() if not mask[n]}
    per_rank = shard_bytes(placements, frozen, mesh) + 3 * shard_bytes(placements, trainable, mesh)
    full = sum(p.numel() * p.element_size() for p in params.values())
    assert per_rank < full / 8 * 2, (per_rank / 2**30, full / 2**30)
    assert per_rank / 2**30 < 4.0
    qkv = "backbone.blocks.0.attn.w_int8"
    assert params[qkv].dtype == torch.int8 and "fsdp" in placements[qkv].spec
    assert shard_bytes(placements, {qkv: params[qkv]}, mesh) == params[qkv].numel() // 8
