"""The partitioned PEFT step over an int8 frozen base, the trainer's LoRA,
``--base_int8`` and Moshi modes, and the Moshi training forwards of the
port, against the JAX package on the CPU, float32.

Tolerances: loss and metrics 1e-5 relative (float32 sums in another order);
logits 2e-5 of their scale; gradients 1e-5 of each leaf's largest
magnitude. Trainable parameters after AdamW steps are held against the
farthest the updates could move them (the sum of the learning rates): every
element within 5 % of it, as ``tests/test_torch_train_step.py`` holds the
full step."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu.models import lora as jlora
from rstnet_tpu.models.backbone import quantize_backbone_int8 as jax_quantize
from rstnet_tpu.models.config import Config as JaxConfig
from rstnet_tpu.models.lm import SpeechTextLM as JaxLM
from rstnet_tpu.training import schedulers as jax_sched
from rstnet_tpu.training import train_step as jts
from rstnet_tpu_torch.core import from_jax_params, stack_layers, tensor_to_numpy
from rstnet_tpu_torch.models import lora
from rstnet_tpu_torch.models.backbone import quantize_backbone_int8
from rstnet_tpu_torch.models.config import Config
from rstnet_tpu_torch.models.lm import SpeechTextLM
from rstnet_tpu_torch.training import schedulers, train_step
from rstnet_tpu_torch.training.trainer import SPEECH_LORA_TRAINABLE
from tests.test_trainer import _trainer_args, _write_synthetic

METRIC_RTOL = 1e-5
LOGIT_TOL = 2e-5
GRAD_TOL = 1e-5
PARAM_STEP_FRACTION = 5e-2
CFG = dict(
    name="peft-tiny", block_size=64, vocab_size=96, padded_vocab_size=96,
    n_layer=2, n_head=4, n_embd=32, n_query_groups=2, rotary_percentage=1.0,
    parallel_residual=False, bias=False, norm_class_name="RMSNorm",
    mlp_class_name="LLaMAMLP", intermediate_size=64, context=32,
    audio_card=66, n_q=4, dep_q=4, codecformer_dim=16, codecformer_heads=2,
    codecformer_layers=2, codecformer_dim_feedforward=32,
    lora_r=4, lora_alpha=8, lora_mlp=True, lora_projection=True,
)
# the flagship's head dim, 128: two query heads over one KV head
CFG_D128 = dict(CFG, name="peft-tiny-d128", n_embd=256, n_head=2, n_query_groups=1)


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(tree)}


def _jax_mask(params):
    mask = jlora.lora_trainable_mask(params)
    for k in SPEECH_LORA_TRAINABLE:
        mask[k] = jax.tree.map(lambda _: True, params[k])
    return mask


def peft_pair(int8: bool, cfg: dict = CFG):
    """(JAX model, params, port model with the same values): LoRA on the
    backbone (B nonzero), and the backbone int8 when asked, on both sides;
    plus the port's trainable mask."""
    jm = JaxLM(JaxConfig(**cfg))
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    overlay = jlora.init_lora(jm.config, jax.random.PRNGKey(1), jnp.float32)
    overlay = jax.tree.map(lambda x: x + 0.05, overlay)  # B nonzero: the factors matter
    params["backbone"] = jlora.attach_lora(params["backbone"], overlay)
    if int8:
        params["backbone"] = jax_quantize(params["backbone"])
    tm = SpeechTextLM(Config(**cfg))
    lora.attach_lora(tm.backbone, lora.init_lora(tm.config))
    if int8:
        quantize_backbone_int8(tm.backbone)
    from_jax_params(_flat(params), tm, stacked=tm.STACKED)
    mask = {n: t or n.split(".")[0] in SPEECH_LORA_TRAINABLE
            for n, t in lora.lora_trainable_mask(tm).items()}
    return jm, params, tm, mask


def make_batch(seed, B=2, S=8, lead=()):
    rng = np.random.default_rng(seed)
    shape = lead + (B,)
    text = rng.integers(0, CFG["padded_vocab_size"], shape + (1, S))
    audio = rng.integers(0, CFG["audio_card"] - 2, shape + (CFG["n_q"], S))
    tokens = np.concatenate([text, audio], axis=-2)
    return tokens, np.ones(tokens.shape, np.float32)


def _batches(tokens, masks):
    return ({"tokens": torch.from_numpy(tokens), "masks": torch.from_numpy(masks)},
            {"tokens": jnp.asarray(tokens), "masks": jnp.asarray(masks)})


def _assert_trainable(tm, trainable_tree, lr_sum):
    got = stack_layers({n: tensor_to_numpy(p) for n, p in tm.named_parameters()
                        if p.requires_grad}, tm.STACKED)
    want = {k: np.asarray(v) for k, v in flatten_dict(trainable_tree) if v is not None}
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=PARAM_STEP_FRACTION * lr_sum,
                                   err_msg=k)


def test_partition_combine_roundtrip():
    _, _, tm, mask = peft_pair(int8=True)
    before = {n: p.clone() for n, p in tm.named_parameters()}
    trainable, frozen = train_step.partition_params(tm, mask)
    assert trainable and frozen and set(trainable) | set(frozen) == set(before)
    assert all(p.requires_grad for p in trainable.values())
    assert not any(p.requires_grad for p in frozen.values())
    assert any(p.dtype == torch.int8 for p in frozen.values())
    assert all(lora.is_lora_path(n) or n.split(".")[0] in SPEECH_LORA_TRAINABLE
               for n in trainable)
    back = train_step.combine_params(trainable, frozen)
    assert set(back) == set(before) and all(torch.equal(back[n], before[n]) for n in before)
    with pytest.raises(TypeError):  # an int8 leaf cannot train
        train_step.partition_params(tm, dict.fromkeys(mask, True))


@pytest.mark.parametrize("int8,cfg", [(False, CFG), (True, CFG), (True, CFG_D128)],
                         ids=["False", "True", "d128"])
def test_peft_step_matches_jax_peft_step(int8, cfg):
    """Two AdamW steps of the partitioned step (over an int8 frozen base, or
    a float one) against JAX's ``make_peft_train_step``: metrics, then the
    trainable parameters; the frozen ones are untouched. ``d128``: head dim
    128 over one KV head (the float32 fine-tune of the flagship, whose
    attention runs its plain version on the CPU)."""
    jm, params, tm, mask = peft_pair(int8, cfg)
    kw = dict(weight_decay=1e-2, grad_clip=1.0)
    jtx = jts.make_optimizer(jax_sched.warmup_lr(1e-3, 2), **kw)
    ttx = train_step.make_optimizer(schedulers.warmup_lr(1e-3, 2), **kw)
    jtrain, jfrozen = jts.partition_params(params, _jax_mask(params))
    jstate = jts.init_train_state(jtrain, jtx)
    jstep = jts.make_peft_train_step(jts.make_loss_fn(jm), jtx, donate=False)
    tstate = train_step.init_train_state(tm, ttx, mask)
    _, frozen = train_step.partition_params(tm, mask)
    frozen_before = {n: p.clone() for n, p in frozen.items()}
    tstep = train_step.make_peft_train_step(train_step.make_loss_fn(tm), ttx)
    for i in range(2):
        tb, jb = _batches(*make_batch(i))
        jstate, jmetrics = jstep(jstate, jfrozen, jb)
        tstate, tmetrics = tstep(tstate, frozen, tb)
        for k in jmetrics:
            np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=METRIC_RTOL,
                                       err_msg=k)
    _assert_trainable(tm, jstate["params"], sum(schedulers.warmup_lr(1e-3, 2)(i) for i in range(2)))
    assert all(torch.equal(p, frozen_before[n]) for n, p in frozen.items())
    assert set(tstate["opt_state"]["mu"]) == {n for n, m in mask.items() if m}


def test_peft_step_int8_frozen_base_learns():
    """Memorizing one batch over the int8 base: finite losses that fall,
    the frozen side bit-identical, no gradient ever on it, and the int8
    linear's backward keeps no float copy of a weight (it saves the int8
    codes and the scales only)."""
    _, _, tm, mask = peft_pair(int8=True)
    tx = train_step.make_optimizer(schedulers.warmup_lr(3e-3, 1))
    state = train_step.init_train_state(tm, tx, mask)
    _, frozen = train_step.partition_params(tm, mask)
    before = {n: p.clone() for n, p in frozen.items()}
    step = train_step.make_peft_train_step(train_step.make_loss_fn(tm), tx)
    batch, _ = _batches(*make_batch(0))
    saved = []

    def pack(t):
        saved.append((t.dtype, tuple(t.shape)))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        losses = [float(step(state, frozen, batch)[1]["loss"]) for _ in range(6)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    assert all(torch.equal(p, before[n]) and p.grad is None for n, p in frozen.items())
    big = {tuple(p.shape) for n, p in frozen.items() if p.dtype == torch.int8}
    assert not any(dtype.is_floating_point and shape in big for dtype, shape in saved)
    with pytest.raises(ValueError):  # the step checks the partition
        for p in frozen.values():
            if p.is_floating_point():
                p.requires_grad_(True)
        step(state, frozen, batch)


def test_peft_step_grad_accum_matches_full_batch():
    _, _, tm, mask = peft_pair(int8=True)
    tokens, masks = make_batch(3, B=4)
    big, _ = _batches(tokens, masks)
    micro = {k: v.reshape((2, 2) + v.shape[1:]) for k, v in big.items()}
    results = []
    for accum, batch in ((1, big), (2, micro)):
        m = peft_pair(int8=True)[2]
        tx = train_step.make_optimizer(schedulers.warmup_lr(1e-3, 10))
        state = train_step.init_train_state(m, tx, mask)
        _, frozen = train_step.partition_params(m, mask)
        step = train_step.make_peft_train_step(train_step.make_loss_fn(m), tx, grad_accum=accum)
        state, metrics = step(state, frozen, batch)
        results.append((float(metrics["loss"]),
                        {n: p.detach().clone() for n, p in m.named_parameters()
                         if p.requires_grad}))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=METRIC_RTOL)
    for n, p in results[0][1].items():
        torch.testing.assert_close(results[1][1][n], p, rtol=0, atol=1e-5)


def _cpu_args(tmp_path, exp, extra=()):
    return _trainer_args(tmp_path, exp, ("--device", "cpu", *extra))


def test_trainer_cli_base_int8(tmp_path):
    """``--base_int8`` through the trainer: trains, checkpoints only the
    trainable parameters (no int8 leaf, every LoRA factor), and resumes
    into a second epoch."""
    from rstnet_tpu_torch.training import trainer

    _write_synthetic(tmp_path)
    exp = tmp_path / "exp"
    flags = ("--lora_r", "4", "--base_int8", "true", "--lora_dropout", "0.1", "--n_epoch")
    first = trainer.main(_cpu_args(tmp_path, exp, flags + ("1",)))
    saved = torch.load(exp / "ep1.checkpoint" / "state.pt", weights_only=True)["params"]
    assert saved and all(t.dtype != torch.int8 for t in saved.values())
    assert any(lora.is_lora_path(n) for n in saved)
    assert all(lora.is_lora_path(n) or n.split(".")[0] in SPEECH_LORA_TRAINABLE for n in saved)
    second = trainer.main(_cpu_args(tmp_path, exp, flags + ("2",)))
    assert (exp / "ep2.checkpoint").is_dir() and {s["epoch"] for s in second["steps"]} == {2}
    assert all(np.isfinite(s["loss"]) for s in first["steps"] + second["steps"])


def test_trainer_lora_mode(tmp_path):
    """``--lora_r`` without the int8 base: the backbone's base weights stay
    as they were built, the factors and the codecformer side train."""
    from rstnet_tpu_torch.training import trainer

    _write_synthetic(tmp_path)
    exp = tmp_path / "exp_lora"
    trainer.main(_cpu_args(tmp_path, exp, ("--lora_r", "2", "--lora_alpha", "4",
                                           "--n_epoch", "1")))
    saved = torch.load(exp / "ep1.checkpoint" / "state.pt", weights_only=True)["params"]
    args = trainer.get_args(_cpu_args(tmp_path, exp, ("--lora_r", "2", "--lora_alpha", "4")))
    fresh = trainer.build_model(args, torch.device("cpu"), torch.float32)
    for n, t in fresh.state_dict().items():
        if n.startswith("backbone."):
            assert torch.equal(saved[n], t), n
    assert not torch.equal(saved["backbone.blocks.0.attn.lora_q.B"],
                           torch.zeros_like(saved["backbone.blocks.0.attn.lora_q.B"]))


# -- Moshi ---------------------------------------------------------------------

SMALL_MOSHI = dict(delays=(0,) * 9, n_q=8, dep_q=4, card=32, text_card=64, dim=32,
                   num_heads=4, num_layers=2, context=16, depformer_dim=16,
                   depformer_num_heads=2, depformer_num_layers=2)


def test_training_forward_shapes():
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel

    m = MoshiLMModel(**SMALL_MOSHI, generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    seq = torch.from_numpy(np.concatenate([rng.integers(0, 64, (2, 1, 5)),
                                           rng.integers(0, 32, (2, 8, 5))], 1))
    with torch.no_grad():
        audio_logits, text_logits = m(seq)
    assert audio_logits.shape == (2, 5, 4, 32)
    assert text_logits.shape == (2, 5, 64)


def test_moshi_forward_and_lora_gradients_match_jax():
    """``MoshiLMModel.forward`` with a JAX LoRA overlay (B nonzero) carried
    over: audio and text logits against JAX's ``__call__``, and the
    gradients of every trainable leaf (the factors and the depformer side,
    as the trainer marks them) against ``jax.grad``."""
    from rstnet_tpu.models.moshi_lm import MoshiLMModel as JM
    from rstnet_tpu_torch.models.moshi_lm import MoshiLMModel
    from rstnet_tpu_torch.training.trainer import MOSHI_LORA_TRAINABLE

    jm = JM(**SMALL_MOSHI)
    params = jm.init(jax.random.PRNGKey(0), jnp.float32)
    overlay = jlora.init_lora_streaming_transformer(jm.transformer, jax.random.PRNGKey(1), r=4,
                                                    alpha=8)
    params["transformer"] = jlora.attach_lora(params["transformer"],
                                              jax.tree.map(lambda x: x + 0.05, overlay))
    tm = MoshiLMModel(**SMALL_MOSHI)
    lora.attach_lora(tm.transformer, lora.init_lora_streaming_transformer(tm.transformer, r=4,
                                                                          alpha=8))
    from_jax_params(_flat(params), tm)
    rng = np.random.default_rng(2)
    seq = np.concatenate([rng.integers(0, 64, (2, 1, 6)), rng.integers(0, 32, (2, 8, 6))], 1)
    seq[:, 1:][rng.random((2, 8, 6)) < 0.1] = -1  # zero tokens

    def jloss(p):
        a, t = jm(p, jnp.asarray(seq))
        return jnp.sum(jnp.tanh(a)) + jnp.sum(jnp.tanh(t)), (a, t)

    (_, (ja, jt)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    mask = {n: t or n.split(".")[0] in MOSHI_LORA_TRAINABLE
            for n, t in lora.lora_trainable_mask(tm).items()}
    train_step.partition_params(tm, mask)
    a, t = tm(torch.from_numpy(seq))
    for got, want in ((a, ja), (t, jt)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=LOGIT_TOL * max(1.0, np.abs(want).max()))
    (torch.tanh(a).sum() + torch.tanh(t).sum()).backward()
    want = _flat(jgrads)
    trained = [n for n, p in tm.named_parameters() if p.requires_grad]
    assert any(lora.is_lora_path(n) for n in trained)
    assert "transformer.layers.in_proj" not in trained
    for n in trained:
        w = want[n]
        np.testing.assert_allclose(tm.get_parameter(n).grad.numpy(), w, rtol=0,
                                   atol=GRAD_TOL * max(1e-3, np.abs(w).max()), err_msg=n)


def _moshi_args(tmp_path, exp, extra=()):
    args = [a for a in _cpu_args(tmp_path, exp, ("--n_epoch", "1"))
            if a != "--model_config" and not str(a).endswith("model.yaml")]
    return args + ["--model_family", "moshi", "--moshi_dim", "32", "--moshi_num_layers", "2",
                   "--moshi_num_heads", "4", "--moshi_text_card", "512", "--n_q", "8",
                   "--dep_q", "4", *extra]


def test_trainer_moshi_family(tmp_path):
    """The pure Moshi path through the trainer, full parameters and LoRA on
    the temporal transformer (its base frozen, the depformer side trained),
    and ``--checkpoint_path`` on a Moshi file (the loaded weights cast to
    the run's dtype)."""
    from rstnet_tpu_torch.tools.upstream_layout import upstream_moshi, write_upstream
    from rstnet_tpu_torch.training import trainer

    _write_synthetic(tmp_path)
    full = trainer.main(_moshi_args(tmp_path, tmp_path / "full"))
    assert (tmp_path / "full" / "ep1.checkpoint").is_dir()
    out = trainer.main(_moshi_args(tmp_path, tmp_path / "lora", ("--lora_r", "2", "--lora_alpha",
                                                                 "4", "--lora_dropout", "0.1")))
    assert all(np.isfinite(s["loss"]) for s in full["steps"] + out["steps"])
    saved = torch.load(tmp_path / "lora" / "ep1.checkpoint" / "state.pt",
                       weights_only=True)["params"]
    args = trainer.get_args(_moshi_args(tmp_path, tmp_path / "lora"))
    fresh = trainer.build_model(args, torch.device("cpu"), torch.float32)
    assert torch.equal(saved["transformer.layers.in_proj"], fresh.transformer.layers.in_proj)
    assert not torch.equal(saved["depformer_in"], fresh.depformer_in)
    path = write_upstream(tmp_path / "moshi.safetensors", upstream_moshi(fresh))
    loaded = trainer.main(_moshi_args(tmp_path, tmp_path / "ckpt", ("--checkpoint_path",
                                                                    str(path))))
    assert np.isfinite(loaded["steps"][0]["loss"])
