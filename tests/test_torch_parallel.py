"""The port's parallel training (``rstnet_tpu_torch/parallel``) against the
JAX package on its 8-device virtual mesh: the mesh must not change the math.

The port's meshes run as 8 gloo ranks on the CPU, one torch thread each
(``tests/torch_parallel_ranks.py``: one start of the ranks for the whole
file). Each mesh trains one step of the tiny LM of ``tests/test_parallel.py``
from the JAX init and the same batch; rank 0 gathers the parameters whole.
Tolerances are the JAX test's: loss within 1e-3, parameters within 5e-3, of
both the JAX one-device step and the port's one-process step. Those alone
cannot see the gradient: the loss is taken before the update, and AdamW's
first step moves every element by about lr (1e-4 here) whatever the
gradient. So the gradient the optimizer took (its first moment over
``1 - b1``: reduced over the mesh, clipped) is held to both references too,
within ``GRAD_ATOL``.
"""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rstnet_tpu.core import flatten_dict
from rstnet_tpu.models.config import Config as JaxConfig
from rstnet_tpu.models.lm import SpeechTextLM as JaxLM
from rstnet_tpu.models.lora import attach_lora as jax_attach_lora
from rstnet_tpu.models.lora import init_lora as jax_init_lora
from rstnet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rstnet_tpu.parallel.sharding import _spec_for
from rstnet_tpu.training.schedulers import warmup_lr as jax_warmup_lr
from rstnet_tpu.training import train_step as jts
from rstnet_tpu_torch.parallel.mesh import AXES, mesh_sizes
from rstnet_tpu_torch.parallel.sharding import spec_for
from tests.test_parallel import CFG
from tests.torch_parallel_ranks import job_train_step, run_ranks

MESHES = {
    "dp8": {"data": 8, "fsdp": 1, "tensor": 1},
    "fsdp8": {"data": 1, "fsdp": 8, "tensor": 1},
    "dp2fsdp2tp2": {"data": 2, "fsdp": 2, "tensor": 2},
    "fsdp2tp4": {"data": 1, "fsdp": 2, "tensor": 4},
}
LOSS_ATOL, PARAM_ATOL = 1e-3, 5e-3
# float32 gradients of the same sums taken in another order (over ranks, in
# shards): rounding only, ~1e-7 of the largest element (up to ~0.1 here); a
# gradient kept local to a rank, summed twice or scaled wrong is off by a
# share of the whole one, orders more
GRAD_ATOL = 1e-5
# a clip below the step's gradient norm, and the finite check on: the
# norm over every shard and the ranks' one decision
CLIP = {"grad_clip": 0.5, "skip_nonfinite": 1}
LORA = dict(CFG, lora_r=2, lora_alpha=4, lora_query=True, lora_key=True, lora_value=True,
            lora_projection=True, lora_mlp=True, lora_head=True)
LORA_DROP = dict(LORA, lora_dropout=0.25)
FLAGSHIP_SMALL = dict(n_layer=2, n_embd=64, n_head=2, n_query_groups=2, intermediate_size=128,
                      padded_vocab_size=128, vocab_size=128, codecformer_dim=32,
                      codecformer_heads=2, codecformer_layers=1, codecformer_dim_feedforward=64,
                      lora_query=True)


def lm_setup(cfg: dict, B: int, S: int):
    """(JAX model, JAX params, flat numpy params, batch) as the JAX tests
    build them."""
    model = JaxLM(JaxConfig(**cfg))
    params = model.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(1)
    V = cfg["padded_vocab_size"]
    text = jax.random.randint(key, (B, 1, S), 0, V)
    audio = jax.random.randint(key, (B, 8, S), 0, 32)
    batch = {"tokens": np.asarray(jnp.concatenate([text, audio], 1)),
             "masks": np.ones((B, 9, S), np.float32)}
    flat = {k: np.array(v) for k, v in flatten_dict(params)}
    return model, params, flat, batch


def jax_one_device_step(model, params, batch, opt: dict | None = None):
    """The JAX step on one device (``opt``: more ``make_optimizer``
    arguments): (loss, flat params, flat gradients as the optimizer took
    them: its first moment over ``1 - b1``)."""
    tx = jts.make_optimizer(jax_warmup_lr(1e-3, 10), **(opt or {}))
    loss_fn = jts.make_loss_fn(model, audio_ignore_id=33, text_ignore_id=127)
    state = jts.init_train_state(params, tx)
    step = jts.make_train_step(loss_fn, tx, donate=False)
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
    mu = optax.tree_utils.tree_get(state["opt_state"], "mu")
    return (float(metrics["loss"]), {k: np.asarray(v) for k, v in flatten_dict(state["params"])},
            {k: np.asarray(v) / np.float32(1 - 0.9) for k, v in flatten_dict(mu)})


def worst_diff(got: dict, want: dict) -> float:
    assert set(got) == set(want)
    return max(float(np.max(np.abs(got[k] - want[k]))) for k in want)


def assert_step_matches(got, jax_ref, port_ref):
    """A mesh's (loss, params, gradients) against the JAX one-device step
    and the port's one-process step."""
    loss, params, grads = got
    for ref_loss, ref_params, ref_grads in (jax_ref, port_ref):
        assert abs(loss - ref_loss) < LOSS_ATOL, (loss, ref_loss)
        assert worst_diff(params, ref_params) < PARAM_ATOL
        worst = worst_diff(grads, ref_grads)
        assert worst < GRAD_ATOL, worst


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    model, params, flat, batch = lm_setup(CFG, 8, 12)
    lora_flat = lora_params(flat)
    jax_ref = jax_one_device_step(model, params, batch)
    port_ref = job_train_step(CFG, flat, batch, {"one": {"data": 1}})["one"]
    ranks = run_ranks(tmp_path_factory.mktemp("ranks"), 8, "suite", parts={
        "steps": ("train_step", dict(cfg=CFG, flat=flat, batch=batch, meshes=MESHES)),
        "shapes": ("mesh_shapes", dict(shapes=[None, {"data": -1, "tensor": 2},
                                               {"fsdp": 2, "seq": -1}])),
        "flagship": ("flagship_mesh", dict(cfg_overrides=FLAGSHIP_SMALL, seed=5,
                                           shape={"data": 2, "fsdp": 2, "tensor": 2})),
        "clipped": ("train_step", dict(cfg=CFG, flat=flat, batch=batch, opt=CLIP,
                                       meshes={"dp2fsdp2tp2": MESHES["dp2fsdp2tp2"]})),
        "lora": ("train_step", dict(cfg=LORA_DROP, flat=lora_flat, batch=batch,
                                    dropout_seed=3, meshes={
                                        "dp2fsdp2tp2": MESHES["dp2fsdp2tp2"],
                                        "fsdp2tp4": MESHES["fsdp2tp4"]})),
    })
    clip_ref = (jax_one_device_step(model, params, batch, CLIP),
                job_train_step(CFG, flat, batch, {"one": {"data": 1}}, opt=CLIP)["one"])
    lora_ref = {seed: job_train_step(LORA_DROP, lora_flat, batch, {"one": {"data": 1}},
                                     dropout_seed=seed)["one"] for seed in (3, None)}
    return {"jax": jax_ref, "port": port_ref, "ranks": ranks, "clip": clip_ref,
            "lora": lora_ref}


@pytest.mark.parametrize("name", list(MESHES))
def test_loss_invariant_to_mesh(tiny, name):
    """One train step gives the same loss and parameters on every mesh."""
    assert_step_matches(tiny["ranks"][0]["steps"][name], tiny["jax"], tiny["port"])


def test_clipped_step_invariant_to_mesh(tiny):
    """With the global-norm clip and the finite check, the mesh's step
    equals both one-device steps: the norm is taken over every shard once."""
    jax_ref, port_ref = tiny["clip"]
    assert_step_matches(tiny["ranks"][0]["clipped"]["dp2fsdp2tp2"], jax_ref, port_ref)
    assert worst_diff(port_ref[1], tiny["port"][1]) > 0, "the clip must change the step"
    assert worst_diff(port_ref[2], tiny["port"][2]) > 10 * GRAD_ATOL, "nor the gradient"


def lora_params(flat: dict) -> dict:
    """``flat`` with LoRA factors on every site (B nonzero, so the dropped
    branch moves the output), as the JAX tree names them."""
    from rstnet_tpu_torch.core import from_jax_params, to_numpy
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.models.lm import SpeechTextLM
    from rstnet_tpu_torch.models.lora import attach_lora, init_lora

    model = SpeechTextLM(Config(**LORA_DROP))
    attach_lora(model.backbone, init_lora(model.config, torch.Generator().manual_seed(0)))
    from_jax_params({**to_numpy(model, stacked=model.STACKED), **flat}, model,
                    stacked=model.STACKED)
    g = torch.Generator().manual_seed(11)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".B"):
                p.copy_(torch.randn(p.shape, generator=g) * 0.1)
    return to_numpy(model, stacked=model.STACKED)


@pytest.mark.parametrize("name", ["dp2fsdp2tp2", "fsdp2tp4"])
def test_lora_dropout_step_invariant_to_mesh(tiny, name):
    """LoRA on every site with branch dropout: each rank's masks are its
    rows of the one-process draw, and the column/row-parallel factors
    follow the weights, so the mesh's step equals the port's one-process
    step with the same dropout seed (which differs from the step without
    dropout)."""
    ref, no_drop = tiny["lora"][3], tiny["lora"][None]
    assert_step_matches(tiny["ranks"][0]["lora"][name], ref, ref)
    assert max(float(np.max(np.abs(ref[1][k] - no_drop[1][k]))) for k in ref[1]) > 1e-6


def test_port_one_process_step_matches_jax(tiny):
    assert_step_matches(tiny["port"], tiny["jax"], tiny["jax"])


def test_every_rank_returns_the_same_loss(tiny):
    for name in MESHES:
        losses = {r["steps"][name][0] for r in tiny["ranks"]}
        assert len(losses) == 1, (name, losses)


def _jax_leaves(cfg: dict, lora: bool = False):
    model = JaxLM(JaxConfig(**cfg))
    params = model.init(jax.random.PRNGKey(0))
    if lora:
        params["backbone"] = jax_attach_lora(
            params["backbone"], jax_init_lora(model.config, jax.random.PRNGKey(7), jnp.float32))
    return jax.tree_util.tree_leaves_with_path(params)


SPEC_MESHES = [*MESHES.values(), {"pipe": 2, "data": 2, "fsdp": 2},
               {"expert": 4, "fsdp": 2}, {"pipe": 4, "tensor": 2}]
MOE = dict(CFG, mlp_class_name="LLaMAMoE", intermediate_size=48, n_expert=4,
           n_expert_per_token=2)


@pytest.mark.parametrize("shape", SPEC_MESHES, ids=lambda s: "-".join(f"{k}{v}" for k, v in
                                                                         s.items()))
@pytest.mark.parametrize("cfg,lora", [(CFG, False), (MOE, False), (LORA, True)],
                         ids=["dense", "moe", "lora"])
def test_spec_for_equals_jax(shape, cfg, lora):
    """``spec_for`` is JAX's ``_spec_for`` on every leaf (the JAX path and
    stacked shape), on the test meshes and on pipe and expert meshes."""
    n = math.prod(shape.values())
    mesh = jax_make_mesh(shape, devices=jax.devices()[:n])
    sizes = dict(mesh.shape)
    for path, leaf in _jax_leaves(cfg, lora):
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", ""))) for p in path)
        want = tuple(_spec_for(path, leaf, mesh))
        want = want + (None,) * (np.ndim(leaf) - len(want))
        assert spec_for(name, np.shape(leaf), sizes) == want, name


@pytest.mark.parametrize("shape", [None, {"data": -1, "tensor": 2}, {"fsdp": 2, "seq": -1},
                                   {"data": 8}, {"data": 3}, {"tensor": 3, "data": -1},
                                   {"data": 2, "fsdp": 2}])
def test_make_mesh_sizes_equal_jax(shape):
    """The absorption of ``-1``, the all-``fsdp`` default and the errors of
    a product that does not match: the port's sizes for 8 ranks are JAX's
    for 8 devices, and both raise ValueError on the same shapes."""
    try:
        want = dict(jax_make_mesh(shape).shape)
    except ValueError:
        with pytest.raises(ValueError):
            mesh_sizes(shape, 8)
        return
    assert dict(zip(AXES, mesh_sizes(shape, 8))) == {a: want.get(a, 1) for a in AXES}


def test_make_mesh_on_eight_ranks(tiny):
    """``make_mesh`` over the 8 ranks absorbs as ``mesh_sizes`` says."""
    got = tiny["ranks"][0]["shapes"]
    assert got[0] == dict(zip(AXES, (1, 1, 1, 8, 1, 1)))
    assert got[1]["data"] == 4 and got[1]["tensor"] == 2
    assert got[2]["seq"] == 4 and got[2]["fsdp"] == 2


def test_make_mesh_one_process_raises_as_jax():
    from rstnet_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(ValueError, match="covers 2 devices but 1 are visible"):
        make_mesh({"data": 2})
    assert make_mesh({"data": -1}).shape["data"] == 1
    assert torch.distributed.is_initialized() is False


def test_build_peft_8b_places_leaves_as_created(tiny):
    """``build_peft_8b(..., mesh=)`` (a small config, 8 ranks): each rank
    holds its shards only, and the leaves gathered whole equal the
    one-device build from the same seed, int8 base included."""
    from rstnet_tpu_torch.core import tensor_to_numpy
    from rstnet_tpu_torch.training.flagship8b import build_peft_8b, flagship_8b_config

    cfg = flagship_8b_config(device="cpu", **FLAGSHIP_SMALL)
    model, trainable, frozen, _ = build_peft_8b(torch.Generator().manual_seed(5), cfg,
                                                device="cpu")
    want = {k: tensor_to_numpy(v) for k, v in model.state_dict().items()}
    got = tiny["ranks"][0]["flagship"]
    assert set(got["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got["params"][k].view(np.uint8), v.view(np.uint8))
    whole = sum(p.numel() * p.element_size() for p in model.parameters())
    assert all(r["flagship"]["held"] < whole / 2 for r in tiny["ranks"])
    assert sorted(trainable) == got["trainable"] and sorted(frozen) == got["frozen"]


def test_batch_slice_rows_and_steps_by_rank():
    """Every rank's part of a global batch (rows over data x fsdp, steps
    over seq), and of a host's batch when ranks run on hosts; a host whose
    ranks' tensor line spans another host is refused."""
    from rstnet_tpu_torch.parallel.mesh import Mesh
    from rstnet_tpu_torch.parallel.sharding import batch_slice

    def mesh(shape):
        return Mesh([shape.get(a, 1) for a in AXES], AXES, "cpu")

    tokens = np.arange(8 * 3 * 12).reshape(8, 3, 12)
    m = mesh({"data": 2, "seq": 2, "fsdp": 2})
    parts = {r: batch_slice(m, {"t": tokens}, rank=r)["t"] for r in range(8)}
    for r, p in parts.items():
        row = m.coord("data", r) * 2 + m.coord("fsdp", r)
        s = m.coord("seq", r)
        np.testing.assert_array_equal(p, tokens[2 * row:2 * row + 2, :, 6 * s:6 * s + 6])
    m = mesh({"data": 4, "tensor": 2})  # 2 hosts of 4 ranks: data 0-1, then 2-3
    host_batch = tokens[:4]
    for r in range(8):
        got = batch_slice(m, {"t": host_batch}, rank=r, hosts=2)["t"]
        local = m.coord("data", r) % 2
        np.testing.assert_array_equal(got, host_batch[2 * local:2 * local + 2])
    with pytest.raises(ValueError, match="must lie within its host"):
        batch_slice(mesh({"data": 2, "tensor": 4}), {"t": tokens}, rank=0, hosts=4)
    with pytest.raises(ValueError, match="not divisible"):
        batch_slice(mesh({"data": 8}), {"t": tokens[:6]}, rank=0)
