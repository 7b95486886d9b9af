"""The port's context parallelism (``ops/context_parallel.py``, the ``seq``
axis) and expert parallelism (the ``expert`` axis) against the JAX package:
the mesh must not change the math.

The port's meshes run as 8 gloo ranks on the CPU, one torch thread each,
all in one start of the ranks (``tests/torch_parallel_ranks.py``). Each rank
of a ``seq`` mesh holds its time chunk; the chunks are joined by their seq
coordinate and held to JAX's dense attention. Tolerances are the JAX
tests': forward 2e-5, gradients 1e-4, the train step's loss 1e-3 and
parameters 5e-3 (of both the JAX one-device step and the port's
one-process step), the MoE forward 2e-4.
"""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rstnet_tpu.ops.attention import masked_attention
from rstnet_tpu_torch.ops.context_parallel import _num_neighbor_blocks, seq_axis_size
from rstnet_tpu_torch.parallel.sharding import spec_for
from tests.test_context_parallel import MOE_CFG, SP_CFG
from tests.test_torch_parallel import assert_step_matches, jax_one_device_step, lm_setup
from tests.torch_parallel_ranks import job_train_step, run_ranks

B, H, T, D = 2, 4, 64, 16
CASES = [{"context": c, "n_seq": n} for n in (2, 4, 8) for c in (8, 24, 64, None)]
WINDOW = {"context": None, "n_seq": 4, "window": 10, "softcap": 30.0}
GRAD = {"context": 24, "n_seq": 4}


def _qkv():
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    return [np.asarray(jax.random.normal(k, (B, H, T, D))) for k in ks]


def _joined(parts):
    """Rank results ``(seq coordinate, chunk)`` joined along time."""
    by = {}
    for i, chunk in parts:
        by[i] = chunk
    return np.concatenate([by[i] for i in sorted(by)], axis=2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    q, k, v = _qkv()
    model, params, flat, batch = lm_setup(SP_CFG, 4, 16)
    moe_model, moe_params, moe_flat, _ = lm_setup(MOE_CFG, 4, 8)
    key = jax.random.PRNGKey(1)
    seq = np.asarray(jnp.concatenate([jax.random.randint(key, (4, 1, 8), 0, 64),
                                      jax.random.randint(key, (4, 8, 8), 0, 32)], axis=1))
    out = run_ranks(tmp_path_factory.mktemp("ranks"), 8, "suite", parts={
        "attn": ("context_parallel", dict(q=q, k=k, v=v, cases=CASES + [WINDOW],
                                          grad_case=GRAD)),
        "step": ("train_step", dict(cfg=SP_CFG, flat=flat, batch=batch,
                                    meshes={"seq4fsdp2": {"seq": 4, "fsdp": 2}})),
        "moe": ("moe_forward", dict(cfg=MOE_CFG, flat=moe_flat, seq=seq,
                                    shape={"expert": 4, "fsdp": 2})),
    })
    return {"ranks": out, "qkv": (q, k, v), "sp": (model, params, flat, batch),
            "moe": (moe_model, moe_params, seq)}


def _dense(q, k, v, context):
    pos = jnp.arange(T)
    return np.asarray(masked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, pos,
                                       context=context))


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=[f"context{c['context']}-seq{c['n_seq']}" for c in CASES])
def test_forward_matches_dense(ranks, index):
    case = CASES[index]
    got = _joined([r["attn"]["outs"][index] for r in ranks["ranks"]])
    np.testing.assert_allclose(got, _dense(*ranks["qkv"], case["context"]), atol=2e-5)


def test_grad_matches_dense(ranks):
    q, k, v = (jnp.asarray(a) for a in ranks["qkv"])
    pos = jnp.arange(T)
    want = jax.grad(lambda q, k, v: jnp.sum(masked_attention(q, k, v, pos, pos, context=24) ** 2),
                    argnums=(0, 1, 2))(q, k, v)
    parts = [r["attn"]["grads"] for r in ranks["ranks"]]
    for n, w in enumerate(want):
        got = _joined([(i, grads[n]) for i, grads in parts])
        np.testing.assert_allclose(got, np.asarray(w), atol=1e-4)


def test_sliding_window_and_softcap(ranks):
    """window=10 on an unbounded context, logits through the softcap."""
    q, k, v = (jnp.asarray(a) for a in ranks["qkv"])
    pos = jnp.arange(T)
    logits = jnp.einsum("bhtd,bhsd->bhts", q, k, preferred_element_type=jnp.float32)
    logits = jnp.tanh(logits / math.sqrt(D) / 30.0) * 30.0
    delta = pos[:, None] - pos[None, :]
    logits = jnp.where(((delta >= 0) & (delta < 10))[None, None], logits, float("-inf"))
    want = jnp.einsum("bhts,bhsd->bhtd", jax.nn.softmax(logits, -1), v)
    got = _joined([r["attn"]["outs"][len(CASES)] for r in ranks["ranks"]])
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)


def test_seq_axis_size_no_mesh():
    assert seq_axis_size() == 1


@pytest.mark.parametrize("t_local,context,n,want", [(16, 24, 4, 2), (16, None, 4, 3),
                                                     (8, 8, 8, 1), (64, 64, 2, 1),
                                                     (32, 1, 2, 0)])
def test_num_neighbor_blocks(t_local, context, n, want):
    from rstnet_tpu.ops.context_parallel import _num_neighbor_blocks as jax_blocks

    assert _num_neighbor_blocks(t_local, context, n) == jax_blocks(t_local, context, n) == want


def test_train_step_invariant_to_seq_mesh(ranks):
    """A sequence-parallel train step equals the one-device step."""
    model, params, flat, batch = ranks["sp"]
    jax_ref = jax_one_device_step(model, params, batch)
    port_ref = job_train_step(SP_CFG, flat, batch, {"one": {"data": 1}})["one"]
    assert_step_matches(ranks["ranks"][0]["step"]["seq4fsdp2"], jax_ref, port_ref)


class TestExpertParallel:
    def test_expert_sharding_rule(self, ranks):
        """The experts' stacks shard their expert axis; the model places."""
        moe = ranks["ranks"][0]["moe"]
        assert spec_for("backbone.blocks.mlp.experts.fc_1.weight", (2, 4, 48, 32),
                        {"expert": 4, "fsdp": 2})[1] == "expert"
        assert moe["spec"][0] == "expert"
        kind, placements, local_shape = moe["fc_1"]
        assert kind == "DTensor" and local_shape[0] == 1  # 4 experts over 4 ranks

    def test_moe_forward_invariant_to_expert_mesh(self, ranks):
        model, params, seq = ranks["moe"]
        audio_ref, text_ref = jax.jit(model)(params, jnp.asarray(seq))
        for r in ranks["ranks"]:
            np.testing.assert_allclose(r["moe"]["text"], np.asarray(text_ref), atol=2e-4)
            np.testing.assert_allclose(r["moe"]["audio"], np.asarray(audio_ref), atol=2e-4)
