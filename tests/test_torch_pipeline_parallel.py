"""The port's pipeline parallelism (``parallel/pipeline.py``, the ``pipe``
axis) against the JAX package: the GPipe schedule must reproduce the plain
loop over the layers: forward, gradients and a whole train step.

The port's meshes run as 8 gloo ranks on the CPU, one torch thread each,
all in one start of the ranks (``tests/torch_parallel_ranks.py``). The toy
body and sizes are the JAX test's; tolerances too: forward 1e-6, gradients
1e-5, the train step's loss 1e-3 and parameters 5e-3 (of both the JAX
one-device step and the port's one-process step).
"""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rstnet_tpu_torch.parallel.pipeline import pipe_axis_size
from rstnet_tpu_torch.parallel.sharding import infer_param_placements
from tests.test_pipeline_parallel import PP_CFG, _toy
from tests.test_torch_parallel import assert_step_matches, jax_one_device_step, lm_setup
from tests.torch_parallel_ranks import _lm, job_train_step, run_ranks

CASES = [{"pipe": 4, "n_micro": 4}, {"pipe": 2, "n_micro": 8}]
PP_MESH = {"pipe": 2, "data": 2, "fsdp": 2}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    body, x, (ws, bs) = _toy()
    x, ws, bs = (np.asarray(a) for a in (x, ws, bs))
    model, params, flat, batch = lm_setup(PP_CFG, 8, 12)
    out = run_ranks(tmp_path_factory.mktemp("ranks"), 8, "suite", parts={
        "toy": ("pipeline", dict(ws=ws, bs=bs, x=x, cases=CASES)),
        "step": ("train_step", dict(cfg=PP_CFG, flat=flat, batch=batch, meshes={"pp": PP_MESH})),
    })
    return {"ranks": out, "toy": (body, x, ws, bs), "pp": (model, params, flat, batch)}


def _scan(body, x, ws, bs):
    return jax.lax.scan(body, jnp.asarray(x), (jnp.asarray(ws), jnp.asarray(bs)))[0]


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=["four_stages_four_micro", "more_microbatches_than_stages"])
def test_forward_matches_scan(ranks, index):
    body, x, ws, bs = ranks["toy"]
    want = np.asarray(_scan(body, x, ws, bs))
    for r in ranks["ranks"]:  # every stage returns the whole output
        np.testing.assert_allclose(r["toy"][index]["out"], want, atol=1e-6)


@pytest.mark.parametrize("index", range(len(CASES)),
                         ids=["four_stages_four_micro", "more_microbatches_than_stages"])
def test_grad_matches_scan(ranks, index):
    body, x, ws, bs = ranks["toy"]
    gx, (gw, gb) = jax.grad(lambda x, xs: jnp.sum(jax.lax.scan(body, x, xs)[0] ** 2),
                            argnums=(0, 1))(jnp.asarray(x), (jnp.asarray(ws), jnp.asarray(bs)))
    P = CASES[index]["pipe"]
    per = ws.shape[0] // P
    for r in ranks["ranks"]:
        got = r["toy"][index]
        s = got["stage"]
        np.testing.assert_allclose(got["dx"], np.asarray(gx), atol=1e-5)
        np.testing.assert_allclose(got["dw"], np.asarray(gw)[s * per:(s + 1) * per], atol=1e-5)
        np.testing.assert_allclose(got["db"], np.asarray(gb)[s * per:(s + 1) * per], atol=1e-5)


def test_pipe_axis_size_no_mesh():
    assert pipe_axis_size() == 1


def test_train_step_invariant_to_pipe_mesh(ranks):
    """The pipelined train step equals the one-device step; the blocks'
    layer axis is placed on ``pipe``."""
    model, params, flat, batch = ranks["pp"]
    placements = infer_param_placements(PP_MESH, _lm(PP_CFG, flat))
    assert placements["backbone.blocks.0.attn.weight"].stage == 0
    assert placements["backbone.blocks.1.attn.weight"].stage == 1
    jax_ref = jax_one_device_step(model, params, batch)
    port_ref = job_train_step(PP_CFG, flat, batch, {"one": {"data": 1}})["one"]
    assert_step_matches(ranks["ranks"][0]["step"]["pp"], jax_ref, port_ref)
