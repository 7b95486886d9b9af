"""The port's trainer CLI and its data pipeline on the CPU
(``python -m rstnet_tpu_torch.training.trainer --device cpu``), with the
tiny synthetic set and arguments of ``tests/test_trainer.py``.

The data modules are copies, so their batches must equal the JAX package's
exactly; the config reader must give the JAX ``Config`` of every YAML file
in ``configs/``."""

import tests.test_torch_threads  # noqa: F401 - first: one torch CPU thread a process

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.test_trainer import _trainer_args, _write_synthetic

ROOT = Path(__file__).resolve().parent.parent


def _cpu_args(tmp_path, exp, extra=()):
    return _trainer_args(tmp_path, exp, extra=("--device", "cpu", *extra))


def test_trainer_two_epochs_with_resume(tmp_path):
    from rstnet_tpu_torch.training import trainer
    from rstnet_tpu_torch.training.checkpoint import latest_checkpoint

    _write_synthetic(tmp_path)
    exp = tmp_path / "exp"
    first = trainer.main(_cpu_args(tmp_path, exp, ("--n_epoch", "1")))
    assert (exp / "ep1.checkpoint" / "state.pt").is_file()
    assert [s["epoch"] for s in first["steps"]] == [1] * len(first["steps"]) and first["steps"]
    second = trainer.main(_cpu_args(tmp_path, exp, ("--n_epoch", "2")))  # resumes at epoch 2
    assert [s["epoch"] for s in second["steps"]] == [2] * len(second["steps"])
    assert latest_checkpoint(exp).name == "ep2.checkpoint"
    saved = torch.load(exp / "ep2.checkpoint" / "state.pt", weights_only=True)
    assert saved["step"] == saved["opt_state"]["count"] == len(first["steps"]) + len(
        second["steps"])
    for s in first["steps"] + second["steps"]:
        assert np.isfinite(s["loss"]) and s["seq_len"] % 32 == 0 and s["lr"] > 0
    assert sorted(os.listdir(exp)) == ["config.yaml", "ep1.checkpoint", "ep2.checkpoint", "logs",
                                       "train_args.yaml"]


def test_trainer_grad_accum_and_validation(tmp_path):
    """``--grad_accum 2``: the epoch's two batches make one optimizer step;
    validation runs."""
    from rstnet_tpu_torch.training import trainer

    _write_synthetic(tmp_path)
    out = trainer.main(_cpu_args(tmp_path, tmp_path / "exp",
                                 ("--n_epoch", "1", "--grad_accum", "2", "--grad_clip", "1.0")))
    saved = torch.load(tmp_path / "exp" / "ep1.checkpoint" / "state.pt", weights_only=True)
    assert len(out["steps"]) == 2 and saved["step"] == saved["opt_state"]["count"] == 1


def test_data_batches_equal_jax(tmp_path):
    from rstnet_tpu.data.dataloader import build_data_iterator as jax_iterator
    from rstnet_tpu.data.task_definition import load_data_for_all_tasks as jax_load
    from rstnet_tpu_torch.data.dataloader import build_data_iterator, find_data_jsons
    from rstnet_tpu_torch.data.task_definition import load_data_for_all_tasks
    from rstnet_tpu_torch.training.trainer import StoredTokens

    _write_synthetic(tmp_path)
    files = find_data_jsons(str(tmp_path / "*.json"))
    tok = {"audio": StoredTokens(), "text": StoredTokens()}
    kw = dict(batch_scale=80, max_length=64, seed=7, is_train=True)
    mine = build_data_iterator(*load_data_for_all_tasks(files), tok, **kw)
    theirs = jax_iterator(*jax_load(files), tok, **kw)
    for epoch in range(2):
        a, b = list(mine), list(theirs)
        assert len(a) == len(b) > 1
        for x, y in zip(a, b):
            assert x["example_ids"] == y["example_ids"]
            np.testing.assert_array_equal(x["tokens"], y["tokens"])
            np.testing.assert_array_equal(x["masks"], y["masks"])
        mine.sampler.refresh()
        theirs.sampler.refresh()


@pytest.mark.parametrize("flags", [
    ("--base_int8", "true", "--lora_r", "2", "--grad_accum", "2"), ("--base_int8", "true"),
    ("--base_int8", "true", "--lora_r", "2", "--model_family", "moshi"), ("--fsdp", "2"),
    ("--seq", "2"), ("--dp", "2")])
def test_trainer_refuses_what_is_not_ported(tmp_path, flags):
    """The JAX trainer's refusals (``--base_int8`` without LoRA, with the
    Moshi family or with ``--grad_accum > 1``), and a mesh larger than the
    ranks running: one process here, so ``--fsdp 2``, ``--seq 2`` and
    ``--dp 2`` raise JAX's ``make_mesh`` error (the mesh covers 2 devices,
    1 is visible)."""
    from rstnet_tpu_torch.training import trainer

    if flags[0] in ("--fsdp", "--seq", "--dp"):
        with pytest.raises(ValueError, match="covers 2 devices but 1 are visible"):
            trainer.main(_cpu_args(tmp_path, tmp_path / "exp", flags))
        return
    with pytest.raises(SystemExit):
        trainer.main(_cpu_args(tmp_path, tmp_path / "exp", flags))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trainer_loads_a_litgpt_checkpoint(tmp_path, dtype):
    """``--checkpoint_path`` loads a litgpt ``lit_model.pth`` into the
    backbone, cast to the run's dtype: with a zero learning rate the saved
    backbone equals the JAX ``convert_backbone`` of the file, cast the same
    way, bit for bit."""
    import ml_dtypes

    from rstnet_tpu.core import flatten_dict
    from rstnet_tpu.models import convert as jc
    from rstnet_tpu.models.config import Config as JaxConfig
    from rstnet_tpu_torch.core import stack_layers, tensor_to_numpy
    from rstnet_tpu_torch.models.backbone import Backbone
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.tools.upstream_layout import upstream_backbone, write_upstream
    from rstnet_tpu_torch.training import trainer

    _write_synthetic(tmp_path)
    cfg_path = str(tmp_path / "model.yaml")
    src = Backbone(Config.from_file(cfg_path), generator=torch.Generator().manual_seed(11))
    ckpt = write_upstream(tmp_path / "lit_model.pth", upstream_backbone(src))
    exp = tmp_path / "exp"
    trainer.main(_cpu_args(tmp_path, exp, ("--checkpoint_path", str(ckpt), "--n_epoch", "1",
                                           "--global_learning_rate", "0", "--dtype", dtype)))
    saved = torch.load(exp / "ep1.checkpoint" / "state.pt", weights_only=True)["params"]
    got = stack_layers({k[len("backbone."):]: tensor_to_numpy(v) for k, v in saved.items()
                        if k.startswith("backbone.")}, ("blocks",))
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    tree = jc.convert_backbone(jc.load_torch_state_dict(str(ckpt)), JaxConfig.from_file(cfg_path))
    want = {k: np.asarray(v).astype(np_dtype) for k, v in flatten_dict(tree)}
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].tobytes() == v.tobytes(), k
    assert saved["backbone.wte"].dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)


def test_trainer_needs_a_card_unless_told_cpu(tmp_path):
    from rstnet_tpu_torch.training import trainer

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _write_synthetic(tmp_path)
    with pytest.raises(SystemExit, match="--device cpu"):
        trainer.main(_trainer_args(tmp_path, tmp_path / "exp"))  # the default --device cuda


@pytest.mark.parametrize("device,enabled", [("cpu", False), ("cuda", True)])
def test_flash_routing_follows_the_device(device, enabled):
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.utils.arguments import get_args

    args = get_args(["--model_config", str(ROOT / "configs/llama_1b_speech.yaml")])
    assert args.flash_attention and args.remat and args.max_length == 1000
    cfg = Config.from_file(args.model_config, use_flash_attention=args.flash_attention
                           and torch.device(device).type == "cuda")
    assert cfg.use_flash_attention == enabled


@pytest.mark.parametrize("name", ["llama_1b_speech.yaml", "qwen_7b_speech.yaml"])
def test_config_files_read_as_jax_reads_them(name, tmp_path):
    from rstnet_tpu.models.config import Config as JaxConfig
    from rstnet_tpu_torch.models.config import Config, read_flat_yaml, write_flat_yaml

    mine, theirs = Config.from_file(ROOT / "configs" / name), JaxConfig.from_file(
        ROOT / "configs" / name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    write_flat_yaml(tmp_path / "c.yaml", dataclasses.asdict(mine))
    assert Config.from_file(tmp_path / "c.yaml") == mine
    adj = read_flat_yaml(tmp_path / "c.yaml")["rope_adjustments"]
    assert adj == (list(mine.rope_adjustments) if mine.rope_adjustments else None)


def test_llama_1b_speech_parameter_count():
    """The full config's parameter tree, built on the meta device (no
    memory): 2.01 B parameters, 1.50 B of them in the backbone."""
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.models.lm import SpeechTextLM

    cfg = Config.from_file(ROOT / "configs/llama_1b_speech.yaml")
    model = SpeechTextLM(cfg, device="meta", generator=torch.Generator())
    total = sum(p.numel() for p in model.parameters())
    backbone = sum(p.numel() for p in model.backbone.parameters())
    codecformer = sum(p.numel() for p in model.codecformer.parameters())
    assert round(total / 1e9, 2) == 2.01 and round(backbone / 1e9, 2) == 1.50
    assert round(codecformer / 1e9, 2) == 0.30


def test_checkpoint_roundtrip_and_rotation(tmp_path):
    from rstnet_tpu_torch.training.checkpoint import (
        latest_checkpoint,
        restore_checkpoint,
        rotate_checkpoints,
        save_checkpoint,
    )

    model = torch.nn.Linear(3, 2)
    state = {"model": model, "opt_state": {"count": 4, "mu": {"w": torch.arange(6.0)}}, "step": 7}
    for ep in (1, 2, 3):
        save_checkpoint(tmp_path / f"ep{ep}.checkpoint", state, {"reporter": {"epoch": ep}})
    assert latest_checkpoint(tmp_path).name == "ep3.checkpoint"
    target = {"model": torch.nn.Linear(3, 2),
              "opt_state": {"count": 0, "mu": {"w": torch.zeros(6)}}, "step": 0}
    restored, extras = restore_checkpoint(tmp_path / "ep3.checkpoint", target)
    assert restored["step"] == 7 and restored["opt_state"]["count"] == 4
    torch.testing.assert_close(restored["opt_state"]["mu"]["w"], torch.arange(6.0))
    torch.testing.assert_close(restored["model"].weight, model.weight)
    assert extras["reporter"]["epoch"] == 3
    rotate_checkpoints(tmp_path, keep_last=1)
    assert [p.name for p in tmp_path.glob("*.checkpoint")] == ["ep3.checkpoint"]


def test_profile_train_step_runs_on_the_cpu(tmp_path):
    """The training-step profiler with a tiny model on the CPU, at its B=4 x
    T=1024 batch (it skips the device profiler there): the JSON it writes
    and no K6 launch."""
    import json

    from rstnet_tpu_torch.tools import profile_train_step

    _write_synthetic(tmp_path)
    model = tmp_path / "model.yaml"
    model.write_text(model.read_text().replace("block_size: 256", "block_size: 1024"))
    out = tmp_path / "p.json"
    profile_train_step.main([
        "--model_config", str(model), "--device", "cpu", "--dtype", "float32",
        "--out", str(out), "--audio_card", "64", "--codecformer_dim", "16",
        "--codecformer_heads", "2", "--codecformer_layers", "1",
        "--codecformer_dim_feedforward", "32"])
    result = json.loads(out.read_text())
    assert result["card"] == "cpu" and result["peak_memory_gib"] is None
    assert (result["batch"], result["seq"], result["step_ms"]["n"]) == (4, 1024, 5)
    assert set(result["stage_ms"]) == {"forward", "backward", "optimizer", "step"}
    assert not any(result["k6_launches_per_step"].values())


# the first moments after the run's steps, float32 (up to 0.12 here): the
# same gradient sums taken in another order (over ranks and time slices),
# and later steps' gradients at parameters that differ by that rounding
# (2e-8 apart measured)
MU_ATOL = 1e-6


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    """8 gloo ranks (one torch thread each, one start for both tests): the
    elastic checkpoint reshard, and ``trainer.main`` on a data x fsdp x seq
    mesh beside the same run in this process."""
    from rstnet_tpu_torch.training import trainer
    from tests.test_torch_speech_lm import CFG, lm_pair
    from tests.torch_parallel_ranks import job_trainer, run_ranks

    tmp = tmp_path_factory.mktemp("mesh")
    _write_synthetic(tmp)
    _, params, _ = lm_pair()
    from rstnet_tpu.core import flatten_dict

    flat = {k: np.array(v) for k, v in flatten_dict(params)}
    mesh_flags = ("--dp", "-1", "--fsdp", "2", "--seq", "2")
    ranks = run_ranks(tmp, 8, "suite", parts={
        "reshard": ("reshard", dict(cfg=CFG, flat=flat, path=str(tmp / "ep1.checkpoint"),
                                    mesh_a={"data": 2, "fsdp": 2, "tensor": 2},
                                    mesh_b={"fsdp": 4, "tensor": 2})),
        "trainer": ("trainer", dict(argv=_cpu_args(tmp, tmp / "exp_mesh", mesh_flags))),
    }, timeout=240)
    one = job_trainer(_cpu_args(tmp, tmp / "exp_one"))
    assert trainer  # imported for the rank side's module path
    return {"ranks": ranks, "flat": flat, "one": one}


def test_checkpoint_elastic_reshard(mesh_ranks):
    """A checkpoint saved under one mesh (data 2, fsdp 2, tensor 2) restores
    under another (fsdp 4, tensor 2) with identical values, each rank
    holding its new shards (JAX ``test_checkpoint_elastic_reshard``)."""
    got = mesh_ranks["ranks"][0]["reshard"]
    want = mesh_ranks["flat"]  # the JAX tree, blocks stacked
    assert set(got["params"]) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got["params"][k], v)
    # wte [V, C] is split on tensor (rows) and fsdp (columns) on both meshes
    (va, ca), (vb, cb) = got["shapes"]["a"], got["shapes"]["b"]
    assert va == vb and ca == 2 * cb


def test_trainer_on_a_mesh_matches_one_process(mesh_ranks):
    """``trainer.main`` with ``--dp -1 --fsdp 2 --seq 2`` on 8 ranks (dp
    absorbs 2) trains as the one-process run: every step's loss within
    1e-3 and the last checkpoint's parameters within 5e-3 (JAX's mesh
    tolerances), the same on every rank. Those cannot see a wrong gradient
    (an Adam step moves an element by about lr whatever its gradient), so
    the checkpoint's first moments, a decayed sum of the steps' reduced
    gradients, are held to the one-process run's within ``MU_ATOL``."""
    one = mesh_ranks["one"]
    for r in mesh_ranks["ranks"]:
        got = r["trainer"]
        assert len(got["steps"]) == len(one["steps"]) > 0
        for a, b in zip(got["steps"], one["steps"]):
            assert (a["batch_size"], a["seq_len"]) == (b["batch_size"], b["seq_len"])
            assert abs(a["loss"] - b["loss"]) < 1e-3, (a["loss"], b["loss"])
    params = mesh_ranks["ranks"][0]["trainer"]["params"]
    assert set(params) == set(one["params"])
    worst = max(float(np.max(np.abs(params[k] - one["params"][k]))) for k in params)
    assert worst < 5e-3, worst
    mu = mesh_ranks["ranks"][0]["trainer"]["mu"]
    assert set(mu) == set(one["mu"])
    worst = max(float(np.max(np.abs(mu[k] - one["mu"][k]))) for k in mu)
    assert worst < MU_ATOL, worst
