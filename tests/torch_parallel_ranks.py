"""Ranks for the port's parallel tests: gloo process groups on the CPU.

The tests run the port's parallel paths as real processes, one a rank, and
compare what rank 0 gathers with the JAX package in the test process. This
module imports torch and the port, never JAX or ``rstnet_tpu``: a rank
reads its weights and data from numpy files that the test wrote.

``run_ranks(tmp, world, job, **kw)`` starts ``world`` processes of
``python -m tests.torch_parallel_ranks``; each joins a gloo group through a
``file://`` store under ``tmp``, sets one torch thread, runs ``JOBS[job]``
and writes its result as a pickle. The test joins them with a time limit: a
rank that fails or hangs fails the test and every rank is killed.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def run_ranks(tmp, world: int, job: str, timeout: float = 150.0, **kw) -> list:
    """Run ``JOBS[job](**kw)`` on ``world`` gloo ranks; returns their results."""
    tmp = Path(tmp) / f"ranks_{job}_{time.monotonic_ns()}"
    tmp.mkdir(parents=True)
    (tmp / "job.pkl").write_bytes(pickle.dumps({"job": job, "kw": kw, "timeout": timeout}))
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=f"{REPO}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    procs = []
    for r in range(world):
        log = open(tmp / f"rank{r}.log", "wb")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "tests.torch_parallel_ranks", str(tmp), str(r), str(world)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), log))
    deadline = time.monotonic() + timeout
    try:
        for p, _ in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    bad = [(r, p.returncode) for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = "\n".join(f"--- rank {r} (exit {rc}):\n"
                          + (tmp / f"rank{r}.log").read_text(errors="replace")[-3000:]
                          for r, rc in bad)
        raise RuntimeError(f"ranks failed or hung ({timeout:.0f} s limit): {bad}\n{tails}")
    return [pickle.loads((tmp / f"out{r}.pkl").read_bytes()) for r in range(world)]


# -- jobs (run inside a rank) --------------------------------------------------


def _lm(cfg: dict, flat: dict, dtype="float32"):
    import torch

    from rstnet_tpu_torch.core import from_jax_params
    from rstnet_tpu_torch.models.config import Config
    from rstnet_tpu_torch.models.lm import SpeechTextLM

    tm = SpeechTextLM(Config(**cfg), dtype=getattr(torch, dtype))
    if cfg.get("lora_r", 0) > 0:  # the factors' structure; their values come from flat
        from rstnet_tpu_torch.models.lora import attach_lora, init_lora

        attach_lora(tm.backbone, init_lora(tm.config, torch.Generator().manual_seed(0),
                                           getattr(torch, dtype)))
    from_jax_params(flat, tm, stacked=tm.STACKED)
    return tm


def _full_params(state) -> dict:
    return _full_state(state)[0]


def _full_state(state) -> tuple[dict, dict]:
    """(whole parameters, whole first moments), numpy, blocks stacked."""
    from rstnet_tpu_torch.core import stack_layers, tensor_to_numpy
    from rstnet_tpu_torch.training.checkpoint import gathered_state

    params, opt = gathered_state(state)
    return tuple(stack_layers({k: tensor_to_numpy(v) for k, v in d.items()},
                              state["model"].STACKED) for d in (params, opt["mu"]))


def job_train_step(cfg: dict, flat: dict, batch: dict, meshes: dict, ignore=(33, 127),
                   lr=1e-3, warmup=10, opt: dict | None = None,
                   dropout_seed: int | None = None) -> dict:
    """One train step of the LM on each mesh (``opt``: more
    ``make_optimizer`` arguments; ``dropout_seed``: LoRA-branch dropout);
    rank 0 returns {name: (loss, whole params, whole gradients)}. The
    gradients are the ones the optimizer took, reduced and clipped: after
    one step AdamW's first moment is ``(1 - b1) g``."""
    import numpy as np
    import torch

    from rstnet_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from rstnet_tpu_torch.parallel.sharding import batch_slice, shard_params
    from rstnet_tpu_torch.training.schedulers import warmup_lr
    from rstnet_tpu_torch.training.train_step import (
        init_train_state,
        make_loss_fn,
        make_optimizer,
        make_train_step,
    )

    out = {}
    for name, shape in meshes.items():
        mesh = make_mesh(shape)
        model = shard_params(mesh, _lm(cfg, flat))
        tx = make_optimizer(warmup_lr(lr, warmup), **(opt or {}))
        loss_fn = make_loss_fn(model, audio_ignore_id=ignore[0], text_ignore_id=ignore[1])
        with set_mesh(mesh):
            state = init_train_state(model, tx)
            mine = {k: torch.tensor(v) for k, v in batch_slice(mesh, batch).items()}
            state, metrics = make_train_step(loss_fn, tx, dropout_seed=dropout_seed)(state, mine)
            params, mu = _full_state(state)
        out[name] = (float(metrics["loss"]), params,
                     {k: v / np.float32(1 - tx.b1) for k, v in mu.items()})
    return out


def job_codec_train(argv: list) -> dict:
    """``codec_trainer.main(argv)`` on every rank; each returns its G
    parameters, EMA buffers and D parameters, the G and D optimizers' first
    moments (numpy) and the steps' losses."""
    from rstnet_tpu_torch.core import tensor_to_numpy, to_numpy
    from rstnet_tpu_torch.training import codec_trainer

    out = codec_trainer.main(argv)
    gan, opt = out["state"]["model"], out["state"]["opt_state"]
    return {"g_params": to_numpy(gan["g"], part="params"),
            "g_buffers": to_numpy(gan["g"], part="buffers"),
            "d_params": to_numpy(gan["d"], part="params"),
            **{f"{w}_mu": {k: tensor_to_numpy(v) for k, v in opt[w]["mu"].items()}
               for w in ("g", "d")},
            "losses": [(s["g_loss"], s["d_loss"]) for s in out["steps"]]}


def job_mesh_shapes(shapes: list) -> list:
    """The sizes ``make_mesh`` gives each shape on this world."""
    from rstnet_tpu_torch.parallel.mesh import make_mesh

    return [make_mesh(shape).shape for shape in shapes]


def job_context_parallel(q, k, v, cases: list, grad_case: dict) -> dict:
    """Context-parallel attention over each ``{"context", "n_seq",
    "window", "softcap"}`` case (a ``{"seq": n, "fsdp": 8 // n}`` mesh), and
    the gradients of ``sum(out ** 2)`` for ``grad_case``: each rank returns
    its time chunk and its seq coordinate."""
    import math

    import torch

    from rstnet_tpu_torch.ops.context_parallel import context_parallel_attention
    from rstnet_tpu_torch.parallel.mesh import make_mesh

    def run(case, grad=False):
        n = case["n_seq"]
        mesh = make_mesh({"seq": n, "fsdp": 8 // n})
        i, T = mesh.coord("seq"), q.shape[2]
        part = [torch.from_numpy(a[:, :, i * T // n:(i + 1) * T // n]).requires_grad_(grad)
                for a in (q, k, v)]
        out = context_parallel_attention(
            *part, context=case["context"], scale=1.0 / math.sqrt(q.shape[-1]),
            softcap=case.get("softcap"), window=case.get("window", 0), group=mesh.group("seq"))
        if not grad:
            return i, out.detach().numpy()
        (out ** 2).sum().backward()
        return i, [t.grad.numpy() for t in part]

    return {"outs": [run(c) for c in cases], "grads": run(grad_case, grad=True)}


def job_moe_forward(cfg: dict, flat: dict, seq, shape: dict) -> dict:
    """The LM forward on an ``expert`` mesh: (audio, text) logits and the
    experts' placements."""
    import torch

    from rstnet_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from rstnet_tpu_torch.parallel.sharding import shard_params

    mesh = make_mesh(shape)
    model = shard_params(mesh, _lm(cfg, flat))
    w = model.backbone.blocks[0].mlp.experts.fc_1.weight
    with set_mesh(mesh), torch.no_grad():
        audio, text = model(torch.from_numpy(seq))
    return {"audio": audio.numpy(), "text": text.numpy(),
            "fc_1": (type(w).__name__, [str(p) for p in w.placements],
                     tuple(w.to_local().shape)),
            "spec": model._shard_layout.placements["backbone.blocks.0.mlp.experts.fc_1.weight"]
            .spec}


def job_pipeline(ws, bs, x, cases: list) -> list:
    """``spmd_pipeline`` over the toy body ``tanh(h * w + b)`` for each
    ``{"pipe", "n_micro"}`` case (a ``{"pipe": P, "data": 8 // P}`` mesh),
    with the gradients of ``sum(out ** 2)``: each rank returns its stage, the
    output and the gradients of x and of its layers."""
    import torch

    from rstnet_tpu_torch.parallel.mesh import make_mesh
    from rstnet_tpu_torch.parallel.pipeline import spmd_pipeline

    def body(h, layer):
        w, b = layer
        return torch.tanh(h * w + b)

    out = []
    for case in cases:
        P = case["pipe"]
        mesh = make_mesh({"pipe": P, "data": 8 // P})
        s, per = mesh.coord("pipe"), ws.shape[0] // P
        w = torch.from_numpy(ws[s * per:(s + 1) * per]).requires_grad_(True)
        b = torch.from_numpy(bs[s * per:(s + 1) * per]).requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        y = spmd_pipeline(body, xt, list(zip(w, b)), n_stages=P, n_micro=case["n_micro"],
                          group=mesh.group("pipe"))
        (y ** 2).sum().backward()
        out.append({"stage": s, "out": y.detach().numpy(), "dx": xt.grad.numpy(),
                    "dw": w.grad.numpy(), "db": b.grad.numpy()})
    return out


def job_reshard(cfg: dict, flat: dict, path: str, mesh_a: dict, mesh_b: dict) -> dict:
    """Save the LM's state under ``mesh_a`` and restore it into a zeroed
    state under ``mesh_b``: rank 0 returns the restored whole parameters
    and the shape of one local shard on each mesh."""
    import torch

    from rstnet_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from rstnet_tpu_torch.parallel.sharding import local, shard_params
    from rstnet_tpu_torch.training.checkpoint import restore_checkpoint, save_checkpoint
    from rstnet_tpu_torch.training.schedulers import warmup_lr
    from rstnet_tpu_torch.training.train_step import init_train_state, make_optimizer

    tx = make_optimizer(warmup_lr(1e-3, 10))
    shapes = {}
    for tag, shape, zero in (("a", mesh_a, False), ("b", mesh_b, True)):
        mesh = make_mesh(shape)
        model = _lm(cfg, flat)
        if zero:
            with torch.no_grad():
                for p in model.parameters():
                    p.zero_()
        shard_params(mesh, model)
        with set_mesh(mesh):
            state = init_train_state(model, tx)
            if tag == "a":
                save_checkpoint(path, state, {"epoch": 1})
            else:
                state, extras = restore_checkpoint(path, state)
                assert extras["epoch"] == 1
                params = _full_params(state)
        shapes[tag] = tuple(local(dict(model.named_parameters())["backbone.wte"]).shape)
    return {"params": params, "shapes": shapes}


def job_trainer(argv: list) -> dict:
    """``trainer.main(argv)`` on every rank: the steps' records and, from
    the last checkpoint, the whole parameters and first moments."""
    import torch

    from rstnet_tpu_torch.training import trainer

    out = trainer.main(argv)
    saved = torch.load(f"{out['checkpoints'][-1]['path']}/state.pt", weights_only=True)
    return {"steps": out["steps"],
            **{key: {k: v.float().numpy() for k, v in d.items()}
               for key, d in (("params", saved["params"]), ("mu", saved["opt_state"]["mu"]))}}


def job_ema(x, codes, embedding_sum) -> dict:
    """``EuclideanCodebook.ema_update`` over the data group, each rank given
    its rows."""
    import torch

    from rstnet_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from rstnet_tpu_torch.quantization.codebook import EuclideanCodebook

    mesh = make_mesh({"data": -1})
    n, r = mesh.size("data"), mesh.coord("data")
    cb = EuclideanCodebook(dim=x.shape[1], codebook_size=embedding_sum.shape[0])
    with torch.no_grad():
        cb.embedding_sum.copy_(torch.from_numpy(embedding_sum))
    rows = slice(r * len(x) // n, (r + 1) * len(x) // n)
    with set_mesh(mesh):
        cb.ema_update(torch.from_numpy(x[rows]), torch.from_numpy(codes[rows]), axis_name="data")
    return {"cluster_usage": cb.cluster_usage.detach().numpy(),
            "embedding_sum": cb.embedding_sum.detach().numpy()}


def job_flagship_mesh(cfg_overrides: dict, seed: int, shape: dict) -> dict:
    """``build_peft_8b(..., mesh=)`` at a small config: the whole leaves
    gathered (numpy) and the bytes this rank holds."""
    import torch

    from rstnet_tpu_torch.core import tensor_to_numpy
    from rstnet_tpu_torch.parallel.mesh import make_mesh
    from rstnet_tpu_torch.parallel.sharding import local
    from rstnet_tpu_torch.training.checkpoint import gathered_state
    from rstnet_tpu_torch.training.flagship8b import build_peft_8b, flagship_8b_config

    cfg = flagship_8b_config(device="cpu", **cfg_overrides)
    mesh = make_mesh(shape)
    model, trainable, frozen, _ = build_peft_8b(torch.Generator().manual_seed(seed), cfg,
                                                device="cpu", mesh=mesh)
    held = sum(local(p).numel() * local(p).element_size() for p in model.parameters())
    params, _ = gathered_state({"model": model, "opt_state": {"mu": {}, "nu": {}}, "step": 0})
    return {"params": {k: tensor_to_numpy(v) for k, v in params.items()}, "held": held,
            "trainable": sorted(trainable), "frozen": sorted(frozen)}


def job_tp_serving(cases: dict, batches=(2, 1), n_frames: int = 5) -> dict:
    """Greedy ``LMGen`` frames of the LM placed on each case's mesh:
    ``cases`` maps a name to ``(cfg, flat, mesh shape)``. For each case and
    batch size: every frame's tokens, the backbone's hidden state and text
    logits, the collectives of each frame (op, bytes), ``step_scan``'s
    frames from a fresh state, the ring's shape, and what ``CapturedStep``
    says of the placed model."""
    import torch

    from rstnet_tpu_torch.inference.generate import LMGen
    from rstnet_tpu_torch.parallel.comm import CollectiveLog
    from rstnet_tpu_torch.parallel.mesh import make_mesh, set_mesh
    from rstnet_tpu_torch.parallel.sharding import shard_params
    from rstnet_tpu_torch.serving.graphs import CapturedStep

    out = {}
    for name, (cfg, flat, shape) in cases.items():
        mesh = make_mesh(shape)
        model = shard_params(mesh, _lm(cfg, flat))
        seen = []
        real = model.step_global

        def step_global(*a, _real=real, **k):
            hidden, logits, state = _real(*a, **k)
            seen.append((hidden.numpy().copy(), logits.numpy().copy()))
            return hidden, logits, state

        model.step_global = step_global
        delays = (0,) + (1,) * model.config.n_q
        gen = LMGen(model, delays=delays, use_sampling=False)
        try:
            CapturedStep(lambda st: (None, st), {}, modules=(model,))
            refusal = None
        except ValueError as e:
            refusal = str(e)
        with torch.no_grad(), set_mesh(mesh):
            for B in batches:
                seen.clear()
                state = gen.init_state(B, torch.float32)
                ring = tuple(state["lm"]["kv"]["k"].shape)
                frames, collectives = [], []
                for _ in range(n_frames):
                    with CollectiveLog() as log:
                        tokens, _, state = gen.step(state, None)
                    frames.append(tokens.numpy().copy())
                    collectives.append(log.calls)
                hidden = [h for h, _ in seen]
                logits = [lg for _, lg in seen]
                scan, _, _ = gen.step_scan(gen.init_state(B, torch.float32), None,
                                           n_frames=n_frames)
                out[f"{name}-B{B}"] = {
                    "frames": frames, "hidden": hidden, "logits": logits,
                    "collectives": collectives, "scan": scan.numpy().copy(), "ring": ring,
                    "refusal": refusal}
    return out


def job_codec_suite(argv: list, ema: dict) -> dict:
    return {"codec": job_codec_train(argv), "ema": job_ema(**ema)}


JOBS = {"train_step": job_train_step, "codec_train": job_codec_train,
        "mesh_shapes": job_mesh_shapes, "context_parallel": job_context_parallel,
        "moe_forward": job_moe_forward, "pipeline": job_pipeline, "reshard": job_reshard,
        "trainer": job_trainer, "codec_suite": job_codec_suite,
        "flagship_mesh": job_flagship_mesh, "tp_serving": job_tp_serving}


def job_suite(parts: dict) -> dict:
    """Several jobs in one start of the ranks: ``{name: (job, kwargs)}``."""
    return {name: JOBS[job](**kw) for name, (job, kw) in parts.items()}


JOBS["suite"] = job_suite


def main(tmp: str, rank: int, world: int) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist

    from rstnet_tpu_torch.parallel.mesh import initialize_distributed

    torch.set_num_threads(1)
    spec = pickle.loads((Path(tmp) / "job.pkl").read_bytes())
    # a rank still running just before the limit prints where it waits
    faulthandler.dump_traceback_later(max(1.0, spec["timeout"] - 10.0), exit=False)
    initialize_distributed(f"file://{tmp}/store", rank=rank, world_size=world,
                           device_type="cpu", timeout_s=120)
    assert dist.get_backend() == "gloo"
    try:
        result = JOBS[spec["job"]](**spec["kw"])
        (Path(tmp) / f"out{rank}.pkl").write_bytes(pickle.dumps(result))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
