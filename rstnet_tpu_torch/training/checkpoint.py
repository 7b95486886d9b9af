"""Checkpoint save and resume (counterpart of
``rstnet_tpu/training/checkpoint.py``, with torch files instead of orbax).

A checkpoint is a directory ``<exp_dir>/ep{E}[-iter{I}].checkpoint`` holding
``state.pt`` (the model's ``state_dict``, the optimizer state and the step)
and ``extras.json`` (the reporter). A state with ``"trainable_only"`` (the
PEFT run over a frozen base) saves and restores only its trainable
parameters, as the JAX trainer's partitioned state holds only the trainable
tree: the frozen base comes from the run's own construction (seed or
``--checkpoint_path``). Resume finds the newest one, and old ones are
rotated away, as in JAX. ``restore_checkpoint(..., partial=True)`` is
the inference CLIs' params-only load: it maps the file (``mmap``) and reads
only the params, so the optimizer moments of a large checkpoint are never
read. ``save_model`` is the weights-only export (a directory with
``state.pt`` holding ``{"params": ...}`` only), which the same partial
restore loads; ``export_numpy`` writes the JAX package's flat ``.npz``.

Under a mesh (a model placed by ``parallel/sharding.py::shard_params``, or
replicated over an ambient mesh) every rank calls save and restore: the
save gathers each parameter and optimizer moment whole (its shards over
``fsdp``, ``tensor`` and ``expert``, and a block from the stage that holds
it) and rank 0 writes the same ``state.pt`` as one process does, so a
checkpoint loads on any mesh; the restore gives each rank its shards of the
whole tensors: whatever mesh the target state is placed on (an elastic
resume).
"""

from __future__ import annotations

import json
import logging
import re
import shutil
from pathlib import Path
from typing import Any, Optional

import torch
import torch.distributed as dist

from rstnet_tpu_torch.parallel.sharding import is_dtensor, local, local_shard, reshard


def _ckpt_dir(path: str | Path) -> Path:
    return Path(path).absolute()


def state_params(state: dict, keep_vars: bool = False) -> dict[str, torch.Tensor]:
    """The parameters a checkpoint of ``state`` holds: the model's
    ``state_dict``, or its trainable parameters alone under
    ``"trainable_only"``."""
    model = state["model"]
    if state.get("trainable_only"):
        return {n: p if keep_vars else p.detach() for n, p in model.named_parameters()
                if p.requires_grad}
    return model.state_dict(keep_vars=keep_vars)


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _layout(state: dict):
    layout = getattr(state["model"], "_shard_layout", None)
    return layout if layout is not None and layout.mesh.world > 1 else None


def _whole(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A local shard laid out as parameter ``like`` (a ``DTensor`` or not),
    gathered whole."""
    if not is_dtensor(like):
        return t.detach()
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(t.detach(), like.device_mesh, like.placements,
                              run_check=False).full_tensor()


def gathered_state(state: dict) -> tuple[dict, dict]:
    """(params, opt_state) of a train state, whole, on rank 0 (on the CPU
    for a placed state; the other ranks get empty dicts). Every rank must
    call it."""
    model, layout = state["model"], _layout(state)
    if layout is None:
        return state_params(state), state["opt_state"]
    mesh = layout.mesh
    reshard(model)
    own = dict(model.named_parameters())
    opt = state["opt_state"]
    trained = set(opt["mu"])
    if mesh.size("pipe") > 1:  # a stage knows its own blocks' moments only
        parts = [None] * mesh.world
        dist.all_gather_object(parts, sorted(trained))
        trained = set().union(*parts)
    names = [n for n in layout.shapes if not state.get("trainable_only") or n in trained]
    keep = _rank() == 0
    params, mu, nu = {}, {}, {}
    for name in names:
        pl, p = layout.placements[name], own.get(name)
        kinds = [(params, p)]
        if name in trained:
            kinds += [(mu, opt["mu"].get(name)), (nu, opt["nu"].get(name))]
        for out, t in kinds:
            whole = None if p is None else _whole(local(t), p)
            if pl.stage is not None and mesh.size("pipe") > 1:
                if whole is None:
                    whole = torch.empty(layout.shapes[name], dtype=layout.dtypes[name],
                                        device=_device(model))
                dist.broadcast(whole, mesh.peer("pipe", pl.stage), group=mesh.group("pipe"))
            if keep:
                out[name] = whole.to("cpu", copy=True)
    # on every rank: FSDP2's state_dict hook reshards the parameters, and
    # the ranks of an fsdp group must all reshard or none
    buffers = {k: v for k, v in model.state_dict().items() if k not in own and not is_dtensor(v)}
    if keep:
        params.update({k: v.detach().to("cpu", copy=True) for k, v in buffers.items()})
    return params, {**{k: v for k, v in opt.items() if k not in ("mu", "nu")},
                    "mu": mu, "nu": nu}


def _device(model) -> torch.device:
    return next(iter(model.parameters())).device


def save_checkpoint(path: str | Path, state: dict, extras: Optional[dict[str, Any]] = None,
                    keep_last: Optional[int] = None) -> None:
    """Save a train state ``{"model", "opt_state", "step"}`` and json extras.
    Under a mesh every rank calls it and rank 0 writes."""
    params, opt_state = gathered_state(state)
    if _rank() == 0:
        _write(path, params, opt_state, state["step"], extras, keep_last)
    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def _write(path, params, opt_state, step, extras, keep_last) -> None:
    path = _ckpt_dir(path)
    if path.exists():
        shutil.rmtree(path, ignore_errors=True)
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    # no transient accumulator (``micro``, the parameters' ``.grad``)
    torch.save({"params": params, "opt_state": opt_state, "step": step}, tmp / "state.pt")
    if extras:
        (tmp / "extras.json").write_text(json.dumps(extras))
    tmp.rename(path)  # a crash mid-save never leaves a checkpoint that resume would pick
    logging.info(f"saved checkpoint {path}")
    if keep_last is not None and keep_last > 0:
        rotate_checkpoints(path.parent, keep_last)


def _copy_into(target, saved, where: str):
    if isinstance(target, torch.Tensor):
        if tuple(saved.shape) != tuple(target.shape) or saved.dtype != target.dtype:
            raise ValueError(f"{where}: checkpoint holds {saved.dtype}{tuple(saved.shape)}, "
                             f"the state {target.dtype}{tuple(target.shape)}")
        with torch.no_grad():
            target.copy_(saved)
        return target
    if isinstance(target, dict):
        if set(target) != set(saved):
            raise KeyError(f"{where}: keys differ: {sorted(set(target) ^ set(saved))}")
        for k in target:
            target[k] = _copy_into(target[k], saved[k], f"{where}.{k}")
        return target
    return saved


def restore_checkpoint(path: str | Path, target_state: dict, partial: bool = False
                       ) -> tuple[dict, dict]:
    """Load a checkpoint into ``target_state`` in place (same structure,
    shapes and dtypes); returns (state, extras). ``partial=True`` is the
    params-only load (``target_state`` is ``{"model": m}``): the file is
    mapped, only the params are read, and they keep their saved dtype, as
    the JAX restore returns the stored arrays."""
    path = _ckpt_dir(path)
    saved = torch.load(path / "state.pt", map_location="cpu", weights_only=True, mmap=partial)
    if partial:
        model = target_state["model"]
        own = model.state_dict(keep_vars=True)
        model.load_state_dict({k: v.to(own[k].device) for k, v in saved["params"].items()},
                              assign=True)
    elif _layout(target_state) is not None:
        _reshard_into(target_state, saved)
    else:
        _copy_into(state_params(target_state, keep_vars=True), saved["params"], "params")
        _copy_into(target_state["opt_state"], saved["opt_state"], "opt_state")
        target_state["step"] = saved["step"]
    extras = {}
    if (path / "extras.json").is_file():
        extras = json.loads((path / "extras.json").read_text())
    logging.info(f"restored checkpoint {path}")
    return target_state, extras


@torch.no_grad()
def _reshard_into(state: dict, saved: dict) -> None:
    """Copy this rank's shards of the saved whole tensors into a placed
    state (each parameter and its moments by the parameter's spec)."""
    model, layout = state["model"], _layout(state)
    reshard(model)
    own = dict(model.named_parameters())
    opt = state["opt_state"]
    names = [n for n in own if not state.get("trainable_only") or own[n].requires_grad]
    missing = [n for n in names if n not in saved["params"]]
    if missing:
        raise KeyError(f"params: the checkpoint lacks {missing}")
    for name in names:
        spec = layout.placements[name].spec
        pairs = [(local(own[name]), saved["params"][name], f"params.{name}")]
        if name in opt["mu"]:
            pairs += [(opt["mu"][name], saved["opt_state"]["mu"][name], f"opt_state.mu.{name}"),
                      (opt["nu"][name], saved["opt_state"]["nu"][name], f"opt_state.nu.{name}")]
        for target, whole, where in pairs:
            _copy_into(target, local_shard(whole, spec, layout.mesh), where)
    for name, buf in model.state_dict().items():
        if name not in own and not is_dtensor(buf) and name in saved["params"]:
            _copy_into(buf, saved["params"][name], f"params.{name}")
    for k, v in saved["opt_state"].items():
        if k not in ("mu", "nu"):
            opt[k] = v
    state["step"] = saved["step"]


def save_model(path: str | Path, params: dict) -> None:
    """Weights-only export: ``{name: tensor}`` (a module's ``state_dict``
    names) to ``<path>/state.pt``, loadable with ``restore_checkpoint(path,
    {"model": module}, partial=True)``."""
    path = _ckpt_dir(path)
    if path.exists():
        shutil.rmtree(path)
    path.mkdir(parents=True)
    torch.save({"params": {k: v.detach().contiguous().cpu() for k, v in params.items()}},
               path / "state.pt")


def export_numpy(path: str | Path, params: dict) -> None:
    """Flat ``.npz`` of ``{dotted JAX path: tensor or array}`` (the JAX
    package's ``export_numpy``; bf16 as ``ml_dtypes.bfloat16``)."""
    import os

    import numpy as np

    from rstnet_tpu_torch.core import tensor_to_numpy

    flat = {k: tensor_to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in params.items()}
    os.makedirs(os.path.dirname(str(path)) or ".", exist_ok=True)
    np.savez(path, **flat)


_CKPT_RE = re.compile(r"ep(\d+)(?:-iter(\d+))?\.checkpoint$")


def scan_checkpoints(exp_dir: str | Path) -> list[Path]:
    """All checkpoints in an experiment dir, oldest first (by epoch/iter)."""
    found = []
    for p in _ckpt_dir(exp_dir).glob("*.checkpoint"):
        m = _CKPT_RE.search(p.name)
        if m:
            it = int(m.group(2)) if m.group(2) else 1 << 30
            found.append(((int(m.group(1)), it), p))
    return [p for _, p in sorted(found)]


def latest_checkpoint(exp_dir: str | Path) -> Optional[Path]:
    ckpts = scan_checkpoints(exp_dir)
    return ckpts[-1] if ckpts else None


def rotate_checkpoints(exp_dir: str | Path, keep_last: int) -> None:
    for p in scan_checkpoints(exp_dir)[:-keep_last]:
        logging.info(f"removing old checkpoint {p}")
        shutil.rmtree(p, ignore_errors=True)


def maybe_resume(exp_dir: str | Path, target_state: dict) -> tuple[dict, dict, Optional[Path]]:
    """Resume from the newest checkpoint in ``exp_dir``, if any."""
    ckpt = latest_checkpoint(exp_dir)
    if ckpt is None:
        return target_state, {}, None
    state, extras = restore_checkpoint(ckpt, target_state)
    return state, extras, ckpt
