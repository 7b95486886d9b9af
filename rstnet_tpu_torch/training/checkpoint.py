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
"""

from __future__ import annotations

import json
import logging
import re
import shutil
from pathlib import Path
from typing import Any, Optional

import torch


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


def save_checkpoint(path: str | Path, state: dict, extras: Optional[dict[str, Any]] = None,
                    keep_last: Optional[int] = None) -> None:
    """Save a train state ``{"model", "opt_state", "step"}`` and json extras."""
    path = _ckpt_dir(path)
    if path.exists():
        shutil.rmtree(path, ignore_errors=True)
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    # no transient accumulator (``micro``, the parameters' ``.grad``)
    torch.save({"params": state_params(state), "opt_state": state["opt_state"],
                "step": state["step"]}, tmp / "state.pt")
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
    else:
        _copy_into(state_params(target_state, keep_vars=True), saved["params"], "params")
        _copy_into(target_state["opt_state"], saved["opt_state"], "opt_state")
        target_state["step"] = saved["step"]
    extras = {}
    if (path / "extras.json").is_file():
        extras = json.loads((path / "extras.json").read_text())
    logging.info(f"restored checkpoint {path}")
    return target_state, extras


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
