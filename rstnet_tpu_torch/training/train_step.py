"""The training step (counterpart of ``rstnet_tpu/training/train_step.py``):
the loss, the optimizer, and the step with and without gradient
accumulation, for full-parameter training on one device.

Loss semantics as in JAX: audio CE over rows 1..dep_q with weights
[2, 1, ...], text CE over row 0, summed.

The optimizer is optax's, written out, not ``torch.optim.AdamW``:
``optax.chain(clip_by_global_norm, adamw)`` optionally wrapped in
``apply_if_finite``. So every parameter is decayed; the moments live in the
parameter's dtype; eps is added outside the square root; the bias
corrections ``1 - b**count`` are float32 and divide in the moment's dtype;
the schedule is read at the update count before it is incremented; the clip
scales by ``max_norm / norm`` only when ``norm >= max_norm`` (no epsilon);
a rejected non-finite update leaves the parameters and the optimizer state
(its count too) as they were, until more than ``skip_nonfinite`` in a row
have been rejected, after which the update is applied anyway. Constants
enter every product in the operand's dtype, as JAX's weakly typed Python
scalars do. Gradients accumulate in the parameter's dtype (``p.grad``).

The train state is ``{"model", "opt_state", "step"}`` (plus ``"micro"``
under cross-batch accumulation); the model's parameters are updated in
place. The trainable set is ``requires_grad``: every floating parameter, or
what a mask names (``init_train_state(..., trainable_mask)``). The
partitioned PEFT step (:func:`partition_params`, :func:`make_peft_train_step`)
is the same step over a model whose frozen side (an int8 base among them)
has ``requires_grad`` off: autograd never differentiates it, so no frozen
gradient exists even for a moment, and the optimizer state covers only the
trainable set. ``"trainable_only"`` in the state makes checkpoints hold only
the trainable parameters.

LoRA-branch dropout (``dropout_seed``): each step's forward gets a CPU
``torch.Generator`` seeded ``fold_in(seed, step)`` (and ``fold_in`` of that
with the microbatch index under accumulation), as JAX folds the step into
its key; a resumed run draws the same masks.

Under an ambient mesh (``parallel/mesh.py::set_mesh``) one step equals the
one-process step on the global batch, each rank given its part
(``parallel/sharding.py::batch_slice``): the loss's sums and token counts are
summed over the batch axes (``losses/ce.py``), so every rank computes the
global loss and its gradients are its share; :class:`MeshSync` sums them
over the batch axes (``data``, ``seq``, and ``fsdp`` where FSDP2 does not
already reduce-scatter them) in buckets, takes the clip's norm over every
shard once, and makes ``skip_nonfinite``'s decision the same on every rank.
The optimizer works on each parameter's local shard.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from rstnet_tpu_torch.core import fold_in
from rstnet_tpu_torch.losses.ce import cross_entropy_and_accuracy
from rstnet_tpu_torch.parallel.comm import all_reduce_, all_reduce_buckets
from rstnet_tpu_torch.parallel.mesh import BATCH_AXES, Mesh, batch_groups, current_mesh
from rstnet_tpu_torch.parallel.sharding import local

TEXT_PAD_TOKEN = 128003
ACOUSTIC_PAD_TOKEN = 2049


def make_loss_fn(model: nn.Module, audio_loss_weights: Optional[tuple[float, ...]] = None,
                 text_loss_weight: float = 1.0, audio_ignore_id: int = ACOUSTIC_PAD_TOKEN,
                 text_ignore_id: int = TEXT_PAD_TOKEN) -> Callable:
    """``loss_fn(batch, dropout_rng=None) -> (loss, metrics)`` over ``batch =
    {"tokens": [B, 1 + n_q, S] int, "masks": [B, 1 + n_q, S] float}`` on the
    model's device; ``dropout_rng`` goes to the model (LoRA-branch dropout)."""
    dep_q = model.config.dep_q
    if audio_loss_weights is None:
        audio_loss_weights = (2.0,) + (1.0,) * (dep_q - 1)

    def loss_fn(batch: dict, dropout_rng: torch.Generator | None = None
                ) -> tuple[torch.Tensor, dict]:
        seqs = batch["tokens"]
        masks = batch["masks"].float()
        groups = batch_groups()
        audio_logits, text_logits = model(seqs, dropout_rng=dropout_rng)
        loss_audio, m_audio = cross_entropy_and_accuracy(
            audio_logits, seqs[:, 1:dep_q + 1], masks[:, 1:dep_q + 1], audio_loss_weights,
            (audio_ignore_id,) * dep_q, groups)
        loss_text, m_text = cross_entropy_and_accuracy(
            text_logits[:, :, None, :], seqs[:, 0:1], masks[:, 0:1], (text_loss_weight,),
            (text_ignore_id,), groups)
        loss = loss_audio + loss_text
        return loss, {
            "loss": loss, "loss_audio": loss_audio, "loss_text": loss_text,
            "acc_audio": m_audio["acc_all"], "acc_text": m_text["acc_all"],
            "acc_audio_tgt": m_audio["acc_target"], "acc_text_tgt": m_text["acc_target"],
        }

    return loss_fn


def _const(x, like: torch.Tensor) -> torch.Tensor:
    """A Python or numpy scalar in ``like``'s dtype (a JAX weak scalar)."""
    return _scalar(float(x), like.dtype, like.device)


@functools.lru_cache(maxsize=256)
def _scalar(x: float, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=dtype, device=device)


class OptaxAdamW:
    """``optax.chain(clip_by_global_norm(grad_clip), adamw(...))``, wrapped in
    ``apply_if_finite(max_consecutive_errors=skip_nonfinite)`` when that is
    > 0; parameters and gradients are ``{name: tensor}`` dicts."""

    def __init__(self, schedule, betas: tuple[float, float] = (0.9, 0.95),
                 weight_decay: float = 1e-3, eps: float = 1e-8,
                 grad_clip: Optional[float] = None, skip_nonfinite: int = 0):
        self.schedule, self.b1, self.b2 = schedule, betas[0], betas[1]
        self.weight_decay, self.eps = weight_decay, eps
        self.grad_clip, self.skip_nonfinite = grad_clip, skip_nonfinite

    def init(self, params: dict[str, torch.Tensor]) -> dict:
        """Zero moments shaped as each parameter's local shard."""
        return {"count": 0, "notfinite_count": 0, "total_notfinite": 0, "last_finite": True,
                "mu": {n: torch.zeros_like(local(p)) for n, p in params.items()},
                "nu": {n: torch.zeros_like(local(p)) for n, p in params.items()}}

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor], state: dict,
               params: dict[str, torch.Tensor], sync: Optional["MeshSync"] = None) -> dict:
        """Apply one update to ``params`` in place; returns ``state``, also
        updated in place. Parameters and gradients may be sharded: the
        update runs on their local shards, and ``sync`` (a mesh's) gives the
        global norm and finite check."""
        params = {n: local(p) for n, p in params.items()}
        grads = {n: local(g) for n, g in grads.items()}
        if self.skip_nonfinite > 0:
            if sync is None:
                finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
            else:
                finite = sync.all_finite(grads)
            state["notfinite_count"] = 0 if finite else state["notfinite_count"] + 1
            state["total_notfinite"] += 0 if finite else 1
            state["last_finite"] = finite
            if not finite and state["notfinite_count"] <= self.skip_nonfinite:
                return state  # rejected: zero updates, inner state unchanged
        if self.grad_clip is not None:
            if sync is None:
                norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
            else:
                norm = sync.global_norm(grads)
            if not bool(norm < self.grad_clip):
                grads = {n: (g / norm.to(g.dtype)) * _const(self.grad_clip, g)
                         for n, g in grads.items()}
        count = state["count"] + 1
        bc1 = np.float32(1.0) - np.float32(self.b1) ** np.float32(count)
        bc2 = np.float32(1.0) - np.float32(self.b2) ** np.float32(count)
        step_size = -np.float32(self.schedule(state["count"]))
        for name, p in params.items():
            g, mu, nu = grads[name], state["mu"][name], state["nu"][name]
            mu.copy_(_const(1 - self.b1, g) * g + _const(self.b1, mu) * mu)
            nu.copy_(_const(1 - self.b2, g) * (g * g) + _const(self.b2, nu) * nu)
            u = (mu / _const(bc1, mu)) / (torch.sqrt(nu / _const(bc2, nu)) + _const(self.eps, nu))
            u = u + _const(self.weight_decay, p) * p
            p.copy_((p + _const(step_size, u) * u).to(p.dtype))
        state["count"] = count
        return state


class MeshSync:
    """The gradient collectives of one step on ``mesh`` for ``model``
    (placed by ``shard_params``, or replicated everywhere without it)."""

    def __init__(self, mesh: Mesh, model: Optional[nn.Module] = None):
        self.mesh = mesh
        layout = getattr(model, "_shard_layout", None)
        self.placements = layout.placements if layout is not None else {}
        self.fsdp = layout.fsdp if layout is not None else set()

    def _axes(self, name: str) -> tuple:
        pl = self.placements.get(name)
        return pl.axes() if pl is not None else ()

    def reduce(self, grads: dict[str, torch.Tensor]) -> None:
        """Sum each gradient (its local shard, in place) over the batch axes
        its parameter is replicated on, in buckets a set of axes. FSDP2's
        reduce-scatter averages over ``fsdp`` (gloo takes no pre-scaled
        sum), so its shards are scaled back to the sum."""
        by_axes: dict = {}
        for name, g in grads.items():
            fsdp = name in self.fsdp
            axes = tuple(a for a in BATCH_AXES if self.mesh.size(a) > 1
                         and not (a == "fsdp" and fsdp))
            by_axes.setdefault((axes, fsdp), []).append(local(g))
        for (axes, fsdp), ts in by_axes.items():
            all_reduce_buckets(ts, [self.mesh.group(a) for a in axes],
                               scale=float(self.mesh.size("fsdp")) if fsdp else None)

    def _copies(self, name: str) -> int:
        """How many ranks hold the same shard of ``name``."""
        pl = self.placements.get(name)
        held = math.prod(self.mesh.size(a) for a in self._axes(name))
        if pl is not None and pl.stage is not None:
            held *= self.mesh.size("pipe")
        return self.mesh.world // held

    def global_norm(self, grads: dict[str, torch.Tensor]) -> torch.Tensor:
        """The norm of the whole gradient: each shard's squares counted once
        (divided by its copies), summed over all ranks."""
        sq = torch.stack([torch.sum(g.float() * g.float()) / self._copies(n)
                          for n, g in grads.items()]).sum().reshape(1)
        return torch.sqrt(all_reduce_(sq, dist.group.WORLD))[0]

    def all_finite(self, grads: dict[str, torch.Tensor]) -> bool:
        """Whether every rank's gradients are finite (one decision for all)."""
        bad = torch.stack([~torch.isfinite(g).all() for g in grads.values()]).any()
        return not bool(all_reduce_(bad.float().reshape(1), dist.group.WORLD,
                                    dist.ReduceOp.MAX)[0] > 0)


def mesh_sync(model: Optional[nn.Module] = None) -> Optional[MeshSync]:
    """The ambient mesh's :class:`MeshSync` for ``model`` (placed by
    ``shard_params``, or None: every parameter replicated), or None on one
    rank."""
    mesh = current_mesh()
    return MeshSync(mesh, model) if mesh is not None and mesh.world > 1 else None


def make_optimizer(learning_rate_schedule, betas: tuple[float, float] = (0.9, 0.95),
                   weight_decay: float = 1e-3, eps: float = 1e-8,
                   grad_clip: Optional[float] = None, skip_nonfinite: int = 0) -> OptaxAdamW:
    """AdamW with the reference's hyperparameters; ``skip_nonfinite > 0``
    drops updates with NaN/inf gradients, up to that many in a row."""
    return OptaxAdamW(learning_rate_schedule, betas, weight_decay, eps, grad_clip,
                      skip_nonfinite)


def trainable_params(model: nn.Module) -> dict[str, torch.Tensor]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def init_train_state(model: nn.Module, tx: OptaxAdamW,
                     trainable_mask: Optional[dict[str, bool]] = None) -> dict:
    """Make every floating parameter trainable (the port builds them for
    inference, without autograd), or those that ``trainable_mask`` ({name:
    bool}) marks and no other, and set up the optimizer state over them."""
    if trainable_mask is not None:
        partition_params(model, trainable_mask)
    else:
        for p in model.parameters():
            p.requires_grad_(p.is_floating_point())
    return {"model": model, "opt_state": tx.init(trainable_params(model)), "step": 0}


def partition_params(model: nn.Module, trainable_mask: dict[str, bool]
                     ) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Split the model's parameters along ``trainable_mask`` ({name: bool},
    every parameter named) into (trainable, frozen) ``{name: tensor}``
    dicts, turning ``requires_grad`` on for the first and off for the
    second, so a backward never computes a frozen gradient. Frozen
    parameters may be int8 (``quantize_backbone_int8``); a trainable one
    must be floating."""
    named = dict(model.named_parameters())
    if set(named) != set(trainable_mask):
        raise KeyError(f"mask and parameters differ: {sorted(set(named) ^ set(trainable_mask))}")
    trainable, frozen = {}, {}
    for name, p in named.items():
        if trainable_mask[name] and not p.is_floating_point():
            raise TypeError(f"{name} is {p.dtype}: only floating parameters can train")
        p.requires_grad_(trainable_mask[name])
        (trainable if trainable_mask[name] else frozen)[name] = p
    return trainable, frozen


def combine_params(trainable: dict[str, torch.Tensor], frozen: dict[str, torch.Tensor]
                   ) -> dict[str, torch.Tensor]:
    """Inverse of :func:`partition_params`: one ``{name: tensor}`` dict."""
    return {**frozen, **trainable}


def step_generator(seed: Optional[int], step: int, micro: Optional[int] = None
                   ) -> Optional[torch.Generator]:
    """The dropout generator of ``step`` (and microbatch ``micro``), or
    None without a seed."""
    if seed is None:
        return None
    s = fold_in(seed, step)
    return torch.Generator().manual_seed(s if micro is None else fold_in(s, micro))


def _detached(metrics: dict) -> dict:
    return {k: v.detach() for k, v in metrics.items()}


def _grads(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """The accumulated ``.grad`` of each parameter; zeros for one the loss
    did not reach (JAX's gradient of an unused leaf)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in params.items()}


def make_train_step(loss_fn: Callable, tx: OptaxAdamW, grad_accum: int = 1,
                    dropout_seed: Optional[int] = None) -> Callable:
    """``step(state, batch) -> (state, metrics)``. With ``grad_accum > 1``
    the batch carries a leading microbatch axis ``[A, B, ...]``; gradients
    and metrics are summed over it and divided by A (the JAX scan).
    ``dropout_seed`` (not None) gives the forwards their dropout generator."""

    def step_fn(state: dict, batch: dict) -> tuple[dict, dict]:
        params = trainable_params(state["model"])
        for p in params.values():
            p.grad = None
        if grad_accum > 1:
            msum = None
            for a in range(grad_accum):
                loss, metrics = loss_fn({k: v[a] for k, v in batch.items()},
                                        step_generator(dropout_seed, state["step"], a))
                loss.backward()
                metrics = _detached(metrics)
                msum = metrics if msum is None else {k: msum[k] + metrics[k] for k in msum}
            grads = {n: g / grad_accum for n, g in _grads(params).items()}
            metrics = {k: v / grad_accum for k, v in msum.items()}
        else:
            loss, metrics = loss_fn(batch, step_generator(dropout_seed, state["step"]))
            loss.backward()
            grads = _grads(params)
            metrics = _detached(metrics)
        sync = mesh_sync(state["model"])
        if sync is not None:
            sync.reduce(grads)
        tx.update(grads, state["opt_state"], params, sync)
        for p in params.values():
            p.grad = None
        state["step"] += 1
        return state, metrics

    return step_fn


def make_peft_train_step(loss_fn: Callable, tx: OptaxAdamW, grad_accum: int = 1,
                         dropout_seed: Optional[int] = None) -> Callable:
    """The train step over a partitioned model: ``step(state, frozen,
    batch) -> (state, metrics)``, ``frozen`` the second dict of
    :func:`partition_params`. The frozen parameters live in the model with
    ``requires_grad`` off, so :func:`make_train_step`'s step differentiates
    and updates only the trainable ones; this checks that first."""
    step = make_train_step(loss_fn, tx, grad_accum, dropout_seed)

    def peft_step(state: dict, frozen: dict[str, torch.Tensor], batch: dict):
        if any(p.requires_grad for p in frozen.values()):
            raise ValueError("a frozen parameter requires grad: partition the model first")
        return step(state, batch)

    return peft_step


def make_grad_accum_steps(loss_fn: Callable, tx: OptaxAdamW,
                          dropout_seed: Optional[int] = None) -> tuple[Callable, Callable]:
    """Cross-batch accumulation, ``(accum_step, apply_step)``:
    ``accum_step(state, batch)`` adds the batch's gradients into the
    parameters' ``.grad`` (param dtype) and counts it in ``state["micro"]``;
    ``apply_step(state)`` divides by the count, updates and clears. The
    accumulator is not checkpointed: a resume restarts the window."""

    def accum_step(state: dict, batch: dict) -> tuple[dict, dict]:
        micro = state.get("micro", 0)
        loss, metrics = loss_fn(batch, step_generator(dropout_seed, state["step"], micro))
        loss.backward()
        state["micro"] = micro + 1
        return state, _detached(metrics)

    def apply_step(state: dict) -> dict:
        params = trainable_params(state["model"])
        n = max(state.get("micro", 0), 1)
        grads = _grads(params)
        sync = mesh_sync(state["model"])
        if sync is not None:
            sync.reduce(grads)
        grads = {name: local(g) / torch.tensor(float(n), dtype=torch.float32, device=g.device)
                 for name, g in grads.items()}
        tx.update(grads, state["opt_state"], params, sync)
        for p in params.values():
            p.grad = None
        state["step"] += 1
        state["micro"] = 0
        return state

    return accum_step, apply_step


def make_eval_step(loss_fn: Callable) -> Callable:
    def eval_fn(batch: dict) -> dict:
        with torch.no_grad():
            return _detached(loss_fn(batch)[1])

    return eval_fn
