"""Sharding rules and parameter placement (counterpart of
``rstnet_tpu/parallel/sharding.py``).

:func:`spec_for` is the JAX rule, read from the port's parameter names: a
spec is one axis name (or None) per dim of the leaf as the JAX package holds
it, so a block parameter is read with its leading layer axis.

* ``tensor`` — Megatron-style: column-parallel on up-projections (QKV, FFN
  in-proj, embeddings, heads), row-parallel on down-projections.
* ``expert`` — MoE expert stacks shard their expert axis.
* ``pipe``   — the blocks' layer axis: each stage holds its contiguous
  ``n_layer / P`` blocks.
* ``fsdp``   — every weight additionally on its largest remaining divisible
  dim.

:func:`shard_params` places a model in place by those specs: the blocks of
other stages are dropped (``backbone.blocks`` becomes a dict keyed by the
global layer index, so names stay), ``tensor`` and ``expert`` dims become
``DTensor`` ``Shard(dim)`` placements, and the ``fsdp`` dims FSDP2's
``fully_shard`` over the ``fsdp`` axis with a ``shard_placement_fn`` that
returns the spec's dim (FSDP2's default, dim 0, is not the JAX rule).
``fully_shard`` wraps the model as one unit: its forward gathers every
parameter, its backward reduce-scatters the gradients. Parameters the rule
leaves whole on ``fsdp`` are FSDP2's ``ignored_params``, replicated, their
gradients summed by ``training/train_step.py``.

The backbone's attention and MLP run Megatron-style on the local shards
(:func:`local`). In a training forward every other tensor-sharded weight is
gathered where it is used (:func:`dense`: the compute after it is the same
on every rank, so its gradient is this rank's chunk).

Serving (``LMGen`` over a placed ``SpeechTextLM`` under ``set_mesh``) reads
the weights through :func:`serving_view`, whose contract is:

* (a) under ``fsdp`` it unshards FSDP2 once (``FSDPModule.unshard``) and the
  weights stay gathered while the model serves, so the step never meets an
  ``fsdp`` shard. :func:`reshard` puts the shards back (and drops the view;
  the next step unshards again);
* (b) the backbone's tensor-sharded weights stay ``DTensor`` s: its
  attention, MLP, ``wte`` (a vocab-parallel lookup) and ``lm_head``
  (column-parallel, the logits gathered) run on the local shards, so the
  only per-frame collectives are sums over ``tensor`` and that gather;
* (c) the depth side (``DEPTH_SIDE``: the codecformer, its input views,
  embeddings and norms, and ``audio_linears``) is gathered into whole plain
  tensors held on every rank, once per weight version: a step that finds a
  source tensor replaced or written in place gathers again. K1 takes the
  whole depth transformer in one launch, and the column rule's split of
  ``linear_in``'s gate-then-value rows has no Megatron split of K2's
  per-step slices (the JAX package keeps it sharded under GSPMD).

:func:`depth_side` is what the step reads the depth side from: the view's
replica on a placed model over more than one rank, else the model itself.

:func:`batch_slice` takes a rank's part of a global batch: rows over
``(data, fsdp)`` combined, the time axis over ``seq``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Any, Optional

import torch
from torch import nn

from rstnet_tpu_torch.parallel.mesh import Mesh

# path suffixes that are column-parallel (shard output dim = axis -2 of a
# [out, in] weight) vs row-parallel (shard input dim = axis -1)
_COL_KEYS = ("attn", "fc", "fc_1", "fc_2", "in_proj", "linear_in", "linear1", "wte",
             "input_emb", "codecformer_text_emb", "codecformer_emb", "lm_head",
             "audio_linears", "codecformer_in", "input_proj", "gate")
_ROW_KEYS = ("proj", "out_proj", "linear_out", "linear2", "output_proj")
# the module prefixes whose JAX leaves carry a leading layer axis that the
# port splits into one module a layer (``core.from_jax_params(stacked=)``)
STACKED = ("backbone.blocks",)


def _sizes(mesh) -> dict[str, int]:
    return mesh if isinstance(mesh, dict) else mesh.shape


def spec_for(name: str, shape, mesh) -> tuple:
    """The JAX ``_spec_for`` of the leaf at dotted path ``name`` with
    ``shape`` (as the JAX tree holds it) on ``mesh`` (a :class:`Mesh` or an
    ``{axis: size}`` dict): one axis name or None a dim."""
    keys = name.split(".")
    shape = tuple(shape)
    ndim = len(shape)
    spec: list[Any] = [None] * ndim
    sizes = _sizes(mesh)
    tensor_size, fsdp_size = sizes.get("tensor", 1), sizes.get("fsdp", 1)
    if ndim == 0:
        return ()
    is_weight = bool(keys) and (
        keys[-1] in ("weight", "A", "B")
        or keys[-1] in ("input_emb", "codecformer_text_emb", "codecformer_emb",
                        "codecformer_in", "wte", "embedding_sum"))

    pipe_size = sizes.get("pipe", 1)
    if pipe_size > 1 and "blocks" in keys and shape[0] % pipe_size == 0:
        spec[0] = "pipe"

    # per-expert weights are [E, out, in] (plus a leading layer axis when
    # the blocks are stacked), biases [E, out]
    expert_size = sizes.get("expert", 1)
    if expert_size > 1 and "experts" in keys:
        e_axis = ndim - 3 if keys[-1] == "weight" else ndim - 2
        if 0 <= e_axis and shape[e_axis] % expert_size == 0:
            spec[e_axis] = "expert"

    if tensor_size > 1 and is_weight and ndim >= 2:
        scope = keys[:-1] if keys[-1] == "weight" else keys
        kind = next((k for k in reversed(scope) if k in _COL_KEYS + _ROW_KEYS), None)
        if keys[-1] == "B":
            axis = ndim - 2  # LoRA B rows follow the base out-dim
        elif keys[-1] == "A":
            axis = None  # LoRA A is tiny; replicated over tensor
        elif kind in _ROW_KEYS:
            axis = ndim - 1
        elif kind in _COL_KEYS or keys[-1] in _COL_KEYS:
            axis = ndim - 2
        else:
            axis = None
        if axis is not None and spec[axis] is None and shape[axis] % tensor_size == 0:
            spec[axis] = "tensor"

    if fsdp_size > 1:
        for axis in sorted(range(ndim), key=lambda i: -shape[i]):
            if spec[axis] is None and shape[axis] % fsdp_size == 0 and shape[axis] >= fsdp_size:
                spec[axis] = "fsdp"
                break
    return tuple(spec)


def stacked_name(name: str) -> tuple[str, Optional[int]]:
    """(the JAX path of a port parameter, its layer index or None):
    ``backbone.blocks.3.attn.weight`` -> (``backbone.blocks.attn.weight``, 3)."""
    for prefix in STACKED:
        if name.startswith(prefix + "."):
            head, rest = name[len(prefix) + 1:].split(".", 1)
            if head.isdigit():
                return f"{prefix}.{rest}", int(head)
    return name, None


@dataclasses.dataclass
class Placement:
    """Where a port parameter lives: ``spec`` over its own dims, and the
    pipeline stage that holds it (None: every stage)."""

    spec: tuple
    stage: Optional[int] = None

    def axes(self) -> tuple:
        return tuple(a for a in self.spec if a is not None)


def param_placement(name: str, shape, mesh, n_layer: int) -> Placement:
    """The placement of port parameter ``name`` of ``shape``: the JAX rule
    on the stacked leaf for a block parameter (its layer axis gives the
    stage; an ``fsdp`` on the layer axis, which no real width picks, leaves
    the layer's tensor whole on ``fsdp``)."""
    jax_name, layer = stacked_name(name)
    if layer is None:
        return Placement(spec_for(name, shape, mesh))
    spec = spec_for(jax_name, (n_layer, *shape), mesh)
    stage = None
    if spec[0] == "pipe":
        stage = layer // (n_layer // _sizes(mesh)["pipe"])
    return Placement(spec[1:], stage)


def _n_layer(model: nn.Module) -> int:
    cfg = getattr(model, "config", None)
    return getattr(cfg, "n_layer", 0) or 1


def infer_param_placements(mesh, model: nn.Module) -> dict[str, Placement]:
    """:class:`Placement` of every parameter of ``model`` (by name)."""
    n_layer = _n_layer(model)
    return {name: param_placement(name, p.shape, mesh, n_layer)
            for name, p in model.named_parameters()}


def shard_bytes(placements: dict[str, Placement], params: dict[str, torch.Tensor],
                mesh) -> int:
    """Bytes one rank holds of ``params`` under ``placements`` (a stage's
    share of the blocks counted for every rank: the largest stage)."""
    sizes = _sizes(mesh)
    total = 0
    for name, p in params.items():
        pl = placements[name]
        div = math.prod(sizes.get(a, 1) for a in pl.axes())
        if pl.stage is not None:
            div *= sizes.get("pipe", 1)
        total += p.numel() * p.element_size() // div
    return total


def local_shard(full: torch.Tensor, spec: tuple, mesh: Mesh,
                rank: Optional[int] = None) -> torch.Tensor:
    """The chunk of ``full`` that ``rank`` (this process by default) holds
    under ``spec``."""
    out = full
    for d, axis in enumerate(spec):
        if axis is not None:
            n = mesh.size(axis)
            out = out.narrow(d, mesh.coord(axis, rank) * (full.shape[d] // n), full.shape[d] // n)
    return out


@dataclasses.dataclass
class ShardLayout:
    """What :func:`shard_params` did to a model: the mesh, every
    parameter's placement, global shape and dtype (the blocks of other
    stages included), and which parameters FSDP2 holds."""

    mesh: Mesh
    placements: dict[str, Placement]
    shapes: dict[str, tuple]
    dtypes: dict[str, torch.dtype]
    fsdp: set


def shard_params(mesh: Mesh, model: nn.Module) -> nn.Module:
    """Place ``model``'s parameters by :func:`spec_for` on ``mesh``, in
    place (see the module docstring); the model's ``_shard_layout`` records
    it. A one-rank mesh changes nothing."""
    placements = infer_param_placements(mesh, model)
    layout = ShardLayout(mesh, placements,
                         {n: tuple(p.shape) for n, p in model.named_parameters()},
                         {n: p.dtype for n, p in model.named_parameters()}, set())
    model._shard_layout = layout
    if mesh.world == 1:
        return model
    backbone = getattr(model, "backbone", model if hasattr(model, "blocks") else None)
    if mesh.size("pipe") > 1 and backbone is not None and any(
            pl.stage is not None for pl in placements.values()):
        stage = mesh.coord("pipe")
        per = _n_layer(model) // mesh.size("pipe")
        keep = nn.ModuleDict({str(i): b for i, b in enumerate(backbone.blocks)
                              if i // per == stage})
        backbone.blocks = keep
    from torch.distributed.tensor import DTensor, Shard

    own = dict(model.named_parameters())
    for name, p in own.items():
        spec = placements[name].spec
        tp_axes = [a for a in ("expert", "tensor") if a in spec]
        if not tp_axes:
            continue
        module, attr = _owner(model, name)
        tp_spec = tuple(a if a in tp_axes else None for a in spec)
        local = local_shard(p.data, tp_spec, mesh).contiguous()
        dt = DTensor.from_local(local, mesh.sub(*tp_axes),
                                [Shard(spec.index(a)) for a in tp_axes], run_check=False)
        module._parameters[attr] = nn.Parameter(dt, requires_grad=p.requires_grad)
    if mesh.size("fsdp") > 1:
        from torch.distributed.fsdp import fully_shard

        params = dict(model.named_parameters())
        dims = {id(p): placements[n].spec.index("fsdp") for n, p in params.items()
                if "fsdp" in placements[n].spec}
        ignored = {p for p in params.values() if id(p) not in dims}
        layout.fsdp = {n for n, p in params.items() if id(p) in dims}
        fully_shard(model, mesh=mesh.sub("fsdp"), ignored_params=ignored,
                    shard_placement_fn=lambda p: Shard(dims[id(p)]))
    return model


def reshard(model: nn.Module) -> None:
    """Put FSDP2's parameters back in their shards. FSDP2 leaves the root
    unit's parameters gathered after a forward that no backward follows
    (an eval step), and then ``named_parameters`` holds whole tensors
    where a state's moments are shards. Every rank of the fsdp group must
    call it; a no-op without FSDP2."""
    from torch.distributed.fsdp import FSDPModule

    for m in model.modules():
        if isinstance(m, FSDPModule):
            m.reshard()
    model.__dict__.pop("_serving_view", None)


# a SpeechTextLM's depth side: what serving holds whole on every rank
DEPTH_SIDE = ("codecformer", "audio_linears", "codecformer_in", "codecformer_text_emb",
              "codecformer_emb", "codecformer_emb_norm", "codecformer_text_emb_norm")


@dataclasses.dataclass
class ServingView:
    """What :func:`serving_view` made: the depth side's whole replica (a
    module with the model's attribute names) and the (address, version) of
    every source tensor it was gathered from."""

    depth: nn.Module
    sources: tuple


def _sources(model: nn.Module) -> tuple:
    return tuple((local(p).data_ptr(), local(p)._version)
                 for name in DEPTH_SIDE if hasattr(model, name)
                 for p in _params_of(getattr(model, name)))


def _params_of(x) -> list:
    return list(x.parameters()) if isinstance(x, nn.Module) else [x]


def _gathered(w) -> torch.Tensor:
    """A weight whole. A ``DTensor`` split over one mesh axis is gathered
    by ``torch.distributed.all_gather`` (which gloo runs on CUDA tensors
    too), any other by ``full_tensor``; a plain tensor is itself."""
    if is_dtensor(w) and w.device_mesh.ndim == 1 and w.placements[0].is_shard():
        from rstnet_tpu_torch.parallel.comm import gather_dim

        return gather_dim(w.to_local(), w.placements[0].dim, w.device_mesh.get_group())
    return dense(w)


def _whole(x):
    """A copy of module or parameter ``x`` over whole plain tensors: a
    ``DTensor`` gathered, any other tensor shared."""
    if not isinstance(x, nn.Module):
        return nn.Parameter(_gathered(x.detach()), requires_grad=False)
    out = copy.copy(x)
    out._parameters = {k: None if p is None else _whole(p) for k, p in x._parameters.items()}
    out._buffers = dict(x._buffers)
    out._modules = {k: None if m is None else _whole(m) for k, m in x._modules.items()}
    return out


@torch.no_grad()
def serving_view(model: nn.Module) -> ServingView:
    """Prepare a model placed by :func:`shard_params` for streaming (the
    module docstring's contract): unshard FSDP2 once, and return the depth
    side's whole replica, gathered again only when a source changed. Every
    rank must call it at the same point (it runs collectives when it
    gathers)."""
    view = model.__dict__.get("_serving_view")
    sources = _sources(model)
    if view is not None and view.sources == sources:
        return view
    from torch.distributed.fsdp import FSDPModule

    fsdp = [m for m in model.modules() if isinstance(m, FSDPModule)]
    for m in fsdp:
        m.unshard()
    if fsdp:
        sources = _sources(model)  # the unsharded parameters
    depth = nn.Module()
    for name in DEPTH_SIDE:
        if hasattr(model, name):
            setattr(depth, name, _whole(getattr(model, name)))
    view = model.__dict__["_serving_view"] = ServingView(depth, sources)
    return view


def depth_side(model: nn.Module) -> nn.Module:
    """Where a serving step reads the depth side: :func:`serving_view`'s
    replica when ``model`` is placed over more than one rank, else
    ``model`` itself."""
    layout = getattr(model, "_shard_layout", None)
    if layout is None or layout.mesh.world == 1:
        return model
    return serving_view(model).depth


def _owner(model: nn.Module, name: str) -> tuple[nn.Module, str]:
    path, attr = name.rsplit(".", 1) if "." in name else ("", name)
    return (model.get_submodule(path) if path else model), attr


_DTENSOR: list = []  # the DTensor class, imported at first use


def is_dtensor(t) -> bool:
    if not _DTENSOR:
        from torch.distributed.tensor import DTensor

        _DTENSOR.append(DTensor)
    return isinstance(t, _DTENSOR[0])


def dense(w):
    """A weight whole: a ``DTensor`` gathered (its gradient is this rank's
    chunk of the full one, which every rank computes alike), a tensor as it
    is."""
    return w.full_tensor() if is_dtensor(w) else w


def local(w):
    """A weight's local shard (the tensor itself when it is not sharded)."""
    return w.to_local() if is_dtensor(w) else w


def row_split_group(w):
    """The process group of a ``DTensor`` weight split along dim 0 over one
    mesh axis (a vocab-split table, a column-parallel head), else None."""
    if not is_dtensor(w) or w.device_mesh.ndim != 1:
        return None
    from torch.distributed.tensor import Shard

    return w.device_mesh.get_group() if tuple(w.placements) == (Shard(0),) else None


def _row_group(mesh: Mesh, rank: int) -> int:
    return mesh.coord("data", rank) * mesh.size("fsdp") + mesh.coord("fsdp", rank)


def batch_slice(mesh: Optional[Mesh], batch: dict, rank: Optional[int] = None,
                hosts: int = 1) -> dict:
    """``rank``'s (this process's) part of a batch of arrays or tensors:
    leading rows over ``(data, fsdp)`` combined, and for arrays of 2+ dims
    the last (time) axis over ``seq``. With ``hosts`` > 1 (ranks laid out
    host by host) the batch is the host's, split over the row groups its
    ranks hold, and a host must hold whole row groups. Raises ValueError
    when a split is uneven."""
    if mesh is None or mesh.world == 1:
        return dict(batch)
    rank = mesh.rank if rank is None else rank
    per_host = mesh.world // hosts
    held = [sorted({_row_group(mesh, r) for r in range(h * per_host, (h + 1) * per_host)})
            for h in range(hosts)]
    if sum(map(len, held)) != mesh.size("data") * mesh.size("fsdp"):
        raise ValueError(f"mesh {mesh.shape} over {hosts} hosts: a rank's pipe/seq/expert/"
                         "tensor line must lie within its host, which reads its own batches")
    groups = held[rank // per_host]
    n_rows, row = len(groups), groups.index(_row_group(mesh, rank))
    n_seq, s = mesh.size("seq"), mesh.coord("seq", rank)
    out = {}
    for k, v in batch.items():
        B = v.shape[0]
        if B % n_rows:
            raise ValueError(f"batch {k} has {B} rows, not divisible by its {n_rows} row groups")
        v = v[row * (B // n_rows):(row + 1) * (B // n_rows)]
        if v.ndim >= 2 and n_seq > 1:
            T = v.shape[-1]
            if T % n_seq:
                raise ValueError(f"batch {k} has {T} steps, not divisible by seq = {n_seq}")
            v = v[..., s * (T // n_seq):(s + 1) * (T // n_seq)]
        out[k] = v
    return out
