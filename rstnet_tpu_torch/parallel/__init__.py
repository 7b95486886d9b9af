"""Parallelism over ``torch.distributed`` (counterpart of
``rstnet_tpu/parallel``): one mesh of named axes and the sharding rules that
place a model on it."""

from rstnet_tpu_torch.parallel.mesh import make_mesh
from rstnet_tpu_torch.parallel.sharding import batch_slice, infer_param_placements, shard_params

__all__ = ["make_mesh", "infer_param_placements", "batch_slice", "shard_params"]
