"""Scale-out on ``torch.distributed``, the counterpart of ``txr.parallel``:
the (dp, tp) mesh and its sharding rules (``mesh``), data-parallel fusion
with the exact map merge (``pipeline``), and a launcher that runs a function
on N ranks of one process group (``launch``)."""

from txr_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_shardings,
    replicated,
    shard_batch,
    shard_params,
    unshard_grads,
    unshard_state_dict,
)

__all__ = [
    "make_mesh",
    "shard_params",
    "param_shardings",
    "shard_batch",
    "batch_sharding",
    "replicated",
    "unshard_state_dict",
    "unshard_grads",
]
