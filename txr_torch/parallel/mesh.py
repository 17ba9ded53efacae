"""Device mesh and sharding rules on ``torch.distributed``, the counterpart
of ``txr/parallel/mesh.py``.

A 2-D mesh ``("dp", "tp")`` over the ranks of the default process group
(``init_device_mesh``; gloo ranks on the CPU, NCCL ranks on cards):

- **dp**: frame batches split along their leading axis, each rank holding
  its slice (``shard_batch``);
- **tp**: the ViT's dense layers split over ranks with ``parallelize_module``:
  qkv, fc1 and w12 column-parallel (``ColwiseParallel``: the weight's rows,
  PyTorch's (out, in) layout, as ``Shard(0)``, and the bias), proj, fc2 and
  w3 row-parallel (``RowwiseParallel``: ``Shard(1)``, the output
  all-reduced over tp); every other parameter is replicated, as
  ``txr``'s rules say.

A column split must follow the layer's parts: the fused qkv rows are laid
out [3][H][D] and w12's [2][hidden], so a contiguous ``Shard(0)`` would give
a rank all of q and part of k. ``shard_params`` therefore reorders those
rows to [tp][parts][rows / tp] before it shards, so that each rank's slice
is [parts][rows / tp]: whole heads of q, k and v in the order the attention
kernel reads (the block reads its head count off the slice's width), or the
two matching halves of w12. ``unshard_state_dict`` gathers the shards and
undoes the reordering. A dimension that tp does not divide, or a head count
it does not, raises ``ValueError`` naming the parameter before anything is
moved.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

COLUMN_PARALLEL = ("qkv", "fc1", "w12")
ROW_PARALLEL = ("proj", "fc2", "w3")
# rows of a column-parallel product that belong together: q / k / v, and
# the two halves of SwiGLU's fused w12
PARTS = {"qkv": 3, "fc1": 1, "w12": 2}


def make_mesh(dp: Optional[int] = None, tp: int = 1) -> DeviceMesh:
    """A (dp, tp) mesh over the ranks of the default process group: CUDA
    devices when its backend is NCCL, the CPU otherwise."""
    n = dist.get_world_size()
    if dp is None:
        if n % tp:
            raise ValueError(f"{n} ranks not divisible by tp={tp}")
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp*tp={dp * tp} != {n} ranks")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device, (dp, tp), mesh_dim_names=("dp", "tp"))


def _role(name: str) -> Tuple[Optional[str], str]:
    """(the dense layer a parameter belongs to, if a tp rule names it;
    the parameter's own name)."""
    parts = name.split(".")
    layer = parts[-2] if len(parts) > 1 else ""
    if layer in COLUMN_PARALLEL or layer in ROW_PARALLEL:
        return layer, parts[-1]
    return None, parts[-1]


def param_placement(name: str):
    """The tp placement of one parameter by rule: ``Shard(0)`` for the
    weight and bias of a column-parallel layer, ``Shard(1)`` for the weight
    of a row-parallel one, ``Replicate()`` for everything else."""
    layer, leaf = _role(name)
    if layer in COLUMN_PARALLEL:
        return Shard(0)
    if layer in ROW_PARALLEL and leaf == "weight":
        return Shard(1)
    return Replicate()


def param_shardings(model: nn.Module, mesh: DeviceMesh) -> Dict[str, tuple]:
    """Each parameter's placements over the mesh's (dp, tp) axes, by rule
    (``txr``'s ``param_shardings``)."""
    return {name: (Replicate(), param_placement(name))
            for name, _ in model.named_parameters()}


def _heads(model: nn.Module, attn_name: str) -> Optional[int]:
    attn = model.get_submodule(attn_name)
    cfg = getattr(attn, "cfg", None)
    return getattr(cfg, "num_heads", None)


def check_divisible(model: nn.Module, tp: int) -> None:
    """Raise ``ValueError`` naming the first parameter whose split
    dimension tp does not divide (each part of a fused product apart), or
    whose attention heads it does not."""
    for name, p in model.named_parameters():
        layer, leaf = _role(name)
        if layer is None or (layer in ROW_PARALLEL and leaf != "weight"):
            continue
        axis = 0 if layer in COLUMN_PARALLEL else 1
        parts = PARTS.get(layer, 1)
        size = p.shape[axis]
        if size % (parts * tp):
            raise ValueError(
                f"param {name} dim {axis} ({size}"
                f"{f' = {parts} x {size // parts}' if parts > 1 else ''}) "
                f"not divisible by tp={tp}")
        if layer == "qkv":
            heads = _heads(model, name.rsplit(".", 2)[0])
            if heads is not None and heads % tp:
                raise ValueError(
                    f"param {name}: {heads} attention heads not divisible "
                    f"by tp={tp}")


def _interleave(t: torch.Tensor, parts: int, tp: int,
                inverse: bool = False) -> torch.Tensor:
    """Rows [parts][tp][n] -> [tp][parts][n] (or back)."""
    rows = t.shape[0] // (parts * tp)
    lead = (tp, parts) if inverse else (parts, tp)
    return t.reshape(*lead, rows, *t.shape[1:]).transpose(0, 1).reshape(
        t.shape)


def shard_params(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Lay the model's dense layers out over the mesh's tp axis by the
    rules above (in place; returns the model). Every rank must hold the
    same weights when it is called."""
    from torch.distributed.tensor.parallel import (ColwiseParallel,
                                                   RowwiseParallel,
                                                   parallelize_module)

    tp = mesh["tp"].size()
    check_divisible(model, tp)
    plan = {}
    for name, mod in model.named_modules():
        layer = name.rsplit(".", 1)[-1]
        if layer not in COLUMN_PARALLEL and layer not in ROW_PARALLEL:
            continue
        if type(mod) is not nn.Linear:
            raise TypeError(
                f"{name} is a {type(mod).__name__}; tensor parallelism "
                f"splits nn.Linear layers only (quant policy 'none')")
        if layer in COLUMN_PARALLEL:
            with torch.no_grad():
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.copy_(_interleave(p, PARTS[layer], tp))
            plan[name] = ColwiseParallel()
        else:
            plan[name] = RowwiseParallel()
    parallelize_module(model, mesh["tp"], plan)
    return model


def _unshard(name: str, t: torch.Tensor) -> torch.Tensor:
    """Parameter ``name``'s tensor (or its gradient) whole, in the
    unsharded layout."""
    if hasattr(t, "full_tensor"):
        tp = t.device_mesh.size()
        t = t.full_tensor()
        layer, _ = _role(name)
        if layer in COLUMN_PARALLEL:
            t = _interleave(t, PARTS[layer], tp, inverse=True)
    return t


def unshard_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's parameters as whole tensors in the unsharded layout
    (gathered over tp; collective, so every tp rank calls it)."""
    return {name: _unshard(name, p.detach())
            for name, p in model.named_parameters()}


def unshard_grads(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The parameters' gradients the same way (a parameter without one is
    left out)."""
    return {name: _unshard(name, p.grad)
            for name, p in model.named_parameters() if p.grad is not None}


def shard_batch(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's dp slice of a batch (the leading axis split into dp
    equal parts in rank order)."""
    dp = mesh["dp"].size()
    if x.shape[0] % dp:
        raise ValueError(f"batch {x.shape[0]} not divisible by dp={dp}")
    n = x.shape[0] // dp
    i = mesh.get_local_rank("dp")
    return x[i * n:(i + 1) * n].contiguous()


def batch_sharding(mesh: DeviceMesh) -> tuple:
    """Placements of a batch over (dp, tp): split over dp, whole on tp."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh) -> tuple:
    return (Replicate(), Replicate())
