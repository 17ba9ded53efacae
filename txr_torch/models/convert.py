"""Weights across: ``txr``'s parameter tree -> a ``DepthAnything`` state dict.

``from_txr_params`` is the inverse of ``txr/models/convert.py``'s layout
rules, applied leaf by leaf to the nested dict of arrays that ``txr`` calls
its params (``{"encoder": {...}, "head": {...}}``):

- Dense ``kernel`` (in, out)            -> ``nn.Linear.weight`` (out, in)
- Conv ``kernel`` HWIO (kh, kw, I, O)   -> ``nn.Conv2d.weight`` OIHW
- ConvTranspose ``kernel`` (``resize_0``, ``resize_1``): ``txr`` stores it
  spatially FLIPPED for its framework's convention, (kh, kw, I, O); PyTorch's
  ``ConvTranspose2d.weight`` is (I, O, kh, kw) unflipped, so the flip is
  undone here
- LayerNorm ``scale``                   -> ``weight``
- everything else (biases, cls_token, pos_embed, ls1, ls2) keeps its name

The fused qkv kernel stays fused and component-major. Module names in
``txr_torch.models`` mirror the tree's, so a leaf's path is its key.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_TRANSPOSED_CONVS = ("resize_0", "resize_1")


def _leaf(path: tuple, value: np.ndarray):
    """(state-dict key, array) for one leaf of the txr tree."""
    v = np.asarray(value)
    name = path[-1]
    module = path[-2] if len(path) > 1 else ""
    if name == "kernel":
        if v.ndim == 2:
            v = v.T
        elif v.ndim == 4 and module in _TRANSPOSED_CONVS:
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel {'.'.join(path)} has rank {v.ndim}")
        name = "weight"
    elif name == "scale":
        name = "weight"
    return ".".join(path[:-1] + (name,)), np.ascontiguousarray(v)


def from_txr_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (``txr`` params) -> ``state_dict`` for
    ``txr_torch.models.depth_anything.DepthAnything``.

    Arrays keep their dtype where PyTorch has it (float32, float16); any
    other floating type (bfloat16 arrays have no numpy dtype PyTorch reads)
    goes through float32. Load with ``model.load_state_dict(sd)``, which
    casts to the model's dtype.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, child in node.items():
                walk(child, path + (str(k),))
            return
        key, arr = _leaf(path, node)
        if arr.dtype not in (np.float32, np.float16, np.float64):
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.array(arr))   # a writable copy

    walk(params, ())
    return out
