"""Reading and writing model weights, the counterpart of
``txr/models/checkpoint.py`` and of the file loading in
``txr/models/convert.py``.

``load_checkpoint`` reads what ``DepthAnythingModel(checkpoint_path=...)``
accepts:

- a ``.safetensors`` file (``safetensors`` is imported only here, when such
  a file is read);
- a ``.pth`` / ``.pt`` / ``.bin`` file (``torch.load`` with
  ``weights_only=True``; a ``state_dict`` or ``model`` wrapper is unwrapped);
  either kind in Hugging Face or original Depth-Anything naming, mapped by
  ``txr_torch.models.convert.convert_state_dict``;
- a directory written by ``save_params``: the port's own form, the model's
  state dict saved with ``torch.save``.

``txr`` converts a PyTorch checkpoint to its own layout once and keeps the
result in an on-disk cache; the published weights are PyTorch's already, so
nothing is converted here and there is no cache.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Mapping

import torch

from txr_torch.models.convert import convert_state_dict

logger = logging.getLogger(__name__)

PARAMS_FILE = "params.pt"


def save_params(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """Write a state dict into directory ``path`` (created if missing)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    cpu = {k: v.detach().to("cpu") for k, v in params.items()}
    tmp = os.path.join(path, PARAMS_FILE + ".tmp")
    torch.save(cpu, tmp)
    os.replace(tmp, os.path.join(path, PARAMS_FILE))   # all or nothing
    logger.info("Saved params to %s", path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """Read the state dict that ``save_params`` wrote into ``path``."""
    return torch.load(os.path.join(os.path.abspath(path), PARAMS_FILE),
                      map_location="cpu", weights_only=True)


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` or ``torch.save`` file, on the CPU,
    under the names the file gives them."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path, device="cpu")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and isinstance(sd.get("model"), dict):
        sd = sd["model"]
    if not isinstance(sd, dict):
        raise ValueError(f"{path} does not hold a state dict")
    return sd


def load_checkpoint(path: str, num_layers: int) -> Dict[str, torch.Tensor]:
    """State dict for ``DepthAnything`` from a checkpoint file or a
    ``save_params`` directory."""
    if os.path.isdir(path):
        return load_params(path)
    return convert_state_dict(read_state_dict(path), num_layers)
