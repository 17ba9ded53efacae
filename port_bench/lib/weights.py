"""Seeded weights of a configuration, made by the harness and handed to
both the program and the reference.

Every leaf is ``mean + std * z`` with ``z`` standard normal: one ``randn``
over all leaves on the card from a generator seeded with the run's seed,
an in-place affine per leaf view (the mean taken out of the leaves the
architecture names in ``CENTRED``), and one cast to the served dtype. The
leaves, their order and their laws are the architecture's
(``archs/<architecture>.py``: ``leaves``); their names are the state-dict
names of the program's model, which loads the dict with
``load_state_dict(strict=True)``, and the reference reads it by the same
names.
"""

from __future__ import annotations

import math
from types import ModuleType
from typing import Dict

import torch


def make_weights(arch: ModuleType, cfg: dict, seed: int, device,
                 dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed`` on ``device`` in ``dtype``:
    views into one flat buffer."""
    specs = arch.leaves(cfg)
    sizes = [math.prod(s) for _, s, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    for (name, _, mean, std), part in zip(specs, flat.split(sizes)):
        part.mul_(std).add_(mean)
        if name in arch.CENTRED:
            part.sub_(part.mean())
    flat = flat.to(dtype)
    return {name: part.view(shape) for (name, shape, _, _), part
            in zip(specs, flat.split(sizes))}
