"""A tensor derived from a parameter, kept until the parameter changes.

Quantised or repacked copies of a weight are pure functions of the weight.
``Derived`` recomputes one when the parameter's storage, version counter,
dtype, device or shape differs from what it last saw, so the copy follows
``load_state_dict``, ``.to(...)``, and any in-place update (each of which
moves the storage or bumps ``Tensor._version``) and is otherwise reused
across forward calls.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


class Derived:
    """Caches ``fn(param)`` for the current state of ``param``."""

    def __init__(self, fn: Callable[[torch.Tensor], Any]):
        self._fn = fn
        self._key: Optional[tuple] = None
        self._value: Any = None

    def get(self, param: torch.Tensor) -> Any:
        key = (param.data_ptr(), param._version, param.dtype, param.device,
               tuple(param.shape), tuple(param.stride()))
        if key != self._key:
            with torch.no_grad():
                self._value = self._fn(param.detach())
            self._key = key
        return self._value
