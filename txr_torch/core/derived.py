"""A tensor derived from a parameter, kept until the parameter changes.

Quantised or repacked copies of a weight are pure functions of the weight.
``Derived`` recomputes one when the parameter's storage, version counter,
dtype, device, shape or stride differs from what it last saw, or when the
extra arguments of ``get`` differ from the last call's, so the copy
follows ``load_state_dict``, ``.to(...)``, and any in-place update (each
of which moves the storage or bumps ``Tensor._version``) and is otherwise
reused across forward calls. Only the latest value is kept, except that
a value handed out while a CUDA stream captures is held for the life of
the ``Derived``: the captured graph reads it by address on every replay,
after ``get`` may have moved on to another value.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def _capturing() -> bool:
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


class Derived:
    """Caches ``fn(param, *args)`` for the current state of ``param`` and
    the latest ``args``; ``computed`` says whether the last ``get`` ran
    ``fn``."""

    def __init__(self, fn: Callable[..., Any]):
        self._fn = fn
        self._key: Optional[tuple] = None
        self._value: Any = None
        self.computed = False
        self._captured: list = []       # values a CUDA graph reads

    def get(self, param: torch.Tensor, *args) -> Any:
        key = (param.data_ptr(), param._version, param.dtype, param.device,
               tuple(param.shape), tuple(param.stride()), args)
        self.computed = key != self._key
        if self.computed:
            with torch.no_grad():
                self._value = self._fn(param.detach(), *args)
            self._key = key
        if _capturing() and not any(v is self._value
                                    for v in self._captured):
            self._captured.append(self._value)
        return self._value
