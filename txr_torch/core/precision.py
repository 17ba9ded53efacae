"""Full-f32 products for the geometry path, the counterpart of
``txr/core/precision.py``.

On an H100, PyTorch may run float32 matmuls and convolutions in TF32 (a
10-bit mantissa): ``torch.backends.cudnn.allow_tf32`` is on by default and
``torch.backends.cuda.matmul.allow_tf32`` is a process-wide switch a caller
may turn on. TF32 inputs cost the sparse geometry stack (normal equations
A^T A, DLT triangulation, Sampson residuals, Gauss-Newton steps) about
three significant digits before a solve starts; reduced-precision f32
products are what cost ``txr`` an 8 % metric-scale error on its first
accelerator.

``f32_dots`` turns both switches off for the code it wraps and gives the
caller's settings back on exit. It is never a global switch: the depth
network keeps whatever the process chose. It is applied exactly where
``txr`` applies its ``f32_dots``. Used as a decorator::

    @f32_dots
    def fn(...): ...

or, called without a function, as a context manager::

    with f32_dots():
        ...

``TXR_F32_DOTS=0`` disables it (read at each entry), as in ``txr``: for
attribution only, never to ship.

``kernel_autocast`` is the other precision decision: the bf16 autocast
under which training and the data-parallel fusion step run the model from
f32 master weights on the card.
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext
from functools import wraps

import torch


@contextmanager
def _f32_products():
    if os.environ.get("TXR_F32_DOTS", "1") == "0":
        yield
        return
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


def f32_dots(fn=None):
    """Decorator (``@f32_dots``) or context manager (``with f32_dots():``):
    TF32 off for matmuls and cuDNN inside, the caller's settings after."""
    if fn is None:
        return _f32_products()

    @wraps(fn)
    def wrapper(*args, **kwargs):
        with _f32_products():
            return fn(*args, **kwargs)

    return wrapper


def kernel_autocast(device_type: str):
    """The precision under which the model trains and runs from f32 master
    weights: bf16 autocast on the card, whose hand kernels take bf16 only
    (each raises by name for another type), and nothing on the CPU, where
    the plain versions run in f32 as ``txr`` does."""
    if device_type == "cuda":
        return torch.autocast("cuda", dtype=torch.bfloat16)
    return nullcontext()
