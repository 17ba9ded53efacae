"""Image resize ops, the counterpart of ``txr/ops/resize.py``.

``txr`` spells bilinear and bicubic resize out as interpolation-matrix
products because its backend has no ``F.interpolate``; the conventions it
implements are exactly PyTorch's (Keys bicubic a=-0.75 with clamped taps and
no antialiasing, bilinear with both ``align_corners`` settings). Here they
are ``F.interpolate`` itself. These ops sit outside every hand-written
kernel in ``txr`` as well, so plain PyTorch ops are their port.

Layout: NHWC, ``(..., H, W, C)``, as in ``txr``. Internally the tensor is
viewed as NCHW in ``channels_last`` memory, which costs no copy.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# ImageNet statistics used by every Depth Anything preprocessing pipeline.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _resize(x: torch.Tensor, height: int, width: int, mode: str,
            align_corners: bool) -> torch.Tensor:
    if not x.is_floating_point():
        x = x.to(torch.float32)
    lead = x.shape[:-3]
    h, w, c = x.shape[-3:]
    y = x.reshape(-1, h, w, c).permute(0, 3, 1, 2)      # NCHW view of NHWC
    y = F.interpolate(y, size=(height, width), mode=mode,
                      align_corners=align_corners)
    return y.permute(0, 2, 3, 1).reshape(*lead, height, width, c)


def resize_bilinear(x: torch.Tensor, height: int, width: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of (..., H, W, C) to (..., height, width, C).

    A floating input keeps its dtype (bf16 activations stay bf16)."""
    return _resize(x, height, width, "bilinear", align_corners)


def resize_bicubic(x: torch.Tensor, height: int, width: int,
                   align_corners: bool = False) -> torch.Tensor:
    """Bicubic (Keys a=-0.75, taps clamped at the border, no antialias)
    resize of (..., H, W, C)."""
    return _resize(x, height, width, "bicubic", align_corners)


def constrain_to_multiple_of(val: float, multiple: int, min_val: int = 0
                             ) -> int:
    """Round to the nearest multiple (DA Resize.constrain_to_multiple_of)."""
    out = int(round(val / multiple) * multiple)
    if out < min_val:
        out = int(-(-val // multiple) * multiple)  # ceil
    return max(out, multiple)


def compute_da_resize(h: int, w: int, target: int = 518, multiple: int = 14,
                      lower_bound: bool = True) -> tuple:
    """Depth-Anything 'lower_bound' aspect-preserving resize shape.

    The short side scales to ``target`` and both sides round to a multiple
    of 14."""
    scale_h = target / h
    scale_w = target / w
    if lower_bound:
        s = max(scale_h, scale_w)
    else:
        s = min(scale_h, scale_w)
    return (constrain_to_multiple_of(s * h, multiple, min_val=target),
            constrain_to_multiple_of(s * w, multiple, min_val=target))
