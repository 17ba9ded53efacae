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


def _strided_taps(out_size: int, in_size: int, align_corners: bool,
                  stride: int, device):
    """(lo index, hi index, hi weight) of every ``stride``-th output
    position of a 1-D linear resize, with F.interpolate's conventions."""
    i = torch.arange(0, out_size, stride, device=device, dtype=torch.float32)
    if align_corners:
        src = i * ((in_size - 1) / max(out_size - 1, 1))
    else:
        # negative source coordinates clamp to 0, as F.interpolate does
        src = ((i + 0.5) * (in_size / out_size) - 0.5).clamp_min(0.0)
    base = src.floor()
    lo = base.long().clamp(0, in_size - 1)
    hi = (base.long() + 1).clamp(0, in_size - 1)
    return lo, hi, src - base


def resize_bilinear_strided(x: torch.Tensor, height: int, width: int,
                            align_corners: bool = False, row_stride: int = 1,
                            col_stride: int = 1) -> torch.Tensor:
    """``resize_bilinear(x, height, width)[..., ::row_stride, ::col_stride, :]``
    without materialising the full-resolution result: only the sampled rows
    and columns are interpolated (two gathers and a lerp per axis)."""
    dt = x.dtype if x.is_floating_point() else torch.float32
    h, w = x.shape[-3], x.shape[-2]
    y = x.to(torch.float32)
    rlo, rhi, rw = _strided_taps(height, h, align_corners, row_stride,
                                 x.device)
    clo, chi, cw = _strided_taps(width, w, align_corners, col_stride,
                                 x.device)
    rw = rw[:, None, None]
    y = y.index_select(-3, rlo) * (1.0 - rw) + y.index_select(-3, rhi) * rw
    cw = cw[:, None]
    y = y.index_select(-2, clo) * (1.0 - cw) + y.index_select(-2, chi) * cw
    return y.to(dt)


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
