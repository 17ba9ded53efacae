"""Canny edge detection, the counterpart of ``txr/ops/canny.py``.

The hybrid detector computes Canny(50, 150) edge maps per frame (reference
depth_enhanced_reconstruction.py:246 via OpenCV C++). The same formulation
as ``txr``'s, in elementwise tensor ops on the image's device:

  1. Sobel gradients as two 3x3 convolutions over a replicate-padded image
     (integers in f32 for a uint8 image: exact in any summation order),
  2. non-maximum suppression with the gradient direction quantised to 4
     sectors (comparisons against the two neighbours along the direction),
  3. double threshold,
  4. hysteresis as a fixed-iteration dilation loop: strong edges seed, weak
     pixels join when 8-connected to an accepted pixel. ``iterations`` bounds
     propagation along weak chains (OpenCV floods the whole component).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
_SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def _conv2(img: torch.Tensor, k) -> torch.Tensor:
    """3x3 cross-correlation of (H, W) with replicate borders (OpenCV
    BORDER_REPLICATE: zero padding would make strong fake gradients along
    the frame)."""
    w = torch.tensor(k, dtype=img.dtype, device=img.device).view(1, 1, 3, 3)
    x = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")
    return F.conv2d(x, w)[0, 0]


def _shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = x[y + dy, x + dx], zero outside the image (a neighbour
    beyond the border never wins; a roll would join opposite edges)."""
    h, w = x.shape
    padded = F.pad(x, (1, 1, 1, 1))
    return padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _dilate8(m: torch.Tensor) -> torch.Tensor:
    """8-neighbour dilation of a bool map (the pixel itself included)."""
    return F.max_pool2d(m[None, None].to(torch.float32), 3, stride=1,
                        padding=1)[0, 0] > 0


@torch.no_grad()
def canny(image: torch.Tensor, low: float = 50.0, high: float = 150.0,
          iterations: int = 16, l2gradient: bool = False) -> torch.Tensor:
    """Edge map of a (H, W) uint8 image -> (H, W) uint8 {0, 255}, on the
    image's device."""
    x = image.to(torch.float32)
    gx = _conv2(x, _SOBEL_X)
    gy = _conv2(x, _SOBEL_Y)
    if l2gradient:
        mag = torch.sqrt(gx * gx + gy * gy)
    else:
        mag = gx.abs() + gy.abs()   # OpenCV's default L1 approximation

    # Direction quantised to 4 sectors: 0, 45, 90, 135 degrees. The
    # divisor is a tensor: a division by a Python number may be taken as a
    # product with its rounded reciprocal.
    ang = torch.atan2(gy, gx)                      # [-pi, pi]
    deg = torch.where(ang < 0, ang + math.pi, ang)  # [0, pi]
    quarter = torch.tensor(math.pi / 4, dtype=torch.float32,
                           device=x.device)
    sector = torch.remainder(
        torch.floor((deg + math.pi / 8) / quarter).to(torch.int32), 4)

    n0a, n0b = _shift(mag, 0, 1), _shift(mag, 0, -1)      # 0: left / right
    n1a, n1b = _shift(mag, 1, 1), _shift(mag, -1, -1)     # 45
    n2a, n2b = _shift(mag, 1, 0), _shift(mag, -1, 0)      # 90
    n3a, n3b = _shift(mag, 1, -1), _shift(mag, -1, 1)     # 135
    na = torch.where(sector == 0, n0a, torch.where(
        sector == 1, n1a, torch.where(sector == 2, n2a, n3a)))
    nb = torch.where(sector == 0, n0b, torch.where(
        sector == 1, n1b, torch.where(sector == 2, n2b, n3b)))
    # Strict on one side (like OpenCV): a 2-px plateau keeps one pixel.
    is_max = (mag > na) & (mag >= nb)

    strong = is_max & (mag >= high)
    weak = is_max & (mag >= low) & (mag < high)
    accepted = strong
    for _ in range(iterations):
        accepted = accepted | (weak & _dilate8(accepted))
    return accepted.to(torch.uint8) * 255
