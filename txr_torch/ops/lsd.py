"""Line segment detection on the device, the counterpart of
``txr/ops/lsd.py``.

The reference rides cv2.createLineSegmentDetector(LSD_REFINE_STD)
(depth_enhanced_reconstruction.py:199-201). LSD proper is a sequential
region grower; ``txr`` re-derives its core idea (group pixels whose
level-line angles agree, fit a rectangle) with fixed-shape array ops, and
this module follows it step for step:

  1. Level-line field: central differences on a lightly blurred image;
     pixels below LSD's magnitude threshold q / sin(tau) are unusable.
  2. Aligned connected components: iterative label propagation (each usable
     pixel takes the least label among its 8 neighbours whose root angle is
     within tau of its own angle), with pointer-jumping rounds
     (label <- label[label]) that double the reach.
  3. Per-component line fit: one stable sort by label, then the segmented
     scan (``ops/scan.py:segmented_cumsum_cols``: the Hopper kernel on the
     card, its plain version on the CPU) over 8 f32 columns gives count,
     root-centred moments and angle coherence per component; a segment max
     gives the x / y extrema.
  4. Validation and fixed capacity: support, coherence, width and density
     gates, then the longest ``capacity`` segments (a tie-stable top-k).

Output matches the cv2 facade: (capacity, 4) [x1, y1, x2, y2] + width +
support + mask. Nothing is read back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from txr_torch.ops.scan import segmented_cumsum_cols
from txr_torch.ops.sift import _blur, _shift2, _top_stable
from txr_torch.ops.voxel import f32_scalar

_INT_MAX = 2 ** 31 - 1
_NEIGH = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
          (1, 1))
_MAX_COMPONENTS = 65536


class LsdLines(NamedTuple):
    lines: torch.Tensor  # (N, 4) float32 x1 y1 x2 y2
    width: torch.Tensor  # (N,) float32 fitted line width (px)
    count: torch.Tensor  # (N,) int32 supporting pixels
    mask: torch.Tensor   # (N,) bool


def _seg_scan_max(vals: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Per-segment max over (N, D), segments starting where ``starts`` (N,)
    is True. Each row gets its whole segment's max, which is the segmented
    running max of ``txr``'s ``_seg_scan_max`` at the segment's last row
    (the only rows the caller reads); a max is exact in any order."""
    seg = torch.cumsum(starts.to(torch.int64), 0) - 1
    idx = seg[:, None].expand_as(vals)
    out = torch.full_like(vals, -math.inf)
    out.scatter_reduce_(0, idx, vals, reduce="amax", include_self=True)
    return out.gather(0, idx)


def _edge_padded(x: torch.Tensor) -> torch.Tensor:
    """(H, W) -> (H + 2, W + 2) with the border rows and columns repeated,
    so that ``_view(p, dy, dx)`` is ``_shift2(x, dy, dx)`` without a copy."""
    x = torch.cat([x[:1], x, x[-1:]], dim=0)
    return torch.cat([x[:, :1], x, x[:, -1:]], dim=1)


def _view(padded: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    h, w = padded.shape[0] - 2, padded.shape[1] - 2
    return padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def _aligned(a: torch.Tensor, b: torch.Tensor, tau: float) -> torch.Tensor:
    d = (a - b).abs()
    return torch.minimum(d, 2 * math.pi - d) < tau


@torch.no_grad()
def _lsd_impl(gray: torch.Tensor, capacity: int, tau: float, mag_thr: float,
              min_count: int, max_width: float, pool_iters: int,
              jump_rounds: int) -> LsdLines:
    H, W = gray.shape
    dev = gray.device
    n = H * W
    img = _blur(gray, 0.8)   # LSD downscales 0.8x with a Gaussian; denoise only

    gx = 0.5 * (_shift2(img, 0, 1) - _shift2(img, 0, -1))
    gy = 0.5 * (_shift2(img, 1, 0) - _shift2(img, -1, 0))
    mag = torch.sqrt(gx * gx + gy * gy)
    # level-line angle: the direction ALONG the line
    ang = torch.atan2(gx, -gy)
    yy = torch.arange(H, device=dev, dtype=torch.int32)[:, None].expand(H, W)
    xx = torch.arange(W, device=dev, dtype=torch.int32)[None, :].expand(H, W)
    interior = (yy >= 1) & (yy < H - 1) & (xx >= 1) & (xx < W - 1)
    usable = (mag > mag_thr) & interior

    # ---------------------------------------------- label propagation
    # Each pixel carries (label, root angle): the raster index of a pixel
    # of its component and that pixel's angle. Adoption needs the
    # candidate ROOT's angle within tau of this pixel's angle, which bounds
    # a component's angular spread to about 2 tau (txr/ops/lsd.py:96-104).
    lab = torch.where(usable, yy * W + xx, _INT_MAX).to(torch.int32)
    root_ang = ang
    # which neighbours may lend their label: usable on both sides
    usable_p = _edge_padded(usable)
    gate = [usable & _view(usable_p, dy, dx) for dy, dx in _NEIGH]

    def pool(lab, root_ang):
        lab_p, ang_p = _edge_padded(lab), _edge_padded(root_ang)
        out_l, out_a = lab, root_ang
        for g, (dy, dx) in zip(gate, _NEIGH):
            nl, nra = _view(lab_p, dy, dx), _view(ang_p, dy, dx)
            better = g & _aligned(ang, nra, tau) & (nl < out_l)
            out_l = torch.where(better, nl, out_l)
            out_a = torch.where(better, nra, out_a)
        return out_l, out_a

    def jump(lab, root_ang):
        idx = lab.reshape(-1).clamp(0, n - 1).to(torch.int64)
        jl = lab.reshape(-1)[idx].reshape(H, W)
        ja = root_ang.reshape(-1)[idx].reshape(H, W)
        better = usable & _aligned(ang, ja, tau) & (jl < lab)
        return torch.where(better, jl, lab), torch.where(better, ja,
                                                         root_ang)

    for _ in range(jump_rounds):
        for _ in range(pool_iters):
            lab, root_ang = pool(lab, root_ang)
        lab, root_ang = jump(lab, root_ang)

    # ------------------------------------- per-component sorted reduction
    key = lab.reshape(-1)
    w = usable.reshape(-1).to(torch.float32)
    # root-centred coordinates: every pixel of a component shares its
    # root's raster index (its sort key), so x - x_root stays within the
    # propagation reach and the second moments within exact-f32 range
    x0 = (key % W).to(torch.float32)
    y0 = torch.div(key, W, rounding_mode="floor").to(torch.float32)
    xf0 = xx.reshape(-1).to(torch.float32)
    yf0 = yy.reshape(-1).to(torch.float32)
    dxr = xf0 - x0
    dyr = yf0 - y0
    dx = dxr * w
    dy = dyr * w
    xf = xf0 * w
    yf = yf0 * w
    angf = ang.reshape(-1)
    valid = w > 0
    payload = torch.stack([
        w,                                       # count
        dx, dy,                                  # centred first moments
        dx * dxr, dy * dyr, dx * dyr,
        torch.cos(2 * angf) * w, torch.sin(2 * angf) * w,
        torch.where(valid, xf, -1.0),            # max x
        torch.where(valid, yf, -1.0),            # max y
        torch.where(valid, -xf, -float(n)),      # -min x
        torch.where(valid, -yf, -float(n)),      # -min y
    ])                                           # (12, n)
    # txr sorts the key with its 12 payload columns in one variadic sort
    # (which keeps the input order on the CPU); here one stable sort of the
    # key and a gather of the payload rows
    skey, order = torch.sort(key, stable=True)
    spay = payload.index_select(1, order)        # (12, n), rows contiguous
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    starts[1:] = skey[1:] != skey[:-1]
    last = torch.ones(n, dtype=torch.bool, device=dev)
    last[:-1] = starts[1:]
    # segment sums from the segmented scan, which restarts at every
    # component (a global cumulative sum's round-off would swamp small
    # components' sums)
    seg = segmented_cumsum_cols(tuple(spay[i] for i in range(8)), starts)
    csum = torch.stack(seg, dim=1)
    cmax = _seg_scan_max(spay[8:].t(), starts)

    # compact the ends of the components that could pass the support gate
    # to the front, in key order (txr sorts (order, index) on two keys: the
    # same permutation as a stable sort of the "does not qualify" flag)
    run_count = seg[0]
    qualifies = last & (skey != _INT_MAX) & (run_count >= min_count)
    n_keep = min(n, _MAX_COMPONENTS)
    perm_c = torch.sort((~qualifies).to(torch.uint8), stable=True)[1][:n_keep]
    is_seg = qualifies[perm_c]

    sums = torch.where(is_seg[:, None], csum[perm_c], 0.0)
    mx = cmax[perm_c]
    kc = skey[perm_c]
    kx0 = (kc % W).to(torch.float32)
    ky0 = torch.div(kc, W, rounding_mode="floor").to(torch.float32)

    cnt = sums[:, 0]
    safe = torch.clamp(cnt, min=1.0)
    edx = sums[:, 1] / safe
    edy = sums[:, 2] / safe
    cx = kx0 + edx
    cy = ky0 + edy
    vxx = sums[:, 3] / safe - edx * edx
    vyy = sums[:, 4] / safe - edy * edy
    vxy = sums[:, 5] / safe - edx * edy
    coher = torch.sqrt(sums[:, 6] ** 2 + sums[:, 7] ** 2) / safe

    # principal axis of the 2x2 covariance (closed form)
    tr = vxx + vyy
    dd = torch.sqrt(torch.clamp((vxx - vyy) ** 2 + 4 * vxy * vxy, min=0.0))
    l2 = torch.clamp(0.5 * (tr - dd), min=0.0)
    theta = 0.5 * torch.atan2(2 * vxy, vxx - vyy)
    dirx = torch.cos(theta)
    diry = torch.sin(theta)
    width = torch.sqrt(12.0 * l2)      # uniform-across-width model

    xmax, ymax = mx[:, 0], mx[:, 1]
    xmin, ymin = -mx[:, 2], -mx[:, 3]

    # endpoints: the extreme coordinate along the dominant axis, the other
    # coordinate from the fitted direction (exact for thin lines)
    horiz = dirx.abs() >= diry.abs()
    slope_yx = diry / torch.where(dirx.abs() < 1e-6, 1e-6, dirx)
    slope_xy = dirx / torch.where(diry.abs() < 1e-6, 1e-6, diry)
    y1h = cy + slope_yx * (xmin - cx)
    y2h = cy + slope_yx * (xmax - cx)
    x1v = cx + slope_xy * (ymin - cy)
    x2v = cx + slope_xy * (ymax - cy)
    x1 = torch.where(horiz, xmin, x1v)
    y1 = torch.where(horiz, y1h, ymin)
    x2 = torch.where(horiz, xmax, x2v)
    y2 = torch.where(horiz, y2h, ymax)
    length = torch.hypot(x2 - x1, y2 - y1)

    good = (is_seg & (cnt >= min_count) & (coher > 0.5)
            & (width <= max_width) & (length >= min_count * 0.5)
            # density: support per unit rectangle area (LSD's D gate)
            & (cnt >= 0.5 * length * torch.clamp(width, min=1.0)))

    score = torch.where(good, length, -1.0)
    top, pick = _top_stable(score, capacity)
    lines = torch.stack([x1[pick], y1[pick], x2[pick], y2[pick]], dim=-1)
    return LsdLines(lines, width[pick], cnt[pick].to(torch.int32), top > 0.0)


def lsd_lines(gray, capacity: int = 512, tau_deg: float = 22.5,
              quant: float = 2.0, min_count: int = 20,
              max_width: float = 6.0, pool_iters: int = 6,
              jump_rounds: int = 6) -> LsdLines:
    """Line segments of a (H, W) image, on the image's device.

    ``gray`` is a uint8 or float [0, 1] tensor. tau_deg / quant mirror LSD's
    angle tolerance and gradient quantisation bound (magnitude threshold
    quant / sin(tau)). Propagation reach is about pool_iters * 2^jump_rounds
    px. Returns fixed-capacity (capacity, 4) [x1 y1 x2 y2] + width +
    support + mask.
    """
    if gray.dtype == torch.uint8:
        # a true division on every device (see ops/voxel.py:f32_scalar)
        gray = gray.to(torch.float32) / f32_scalar(255.0, gray)
    else:
        gray = gray.to(torch.float32)
    tau = math.radians(tau_deg)
    mag_thr = (quant / 255.0) / math.sin(tau)
    return _lsd_impl(gray, capacity, tau, mag_thr, int(min_count),
                     float(max_width), pool_iters, jump_rounds)
