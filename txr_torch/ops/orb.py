"""ORB keypoint detection + description on the device, the counterpart of
``txr/ops/orb.py``.

The reference rides cv2.ORB_create(nfeatures=2000, nlevels=8)
(depth_enhanced_reconstruction.py:197-199). ``txr``'s re-derivation with
fixed shapes, step for step:

  1. Image pyramid, scale 1.2, each level a bilinear resize of the frame
     (``ops/resize.py:resize_bilinear``).
  2. FAST-9 on a 16-pixel ring of shifted images: a corner needs 9
     contiguous ring pixels all brighter / all darker than the centre +- t.
     The ring's runs are found on a 16-bit mask per pixel (three rotations
     and ANDs), the same test as ``txr``'s 16 x 8 ANDs.
  3. Harris ranking (Sobel products box-filtered 7x7), 3x3 NMS, a per-level
     top-k, then a global top-k (fixed capacity; tie-stable, as
     ``jax.lax.top_k``, since the -1 fillers tie).
  4. Orientation: intensity centroid over the 31x31 disk, gathered per
     keypoint from one flat buffer of the pyramid.
  5. Steered binary descriptor: 256 seeded Gaussian point pairs rotated by
     the keypoint angle, compared on a sigma-2 blurred pyramid, packed to
     32 uint8, most significant bit first (``ops/matching.py:unpack_bits``).

The ring's offsets go through ``txr``'s shift, which moves by at most one
pixel: ``txr/ops/sift.py:_shift2`` slices an edge-padded image at 1 + d,
and ``jax.lax.dynamic_slice`` wraps a negative start and clamps it into
range, so an offset of 2 or 3 moves by +1 and one of -2 or -3 also by +1.
``_txr_shift`` reproduces that, so that the corners are ``txr``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from txr_torch.ops.resize import resize_bilinear
from txr_torch.ops.sift import _blur, _shift2, _top_stable
from txr_torch.ops.voxel import f32_scalar


class OrbFeatures(NamedTuple):
    uv: torch.Tensor        # (N, 2) float32 x, y original-image pixels
    size: torch.Tensor      # (N,) float32 patch diameter at level scale
    angle: torch.Tensor     # (N,) float32 degrees [0, 360)
    response: torch.Tensor  # (N,) float32 Harris response
    desc: torch.Tensor      # (N, 32) uint8 packed 256-bit descriptor
    mask: torch.Tensor      # (N,) bool


# 16-point Bresenham circle of radius 3, clockwise from 12 o'clock, (dy, dx).
_CIRCLE = [(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
           (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
           (-3, -1)]

_PATCH = 31          # orientation / descriptor patch diameter
_HALF = _PATCH // 2  # 15
# rotated BRIEF taps reach _HALF * sqrt(2) from the keypoint, plus the blur
_BORDER = int(math.ceil(_HALF * math.sqrt(2.0))) + 4


def _brief_pattern(n_bits: int = 256, seed: int = 7) -> np.ndarray:
    """(n_bits, 4) int32 point pairs (y1, x1, y2, x2), BRIEF G-II sampling:
    coordinates ~ N(0, (patch/5)^2), clipped to the 31x31 patch."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, _PATCH / 5.0, size=(n_bits, 4))
    return np.clip(np.round(pts), -_HALF, _HALF).astype(np.int32)


def _txr_shift(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """``txr/ops/sift.py:_shift2`` for any offset: within [-1, 1] the
    edge-clamped shift, beyond it a shift of +1 (see the module notes)."""
    def eff(d):
        return d if -1 <= d <= 1 else 1
    return _shift2(x, eff(dy), eff(dx))


def _box7(x: torch.Tensor) -> torch.Tensor:
    """7x7 box filter, separable, edge-padded."""
    k = torch.full((7,), 1.0 / 7.0, dtype=torch.float32, device=x.device)
    y = F.pad(x[None, None], (0, 0, 3, 3), mode="replicate")
    y = F.conv2d(y, k.view(1, 1, 7, 1))
    y = F.pad(y, (3, 3, 0, 0), mode="replicate")
    return F.conv2d(y, k.view(1, 1, 1, 7))[0, 0]


def _sobel(x: torch.Tensor):
    gx = (_shift2(x, 0, 1) - _shift2(x, 0, -1)) * 2.0 \
        + (_shift2(x, -1, 1) - _shift2(x, -1, -1)) \
        + (_shift2(x, 1, 1) - _shift2(x, 1, -1))
    gy = (_shift2(x, 1, 0) - _shift2(x, -1, 0)) * 2.0 \
        + (_shift2(x, 1, -1) - _shift2(x, -1, -1)) \
        + (_shift2(x, 1, 1) - _shift2(x, -1, 1))
    return gx, gy


def _rotr16(m: torch.Tensor, k: int) -> torch.Tensor:
    return ((m >> k) | (m << (16 - k))) & 0xFFFF


def _has_arc9(m: torch.Tensor) -> torch.Tensor:
    """Whether a 16-bit ring mask (bit k: ring pixel k passes) holds 9
    circularly contiguous set bits."""
    r2 = m & _rotr16(m, 1)           # bit k: pixels k, k+1
    r4 = r2 & _rotr16(r2, 2)         # k .. k+3
    r8 = r4 & _rotr16(r4, 4)         # k .. k+7
    return (r8 & _rotr16(m, 8)) != 0  # k .. k+8


def _detect_level(img: torch.Tensor, k_cand: int, fast_thr: float,
                  border: int):
    """FAST-9/16 corners on one pyramid level, Harris-ranked.

    Returns (y, x, response, valid), each (k_cand,) (int64 coordinates)."""
    H, W = img.shape
    bright = torch.zeros((H, W), dtype=torch.int32, device=img.device)
    dark = torch.zeros_like(bright)
    hi, lo = img + fast_thr, img - fast_thr
    for k, (dy, dx) in enumerate(_CIRCLE):
        ring = _txr_shift(img, dy, dx)
        bright |= (ring > hi).to(torch.int32) << k
        dark |= (ring < lo).to(torch.int32) << k
    corner = _has_arc9(bright) | _has_arc9(dark)

    gx, gy = _sobel(img)
    sxx = _box7(gx * gx)
    syy = _box7(gy * gy)
    sxy = _box7(gx * gy)
    harris = (sxx * syy - sxy * sxy) - 0.04 * (sxx + syy) ** 2

    score = torch.where(corner, harris, -math.inf)
    nmax = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nmax = torch.maximum(nmax, _shift2(score, dy, dx))
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    keep = corner & (score >= nmax) & (harris > 0) \
        & (yy >= border) & (yy < H - border) & (xx >= border) \
        & (xx < W - border)
    flat = torch.where(keep, harris, -1.0).reshape(-1)
    top, idx = _top_stable(flat, min(k_cand, flat.shape[0]))
    return idx // W, idx % W, top, top > 0.0


def _pad_to(a: torch.Tensor, n: int, value) -> torch.Tensor:
    if a.shape[0] >= n:
        return a
    return torch.cat([a, a.new_full((n - a.shape[0],), value)])


@torch.no_grad()
def _orb_impl(gray: torch.Tensor, capacity: int, n_levels: int,
              scale_factor: float, fast_thr: float) -> OrbFeatures:
    H, W = gray.shape
    dev = gray.device
    border = _BORDER

    # ------------------------------------------------------------- pyramid
    levels = [gray]
    for lv in range(1, n_levels):
        s = scale_factor ** lv
        h = max(int(round(H / s)), 2 * border + 8)
        w = max(int(round(W / s)), 2 * border + 8)
        levels.append(resize_bilinear(gray[..., None], h, w)[..., 0])

    # ------------------------------------------------- per-level detection
    cands = []
    for lv, img in enumerate(levels):
        y, x, resp, ok = _detect_level(img, capacity, fast_thr, border)
        cands.append((torch.full((capacity,), lv, dtype=torch.int64,
                                 device=dev),
                      _pad_to(y, capacity, 0), _pad_to(x, capacity, 0),
                      _pad_to(resp, capacity, -1.0),
                      _pad_to(ok, capacity, False)))
    lvl, cy, cx, resp, ok = (torch.cat(c) for c in zip(*cands))

    top, pick = _top_stable(torch.where(ok, resp, -1.0), capacity)
    lvl, cy, cx = lvl[pick], cy[pick], cx[pick]
    resp = top
    mask = top > 0.0

    # -------------------------------------- flat pyramid buffers (raw+blur)
    offs, hs, ws, total = [], [], [], 0
    for img in levels:
        h, w = img.shape
        offs.append(total)
        hs.append(h)
        ws.append(w)
        total += h * w
    flat_raw = torch.cat([img.reshape(-1) for img in levels])
    flat_blur = torch.cat([_blur(img, 2.0).reshape(-1) for img in levels])

    def table(v):
        return torch.tensor(v, dtype=torch.int64, device=dev)[lvl]

    base, hh, ww = table(offs), table(hs), table(ws)

    def gather(flat, dy, dx):
        # (N, P) integer-offset gather with border clamp
        yi = torch.minimum(torch.clamp(cy[:, None] + dy, min=0),
                           hh[:, None] - 1)
        xi = torch.minimum(torch.clamp(cx[:, None] + dx, min=0),
                           ww[:, None] - 1)
        return flat[base[:, None] + yi * ww[:, None] + xi]

    # ------------------------------------ orientation: intensity centroid
    r = np.arange(-_HALF, _HALF + 1)
    py, px = np.meshgrid(r, r, indexing="ij")
    disk = (py * py + px * px) <= _HALF * _HALF
    py = torch.from_numpy(py[disk].astype(np.int64)).to(dev)
    px = torch.from_numpy(px[disk].astype(np.int64)).to(dev)
    patch = gather(flat_raw, py[None, :], px[None, :])          # (N, P)
    m10 = (patch * px.to(torch.float32)[None, :]).sum(1)
    m01 = (patch * py.to(torch.float32)[None, :]).sum(1)
    theta = torch.atan2(m01, m10)

    # ----------------------------------------------- steered 256-bit BRIEF
    pat = torch.from_numpy(_brief_pattern()).to(dev)   # (256, 4) y1 x1 y2 x2
    p1 = pat[:, :2].to(torch.float32)
    p2 = pat[:, 2:].to(torch.float32)
    ct = torch.cos(theta)[:, None]
    st = torch.sin(theta)[:, None]

    def rot(p):
        ry = torch.round(p[None, :, 0] * ct + p[None, :, 1] * st)
        rx = torch.round(-p[None, :, 0] * st + p[None, :, 1] * ct)
        return ry.to(torch.int64), rx.to(torch.int64)

    bits = gather(flat_blur, *rot(p1)) < gather(flat_blur, *rot(p2))
    weights = (1 << torch.arange(7, -1, -1, device=dev)).to(torch.int32)
    desc = (bits.view(-1, 32, 8).to(torch.int32) * weights).sum(-1) \
        .to(torch.uint8)                                # (N, 32) big-endian

    # ------------------------------------------------------------- outputs
    scale_mult = torch.pow(f32_scalar(scale_factor, gray),
                           lvl.to(torch.float32))
    uv = torch.stack([cx.to(torch.float32) * scale_mult,
                      cy.to(torch.float32) * scale_mult], dim=-1)
    size = float(_PATCH) * scale_mult
    # cv2 ORB convention: angle = atan2(m01, m10) in degrees, y down
    angle = torch.remainder(torch.rad2deg(theta), 360.0)
    return OrbFeatures(uv, size, angle, resp, desc, mask)


def orb_features(gray: torch.Tensor, capacity: int = 2048, n_levels: int = 8,
                 scale_factor: float = 1.2,
                 fast_threshold: int = 20) -> OrbFeatures:
    """Detect + describe ORB features of a (H, W) image on its device.

    ``gray`` is a uint8 or float [0, 1] tensor. fast_threshold is in 0..255
    units (cv2.ORB's default 20). Levels that would be smaller than the
    detection border are dropped. Returns fixed-capacity masked tensors;
    descriptors are (N, 32) packed uint8 for ``ops/matching.py``'s Hamming
    matching.
    """
    if gray.dtype == torch.uint8:
        gray = gray.to(torch.float32) / f32_scalar(255.0, gray)
    else:
        gray = gray.to(torch.float32)
    n_levels = max(1, min(n_levels, int(
        math.log(max(min(gray.shape) / (2.0 * _BORDER + 8), 1.001))
        / math.log(scale_factor)) + 1))
    return _orb_impl(gray, capacity, n_levels, float(scale_factor),
                     float(fast_threshold) / 255.0)
