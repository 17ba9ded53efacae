"""SIFT keypoint detection + description on the device, the counterpart of
``txr/ops/sift.py``.

The reference rides OpenCV's C++ SIFT (depth_to_reconstruction.py:133-153).
This module runs ``txr``'s re-derivation with fixed shapes throughout:

  1. Gaussian scale-space pyramid: separable ``F.conv2d`` blurs, every level
     of an octave straight from the octave base (sigma0 * 2^(i/S)).
  2. DoG extrema: 26-neighbour max / min tests as shifted-array comparisons,
     contrast + Hessian edge rejection, all elementwise.
  3. Fixed-capacity selection: the strongest candidates of each octave, then
     the strongest across octaves. Equal responses keep index order, as
     ``jax.lax.top_k`` keeps them (a stable sort; ``torch.topk`` promises no
     order for ties).
  4. Subpixel refinement: batched 3x3 quadratic fits (adjugate inverse) on
     gathered 27-neighbourhoods.
  5. Orientation + descriptor: bilinear gathers of gradient patches from one
     flat buffer of every octave's levels, a 36-bin orientation histogram
     and the standard 4x4x8 trilinearly weighted descriptor as batched
     products.

Conventions differ from OpenCV as ``txr``'s do: no initial 2x upsampling and
one dominant orientation per keypoint.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from txr_torch.core.device import device_constant

# Orientation / descriptor sample-grid side (J x J samples per keypoint).
# TXR_SIFT_GRID overrides it, read at import as in ``txr``.
_SAMPLE_GRID = int(os.environ.get("TXR_SIFT_GRID", "12"))


class SiftFeatures(NamedTuple):
    """Fixed-capacity SIFT output (all tensors sized to `capacity`)."""

    uv: torch.Tensor        # (N, 2) float32 x, y in original image pixels
    size: torch.Tensor      # (N,) float32 keypoint diameter (OpenCV kp.size)
    angle: torch.Tensor     # (N,) float32 orientation in degrees [0, 360)
    response: torch.Tensor  # (N,) float32 |DoG| response
    desc: torch.Tensor      # (N, 128) float32 descriptor (0..255 scaled)
    mask: torch.Tensor      # (N,) bool validity


def _gauss_kernel(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable Gaussian blur of (H, W) with reflect-101 borders
    (cv2.GaussianBlur)."""
    if sigma <= 0:
        return img
    k = device_constant(_gauss_kernel(sigma), img.device)
    r = (k.shape[0] - 1) // 2
    x = F.pad(img[None, None], (0, 0, r, r), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, -1, 1))
    x = F.pad(x, (r, r, 0, 0), mode="reflect")
    return F.conv2d(x, k.view(1, 1, 1, -1))[0, 0]


def _blur_multi(img: torch.Tensor, sigmas) -> torch.Tensor:
    """All pyramid levels of one octave in two separable conv passes.

    Gaussians compose (G(a)*G(b) = G(sqrt(a^2+b^2))), so every level comes
    straight from the octave base: one vertical conv with L output channels
    (one kernel per level) and one horizontal depthwise conv.

    img: (H, W) octave base. sigmas: per-level blur RELATIVE to the base
    (0: identity). Returns (L, H, W)."""
    L = len(sigmas)
    rs = [max(1, int(math.ceil(3.0 * s))) if s > 0 else 0 for s in sigmas]
    r = max(rs)
    K = np.zeros((L, 2 * r + 1), np.float32)
    for i, s in enumerate(sigmas):
        if s <= 0:
            K[i, r] = 1.0
        else:
            k = _gauss_kernel(s)
            ri = (k.shape[0] - 1) // 2
            K[i, r - ri:r + ri + 1] = k
    Kt = device_constant(K, img.device)
    x = F.pad(img[None, None], (0, 0, r, r), mode="reflect")
    v = F.conv2d(x, Kt.view(L, 1, -1, 1))                 # (1, L, H, W)
    v = F.pad(v, (r, r, 0, 0), mode="reflect")
    h = F.conv2d(v, Kt.view(L, 1, 1, -1), groups=L)       # depthwise
    return h[0]


def _shift2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """x shifted by (dy, dx) over its last two axes, edge-clamped:
    out[..., y, x] = x[..., clamp(y + dy), clamp(x + dx)]."""
    if dy == 1:
        x = torch.cat([x[..., 1:, :], x[..., -1:, :]], dim=-2)
    elif dy == -1:
        x = torch.cat([x[..., :1, :], x[..., :-1, :]], dim=-2)
    if dx == 1:
        x = torch.cat([x[..., :, 1:], x[..., :, -1:]], dim=-1)
    elif dx == -1:
        x = torch.cat([x[..., :, :1], x[..., :, :-1]], dim=-1)
    return x


def _neighborhood_max_min(dog: torch.Tensor):
    """Per-pixel max / min over the 3x3 window of each DoG level (windows
    clipped at the border). dog: (L, H, W)."""
    mx = F.max_pool2d(dog[None], 3, stride=1, padding=1)[0]
    mn = -F.max_pool2d(-dog[None], 3, stride=1, padding=1)[0]
    return mx, mn


def _shift_others(mid: torch.Tensor, reduce) -> torch.Tensor:
    """Max (or min) over the 8 spatial neighbours at the same level."""
    out = None
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                s = _shift2(mid, dy, dx)
                out = s if out is None else reduce(out, s)
    return out


def _top_stable(score: torch.Tensor, k: int):
    """The k largest entries of a 1-D tensor, largest first, equal values
    in index order (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(score, descending=True, stable=True)
    return vals[:k], idx[:k]


def _detect_octave(dog: torch.Tensor, k_cand: int, contrast_thr: float,
                   edge_thr: float, n_scales: int):
    """Extrema of one octave's DoG stack (L=S+2, H, W).

    Returns fixed-size candidate tensors of length k_cand:
    (s_idx, y, x, s, response, valid).
    """
    L, H, W = dog.shape
    mx, mn = _neighborhood_max_min(dog)

    mid = dog[1:-1]  # levels 1..S
    nb_max = torch.maximum(torch.maximum(mx[:-2], mx[2:]),
                           _shift_others(mid, torch.maximum))
    nb_min = torch.minimum(torch.minimum(mn[:-2], mn[2:]),
                           _shift_others(mid, torch.minimum))
    prelim = 0.5 * contrast_thr / n_scales
    is_max = (mid > nb_max) & (mid > prelim)
    is_min = (mid < nb_min) & (mid < -prelim)
    extremum = is_max | is_min

    # Exclude a border margin (refinement + edge test need the 3x3x3 block).
    b = 5
    ys = torch.arange(H, device=dog.device)
    xs = torch.arange(W, device=dog.device)
    interior = (((ys >= b) & (ys < H - b))[:, None]
                & ((xs >= b) & (xs < W - b))[None, :])
    extremum = extremum & interior

    score = torch.where(extremum, mid.abs(), -1.0)
    flat = score.reshape(-1)
    k = min(k_cand, flat.shape[0])
    top, idx = _top_stable(flat, k)
    valid = top > 0.0

    s_idx = idx // (H * W) + 1          # level within the gaussian stack
    rem = idx % (H * W)
    y = rem // W
    x = rem % W

    # --- subpixel refinement: quadratic fit on the 27-neighbourhood -------
    dflat = dog.reshape(-1)
    n_flat = dflat.shape[0]

    def at(ds, dy, dx):
        i = ((s_idx + ds) * H + (y + dy)) * W + (x + dx)
        return dflat[i.clamp(0, n_flat - 1)]

    c = at(0, 0, 0)
    dx1 = 0.5 * (at(0, 0, 1) - at(0, 0, -1))
    dy1 = 0.5 * (at(0, 1, 0) - at(0, -1, 0))
    ds1 = 0.5 * (at(1, 0, 0) - at(-1, 0, 0))
    dxx = at(0, 0, 1) + at(0, 0, -1) - 2 * c
    dyy = at(0, 1, 0) + at(0, -1, 0) - 2 * c
    dss = at(1, 0, 0) + at(-1, 0, 0) - 2 * c
    dxy = 0.25 * (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1))
    dxs = 0.25 * (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1))
    dys = 0.25 * (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0))

    # Solve H_3x3 * off = -g via the adjugate (batched, branch-free).
    a11, a22, a33 = dxx, dyy, dss
    a12, a13, a23 = dxy, dxs, dys
    det = (a11 * (a22 * a33 - a23 * a23)
           - a12 * (a12 * a33 - a23 * a13)
           + a13 * (a12 * a23 - a22 * a13))
    safe = torch.where(det.abs() > 1e-12, det, 1.0)
    c11 = a22 * a33 - a23 * a23
    c12 = a13 * a23 - a12 * a33
    c13 = a12 * a23 - a13 * a22
    c22 = a11 * a33 - a13 * a13
    c23 = a12 * a13 - a11 * a23
    c33 = a11 * a22 - a12 * a12
    gx, gy, gs = dx1, dy1, ds1
    off_x = -(c11 * gx + c12 * gy + c13 * gs) / safe
    off_y = -(c12 * gx + c22 * gy + c23 * gs) / safe
    off_s = -(c13 * gx + c23 * gy + c33 * gs) / safe
    off_ok = ((off_x.abs() < 0.8) & (off_y.abs() < 0.8)
              & (off_s.abs() < 0.8) & (det.abs() > 1e-12))
    off_x = torch.clamp(off_x, -0.5, 0.5)
    off_y = torch.clamp(off_y, -0.5, 0.5)
    off_s = torch.clamp(off_s, -0.5, 0.5)

    contrast = c + 0.5 * (gx * off_x + gy * off_y + gs * off_s)
    contrast_ok = contrast.abs() * n_scales >= contrast_thr

    # Edge response on the 2D spatial Hessian (Lowe r-test).
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    r = edge_thr
    edge_ok = (det2 > 0) & (tr * tr * r < (r + 1) * (r + 1) * det2)

    valid = valid & off_ok & contrast_ok & edge_ok
    return (s_idx, y.to(torch.float32) + off_y, x.to(torch.float32) + off_x,
            s_idx.to(torch.float32) + off_s, contrast.abs(), valid)


def _bilinear_pair(flat_grad8: torch.Tensor, base: torch.Tensor,
                   hh: torch.Tensor, ww: torch.Tensor,
                   ys: torch.Tensor, xs: torch.Tensor):
    """Sample (dx, dy) pairs bilinearly from the packed flat pyramid buffer.

    flat_grad8: (T, 8), each pixel's row its 2x2 bilinear footprint
    [g(y,x), g(y,x+1), g(y+1,x), g(y+1,x+1)] (edge-clamped), so one row
    gather serves a sample. base: (N,) flat offset of each keypoint's
    level; hh / ww: (N,) level dims. ys / xs: (N, P) sample coords in level
    pixels. Returns ((N, P, 2), in-bounds (N, P))."""
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    fy = (ys - y0)[..., None]
    fx = (xs - x0)[..., None]
    hf = hh[:, None].to(torch.float32)
    wf = ww[:, None].to(torch.float32)
    inb = (xs >= 0) & (xs <= wf - 1.001) & (ys >= 0) & (ys <= hf - 1.001)
    yi = torch.minimum(torch.clamp(y0.to(torch.int64), min=0), hh[:, None] - 1)
    xi = torch.minimum(torch.clamp(x0.to(torch.int64), min=0), ww[:, None] - 1)
    i = base[:, None] + yi * ww[:, None] + xi
    rows = flat_grad8[i.clamp(0, flat_grad8.shape[0] - 1)]  # (N, P, 8)
    v = ((1 - fy) * (1 - fx) * rows[..., 0:2]
         + (1 - fy) * fx * rows[..., 2:4]
         + fy * (1 - fx) * rows[..., 4:6]
         + fy * fx * rows[..., 6:8])
    return v, inb


def _smooth_hist_circular(h: torch.Tensor) -> torch.Tensor:
    """OpenCV's [1,4,6,4,1]/16 circular smoothing of the 36-bin histogram."""
    out = (6 * h
           + 4 * (torch.roll(h, 1, -1) + torch.roll(h, -1, -1))
           + 1 * (torch.roll(h, 2, -1) + torch.roll(h, -2, -1)))
    return out / 16.0


def _sift_impl(gray: torch.Tensor, capacity: int, n_octaves: int,
               n_scales: int, sigma0: float, contrast_thr: float,
               edge_thr: float, n_active: int) -> SiftFeatures:
    H, W = gray.shape
    S = n_scales
    dev = gray.device

    # ------------------------------------------------------------- pyramid
    sig = [sigma0 * (2.0 ** (i / S)) for i in range(S + 3)]
    base = _blur(gray, math.sqrt(max(sigma0 ** 2 - 0.25, 0.01)))
    rel = [0.0] + [math.sqrt(max(sig[i] ** 2 - sig[0] ** 2, 1e-6))
                   for i in range(1, S + 3)]
    octaves = []  # (S+3, Ho, Wo) each
    img = base
    for _ in range(n_octaves):
        g = _blur_multi(img, rel)
        octaves.append(g)
        img = g[S, ::2, ::2]  # the next octave seeds from the 2x-sigma level

    # ---------------------------------------------------- per-octave extrema
    cols = [[] for _ in range(7)]
    for o, g in enumerate(octaves):
        dog = g[1:] - g[:-1]
        k_cand = min(capacity, dog[1:-1].numel())
        s_i, yf, xf, sf, resp, ok = _detect_octave(
            dog, k_cand, contrast_thr, edge_thr, S)
        pad = capacity - k_cand
        if pad > 0:
            s_i, yf, xf, resp = (F.pad(a, (0, pad))
                                 for a in (s_i, yf, xf, resp))
            sf = F.pad(sf, (0, pad), value=1.0)
            ok = F.pad(ok, (0, pad))
        parts = (torch.full((capacity,), o, dtype=torch.int64, device=dev),
                 s_i, yf, xf, sf, resp, ok)
        for col, part in zip(cols, parts):
            col.append(part)
    oct_i, s_i, yf, xf, sf, resp, ok = (torch.cat(c) for c in cols)

    # The strongest n_active candidates (response-sorted, a prefix) go on;
    # the per-keypoint passes below run on those rows only, and the outputs
    # are padded back to `capacity` rows with mask False.
    top, pick = _top_stable(torch.where(ok, resp, -1.0), n_active)
    oct_i, s_i, yf, xf, sf, resp = (a[pick] for a in
                                    (oct_i, s_i, yf, xf, sf, resp))
    mask = top > 0.0

    # ------------------------------------------- flat gradient pyramid buffer
    # Every octave's per-level (dx, dy) images in one flat buffer, each
    # pixel's row pre-packing its 2x2 bilinear footprint (8 floats), so one
    # row gather serves a sample from any octave / level.
    grads = []
    level_offset = np.zeros((n_octaves, S + 3), np.int64)
    level_h = np.zeros((n_octaves,), np.int64)
    level_w = np.zeros((n_octaves,), np.int64)
    total = 0
    for o, g in enumerate(octaves):
        ho, wo = g.shape[1:]
        gx = 0.5 * (_shift2(g, 0, 1) - _shift2(g, 0, -1))
        gy = 0.5 * (_shift2(g, 1, 0) - _shift2(g, -1, 0))
        gxy = torch.stack([gx, gy], dim=1)                  # (L, 2, H, W)
        packed = torch.cat([gxy, _shift2(gxy, 0, 1), _shift2(gxy, 1, 0),
                            _shift2(gxy, 1, 1)], dim=1)     # (L, 8, H, W)
        grads.append(packed.permute(0, 2, 3, 1).reshape(-1, 8))
        for i in range(S + 3):
            level_offset[o, i] = total + i * ho * wo
        level_h[o] = ho
        level_w[o] = wo
        total += (S + 3) * ho * wo
    flat_grad = torch.cat(grads, dim=0)
    del grads
    off_tab = device_constant(level_offset.reshape(-1), dev)
    h_tab = device_constant(level_h, dev)
    w_tab = device_constant(level_w, dev)

    base_idx = off_tab[(oct_i * (S + 3) + s_i).clamp(0, off_tab.numel() - 1)]
    hh = h_tab[oct_i.clamp(0, n_octaves - 1)]
    ww = w_tab[oct_i.clamp(0, n_octaves - 1)]

    sigma_rel = sigma0 * (2.0 ** (sf / S))  # scale in octave pixels

    # -------------------------------------------------- orientation histogram
    J = _SAMPLE_GRID
    lin = (torch.arange(J, dtype=torch.float32, device=dev) + 0.5) / J \
        * 2.0 - 1.0
    gv, gu = torch.meshgrid(lin, lin, indexing="ij")  # (J, J) unit offsets
    gu = gu.reshape(-1)
    gv = gv.reshape(-1)  # (P,)
    r_ori = 3.0 * 1.5 * sigma_rel  # OpenCV SIFT_ORI_RADIUS
    ys = yf[:, None] + gv[None, :] * r_ori[:, None]
    xs = xf[:, None] + gu[None, :] * r_ori[:, None]
    g, inb = _bilinear_pair(flat_grad, base_idx, hh, ww, ys, xs)
    mag = torch.sqrt(g[..., 0] ** 2 + g[..., 1] ** 2)
    ang = torch.atan2(g[..., 1], g[..., 0])  # (-pi, pi]
    rr2 = gu[None, :] ** 2 + gv[None, :] ** 2
    wgt = torch.exp(-rr2 * r_ori[:, None] ** 2
                    / (2.0 * (1.5 * sigma_rel[:, None]) ** 2))
    wgt = torch.where((rr2 <= 1.0) & inb, wgt, 0.0)

    NB = 36
    b = (ang + math.pi) / (2 * math.pi) * NB  # [0, 36]
    contrib = wgt * mag
    bins = torch.arange(NB, dtype=torch.float32, device=dev)
    dwrap = (b[..., None] - bins).abs()
    dwrap = torch.minimum(dwrap, NB - dwrap)
    Bw = torch.clamp(1.0 - dwrap, 0.0, 1.0)  # (N, P, 36) circular weights
    hist = torch.bmm(contrib[:, None, :], Bw)[:, 0]
    del Bw
    hist = _smooth_hist_circular(_smooth_hist_circular(hist))
    pk = torch.argmax(hist, dim=-1)
    hl = torch.gather(hist, 1, ((pk - 1) % NB)[:, None])[:, 0]
    hc = torch.gather(hist, 1, pk[:, None])[:, 0]
    hr = torch.gather(hist, 1, ((pk + 1) % NB)[:, None])[:, 0]
    denom = hl - 2 * hc + hr
    frac = torch.where(denom.abs() > 1e-12, 0.5 * (hl - hr) / denom, 0.0)
    # Bin k's tent weight peaks at b == k, so the interpolated peak angle is
    # (pk + frac), with no half-bin shift.
    theta = (pk.to(torch.float32) + torch.clamp(frac, -0.5, 0.5)) \
        / NB * 2 * math.pi - math.pi  # radians, gradient frame

    # --------------------------------------------------------- descriptor
    D = 4   # spatial bins per side
    NO = 8  # orientation bins
    JD = _SAMPLE_GRID
    lin_d = (torch.arange(JD, dtype=torch.float32, device=dev) + 0.5) / JD \
        * D - D / 2  # cell units
    dv, du = torch.meshgrid(lin_d, lin_d, indexing="ij")
    du = du.reshape(-1)
    dv = dv.reshape(-1)  # (PD,) in (-2, 2)
    hist_w = 3.0 * sigma_rel  # pixels per descriptor cell
    ct = torch.cos(theta)
    st = torch.sin(theta)
    # rotate sample offsets into the image frame
    ox = (du[None, :] * ct[:, None] - dv[None, :] * st[:, None]) \
        * hist_w[:, None]
    oy = (du[None, :] * st[:, None] + dv[None, :] * ct[:, None]) \
        * hist_w[:, None]
    ys = yf[:, None] + oy
    xs = xf[:, None] + ox
    g, inb = _bilinear_pair(flat_grad, base_idx, hh, ww, ys, xs)
    del flat_grad
    mag = torch.sqrt(g[..., 0] ** 2 + g[..., 1] ** 2)
    ang = torch.atan2(g[..., 1], g[..., 0]) - theta[:, None]  # kp frame
    wgt = torch.exp(-(du[None, :] ** 2 + dv[None, :] ** 2)
                    / (2 * (0.5 * D) ** 2))
    contrib = torch.where(inb, mag * wgt, 0.0)

    # trilinear bin weights via per-axis two-tap weights (no scatter)
    rbin = dv[None, :] + D / 2 - 0.5  # [-0.5, 3.5]
    cbin = du[None, :] + D / 2 - 0.5
    obin = torch.remainder(ang, 2 * math.pi) / (2 * math.pi) * NO  # [0, 8)
    cells = torch.arange(D, dtype=torch.float32, device=dev)

    def axis_w(v):
        # (N, P, D): linear weight of sample v onto integer bins 0..D-1
        return torch.clamp(1.0 - (v[..., None] - cells).abs(), 0.0, 1.0)

    Rw = axis_w(rbin.expand(mag.shape))
    Cw = axis_w(cbin.expand(mag.shape))
    ob = torch.arange(NO, dtype=torch.float32, device=dev)
    dwrap = (obin[..., None] - ob).abs()
    dwrap = torch.minimum(dwrap, NO - dwrap)
    Ow = torch.clamp(1.0 - dwrap, 0.0, 1.0)  # (N, P, 8) circular weights

    RC = (Rw[..., :, None] * Cw[..., None, :]).reshape(*mag.shape, D * D)
    desc = torch.bmm((RC * contrib[..., None]).transpose(1, 2), Ow)
    desc = desc.reshape(desc.shape[0], D * D * NO)

    # SIFT normalisation: L2, clip 0.2, renormalise, scale to byte range.
    nrm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(nrm, min=1e-7)
    desc = torch.clamp(desc, max=0.2)
    nrm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.clamp(nrm, min=1e-7)
    desc = torch.clamp(512.0 * desc, max=255.0)

    # ------------------------------------------------------------- outputs
    scale_mult = (2 ** oct_i).to(torch.float32)
    uv = torch.stack([xf * scale_mult, yf * scale_mult], dim=-1)
    size = sigma_rel * scale_mult * 2.0
    angle_deg = torch.remainder(-torch.rad2deg(theta), 360.0)
    pad = capacity - n_active
    if pad > 0:
        uv = F.pad(uv, (0, 0, 0, pad))
        size, angle_deg, resp, mask = (F.pad(a, (0, pad)) for a in
                                       (size, angle_deg, resp, mask))
        desc = F.pad(desc, (0, 0, 0, pad))
    return SiftFeatures(uv, size, angle_deg, resp, desc, mask)


def sift_features(gray: torch.Tensor, capacity: int = 4096,
                  n_octaves: Optional[int] = None, n_scales: int = 3,
                  sigma0: float = 1.6, contrast_threshold: float = 0.04,
                  edge_threshold: float = 10.0,
                  n_features: Optional[int] = None) -> SiftFeatures:
    """Detect + describe SIFT features of a (H, W) image on its device.

    `gray` may be uint8 (0..255) or float (0..1). Returns fixed-capacity
    tensors; invalid rows are masked. Defaults mirror cv2.SIFT_create; the
    fusion pipeline overrides contrast_threshold=0.01, edge_threshold=15.

    `n_features` (cv2 nfeatures): keep only the strongest n keypoints; the
    per-keypoint passes then run on ceil128(n_features) rows.
    """
    if gray.dtype == torch.uint8:
        gray = gray.to(torch.float32) / 255.0
    else:
        gray = gray.to(torch.float32)
    H, W = gray.shape
    if n_octaves is None:
        n_octaves = max(1, min(5, int(math.log2(max(min(H, W) / 16.0,
                                                    2.0)))))
    n_active = capacity
    if n_features is not None:
        n_active = min(capacity,
                       max(128, ((int(n_features) + 127) // 128) * 128))
    return _sift_impl(gray, capacity=capacity, n_octaves=n_octaves,
                      n_scales=n_scales, sigma0=float(sigma0),
                      contrast_thr=float(contrast_threshold),
                      edge_thr=float(edge_threshold), n_active=n_active)
