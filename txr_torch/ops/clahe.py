"""CLAHE (contrast-limited adaptive histogram equalisation), the
counterpart of ``txr/ops/clahe.py``.

The fusion pipeline equalises low-contrast frames with CLAHE(clipLimit=2.0,
tiles 8x8) before SIFT (reference depth_to_reconstruction.py:133-153 via
cv2.createCLAHE). Formulation, as ``txr``'s:

  1. per-tile 256-bin histogram (``txr`` reduces a one-hot comparison; here
     the same integer counts come from one scatter-add, which needs no
     (pixels, 256) intermediate: 2 GB at 1080p),
  2. clip at the absolute limit, redistribute the excess evenly in one pass,
  3. per-tile LUT from the CDF,
  4. per-pixel bilinear interpolation between the 4 neighbouring tile LUTs
     (border-replicated, as OpenCV).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def clahe(image: torch.Tensor, clip_limit: float = 2.0, tiles: int = 8
          ) -> torch.Tensor:
    """Equalise a (H, W) uint8 image on its device; any H, W (edge-
    replicated up to the next tile multiple, then cropped back).

    Returns (H, W) uint8.
    """
    h0, w0 = image.shape
    pad_h = (-h0) % tiles
    pad_w = (-w0) % tiles
    img = image.to(torch.int32)
    if pad_h or pad_w:
        img = F.pad(img[None, None].float(), (0, pad_w, 0, pad_h),
                    mode="replicate")[0, 0].to(torch.int32)
    h, w = h0 + pad_h, w0 + pad_w
    th, tw = h // tiles, w // tiles
    area = th * tw
    dev = img.device

    # --- per-tile histograms (exact integer counts) ------------------------
    tile = ((torch.arange(h, device=dev) // th)[:, None] * tiles
            + (torch.arange(w, device=dev) // tw)[None, :])
    flat = (tile * 256 + img).reshape(-1).to(torch.int64)
    hist = torch.zeros(tiles * tiles * 256, dtype=torch.float32, device=dev)
    hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.float32))
    hist = hist.reshape(tiles * tiles, 256)

    # --- clip + even redistribution ----------------------------------------
    limit = max(1.0, clip_limit * area / 256.0)
    clipped = torch.clamp(hist, max=limit)
    excess = (hist - clipped).sum(-1, keepdim=True)
    clipped = clipped + excess / 256.0

    # --- LUTs from CDFs -----------------------------------------------------
    cdf = torch.cumsum(clipped, dim=-1)
    luts = torch.clamp(torch.round(cdf * (255.0 / area)), 0, 255)
    luts = luts.reshape(-1)                          # (T * T * 256,)

    # --- bilinear interpolation between neighbouring tile LUTs -------------
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    fy = (yy + 0.5) / th - 0.5
    fx = (xx + 0.5) / tw - 0.5
    y0 = torch.clamp(torch.floor(fy).to(torch.int64), 0, tiles - 1)
    x0 = torch.clamp(torch.floor(fx).to(torch.int64), 0, tiles - 1)
    y1 = torch.clamp(y0 + 1, 0, tiles - 1)
    x1 = torch.clamp(x0 + 1, 0, tiles - 1)
    wy = torch.clamp(fy - torch.floor(fy), 0.0, 1.0)
    wx = torch.clamp(fx - torch.floor(fx), 0.0, 1.0)
    # Border replication: outside the first / last tile centres the weights
    # snap.
    wy = torch.where(fy < 0, 0.0, torch.where(fy > tiles - 1, 1.0, wy))
    wx = torch.where(fx < 0, 0.0, torch.where(fx > tiles - 1, 1.0, wx))

    v = img.to(torch.int64)

    def lut(ty, tx):
        return luts[(ty * tiles + tx) * 256 + v]

    v00, v01 = lut(y0, x0), lut(y0, x1)
    v10, v11 = lut(y1, x0), lut(y1, x1)
    out = ((1 - wy) * ((1 - wx) * v00 + wx * v01)
           + wy * ((1 - wx) * v10 + wx * v11))
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)[:h0, :w0]
