"""Chunked dense voxel merge: bounded device memory for long sequences,
the counterpart of ``txr/fusion/chunked_merge.py``.

The fusion CLI back-projects and merges every view in one pass
(``pipelines/fusion_pipeline.py``), so its device memory grows with the
views. This module keeps the merge exact while holding one chunk of views
on the device at a time:

  pass A (per chunk) back-project -> masked min of world coords; the host
         fold of the chunk minima is the GLOBAL voxel origin, so the voxel
         partition matches the single pass (which keys off the global
         masked min).
  pass B (per chunk) back-project -> per-voxel (sum_xyz, sum_rgb, weight)
         keyed to that origin (``ops/voxel.py:voxel_sums``, one scan
         launch); the host fetches only the compacted rows, in power-of-two
         buckets.
  pass C (once)     all chunks' rows (+ optional extra points) -> second
         sorted reduce -> per-voxel means (``voxel_means_of_sums``).

Sums over disjoint chunks add, so the result equals the single pass up to
float summation order. Reference semantics: depth_to_reconstruction.py:
386-420 (Open3D voxel_down_sample averaging).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from txr_torch.core.device import resolve_device
from txr_torch.core.types import PointSet
from txr_torch.fusion.pointcloud import backproject_views
from txr_torch.ops.segment import INT_MAX
from txr_torch.ops.voxel import voxel_means_of_sums, voxel_sums

_BIG = 3.0e38


def _pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


def chunked_dense_voxel_merge(depths, bgrs, Rs: np.ndarray, ts: np.ndarray,
                              scales: np.ndarray, keep: np.ndarray, *, fx,
                              fy, cx, cy, min_depth, max_depth,
                              subsample: int, voxel_size: float,
                              chunk_views: int = 8,
                              extra: Optional[PointSet] = None,
                              device=None) -> Tuple[PointSet, np.ndarray]:
    """Host-orchestrated chunked merge.

    ``depths`` / ``bgrs`` may be stacked (N, H, W[, 3]) arrays or per-view
    sequences of mixed-shape arrays (None for skipped views): the padded
    (chunk, Hmax, Wmax) slab is built per chunk, so host memory is O(chunk)
    too. Each chunk is staged once per pass (twice in all), so the device
    holds a single chunk.

    Returns (merged per-voxel means as a PointSet on the device, per-view
    point counts (N,) int32). ``extra`` (e.g. sparse SfM points) joins the
    final reduce as weight-1 rows.
    """
    dev = resolve_device(device)
    n = len(depths)
    c = max(1, min(int(chunk_views), n))
    cam = (float(fx), float(fy), float(cx), float(cy), float(min_depth),
           float(max_depth), int(subsample))

    shapes = [d.shape for d in depths if d is not None] or [(1, 1)]
    hmax = max(s[0] for s in shapes)
    wmax = max(s[1] for s in shapes)
    Rs_a = np.asarray(Rs, np.float32)
    ts_a = np.asarray(ts, np.float32)
    scales_a = np.asarray(scales, np.float32)
    keep_a = np.asarray(keep, bool)
    n_pad = int(np.ceil(n / c)) * c

    def pad_small(a, s):
        out = a[s:min(s + c, n)]
        if len(out) < c:
            out = np.concatenate(
                [out, np.zeros((c - len(out),) + a.shape[1:], a.dtype)])
        return torch.from_numpy(np.ascontiguousarray(out)).to(dev)

    def flat_chunk(s):
        dep = np.zeros((c, hmax, wmax), np.float32)
        bgr = np.zeros((c, hmax, wmax, 3), np.uint8)
        for k in range(s, min(s + c, n)):
            d = depths[k]
            if d is None:
                continue
            dep[k - s, :d.shape[0], :d.shape[1]] = d
            im = bgrs[k]
            if im is not None:
                if im.ndim == 2:
                    im = im[:, :, None]
                ih, iw = min(im.shape[0], hmax), min(im.shape[1], wmax)
                bgr[k - s, :ih, :iw] = im[:ih, :iw]
        return backproject_views(
            torch.from_numpy(dep).to(dev), torch.from_numpy(bgr).to(dev),
            pad_small(Rs_a, s), pad_small(ts_a, s), pad_small(scales_a, s),
            pad_small(keep_a, s), *cam)

    starts = list(range(0, n_pad, c))
    mins = []
    for s in starts:                                    # pass A
        flat, _ = flat_chunk(s)
        mins.append(torch.where(flat.mask[:, None], flat.xyz, _BIG)
                    .amin(dim=0).cpu().numpy())
        del flat
    origin = np.min(np.stack(mins), axis=0)
    if extra is not None:
        exyz = extra.xyz.cpu().numpy().astype(np.float32)
        emask = extra.mask.cpu().numpy().astype(bool)
        if emask.any():
            origin = np.minimum(origin, exyz[emask].min(axis=0))
    origin_d = torch.from_numpy(origin.astype(np.float32)).to(dev)

    key_rows, sum_rows = [], []
    counts = np.zeros(n_pad, np.int32)
    for s in starts:                                    # pass B
        flat, cnts = flat_chunk(s)   # re-staged: the device holds one chunk
        keys, sums, _, n_vox = voxel_sums(flat, voxel_size, origin_d)
        del flat
        bucket = _pow2(int(n_vox))
        key_rows.append(keys[:bucket].cpu().numpy())
        sum_rows.append(sums[:bucket].cpu().numpy())
        counts[s:s + c] = cnts.cpu().numpy()
    counts = counts[:n]

    if extra is not None and emask.any():
        ergb = extra.rgb.cpu().numpy().astype(np.float32)
        sel = np.where(emask)[0]
        ek = np.floor((exyz[sel] - origin[None, :]) /
                      np.float32(voxel_size)).astype(np.int32)
        es = np.concatenate([exyz[sel], ergb[sel],
                             np.ones((len(sel), 1), np.float32)], axis=1)
        key_rows.append(ek)
        sum_rows.append(es)

    all_keys = np.concatenate(key_rows)
    all_sums = np.concatenate(sum_rows)
    pad = _pow2(len(all_keys)) - len(all_keys)
    if pad:
        all_keys = np.concatenate(
            [all_keys, np.full((pad, 3), INT_MAX, np.int32)])
        all_sums = np.concatenate([all_sums, np.zeros((pad, 7), np.float32)])
    merged = voxel_means_of_sums(torch.from_numpy(all_keys).to(dev),   # pass C
                                 torch.from_numpy(all_sums).to(dev))
    return merged, counts
