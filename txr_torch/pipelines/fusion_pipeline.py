"""Fusion from precomputed depth, the counterpart of
``txr/pipelines/fusion_pipeline.py`` (reference CLI
depth_to_reconstruction.py:423-703).

RGB + depth pairing by filename, an initialisation pair (pose ->
triangulation -> scale), incremental views with pose chaining and a 0.7 /
0.3 scale EMA, and a dense merge (voxel downsample + statistical outlier
removal).

The sequence runs as three device stages: ``_pairs_batch`` (one
``pair_step`` per consecutive frame pair: match -> essential RANSAC and
homography RANSAC with model selection -> cheirality pose -> Gauss-Newton
refinement -> DLT triangulation -> filtering), ``_scales_batch`` (the
metric scale of the first pair's views and of every later view against its
chained pose), and ``_dense_merge_batch`` (back-projection of every kept
view -> one flat PointSet -> ``voxel_downsample``, whose segment sums are
the segmented-scan kernel on the card -> grid outlier removal). The host
reads the per-pair results once, to chain poses with the reference's skip
rules, and the merged cloud once at the end.
"""

from __future__ import annotations

import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from txr_torch.core.config import ReconstructionConfig
from txr_torch.core.device import resolve_device
from txr_torch.core.precision import f32_dots
from txr_torch.fusion.pointcloud import (backproject_views,
                                         depth_to_pointcloud,
                                         merge_pointclouds)
from txr_torch.geometry.features import SIFTDetector, match_features
from txr_torch.geometry.epipolar import essential_ransac
from txr_torch.geometry.homography import (homography_ransac,
                                           recover_pose_homography,
                                           transfer_error)
from txr_torch.geometry.pose import recover_pose
from txr_torch.geometry.refine import refine_pose
from txr_torch.geometry.scale import clamp_scale, estimate_scale
from txr_torch.geometry.triangulate import reprojection_error, triangulate
from txr_torch.io.depth_io import find_matching_depth, load_depth
from txr_torch.io.opencv import cv2_or_none, require_cv2
from txr_torch.io.ply import write_ply
from txr_torch.io.sources import _read_image
from txr_torch.ops.matching import match_l2_ratio
from txr_torch.ops.outlier import remove_statistical_outliers_grid
from txr_torch.ops.voxel import voxel_downsample


@f32_dots
def pair_step(uv1: torch.Tensor, uv2: torch.Tensor,
              match_mask: torch.Tensor, K: torch.Tensor,
              generator: Optional[torch.Generator],
              ransac_threshold: float = 2.0, min_depth: float = 0.1,
              max_depth: float = 50.0, max_reproj: float = 5.0,
              num_hypotheses: int = 1024, *,
              priorities: Optional[Sequence[torch.Tensor]] = None):
    """Relative pose + filtered sparse structure for one frame pair.

    Follows SparseReconstructor.compute_pose/triangulate/filter_points
    (depth_to_reconstruction.py:183-271): essential RANSAC -> cheirality
    pose -> DLT triangulation -> filter by depth range in cam1, positive
    depth in cam2 and reprojection error < max_reproj px in both views.

    Planar degeneracy: the 8-point essential solve is ill-posed when the
    matches lie on a plane. A homography is fitted alongside and, when it
    explains most of the E-inlier set (n_H > 0.7 n_E, both counted at the
    same pixel threshold), the pose comes from the homography decomposition
    instead. The winner is polished by Gauss-Newton (``refine_pose``).

    generator draws the RANSAC priorities (essential first, then
    homography); ``priorities=(prio_E, prio_H)``, each (num_hypotheses, N),
    replaces the draw.

    Returns R (3, 3), t (3,), X (N, 3) points in the cam-1 frame, valid
    (N,), n_inliers (0-dim).
    """
    prio_e, prio_h = (None, None) if priorities is None else priorities
    E, inliers_e = essential_ransac(uv1, uv2, match_mask, K, generator,
                                    ransac_threshold, num_hypotheses,
                                    priorities=prio_e)
    R_e, t_e, cheiral_e = recover_pose(E, uv1, uv2, K, inliers_e)

    H, inliers_h = homography_ransac(uv1, uv2, match_mask, generator,
                                     max(ransac_threshold, 3.0),
                                     num_hypotheses, priorities=prio_h)
    R_h, t_h, cheiral_h = recover_pose_homography(H, uv1, uv2, K, inliers_h)

    n_e = inliers_e.sum()
    # Model selection rescores H at the SAME pixel threshold as E.
    h_sel = match_mask & (transfer_error(H, uv1, uv2)
                          < 2.0 * ransac_threshold ** 2)
    use_h = h_sel.sum().to(K.dtype) > 0.7 * n_e.to(K.dtype)

    R = torch.where(use_h, R_h, R_e)
    t = torch.where(use_h, t_h, t_e)
    cheiral = torch.where(use_h, cheiral_h, cheiral_e)
    inliers = torch.where(use_h, inliers_h, inliers_e)

    R, t = refine_pose(R, t, uv1, uv2, K, inliers & cheiral)

    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    P1 = K @ torch.cat([eye, torch.zeros_like(eye[:, :1])], dim=1)
    P2 = K @ torch.cat([R, t[:, None]], dim=1)
    X = triangulate(P1, P2, uv1, uv2)

    z1 = X[:, 2]
    z2 = X @ R[2, :] + t[2]
    err1 = reprojection_error(P1, X, uv1)
    err2 = reprojection_error(P2, X, uv2)
    valid = (inliers & cheiral & (z1 > min_depth) & (z1 < max_depth)
             & (z2 > min_depth) & (err1 < max_reproj) & (err2 < max_reproj)
             & torch.isfinite(z1))
    X = torch.where(valid[:, None], X, 0.0)
    return R, t, X, valid, inliers.sum()


@f32_dots
def sparse_to_world(X: torch.Tensor, valid: torch.Tensor,
                    R_prev: torch.Tensor, t_prev: torch.Tensor):
    """Triangulated points (..., N, 3) in the previous camera's frame ->
    world, with the reference's depth-range filter 0.1 < z_w < 100
    (depth_to_reconstruction.py:630-637)."""
    Xw = (X - t_prev[..., None, :]) @ R_prev   # R_prev^T (X - t_prev)
    ok = valid & (Xw[..., 2] > 0.1) & (Xw[..., 2] < 100.0)
    return Xw, ok


def _compact(ok: torch.Tensor, cap: int) -> torch.Tensor:
    """Indices of the first ``cap`` rows with the matched rows first, each
    group in its order (``txr`` takes a stable top-k of the mask)."""
    order = torch.sort(ok.to(torch.uint8), descending=True, stable=True)[1]
    return order[:cap]


def _pairs_batch(desc: torch.Tensor, fmask: torch.Tensor, fuv: torch.Tensor,
                 K: torch.Tensor, generator: Optional[torch.Generator],
                 match_ratio: float, ransac_threshold: float,
                 min_depth: float, max_depth: float,
                 num_hypotheses: int = 1024, *,
                 priorities: Optional[torch.Tensor] = None):
    """Match + pair_step for every consecutive frame pair.

    desc / fmask / fuv: (N, cap, ...) stacked features. priorities:
    optional (N-1, 2, num_hypotheses, rows) ready-made RANSAC priorities
    (see ``pair_step``). Returns per pair (R, t, X, valid, n_inl, n_match,
    uv1, uv2, ok), each with leading dim N-1.

    The pair's rows are compacted to the first TXR_PAIR_CAP (default 4096;
    0 disables) with the matched rows first, in order: pair_step's per-row
    cost scales with the rows, and only matches count. The pairs run one
    after another, as ``txr``'s ``lax.map``, so peak memory stays at one
    pair's (cap, cap) distance matrix (268 MB at cap 8192).
    """
    pair_cap = int(os.environ.get("TXR_PAIR_CAP", "4096"))
    outs = []
    for p in range(desc.shape[0] - 1):
        u1 = fuv[p]
        idx2, ok = match_l2_ratio(desc[p], desc[p + 1], fmask[p],
                                  fmask[p + 1], match_ratio)
        uv2 = fuv[p + 1][idx2]
        n_match = ok.sum()
        if 0 < pair_cap < u1.shape[0]:
            pick = _compact(ok, pair_cap)
            u1, uv2, ok = u1[pick], uv2[pick], ok[pick]
        prio = None if priorities is None else priorities[p]
        R, t, X, valid, n_inl = pair_step(
            u1, uv2, ok, K, generator, ransac_threshold, min_depth,
            max_depth, num_hypotheses=num_hypotheses, priorities=prio)
        outs.append((R, t, X, valid, n_inl, n_match, u1, uv2, ok))
    return tuple(torch.stack(col) for col in zip(*outs))


def _scales_init(X0, valid0, uv1_0, uv2_0, d0, d1):
    """Init-pair scale estimates only (the chunked-sequence split of
    _scales_batch)."""
    s1 = estimate_scale(X0, uv1_0, valid0, d0, min_points=0,
                        per_sample_clamp=True)
    s2 = estimate_scale(X0, uv2_0, valid0, d1, min_points=0,
                        per_sample_clamp=True)
    return clamp_scale(s1), clamp_scale(s2), valid0.sum()


def _scales_views(X, valid, uv2, R_prev, t_prev, depths_next):
    """Per-view world-frame scales for one chunk of pairs (the chunked-
    sequence split of _scales_batch); depths_next[p] is view p+1's depth."""
    Xw, ok = sparse_to_world(X, valid, R_prev, t_prev)
    s = estimate_scale(Xw, uv2, ok, depths_next, min_points=0,
                       per_sample_clamp=True)
    return clamp_scale(s), ok.sum(-1)


@f32_dots
def _scales_batch(X, valid, uv1, uv2, depths, R_prev, t_prev):
    """Init-pair scales + per-view world-frame scales, all pairs at once.

    X / valid / uv1 / uv2: (P, cap, ...) pair outputs (on the device, from
    _pairs_batch). depths: (P+1, H, W). R_prev / t_prev: (P, 3, 3) / (P, 3):
    entry p holds the chained pose of the LAST SUCCESSFUL view before view
    p+1 (host-computed; entry 0 unused).
    Returns (s1, s2, n_valid0, sw (P,), ok_n (P,)).
    """
    # depth_to_reconstruction.py:297-326 semantics: no input-count gate,
    # per-ratio (0.001, 1000) clamp before the median.
    s1 = estimate_scale(X[0], uv1[0], valid[0], depths[0], min_points=0,
                        per_sample_clamp=True)
    s2 = estimate_scale(X[0], uv2[0], valid[0], depths[1], min_points=0,
                        per_sample_clamp=True)
    Xw, ok = sparse_to_world(X, valid, R_prev, t_prev)
    sw = estimate_scale(Xw, uv2, ok, depths[1:], min_points=0,
                        per_sample_clamp=True)
    return s1, s2, valid[0].sum(), sw, ok.sum(-1)


def _pad_pow2(n: int, lo: int = 1) -> int:
    return max(lo, 1 << int(np.ceil(np.log2(max(n, 1)))))


def dense_chunk_views(single_rows: int, rows_per_view: int) -> int:
    """Views per chunk of the chunked dense merge: the largest power of two
    whose rows stay within half of TXR_DENSE_SINGLE_ROWS's ``single_rows``
    (at least 1)."""
    return max(1, _pad_pow2(max(1, single_rows // 2 // rows_per_view)) // 2)


def _seq_chunk() -> int:
    """Pair-slab size for long sequences (TXR_SEQ_CHUNK, default 64),
    rounded up to a power of two so it divides the pow2-padded pair
    count."""
    return _pad_pow2(int(os.environ.get("TXR_SEQ_CHUNK", "64")))


def _dense_merge_batch(depths: torch.Tensor, bgrs: torch.Tensor,
                       Rs: torch.Tensor, ts: torch.Tensor,
                       scales: torch.Tensor, keep: torch.Tensor, *, fx, fy,
                       cx, cy, min_depth, max_depth, voxel_size,
                       outlier_std_ratio, subsample: int,
                       outlier_neighbors: int):
    """Back-project every kept view and merge on the device: one flat
    PointSet -> voxel downsample -> grid statistical outlier removal (cell
    tuned from the data). Returns (merged PointSet, per-view counts (V,)),
    both on the device; nothing is read back but ``auto_cell``'s one
    branch."""
    flat, counts = backproject_views(depths, bgrs, Rs, ts, scales, keep, fx,
                                     fy, cx, cy, min_depth, max_depth,
                                     subsample)
    out = voxel_downsample(flat, voxel_size)
    out = remove_statistical_outliers_grid(
        out, None, nb_neighbors=outlier_neighbors,
        std_ratio=outlier_std_ratio)
    return out, counts


class DepthToReconstructionPipeline:
    """RGB + precomputed depth -> fused PLY (the reference's CLI #1).

    device: where the pipeline runs (``None``: the CUDA device, which must
    be present; ``"cpu"`` runs the plain versions). RANSAC draws come from a
    ``torch.Generator`` seeded 0 on that device, advancing with each
    ``reconstruct``."""

    def __init__(self, config: Optional[ReconstructionConfig] = None,
                 feature_capacity: int = 8192, verbose: bool = True,
                 feature_backend: str = "auto", device=None):
        self.config = config or ReconstructionConfig()
        self.device = resolve_device(device)
        self.detector = SIFTDetector(capacity=feature_capacity,
                                     backend=feature_backend,
                                     device=self.device)
        self.verbose = verbose
        self.images: List[np.ndarray] = []
        self.depths: List[np.ndarray] = []
        self.image_names: List[str] = []
        self.camera_poses: List[Tuple[np.ndarray, np.ndarray]] = []
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    # ------------------------------------------------------------------ I/O

    def _log(self, msg: str):
        if self.verbose:
            print(msg)

    def load_data(self, rgb_folder: str, depth_folder: str) -> int:
        """Pair RGB frames with depth maps by filename; resize depth to RGB
        (reference :439-477). JPEGs decode natively; other images, and a
        depth map of another size than its frame, need OpenCV."""
        rgb_files = sorted(
            f for f in os.listdir(rgb_folder)
            if os.path.splitext(f)[1].lower() in (".png", ".jpg", ".jpeg"))
        self._log(f"Found {len(rgb_files)} RGB images")
        for name in rgb_files:
            img = _read_image(os.path.join(rgb_folder, name))
            if img is None:
                if cv2_or_none() is None:
                    require_cv2(f"reading the image {name}")
                continue
            depth_file = find_matching_depth(name, depth_folder)
            if depth_file is None:
                self._log(f"  Warning: No depth found for {name}")
                continue
            depth = load_depth(depth_file)
            if depth.shape[:2] != img.shape[:2]:
                cv2 = require_cv2("resizing a depth map to its RGB frame")
                depth = cv2.resize(depth, (img.shape[1], img.shape[0]),
                                   interpolation=cv2.INTER_LINEAR)
            self.images.append(img)
            self.depths.append(depth.astype(np.float32))
            self.image_names.append(name)
            self._log(f"  Loaded: {name} with depth")
        self._log(f"Loaded {len(self.images)} image-depth pairs")
        return len(self.images)

    # ------------------------------------------------------------- pipeline

    def _dslab(self, s: int, e: int, h: int, w: int) -> np.ndarray:
        """Depths of views s..e-1 zero-padded to (e - s, h, w) (views past
        the sequence stay zero)."""
        out = np.zeros((e - s, h, w), np.float32)
        for k in range(s, min(e, len(self.depths))):
            d = self.depths[k]
            out[k - s, :d.shape[0], :d.shape[1]] = d
        return out

    def reconstruct(self, priorities: Optional[torch.Tensor] = None):
        """Run the full pipeline. Returns (points, colors[0..255], poses).

        priorities: optional (P2, 2, hypotheses, rows) RANSAC priorities,
        one essential and one homography draw per pair of the
        power-of-two-padded pair count P2, in the order the pipeline
        draws them; None draws them from ``self.generator``.

        Three device stages (pairs, scales, dense merge), each run once for
        sequences up to TXR_SEQ_CHUNK pairs and once per slab of pairs
        beyond that (the same results; device memory O(chunk)); dense
        merges of more than TXR_DENSE_SINGLE_ROWS rows go through the
        chunked merge. The host carries only the reference's skip /
        pose-chain / scale-EMA logic (depth_to_reconstruction.py:479-671).
        """
        cfg = self.config
        dev = self.device
        if len(self.images) < 2:
            self._log("Need at least 2 images")
            return None, None, None

        self._log("\n" + "=" * 70)
        self._log("DEPTH-ENHANCED RECONSTRUCTION PIPELINE "
                  f"({dev.type.upper()})")
        self._log("=" * 70)

        K = torch.as_tensor(cfg.K.astype(np.float32)).to(dev)
        t0 = time.time()
        features = self.detector.detect_batch(self.images)
        self._log(f"Features detected for {len(features)} frames "
                  f"({time.time() - t0:.2f}s)")

        n = len(self.images)
        n_pairs = n - 1
        p2 = _pad_pow2(n_pairs)
        n2 = p2 + 1

        def stacked(name):
            a = torch.stack([getattr(f, name) for f in features])
            pad = a.new_zeros((n2 - n,) + a.shape[1:])
            return torch.cat([a, pad])

        desc, fuv, fmask = stacked("desc"), stacked("uv"), stacked("mask")
        # folders may mix resolutions: depths are padded to the largest
        # frame (the pad reads 0 and masks out downstream)
        h = max(d.shape[0] for d in self.depths)
        w = max(d.shape[1] for d in self.depths)
        prio = None if priorities is None else priorities.to(dev)

        def pairs(s, e):
            return _pairs_batch(
                desc[s:e + 1], fmask[s:e + 1], fuv[s:e + 1], K,
                self.generator, cfg.match_ratio, cfg.ransac_threshold,
                cfg.min_depth, cfg.max_depth,
                priorities=None if prio is None else prio[s:e])

        # ---- stage 1: all pair matches + pose / structure ----------------
        # Longer sequences run the same stage over fixed slabs of pairs
        # (the descriptor stack is O(views) on the device); per-pair math is
        # independent and the draws come in pair order, so the results are
        # the same. Each slab's outputs go to the host and come back for
        # the scale stage.
        seq_chunk = _seq_chunk()
        pair_chunks = None
        if p2 <= seq_chunk:
            R_rel, t_rel, X, valid, n_inl, n_match, uv1b, uv2b, _ = \
                pairs(0, p2)
            R_rel_h, t_rel_h, n_inl_h, n_match_h = (
                a.cpu().numpy() for a in (R_rel, t_rel, n_inl, n_match))
        else:
            cp = seq_chunk
            pair_chunks = []          # per-slab host (X, valid, uv2)
            R_l, t_l, ni_l, nm_l = [], [], [], []
            uv1_0 = None
            for s in range(0, p2, cp):
                Rc, tc, Xc, vc, nic, nmc, u1c, u2c, _ = pairs(s, s + cp)
                if s == 0:
                    uv1_0 = u1c[0].cpu().numpy()
                pair_chunks.append(tuple(a.cpu().numpy()
                                         for a in (Xc, vc, u2c)))
                R_l.append(Rc.cpu().numpy())
                t_l.append(tc.cpu().numpy())
                ni_l.append(nic.cpu().numpy())
                nm_l.append(nmc.cpu().numpy())
            R_rel_h = np.concatenate(R_l)
            t_rel_h = np.concatenate(t_l)
            n_inl_h = np.concatenate(ni_l)
            n_match_h = np.concatenate(nm_l)

        # ---- Step 1: initialize with the first pair ------------------------
        self._log("\n--- Step 1: Initialize with first pair ---")
        self._log(f"Feature matches: {int(n_match_h[0])}")
        if int(n_match_h[0]) < 8:
            self._log("Insufficient matches for initialization")
            return None, None, None
        self._log(f"Inliers: {int(n_inl_h[0])}")

        self.camera_poses = [
            (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
            (R_rel_h[0], t_rel_h[0]),
        ]

        # Host pose chain with the reference's skip rules; R_prev[p] is the
        # last successful pose before view p+1 (feeds the scale stage).
        R_prev = np.tile(np.eye(3, dtype=np.float32), (p2, 1, 1))
        t_prev = np.zeros((p2, 3), np.float32)
        processed: List[int] = []
        skip_reason: dict = {}
        for i in range(2, n):
            p = i - 1
            if int(n_match_h[p]) < 8:
                skip_reason[i] = f"insufficient matches ({int(n_match_h[p])})"
                continue
            if int(n_inl_h[p]) < 8:
                skip_reason[i] = f"insufficient inliers ({int(n_inl_h[p])})"
                continue
            Rp, tp = self.camera_poses[-1]
            R_prev[p], t_prev[p] = Rp, tp
            R_curr = R_rel_h[p] @ Rp
            t_curr = R_rel_h[p] @ tp + t_rel_h[p]
            self.camera_poses.append((R_curr, t_curr))
            processed.append(i)

        def on_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        # ---- stage 2: all scale estimates ----------------------------------
        if pair_chunks is None:
            s1_d, s2_d, n_valid0_d, sw_d, okn_d = _scales_batch(
                X, valid, uv1b, uv2b, on_dev(self._dslab(0, n2, h, w)),
                on_dev(R_prev), on_dev(t_prev))
            s1c, s2c, n_valid0, sw_h, okn_h = (
                a.cpu().numpy() for a in (clamp_scale(s1_d),
                                          clamp_scale(s2_d), n_valid0_d,
                                          clamp_scale(sw_d), okn_d))
        else:
            # the same split, chunked: the (N, H, W) depth stack is the
            # other O(views) device allocation
            cp = seq_chunk
            X0, valid0_0, uv2_0 = pair_chunks[0]
            d01 = self._dslab(0, 2, h, w)
            s1_d, s2_d, nv0 = _scales_init(
                on_dev(X0[0]), on_dev(valid0_0[0]), on_dev(uv1_0),
                on_dev(uv2_0[0]), on_dev(d01[0]), on_dev(d01[1]))
            sw_l, okn_l = [], []
            for ci, s in enumerate(range(0, p2, cp)):
                Xc, vc, u2c = pair_chunks[ci]
                swc, oknc = _scales_views(
                    on_dev(Xc), on_dev(vc), on_dev(u2c),
                    on_dev(R_prev[s:s + cp]), on_dev(t_prev[s:s + cp]),
                    on_dev(self._dslab(s + 1, s + cp + 1, h, w)))
                sw_l.append(swc.cpu().numpy())
                okn_l.append(oknc.cpu().numpy())
                pair_chunks[ci] = None  # free this slab
            s1c, s2c, n_valid0 = (a.cpu().numpy() for a in (s1_d, s2_d, nv0))
            sw_h = np.concatenate(sw_l)
            okn_h = np.concatenate(okn_l)
        n_valid0 = int(n_valid0)
        self._log(f"Valid sparse points: {n_valid0}")

        # ---- Step 2: depth scale from sparse anchor ------------------------
        self._log("\n--- Step 2: Estimate depth scale ---")
        if n_valid0 >= 3:
            avg_scale = float((s1c + s2c) / 2.0)
        else:
            self._log("Warning: Not enough sparse points for scale estimation")
            avg_scale = 1.0
        self._log(f"Average scale: {avg_scale:.6f}")

        # Scale EMA chain (reference :633-650) over the processed views.
        view_R = np.zeros((n2, 3, 3), np.float32)
        view_t = np.zeros((n2, 3), np.float32)
        view_scale = np.zeros((n2,), np.float32)
        keep = np.zeros((n2,), bool)
        for i in (0, 1):
            view_R[i], view_t[i] = self.camera_poses[i]
            view_scale[i] = avg_scale
            keep[i] = True
        pose_idx = 2
        scale_warn: dict = {}
        for i in processed:
            p = i - 1
            if int(okn_h[p]) >= 3:
                scale_i = float(sw_h[p])
            else:
                scale_warn[i] = True
                scale_i = avg_scale
            avg_scale = 0.7 * avg_scale + 0.3 * scale_i
            view_R[i], view_t[i] = self.camera_poses[pose_idx]
            view_scale[i] = avg_scale
            keep[i] = True
            pose_idx += 1

        # ---- stage 3: dense clouds + device merge --------------------------
        ss = int(cfg.subsample_factor)
        rows_per_view = -(-h // ss) * -(-w // ss)
        single_rows = int(os.environ.get("TXR_DENSE_SINGLE_ROWS",
                                         str(1 << 24)))
        cam = dict(fx=float(cfg.fx), fy=float(cfg.fy), cx=float(cfg.cx),
                   cy=float(cfg.cy), min_depth=float(cfg.min_depth),
                   max_depth=float(cfg.max_depth))
        if n2 * rows_per_view <= single_rows:
            bgrs = np.zeros((n2, h, w, 3), np.uint8)
            for i, im in enumerate(self.images):
                bgrs[i, :im.shape[0], :im.shape[1]] = im
            merged, counts_d = _dense_merge_batch(
                on_dev(self._dslab(0, n2, h, w)), on_dev(bgrs),
                on_dev(view_R), on_dev(view_t), on_dev(view_scale),
                on_dev(keep), voxel_size=float(cfg.voxel_size),
                outlier_std_ratio=float(cfg.outlier_std_ratio),
                subsample=ss, outlier_neighbors=int(cfg.outlier_neighbors),
                **cam)
            counts = counts_d.cpu().numpy()
        else:
            # Long sequences: the views in chunks with an exact weighted
            # merge (fusion/chunked_merge.py), then the same outlier pass.
            # Per-view lists keep host memory O(chunk).
            from txr_torch.fusion.chunked_merge import \
                chunked_dense_voxel_merge

            depth_list = list(self.depths) + [None] * (n2 - n)
            img_list = list(self.images) + [None] * (n2 - n)
            chunk_views = dense_chunk_views(single_rows, rows_per_view)
            merged, counts = chunked_dense_voxel_merge(
                depth_list, img_list, view_R, view_t, view_scale, keep,
                subsample=ss, voxel_size=float(cfg.voxel_size),
                chunk_views=min(chunk_views, n2), device=dev, **cam)
            merged = remove_statistical_outliers_grid(
                merged, None, nb_neighbors=int(cfg.outlier_neighbors),
                std_ratio=float(cfg.outlier_std_ratio))
        points, colors = merged.to_numpy()
        colors = colors * 255.0

        # Narration (same lines / order as the frame-sequential reference).
        self._log("\n--- Step 3: Generate dense point clouds ---")
        for i in (0, 1):
            self._log(f"Camera {i}: {int(counts[i])} points")
        self._log("\n--- Step 4: Add remaining views ---")
        for i in range(2, n):
            self._log(f"\nProcessing image {i}...")
            self._log(f"Feature matches: {int(n_match_h[i - 1])}")
            if i in skip_reason:
                self._log(f"  Skipping - {skip_reason[i]}")
                continue
            if i in scale_warn:
                self._log("  Warning: Not enough valid points for scale, "
                          "using previous")
            self._log(f"  Camera {i}: {int(counts[i])} points "
                      f"(scale {view_scale[i]:.4f})")

        # ---- Step 5: merge --------------------------------------------------
        self._log("\n--- Step 5: Merge and clean point cloud ---")
        self._log(f"\nFinal reconstruction: {len(points)} points, "
                  f"{len(self.camera_poses)} cameras")
        return points, colors, self.camera_poses

    def save_reconstruction(self, points: np.ndarray, colors: np.ndarray,
                            output_path: str):
        if points is None or len(points) == 0:
            self._log("No points to save")
            return
        os.makedirs(os.path.dirname(os.path.abspath(output_path)),
                    exist_ok=True)
        write_ply(output_path, points, colors / 255.0)
        self._log(f"Saved to {output_path}")


class SparseReconstructor:
    """Reference-named facade (depth_to_reconstruction.py:122-271): CLAHE +
    SIFT detection / matching, essential-matrix pose, triangulation and
    point filtering on the port's ops."""

    def __init__(self, config: Optional[ReconstructionConfig] = None,
                 feature_capacity: int = 8192, device=None):
        self.config = config or ReconstructionConfig()
        self.device = resolve_device(device)
        self.detector = SIFTDetector(capacity=feature_capacity,
                                     device=self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32)).to(self.device)

    def detect_and_match(self, img1: np.ndarray, img2: np.ndarray):
        """Returns (pts1 (M, 2), pts2 (M, 2), n_matches) on the host."""
        f1 = self.detector.detect(img1)
        f2 = self.detector.detect(img2)
        uv1, uv2, mask = (a.cpu().numpy() for a in
                          match_features(f1, f2, self.config.match_ratio))
        return uv1[mask], uv2[mask], int(mask.sum())

    def compute_pose(self, pts1: np.ndarray, pts2: np.ndarray):
        """Returns (R, t, inlier_mask) or (None, None, None) on failure."""
        if len(pts1) < 8:
            return None, None, None
        cap = 1 << max(8, int(np.ceil(np.log2(len(pts1)))))
        a = np.zeros((cap, 2), np.float32)
        a[:len(pts1)] = pts1
        b = np.zeros((cap, 2), np.float32)
        b[:len(pts2)] = pts2
        m = np.zeros((cap,), bool)
        m[:len(pts1)] = True
        R, t, X, valid, n_inl = pair_step(
            self._t(a), self._t(b), torch.from_numpy(m).to(self.device),
            self._t(self.config.K), self.generator,
            self.config.ransac_threshold, self.config.min_depth,
            self.config.max_depth)
        if int(n_inl) < 8:
            return None, None, None
        self._last = (X.cpu().numpy()[:len(pts1)],
                      valid.cpu().numpy()[:len(pts1)])
        return R.cpu().numpy(), t.cpu().numpy(), self._last[1]

    def _projections(self, R, t):
        K = self.config.K.astype(np.float32)
        P1 = (K @ np.hstack([np.eye(3), np.zeros((3, 1))])).astype(np.float32)
        P2 = (K @ np.hstack([np.asarray(R).reshape(3, 3),
                             np.asarray(t).reshape(3, 1)])).astype(np.float32)
        return self._t(P1), self._t(P2)

    @f32_dots
    def triangulate(self, pts1, pts2, R, t):
        """DLT triangulation under (I|0) and (R|t)."""
        P1, P2 = self._projections(R, t)
        return triangulate(P1, P2, self._t(pts1), self._t(pts2)).cpu().numpy()

    @f32_dots
    def filter_points(self, points_3d, pts1, pts2, R, t,
                      max_error: float = 5.0):
        """Positive depth in both cameras + reprojection < max_error px."""
        cfg = self.config
        P1, P2 = self._projections(R, t)
        X = self._t(points_3d)
        e1 = reprojection_error(P1, X, self._t(pts1)).cpu().numpy()
        e2 = reprojection_error(P2, X, self._t(pts2)).cpu().numpy()
        pts = np.asarray(points_3d)
        z1 = pts[:, 2]
        z2 = pts @ np.asarray(R).reshape(3, 3)[2] + np.asarray(t).reshape(3)[2]
        return ((z1 > cfg.min_depth) & (z1 < cfg.max_depth)
                & (z2 > cfg.min_depth) & (e1 < max_error) & (e2 < max_error))


class DenseReconstructor:
    """Reference-named facade (depth_to_reconstruction.py:274-420)."""

    def __init__(self, config: Optional[ReconstructionConfig] = None,
                 device=None):
        self.config = config or ReconstructionConfig()
        self.device = resolve_device(device)

    def estimate_scale(self, sparse_points, sparse_2d, depth_map) -> float:
        dev = self.device
        pts = torch.as_tensor(np.asarray(sparse_points, np.float32)).to(dev)
        uv = torch.as_tensor(np.asarray(sparse_2d, np.float32)).to(dev)
        mask = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        s = estimate_scale(pts, uv, mask,
                           torch.as_tensor(np.asarray(depth_map)).to(dev),
                           min_points=0, per_sample_clamp=True)
        return float(clamp_scale(s))

    def depth_to_pointcloud(self, depth, color, pose=None, scale: float = 1.0,
                            subsample: int = 2):
        cfg = self.config
        R, t = pose if pose is not None else (np.eye(3), np.zeros(3))
        ps = depth_to_pointcloud(depth, color, np.asarray(R),
                                 np.asarray(t).reshape(3), cfg.fx, cfg.fy,
                                 cfg.cx, cfg.cy, scale=scale,
                                 subsample=subsample,
                                 min_depth=cfg.min_depth,
                                 max_depth=cfg.max_depth, device=self.device)
        xyz, rgb = ps.to_numpy()
        return xyz, rgb * 255.0

    def merge_pointclouds(self, clouds, voxel_size: float = 0.005):
        return merge_pointclouds(
            clouds, voxel_size=voxel_size,
            outlier_neighbors=self.config.outlier_neighbors,
            outlier_std_ratio=self.config.outlier_std_ratio,
            device=self.device)
