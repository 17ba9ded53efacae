"""End-to-end depth-enhanced reconstruction, the counterpart of
``txr/pipelines/enhanced_pipeline.py`` (reference
DepthEnhancedReconstruction, depth_enhanced_reconstruction.py:896-1311).

Per-image depth (one batched forward of the depth model), hybrid features
(``geometry/hybrid.py``), depth-filtered matching on the host, then three
device stages: ``_enh_pairs_batch`` (fundamental RANSAC at 3 px gates the
matches, then ``pair_step``: essential / homography pose, triangulation and
the filter <8 px, 0.1 < Z < 100), ``_enh_scales_batch`` (world-frame sparse
points and per-view metric scales) and ``_enh_dense_merge`` (back-projection
at subsample 4 and a voxel-0.005 merge whose segment sums are the
segmented-scan kernel on the card; no statistical outlier pass, this CLI's
merge differs from depth_to_reconstruction's). The host chains the poses
with the reference's skip rules and the 0.7 / 0.3 scale EMA, and can run
bundle adjustment (``geometry/bundle_adjustment.py``) before the merge.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from txr_torch.core.device import resolve_device
from txr_torch.core.precision import f32_dots
from txr_torch.core.types import PointSet, concatenate
from txr_torch.fusion.pointcloud import backproject_views, merge_pointclouds
from txr_torch.geometry.epipolar import fundamental_ransac
from txr_torch.geometry.hybrid import (DepthGuidedMatcher,
                                       HybridFeatureDetector)
from txr_torch.geometry.scale import clamp_scale, estimate_scale
from txr_torch.io.opencv import require_cv2
from txr_torch.io.ply import write_ply
from txr_torch.ops.voxel import voxel_downsample
from txr_torch.pipelines.fusion_pipeline import (_seq_chunk,
                                                 dense_chunk_views,
                                                 pair_step, sparse_to_world)

MATCH_CAPACITY = 4096
MIN_DEPTH, MAX_DEPTH = 0.1, 100.0


def _enh_pair(a, b, m, K, generator, priorities=None):
    """RANSAC-F gates one pair's matches, then ``pair_step`` (reference
    :998-1052 and the essential pose with triangulation and the filter
    <8 px, 0.1 < Z < 100). priorities: optional (3, hypotheses, rows): the
    fundamental, essential and homography draws."""
    pf, pe, ph = (None, None, None) if priorities is None else priorities
    _, inliers = fundamental_ransac(a, b, m, generator, threshold=3.0,
                                    priorities=pf)
    mm = m & inliers
    R, t, X, valid, n_inl = pair_step(
        a, b, mm, K, generator, 2.0, MIN_DEPTH, MAX_DEPTH, 8.0,
        priorities=None if priorities is None else (pe, ph))
    return R, t, X, valid, n_inl, mm.sum()


@torch.no_grad()
def _enh_pairs_batch(A: torch.Tensor, B: torch.Tensor, M: torch.Tensor,
                     K: torch.Tensor, run: List[bool],
                     generator: Optional[torch.Generator],
                     priorities: Optional[torch.Tensor] = None):
    """``_enh_pair`` for every pair whose ``run`` is True, in pair order
    (each draws fundamental, then essential and homography priorities from
    ``generator``, or takes ``priorities[p]``). A pair that does not run
    (fewer than 8 raw matches: the host chain never reads it) gets zeros
    and draws nothing. Returns (R, t, X, valid, n_inl, n_f), each with a
    leading pair axis, on the device."""
    cap = A.shape[1]
    dev = A.device
    zero = (torch.eye(3, device=dev), torch.zeros(3, device=dev),
            torch.zeros((cap, 3), device=dev),
            torch.zeros(cap, dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))
    outs = []
    for p in range(A.shape[0]):
        if not run[p]:
            outs.append(zero)
            continue
        prio = None if priorities is None else priorities[p]
        outs.append(_enh_pair(A[p], B[p], M[p], K, generator, prio))
    return tuple(torch.stack(col) for col in zip(*outs))


@f32_dots
def _enh_scales_batch(X, valid, b_uv, depths_next, R_prev, t_prev):
    """World-frame sparse points and per-view scale estimates for a slab
    of pairs: X / valid / b_uv (P, cap, ...), depths_next[p] the depth of
    view p + 1, R_prev / t_prev the last chained pose before it. Returns
    (Xw, ok, clamped scale (P,), valid count (P,))."""
    Xw, ok = sparse_to_world(X, valid, R_prev, t_prev)
    s = estimate_scale(Xw, b_uv, ok, depths_next)
    return Xw, ok, clamp_scale(s), ok.sum(-1)


@torch.no_grad()
def _enh_dense_merge(depths: torch.Tensor, bgrs: torch.Tensor,
                     Rs: torch.Tensor, ts: torch.Tensor,
                     scales: torch.Tensor, keep: torch.Tensor,
                     extra: PointSet, *, fx, fy, cx, cy, subsample: int,
                     voxel_size: float):
    """Back-project every kept view, add the sparse points as extra rows and
    voxel-merge on the device (no outlier pass, reference :1149). Returns
    (merged PointSet, per-view counts (V,))."""
    flat, counts = backproject_views(depths, bgrs, Rs, ts, scales, keep, fx,
                                     fy, cx, cy, MIN_DEPTH, MAX_DEPTH,
                                     subsample)
    return voxel_downsample(concatenate([flat, extra]), voxel_size), counts


class DepthEnhancedReconstruction:
    """images folder -> depth + hybrid features + SfM from scratch -> fused
    PLY.

    device: where the pipeline runs (``None``: the CUDA device, which must
    be present; ``"cpu"`` runs the plain versions). depth_model: any object
    with ``infer_batch`` / ``infer`` (default: Depth Anything V2 ViT-L in
    bf16 on ``device``, built at first use). RANSAC draws come from a
    ``torch.Generator`` seeded 0 on the device, advancing with each call.
    """

    def __init__(self, K: np.ndarray, use_depth: bool = True,
                 use_hybrid_features: bool = True, depth_model=None,
                 verbose: bool = True, subsample: int = 4,
                 voxel_size: float = 0.005, use_ba: bool = False,
                 ba_iterations: int = 15, feature_backend: str = "auto",
                 quant: str = "none", device=None):
        self.K = np.asarray(K, np.float64)
        self.device = resolve_device(device)
        self.use_depth = use_depth
        self.use_hybrid = use_hybrid_features
        self.verbose = verbose
        self.subsample = subsample
        self.voxel_size = voxel_size
        self.use_ba = use_ba
        self.ba_iterations = ba_iterations
        self.quant = quant

        self.images: List[np.ndarray] = []
        self.image_names: List[str] = []
        self.depths: List[Optional[np.ndarray]] = []
        self.features: List = []
        self.camera_poses: List[Tuple[np.ndarray, np.ndarray]] = []
        self.sparse_points = np.zeros((0, 3), np.float32)
        self.sparse_colors = np.zeros((0, 3), np.float32)

        self.detector = HybridFeatureDetector(
            use_orb=use_hybrid_features, use_lines=use_hybrid_features,
            use_edges=use_hybrid_features, verbose=verbose,
            backend=feature_backend, device=self.device)
        self.depth_matcher = DepthGuidedMatcher()
        self._depth_model = depth_model
        self.generator = torch.Generator(device=self.device).manual_seed(0)

    def _log(self, msg):
        if self.verbose:
            print(msg)

    # ---------------------------------------------------------------- I/O

    def load_images(self, folder: str) -> int:
        """The folder's images in name order, read with OpenCV (which must
        be installed when there is an image to read)."""
        files = []
        for ext in ("jpg", "jpeg", "png", "bmp", "JPG", "PNG"):
            files.extend(glob.glob(os.path.join(folder, f"*.{ext}")))
        for path in sorted(set(files)):
            cv2 = require_cv2(f"reading the image {os.path.basename(path)}")
            img = cv2.imread(path)
            if img is None:
                continue
            self.images.append(img)
            self.image_names.append(os.path.basename(path))
        self._log(f"Loaded {len(self.images)} images from {folder}")
        return len(self.images)

    # ---------------------------------------------------------- stage fns

    def estimate_all_depths(self):
        if not self.use_depth:
            self.depths = [None] * len(self.images)
            return
        if self._depth_model is None:
            from txr_torch.models.depth_anything import DepthAnythingModel

            # reference DepthEstimator: DA-V2-Large
            # (depth_enhanced_reconstruction.py:108-134)
            self._depth_model = DepthAnythingModel(
                version="v2", encoder="vitl", quant=self.quant,
                device=self.device)
        self._log("Estimating depth maps...")
        shapes = {im.shape[:2] for im in self.images}
        if len(shapes) == 1 and len(self.images) > 1:
            d = self._depth_model.infer_batch(np.stack(self.images))
            self.depths = [d[i] for i in range(len(self.images))]
        else:
            self.depths = [self._depth_model.infer(im) for im in self.images]
        self._log(f"  Depth maps: {len(self.depths)}")

    def detect_all_features(self):
        self._log("Detecting features...")
        if self.detector.backend == "device":
            self.features = self.detector.detect_batch(self.images)
            for i in range(len(self.features)):
                self._log(f" Image {i}: (batched detect)")
        else:
            self.features = []
            for i, im in enumerate(self.images):
                self._log(f" Image {i}:")
                self.features.append(self.detector.detect(im))

    def match_image_pair(self, i: int, j: int,
                         priorities: Optional[torch.Tensor] = None):
        """Hybrid match -> depth filter -> RANSAC-F (reference :998-1052).
        Returns the inlier (pts1, pts2). priorities: optional
        (hypotheses, MATCH_CAPACITY) fundamental draw."""
        pts1, pts2 = self._match_pair_host(i, j)
        if len(pts1) < 8:
            return pts1, pts2
        pts1, pts2 = pts1[:MATCH_CAPACITY], pts2[:MATCH_CAPACITY]
        a, b, m = self._padded(pts1, pts2)
        _, inliers = fundamental_ransac(
            a, b, m, self.generator, threshold=3.0,
            priorities=None if priorities is None
            else priorities.to(self.device))
        inl = inliers.cpu().numpy()[:len(pts1)]
        self._log(f"  RANSAC-F inliers: {int(inl.sum())}/{len(pts1)}")
        return pts1[inl], pts2[inl]

    def _padded(self, pts1: np.ndarray, pts2: np.ndarray):
        n = min(len(pts1), MATCH_CAPACITY)
        a = np.zeros((MATCH_CAPACITY, 2), np.float32)
        b = np.zeros((MATCH_CAPACITY, 2), np.float32)
        m = np.zeros((MATCH_CAPACITY,), bool)
        a[:n], b[:n], m[:n] = pts1[:n], pts2[:n], True
        return tuple(torch.from_numpy(x).to(self.device) for x in (a, b, m))

    def _match_pair_host(self, i: int, j: int):
        """Host part of pair matching: hybrid match + depth filter."""
        pts1, pts2 = self.detector.match_features(self.features[i],
                                                  self.features[j])
        if len(pts1) < 8:
            return pts1, pts2
        if self.use_depth and self.depths[i] is not None:
            pts1, pts2 = self.depth_matcher.filter_matches_by_depth(
                pts1, pts2, self.depths[i], self.depths[j])
        return pts1, pts2

    def _on_dev(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _depth_slab(self, lo: int, hi: int, h: int, w: int) -> np.ndarray:
        """Depths of views lo..hi-1 zero-padded to (hi - lo, h, w): views
        past the sequence or without depth read 0 (below min_depth)."""
        slab = np.zeros((hi - lo, h, w), np.float32)
        for i in range(lo, min(hi, len(self.images))):
            d = self.depths[i]
            if d is not None:
                slab[i - lo, :d.shape[0], :d.shape[1]] = d
        return slab

    # ------------------------------------------------------------ pipeline

    def reconstruct(self, output_dir: str = "./output",
                    priorities: Optional[torch.Tensor] = None):
        """Run the pipeline and write ``output_dir/reconstruction.ply``.
        Returns (points, colors[0..255], poses), or None.

        priorities: optional (P, 3, hypotheses, MATCH_CAPACITY) RANSAC
        priorities for P >= the pair count (``txr`` pads the pairs to a
        power of two; rows past the pairs are ignored): per pair the
        fundamental, essential and homography draws, in the order of
        ``txr``'s key chain (a pair with at least 8 raw matches draws F,
        then its pose key). None draws them from ``self.generator``; a pair
        with fewer than 8 raw matches draws nothing and is not run (``txr``
        runs it on a fixed dummy key and discards the result)."""
        if len(self.images) < 2:
            self._log("Need at least 2 images")
            return None

        os.makedirs(output_dir, exist_ok=True)
        self.estimate_all_depths()
        self.detect_all_features()

        dev = self.device
        K = self._on_dev(self.K.astype(np.float32))
        n = len(self.images)
        n_pairs = n - 1

        # ---- host: hybrid match + depth filter for every consecutive pair
        A = np.zeros((n_pairs, MATCH_CAPACITY, 2), np.float32)
        B = np.zeros((n_pairs, MATCH_CAPACITY, 2), np.float32)
        M = np.zeros((n_pairs, MATCH_CAPACITY), bool)
        n_raw = np.zeros(n_pairs, np.int64)
        self._log("\nMatching initial pair...")
        for p in range(n_pairs):
            if p >= 1:
                self._log(f"\nProcessing image {p + 1}...")
            pts1, pts2 = self._match_pair_host(p, p + 1)
            n_raw[p] = len(pts1)
            c = min(len(pts1), MATCH_CAPACITY)
            A[p, :c], B[p, :c], M[p, :c] = pts1[:c], pts2[:c], True

        # ---- stage 1: RANSAC-F + pose / structure for all pairs ----------
        R_rel, t_rel, X, valid, n_inl, n_f = _enh_pairs_batch(
            self._on_dev(A), self._on_dev(B), self._on_dev(M), K,
            [bool(k >= 8) for k in n_raw], self.generator,
            None if priorities is None else priorities.to(dev))
        R_rel_h, t_rel_h, n_inl_h, n_f_h = (
            a.cpu().numpy() for a in (R_rel, t_rel, n_inl, n_f))

        for p in range(n_pairs):
            if n_raw[p] >= 8:
                self._log(f"  RANSAC-F inliers (pair {p}): "
                          f"{int(n_f_h[p])}/{int(n_raw[p])}")

        if min(n_raw[0], n_f_h[0]) < 8:
            self._log("Insufficient matches for initialization")
            return None
        valid0 = valid[0].cpu().numpy()
        self._log(f"Pose inliers: {int(n_inl_h[0])}; "
                  f"valid sparse: {int(valid0.sum())}")

        self.camera_poses = [(np.eye(3, dtype=np.float32),
                              np.zeros(3, np.float32)),
                             (R_rel_h[0], t_rel_h[0])]
        # image index -> pose index (views can be skipped)
        pose_of_image = {0: 0, 1: 1}
        view_scales = {}

        # host pose chain with the reference's skip rules (:1171-1238)
        R_prev = np.tile(np.eye(3, dtype=np.float32), (n_pairs, 1, 1))
        t_prev = np.zeros((n_pairs, 3), np.float32)
        prev_pose_of_pair = {}
        for i in range(2, n):
            p = i - 1
            if min(n_raw[p], n_f_h[p]) < 8:
                self._log(f"  Skipping image {i} - insufficient matches")
                continue
            if int(n_inl_h[p]) < 8:
                self._log(f"  Skipping image {i} - insufficient inliers")
                continue
            Rp, tp = self.camera_poses[-1]
            prev_pose_of_pair[p] = len(self.camera_poses) - 1
            R_prev[p], t_prev[p] = Rp, tp
            self.camera_poses.append((R_rel_h[p] @ Rp,
                                      R_rel_h[p] @ tp + t_rel_h[p]))
            pose_of_image[i] = len(self.camera_poses) - 1

        # ---- stage 2: world-frame sparse + per-view scales ---------------
        scale = 1.0
        need_scales = self.use_depth and self.depths[0] is not None
        # the EMA chain reads the scales of ANY later view with depth, so
        # the stage also runs when only views >= 2 have depth
        later_depth = self.use_depth and any(
            self.depths[i] is not None for i in range(2, n))
        if need_scales or later_depth or self.use_ba:
            # depths padded to the largest frame; matched uv never lands in
            # the pad. Slabs of TXR_SEQ_CHUNK pairs bound the (views, H, W)
            # depth stack; per-pair math is independent.
            h = max(im.shape[0] for im in self.images)
            w = max(im.shape[1] for im in self.images)
            cp = _seq_chunk()
            sw_l, okn_l, Xw_l, ok_l = [], [], [], []
            for s in range(0, n_pairs, cp):
                e = min(s + cp, n_pairs)
                Xw_c, ok_c, sw_c, okn_c = _enh_scales_batch(
                    X[s:e], valid[s:e], self._on_dev(B[s:e]),
                    self._on_dev(self._depth_slab(s + 1, e + 1, h, w)),
                    self._on_dev(R_prev[s:e]), self._on_dev(t_prev[s:e]))
                sw_l.append(sw_c.cpu().numpy())
                okn_l.append(okn_c.cpu().numpy())
                if self.use_ba:
                    Xw_l.append(Xw_c.cpu().numpy())
                    ok_l.append(ok_c.cpu().numpy())
            sw_h = np.concatenate(sw_l)
            okn_h = np.concatenate(okn_l)

        if need_scales:
            s0, s1 = (clamp_scale(estimate_scale(
                X[0], self._on_dev(uv[0]), valid[0],
                self._on_dev(self.depths[v]))) for uv, v in ((A, 0), (B, 1)))
            scale = float((s0 + s1) / 2.0)
            self._log(f"Depth scale estimate: {scale:.6f}")
        view_scales[0] = view_scales[1] = scale

        # scale EMA chain over the processed views (reference :1221-1238)
        for i in range(2, n):
            p = i - 1
            if i not in pose_of_image:
                continue
            if self.use_depth and self.depths[i] is not None:
                if int(okn_h[p]) >= 3:
                    scale = 0.7 * scale + 0.3 * float(sw_h[p])
                view_scales[i] = scale
                self._log(f"  Camera {i}: pose chained (scale {scale:.4f})")

        # BA bookkeeping: sparse world points + their 2-view observations
        ba_points: List[np.ndarray] = []
        ba_obs: List[tuple] = []

        def collect_ba(Xw_np, ok_np, uv_a, uv_b, pose_a, pose_b):
            base = sum(len(q) for q in ba_points)
            sel = np.where(ok_np)[0]
            ba_points.append(Xw_np[sel])
            for j, s in enumerate(sel):
                ba_obs.append((pose_a, base + j, uv_a[s]))
                ba_obs.append((pose_b, base + j, uv_b[s]))

        X0 = X[0].cpu().numpy()
        if self.use_ba:
            collect_ba(X0, valid0, A[0], B[0], 0, 1)
            Xw_h, ok_h = np.concatenate(Xw_l), np.concatenate(ok_l)
            for i in range(2, n):
                p = i - 1
                if i in pose_of_image:
                    collect_ba(Xw_h[p], ok_h[p], A[p], B[p],
                               prev_pose_of_pair[p], pose_of_image[i])

        # sparse points of the initial pair, coloured at the image-0
        # keypoints (the reference always keeps them in the final cloud,
        # depth_enhanced_reconstruction.py:1108-1165)
        sp_xyz = X0[valid0]
        uv0 = np.clip(A[0][valid0].astype(np.int32), 0,
                      [self.images[0].shape[1] - 1,
                       self.images[0].shape[0] - 1])
        sp_bgr = self.images[0][uv0[:, 1], uv0[:, 0]].astype(np.float32)
        if sp_bgr.ndim == 1:  # grey source
            sp_rgb = np.repeat(sp_bgr[:, None], 3, axis=1)
        else:
            sp_rgb = sp_bgr[:, ::-1]  # BGR -> RGB
        self.sparse_points = sp_xyz
        self.sparse_colors = sp_rgb

        # ---- bundle adjustment (declared by the reference but never run,
        # depth_enhanced_reconstruction.py:45-50) ---------------------------
        self.ba_history = None
        if self.use_ba and ba_points and sum(len(q) for q in ba_points) >= 10:
            from txr_torch.geometry.bundle_adjustment import (build_problem,
                                                              bundle_adjust)

            Xall = np.concatenate(ba_points).astype(np.float32)
            prob = build_problem(self.camera_poses, Xall, ba_obs, device=dev)
            Rba, tba, _, hist = bundle_adjust(prob, K,
                                              iterations=self.ba_iterations)
            self.ba_history = hist.cpu().numpy()
            self._log(f"\nBundle adjustment: reprojection RMS "
                      f"{float(self.ba_history[0]):.3f} -> "
                      f"{float(self.ba_history[-1]):.3f} px "
                      f"({len(Xall)} points, {len(ba_obs)} observations)")
            Rba, tba = Rba.cpu().numpy(), tba.cpu().numpy()
            self.camera_poses = [(Rba[i], tba[i])
                                 for i in range(len(self.camera_poses))]

        # ---- stage 3: dense clouds + device voxel merge -------------------
        fx, fy = float(self.K[0, 0]), float(self.K[1, 1])
        cx, cy = float(self.K[0, 2]), float(self.K[1, 2])
        have_dense = self.use_depth and any(
            self.depths[i] is not None for i in pose_of_image)
        if have_dense:
            points, colors = self._dense(pose_of_image, view_scales, scale,
                                         fx, fy, cx, cy)
        else:
            # sparse-only fallback (reference :1155-1165): voxel merge of
            # the pair-0 sparse points
            if not len(self.sparse_points):
                self._log("No sparse or dense points — nothing to merge")
                return None
            points, colors = merge_pointclouds(
                [(self.sparse_points.astype(np.float32),
                  self.sparse_colors.astype(np.float32))],
                voxel_size=self.voxel_size, remove_outliers=False,
                device=dev)
        self._log(f"\nFinal: {len(points)} points, "
                  f"{len(self.camera_poses)} cameras")

        out_path = os.path.join(output_dir, "reconstruction.ply")
        self._save_pointcloud(points, colors, out_path)
        return points, colors, self.camera_poses

    def _dense(self, pose_of_image: dict, view_scales: dict, scale: float,
               fx: float, fy: float, cx: float, cy: float):
        """Every posed view with depth back-projected and merged with the
        sparse points; one device call up to TXR_DENSE_SINGLE_ROWS rows,
        the chunked exact merge beyond. Returns host (points, colors
        0..255)."""
        n = len(self.images)
        h = max(im.shape[0] for im in self.images)
        w = max(im.shape[1] for im in self.images)
        depth_list, img_list = [None] * n, [None] * n
        Rs = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        ts = np.zeros((n, 3), np.float32)
        sc = np.ones((n,), np.float32)
        keep = np.zeros((n,), bool)
        for i, pose_idx in pose_of_image.items():
            if self.depths[i] is None:
                continue
            depth_list[i], img_list[i] = self.depths[i], self.images[i]
            Rs[i], ts[i] = self.camera_poses[pose_idx]
            sc[i] = view_scales.get(i, scale)
            keep[i] = True
        ns = min(len(self.sparse_points), MATCH_CAPACITY)
        sp_xyz = np.zeros((MATCH_CAPACITY, 3), np.float32)
        sp_rgb = np.zeros((MATCH_CAPACITY, 3), np.float32)
        sp_m = np.zeros((MATCH_CAPACITY,), bool)
        sp_xyz[:ns] = self.sparse_points[:ns]
        sp_rgb[:ns] = self.sparse_colors[:ns] / 255.0
        sp_m[:ns] = True
        extra = PointSet(self._on_dev(sp_xyz), self._on_dev(sp_rgb),
                         self._on_dev(sp_m))
        ss = int(self.subsample)
        rows_per_view = -(-h // ss) * -(-w // ss)
        single_rows = int(os.environ.get("TXR_DENSE_SINGLE_ROWS",
                                         str(1 << 24)))
        cam = dict(fx=fx, fy=fy, cx=cx, cy=cy)
        if n * rows_per_view <= single_rows:
            bgrs = np.zeros((n, h, w, 3), np.uint8)
            for i, im in enumerate(img_list):
                if im is not None:
                    bgrs[i, :im.shape[0], :im.shape[1]] = im
            merged, counts_d = _enh_dense_merge(
                self._on_dev(self._depth_slab(0, n, h, w)),
                self._on_dev(bgrs), self._on_dev(Rs), self._on_dev(ts),
                self._on_dev(sc), self._on_dev(keep), extra, subsample=ss,
                voxel_size=float(self.voxel_size), **cam)
            counts = counts_d.cpu().numpy()
        else:
            # long sequences: the chunked exact merge
            # (fusion/chunked_merge.py); the sparse points join its final
            # reduce as weight-1 rows, as in the single call
            from txr_torch.fusion.chunked_merge import \
                chunked_dense_voxel_merge

            chunk_views = dense_chunk_views(single_rows, rows_per_view)
            merged, counts = chunked_dense_voxel_merge(
                depth_list, img_list, Rs, ts, sc, keep,
                min_depth=MIN_DEPTH, max_depth=MAX_DEPTH, subsample=ss,
                voxel_size=float(self.voxel_size),
                chunk_views=min(chunk_views, n), extra=extra,
                device=self.device, **cam)
        for i in sorted(pose_of_image):
            if keep[i]:
                self._log(f"Camera {i}: {int(counts[i])} dense points")
        points, colors = merged.to_numpy()
        return points, colors * 255.0

    def _save_pointcloud(self, points, colors, path):
        if points is None or len(points) == 0:
            self._log("No points to save")
            return
        write_ply(path, points, colors / 255.0)
        self._log(f"Saved to {path}")
