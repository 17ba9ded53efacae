"""Streaming SLAM-like reconstruction, the counterpart of the stepwise path
of ``txr/pipelines/streaming.py`` (behind ``reconstruction_torch.py``).

Per frame, on the device:

  frame -> depth (any model with ``infer(bgr, intrinsics)``) -> SIFT
       -> ratio matching + essential / homography ``pair_step`` against the
          previous frame, metric-scale EMA from the depth anchor
       -> (optional) point-to-plane ICP against the map (the textureless
          rescue) -> back-projection -> insert into the packed voxel map
          (the fused-reduce scan kernel on the card)

Pose strategy follows the reference launch graph's frame-to-frame odometry
with MinInliers 15 (slam.launch.py:115-121): the feature pose when the
matches carry it; ICP against the map refines it, or replaces it when
matching fails. With ICP off, a failed frame is skipped and the stream
goes on.

Loop closure (rtabmap_slam's role, slam.launch.py:126-145): every
``keyframe_every`` fused frames a keyframe keeps its features, an
appearance sketch and a camera-frame cloud. A new keyframe is matched
against the old ones that its sketch gates in (skipping the newest
``loop_min_separation``); an accepted match, tightened by ICP between the
two keyframe clouds, becomes a pose-graph edge, the keyframe trajectory is
re-optimised by SE(3) Gauss-Newton (``geometry/pose_graph.py``), the
corrections carry over to the frames between keyframes, and the map is
re-fused from the keyframe clouds. Keyframes older than the working set
move to host memory and come back to the device when a closure needs them.

RANSAC draws come from a ``torch.Generator`` seeded 0 on the device, or
from ``priorities``, a callable ``priorities(count, num_hypotheses, rows)``
that returns (2, num_hypotheses, rows) essential and homography priorities
for one odometry pair when ``count`` is None, and (count, 2,
num_hypotheses, rows) for a chunk of ``count`` loop candidates (a chunk
takes one draw whatever the number of real candidates in it).
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from txr_torch.core.config import StreamingConfig
from txr_torch.core.device import resolve_device
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.core.precision import f32_dots
from txr_torch.core.types import PointSet
from txr_torch.fusion.occupancy import occupancy_grid, write_occupancy_map
from txr_torch.fusion.offset_map import (OffsetVoxelMap, create_offset_map,
                                         offset_map_insert, offset_map_points,
                                         offset_map_size)
from txr_torch.geometry.appearance import (appearance_scores,
                                           appearance_sketch)
from txr_torch.geometry.features import (Features, SIFTDetector,
                                         match_features)
from txr_torch.geometry.icp import estimate_normals, icp_point_to_plane
from txr_torch.geometry.pose_graph import optimize_pose_graph
from txr_torch.geometry.scale import clamp_scale, ema_scale, estimate_scale
from txr_torch.io.ply import write_ply
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.matching import match_l2_ratio
from txr_torch.pipelines.fusion_pipeline import _compact, pair_step

logger = logging.getLogger(__name__)

MIN_INLIERS = 15  # rtabmap rgbd_odometry Vis/MinInliers (slam.launch.py:115)
# Loop pairs are distant frames: a few hundred ratio-test matches survive
# of the feature capacity, so verification runs on the first VCAP matched
# rows (matched rows first, each group in index order) with 512 hypotheses.
VCAP = 512
LOOP_HYPOTHESES = 512

Priorities = Callable[[Optional[int], int, int], torch.Tensor]


def _to_device(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(device)


class StreamingReconstructor:
    """Incremental frame-by-frame reconstruction into a voxel map.

    device: where the map, features and frames live (None: the CUDA
    device, which must be present); SIFT runs on it (OpenCV's on the CPU
    when installed, ``geometry/features.py:resolve_backend``).
    """

    def __init__(
        self,
        intrinsics: CameraIntrinsics,
        depth_model=None,
        config: Optional[StreamingConfig] = None,
        use_icp: bool = True,
        metric_depth: bool = False,
        feature_capacity: int = 4096,
        icp_sample: int = 4096,
        verbose: bool = True,
        device=None,
        priorities: Optional[Priorities] = None,
    ):
        self.device = resolve_device(device)
        self.intr = intrinsics
        self.cfg = config or StreamingConfig()
        self.depth_model = depth_model
        self.use_icp = use_icp
        self.metric_depth = metric_depth
        self.verbose = verbose
        self.detector = SIFTDetector(n_features=3000,
                                     capacity=feature_capacity,
                                     device=self.device)
        self.icp_sample = icp_sample
        self.K = torch.from_numpy(
            intrinsics.to_matrix().astype(np.float32)).to(self.device)

        cap = 1 << int(np.ceil(np.log2(self.cfg.max_map_points)))
        self.map: OffsetVoxelMap = create_offset_map(
            cap, self.cfg.voxel_size, self.device)

        self.poses: List[Tuple[np.ndarray, np.ndarray]] = []
        self.scale = 1.0
        self._prev_features = None
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.priorities = priorities
        self.frames_processed = 0
        self.frames_skipped = 0
        self.icp_accepted = 0
        # Loop closure state: keyframes carry features + a camera-frame
        # cloud so the map can be re-fused after graph optimisation.
        self.keyframes: List[dict] = []
        self.loops_closed = 0
        self.loop_edges: List[Tuple[int, int]] = []

    def _log(self, msg):
        if self.verbose:
            logger.info(msg)

    def _draw(self, count: Optional[int], hypotheses: int, rows: int):
        """The next RANSAC priorities from ``priorities`` (None: pair_step
        draws from the generator)."""
        if self.priorities is None:
            return None
        return torch.as_tensor(self.priorities(count, hypotheses, rows)
                               ).to(self.device)

    def _depth_scale(self) -> float:
        return self.scale if not self.metric_depth else 1.0

    # ----------------------------------------------------------------- steps

    @f32_dots
    def _estimate_pose_features(self, feats: Features, depth: torch.Tensor):
        """Essential-matrix relative pose against the previous frame.
        Returns (R_rel, t_rel, n_inliers, scale_estimate or None)."""
        uv1, uv2, mask = match_features(self._prev_features, feats,
                                        ratio=0.75)
        R, t, X, valid, n_inl = pair_step(
            uv1, uv2, mask, self.K, self.generator, 2.0, self.cfg.min_depth,
            self.cfg.max_depth * 10,
            priorities=self._draw(None, 1024, uv1.shape[0]))
        scale_i = None
        if not self.metric_depth and int(valid.sum()) >= 5:
            # X is in the previous camera's frame; the depth pairs with the
            # CURRENT frame's pixels, so transform first.
            X_curr = X @ R.T + t
            scale_i = float(clamp_scale(estimate_scale(X_curr, uv2, valid,
                                                       depth)))
        return (R.cpu().numpy(), t.cpu().numpy(), int(n_inl), scale_i)

    def _backproject(self, depth: torch.Tensor, rgb: torch.Tensor, R, t
                     ) -> PointSet:
        return backproject_world(
            depth, rgb, _to_device(R, self.device),
            _to_device(t, self.device), self.intr.fx, self.intr.fy,
            self.intr.cx, self.intr.cy, self.cfg.min_depth,
            self.cfg.max_depth, self._depth_scale(),
            self.cfg.subsample_factor)

    def _refine_icp(self, points_world: PointSet, R_w2c, t_w2c):
        """Refine the world->camera pose by registering the frame cloud onto
        the current map (point-to-plane ICP on subsampled sets)."""
        map_pts = offset_map_points(self.map)
        sstep = max(1, points_world.capacity // self.icp_sample)
        n = self.icp_sample
        src = PointSet(points_world.xyz[::sstep][:n],
                       points_world.rgb[::sstep][:n],
                       points_world.mask[::sstep][:n])
        # Strided subsample: the map is sorted by voxel key, so a prefix
        # would be one spatial corner of the scene.
        tcap = min(self.icp_sample * 4, map_pts.capacity)
        tstep = max(1, map_pts.capacity // tcap)
        tgt = PointSet(map_pts.xyz[::tstep][:tcap],
                       map_pts.rgb[::tstep][:tcap],
                       map_pts.mask[::tstep][:tcap])
        if int(tgt.count()) < 100 or int(src.count()) < 100:
            return R_w2c, t_w2c, None
        normals = estimate_normals(tgt.xyz, tgt.mask, k=8)
        # Register the (already world-framed) frame cloud onto the map: the
        # correction applies on top of the current pose estimate.
        eye = torch.eye(3, dtype=torch.float32, device=self.device)
        Rc, tc, rmse, frac = icp_point_to_plane(
            src.xyz, src.mask, tgt.xyz, normals, tgt.mask, eye,
            torch.zeros(3, dtype=torch.float32, device=self.device),
            iterations=self.cfg.icp_iterations,
            max_correspondence=self.cfg.icp_max_correspondence)
        if float(frac) < 0.3:  # registration failed; keep the feature pose
            return R_w2c, t_w2c, None
        Rc_np, tc_np = Rc.cpu().numpy(), tc.cpu().numpy()
        # World-frame correction X' = Rc X + tc folded into the
        # camera-from-world pose.
        R_new = R_w2c @ Rc_np.T
        t_new = t_w2c - R_new @ tc_np
        return R_new, t_new, float(rmse)

    # ----------------------------------------------------------- loop closure

    def _camera_cloud(self, depth: torch.Tensor, rgb: torch.Tensor
                      ) -> PointSet:
        """Subsampled CAMERA-frame cloud of exactly ``kf_cloud_points`` rows
        (pose-independent keyframe store, kept on the device)."""
        ps = self._backproject(depth, rgb, np.eye(3, dtype=np.float32),
                               np.zeros(3, np.float32))
        cap = self.cfg.kf_cloud_points
        step = max(1, ps.capacity // cap)
        xyz, rgb_, mask = (a[::step][:cap] for a in (ps.xyz, ps.rgb,
                                                      ps.mask))
        pad = cap - xyz.shape[0]
        if pad > 0:
            # _rebuild_map stacks keyframe clouds: a frame smaller than the
            # budget must not give a ragged cloud.
            xyz = torch.nn.functional.pad(xyz, (0, 0, 0, pad))
            rgb_ = torch.nn.functional.pad(rgb_, (0, 0, 0, pad))
            mask = torch.nn.functional.pad(mask, (0, pad))
        return PointSet(xyz, rgb_, mask)

    def _loop_candidates(self, sketch) -> List[int]:
        """Appearance-gated candidate keyframes, most similar first: the
        whole history is scored in one host product over the stored
        sketches and the top ``loop_topk`` above ``loop_min_similarity``
        survive; loop_topk = 0 scans every ``loop_stride``-th keyframe."""
        n_old = len(self.keyframes) - self.cfg.loop_min_separation
        if n_old <= 0:
            return []
        if self.cfg.loop_topk <= 0:
            return list(range(0, n_old, self.cfg.loop_stride))
        sk = np.stack([kf["sketch"] for kf in self.keyframes[:n_old]])
        scores = appearance_scores(sk, sketch)
        order = np.argsort(-scores)[: self.cfg.loop_topk]
        return [int(i) for i in order
                if scores[i] >= self.cfg.loop_min_similarity]

    @f32_dots
    def _loop_verify(self, cand: Features, feats: Features,
                     depth: torch.Tensor, prio: Optional[torch.Tensor]):
        """Geometric verification of one candidate keyframe against the new
        one: ratio matching, the first VCAP matched rows, ``pair_step`` with
        512 hypotheses and the depth-anchored scale. Returns (matches,
        inliers, valid points, R, t, scale) as tensors."""
        idx2, ok = match_l2_ratio(cand.desc, feats.desc, cand.mask,
                                  feats.mask, 0.75)
        uv2 = feats.uv[idx2]
        pick = _compact(ok, VCAP)
        uv1_c, uv2_c, ok_c = cand.uv[pick], uv2[pick], ok[pick]
        R, t, X, valid, n_inl = pair_step(
            uv1_c, uv2_c, ok_c, self.K, self.generator, 2.0,
            self.cfg.min_depth, self.cfg.max_depth * 10,
            num_hypotheses=LOOP_HYPOTHESES, priorities=prio)
        X_curr = X @ R.T + t
        s = clamp_scale(estimate_scale(X_curr, uv2_c, valid, depth))
        return ok.sum(), n_inl, valid.sum(), R, t, s

    def _try_loop_edge(self, feats: Features, depth: torch.Tensor, sketch):
        """Match the new keyframe against the gated candidates; return
        (old keyframe index, R_rel, t_rel in world units) or None.

        Most similar first, the first hit wins: >= loop_inliers ratio-test
        matches, >= loop_inliers RANSAC inliers, >= 5 triangulated anchors.
        Candidates go in chunks of ``loop_topk`` (8 when it is 0), each
        chunk taking one draw of priorities; a chunk stops at its first
        hit."""
        cands = self._loop_candidates(sketch)
        if not cands:
            return None
        k_pad = max(self.cfg.loop_topk, 1) if self.cfg.loop_topk > 0 else 8
        for lo in range(0, len(cands), k_pad):
            group = cands[lo:lo + k_pad]
            prio = self._draw(k_pad, LOOP_HYPOTHESES, VCAP)
            for j, ki in enumerate(group):
                f = self.keyframes[ki]["features"]
                # a spilled (host) keyframe comes back to the device here
                cand = Features(*(_to_device(a, self.device)
                                  for a in (f.uv, f.desc, f.mask)), f.kind)
                n_match, n_inl, n_val, R, t, s = (
                    v.cpu() for v in self._loop_verify(
                        cand, feats, depth, None if prio is None else prio[j]))
                if int(n_match) < self.cfg.loop_inliers:
                    continue
                if int(n_inl) < self.cfg.loop_inliers:
                    continue
                if int(n_val) < 5:
                    continue
                # pair_step's translation has unit length; the depth anchor
                # gives world units: X_loop ~ s_loop * depth while the world
                # is scale * depth, so t_world = t * scale / s_loop.
                s_loop = float(s)
                s_world = self._depth_scale()
                t_world = t.numpy().astype(np.float64) * (
                    s_world / max(s_loop, 1e-9))
                self._log(f"  loop closure: keyframe {ki} <-> new "
                          f"({int(n_inl)} inliers, "
                          f"scale {s_world / s_loop:.3f})")
                return ki, R.numpy().astype(np.float64), t_world
        return None

    @f32_dots
    def _refine_loop_edge(self, old_ki: int, R_rel, t_rel):
        """Tighten the feature-RANSAC loop edge with point-to-plane ICP
        between the two keyframe clouds: the old cloud, mapped through the
        candidate edge, registered onto the new one. Gated on an inlier
        fraction >= 0.3, so a diverged solve never worsens the edge."""
        old_c = self.keyframes[old_ki]["cloud"]
        new_c = self.keyframes[-1]["cloud"]
        Rj = torch.from_numpy(np.asarray(R_rel, np.float32)).to(self.device)
        tj = torch.from_numpy(np.asarray(t_rel, np.float32)).to(self.device)
        src_full = _to_device(old_c.xyz, self.device) @ Rj.T + tj[None, :]
        sstep = max(1, src_full.shape[0] // self.icp_sample)
        src_xyz = src_full[::sstep][: self.icp_sample]
        src_mask = _to_device(old_c.mask, self.device)[::sstep][
            : self.icp_sample]
        tgt_xyz = _to_device(new_c.xyz, self.device)
        tgt_mask = _to_device(new_c.mask, self.device)
        normals = estimate_normals(tgt_xyz, tgt_mask, 8)
        Rc, tc, _rmse, frac = icp_point_to_plane(
            src_xyz, src_mask, tgt_xyz, normals, tgt_mask,
            torch.eye(3, dtype=torch.float32, device=self.device),
            torch.zeros(3, dtype=torch.float32, device=self.device),
            int(self.cfg.icp_iterations),
            float(self.cfg.icp_max_correspondence), 1024)
        if float(frac) < 0.3:
            return R_rel, t_rel
        Rc_np = Rc.cpu().numpy().astype(np.float64)
        tc_np = tc.cpu().numpy().astype(np.float64)
        self._log(f"  loop edge ICP refine: inlier frac {float(frac):.2f}")
        return Rc_np @ R_rel, Rc_np @ t_rel + tc_np

    def _close_loop(self, old_ki: int, R_rel, t_rel):
        """Optimise the keyframe pose graph with the new loop edge, carry
        the corrections to the frames between keyframes, and re-fuse the
        map."""
        R_rel, t_rel = self._refine_loop_edge(old_ki, R_rel, t_rel)
        kfs = self.keyframes
        nodes = [self.poses[kf["pose_idx"]] for kf in kfs]
        edges = []
        for a in range(len(kfs) - 1):
            Ra, ta = nodes[a]
            Rb, tb = nodes[a + 1]
            R_ab = Rb @ Ra.T
            t_ab = tb - R_ab @ ta
            edges.append((a, a + 1, R_ab, t_ab, 1.0))
        edges.append((old_ki, len(kfs) - 1, R_rel, t_rel,
                      self.cfg.loop_weight))
        opt = optimize_pose_graph(nodes, edges, fixed=0)

        # The largest camera-centre correction decides whether the fused
        # map is rebuilt: below about one voxel it is unchanged at its own
        # resolution.
        max_move = 0.0
        for (Ro, to), (Rn, tn) in zip(nodes, opt):
            c_old = -Ro.T @ to
            c_new = -Rn.T @ tn
            max_move = max(max_move, float(np.linalg.norm(c_new - c_old)))

        # Each keyframe's correction moves its trailing segment rigidly: a
        # frame keeps its pose RELATIVE to its keyframe, T_p_new = T_p_old
        # o T_a_old^-1 o T_a_new (world-to-camera poses, X_c = R X_w + t).
        for a, kf in enumerate(kfs):
            Ro, to = nodes[a]
            Rn, tn = opt[a]
            Rd = Ro.T @ Rn
            td = Ro.T @ (tn - to)
            lo = kf["pose_idx"]
            hi = kfs[a + 1]["pose_idx"] if a + 1 < len(kfs) \
                else len(self.poses)
            for p in range(lo, hi):
                Rp, tp = self.poses[p]
                self.poses[p] = ((Rp @ Rd).astype(np.float32),
                                 (Rp @ td + tp).astype(np.float32))
        thr = self.cfg.loop_rebuild_min_correction
        if thr is None:
            thr = float(self.map.voxel_size)
        if max_move > thr:
            self._rebuild_map()
        self.loops_closed += 1
        self.loop_edges.append((old_ki, len(kfs) - 1))

    @f32_dots
    def _rebuild_map(self):
        """Re-fuse the voxel map from the keyframe clouds at the corrected
        poses, in inserts of at most about 4M rows."""
        self.map = create_offset_map(self.map.khi.shape[0],
                                     float(self.map.voxel_size), self.device)
        if not self.keyframes:
            return
        rows_per_batch = max(1, 4_000_000 // max(self.cfg.kf_cloud_points, 1))
        for lo in range(0, len(self.keyframes), rows_per_batch):
            group = self.keyframes[lo:lo + rows_per_batch]
            # Clouds stay in the CAMERA frame: world-frame copies would go
            # stale at every closure, which is when rebuilds happen.
            Rs = torch.from_numpy(np.stack(
                [self.poses[kf["pose_idx"]][0] for kf in group]
            ).astype(np.float32)).to(self.device)
            ts = torch.from_numpy(np.stack(
                [self.poses[kf["pose_idx"]][1] for kf in group]
            ).astype(np.float32)).to(self.device)
            xyz, rgb, msk = (torch.stack([_to_device(getattr(kf["cloud"], a),
                                                     self.device)
                                          for kf in group])
                             for a in ("xyz", "rgb", "mask"))
            # (X_c - t) @ R per keyframe: R^T (X_c - t)
            world = torch.einsum("gpk,gkj->gpj", xyz - ts[:, None, :], Rs)
            n = world.shape[0] * world.shape[1]
            ps = PointSet(world.reshape(n, 3), rgb.reshape(n, 3),
                          msk.reshape(n))
            self.map = offset_map_insert(self.map, ps)

    def _spill_old_keyframes(self):
        """Keep only the newest ``kf_working_set`` keyframes on the device
        (rtabmap's WM/LTM split, slam.launch.py:126-145): older keyframes'
        features and clouds move to host numpy. Their sketches were on the
        host all along, so retrieval still spans the whole session; a
        spilled candidate or cloud goes back to the device where it is
        used."""
        ws = int(self.cfg.kf_working_set)
        if ws <= 0 or len(self.keyframes) <= ws:
            return
        for kf in self.keyframes[:-ws]:
            if kf.get("spilled"):
                continue
            f = kf["features"]
            kf["features"] = Features(f.uv.cpu().numpy(),
                                      f.desc.cpu().numpy(),
                                      f.mask.cpu().numpy(), f.kind)
            c = kf["cloud"]
            kf["cloud"] = PointSet(c.xyz.cpu().numpy(), c.rgb.cpu().numpy(),
                                   c.mask.cpu().numpy())
            kf["spilled"] = True

    def _maybe_keyframe(self, feats: Features, depth: torch.Tensor,
                        rgb: torch.Tensor):
        if not self.cfg.loop_closure:
            return
        if (self.frames_processed - 1) % self.cfg.keyframe_every != 0:
            return
        sketch = appearance_sketch(feats.desc, feats.mask)
        loop = self._try_loop_edge(feats, depth, sketch)
        self.keyframes.append({
            "pose_idx": len(self.poses) - 1,
            "features": feats,
            "sketch": sketch,
            "cloud": self._camera_cloud(depth, rgb),
        })
        self._spill_old_keyframes()
        if loop is not None:
            self._close_loop(loop[0], loop[1], loop[2])

    # ------------------------------------------------------------------ API

    @torch.no_grad()
    def process_frame(self, bgr, timestamp: float = 0.0,
                      identifier: str = "") -> bool:
        """Ingest one (H, W, 3) uint8 BGR frame (numpy or tensor). Returns
        True if fused, False if skipped."""
        if self.depth_model is None:
            raise RuntimeError("StreamingReconstructor needs a depth model")
        depth_out = self.depth_model.infer(bgr, self.intr)
        # one upload of the frame and its depth; everything after stays on
        # the device
        bgr_t = _to_device(bgr, self.device)
        depth = _to_device(depth_out, self.device).to(torch.float32)
        rgb = bgr_t.flip(-1)

        feats = self.detector.detect(bgr_t)

        if not self.poses:  # the first frame anchors the world
            R, t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
            if not self.metric_depth:
                self.scale = 1.0
        else:
            R_rel, t_rel, n_inl, scale_i = (
                self._estimate_pose_features(feats, depth)
                if self._prev_features is not None else (None, None, 0, None))
            if n_inl < MIN_INLIERS:
                self._log(f"  frame {identifier}: {n_inl} inliers < "
                          f"{MIN_INLIERS} - feature odometry failed")
                if not self.use_icp:
                    self.frames_skipped += 1
                    self._prev_features = feats
                    return False
                R_prev, t_prev = self.poses[-1]
                R, t = R_prev.copy(), t_prev.copy()  # constant position
            else:
                R_prev, t_prev = self.poses[-1]
                R = R_rel @ R_prev
                t = R_rel @ t_prev + t_rel
                if scale_i is not None:
                    self.scale = float(ema_scale(self.scale, scale_i))

        ps = self._backproject(depth, rgb, R, t)

        # ICP refinement against the map (the textureless rescue path)
        if self.use_icp and self.poses:
            R2, t2, rmse = self._refine_icp(ps, R, t)
            if rmse is not None and (not np.allclose(R2, R)
                                     or not np.allclose(t2, t)):
                R, t = R2, t2
                self.icp_accepted += 1
                ps = self._backproject(depth, rgb, R, t)

        self.map = offset_map_insert(self.map, ps)
        self.poses.append((np.asarray(R, np.float32),
                           np.asarray(t, np.float32)))
        self._prev_features = feats
        self.frames_processed += 1
        self._maybe_keyframe(feats, depth, rgb)
        return True

    def run(self, source, max_frames: Optional[int] = None) -> int:
        """Fuse every frame of ``source`` (an iterable of (bgr, timestamp,
        identifier)), stepwise; returns the frames fused."""
        self._log("Streaming stepwise: the port has no fused "
                  "one-program-per-frame step yet")
        start = time.time()
        try:
            for i, (bgr, ts, ident) in enumerate(source):
                if max_frames is not None and i >= max_frames:
                    break
                self.process_frame(bgr, ts, ident)
                if self.frames_processed and self.frames_processed % 10 == 0:
                    fps = self.frames_processed / (time.time() - start)
                    self._log(f"Fused {self.frames_processed} frames "
                              f"({fps:.1f} fps), map: "
                              f"{int(offset_map_size(self.map))} voxels")
        except KeyboardInterrupt:
            self._log("Interrupted - finalizing map")
        elapsed = max(time.time() - start, 1e-9)
        self._log(f"Stream done: {self.frames_processed} fused, "
                  f"{self.frames_skipped} skipped, "
                  f"{self.frames_processed / elapsed:.1f} fps")
        return self.frames_processed

    def save(self, path: str) -> int:
        xyz, rgb = offset_map_points(self.map).to_numpy()
        write_ply(path, xyz, rgb)
        self._log(f"Saved {len(xyz)} points to {path}")
        return len(xyz)

    def save_grid(self, path_stem: str, cell_size: float = 0.05,
                  range_max: float = 5.0) -> np.ndarray:
        """Write the rtabmap-style 2D occupancy grid (PGM + YAML), the
        second product of the reference's rtabmap_slam node
        (slam.launch.py:126-145, Grid/RangeMax = 5)."""
        xyz, _ = offset_map_points(self.map).to_numpy()
        centers = np.stack([-R.T @ t for R, t in self.poses], axis=0) \
            if self.poses else None
        grid, origin = occupancy_grid(xyz, camera_centers=centers,
                                      cell_size=cell_size,
                                      range_max=range_max)
        out = write_occupancy_map(path_stem, grid, origin, cell_size)
        occ = int((grid == 100).sum())
        free = int((grid == 0).sum())
        self._log(f"Saved occupancy grid {grid.shape[1]}x{grid.shape[0]} "
                  f"({occ} occupied, {free} free) to {out}")
        return grid
