"""Streaming SLAM-like reconstruction, the counterpart of
``txr/pipelines/streaming.py`` (behind ``reconstruction_torch.py``).

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

``run`` takes one of three routes, as ``txr``'s does. With ``fused`` set and
the port's ``DepthAnythingModel`` as the model, the whole chain of a frame
is one step with no host read (``pipelines/stream_step.py``; on the card a
CUDA graph replayed per frame): an offline source runs
``cfg.stream_batch`` frames a step (``_run_fused_batched``), a live one a
frame a step (``_run_fused``). Otherwise, and always in ``process_frame``,
the stepwise loop runs, reading its counts and poses back per frame.

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
                                           appearance_sketch,
                                           appearance_sketch_device)
from txr_torch.geometry.features import (Features, SIFTDetector,
                                         match_features)
from txr_torch.geometry.icp import estimate_normals, icp_point_to_plane
from txr_torch.geometry.pose_graph import optimize_pose_graph
from txr_torch.geometry.scale import clamp_scale, ema_scale, estimate_scale
from txr_torch.io.ply import write_ply
from txr_torch.models.depth_anything import DepthAnythingModel
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.matching import match_l2_ratio
from txr_torch.pipelines.fusion_pipeline import _compact, pair_step
from txr_torch.pipelines.stream_step import (MIN_INLIERS, PAIR_HYPOTHESES,
                                             FusedStreamState,
                                             build_fused_stream_batch_step,
                                             build_fused_stream_step,
                                             init_fused_state, read_rows)

logger = logging.getLogger(__name__)

# Fused steps (with their CUDA graphs), shared by every reconstructor whose
# model, frame shape and settings give the same step (see _step_key).
_FUSED_STEP_CACHE: dict = {}
# Loop pairs are distant frames: a few hundred ratio-test matches survive
# of the feature capacity, so verification runs on the first VCAP matched
# rows (matched rows first, each group in index order) with 512 hypotheses.
VCAP = 512
LOOP_HYPOTHESES = 512

Priorities = Callable[[Optional[int], int, int], torch.Tensor]


def _to_device(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(a).to(device)


class _Row:
    """One frame's view of a batched step's diagnostics, for
    ``_maybe_keyframe_fused``."""

    def __init__(self, diag, i: int):
        self.uv, self.desc = diag.uv[i], diag.desc[i]
        self.fmask, self.depth = diag.fmask[i], diag.depth[i]


class StreamingReconstructor:
    """Incremental frame-by-frame reconstruction into a voxel map.

    device: where the map, features and frames live (None: the CUDA
    device, which must be present); SIFT runs on it (OpenCV's on the CPU
    when installed, ``geometry/features.py:resolve_backend``; the fused
    step always runs the device SIFT).
    fused: ``run`` takes the fused step when the model is the port's
    ``DepthAnythingModel`` (see the module docstring).
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
        fused: bool = True,
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
        self.icp_frames: List[int] = []   # poses that ICP corrected
        # Loop closure state: keyframes carry features + a camera-frame
        # cloud so the map can be re-fused after graph optimisation.
        self.keyframes: List[dict] = []
        self.loops_closed = 0
        self.loop_edges: List[Tuple[int, int]] = []
        self._last_loop_delta = None
        # Fused mode: the device state of the fused step, kept in step with
        # the host's view when process_frame or a closure changes that
        self.fused = fused
        self._fused_state: Optional[FusedStreamState] = None
        self.drains = 0             # host reads of the fused runs
        self.route: Optional[str] = None    # the route run() took last

    @property
    def icp_accepted(self) -> int:
        """Frames whose pose ICP corrected."""
        return len(self.icp_frames)

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
        # The last keyframe's right-composed correction, for a caller that
        # holds poses chained past this closure (the batched drain applies
        # it to the rest of its batch)
        Ro, to = nodes[-1]
        Rn, tn = opt[-1]
        self._last_loop_delta = (Ro.T @ Rn, Ro.T @ (tn - to))
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
                    self._resync_fused(feats, fused=False)
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
                self.icp_frames.append(len(self.poses))
                ps = self._backproject(depth, rgb, R, t)

        self.map = offset_map_insert(self.map, ps)
        self.poses.append((np.asarray(R, np.float32),
                           np.asarray(t, np.float32)))
        self._prev_features = feats
        self.frames_processed += 1
        self._maybe_keyframe(feats, depth, rgb)
        self._resync_fused(feats, fused=True)
        return True

    def _resync_fused(self, feats: Features, fused: bool) -> None:
        """After a stepwise frame, bring the fused state (if a fused run
        made one) up to the host's view: the map, the last pose (a closure
        may have corrected it), the scale, the frames fused and this frame's
        features, so that a later fused run goes on from here."""
        st = self._fused_state
        if st is None:
            return
        if fused:
            st = self._with_host_pose(st)._replace(
                scale=torch.tensor(self.scale, dtype=torch.float64,
                                   device=self.device),
                n_fused=st.n_fused + 1)
        if (feats.desc.shape == st.prev_desc.shape
                and feats.desc.dtype == torch.float32):
            st = st._replace(prev_uv=feats.uv, prev_desc=feats.desc,
                             prev_mask=feats.mask)
        self._fused_state = st

    # ------------------------------------------------------- fused hot loop

    def _with_host_pose(self, st: FusedStreamState) -> FusedStreamState:
        """The fused state with the host's map and last pose."""
        R_l, t_l = self.poses[-1]
        return st._replace(vm=self.map, R=_to_device(R_l, self.device),
                           t=_to_device(t_l, self.device))

    def _fused_state_now(self) -> FusedStreamState:
        """The fused state, made at the first fused run: empty, or, after
        stepwise frames, holding their map, last pose, scale, count and
        features."""
        if self._fused_state is None:
            st = init_fused_state(self.map.khi.shape[0],
                                  float(self.map.voxel_size),
                                  self.detector.capacity, self.device)
            if self.poses:
                st = self._with_host_pose(st)._replace(
                    scale=torch.tensor(self.scale, dtype=torch.float64,
                                       device=self.device),
                    n_fused=torch.tensor(len(self.poses), dtype=torch.int32,
                                         device=self.device))
            self._fused_state = st
            if self._prev_features is not None:
                self._resync_fused(self._prev_features, fused=False)
        return self._fused_state

    def _finish_fused(self, state: FusedStreamState) -> None:
        self._fused_state = state
        self.map = state.vm
        # a stepwise frame after this run matches against the last frame
        self._prev_features = Features(state.prev_uv, state.prev_desc,
                                       state.prev_mask, "sift")

    def _step_key(self, h: int, w: int, b: Optional[int] = None):
        """Everything that shapes the step (and its captured graphs): keyed
        at module level (_FUSED_STEP_CACHE), so a second reconstructor over
        the same model and settings replays the same graphs instead of
        capturing its own. The step holds the model, so its id stays
        unique while cached."""
        m, d = self.depth_model, self.detector
        return (id(m), m.version, m.encoder, m.input_size, h, w, b,
                str(self.device), float(self.intr.fx), float(self.intr.fy),
                float(self.intr.cx), float(self.intr.cy), d.capacity,
                d.n_features, d.contrast_threshold, float(d.edge_threshold),
                d.use_clahe, self.use_icp, self.metric_depth,
                self.icp_sample, float(self.cfg.min_depth),
                float(self.cfg.max_depth), int(self.cfg.subsample_factor),
                int(self.cfg.icp_iterations),
                float(self.cfg.icp_max_correspondence),
                int(self.cfg.kf_cloud_points))

    def _step_options(self) -> dict:
        d = self.detector
        return dict(feature_capacity=d.capacity, n_features=d.n_features,
                    contrast_threshold=d.contrast_threshold,
                    edge_threshold=float(d.edge_threshold),
                    use_clahe=d.use_clahe, use_icp=self.use_icp,
                    metric_depth=self.metric_depth,
                    icp_sample=self.icp_sample, device=self.device)

    def _fused_step_for(self, h: int, w: int):
        key = self._step_key(h, w)
        if key not in _FUSED_STEP_CACHE:
            _FUSED_STEP_CACHE[key] = build_fused_stream_step(
                self.depth_model, self.intr, self.cfg, h=h, w=w,
                **self._step_options())
        return _FUSED_STEP_CACHE[key]

    def _fused_batch_step_for(self, h: int, w: int, b: int):
        key = self._step_key(h, w, b)
        if key not in _FUSED_STEP_CACHE:
            _FUSED_STEP_CACHE[key] = build_fused_stream_batch_step(
                self.depth_model, self.intr, self.cfg, h=h, w=w, batch=b,
                kf_cloud_points=self.cfg.kf_cloud_points,
                **self._step_options())
        return _FUSED_STEP_CACHE[key]

    def _pair_priorities(self) -> torch.Tensor:
        """One odometry pair's (2, 1024, capacity) essential and homography
        priorities, drawn as the stepwise path draws them: two draws of the
        generator in that order, or one call of ``priorities``."""
        cap = self.detector.capacity
        if self.priorities is not None:
            return self._draw(None, PAIR_HYPOTHESES, cap)
        out = torch.empty((2, PAIR_HYPOTHESES, cap), dtype=torch.float32,
                          device=self.device)
        for k in range(2):
            torch.rand((PAIR_HYPOTHESES, cap), generator=self.generator,
                       out=out[k])
        return out

    def _no_priorities(self) -> torch.Tensor:
        """A stream's first frame draws nothing; its step takes zeros."""
        return torch.zeros((2, PAIR_HYPOTHESES, self.detector.capacity),
                           dtype=torch.float32, device=self.device)

    def _upload(self, frames) -> torch.Tensor:
        """uint8 frames (numpy or tensor) on the device. From the host they
        go through pinned memory, asynchronously: a copy from pageable
        memory would wait for every step enqueued before it."""
        if isinstance(frames, torch.Tensor):
            return frames.to(self.device)
        t = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _maybe_keyframe_fused(self, diag, rgb: Optional[torch.Tensor] = None,
                              cloud: Optional[PointSet] = None) -> bool:
        """Keyframe and loop-closure bookkeeping for one fused frame; the
        depth and features are read here only. Returns True if a loop
        closed (the device state must be resynced). ``cloud`` is the
        batched step's keyframe cloud (else one is back-projected from
        ``rgb``)."""
        if not self.cfg.loop_closure:
            return False
        if (self.frames_processed - 1) % self.cfg.keyframe_every != 0:
            return False
        # the keyframe keeps its own copy of the step's features; only the
        # (N_ANCHORS * 128,) sketch crosses to the host
        feats = Features(diag.uv.clone(), diag.desc.clone(),
                         diag.fmask.clone(), "sift")
        sketch = appearance_sketch_device(feats.desc, feats.mask
                                          ).cpu().numpy()
        loop = self._try_loop_edge(feats, diag.depth, sketch)
        self.keyframes.append({
            "pose_idx": len(self.poses) - 1,
            "features": feats,
            "sketch": sketch,
            "cloud": cloud if cloud is not None
            else self._camera_cloud(diag.depth, rgb),
        })
        self._spill_old_keyframes()
        if loop is not None:
            self._close_loop(loop[0], loop[1], loop[2])
            return True
        return False

    def _take_frame(self, rows, k: int) -> bool:
        """The host's part of one drained frame: skip it, or append its
        pose and take its scale. Returns whether it was fused."""
        if not rows.fused[k]:
            self.frames_skipped += 1
            self._log(f"  frame: {int(rows.n_inliers[k])} inliers < "
                      f"{MIN_INLIERS} - feature odometry failed")
            return False
        self.poses.append((rows.R[k], rows.t[k]))
        self.scale = float(rows.scale[k])
        self.frames_processed += 1
        if rows.icp_applied[k]:
            self.icp_frames.append(len(self.poses) - 1)
        return True

    def _log_rate(self, start: float, map_size: Callable[[], int]) -> None:
        if self.frames_processed % 10 == 0:
            fps = self.frames_processed / (time.time() - start)
            self._log(f"Fused {self.frames_processed} frames ({fps:.1f} "
                      f"fps), map: {map_size()} voxels")

    def _log_done(self, start: float) -> None:
        elapsed = max(time.time() - start, 1e-9)
        self._log(f"Stream done: {self.frames_processed} fused, "
                  f"{self.frames_skipped} skipped, "
                  f"{self.frames_processed / elapsed:.1f} fps")

    @torch.no_grad()
    def _run_fused(self, source, max_frames: Optional[int] = None) -> int:
        """One step per frame and one host read per chunk of frames.

        Chunks end on keyframes, so a keyframe's depth and features are read
        before the next step runs and a closure's corrections reach the
        device state at the stepwise path's cadence; without ICP a frame may
        be skipped, which moves the keyframes, so each frame is read on its
        own."""
        self._log("Streaming fused: one step a frame")
        start = time.time()
        state = self._fused_state_now()
        if self.cfg.loop_closure:
            chunk = self.cfg.keyframe_every if self.use_icp else 1
        else:
            chunk = 8
        pend: list = []   # (diag, frame on the device)

        def drain():
            nonlocal state
            if not pend:
                return
            rows = read_rows(torch.stack([d.row for d, _ in pend]))
            self.drains += 1
            resync = False
            for k, (d, frame) in enumerate(pend):
                if not self._take_frame(rows, k):
                    continue
                self.map = state.vm   # _rebuild_map needs its capacity
                resync |= self._maybe_keyframe_fused(d, rgb=frame.flip(-1))
                self._log_rate(start, lambda: int(rows.map_size[k]))
            if resync:
                # the closure rebuilt self.map and corrected self.poses on
                # the host: both go back into the device state
                state = self._with_host_pose(state)
            pend.clear()

        try:
            for i, (bgr, ts, ident) in enumerate(source):
                if max_frames is not None and i >= max_frames:
                    break
                frame = self._upload(bgr)
                step = self._fused_step_for(*frame.shape[:2])
                first = not self.poses and not pend
                prio = self._no_priorities() if first \
                    else self._pair_priorities()
                state, diag = step(state, frame, prio)
                pend.append((diag, frame))
                # keyframes end a chunk: the first drain after frame 1
                # (frames_processed == 1), then every `chunk` frames
                if (len(self.poses) + len(pend)) % chunk == 1 or chunk == 1:
                    drain()
        except KeyboardInterrupt:
            self._log("Interrupted - finalizing map")
        drain()
        self._finish_fused(state)
        self._log_done(start)
        return self.frames_processed

    @torch.no_grad()
    def _run_fused_batched(self, source, max_frames: Optional[int] = None
                           ) -> int:
        """One step and one host read per ``cfg.stream_batch`` frames
        (``FusedStreamBatchStep``). Offline sources only: a live camera
        would wait a batch per frame, so ``run`` keeps those per frame."""
        B = int(self.cfg.stream_batch)
        self._log(f"Streaming fused: one step per {B} frames")
        start = time.time()
        state = self._fused_state_now()

        def flush(buf):
            nonlocal state
            if not buf:
                return
            n = len(buf)
            pad = buf + [buf[-1]] * (B - n)
            frames = torch.stack([self._upload(f) for f in pad]) \
                if isinstance(buf[0], torch.Tensor) \
                else self._upload(np.stack(pad))
            step = self._fused_batch_step_for(*frames.shape[1:3], B)
            state, diag = step(state, frames, n, self._pair_priorities,
                               first=not self.poses)
            rows = read_rows(diag.rows[:n])
            self.drains += 1
            delta = None  # right-composed fix for poses chained past a
            # closure earlier in this batch
            for i in range(n):
                if not self._take_frame(rows, i):
                    continue
                if delta is not None:
                    Rd, td = delta
                    R_i, t_i = self.poses[-1]
                    self.poses[-1] = ((R_i @ Rd).astype(np.float32),
                                      (R_i @ td + t_i).astype(np.float32))
                self.map = state.vm   # _rebuild_map needs its capacity
                if (self.cfg.loop_closure and (self.frames_processed - 1)
                        % self.cfg.keyframe_every == 0):
                    cloud = PointSet(diag.kf_xyz[i], diag.kf_rgb[i],
                                     diag.kf_mask[i])
                    if self._maybe_keyframe_fused(_Row(diag, i),
                                                  cloud=cloud):
                        Rd2, td2 = (np.asarray(a, np.float32)
                                    for a in self._last_loop_delta)
                        if delta is None:
                            delta = (Rd2, td2)
                        else:   # raw o d1 o d2 (right-composition)
                            Rd1, td1 = delta
                            delta = (Rd1 @ Rd2, Rd1 @ td2 + td1)
                        state = self._with_host_pose(state)
                self._log_rate(start, lambda: int(rows.map_size[i]))
            if delta is not None:
                # the next batch chains from the corrected last pose
                state = self._with_host_pose(state)
            buf.clear()

        buf: list = []
        try:
            for i, (bgr, ts, ident) in enumerate(source):
                if max_frames is not None and i >= max_frames:
                    break
                if buf and tuple(bgr.shape[:2]) != tuple(buf[0].shape[:2]):
                    flush(buf)   # a change of shape starts a new batch
                buf.append(bgr)
                if len(buf) == B:
                    flush(buf)
        except KeyboardInterrupt:
            self._log("Interrupted - finalizing map")
        flush(buf)
        self._finish_fused(state)
        self._log_done(start)
        return self.frames_processed

    def run(self, source, max_frames: Optional[int] = None) -> int:
        """Fuse every frame of ``source`` (an iterable of (bgr, timestamp,
        identifier)); returns the frames fused. The fused step runs when
        ``fused`` is set and the model is the port's
        ``DepthAnythingModel``, batched unless the source is realtime
        (``txr``'s dispatch); any other model takes the stepwise loop."""
        if self.fused and isinstance(self.depth_model, DepthAnythingModel):
            if (int(self.cfg.stream_batch) > 1
                    and not getattr(source, "realtime", False)):
                self.route = "fused_batched"
                return self._run_fused_batched(source, max_frames)
            self.route = "fused_per_frame"
            return self._run_fused(source, max_frames)
        self.route = "stepwise"
        self._log("Streaming stepwise: one frame at a time")
        start = time.time()
        try:
            for i, (bgr, ts, ident) in enumerate(source):
                if max_frames is not None and i >= max_frames:
                    break
                if self.process_frame(bgr, ts, ident):
                    self._log_rate(
                        start, lambda: int(offset_map_size(self.map)))
        except KeyboardInterrupt:
            self._log("Interrupted - finalizing map")
        self._log_done(start)
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
