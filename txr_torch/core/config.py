"""Pipeline configuration dataclasses, the counterpart of
``txr/core/config.py`` field for field, with the same defaults.

`ReconstructionConfig` matches the reference's defaults field-for-field
(reference: depth_to_reconstruction.py:45-73) so CLI behavior is identical.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class ReconstructionConfig:
    """Configuration for the fusion-from-precomputed-depth pipeline."""

    # Camera intrinsics (defaults match the reference's portrait-phone camera)
    fx: float = 1719.0
    fy: float = 1719.0
    cx: float = 540.0
    cy: float = 960.0

    # Depth validity range in meters
    min_depth: float = 0.1
    max_depth: float = 50.0

    # Feature matching
    match_ratio: float = 0.75
    min_matches: int = 50
    ransac_threshold: float = 3.0

    # Point-cloud fusion
    voxel_size: float = 0.005
    subsample_factor: int = 2

    # Statistical outlier removal (Open3D-equivalent semantics)
    outlier_neighbors: int = 20
    outlier_std_ratio: float = 2.0

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )


@dataclass
class StreamingConfig:
    """Configuration for the streaming (SLAM-like) reconstruction mode
    (the README-promised reconstruction.py; reference README.md:1-19)."""

    voxel_size: float = 0.01
    max_map_points: int = 2_000_000
    keyframe_every: int = 5
    icp_iterations: int = 10
    icp_max_correspondence: float = 0.1
    min_depth: float = 0.1
    max_depth: float = 10.0
    subsample_factor: int = 2
    # Offline sources run `stream_batch` frames per fused device program
    # (batched depth forward, one map insert per batch); 1 restores the
    # per-frame fused step. Live cameras always run per-frame.
    stream_batch: int = 8
    # Loop closure (rtabmap_slam's role in the reference launch graph,
    # slam.launch.py:126-145): match new keyframes against old ones, add a
    # pose-graph constraint on a hit, re-optimize, re-fuse the map.
    loop_closure: bool = True
    loop_min_separation: int = 8     # keyframes between loop candidates
    loop_stride: int = 2             # brute-force mode: every k-th keyframe
    loop_inliers: int = 30           # inlier bar for accepting a loop edge
    loop_weight: float = 5.0         # loop-edge weight vs odometry edges
    kf_cloud_points: int = 16384     # stored per-keyframe cloud budget
    # Appearance-gated retrieval (rtabmap's BoW memory role): candidates are
    # ranked by VLAD-sketch similarity (geometry/appearance.py in ``txr``) and
    # only the top-k geometrically verified. 0 falls back to the brute-force
    # every-loop_stride-th scan.
    loop_topk: int = 4
    loop_min_similarity: float = 0.05  # sketch score gate for candidates
    # Bounded session memory (rtabmap's Mem/IncrementalMemory WM/LTM split,
    # slam.launch.py:126-145): only the newest kf_working_set keyframes keep
    # device-resident features+clouds; older keyframes
    # spill to host RAM. Appearance sketches always stay host-side, so loop
    # retrieval spans the WHOLE session; a spilled candidate that passes the
    # appearance gate is re-uploaded for geometric verification. 0 disables
    # spilling (unbounded device-memory growth — short sessions only).
    kf_working_set: int = 64
    # Map re-fuse after graph optimization is skipped when every keyframe
    # camera center moved less than this (meters); None → voxel_size (the
    # map is already consistent to within one cell).
    loop_rebuild_min_correction: float | None = None
