"""Two-view geometry of the port (the counterpart of ``txr.geometry``),
with the hybrid features and bundle adjustment of the enhanced CLI."""

from txr_torch.geometry.epipolar import (
    normalize_transform,
    eight_point,
    sampson_error,
    fundamental_ransac,
    essential_ransac,
)
from txr_torch.geometry.triangulate import (triangulate, reprojection_error,
                                            depth_in_camera)
from txr_torch.geometry.pose import (recover_pose, decompose_essential,
                                     chain_pose)
from txr_torch.geometry.scale import (
    masked_median,
    estimate_scale,
    clamp_scale,
    ema_scale,
)
from txr_torch.geometry.bundle_adjustment import (BAProblem, build_problem,
                                                  bundle_adjust)
from txr_torch.geometry.hybrid import (DepthGuidedMatcher,
                                       HybridFeatureDetector,
                                       HybridFeatures,
                                       generate_dense_correspondences,
                                       match_line_endpoints)

__all__ = [
    "normalize_transform",
    "eight_point",
    "sampson_error",
    "fundamental_ransac",
    "essential_ransac",
    "triangulate",
    "reprojection_error",
    "depth_in_camera",
    "recover_pose",
    "decompose_essential",
    "chain_pose",
    "masked_median",
    "estimate_scale",
    "clamp_scale",
    "ema_scale",
    "BAProblem",
    "build_problem",
    "bundle_adjust",
    "DepthGuidedMatcher",
    "HybridFeatureDetector",
    "HybridFeatures",
    "generate_dense_correspondences",
    "match_line_endpoints",
]
