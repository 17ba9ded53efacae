"""txr_torch.ops: counterpart of txr.ops, with its exports.

``txr.ops`` also re-exports the function ``backproject``, which shadows the
module of that name; the port leaves ``txr_torch.ops.backproject`` the
module (import the function from it)."""

from txr_torch.ops.backproject import (
    backproject_batch,
    backproject_world,
    transform_to_world,
)
from txr_torch.ops.voxel import voxel_downsample
from txr_torch.ops.outlier import knn_mean_distance, remove_statistical_outliers
from txr_torch.ops.canny import canny
from txr_torch.ops.lsd import LsdLines, lsd_lines
from txr_torch.ops.orb import OrbFeatures, orb_features

__all__ = [
    "backproject_batch",
    "backproject_world",
    "transform_to_world",
    "voxel_downsample",
    "knn_mean_distance",
    "remove_statistical_outliers",
    "canny",
    "LsdLines",
    "lsd_lines",
    "OrbFeatures",
    "orb_features",
]
