"""txr_torch.fusion: counterpart of txr.fusion (the packed voxel map, dense
point clouds and their merges)."""

from txr_torch.fusion.chunked_merge import chunked_dense_voxel_merge
from txr_torch.fusion.pointcloud import (DensePointCloudGenerator,
                                         depth_to_pointcloud,
                                         merge_pointclouds)

__all__ = ["DensePointCloudGenerator", "chunked_dense_voxel_merge",
           "depth_to_pointcloud", "merge_pointclouds"]
