"""Core types of the port: PointSet, CameraIntrinsics, device resolution."""

from txr_torch.core.device import resolve_device
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.core.types import PointSet, concatenate

__all__ = ["CameraIntrinsics", "PointSet", "concatenate", "resolve_device"]
