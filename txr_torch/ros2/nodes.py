"""What the ROS2 nodes of ``ros2_ws/src/txr_slam`` do, without ``rclpy``:
the bodies of the port's depth node and database replay node
(``txr_slam/depth_node_torch.py``, ``db_player_node_torch.py``), which
keep only the topic plumbing.

- ``load_depth_model`` / ``DepthCallback``: ``depth_node.py:35-81``. A bgr8
  or rgb8 frame in, 32FC1 depth out: the metric head's meters, or the
  relative output through the inverse-depth heuristic
  ``depth_scale_factor / max(relative, 1e-3)``; everything past
  ``max_depth`` is set to 0 (invalid).
- ``replay_tick``: ``db_player_node.py:41-55``. The next frame of an
  RTAB-Map database with the camera-info values published beside it, or
  ``None`` when the replay is over.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from txr_torch.models.depth_anything import DepthAnythingModel


def load_depth_model(version: str = "v2", encoder: str = "vits",
                     checkpoint: Optional[str] = None, metric: bool = False,
                     max_depth: float = 3.5,
                     device: Optional[Union[str, torch.device]] = None
                     ) -> DepthAnythingModel:
    """The depth node's model: ``max_depth`` scales the metric head only;
    the relative head keeps the model's default range (20), as in the
    reference node. ``device=None``: the CUDA device."""
    return DepthAnythingModel(version=version, encoder=encoder,
                              checkpoint_path=checkpoint or None,
                              metric=metric,
                              max_depth=max_depth if metric else 20.0,
                              device=device)


class DepthCallback:
    """The depth node's image callback: (H, W, 3) uint8 frame and its ROS
    encoding -> (H, W) float32 depth in meters, 0 where invalid."""

    def __init__(self, model, metric: bool = False, max_depth: float = 3.5,
                 scale_factor: float = 20.0):
        self.model = model
        self.metric = metric
        self.max_depth = max_depth
        self.scale_factor = scale_factor

    def __call__(self, image: np.ndarray, encoding: str) -> np.ndarray:
        bgr = image[..., ::-1] if encoding == "rgb8" else image
        rel = self.model.infer(np.ascontiguousarray(bgr))
        if self.metric:
            depth = rel
        else:
            depth = self.scale_factor / np.maximum(rel, 1e-3)
        return np.where(depth > self.max_depth, 0.0, depth).astype(np.float32)


@dataclass
class ReplayFrame:
    """One replayed frame and the camera-info values published with it."""

    bgr: np.ndarray
    width: int
    height: int
    fx: float
    fy: float
    cx: float
    cy: float


def replay_tick(source) -> Optional[ReplayFrame]:
    """The next frame of ``source`` (an ``RTABMapDBSource``) with its
    intrinsics, or ``None`` at the end of the replay."""
    try:
        bgr, _, _ = next(source)
    except StopIteration:
        return None
    intr = source.intrinsics
    return ReplayFrame(bgr, bgr.shape[1], bgr.shape[0], intr.fx, intr.fy,
                       intr.cx, intr.cy)
