"""Camera intrinsics model.

Behavioral parity with the reference `CameraIntrinsics` dataclasses
(reference: depth_processor.py:78-135 and depth_enhanced_reconstruction.py:57-80):
JSON loading with key aliases, a default model with fx = 0.8*width, a RealSense
D455 preset, and 3x3 K-matrix round-tripping.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, replace

import numpy as np


@dataclass(frozen=True)
class CameraIntrinsics:
    """Pinhole camera intrinsics.

    depth_scale converts stored depth units to meters (e.g. 0.001 for
    millimeter-quantized uint16 depth images).
    """

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480
    depth_scale: float = 1.0

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_json(cls, path: str) -> "CameraIntrinsics":
        """Load intrinsics from a JSON file.

        Accepts both short keys (``fx``) and long aliases
        (``focal_length_x``), mirroring the reference's tolerant schema
        (depth_processor.py:89-102).
        """
        with open(path, "r") as f:
            data = json.load(f)

        def pick(*names, default=None):
            for n in names:
                if n in data:
                    return data[n]
            return default

        width = int(pick("width", "image_width", default=640))
        height = int(pick("height", "image_height", default=480))
        return cls(
            fx=float(pick("fx", "focal_length_x", default=width * 0.8)),
            fy=float(pick("fy", "focal_length_y", default=width * 0.8)),
            cx=float(pick("cx", "principal_point_x", default=width / 2.0)),
            cy=float(pick("cy", "principal_point_y", default=height / 2.0)),
            width=width,
            height=height,
            depth_scale=float(pick("depth_scale", default=1.0)),
        )

    @classmethod
    def default(cls, width: int = 640, height: int = 480) -> "CameraIntrinsics":
        """Approximate intrinsics when no calibration is available.

        Uses the reference's heuristic focal length fx = fy = 0.8 * width
        (depth_processor.py:104-114, simple_camera_node.py:104-115).
        """
        f = 0.8 * width
        return cls(fx=f, fy=f, cx=width / 2.0, cy=height / 2.0, width=width, height=height)

    @classmethod
    def realsense_d455(cls) -> "CameraIntrinsics":
        """Intel RealSense D455 factory preset (reference depth_processor.py:116-127)."""
        return cls(
            fx=636.2,
            fy=636.2,
            cx=635.9,
            cy=366.1,
            width=1280,
            height=720,
            depth_scale=0.001,
        )

    @classmethod
    def from_matrix(
        cls, K: np.ndarray, width: int = 640, height: int = 480
    ) -> "CameraIntrinsics":
        K = np.asarray(K, dtype=np.float64)
        return cls(
            fx=float(K[0, 0]),
            fy=float(K[1, 1]),
            cx=float(K[0, 2]),
            cy=float(K[1, 2]),
            width=width,
            height=height,
        )

    # -- views -------------------------------------------------------------

    def to_matrix(self) -> np.ndarray:
        """3x3 camera matrix K."""
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float64,
        )

    # alias kept for callers thinking in K terms
    @property
    def K(self) -> np.ndarray:
        return self.to_matrix()

    def scaled(self, new_width: int, new_height: int) -> "CameraIntrinsics":
        """Rescale intrinsics to a different image resolution.

        Mirrors db_player_node's rescale-on-size-mismatch behavior
        (db_player_node.py:164-179).
        """
        sx = new_width / float(self.width)
        sy = new_height / float(self.height)
        return replace(
            self,
            fx=self.fx * sx,
            fy=self.fy * sy,
            cx=self.cx * sx,
            cy=self.cy * sy,
            width=new_width,
            height=new_height,
        )
