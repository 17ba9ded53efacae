"""ROS2 publishers for depth images and point clouds, the counterpart of
``txr/ros2/publisher.py`` (the same message bytes).

Topic contract parity with the reference's ROS2DepthPublisher
(depth_processor.py:665-792): 32FC1 depth Image, PointCloud2 with per-point
packed-float RGB, CameraInfo with plumb_bob distortion, and a wall-clock rate
limiter. The reference packs PointCloud2 RGB in a per-point Python loop
(:751-756, its worst CPU hot spot); here the whole message body is one
vectorized structured-array write.

rclpy is optional — ros2_available() gates every entry point.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np

try:
    import rclpy
    from rclpy.node import Node
    from sensor_msgs.msg import CameraInfo, Image, PointCloud2, PointField
    from std_msgs.msg import Header

    _ROS2 = True
except ImportError:  # pragma: no cover
    _ROS2 = False
    Node = object  # type: ignore


def ros2_available() -> bool:
    return _ROS2


def _stamp(ts: float):
    from builtin_interfaces.msg import Time

    t = Time()
    t.sec = int(ts)
    t.nanosec = int((ts - int(ts)) * 1e9)
    return t


def pack_pointcloud2_data(points: np.ndarray, colors: Optional[np.ndarray]) -> bytes:
    """XYZRGB packing: float32 x,y,z + packed-float rgb. C++ fast path
    (``txr_pack_xyzrgb`` of ``txr_torch._native``) when a toolchain is
    available; the numpy fallback is byte-identical."""
    from txr_torch._native import native_pack_xyzrgb

    c = colors
    if c is not None and c.dtype == np.uint8:
        c = c.astype(np.float32) / 255.0  # native rounds back to the same byte
    packed = native_pack_xyzrgb(np.asarray(points, np.float32), c)
    if packed is not None:
        return packed
    return pack_pointcloud2_numpy(points, colors)


def pack_pointcloud2_numpy(points: np.ndarray, colors: Optional[np.ndarray]) -> bytes:
    """Vectorized numpy XYZRGB packing (the native path's parity oracle)."""
    n = len(points)
    if colors is not None:
        c = colors
        if c.dtype != np.uint8:
            # Half-up in float32, byte-identical to the C++ pack's
            # `c*255.0f + 0.5f` truncation (np.round is half-to-even).
            c = np.clip(np.floor(c.astype(np.float32) * np.float32(255.0)
                                 + np.float32(0.5)), 0, 255).astype(np.uint8)
        rgb_u32 = (c[:, 0].astype(np.uint32) << 16) | \
                  (c[:, 1].astype(np.uint32) << 8) | c[:, 2].astype(np.uint32)
        rec = np.empty(n, dtype=np.dtype(
            [("x", "<f4"), ("y", "<f4"), ("z", "<f4"), ("rgb", "<f4")]))
        rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
        rec["rgb"] = rgb_u32.view(np.float32)
    else:
        rec = np.empty(n, dtype=np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")]))
        rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    return rec.tobytes()


if _ROS2:

    class ROS2DepthPublisher(Node):  # pragma: no cover - needs a ROS2 runtime
        def __init__(
            self,
            publish_depth: bool = True,
            publish_pointcloud: bool = True,
            publish_rate: float = 10.0,
            depth_topic: str = "/depth_anything/depth_image",
            pc_topic: str = "/depth_anything/points",
            info_topic: str = "/depth_anything/camera_info",
            frame_id: str = "camera_depth_optical_frame",
        ):
            if not rclpy.ok():
                rclpy.init()
            super().__init__("txr_depth_publisher")
            self.frame_id = frame_id
            self.publish_rate = publish_rate
            self._last_pub = 0.0
            self.depth_pub = (
                self.create_publisher(Image, depth_topic, 10) if publish_depth else None)
            self.pc_pub = (
                self.create_publisher(PointCloud2, pc_topic, 10) if publish_pointcloud else None)
            self.info_pub = self.create_publisher(CameraInfo, info_topic, 10)

        def should_publish(self) -> bool:
            now = time.time()
            if now - self._last_pub >= 1.0 / max(self.publish_rate, 1e-6):
                self._last_pub = now
                return True
            return False

        def spin_once(self):
            rclpy.spin_once(self, timeout_sec=0)

        def publish_depth_image(self, depth: np.ndarray, ts: float):
            if self.depth_pub is None:
                return
            msg = Image()
            msg.header = Header(stamp=_stamp(ts), frame_id=self.frame_id)
            msg.height, msg.width = depth.shape[:2]
            msg.encoding = "32FC1"
            msg.is_bigendian = False
            msg.step = msg.width * 4
            msg.data = depth.astype(np.float32).tobytes()
            self.depth_pub.publish(msg)

        def publish_pointcloud(self, points: np.ndarray,
                               colors: Optional[np.ndarray], ts: float):
            if self.pc_pub is None or len(points) == 0:
                return
            msg = PointCloud2()
            msg.header = Header(stamp=_stamp(ts), frame_id=self.frame_id)
            msg.height = 1
            msg.width = len(points)
            fields = [
                PointField(name="x", offset=0, datatype=PointField.FLOAT32, count=1),
                PointField(name="y", offset=4, datatype=PointField.FLOAT32, count=1),
                PointField(name="z", offset=8, datatype=PointField.FLOAT32, count=1),
            ]
            point_step = 12
            if colors is not None:
                fields.append(PointField(name="rgb", offset=12,
                                         datatype=PointField.FLOAT32, count=1))
                point_step = 16
            msg.fields = fields
            msg.is_bigendian = False
            msg.point_step = point_step
            msg.row_step = point_step * len(points)
            msg.is_dense = True
            msg.data = pack_pointcloud2_data(points, colors)
            self.pc_pub.publish(msg)

        def publish_camera_info(self, intr, ts: float):
            msg = CameraInfo()
            msg.header = Header(stamp=_stamp(ts), frame_id=self.frame_id)
            msg.height, msg.width = int(intr.height), int(intr.width)
            msg.distortion_model = "plumb_bob"
            msg.d = [0.0] * 5
            msg.k = [intr.fx, 0.0, intr.cx, 0.0, intr.fy, intr.cy, 0.0, 0.0, 1.0]
            msg.r = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
            msg.p = [intr.fx, 0.0, intr.cx, 0.0,
                     0.0, intr.fy, intr.cy, 0.0, 0.0, 0.0, 1.0, 0.0]
            self.info_pub.publish(msg)

        def shutdown(self):
            self.destroy_node()
            if rclpy.ok():
                rclpy.shutdown()

else:

    class ROS2DepthPublisher:  # type: ignore[no-redef]
        """Placeholder that fails loudly when ROS2 is unavailable."""

        def __init__(self, *args, **kwargs):
            raise RuntimeError(
                "rclpy is not available — install ROS2 to use --ros2 publishing")
