#!/usr/bin/env python3
"""Monocular depth node on the PyTorch / CUDA port: RGB in, registered
metric depth out, on the card.

The counterpart of depth_node.py with the same topics and parameters, plus
``device`` ("" is the CUDA device). It subscribes /camera/image_raw and
publishes 32FC1 meters on /camera/depth_registered/image_raw with a synced
CameraInfo; what happens to a frame is ``txr_torch.ros2.nodes.
DepthCallback`` (the inverse-depth heuristic for the relative head, 0 past
max_depth).

Parameters: model_version (v1/v2/v3), model_encoder, checkpoint, metric
(native metric head instead of the inverse heuristic), max_depth (default
3.5), depth_scale_factor (default 20.0), device.
"""

import rclpy
from rclpy.node import Node
from sensor_msgs.msg import CameraInfo, Image

from txr_slam.msg_utils import image_to_msg, msg_to_image


class DepthNode(Node):
    def __init__(self):
        super().__init__("txr_depth_node")
        self.declare_parameter("model_version", "v2")
        self.declare_parameter("model_encoder", "vits")
        self.declare_parameter("checkpoint", "")
        self.declare_parameter("metric", False)
        self.declare_parameter("max_depth", 3.5)
        self.declare_parameter("depth_scale_factor", 20.0)
        self.declare_parameter("device", "")

        from txr_torch.ros2.nodes import DepthCallback, load_depth_model

        metric = bool(self.get_parameter("metric").value)
        max_depth = float(self.get_parameter("max_depth").value)
        model = load_depth_model(
            version=self.get_parameter("model_version").value,
            encoder=self.get_parameter("model_encoder").value,
            checkpoint=self.get_parameter("checkpoint").value or None,
            metric=metric, max_depth=max_depth,
            device=self.get_parameter("device").value or None)
        self.callback = DepthCallback(
            model, metric=metric, max_depth=max_depth,
            scale_factor=float(self.get_parameter("depth_scale_factor").value))
        self.get_logger().info(f"Depth model ready on {model.device}")

        self._last_info = None
        self.create_subscription(Image, "/camera/image_raw", self._on_image, 10)
        self.create_subscription(CameraInfo, "/camera/camera_info", self._on_info, 10)
        self.depth_pub = self.create_publisher(
            Image, "/camera/depth_registered/image_raw", 10)
        self.info_pub = self.create_publisher(
            CameraInfo, "/camera/depth_registered/camera_info", 10)

    def _on_info(self, msg: CameraInfo):
        self._last_info = msg

    def _on_image(self, msg: Image):
        depth = self.callback(msg_to_image(msg), msg.encoding)
        out = image_to_msg(depth, "32FC1", msg.header.stamp, msg.header.frame_id)
        self.depth_pub.publish(out)
        if self._last_info is not None:
            info = self._last_info
            info.header = out.header
            self.info_pub.publish(info)


def main(args=None):
    rclpy.init(args=args)
    node = DepthNode()
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":
    main()
