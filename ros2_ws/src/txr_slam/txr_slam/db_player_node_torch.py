#!/usr/bin/env python3
"""RTAB-Map database replay node on the PyTorch / CUDA port's host code.

The counterpart of db_player_node.py with the same topics and parameters:
replays JPEG frames from an RTAB-Map sqlite session on /camera/image_raw
with the calibration parsed from the binary blob (rescaled if image sizes
differ). The parsing lives in txr_torch.io.rtabmap_db and a tick in
``txr_torch.ros2.nodes.replay_tick``; this node is the thin DDS edge.
"""

import rclpy
from rclpy.node import Node
from sensor_msgs.msg import CameraInfo, Image

from txr_slam.msg_utils import image_to_msg, make_camera_info


class DBPlayerNode(Node):
    def __init__(self):
        super().__init__("txr_db_player_node")
        self.declare_parameter("db_path", "")
        self.declare_parameter("framerate", 30.0)
        self.declare_parameter("loop", False)
        self.declare_parameter("frame_id", "camera")

        from txr_torch.io.rtabmap_db import RTABMapDBSource

        db_path = self.get_parameter("db_path").value
        if not db_path:
            raise RuntimeError("db_path parameter is required")
        self.frame_id = self.get_parameter("frame_id").value
        self.source = RTABMapDBSource(
            db_path, loop=bool(self.get_parameter("loop").value))
        self.get_logger().info(f"Replaying {len(self.source)} frames from {db_path}")

        self.pub = self.create_publisher(Image, "/camera/image_raw", 10)
        self.info_pub = self.create_publisher(CameraInfo, "/camera/camera_info", 10)
        rate = float(self.get_parameter("framerate").value)
        self.timer = self.create_timer(1.0 / max(rate, 1e-3), self._tick)

    def _tick(self):
        from txr_torch.ros2.nodes import replay_tick

        frame = replay_tick(self.source)
        if frame is None:
            self.get_logger().info("Replay finished")
            self.timer.cancel()
            return
        stamp = self.get_clock().now().to_msg()
        msg = image_to_msg(frame.bgr, "bgr8", stamp, self.frame_id)
        self.pub.publish(msg)
        info = make_camera_info(frame.width, frame.height, header=msg.header,
                                fx=frame.fx, fy=frame.fy, cx=frame.cx,
                                cy=frame.cy)
        self.info_pub.publish(info)


def main(args=None):
    rclpy.init(args=args)
    node = DBPlayerNode()
    try:
        rclpy.spin(node)
    finally:
        node.destroy_node()
        rclpy.shutdown()


if __name__ == "__main__":
    main()
