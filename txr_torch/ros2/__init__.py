"""Optional ROS2 integration (requires rclpy; degrades gracefully without)."""
