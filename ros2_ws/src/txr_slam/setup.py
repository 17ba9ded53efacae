import os
from glob import glob

from setuptools import setup

package_name = "txr_slam"

setup(
    name=package_name,
    version="0.1.0",
    packages=[package_name],
    data_files=[
        ("share/ament_index/resource_index/packages",
         [f"resource/{package_name}"]),
        (f"share/{package_name}", ["package.xml"]),
        (os.path.join("share", package_name, "launch"),
         glob("launch/*.launch.py")),
    ],
    install_requires=["setuptools"],
    zip_safe=True,
    maintainer="txr",
    maintainer_email="txr@example.com",
    description="TPU-native monocular SLAM nodes: camera/db-replay sources, "
                "Depth Anything depth node, depth probe, RTAB-Map launch graph",
    license="MIT",
    entry_points={
        "console_scripts": [
            "camera_node = txr_slam.camera_node:main",
            "depth_node = txr_slam.depth_node:main",
            "db_player_node = txr_slam.db_player_node:main",
            "check_depth = txr_slam.check_depth:main",
            "depth_node_torch = txr_slam.depth_node_torch:main",
            "db_player_node_torch = txr_slam.db_player_node_torch:main",
        ],
    },
)
