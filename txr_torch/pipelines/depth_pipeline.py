"""Depth-inference pipeline (depth_processor parity), the counterpart of
``txr/pipelines/depth_pipeline.py``.

Behavioral rebuild of the reference's DepthProcessor
(depth_processor.py:795-964): iterate a frame source, run depth inference,
write raw .npy + colormapped vis PNG + uint16 millimeter PNG into
depth_images/ visualizations/, back-project to a per-frame camera-space PLY in
pointclouds/, rate-limited ROS2 publishing, FPS log every 10 frames, optional
preview window, KeyboardInterrupt → clean summary.

For offline sources (folder/video) the processor batches frames: a batch
runs preprocess → model → upsample → back-projection on the model's device
(through ``DepthAnythingModel._forward``, the one preprocessing body), and
its results are copied to the host once. The per-frame artifacts (npy, PNGs,
PLYs, ROS2 messages, preview) are emitted as in the sequential loop, in
order. Live camera sources keep batch 1 for latency; ``batch_size=1``
forces the frame-sequential reference loop. A short last batch runs as it
is: PyTorch needs no padding to a fixed batch shape.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from txr_torch.core.device import resolve_device
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.core.types import PointSet
from txr_torch.io.depth_io import save_depth_npy, save_depth_png16
from txr_torch.io.opencv import cv2_or_none, require_cv2
from txr_torch.io.ply import write_ply
from txr_torch.io.sources import CameraSource, ImageSource, PrefetchSource
from txr_torch.models.depth_anything import DepthAnythingModel
from txr_torch.ops.backproject import backproject
from txr_torch.ops.resize import compute_da_resize

logger = logging.getLogger(__name__)


class PointCloudGenerator:
    """Depth → camera-frame colored point cloud
    (reference depth_processor.py:339-450), back-projected on ``device``
    (``None``: the CUDA device)."""

    def __init__(self, intrinsics: CameraIntrinsics,
                 downsample_factor: int = 1, device=None):
        self.intrinsics = intrinsics
        self.downsample = max(1, int(downsample_factor))
        self.device = resolve_device(device)

    @torch.no_grad()
    def generate(self, depth: np.ndarray, bgr: np.ndarray,
                 max_depth: float = 100.0, min_depth: float = 0.1):
        intr = self.intrinsics
        d = torch.from_numpy(np.ascontiguousarray(depth)).to(self.device)
        rgb = torch.from_numpy(np.ascontiguousarray(bgr)).to(self.device)
        ps = backproject(
            d, rgb.flip(-1), intr.fx, intr.fy, intr.cx, intr.cy,
            min_depth, max_depth, intr.depth_scale, self.downsample,
        )
        return ps.to_numpy()

    @staticmethod
    def save_ply(path: str, points: np.ndarray, colors: Optional[np.ndarray]):
        write_ply(path, points, colors)


class DepthProcessor:
    """Main processor tying source → model → outputs together. Runs on the
    model's device (``model.device``)."""

    def __init__(
        self,
        model: DepthAnythingModel,
        source: ImageSource,
        output_dir: str,
        mode: str = "both",
        enable_ros2: bool = False,
        ros2_freq: float = 10.0,
        ros2_depth_topic: str = "/depth_anything/depth_image",
        ros2_pc_topic: str = "/depth_anything/points",
        ros2_frame_id: str = "camera_depth_optical_frame",
        pointcloud_downsample: int = 1,
        max_depth: float = 100.0,
        min_depth: float = 0.1,
        colormap: int = 2,  # cv2.COLORMAP_JET
        save_raw_depth: bool = True,
        batch_size: Optional[int] = None,  # None/0 = auto (8 offline, 1 live)
    ):
        self.model = model
        self.source = source
        self.output_dir = Path(output_dir)
        self.mode = mode
        self.max_depth = max_depth
        self.min_depth = min_depth
        self.colormap = colormap
        self.save_raw_depth = save_raw_depth
        self._previewed = False

        self.depth_dir = self.output_dir / "depth_images"
        self.pc_dir = self.output_dir / "pointclouds"
        self.vis_dir = self.output_dir / "visualizations"
        if mode in ("images", "both"):
            self.depth_dir.mkdir(parents=True, exist_ok=True)
            self.vis_dir.mkdir(parents=True, exist_ok=True)
        if mode in ("pointcloud", "both"):
            self.pc_dir.mkdir(parents=True, exist_ok=True)

        self.pc_generator = PointCloudGenerator(
            source.intrinsics, downsample_factor=pointcloud_downsample,
            device=getattr(model, "device", None))
        self.batch_size = batch_size

        self.ros2_node = None
        if enable_ros2:
            from txr_torch.ros2.publisher import (ROS2DepthPublisher,
                                                  ros2_available)

            if not ros2_available():
                raise RuntimeError("ROS2 requested but rclpy is not available")
            self.ros2_node = ROS2DepthPublisher(
                publish_depth=mode in ("images", "both"),
                publish_pointcloud=mode in ("pointcloud", "both"),
                publish_rate=ros2_freq,
                depth_topic=ros2_depth_topic,
                pc_topic=ros2_pc_topic,
                frame_id=ros2_frame_id,
            )

    # ------------------------------------------------------------------ run

    def _resolve_batch(self) -> int:
        # The batched path needs the real model (its _forward); model stubs
        # or wrappers that only expose infer() run the sequential loop.
        if getattr(self.model, "model", None) is None:
            return 1
        if self.batch_size:
            return max(1, int(self.batch_size))
        env = os.environ.get("TXR_DEPTH_BATCH")
        if env:
            return max(1, int(env))
        src = self.source
        if isinstance(src, PrefetchSource):
            src = src.inner
        return 1 if isinstance(src, CameraSource) else 8

    @torch.no_grad()
    def _device_batch(self, images: np.ndarray):
        """One batch on the model's device: BGR uint8 (B, H, W, 3) → depth
        (B, H, W) (with the V3 focal scaling) and, when point clouds are
        written, its back-projection at the downsample stride (a PointSet of
        (B, N) rows), else None."""
        m = self.model
        h, w = images.shape[1:3]
        in_h, in_w = compute_da_resize(h, w, m.input_size)
        rgb = torch.from_numpy(images).to(m.device).flip(-1)
        depth = m._forward(rgb, in_h, in_w, h, w)
        intr = self.source.intrinsics
        if m.version == "v3" and intr is not None:
            depth = depth * ((intr.fx + intr.fy) / 2.0 / m.focal_length_ref)
        if self.mode not in ("pointcloud", "both"):
            return depth, None
        ps = backproject(depth, rgb, intr.fx, intr.fy, intr.cx, intr.cy,
                         self.min_depth, self.max_depth, intr.depth_scale,
                         self.pc_generator.downsample)
        return depth, ps

    @staticmethod
    def _to_host(depth: torch.Tensor, ps: Optional[PointSet]):
        """The batch's results as numpy arrays, one copy each."""
        if ps is None:
            return depth.cpu().numpy(), None
        return depth.cpu().numpy(), (ps.xyz.cpu().numpy(),
                                     ps.rgb.cpu().numpy(),
                                     ps.mask.cpu().numpy())

    def process(self, show_preview: bool = False):
        batch = self._resolve_batch()
        self._previewed = show_preview
        logger.info("Starting processing with mode: %s (batch %d)",
                    self.mode, batch)
        if batch <= 1:
            return self._process_sequential(show_preview)
        return self._process_batched(batch, show_preview)

    def _process_sequential(self, show_preview: bool = False):
        processed = 0
        start = time.time()
        try:
            for image, timestamp, identifier in self.source:
                depth = self.model.infer(image, self.source.intrinsics)

                if self.mode in ("images", "both"):
                    self._save_depth(depth, identifier)

                points = colors = None
                if self.mode in ("pointcloud", "both"):
                    points, colors = self.pc_generator.generate(
                        depth, image, self.max_depth, self.min_depth)
                    self._save_pointcloud(points, colors, identifier)

                self._publish_ros2(depth, points, colors, timestamp)

                if show_preview:
                    self._show_preview(image, depth, identifier)

                processed += 1
                if processed % 10 == 0:
                    fps = processed / (time.time() - start)
                    logger.info("Processed %d frames (%.1f fps)", processed, fps)
        except KeyboardInterrupt:
            logger.info("Processing interrupted by user")
        finally:
            elapsed = max(time.time() - start, 1e-9)
            logger.info("Processed %d frames in %.1fs (%.1f fps)",
                        processed, elapsed, processed / elapsed)
            self.cleanup()
        return processed

    def _process_batched(self, batch: int, show_preview: bool = False):
        processed = 0
        start = time.time()
        it = iter(self.source)
        want_pc = self.mode in ("pointcloud", "both")
        try:
            done = False
            pending = None
            while not done or pending is not None:
                frames = []
                if pending is not None:
                    frames.append(pending)
                    pending = None
                while len(frames) < batch:
                    try:
                        f = next(it)
                    except StopIteration:
                        done = True
                        break
                    # Folder sources may yield mixed sizes (the reference
                    # tolerates them): flush the batch at a shape change.
                    if frames and f[0].shape != frames[0][0].shape:
                        pending = f
                        break
                    frames.append(f)
                if not frames:
                    break
                images = np.stack([f[0] for f in frames])
                depths, cloud = self._to_host(*self._device_batch(images))

                for i, (image, timestamp, identifier) in enumerate(frames):
                    depth = depths[i]
                    if self.mode in ("images", "both"):
                        self._save_depth(depth, identifier)
                    points = colors = None
                    if want_pc:
                        xyz, rgb, msk = cloud
                        points, colors = xyz[i][msk[i]], rgb[i][msk[i]]
                        self._save_pointcloud(points, colors, identifier)
                    self._publish_ros2(depth, points, colors, timestamp)
                    if show_preview:
                        self._show_preview(image, depth, identifier)
                    processed += 1
                    if processed % 10 == 0:
                        fps = processed / (time.time() - start)
                        logger.info("Processed %d frames (%.1f fps)",
                                    processed, fps)
        except KeyboardInterrupt:
            logger.info("Processing interrupted by user")
        finally:
            elapsed = max(time.time() - start, 1e-9)
            logger.info("Processed %d frames in %.1fs (%.1f fps)",
                        processed, elapsed, processed / elapsed)
            self.cleanup()
        return processed

    def _publish_ros2(self, depth, points, colors, timestamp):
        if self.ros2_node is not None and self.ros2_node.should_publish():
            self.ros2_node.publish_camera_info(self.source.intrinsics,
                                               timestamp)
            if self.mode in ("images", "both"):
                self.ros2_node.publish_depth_image(depth, timestamp)
            if self.mode in ("pointcloud", "both") and points is not None:
                self.ros2_node.publish_pointcloud(points, colors, timestamp)
            self.ros2_node.spin_once()

    # ------------------------------------------------------------- outputs

    def _vis_image(self, depth: np.ndarray) -> np.ndarray:
        # Normalize by max_depth — reference behavior (:910-915), not min-max.
        cv2 = require_cv2("the depth visualization")
        norm = np.clip(depth / self.max_depth, 0, 1)
        return cv2.applyColorMap((norm * 255).astype(np.uint8), self.colormap)

    def _save_depth(self, depth: np.ndarray, identifier: str):
        if self.save_raw_depth:
            save_depth_npy(str(self.depth_dir / f"{identifier}_depth.npy"),
                           depth)
        require_cv2("the depth visualization").imwrite(
            str(self.vis_dir / f"{identifier}_depth_vis.png"),
            self._vis_image(depth))
        save_depth_png16(str(self.depth_dir / f"{identifier}_depth.png"),
                         depth)

    def _save_pointcloud(self, points, colors, identifier: str):
        if points is None or len(points) == 0:
            return
        self.pc_generator.save_ply(str(self.pc_dir / f"{identifier}.ply"),
                                   points, colors)

    def _show_preview(self, image: np.ndarray, depth: np.ndarray, identifier: str):
        cv2 = require_cv2("the preview window")
        vis = self._vis_image(depth)
        h, w = image.shape[:2]
        if w > 640:
            s = 640 / w
            image = cv2.resize(image, None, fx=s, fy=s)
            vis = cv2.resize(vis, None, fx=s, fy=s)
        cv2.imshow(f"Depth Anything - {identifier}", np.hstack([image, vis]))
        if cv2.waitKey(1) & 0xFF == ord("q"):
            raise KeyboardInterrupt

    def cleanup(self):
        self.source.close()
        # only a preview opens windows (a headless OpenCV has none to close)
        cv2 = cv2_or_none() if self._previewed else None
        if cv2 is not None:
            cv2.destroyAllWindows()
        if self.ros2_node is not None:
            self.ros2_node.shutdown()
