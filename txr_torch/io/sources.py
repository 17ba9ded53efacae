"""Frame sources: folder / camera / video, with the reference's iterator
contract ``__next__() -> (bgr_image, timestamp, identifier)`` plus an
``.intrinsics`` attribute (reference: depth_processor.py:453-662). The
counterpart of ``txr/io/sources.py``: the same frames, identifiers and
intrinsics.

JPEG decode goes through the port's own C++ stage (``txr_torch._native``,
libjpeg) with cv2 as the fallback and the codec for other formats, video and
cameras; cv2 is imported at first use. A background prefetch thread
overlaps host decode with device compute.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from txr_torch._native import native_decode_jpeg
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.io.opencv import cv2_or_none, require_cv2

Frame = Tuple[np.ndarray, float, str]

_IMAGE_EXTS = ("jpg", "jpeg", "png", "bmp", "tiff", "tif")


def _read_image(path: str) -> Optional[np.ndarray]:
    """Read a BGR image: native C++ JPEG decode when available (the same
    pixels as cv2's), cv2 otherwise; None when neither can read it."""
    if path.lower().endswith((".jpg", ".jpeg")):
        try:
            with open(path, "rb") as f:
                img = native_decode_jpeg(f.read())
            if img is not None:
                return img
        except OSError:
            return None
        except Exception:
            pass  # fall back to cv2
    cv2 = cv2_or_none()
    if cv2 is None:
        return None
    return cv2.imread(path)


class ImageSource:
    """Base frame source: iterator of (bgr, timestamp, identifier)."""

    intrinsics: Optional[CameraIntrinsics] = None
    # Live sources mark themselves realtime; batched consumers (streaming's
    # stream_batch path) stay per-frame for them to avoid batch latency.
    realtime: bool = False

    def __iter__(self) -> Iterator[Frame]:
        return self

    def __next__(self) -> Frame:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FolderSource(ImageSource):
    """Sorted glob over image files in a directory; unreadable files are
    skipped (reference depth_processor.py:470-519)."""

    def __init__(self, folder: str, intrinsics_path: Optional[str] = None):
        self.folder = folder
        self.files: list[str] = []
        for ext in _IMAGE_EXTS:
            self.files.extend(glob.glob(os.path.join(folder, f"*.{ext}")))
            self.files.extend(glob.glob(os.path.join(folder, f"*.{ext.upper()}")))
        self.files = sorted(set(self.files))
        if not self.files:
            raise FileNotFoundError(f"No images found in {folder}")
        self.index = 0
        if intrinsics_path:
            self.intrinsics = CameraIntrinsics.from_json(intrinsics_path)
        else:
            first = _read_image(self.files[0])
            if first is not None:
                h, w = first.shape[:2]
                self.intrinsics = CameraIntrinsics.default(w, h)
            else:
                self.intrinsics = CameraIntrinsics.default()

    def __len__(self) -> int:
        return len(self.files)

    def __next__(self) -> Frame:
        while self.index < len(self.files):
            path = self.files[self.index]
            self.index += 1
            img = _read_image(path)
            if img is None:  # bad image: skip, like the reference (:513-516)
                continue
            name = os.path.splitext(os.path.basename(path))[0]
            return img, float(self.index - 1), name
        raise StopIteration


class VideoSource(ImageSource):
    """Video-file source with the reference's fps sampling modes
    (depth_processor.py:596-662): '1fps' keeps one frame per source-fps
    frames, 'all' keeps everything, 'custom' keeps fps_percent% of frames.

    Video demux/decode stays on cv2's FFmpeg backend by design: inter-frame
    codecs (H.264 etc.) need a full container/codec stack, the reference
    rides the identical cv2 path, and decode overlaps device compute behind
    PrefetchSource — unlike JPEG/PNG16, it is never the artifact contract."""

    def __init__(
        self,
        path: str,
        fps_mode: str = "1fps",
        fps_percent: float = 100.0,
        intrinsics_path: Optional[str] = None,
    ):
        cv2 = require_cv2("video sources")
        self.cap = cv2.VideoCapture(path)
        if not self.cap.isOpened():
            raise IOError(f"Cannot open video: {path}")
        self.fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        self.total = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        w = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        if fps_mode == "1fps":
            self.skip = max(1, int(self.fps))
        elif fps_mode == "all":
            self.skip = 1
        else:  # custom
            self.skip = max(1, int(100.0 / max(fps_percent, 1e-6)))
        self.frame_index = 0
        if intrinsics_path:
            self.intrinsics = CameraIntrinsics.from_json(intrinsics_path)
        else:
            self.intrinsics = CameraIntrinsics.default(w or 640, h or 480)

    def __next__(self) -> Frame:
        # Skip unreadable frames and keep going, like the reference
        # (depth_processor.py:641-651); bounded by the frame count.
        cv2 = require_cv2("video sources")
        while self.frame_index < self.total:
            self.cap.set(cv2.CAP_PROP_POS_FRAMES, self.frame_index)
            ok, img = self.cap.read()
            idx = self.frame_index
            self.frame_index += self.skip
            if not ok or img is None:
                continue
            return img, idx / self.fps, f"frame_{idx:06d}"
        raise StopIteration

    def close(self) -> None:
        self.cap.release()


class CameraSource(ImageSource):
    """Live camera source with wall-clock capture-interval fps modes
    (reference depth_processor.py:522-593)."""

    realtime = True

    def __init__(
        self,
        device_id: int = 0,
        width: int = 640,
        height: int = 480,
        fps_mode: str = "1fps",
        fps_percent: float = 100.0,
        intrinsics_path: Optional[str] = None,
    ):
        cv2 = require_cv2("camera sources")
        self.cap = cv2.VideoCapture(device_id)
        if not self.cap.isOpened():
            raise IOError(f"Cannot open camera {device_id}")
        self.cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        self.cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        actual_w = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH)) or width
        actual_h = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT)) or height
        cam_fps = self.cap.get(cv2.CAP_PROP_FPS) or 30.0
        if fps_mode == "1fps":
            self.interval = 1.0
        elif fps_mode == "all":
            self.interval = 0.0
        else:
            self.interval = 1.0 / max(cam_fps * fps_percent / 100.0, 1e-6)
        self._last_ts = 0.0
        self._count = 0
        if intrinsics_path:
            self.intrinsics = CameraIntrinsics.from_json(intrinsics_path)
        else:
            self.intrinsics = CameraIntrinsics.default(actual_w, actual_h)

    def __next__(self) -> Frame:
        while True:
            ok, img = self.cap.read()
            if not ok or img is None:
                raise StopIteration
            now = time.time()
            if now - self._last_ts >= self.interval:
                self._last_ts = now
                name = f"camera_{self._count:06d}"
                self._count += 1
                return img, now, name
            # off-interval frame: discard and keep reading (reference :576-589)

    def close(self) -> None:
        self.cap.release()


class PrefetchSource(ImageSource):
    """Wrap any source with a background decode thread + bounded queue so
    host I/O overlaps device compute (SURVEY §2.6 'host-pipeline')."""

    _SENTINEL = object()

    def __init__(self, inner: ImageSource, depth: int = 4):
        self.inner = inner
        self.intrinsics = inner.intrinsics
        self.realtime = getattr(inner, "realtime", False)
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for frame in self.inner:
                if self._stop.is_set():
                    return
                self.q.put(frame)
        finally:
            self.q.put(self._SENTINEL)

    def __next__(self) -> Frame:
        item = self.q.get()
        if item is self._SENTINEL:
            raise StopIteration
        return item

    def close(self) -> None:
        self._stop.set()
        # drain so the worker can observe the stop flag
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.inner.close()


def make_source(
    source: str,
    input_path: str = "./images",
    video_path: Optional[str] = None,
    device_id: int = 0,
    width: int = 640,
    height: int = 480,
    fps_mode: str = "1fps",
    fps_percent: float = 100.0,
    intrinsics_path: Optional[str] = None,
    prefetch: bool = True,
) -> ImageSource:
    """Factory matching the reference CLI's --source choices."""
    if source == "folder":
        src: ImageSource = FolderSource(input_path, intrinsics_path)
    elif source == "video":
        if not video_path:
            raise ValueError("--video-path is required for video source")
        src = VideoSource(video_path, fps_mode, fps_percent, intrinsics_path)
    elif source == "camera":
        src = CameraSource(device_id, width, height, fps_mode, fps_percent, intrinsics_path)
        prefetch = False  # live camera: prefetch would fight the interval logic
    else:
        raise ValueError(f"Unknown source type: {source}")
    return PrefetchSource(src) if prefetch else src
