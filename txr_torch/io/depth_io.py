"""Depth-map file I/O: .npy float32, 16-bit millimeter PNG, EXR. The
counterpart of ``txr/io/depth_io.py``: the same files for the same arrays.

Reference parity: DepthImageLoader (depth_to_reconstruction.py:76-119) with its
six filename-matching patterns, and DepthProcessor._save_depth's three outputs
(depth_processor.py:905-921): raw .npy, colormapped visualization PNG, and
uint16 millimeter PNG (depth * 1000).

The uint16 PNG (the depth artifact contract) encodes/decodes through the
port's C++ libpng stage (``txr_torch._native``), with cv2 as the fallback
codec; the lossy colormap visualization and EXR remain on cv2, which is
imported at first use.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from txr_torch._native import native_decode_png16, native_encode_png16
from txr_torch.io.opencv import cv2_or_none

_COLORMAP_NAMES = ("jet", "magma", "inferno", "viridis", "plasma", "turbo")


def get_colormap(name: str) -> int:
    """Name → OpenCV colormap constant (reference
    depth_processor.py:1059-1069); unknown names give jet's, and without
    OpenCV 2 (jet's value)."""
    cv2 = cv2_or_none()
    if cv2 is None:
        return 2
    table = {n: getattr(cv2, f"COLORMAP_{n.upper()}")
             for n in _COLORMAP_NAMES}
    return table.get(name.lower(), table["jet"])


def load_depth(path: str) -> np.ndarray:
    """Load a depth map in meters from .npy / 16-bit .png (mm) / .exr."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path).astype(np.float32)
    if ext == ".png":
        # Native libpng path first (16-bit grayscale = the mm contract).
        with open(path, "rb") as f:
            data = f.read()
        img = native_decode_png16(data)
        if img is not None:
            return img.astype(np.float32) / 1000.0  # millimeters → meters
    cv2 = cv2_or_none()
    if cv2 is None:
        raise IOError(f"OpenCV is required to read {ext} depth maps "
                      f"(install opencv-python or use .npy): {path}")
    if ext in (".png", ".tiff", ".tif"):
        img = cv2.imread(path, cv2.IMREAD_ANYDEPTH)
        if img is None:
            raise IOError(f"Failed to read depth image: {path}")
        if img.dtype == np.uint16:
            return img.astype(np.float32) / 1000.0  # millimeters → meters
        return img.astype(np.float32)
    if ext == ".exr":
        img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
        if img is None:
            raise IOError(f"Failed to read EXR depth: {path}")
        if img.ndim == 3:
            img = img[..., 0]
        return img.astype(np.float32)
    raise ValueError(f"Unsupported depth format: {path}")


# Filename patterns tried when pairing an RGB frame with its depth map
# (reference depth_to_reconstruction.py:100-119).
_DEPTH_PATTERNS = (
    "{stem}_depth.npy",
    "{stem}_depth.png",
    "{stem}.npy",
    "{stem}.png",
    "depth_{stem}.npy",
    "depth_{stem}.png",
)


def find_matching_depth(rgb_path: str, depth_folder: str) -> Optional[str]:
    """Locate the depth file matching an RGB frame by filename stem."""
    stem = os.path.splitext(os.path.basename(rgb_path))[0]
    for pat in _DEPTH_PATTERNS:
        cand = os.path.join(depth_folder, pat.format(stem=stem))
        if os.path.exists(cand):
            return cand
    return None


def save_depth_npy(path: str, depth: np.ndarray) -> None:
    np.save(path, depth.astype(np.float32))


def save_depth_png16(path: str, depth: np.ndarray) -> None:
    """16-bit millimeter PNG: (depth_m * 1000).astype(uint16) — the
    reference's exact cast (reference :917-921), kept for byte parity with
    its artifacts. Note the
    cast WRAPS above 65.535 m, as the reference's does; scenes are clamped
    to max_depth (≤ 50 m default) well before this point."""
    mm = (depth * 1000).astype(np.uint16)
    data = native_encode_png16(mm)
    if data is not None:
        with open(path, "wb") as f:
            f.write(data)
        return
    cv2 = cv2_or_none()
    if cv2 is None:
        raise IOError("A PNG codec (native libpng or opencv-python) is "
                      "required to write 16-bit depth PNGs; or save .npy")
    cv2.imwrite(path, mm)


def depth_to_colormap(depth: np.ndarray, colormap: int | str = "jet") -> np.ndarray:
    """Normalize depth to uint8 and apply a colormap → BGR uint8 image
    (reference depth_processor.py:909-915)."""
    cv2 = cv2_or_none()
    if cv2 is None:
        raise IOError("OpenCV is required for colormap rendering "
                      "(install opencv-python)")
    if isinstance(colormap, str):
        colormap = get_colormap(colormap)
    valid = np.isfinite(depth)
    if valid.any():
        lo = float(depth[valid].min())
        hi = float(depth[valid].max())
    else:
        lo, hi = 0.0, 1.0
    rng = hi - lo if hi > lo else 1.0
    norm = np.clip((depth - lo) / rng * 255.0, 0, 255).astype(np.uint8)
    return cv2.applyColorMap(norm, colormap)


def save_depth_vis(path: str, depth: np.ndarray, colormap: int | str = "jet") -> None:
    vis = depth_to_colormap(depth, colormap)
    cv2_or_none().imwrite(path, vis)


class DepthImageLoader:
    """Reference-named facade (depth_to_reconstruction.py:76-119)."""

    @staticmethod
    def load_depth(path: str) -> np.ndarray:
        return load_depth(path)

    @staticmethod
    def find_matching_depth(rgb_name: str, depth_folder) -> Optional[str]:
        return find_matching_depth(str(rgb_name), str(depth_folder))
