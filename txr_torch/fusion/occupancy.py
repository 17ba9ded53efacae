"""2D occupancy-grid projection of the fused voxel map, the counterpart
of ``txr/fusion/occupancy.py`` (host numpy; the same PGM and YAML bytes).

The reference's streaming mode delegates mapping to rtabmap_slam, whose
second product (besides the 3D cloud) is a 2D occupancy grid bounded by
``Grid/RangeMax`` / ``Grid/DepthMax`` = 5 m (reference
ros2_ws/src/monocular_slam/launch/slam.launch.py:126-145). The in-process
streaming mode owns the map itself, so it emits that artifact too: the
fused points are projected onto the world ground plane and written as a
ROS ``map_server`` PGM + YAML pair.

World frame: the first camera frame anchors the world, so +y points DOWN
(camera convention) and the ground plane is the x-z plane; height above
ground is ``-y`` relative to an estimated ground level.

It runs once, at save time, on the compacted host cloud.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

# ROS OccupancyGrid cell values.
UNKNOWN = -1
FREE = 0
OCCUPIED = 100


def occupancy_grid(
    xyz: np.ndarray,
    camera_centers: Optional[np.ndarray] = None,
    cell_size: float = 0.05,
    range_max: float = 5.0,
    ground_band: float = 0.10,
    max_obstacle_height: float = 2.0,
    min_points: int = 2,
    footprint_radius: float = 0.30,
    max_cells: int = 4096,
) -> Tuple[np.ndarray, Tuple[float, float]]:
    """Project world-frame points to a 2D occupancy grid.

    Args:
      xyz: (N, 3) float world points (y down).
      camera_centers: optional (P, 3) camera centers in world frame; points
        farther than `range_max` from every center are dropped (the
        Grid/RangeMax cutoff) and cells under a center's footprint are
        marked free.  With no centers, the cutoff is measured from origin.
      cell_size: grid resolution in meters (rtabmap Grid/CellSize default).
      ground_band: height band above the estimated ground treated as floor
        (free evidence) rather than obstacle.
      max_obstacle_height: points higher than this above ground are ignored
        (ceiling / overhanging structure does not block a 2D footprint).
      min_points: cell occupancy/free threshold in point counts.
      footprint_radius: radius around each camera center marked free.
      max_cells: safety clamp on either grid dimension.

    Returns:
      (grid, origin): grid is (rows, cols) int8 in ROS convention
      (-1 unknown / 0 free / 100 occupied) with row = z index, col = x
      index; origin is the world (x, z) of the grid's [0, 0] cell corner.
    """
    xyz = np.asarray(xyz, np.float64).reshape(-1, 3)
    if camera_centers is None or len(camera_centers) == 0:
        centers = np.zeros((1, 3))
    else:
        centers = np.asarray(camera_centers, np.float64).reshape(-1, 3)

    # Range cutoff: min distance to any camera center, chunked so the
    # (N, P) distance matrix never materializes at full size.
    if len(xyz):
        keep = np.zeros(len(xyz), bool)
        for s in range(0, len(xyz), 262144):
            blk = xyz[s:s + 262144]
            d2 = ((blk[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
            keep[s:s + 262144] = d2.min(axis=1) <= range_max * range_max
        xyz = xyz[keep]

    # Ground level: robust low percentile of height (= -y).
    if len(xyz):
        h = -xyz[:, 1]
        ground = np.percentile(h, 2.0)
        rel = h - ground
        is_ground = rel < ground_band
        is_obst = (rel >= ground_band) & (rel <= max_obstacle_height)
    else:
        is_ground = is_obst = np.zeros(0, bool)

    # Grid extents cover both points and camera footprints.
    fx = np.concatenate([xyz[:, 0], centers[:, 0]])
    fz = np.concatenate([xyz[:, 2], centers[:, 2]])
    pad = max(footprint_radius, cell_size)
    x0 = float(np.floor((fx.min() - pad) / cell_size) * cell_size) if len(fx) else 0.0
    z0 = float(np.floor((fz.min() - pad) / cell_size) * cell_size) if len(fz) else 0.0
    cols = int(min(max_cells, np.ceil((fx.max() + pad - x0) / cell_size))) if len(fx) else 1
    rows = int(min(max_cells, np.ceil((fz.max() + pad - z0) / cell_size))) if len(fz) else 1
    cols, rows = max(cols, 1), max(rows, 1)

    def cell_ids(pts):
        cx = np.clip(((pts[:, 0] - x0) / cell_size).astype(np.int64), 0, cols - 1)
        cz = np.clip(((pts[:, 2] - z0) / cell_size).astype(np.int64), 0, rows - 1)
        return cz * cols + cx

    n_cells = rows * cols
    obst_count = np.bincount(cell_ids(xyz[is_obst]), minlength=n_cells) \
        if is_obst.any() else np.zeros(n_cells, np.int64)
    ground_count = np.bincount(cell_ids(xyz[is_ground]), minlength=n_cells) \
        if is_ground.any() else np.zeros(n_cells, np.int64)

    grid = np.full(n_cells, UNKNOWN, np.int8)
    grid[ground_count >= min_points] = FREE
    grid[obst_count >= min_points] = OCCUPIED
    grid = grid.reshape(rows, cols)

    # Camera footprints are traversed space: free unless observed occupied.
    r_cells = max(int(np.ceil(footprint_radius / cell_size)), 0)
    for c in centers:
        ci = int((c[0] - x0) / cell_size)
        cj = int((c[2] - z0) / cell_size)
        j_lo, j_hi = max(cj - r_cells, 0), min(cj + r_cells + 1, rows)
        i_lo, i_hi = max(ci - r_cells, 0), min(ci + r_cells + 1, cols)
        patch = grid[j_lo:j_hi, i_lo:i_hi]
        patch[patch == UNKNOWN] = FREE

    return grid, (x0, z0)


def write_occupancy_map(path_stem: str, grid: np.ndarray,
                        origin: Tuple[float, float], cell_size: float) -> str:
    """Write `<stem>.pgm` + `<stem>.yaml` in ROS map_server format.

    PGM encoding follows map_server conventions: occupied -> 0 (black),
    free -> 254 (white), unknown -> 205 (gray).  Row 0 of the PGM is the
    TOP of the image, i.e. the highest z row (image y axis points down).
    """
    img = np.full(grid.shape, 205, np.uint8)
    img[grid == FREE] = 254
    img[grid == OCCUPIED] = 0
    img = img[::-1, :]  # image origin top-left; world z grows upward in map

    pgm_path = path_stem + ".pgm"
    with open(pgm_path, "wb") as f:
        f.write(b"P5\n# txr occupancy grid\n")
        f.write(f"{img.shape[1]} {img.shape[0]}\n255\n".encode())
        f.write(img.tobytes())
    with open(path_stem + ".yaml", "w") as f:
        f.write(
            f"image: {os.path.basename(pgm_path)}\n"
            f"resolution: {cell_size}\n"
            f"origin: [{origin[0]:.6f}, {origin[1]:.6f}, 0.0]\n"
            "negate: 0\noccupied_thresh: 0.65\nfree_thresh: 0.196\n")
    return pgm_path
