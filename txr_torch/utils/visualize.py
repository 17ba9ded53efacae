"""Interactive reconstruction view, the counterpart of
``txr/utils/visualize.py``.

A Plotly Scatter3d view of the fused cloud and camera triads, matching the
reference's visualize_with_plotly / visualize_reconstruction
(depth_to_reconstruction.py:706-767). Plotly is optional and imported at
first use; without it the cloud's statistics are printed instead.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _plotly_go():
    """``plotly.graph_objects``, or None when Plotly is not installed."""
    try:
        import plotly.graph_objects as go
    except ImportError:
        return None
    return go


def print_cloud_stats(points: np.ndarray, title: str = "Reconstruction"
                      ) -> None:
    if len(points) == 0:
        print(f"{title}: empty cloud")
        return
    mn, mx = points.min(axis=0), points.max(axis=0)
    print(f"{title}: {len(points)} points")
    print(f"  X range: [{mn[0]:.3f}, {mx[0]:.3f}]")
    print(f"  Y range: [{mn[1]:.3f}, {mx[1]:.3f}]")
    print(f"  Z range: [{mn[2]:.3f}, {mx[2]:.3f}]")


def visualize_reconstruction(
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    poses: Optional[List[Tuple[np.ndarray, np.ndarray]]] = None,
    title: str = "3D Reconstruction",
    max_points: int = 200_000,
) -> None:
    """Open an interactive 3D view (or print stats when Plotly is absent)."""
    print_cloud_stats(points, title)
    go = _plotly_go()
    if go is None:
        print("(plotly not available — skipping interactive visualization)")
        return
    if len(points) > max_points:
        idx = np.random.default_rng(0).choice(len(points), max_points,
                                              replace=False)
        points = points[idx]
        colors = colors[idx] if colors is not None else None

    marker = dict(size=1)
    if colors is not None:
        c = colors if colors.max() > 1.5 else colors * 255.0
        marker["color"] = [f"rgb({int(r)},{int(g)},{int(b)})"
                           for r, g, b in c]
    traces = [go.Scatter3d(x=points[:, 0], y=points[:, 1], z=points[:, 2],
                           mode="markers", marker=marker, name="points")]

    if poses:
        span = (np.linalg.norm(points.max(0) - points.min(0))
                if len(points) else 0.0)
        axis_len = 0.1 * float(span or 1.0)
        for i, (R, t) in enumerate(poses):
            center = -np.asarray(R).T @ np.asarray(t).reshape(3)
            for ax, col in zip(range(3), ("red", "green", "blue")):
                tip = center + np.asarray(R).T[:, ax] * axis_len
                traces.append(go.Scatter3d(
                    x=[center[0], tip[0]], y=[center[1], tip[1]],
                    z=[center[2], tip[2]], mode="lines",
                    line=dict(color=col, width=3), showlegend=False,
                    name=f"cam{i}"))

    fig = go.Figure(data=traces)
    fig.update_layout(title=title, scene=dict(aspectmode="data"))
    fig.show()


def visualize_with_plotly(points, colors=None, poses=None,
                          title: str = "3D Reconstruction"):
    """Reference-named alias (depth_to_reconstruction.py:706-767)."""
    visualize_reconstruction(points, colors, poses, title)
