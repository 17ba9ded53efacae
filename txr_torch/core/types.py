"""Typed tensor containers.

Mirrors ``txr/core/types.py``: every stage of the pipeline produces a
data-dependent number of points, and ``PointSet`` carries them as a
fixed-capacity buffer plus a validity mask so shapes stay static from frame
to frame. Compaction to dense arrays happens only at the host boundary.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from txr_torch.core.device import resolve_device


class PointSet:
    """Fixed-capacity masked point cloud.

    Attributes:
      xyz:   (N, 3) float32 positions. Invalid slots hold zeros.
      rgb:   (N, 3) float32 colors in [0, 1]. Invalid slots hold zeros.
      mask:  (N,) bool validity.
    """

    def __init__(self, xyz: torch.Tensor, rgb: torch.Tensor,
                 mask: torch.Tensor):
        self.xyz = xyz
        self.rgb = rgb
        self.mask = mask

    # -- constructors ------------------------------------------------------

    @classmethod
    def empty(cls, capacity: int,
              device: Optional[Union[str, torch.device]] = None
              ) -> "PointSet":
        dev = resolve_device(device)
        return cls(
            xyz=torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
            rgb=torch.zeros((capacity, 3), dtype=torch.float32, device=dev),
            mask=torch.zeros((capacity,), dtype=torch.bool, device=dev),
        )

    @classmethod
    def from_numpy(cls, xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None,
                   device: Optional[Union[str, torch.device]] = None
                   ) -> "PointSet":
        """Build a PointSet from dense host arrays, optionally padded to
        ``capacity`` (rows past it are dropped)."""
        dev = resolve_device(device)
        n = xyz.shape[0]
        cap = capacity if capacity is not None else n
        if rgb is None:
            rgb = np.zeros_like(xyz)
        out_xyz = np.zeros((cap, 3), np.float32)
        out_rgb = np.zeros((cap, 3), np.float32)
        out_mask = np.zeros((cap,), bool)
        m = min(n, cap)
        out_xyz[:m] = xyz[:m]
        out_rgb[:m] = rgb[:m]
        out_mask[:m] = True
        return cls(torch.from_numpy(out_xyz).to(dev),
                   torch.from_numpy(out_rgb).to(dev),
                   torch.from_numpy(out_mask).to(dev))

    def to(self, device: Union[str, torch.device]) -> "PointSet":
        return PointSet(self.xyz.to(device), self.rgb.to(device),
                        self.mask.to(device))

    # -- properties --------------------------------------------------------

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xyz.device

    def count(self) -> torch.Tensor:
        """Number of valid points (0-d tensor on the set's device)."""
        return self.mask.sum(dtype=torch.int32)

    # -- host-boundary compaction -------------------------------------------

    def to_numpy(self):
        """Compact to dense (n, 3) float arrays on the host."""
        xyz = self.xyz.detach().cpu().numpy()
        rgb = self.rgb.detach().cpu().numpy()
        mask = self.mask.detach().cpu().numpy()
        return xyz[mask], rgb[mask]

    def __repr__(self):
        return f"PointSet(capacity={self.capacity}, device={self.device})"


def concatenate(sets: Sequence[PointSet]) -> PointSet:
    """Concatenate PointSets along the capacity axis."""
    return PointSet(
        xyz=torch.cat([s.xyz for s in sets], dim=0),
        rgb=torch.cat([s.rgb for s in sets], dim=0),
        mask=torch.cat([s.mask for s in sets], dim=0),
    )
