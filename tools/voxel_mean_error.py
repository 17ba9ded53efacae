#!/usr/bin/env python3
"""Voxel means of ``txr`` and of the port against a float64 reduce of the
same rows, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/voxel_mean_error.py [--sizes 9216:0.05 ...]

Uniform points, x and y in +-20 m and z in 25 to 50 m (seeded), go through
``txr.ops.voxel.voxel_downsample`` (segment sums as differences of one
global f32 cumulative sum) and ``txr_torch.ops.voxel.voxel_downsample`` on
CPU tensors (the plain version of the segmented scan, which restarts at
every voxel). Both are held against float64 means of the same rows keyed
the same way. Prints one JSON line per size: the max and median error of
each. The largest default size takes about a minute and a few GB.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from txr.core.types import PointSet as JPointSet  # noqa: E402
from txr.ops.voxel import voxel_downsample as j_voxel  # noqa: E402
from txr_torch.core.types import PointSet  # noqa: E402
from txr_torch.ops.voxel import voxel_downsample as t_voxel  # noqa: E402


def f64_means(xyz: np.ndarray, voxel: float) -> np.ndarray:
    k = np.floor((xyz - xyz.min(0)) / np.float32(voxel)).astype(np.int64)
    packed = (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]
    order = np.argsort(packed, kind="stable")
    ps = packed[order]
    starts = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
    sums = np.add.reduceat(xyz[order].astype(np.float64), starts, axis=0)
    return sums / np.diff(np.r_[starts, len(ps)])[:, None]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", nargs="*",
                    default=["9216:0.05", "65536:0.05", "1048576:0.005",
                             "4194304:0.005"],
                    help="rows:voxel_size pairs")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for item in args.sizes:
        n, voxel = item.split(":")
        n, voxel = int(n), float(voxel)
        rng = np.random.default_rng(args.seed)
        xyz = np.stack([rng.uniform(-20, 20, n), rng.uniform(-20, 20, n),
                        rng.uniform(25, 50, n)], 1).astype(np.float32)
        rgb = np.zeros_like(xyz)
        mask = np.ones(n, bool)
        ref = f64_means(xyz, voxel)
        jo = j_voxel(JPointSet(jnp.asarray(xyz), jnp.asarray(rgb),
                               jnp.asarray(mask)), voxel)
        j = np.asarray(jo.xyz)[np.asarray(jo.mask)]
        to = t_voxel(PointSet(*(torch.from_numpy(a) for a in
                                (xyz, rgb, mask))), voxel)
        t = to.xyz[to.mask].numpy()
        ej = np.abs(j - ref).max(1)
        et = np.abs(t - ref).max(1)
        print(json.dumps({"rows": n, "voxel_m": voxel, "voxels": len(ref),
                          "txr_max_m": float(ej.max()),
                          "txr_median_m": float(np.median(ej)),
                          "port_max_m": float(et.max()),
                          "port_median_m": float(np.median(et))}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
