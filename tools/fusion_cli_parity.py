#!/usr/bin/env python3
"""The fusion CLI's pipeline in ``txr`` and in the port on the CPU, on the
two synthetic scenes of ``tests/test_torch_fusion_cli.py``, with the same
SIFT (OpenCV) and the same RANSAC draws.

    JAX_PLATFORMS=cpu python3 tools/fusion_cli_parity.py

For each scene (``test_fusion_pipeline.py``'s and ``test_golden.py``'s)
prints one JSON line: each view's pose difference, the scales both
narrate, the point counts, the chamfer distance between the two clouds
and, for the golden scene, each cloud's chamfer distance to
``tests/golden/fusion_scene.ply``. Then, for every pair whose homography
RANSAC keeps another winner in the two packages, one line with both
winners, their inlier counts, the rows on which they differ and those
rows' transfer errors under each side's fit of the port's winner. About a
minute and a half on 8 cores (most of it compiling ``txr``'s programs).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import pathlib
import sys
import tempfile

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

from test_torch_fusion_cli import (GOLDEN, SCALE_LINE, SCENES,  # noqa: E402
                                   ROWS, homography_winners,
                                   record_pairs, txr_priorities)
from txr.core.config import ReconstructionConfig as JConfig  # noqa: E402
from txr.io.ply import read_ply  # noqa: E402
from txr.pipelines import fusion_pipeline as jfp  # noqa: E402
from txr.utils.chamfer import chamfer_distance  # noqa: E402
from txr_torch.core.config import ReconstructionConfig  # noqa: E402
from txr_torch.pipelines import fusion_pipeline as tfp  # noqa: E402


def run(side: str, cfg: dict, rgb: str, dep: str):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if side == "txr":
            pipe = jfp.DepthToReconstructionPipeline(
                JConfig(**cfg), feature_capacity=ROWS, feature_backend="cv2")
            pipe.load_data(rgb, dep)
            pts, _, poses = pipe.reconstruct()
        else:
            pipe = tfp.DepthToReconstructionPipeline(
                ReconstructionConfig(**cfg), feature_capacity=ROWS,
                feature_backend="cv2", device="cpu")
            pipe.load_data(rgb, dep)
            with record_pairs() as pairs_out:
                pts, _, poses = pipe.reconstruct(
                    priorities=txr_priorities(2, ROWS))
    scales = [float(a or b) for a, b in SCALE_LINE.findall(buf.getvalue())]
    return pts, poses, scales, (pairs_out[0] if side == "port" else None)


def main() -> int:
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    for name, sc in SCENES.items():
        with tempfile.TemporaryDirectory() as td:
            rgb, dep = sc["build"](pathlib.Path(td))
            jp, jposes, js, _ = run("txr", sc["cfg"], rgb, dep)
            tp, tposes, ts, pairs_out = run("port", sc["cfg"], rgb, dep)
            line = {"scene": name, "views": [
                {"view": i, "R_max_abs_diff": float(np.abs(a[0] - b[0]).max()),
                 "t_max_abs_diff": float(np.abs(a[1] - b[1]).max())}
                for i, (a, b) in enumerate(zip(tposes, jposes))],
                "scales_txr": js, "scales_port": ts,
                "scale_rel_diff": [abs(a / b - 1) for a, b in zip(ts, js)],
                "points": {"txr": len(jp), "port": len(tp)},
                "chamfer_port_txr": chamfer_distance(tp, jp),
                "depth_p85_txr": float(np.percentile(jp[:, 2], 85))}
            if name == "golden":
                gold, _ = read_ply(str(GOLDEN))
                line["chamfer_to_golden"] = {
                    "txr": chamfer_distance(jp, gold),
                    "port": chamfer_distance(tp, gold),
                    "scene_p85": float(np.percentile(gold[:, 2], 85))}
            print(json.dumps(line), flush=True)
            for row in homography_winners(pairs_out, sc["cfg"],
                                          txr_priorities(2, ROWS)):
                print(json.dumps(dict(row, scene=name)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
