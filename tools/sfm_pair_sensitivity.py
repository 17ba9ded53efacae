#!/usr/bin/env python3
"""One pair of ``chip_smoke.py``'s floor-and-wall scene through ``txr``'s
and the port's sparse pair stage on the CPU, with the same RANSAC draws.

    JAX_PLATFORMS=cpu python3 tools/sfm_pair_sensitivity.py [--pair 5] [--keys 8]

Renders the scene at the fusion CLI's operating point (1080 x 1920, K of
``depth_to_reconstruction.py``), detects SIFT on the pair's two frames with
the port (``device="cpu"``), and for each ``jax.random`` key runs
``txr.pipelines.fusion_pipeline._pairs_batch`` and the port's
``_pairs_batch`` with that key's draw passed as ``priorities=``. Prints one
JSON line per key: each side's rotation and translation-direction error
against the scene's truth and inlier count, and the rows whose essential
RANSAC inlier flag differs between the two, with their Sampson error over
the threshold under ``txr``'s final E. A few minutes on 8 cores (most of it
compiling ``txr``'s program and SIFT at 1080p).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from txr.geometry import epipolar as j_epi  # noqa: E402
from txr.pipelines.fusion_pipeline import _pairs_batch as j_pairs  # noqa: E402
from txr_torch.geometry import epipolar as t_epi  # noqa: E402
from txr_torch.geometry.features import SIFTDetector  # noqa: E402
from txr_torch.pipelines.fusion_pipeline import _pairs_batch as t_pairs  # noqa: E402


def chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pair", type=int, default=5)
    ap.add_argument("--keys", type=int, default=8)
    args = ap.parse_args()
    cs = chip_smoke()
    p = args.pair
    scene = cs.two_plane_scene(cs.SFM_H, cs.SFM_W, cs.SFM_K, p + 2, "cpu")
    R_true, t_dir = cs.relative_truth(scene["R"], scene["t"])
    det = SIFTDetector(**cs.SFM_SIFT, backend="device", device="cpu")
    desc, fmask, fuv = (a.numpy() for a in cs.stack_features(
        det.detect_batch(scene["bgr"][p:p + 2])))
    fx, fy, cx, cy = cs.SFM_K
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    cfg = (cs.SFM_RANSAC["match_ratio"], cs.SFM_RANSAC["ransac_threshold"],
           cs.SFM_RANSAC["min_depth"], cs.SFM_RANSAC["max_depth"])
    hyp = cs.SFM_RANSAC["num_hypotheses"]
    thr = cs.SFM_RANSAC["ransac_threshold"]

    def errors(R, t):
        c = float(np.clip(np.asarray(t, np.float64) @ t_dir[p], -1.0, 1.0))
        return {"rot_err_deg": cs.angle_deg(np.asarray(R), R_true[p]),
                "t_dir_err_deg": float(np.degrees(np.arccos(c)))}

    for k in range(args.keys):
        key = jax.random.PRNGKey(k)
        want = j_pairs(jnp.asarray(desc), jnp.asarray(fmask),
                       jnp.asarray(fuv), jnp.asarray(K), key[None], *cfg,
                       num_hypotheses=hyp)
        u1, u2, ok = (np.asarray(a[0]) for a in want[6:9])
        kE, kH = jax.random.split(key)
        prio = np.stack([np.asarray(jax.random.uniform(kk, (hyp, len(u1))))
                         for kk in (kE, kH)])[None]
        got = t_pairs(*(torch.from_numpy(a) for a in (desc, fmask, fuv, K)),
                      None, *cfg, num_hypotheses=hyp,
                      priorities=torch.from_numpy(prio))
        E_j, inl_j = j_epi.essential_ransac(
            jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(ok),
            jnp.asarray(K), kE, thr, hyp)
        _, inl_t = t_epi.essential_ransac(
            *(torch.from_numpy(a) for a in (u1, u2, ok, K)), None, thr, hyp,
            priorities=torch.from_numpy(prio[0, 0]))
        rows = np.nonzero(np.asarray(inl_j) != inl_t.numpy())[0]
        Kinv = np.linalg.inv(K)
        n1 = (np.c_[u1, np.ones(len(u1))] @ Kinv.T)[:, :2].astype(np.float32)
        n2 = (np.c_[u2, np.ones(len(u2))] @ Kinv.T)[:, :2].astype(np.float32)
        err = np.asarray(j_epi.sampson_error(E_j, jnp.asarray(n1),
                                             jnp.asarray(n2)))
        print(json.dumps({
            "pair": [p, p + 1], "key": k,
            "txr": dict(errors(want[0][0], want[1][0]),
                        inliers=int(want[4][0])),
            "port": dict(errors(got[0][0], got[1][0]),
                         inliers=int(got[4][0])),
            "essential_inlier_rows_differing": rows.tolist(),
            "their_sampson_over_threshold_under_txr_E":
                (err[rows] / (thr / fx) ** 2).tolist()}), flush=True)


if __name__ == "__main__":
    main()
