#!/usr/bin/env python3
"""The stepwise streaming reconstruction of ``txr`` and of the port on
``chip_smoke.py``'s floor-and-wall scene, on the CPU: what loop closure
does to the trajectory, what ICP at a wider correspondence does, and what
metric mode's unit translations do.

    JAX_PLATFORMS=cpu python3 tools/stream_closure_drift.py [--div 4]
        [--sections closure,icp,sensitivity,metric]

Renders ``chip_smoke.stream_path``'s ping-pong trajectory (cameras 0 ... 8
... 0, 17 frames) at 1/``div`` of 1080 x 1920 (K scaled with it) and runs
both packages' ``StreamingReconstructor`` with ``stream_path``'s settings
(ICP on, keyframes every 2, closure off and on), once with the relative
depth of ``stream_path`` (metric / 6: true scale 75) and once in
baselines (true scale 1, where the scale EMA starts). The port runs three
ways:

- ``port``: its own draws (a ``torch.Generator``);
- ``port, txr's draws``: ``txr``'s RANSAC draws in ``txr``'s order
  (``tests/test_torch_streaming.py:TxrDraws``), nothing else shared;
- ``port, txr's replay``: ``tests/test_torch_streaming.py:run_port``,
  ``txr``'s draws, and each ``pair_step`` and loop verification held
  against ``txr``'s record and continued with ``txr``'s result (the two
  may stop ``refine_pose`` one step apart on costs equal to f32
  round-off); everything after it (scale, ICP, keyframes, the loop-edge
  ICP, the pose graph and its propagation, the map) is the port's own.

Prints one JSON line per package and setting: the end camera's distance
from the start (the drift, in baselines), the worst pair errors against
the truth, the loops closed, each loop edge's keyframes, the scale after
each update of the EMA (which starts at 1.0) and, for the replay, the
largest pose difference from ``txr``'s (section ``closure``). Then ICP at
1.25 units (0.1 m, the default correspondence of a metric stream, in this
stream's unit of 8 cm), closure off: the frames on which ICP was accepted
and the pair errors (``icp``). Then each loop edge's ICP of the port's
stream in baselines, through both packages on the same inputs and on a
source nudged by a few ulps (``sensitivity``). Then metric mode (the
scene's metric depth, ``metric_depth=True``) over 5 frames: the length of
each chained step, where the scene's camera moves 0.08 m (``metric``).
About forty-five minutes on 8 cores at ``--div 4``; ``--sections`` picks
some.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import chip_smoke as cs  # noqa: E402
import test_torch_streaming as tts  # noqa: E402
from txr.core.config import StreamingConfig as JConfig  # noqa: E402
from txr.core.intrinsics import CameraIntrinsics as JIntr  # noqa: E402
from txr.pipelines import streaming as jst  # noqa: E402
from txr_torch.core.config import StreamingConfig  # noqa: E402
from txr_torch.core.intrinsics import CameraIntrinsics  # noqa: E402
from txr_torch.pipelines import streaming as tst  # noqa: E402

CAP = 4096                    # the reconstructors' default feature capacity
ICP_WIDE = 0.1 / cs.STREAM_UNIT_M


class Depth:
    """One depth map per call, in stream order (numpy, as a model's)."""

    def __init__(self, depth: np.ndarray):
        self.depth, self.i = depth, 0

    def infer(self, bgr, intr=None):
        d = self.depth[self.i]
        self.i += 1
        return d


@contextlib.contextmanager
def recorded(module, name: str, out: list, pick=lambda a, r: r):
    """Wrap ``module.name``, appending ``pick(args, result)`` per call."""
    fn = getattr(module, name)

    def wrapped(*a, **k):
        r = fn(*a, **k)
        out.append(pick(a, r))
        return r

    setattr(module, name, wrapped)
    try:
        yield out
    finally:
        setattr(module, name, fn)


def run(package: str, frames, depth, K, cfg: dict, metric: bool,
        priorities=None):
    h, w = frames[0].shape[:2]
    intr = dict(fx=K[0], fy=K[1], cx=K[2], cy=K[3], width=w, height=h)
    if package == "txr":
        rec = jst.StreamingReconstructor(
            JIntr(**intr), depth_model=Depth(depth),
            config=JConfig(**cfg), use_icp=True, metric_depth=metric,
            feature_capacity=CAP, verbose=False)
    else:
        rec = tst.StreamingReconstructor(
            CameraIntrinsics(**intr), depth_model=Depth(depth),
            config=StreamingConfig(**cfg), use_icp=True,
            metric_depth=metric, feature_capacity=CAP, verbose=False,
            device="cpu", priorities=priorities)
    for i, f in enumerate(frames):
        rec.process_frame(f, float(i), str(i))
    return rec


def icp_frames(package: str, frames, depth, K, cfg: dict) -> tuple:
    """The stream, and the frames whose ICP refinement was kept."""
    mod = jst if package == "txr" else tst
    kept = []
    cls = mod.StreamingReconstructor
    orig = cls._refine_icp

    def refine(self, ps, R, t):
        out = orig(self, ps, R, t)
        if out[2] is not None and not (np.allclose(out[0], R)
                                       and np.allclose(out[1], t)):
            kept.append(len(self.poses))
        return out

    cls._refine_icp = refine
    try:
        rec = run(package, frames, depth, K, cfg, metric=False)
    finally:
        cls._refine_icp = orig
    return rec, kept


def summary(scene, rec, **extra) -> dict:
    pairs, drift = cs.stream_truth(scene, rec.poses)
    return dict(extra, end_drift_baselines=drift,
                worst_rot_err_deg=max(p[0] for p in pairs),
                worst_t_dir_err_deg=max(p[1] for p in pairs),
                loops_closed=rec.loops_closed)


def closure_runs(scene, frames, metric, K) -> None:
    h, w = frames[0].shape[:2]
    modes = {"relative depth = metric / 6": cs.SFM_SCENE["depth_div"],
             "relative depth in baselines (true scale 1)":
             cs.SFM_SCENE["baseline"]}
    for mode, div in modes.items():
        depth = metric / div
        base = dict(mode=mode, size=[h, w],
                    true_scale=div / cs.SFM_SCENE["baseline"])
        for closure in (False, True):
            cfg = dict(cs.STREAM_CFG, loop_closure=closure)
            spec = dict(frames=lambda: frames, f=K[0],
                        model=lambda: Depth(depth), use_icp=True,
                        metric=False, cfg=cfg)
            with recorded(jst, "ema_scale", []) as scales:
                jrec, log = tts.run_txr(spec, frames)
            print(json.dumps(summary(
                scene, jrec, package="txr", closure=closure,
                loop_keyframes=log["closed"],
                scale_updates=[float(s) for s in scales], **base)),
                flush=True)
            for how in ("port", "port, txr's draws", "port, txr's replay"):
                with recorded(tst, "ema_scale", []) as scales:
                    if how == "port, txr's replay":
                        trec, report = tts.run_port(spec, frames, log)
                        extra = {"pair_flips": len(report["pair_flips"]),
                                 "verify_flips": len(report["verify_flips"])}
                    else:
                        trec = run("port", frames, depth, K, cfg, False,
                                   tts.TxrDraws() if "draws" in how
                                   else None)
                        extra = {}
                gap = max(float(max(np.abs(a - c).max(), np.abs(b - d).max()))
                          for (a, b), (c, d) in zip(trec.poses, jrec.poses))
                print(json.dumps(summary(
                    scene, trec, package=how, closure=closure,
                    loop_keyframes=[e[0] for e in trec.loop_edges],
                    scale_updates=[float(s) for s in scales],
                    largest_pose_difference_from_txr=gap, **extra, **base)),
                    flush=True)


def icp_runs(scene, frames, metric, K) -> None:
    cfg = dict(cs.STREAM_CFG, loop_closure=False,
               icp_max_correspondence=ICP_WIDE)
    for package in ("txr", "port"):
        rec, kept = icp_frames(package, frames,
                               metric / cs.SFM_SCENE["depth_div"], K, cfg)
        pairs, _ = cs.stream_truth(scene, rec.poses)
        print(json.dumps(summary(
            scene, rec, package=package, mode="ICP at 0.1 m",
            icp_max_correspondence=ICP_WIDE, icp_kept_on_frames=kept,
            t_dir_err_deg_per_pair=[p[1] for p in pairs])), flush=True)


def loop_icp_sensitivity(scene, frames, metric, K) -> None:
    """Each loop edge's ICP of the port's stream in baselines with closure
    on (where it registers two planes), through both packages'
    ``icp_point_to_plane`` on the same inputs, and again with the source
    scaled by 1 + 2^-22 (a few f32 ulps): how far round-off alone moves
    each package's answer."""
    import jax.numpy as jnp
    from txr.geometry.icp import icp_point_to_plane as j_icp

    calls = []
    cls = tst.StreamingReconstructor
    orig = cls._refine_loop_edge

    def refine(self, *a):
        with recorded(tst, "icp_point_to_plane", calls,
                      pick=lambda args, r: args):
            return orig(self, *a)

    cls._refine_loop_edge = refine
    try:
        run("port", frames, metric / cs.SFM_SCENE["baseline"], K,
            dict(cs.STREAM_CFG, loop_closure=True), False)
    finally:
        cls._refine_loop_edge = orig
    for i, args in enumerate(calls):
        arrs = [a.numpy() for a in args[:7]]
        rest = args[7:]
        nudged = (arrs[0] * np.float32(1 + 2 ** -22)).astype(np.float32)
        out = {}
        for src, tag in ((arrs[0], ""), (nudged, " nudged")):
            R, t, _, f = tst.icp_point_to_plane(
                torch.from_numpy(src), *map(torch.from_numpy, arrs[1:]),
                *rest)
            out["port" + tag] = (R.numpy(), t.numpy(), float(f))
            R, t, _, f = j_icp(jnp.asarray(src), *map(jnp.asarray, arrs[1:]),
                               *rest)
            out["txr" + tag] = (np.asarray(R), np.asarray(t), float(f))

        def gap(a, b):
            return {"R": float(np.abs(out[a][0] - out[b][0]).max()),
                    "t": float(np.abs(out[a][1] - out[b][1]).max())}

        print(json.dumps({
            "mode": "loop-edge ICP, baselines, closure on", "edge": i,
            "inlier_fraction": {k: v[2] for k, v in out.items()},
            "t": {k: v[1].tolist() for k, v in out.items()},
            "port_vs_txr": gap("port", "txr"),
            "txr_vs_txr_nudged": gap("txr", "txr nudged"),
            "port_vs_port_nudged": gap("port", "port nudged")}), flush=True)


def metric_runs(scene, frames, metric, K) -> None:
    n = 5
    for package in ("txr", "port"):
        rec = run(package, frames[:n], metric[:n], K,
                  dict(cs.STREAM_CFG, voxel_size=0.01, max_depth=10.0,
                       loop_closure=False), metric=True)
        centres = [-R.T @ t for R, t in rec.poses]
        steps = [float(np.linalg.norm(b - a))
                 for a, b in zip(centres, centres[1:])]
        print(json.dumps({"package": package, "mode": "metric depth",
                          "frames": n, "chained_step_lengths": steps,
                          "true_step_m": cs.SFM_SCENE["baseline"]}),
              flush=True)


SECTIONS = {"closure": closure_runs, "icp": icp_runs,
            "sensitivity": loop_icp_sensitivity, "metric": metric_runs}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--div", type=int, default=4)
    ap.add_argument("--sections", default=",".join(SECTIONS),
                    help="comma-separated, of " + ", ".join(SECTIONS))
    args = ap.parse_args()
    torch.set_num_threads(os.cpu_count() or 1)
    h, w = cs.SFM_H // args.div, cs.SFM_W // args.div
    K = tuple(k / args.div for k in cs.SFM_K)
    scene = cs.two_plane_scene(h, w, K, len(cs.STREAM_CAMS), "cpu",
                               cams=cs.STREAM_CAMS)
    frames = list(scene["bgr"].numpy())
    tts.CAP = CAP
    for name in args.sections.split(","):
        SECTIONS[name](scene, frames, scene["depth"].numpy(), K)


if __name__ == "__main__":
    main()
