#!/usr/bin/env python3
"""Bring-up of the fused stream on one CUDA card.

    python3 tools/stream_fused_dev.py [--small-only | --probe]

Builds the kernels, then, small: the per-frame and batched fused steps of
``txr_torch/pipelines/stream_step.py`` on five 128 x 160 frames with a v2
vits model at input size 70 (seeded random weights, bf16): capture, the
fused route against the stepwise one on the same draws, a replay against
the eager step. Then, unless ``--small-only``, ``chip_smoke.py``'s
``stream_fused_path`` phase at full size (it runs its own stepwise
reference). ``--probe`` instead captures each stage of the per-frame step
at full size on its own and names the stages that break a capture. Every
line of standard output is one JSON object; a failing check raises.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import txr_torch._cuda as kernels  # noqa: E402
from txr_torch.core.config import StreamingConfig  # noqa: E402
from txr_torch.core.intrinsics import CameraIntrinsics  # noqa: E402
from txr_torch.models.depth_anything import DepthAnythingModel  # noqa: E402
from txr_torch.pipelines import streaming as st  # noqa: E402

H, W = 128, 160


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def frames(n: int = 5) -> list:
    """A patch of coloured blocks shifted 3 px a frame."""
    rng = np.random.default_rng(0)
    base = np.full((H, W, 3), 90, np.uint8)
    for _ in range(60):
        c = rng.integers(0, 255, 3)
        x, y = int(rng.integers(5, W - 12)), int(rng.integers(5, H - 12))
        base[y:y + 7, x:x + 8] = c
    out = []
    for k in range(n):
        f = np.full_like(base, 90)
        f[:, 3 * k:] = base[:, :W - 3 * k]
        out.append(f)
    return out


def run(model, seq, fused, batch=1, **cfg):
    rec = st.StreamingReconstructor(
        CameraIntrinsics(130.0, 130.0, W / 2, H / 2, W, H),
        depth_model=model, use_icp=True, metric_depth=True, verbose=False,
        fused=fused, feature_capacity=1024, icp_sample=512,
        config=StreamingConfig(**dict(dict(
            voxel_size=0.02, max_map_points=1 << 14, subsample_factor=2,
            max_depth=1e6, min_depth=1e-6, loop_closure=False,
            stream_batch=batch), **cfg)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec.run([(f, float(i), str(i)) for i, f in enumerate(seq)])
    torch.cuda.synchronize()
    return rec, time.perf_counter() - t0


def small() -> None:
    import chip_smoke

    model = DepthAnythingModel(version="v2", encoder="vits", input_size=70)
    seq = frames()
    st._FUSED_STEP_CACHE.clear()
    f, wall_f = run(model, seq, True)
    s, wall_s = run(model, seq, False)
    agree = chip_smoke.routes_agree("small", f, s)
    prog = next(p for p in chip_smoke.programs_of_cache()
                if p.name == "fused_stream_step")
    replay = chip_smoke.replay_against_eager(prog)
    b, wall_b = run(model, seq, True, batch=3)
    emit({"phase": "small", "agree": agree, "replay": replay,
          "wall_s": {"fused": wall_f, "stepwise": wall_s, "batched": wall_b},
          "batched_fused": b.frames_processed,
          "batched_t_diff": max(float(np.abs(x[1] - y[1]).max())
                                for x, y in zip(b.poses, f.poses)),
          "graphs": chip_smoke.graph_record(chip_smoke.programs_of_cache())})
    st._FUSED_STEP_CACHE.clear()


def probe() -> None:
    """Capture each stage of the per-frame step at full size on its own, on
    the second frame of chip_smoke.py's stream scene (a stage that breaks
    the capture is named by its own failure), and the whole step on the
    first and the second frame."""
    import chip_smoke as cs
    from txr_torch.core.types import PointSet
    from txr_torch.fusion.offset_map import OffsetVoxelMap, offset_map_insert
    from txr_torch.geometry.icp import icp_point_to_plane
    from txr_torch.ops.backproject import backproject_world
    from txr_torch.ops.matching import match_l2_ratio
    from txr_torch.pipelines import stream_step as ss

    dev = torch.device("cuda")
    scene = cs.two_plane_scene(cs.SFM_H, cs.SFM_W, cs.SFM_K, 2, dev)
    rel = scene["depth"] / cs.SFM_SCENE["depth_div"]
    model = cs.SceneDepthModel(rel, 1)
    fx, fy, cx, cy = cs.SFM_K
    rec = st.StreamingReconstructor(
        CameraIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=cs.SFM_W,
                         height=cs.SFM_H), depth_model=model,
        verbose=False, config=StreamingConfig(stream_batch=1,
                                              **cs.STREAM_CFG))
    step = rec._fused_step_for(cs.SFM_H, cs.SFM_W)
    ch = step.chain
    first = (*ss._flat_state(rec._fused_state_now()), scene["bgr"][0],
             rec._no_priorities())
    model.buf[0].copy_(rel[0])
    flat = step.program.eager(*first)[:ss.N_STATE]
    vm, carry = OffsetVoxelMap(*flat[:5]), ss._Carry(*flat[5:])
    bgr, prio = scene["bgr"][1], rec._pair_priorities()
    model.buf[0].copy_(rel[1])
    depth = ch.depth(bgr.flip(-1)[None])[0]
    feats = ch.features(bgr)
    tgt = ch.icp_target(vm)
    idx2, ok = match_l2_ratio(carry.prev_desc, feats[1], carry.prev_mask,
                              feats[2], 0.75)
    ps = backproject_world(depth, bgr.flip(-1), carry.R, carry.t, fx, fy,
                           cx, cy, 0.1, 60.0, 1.0, 2)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    stages = {
        "step_first": (step._fn, first),
        "step_second": (step._fn, (*flat, bgr, prio)),
        "depth": (lambda b: (ch.depth(b.flip(-1)[None])[0],), (bgr,)),
        "features": (lambda b: tuple(ch.features(b)), (bgr,)),
        "icp_target": (lambda *v: tuple(ch.icp_target(OffsetVoxelMap(*v))),
                       tuple(vm)),
        "match": (lambda a, b, c, d: match_l2_ratio(a, b, c, d, 0.75),
                  (carry.prev_desc, feats[1], carry.prev_mask, feats[2])),
        "pair_step": (lambda a, b, m, p: st.pair_step(
            a, b, m, ch.K, None, 2.0, 0.1, 600.0, priorities=(p[0], p[1])),
            (carry.prev_uv, feats[0][idx2], ok, prio)),
        "icp": (lambda s, sm, *t: icp_point_to_plane(
            s, sm, t[0], t[2], t[1], eye, zero, 10, 0.1, 1024,
            compact=False), (ps.xyz[::128], ps.mask[::128], *tgt[:3])),
        "chain": (lambda *a: tuple(ch.frame(
            ss._Carry(*a[:7]), a[7].flip(-1), a[8], a[9:12], a[12],
            a[13:17]).carry), (*carry, bgr, depth, *feats, prio, *tgt)),
        "insert": (lambda *a: tuple(offset_map_insert(
            OffsetVoxelMap(*a[:5]), PointSet(*a[5:8]))[:4]),
            (*vm, ps.xyz, ps.rgb, ps.mask)),
    }
    res = {}
    for name, (fn, args) in stages.items():
        try:
            ss.GraphedProgram(fn, name)(*args)
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:   # noqa: BLE001 - a probe reports each stage
            import traceback

            where = [f"{f.filename.split('/')[-1]}:{f.lineno} {f.line}"
                     for f in traceback.extract_tb(e.__traceback__)[-6:]]
            res[name] = {"error": f"{type(e).__name__}: {str(e)[:300]}",
                         "where": where}
    emit({"phase": "probe", "stages": res})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small-only", action="store_true")
    ap.add_argument("--probe", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("stream_fused_dev: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    kernels.build()
    kernels.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0})
    if args.probe:
        probe()
        return 0
    small()
    if not args.small_only:
        import chip_smoke

        chip_smoke.stream_fused_path()
    emit({"phase": "done", "wall_s": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    sys.exit(main())
