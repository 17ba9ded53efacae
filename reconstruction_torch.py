#!/usr/bin/env python3
"""Streaming SLAM-like 3D reconstruction from a folder or live camera, on
PyTorch and CUDA (the ``txr_torch`` port of reconstruction.py).

The same argparse surface as reconstruction.py (every flag and default).
Underneath, per frame on an NVIDIA GPU, which must be present: Depth
Anything (the hand-written attention and DPT-tail kernels), SIFT,
essential / homography RANSAC against the previous frame with the
metric-scale EMA, point-to-plane ICP against the map, and an insert into
the packed voxel map (the fused-reduce scan kernel); keyframes with
appearance-gated loop closure and SE(3) pose-graph optimisation; at the
end a PLY and a 2D occupancy grid (PGM + YAML).

By default the whole chain of a frame is one step with no host read,
captured once as a CUDA graph and replayed: a folder runs 8 frames a step
(the batched fused step), a camera one frame a step. ``--no-fused`` runs
the stepwise loop, which reads its counts and poses back per frame.

Usage:
    python reconstruction_torch.py --mode folder --input ./my_images/ --output scene.ply
    python reconstruction_torch.py --mode camera --camera 0 --output scene.ply
"""

import argparse
import logging
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description='Streaming SLAM-like 3D reconstruction (folder or camera)')
    parser.add_argument('--mode', type=str, default='folder',
                        choices=['folder', 'camera'], help='Input mode')
    parser.add_argument('--input', type=str, default='./images',
                        help='Input folder (folder mode)')
    parser.add_argument('--camera', type=int, default=0,
                        help='Camera device ID (camera mode)')
    parser.add_argument('--output', type=str, default='scene.ply',
                        help='Output PLY file')
    # Model settings (same registry as depth_processor_torch.py)
    parser.add_argument('--version', type=str, default='v2',
                        choices=['v1', 'v2', 'v3'])
    parser.add_argument('--encoder', type=str, default='vits',
                        choices=['vits', 'vitb', 'vitl', 'vitg', 'large'])
    parser.add_argument('--checkpoint', type=str, default=None)
    parser.add_argument('--metric', action='store_true',
                        help='Model outputs metric depth (skip SfM scale anchoring)')
    parser.add_argument('--max-depth', type=float, default=10.0,
                        help='Maximum fused depth (meters)')
    parser.add_argument('--intrinsics', type=str, default=None,
                        help='Camera intrinsics JSON')
    parser.add_argument('--voxel-size', type=float, default=0.01)
    parser.add_argument('--subsample', type=int, default=2)
    parser.add_argument('--no-fused', action='store_true',
                        help='Per-op streaming loop instead of the fused '
                             'one-program-per-frame device step')
    parser.add_argument('--no-icp', action='store_true',
                        help='Disable ICP refinement (feature odometry only)')
    parser.add_argument('--max-frames', type=int, default=None)
    parser.add_argument('--no-grid', action='store_true',
                        help='Skip the 2D occupancy grid artifact '
                             '(<output>_grid.pgm/.yaml)')
    parser.add_argument('--grid-cell', type=float, default=0.05,
                        help='Occupancy grid cell size in meters')
    parser.add_argument('--grid-range', type=float, default=5.0,
                        help='Occupancy grid max range from trajectory '
                             '(rtabmap Grid/RangeMax)')
    return parser


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (the process's arguments when None) on
    ``device`` (None: the CUDA device, which must be present)."""
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")

    from txr_torch.core.config import StreamingConfig
    from txr_torch.core.device import resolve_device
    from txr_torch.io.sources import make_source
    from txr_torch.models.depth_anything import DepthAnythingModel
    from txr_torch.pipelines.streaming import StreamingReconstructor

    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        print(f"reconstruction_torch: {e}", file=sys.stderr)
        return 1

    model = DepthAnythingModel(
        version=args.version, encoder=args.encoder,
        checkpoint_path=args.checkpoint, metric=args.metric,
        max_depth=args.max_depth, device=dev,
    )

    source = make_source(
        'folder' if args.mode == 'folder' else 'camera',
        input_path=args.input, device_id=args.camera,
        fps_mode='all', intrinsics_path=args.intrinsics,
    )

    cfg = StreamingConfig(voxel_size=args.voxel_size,
                          subsample_factor=args.subsample,
                          max_depth=args.max_depth)
    rec = StreamingReconstructor(
        intrinsics=source.intrinsics, depth_model=model, config=cfg,
        use_icp=not args.no_icp, metric_depth=args.metric,
        fused=not args.no_fused, device=dev,
    )
    try:
        n = rec.run(source, max_frames=args.max_frames)
    finally:
        source.close()
    if n == 0:
        print("No frames fused")
        return 1
    rec.save(args.output)
    if not args.no_grid:
        stem = os.path.splitext(args.output)[0] + "_grid"
        rec.save_grid(stem, cell_size=args.grid_cell,
                      range_max=args.grid_range)
    return 0


if __name__ == "__main__":
    sys.exit(main())
