#!/usr/bin/env python3
"""Depth to 3D Reconstruction — fuse RGB frames + precomputed depth maps into
a single PLY point cloud, anchored to metric scale by sparse SfM, on
PyTorch and CUDA (the ``txr_torch`` port of depth_to_reconstruction.py).

The same argparse surface as depth_to_reconstruction.py (flags, defaults,
help). Underneath: CLAHE + SIFT features, batched essential / homography
RANSAC, pose refinement and DLT triangulation, then the dense merge (voxel
averaging through the port's segmented-scan kernel, grid statistical
outlier removal), all on an NVIDIA GPU, which must be present.

Usage:
    python depth_to_reconstruction_torch.py --rgb-folder images/ \
        --depth-folder depth/ --output ./output/reconstruction.ply
"""

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Depth to 3D Reconstruction')
    parser.add_argument('--rgb-folder', type=str, required=True,
                        help='Folder with RGB images')
    parser.add_argument('--depth-folder', type=str, required=True,
                        help='Folder with depth images')
    parser.add_argument('--output', type=str, default='./output/reconstruction.ply',
                        help='Output PLY file path')
    parser.add_argument('--fx', type=float, default=1719.0)
    parser.add_argument('--fy', type=float, default=1719.0)
    parser.add_argument('--cx', type=float, default=540.0)
    parser.add_argument('--cy', type=float, default=960.0)
    parser.add_argument('--voxel-size', type=float, default=0.005)
    parser.add_argument('--subsample', type=int, default=2)
    parser.add_argument('--no-vis', action='store_true')
    parser.add_argument('--device-features', action='store_true',
                        help='Run SIFT detection as PyTorch ops on the GPU '
                             'instead of host OpenCV (extends the reference)')
    return parser


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (the process's arguments when None) on
    ``device`` (None: the CUDA device, which must be present)."""
    args = build_parser().parse_args(argv)

    from txr_torch.core.config import ReconstructionConfig
    from txr_torch.core.device import resolve_device
    from txr_torch.geometry.features import resolve_backend
    from txr_torch.pipelines.fusion_pipeline import \
        DepthToReconstructionPipeline
    from txr_torch.utils.visualize import visualize_reconstruction

    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        print(f"depth_to_reconstruction_torch: {e}", file=sys.stderr)
        return 1

    config = ReconstructionConfig(
        fx=args.fx, fy=args.fy,
        cx=args.cx, cy=args.cy,
        voxel_size=args.voxel_size,
        subsample_factor=args.subsample,
    )
    backend = resolve_backend(
        "device" if args.device_features else "auto", dev)
    pipeline = DepthToReconstructionPipeline(config, feature_backend=backend,
                                             device=dev)

    num_loaded = pipeline.load_data(args.rgb_folder, args.depth_folder)
    if num_loaded < 2:
        print("Failed to load sufficient data")
        return 0

    points, colors, poses = pipeline.reconstruct()

    if points is not None and len(points) > 0:
        pipeline.save_reconstruction(points, colors, args.output)
        if not args.no_vis:
            visualize_reconstruction(points, colors, poses,
                                     "Depth-Enhanced Reconstruction")
    else:
        print("Reconstruction failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
