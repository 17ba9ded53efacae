#!/usr/bin/env python3
"""Depth-Enhanced 3D Reconstruction — end-to-end monocular reconstruction for
textureless surfaces: neural depth + hybrid features (SIFT/ORB/lines/edges) +
from-scratch SfM → fused PLY, on PyTorch and CUDA (the ``txr_torch`` port of
depth_enhanced_reconstruction.py).

The same argparse surface as depth_enhanced_reconstruction.py (flags,
defaults, groups). Underneath: Depth Anything V2 ViT-L in bf16 (the
hand-written attention and DPT-tail kernels), hybrid features, fundamental
and essential / homography RANSAC, DLT triangulation, optional bundle
adjustment, and a voxel merge whose segment sums are the segmented-scan
kernel, all on an NVIDIA GPU, which must be present.

Usage:
    python depth_enhanced_reconstruction_torch.py --input ./input_folder/buddha_images
"""

import argparse
import sys

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Depth-Enhanced 3D Reconstruction')
    parser.add_argument('--input', type=str, default='./input_folder/buddha_images',
                        help='Input folder with images')
    parser.add_argument('--output', type=str, default='./output',
                        help='Output directory')
    parser.add_argument('--fx', type=float, default=1719.0, help='Focal length X')
    parser.add_argument('--fy', type=float, default=1719.0, help='Focal length Y')
    parser.add_argument('--cx', type=float, default=540.0, help='Principal point X')
    parser.add_argument('--cy', type=float, default=960.0, help='Principal point Y')
    parser.add_argument('--no-depth', action='store_true', help='Disable depth estimation')
    parser.add_argument('--no-hybrid', action='store_true', help='Disable hybrid features')
    parser.add_argument('--ba', action='store_true',
                        help='Refine poses with bundle adjustment (extends the '
                             'reference, which declares BA but never runs it)')
    parser.add_argument('--int8', action='store_true',
                        help='Encoder linears as W8A8 int8 matmuls '
                             '(extends the reference)')
    parser.add_argument('--device-features', action='store_true',
                        help='Run SIFT/ORB/LSD/Canny as PyTorch ops on the '
                             'GPU instead of host OpenCV (extends the '
                             'reference; same detectors)')
    return parser


def main(argv=None, device=None) -> int:
    """Run the CLI on ``argv`` (the process's arguments when None) on
    ``device`` (None: the CUDA device, which must be present)."""
    args = build_parser().parse_args(argv)

    K = np.array([
        [args.fx, 0, args.cx],
        [0, args.fy, args.cy],
        [0, 0, 1]
    ], dtype=np.float64)

    from txr_torch.core.device import resolve_device
    from txr_torch.pipelines.enhanced_pipeline import \
        DepthEnhancedReconstruction
    from txr_torch.utils.visualize import visualize_reconstruction

    try:
        dev = resolve_device(device)
    except RuntimeError as e:
        print(f"depth_enhanced_reconstruction_torch: {e}", file=sys.stderr)
        return 1

    reconstructor = DepthEnhancedReconstruction(
        K=K,
        use_depth=not args.no_depth,
        quant="int8" if args.int8 else "none",
        use_hybrid_features=not args.no_hybrid,
        use_ba=args.ba,
        feature_backend="device" if args.device_features else "auto",
        device=dev,
    )

    num_images = reconstructor.load_images(args.input)
    if num_images < 2:
        print("Need at least 2 images for reconstruction")
        return 1

    result = reconstructor.reconstruct(output_dir=args.output)

    if result is not None:
        points, colors, poses = result
        visualize_reconstruction(points, colors, poses,
                                 title="Depth-Enhanced 3D Reconstruction")
    else:
        print("Reconstruction failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
