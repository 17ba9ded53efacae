#!/usr/bin/env python3
"""Depth Anything Processor with Point Cloud Generation and ROS2 Support,
on PyTorch and CUDA (the ``txr_torch`` port of depth_processor.py).

The same argparse surface as depth_processor.py (groups, flags, defaults,
choices): Depth Anything V1/V2/V3 inference over folder/camera/video
sources, raw .npy + colormapped + 16-bit mm PNG depth outputs, per-frame PLY
point clouds, and optional ROS2 publishing. The model runs as a PyTorch ViT +
DPT head with the port's hand-written attention and DPT-tail kernels on an
NVIDIA GPU; --device cpu runs the plain PyTorch versions on the CPU.

Examples:
    # Process image folder with V2 large model on the GPU
    python depth_processor_torch.py --source folder --input ./images --output ./out

    # Metric V3 on a video, keeping half the frames, depth + point clouds
    python depth_processor_torch.py --source video --video-path v.mp4 \
        --version v3 --encoder large --metric --dataset vkitti --max-depth 80 \
        --fps-mode custom --fps-percent 50 --mode both
"""

import argparse
import logging
import sys

logging.basicConfig(
    level=logging.INFO,
    format="%(asctime)s - %(name)s - %(levelname)s - %(message)s",
)
logger = logging.getLogger("depth_processor_torch")


def parse_args():
    parser = argparse.ArgumentParser(
        description='Depth Anything Processor with Point Cloud Generation and ROS2 Support',
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=__doc__,
    )

    model_group = parser.add_argument_group('Model Settings')
    model_group.add_argument('--version', type=str, default='v2', choices=['v1', 'v2', 'v3'],
                             help='Depth Anything version (default: v2)')
    model_group.add_argument('--encoder', type=str, default='vitl',
                             choices=['vits', 'vitb', 'vitl', 'vitg', 'large'],
                             help='Encoder size (default: vitl)')
    model_group.add_argument('--checkpoint', type=str, default=None,
                             help='Path to model checkpoint')
    model_group.add_argument('--metric', action='store_true',
                             help='Use metric depth model')
    model_group.add_argument('--max-depth', type=float, default=20.0,
                             help='Maximum depth for metric models (20 indoor, 80 outdoor)')
    model_group.add_argument('--dataset', type=str, default='hypersim',
                             choices=['hypersim', 'vkitti'],
                             help='Training dataset for metric models')
    model_group.add_argument('--input-size', type=int, default=518,
                             help='Input size for model inference')
    model_group.add_argument('--batch', type=int, default=0,
                             help='Frames per device batch (extension; '
                                  '0 = auto: 8 for folder/video sources, 1 '
                                  'for live camera; 1 reproduces the '
                                  'reference frame-sequential loop exactly)')
    model_group.add_argument('--int8', action='store_true',
                             help='Run encoder dense layers as W8A8 int8 '
                                  'matmuls (extension; the "int8" policy: '
                                  'torch._int_mm on the GPU)')
    model_group.add_argument('--device', type=str, default='auto',
                             choices=['auto', 'cuda', 'cpu', 'mps', 'tpu'],
                             help='Device for inference (auto and cuda: the '
                                  'GPU, which must be present; cpu: the CPU; '
                                  'mps and tpu are refused)')

    input_group = parser.add_argument_group('Input Settings')
    input_group.add_argument('--source', type=str, default='folder',
                             choices=['folder', 'camera', 'video'],
                             help='Input source type')
    input_group.add_argument('--input', type=str, default='./images',
                             help='Input folder path (for folder source)')
    input_group.add_argument('--video-path', type=str,
                             help='Video file path (for video source)')
    input_group.add_argument('--device-id', type=int, default=0,
                             help='Camera device ID (for camera source)')
    input_group.add_argument('--width', type=int, default=640,
                             help='Camera/video width')
    input_group.add_argument('--height', type=int, default=480,
                             help='Camera/video height')
    input_group.add_argument('--fps-mode', type=str, default='1fps',
                             choices=['1fps', 'all', 'custom'],
                             help='Frame capture mode')
    input_group.add_argument('--fps-percent', type=float, default=100.0,
                             help='FPS percentage for custom mode (1-100)')
    input_group.add_argument('--intrinsics', type=str,
                             help='Path to camera intrinsics JSON file')

    output_group = parser.add_argument_group('Output Settings')
    output_group.add_argument('--output', type=str, default='./output',
                              help='Output directory')
    output_group.add_argument('--mode', type=str, default='both',
                              choices=['images', 'pointcloud', 'both'],
                              help='Output mode')
    output_group.add_argument('--pointcloud-downsample', type=int, default=1,
                              help='Point cloud downsampling factor')
    output_group.add_argument('--min-depth', type=float, default=0.1,
                              help='Minimum valid depth (meters)')
    output_group.add_argument('--colormap', type=str, default='jet',
                              choices=['jet', 'magma', 'inferno', 'viridis', 'plasma', 'turbo'],
                              help='Depth visualization colormap')
    output_group.add_argument('--no-raw-depth', action='store_true',
                              help='Do not save raw depth numpy files')

    ros2_group = parser.add_argument_group('ROS2 Settings')
    ros2_group.add_argument('--ros2', action='store_true',
                            help='Enable ROS2 topic publishing')
    ros2_group.add_argument('--ros2-freq', type=float, default=10.0,
                            help='ROS2 publish frequency (Hz)')
    ros2_group.add_argument('--depth-topic', type=str, default='/depth_anything/depth_image',
                            help='ROS2 depth image topic')
    ros2_group.add_argument('--pc-topic', type=str, default='/depth_anything/points',
                            help='ROS2 point cloud topic')
    ros2_group.add_argument('--frame-id', type=str, default='camera_depth_optical_frame',
                            help='ROS2 frame ID')

    parser.add_argument('--preview', action='store_true',
                        help='Show preview window')
    parser.add_argument('--verbose', '-v', action='store_true',
                        help='Verbose logging')

    return parser.parse_args()


def main():
    args = parse_args()
    if args.verbose:
        logging.getLogger().setLevel(logging.DEBUG)

    from txr_torch.core.device import resolve_device
    from txr_torch.io.depth_io import get_colormap
    from txr_torch.io.sources import make_source
    from txr_torch.models.depth_anything import DepthAnythingModel
    from txr_torch.pipelines.depth_pipeline import DepthProcessor
    from txr_torch.ros2.publisher import ros2_available

    if args.device in ('mps', 'tpu'):
        logger.error("--device %s is not supported by txr_torch: it runs on "
                     "a CUDA GPU (--device auto or cuda) or, when asked, on "
                     "the CPU (--device cpu)", args.device)
        sys.exit(2)
    try:
        # auto never falls back to the CPU: without a GPU it stops here
        device = resolve_device('cpu' if args.device == 'cpu' else None)
    except RuntimeError as e:
        logger.error("%s", e)
        sys.exit(1)

    if args.ros2 and not ros2_available():
        logger.error("ROS2 is required for topic publishing but not available")
        sys.exit(1)

    logger.info("Loading Depth Anything %s with %s encoder on %s...",
                args.version.upper(), args.encoder, device)
    model = DepthAnythingModel(
        version=args.version,
        encoder=args.encoder,
        checkpoint_path=args.checkpoint,
        metric=args.metric,
        max_depth=args.max_depth,
        dataset=args.dataset,
        input_size=args.input_size,
        quant="int8" if args.int8 else "none",
        device=device,
    )

    try:
        source = make_source(
            args.source,
            input_path=args.input,
            video_path=args.video_path,
            device_id=args.device_id,
            width=args.width,
            height=args.height,
            fps_mode=args.fps_mode,
            fps_percent=args.fps_percent,
            intrinsics_path=args.intrinsics,
        )
    except (IOError, FileNotFoundError, ValueError) as e:
        logger.error("%s", e)
        sys.exit(1)

    processor = DepthProcessor(
        model=model,
        source=source,
        output_dir=args.output,
        mode=args.mode,
        enable_ros2=args.ros2,
        ros2_freq=args.ros2_freq,
        ros2_depth_topic=args.depth_topic,
        ros2_pc_topic=args.pc_topic,
        ros2_frame_id=args.frame_id,
        pointcloud_downsample=args.pointcloud_downsample,
        max_depth=args.max_depth,
        min_depth=args.min_depth,
        colormap=get_colormap(args.colormap),
        save_raw_depth=not args.no_raw_depth,
        batch_size=args.batch,
    )
    processor.process(show_preview=args.preview)


if __name__ == '__main__':
    main()
