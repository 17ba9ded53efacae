#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

builds the hand-written kernels of ``txr_torch`` from ``txr_torch/csrc``,
holds each against its plain PyTorch version on the card at the shapes the
paths below give it, and then drives those paths at full width:

    uint8 1080p frames -> bicubic resize + ImageNet normalize
    -> Depth Anything V2 ViT-L (bf16, seeded random weights)
    -> back-projection on the 518x924 depth grid
    -> insert into the packed mean-offset voxel map (capacity 2^21, 1 cm)

Each kernel is held against its plain version at its path shapes and at
ragged ones (attention: S = 2432, 256 and 77, ``kv_len`` 1 / 64 / 1984 /
2000 with its masked keys bit for bit of no weight, a flat softmax beside
the peaked one, S = 25,024 and 39,088, score mode ``boundmax`` with its
key-norm pre-pass, three stride patterns of the (B, H, S, D) entry; conv: one whole tile, an image smaller
than a tile, F = 136; int8 linear: one whole tile, M = 1 and 129, K = 16 and
4096 + 16, N = 8, an all-zero row, values on rounding ties; tail: every head
width, every resize ratio, an image smaller than a tile; scan: the insert's
real segments, one segment over 146 tiles, N = 1 and one tile +- 1 row, 7
columns with random starts or none); the fused voxel-map reduce is held bit
for bit against the unfused route (``torch.sort``, the standalone scan
kernel, ``torch.nonzero`` compaction) on a full map, an overflowing one, an
all-invalid batch, a saturating voxel and ``offset_map_merge``, with
PyTorch's sync debug mode set to fail on any host sync inside an insert or a
merge; the insert's merge of its sorted batch into the map's key-ordered
rows (merge kernel) is held bit for bit, keys and permutation, against its
plain version and ``torch.sort`` of all rows, at 2^26 map rows with the
cells' 8- and 16-frame batches and on ties, empty rows, empty sides and
ragged lengths; the ViT block's residual kernel (x + branch * gamma, and
the LayerNorm after it) is held against its plain version, x' bit for bit
and h within one bf16 ulp of the LayerNorm's terms, at the cells' steps,
at widths 384 to 2048, on ragged row counts and in a float32 model's and
bf16 autocast's dtypes, with its autograd route's gradients bit-equal to
the plain composition's; the DPT head's upsample kernel is held against
``F.interpolate`` at every cell's fusion-block shapes and the unfused
tail's, both ``align_corners``, bf16, float32 and bf16 autocast, ragged
channels and grids and a misaligned input, within one ulp with the
bit-equal share, under autocast autograd and in a CUDA graph's replay.
Every kernel is run twice on one input and must repeat bit for bit,
is timed against its library call (where one exists) inside one interleaved
loop (min / median / max on the ``kernels`` line; the int8 linear's quantise
pass and product also apart), and the built library must report the tiling
the wrappers compute with.

``main_path`` runs it with the default configuration (attention, DPT tail
and fused-reduce kernels); ``quant_path`` with ``quant="int8p"`` and
``TXR_FUSED_CONVS=1`` (also the int8 linear and 3x3 conv kernels);
``boundmax_path`` with ``TXR_ATTN_SCORES=boundmax`` (the bound-shift
attention kernel and its key-norm pre-pass instead of the f32max kernel);
``odd_heads_path`` runs a two-block ViT encoder of 15 heads on the same
2443-token sequence (the (B, H, S, D) attention entry point);
``depth_cli_path`` runs the depth CLI's pipeline as
``depth_processor_torch.py`` builds it (Depth Anything V2 ViT-L, bf16,
``DepthProcessor`` in point-cloud mode at batch 8) over 12 seeded 1080p
frames, with the native host library built from ``txr_torch/_native``: a
PLY per frame at the source resolution, read back and held against the
back-projection of ``infer_batch``, the batch-1 loop against the batched
one, and the ``--int8`` policy over 8 frames. ``bf16_vs_f32`` holds the
default bf16 ViT-L's depth against f32 arithmetic on the same bf16-rounded
weights (``txr``'s arithmetic) on main_path's frames.

``batch_path`` drives main_path's and quant_path's configurations at
``bench.py``'s 16, 24 and 32 frames a step (same weights and frames):
launches, the map, the first 8 frames' depth against the 8-frame step's,
and the kernels' 32-bit counts beside their limits.
``v3_metric_cli_path`` runs the depth CLI as ``--version v3 --encoder
large --metric --dataset vkitti --max-depth 80`` with explicit intrinsics:
the depth within the focal-rescaled ceiling and equal to ``infer_batch``'s
host-side rescale, each PLY's points at the depth of their pixels.
``registry_path`` drives every distinct configuration of the registry at
full width (``REGISTRY``: ViT-B bf16 and int8p with the conv kernel,
ViT-G bf16, int8mix and int8p with the conv kernel, ViT-L int8mix; seeded
weights drawn on the card, the relative head centred by ``centre_head``):
its launches a step, the policy table layer by layer, every kernel held to
its plain version on the operands the model handed it in the staged step
(``Capture``: two blocks' qkv, the tail with its cached operands, two conv
sites, a block's four dense layers), and the depth against the same
weights on the plain route. ``compare`` reports each kernel check's signed
error and holds the attention and tail kernels to a bias bound (``BIAS``).
``da3_path`` drives Depth Anything 3 any-view (``v3`` / ``large-anyview``,
seeded weights drawn on the card) at 16 views of 1080p a step: 24
attention, 16 QK-norm / RoPE, 2 tail and 1 reduce launches a step, then
on the staged step's own activations the QK-norm / RoPE kernel's in-place
result at blocks 9 and 23 against its plain version on the block's own
pre-prep qkv (``compare_qk_prep``), the attention kernel at a cross-view
layer (one sequence of 39,088 tokens after QK-norm and RoPE) against a
float32 plain attention taken in blocks of query rows, and the tail
kernel of both branches (2 and 7 output channels) against its plain
version in float32, and no further from it than ``DPTHead``'s unfused
bf16 tail; every output (rays and confidences too) against the same
forward with the heads' resizes through ``F.interpolate``
(``upsample_route_change``, as in ``vggt_path`` and ``streamvggt_path``).
``check_qk_prep`` holds the QK-norm / RoPE kernel alone at
(16, 2443, 3072), an odd B x S and five heads, and times its launch, its
wrapper and the plain chain.

``vggt_path`` drives VGGT-1B (the benchmark's ``vggt-1b`` configuration and
seeded weights, built by ``port_bench/archs/vggt.py``) at 32 views of 1080p
a step at 294 x 518: 72 attention, 48 QK-norm / RoPE, 2 tail and 1 reduce
launches a step; on the staged step the QK-norm / RoPE and attention
kernels at the global blocks of pairs 11 and 23 (one sequence of 25,024
tokens) and both heads' tails with VGGT's position term, as ``da3_path``
does; then depth, points, both confidences and the pose encoding against
the float32 reference (``port_bench/reference/vggt.py``) on the same input,
each no further than twice the same reference at bfloat16 (rms).
``check_tail`` holds the tail's position term (``position_term``, on a
generator of its own) at VGGT's shape and at ragged ones, and times the
kernel with and without it.

``streamvggt_path`` drives StreamVGGT (the benchmark's ``streamvggt-1b``
configuration and seeded weights, built by ``port_bench/archs/
streamvggt.py``) at 128 keyframes of 1080p a step, one submap in 4 chunks
of 32 through its key / value cache: 192 attention, 96 cached attention,
192 QK-norm / RoPE, 8 tail and 1 reduce launches a step; on the staged step
the cached entry point at three global calls (chunk 0 and chunk 3, up to
100,096 keys) on their own operands against a float32 plain attention
taken frame by frame, then every output against the float32 frame-causal
reference (``port_bench/reference/streamvggt.py``), each no further than
twice the same reference at bfloat16 (rms). ``check_cached_attention``
holds the cached entry point alone at the cell's shapes, with an empty
cache and at odd frame sizes and key counts, and times it at the four
chunks of a submap.

``sfm_path`` runs the fusion CLI's sparse path, which holds no kernel of
the port (plain PyTorch on the card), at the CLI's operating point:

    8 uint8 BGR frames of 1080x1920 (portrait, fx = fy = 1719)
    -> grey -> CLAHE -> SIFT (capacity 8192, 8000 features)
    -> L2 ratio matching per consecutive pair (rows capped at 4096)
    -> essential + homography RANSAC (1024 hypotheses) with model selection
    -> cheirality pose -> Gauss-Newton refinement -> DLT triangulation
    -> host pose chain -> world transform -> per-view metric scale

over a seeded floor-and-wall scene rendered here with ``grid_sample``; it
holds poses, the chosen models and the scales against the scene's ground
truth, runs the pair and scale stages under PyTorch's sync debug mode,
repeats them under the process's other TF32 settings, and holds the card
against the port on the CPU on 2 smaller frames.

``fusion_cli_path`` runs ``depth_to_reconstruction_torch.py``'s pipeline
(``DepthToReconstructionPipeline`` at the CLI's defaults, the ``auto``
feature backend) end to end on 8 views of that scene, filled in as
``load_data`` would: features, pairs, host pose chain, scales, then the
dense merge of 9 x 518,400 rows (back-projection -> three-key sort ->
segmented-scan kernel -> voxel means -> ``auto_cell`` + grid kNN outlier
removal) and a PLY written and read back. Poses and scales are held to the
truth; the dense stage on the true poses and metric scale is held to the
two true planes (1e-4 m), to a float64 host reduce and to the chunked
route (2 views a chunk), and the scan kernel to its plain version on the
columns and starts ``reconstruct()`` handed it (and on the true poses').
Each stage is timed between CUDA events; launches and the card's busy
share come from one more ``reconstruct()`` under the profiler.

``enhanced_cli_path`` runs ``depth_enhanced_reconstruction_torch.py``'s
pipeline (``DepthEnhancedReconstruction``) on 8 views of the same scene put
straight into ``rec.images``. Run A is the CLI's default: ViT-L v2 bf16
with seeded weights (attention and tail kernels), the device's hybrid
features (SIFT, ORB, LSD with the scan kernel at 8 columns once a frame,
Canny), host matching, fundamental RANSAC + ``pair_step`` per pair, the
scales, and the voxel merge (the scan kernel once more) into a PLY that is
read back; it must launch attention >= 24, tail >= 1, segscan 9 times and
the residual kernel twice an attention launch, and prints its stages (events), each feature op on one frame, its peak
memory and one profiled ``reconstruct()``. Run B takes the scene's depth
as the model and bundle adjustment on: poses and scales are held to the
truth (``SFM_TOL``) and the RMS history may not rise. Then the scan kernel
at 8 columns is held to its plain version on the columns and starts LSD
handed it for one frame and timed beside its bound, and that frame's LSD,
Canny, ORB and SIFT on the card are held against the CPU.

``stream_path`` runs ``reconstruction_torch.py``'s stepwise stream. Run
A: ``StreamingReconstructor`` on a ping-pong trajectory over the same scene
(cameras 0 ... 8 ... 0, 17 frames of 1080 x 1920; the scene's relative
depth as the depth model, so the scale anchor runs; ICP on; keyframes
every 2, 1 cm voxels in the stream's unit of one baseline) over its first
6 frames under the profiler, then with loop closure off and on: each pair of both runs
against the truth (``SFM_TOL``), the loops closed and each loop edge
against the truth, the end camera's drift with and without closure (with
closure at most the worst loop edge's error above it), one frame's ICP
(normals, and the registration at the stream's radius and at 0.1 m) on
the card against the CPU, stages between CUDA events, peak memory, and the
map the fused-reduce kernel built replayed through the unfused route, bit
for bit. Run B:
``reconstruction_torch.main --no-fused`` (v2 vits, seeded weights) over 10
of the scene's frames handed in through ``make_source``: the PLY against
the map, the grid's PGM / YAML read back, frames per second, and
attention, tail and fused-reduce launches.

``stream_fused_path`` runs the streaming CLI's default, the fused step
(``txr_torch/pipelines/stream_step.py``: each step a CUDA graph, captured
once and replayed). Run A': run A's scene with the depth through a stand-in
for the port's model whose device forward reads a buffer filled per frame,
per frame against ``stream_path``'s stepwise runs on the same draws
(closure off and on: the same counts, loops and ICP decisions, poses within
1e-4, pairs against the truth), both routes at 0.1 m of ICP radius (ICP
kept on at least one frame, the same decisions), a replay against the
eager step bit for bit, the steady state under PyTorch's sync debug mode
"error" between host reads, frames per second of the three routes (8
frames a step batched), capture time and pool of each graph, 6 profiled
frames, and ``pair_step`` eager against its own graph. Run B: the CLI at
its defaults (the batched fused route) over the same 10 frames, cold and
then warm; its depth graph (attention and tail kernels inside) against
its eager call. A graph's kernel launches are its launches per replay
times its replays, plus its warm-up calls'.

``train_path`` fine-tunes v2 / ViT-L (metric head) at full width through
``txr_torch.train``: 4 frames of main_path's preprocess (518 x 924, 2443
tokens) against a seeded smooth metric target, f32 master weights under
bf16 autocast, ``make_optimizer()`` at its defaults. One step of the kernel
route (attention and tail kernels forward, their plain versions
differentiated backward) is held against the plain route
(``TXR_FUSED_HEAD=0``, the plain attention) at one frame (the plain
attention's saved scores take 18 GB a frame), and one with
``TXR_FUSED_CONVS=1`` (9 conv launches) against cuDNN's at four: the loss,
the global gradient norm and each parameter's gradient. After optimizer
steps the tail's and the conv's operands derived from the weights are held
against the plain versions at the new weights. Then 2 warm-up and 8 timed
steps, split into forward, backward and clip + optimizer between CUDA
events, with 24 attention and 1 tail launch a step and losses whose
minimum falls below the first; one profiled step (the device time under
the plain attention backward); one layer's plain attention backward
alone; and, over a one-rank NCCL group at mesh (1, 1) on v2 / ViT-S, the
sharded fusion step (one fused-reduce launch an insert) and the sharded
train step against their unsharded counterparts. Its ``train_shift`` line
(``shift_by_layer``) follows the two routes' forward layer by layer: the
signed difference at each block, head stage and the log depth, each
kernel's own signed error there, and the log-depth shift that conv3's
weight and the biases make when the tail reads them in f32 rather than as
autocast's bf16.

Every line of standard output is one JSON object. The phases are ``device``,
``build``, ``kernel_check`` (one line per comparison), ``reference``,
``main_path``, ``quant_path``, ``boundmax_path``, ``odd_heads_path``,
``batch_path`` (a line a run, then its ``phase_s``), ``depth_cli_path``,
``v3_metric_cli_path``, ``registry_path`` (a line a configuration, then
its ``phase_s``), ``da3_path``, ``vggt_path``, ``streamvggt_path``,
``bf16_vs_f32``, ``sfm_path``, ``fusion_cli_path``,
``enhanced_cli_path``, ``stream_path``, ``stream_fused_path``,
``train_shift``, ``train_path``, ``script``
(the whole run's wall),
then the ``kernels`` summary and, last, the verdict
``{"ok": true, "device": {...}}``. Any failing phase raises and the exit
code is non-zero; nothing runs on the CPU and no kernel is swapped for its
plain version. Without a CUDA device the script exits with code 2 and
prints no result.

Options (none is needed): ``--frames N`` frames per step (default 8);
``--profile`` builds with ``-Xptxas -v`` and adds a ``ptxas`` line (each
kernel's registers and spills; a spill or a "wgmma serialized" warning
fails the run).

``KERNEL_CHECKS`` names each kernel's on-card checks; ``tools/kernel_dev.py
<mode>`` runs one entry of it alone.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch
import torch.distributed
import torch.nn.functional as F

import txr_torch._cuda as kernels
import txr_torch._native as native
import txr_torch.train as train
from txr_torch.core.precision import kernel_autocast
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (NCOLS, _insert_cols, _point_cols,
                                         _reduce_unfused, _sort_keys,
                                         create_offset_map, offset_map_insert,
                                         offset_map_merge, offset_map_points,
                                         offset_map_scan_inputs,
                                         offset_map_size)
from txr_torch.io.ply import read_ply
from txr_torch.io.sources import ImageSource
from txr_torch.models.depth_anything import (MODEL_CONFIGS, DepthAnything,
                                             DepthAnythingModel, build_model)
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import VIT_PRESETS, ViTConfig
from txr_torch.models.vit import _dense as vit_dense
from txr_torch.ops.attention import BLOCK_K as ATTN_BLOCK_K
from txr_torch.ops.attention import BLOCK_Q as ATTN_BLOCK_Q
from txr_torch.ops.attention import (attention_flash, attention_key_norm,
                                     attention_plain, attention_reference,
                                     cached_attention, cached_kernel_plan,
                                     fused_attention, key_norm_plain,
                                     split_heads)
from txr_torch.ops.attention import kernel_geometry as attention_geometry
from txr_torch.ops.backproject import backproject, backproject_world
from txr_torch.ops.conv_stripe import (BLOCK_F, TILE_H, TILE_W,
                                       conv3x3_reference, conv3x3_stripe,
                                       pack_weight)
from txr_torch.ops.conv_stripe import kernel_geometry as conv_geometry
from txr_torch.ops.dpt_tail import (fused_head_tail, head_tail_reference,
                                    pack_params, position_term)
from txr_torch.ops.dpt_tail import kernel_geometry as tail_geometry
from txr_torch.ops.quant import Int8Linear
from txr_torch.ops.quant_fused import (STAGES, TILE_M, TILE_N,
                                       Int8LinearFused, int8_linear,
                                       int8_linear_reference)
from txr_torch.ops.quant_fused import kernel_geometry as int8_geometry
from txr_torch.ops.merge import ITEMS as MERGE_ITEMS
from txr_torch.ops.merge import PART_THREADS as MERGE_PART_THREADS
from txr_torch.ops.merge import THREADS as MERGE_THREADS
from txr_torch.ops.merge import TILE as MERGE_TILE
from txr_torch.ops.merge import (merge_geometry, merge_sorted,
                                 merge_sorted_plain, row_keys)
from txr_torch.ops.resize import (IMAGENET_MEAN, IMAGENET_STD,
                                  compute_da_resize, resize_bicubic,
                                  resize_bilinear)
from txr_torch.ops.qk_prep import HEAD_DIM as QK_HEAD_DIM
from txr_torch.ops.qk_prep import ROWS_PER_BLOCK as QK_ROWS_PER_BLOCK
from txr_torch.ops.qk_prep import THREADS as QK_THREADS
from txr_torch.ops.qk_prep import _launch as qk_prep_launch
from txr_torch.ops.qk_prep import (qk_prep, qk_prep_plain,
                                   require_qk_prep_operands, rope_tables)
from txr_torch.ops.residual_norm import MAX_WIDTH as RN_MAX_WIDTH
from txr_torch.ops.residual_norm import ROWS_PER_BLOCK as RN_ROWS_PER_BLOCK
from txr_torch.ops.residual_norm import THREADS as RN_THREADS
from txr_torch.ops.residual_norm import VEC as RN_VEC
from txr_torch.ops.residual_norm import _launch as residual_norm_launch
from txr_torch.ops.residual_norm import (require_residual_norm_operands,
                                         residual_norm, residual_norm_plain)
from txr_torch.ops.upsample import MAX_CHUNK_BYTES as UP_MAX_CHUNK_BYTES
from txr_torch.ops.upsample import SEGMENT_CHUNKS as UP_SEGMENT_CHUNKS
from txr_torch.ops.upsample import THREADS as UP_THREADS
from txr_torch.ops.upsample import _launch as upsample_launch
from txr_torch.ops.upsample import (require_upsample_operands,
                                    upsample_bilinear,
                                    upsample_bilinear_plain)
from txr_torch.ops.scan import ITEMS as SCAN_ITEMS
from txr_torch.ops.scan import MAX_COLS as SCAN_MAX_COLS
from txr_torch.ops.scan import THREADS as SCAN_THREADS
from txr_torch.ops.scan import TILE as SCAN_TILE
from txr_torch.ops.scan import (offset_reduce, scan_geometry,
                                segmented_cumsum_cols)
from txr_torch.ops.segment import INT_MAX, segmented_cumsum
from txr_torch.geometry.epipolar import essential_ransac
from txr_torch.geometry.features import SIFTDetector, bgr_to_gray
from txr_torch.ops.canny import canny
from txr_torch.ops.lsd import lsd_lines
from txr_torch.ops.orb import orb_features
from txr_torch.ops.sift import sift_features
from txr_torch.geometry.homography import homography_ransac, transfer_error
from txr_torch.geometry.scale import clamp_scale
from txr_torch.ops.matching import match_l2_ratio
from txr_torch.pipelines.depth_pipeline import DepthProcessor
from txr_torch.pipelines.fusion_pipeline import (
    DepthToReconstructionPipeline, _dense_merge_batch, _pairs_batch,
    _scales_batch, dense_chunk_views, pair_step)
from txr_torch.core.config import ReconstructionConfig
from txr_torch.fusion.chunked_merge import chunked_dense_voxel_merge
from txr_torch.fusion.pointcloud import backproject_views
from txr_torch.ops.outlier import remove_statistical_outliers_grid
from txr_torch.ops.segment import lexsort3
from txr_torch.ops.voxel import _voxel_keys, _weighted_cols, voxel_downsample
from txr_torch.parallel.mesh import (COLUMN_PARALLEL, ROW_PARALLEL,
                                     make_mesh, shard_batch, shard_params,
                                     unshard_grads, unshard_state_dict)
from txr_torch.parallel.pipeline import (create_sharded_maps,
                                         make_sharded_fusion_step,
                                         merge_sharded_maps,
                                         stack_sharded_maps)

# Published dense peaks of one H100 SXM, used for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_BYTES = 3.35e12

H, W = 1080, 1920
HEADS, HEAD_DIM = 16, 64
ODD_HEADS = 15                  # head count of the odd-heads path
STEPS = 2                       # timed steps of a path
CLI_FRAMES = 12                 # depth_cli_path: a batch of 8, then of 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, runs: int = 5, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def time_spread(fns: dict, runs: int = 20, warmup: int = 3,
                inner: int = 5) -> dict:
    """Times several functions against each other inside one loop: after
    ``warmup`` calls of each, ``runs`` rounds in which every function is
    timed in turn, so that clock and temperature drift hits all alike. One
    sample is ``inner`` launches enqueued back to back between two CUDA
    events, divided by ``inner``: the host's work to enqueue the first
    launch (tens of microseconds of wrapper code on an idle card) is then
    spread over the sample and is not billed to the kernel. Returns
    ``{name: {"min": ms, "median": ms, "max": ms}}``."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / inner)
    return {name: {"min": min(ts), "median": statistics.median(ts),
                   "max": max(ts), "runs": runs, "launches_per_run": inner}
            for name, ts in times.items()}


def time_queued(fns: dict, runs: int = 10, inner: int = 10) -> dict:
    """Device time of several functions in turn, as ``time_spread``, but
    each sample enqueued behind a bf16 product of 8192 x 8192 matrices
    (over a millisecond of device work) that starts before the first event:
    the host enqueues the sample's ``inner`` launches while the card is
    busy, so a function whose host work is longer than its device time is
    not paced by the host. Returns ``{name: {"min", "median", "max"}}``."""
    gate = torch.ones((8192, 8192), dtype=torch.bfloat16, device="cuda")
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {name: [] for name in fns}
    for _ in range(runs):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            gate @ gate
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[name].append(start.elapsed_time(end) / inner)
    return {name: {"min": min(ts), "median": statistics.median(ts),
                   "max": max(ts), "runs": runs, "launches_per_run": inner}
            for name, ts in times.items()}


def require_repeatable(name: str, fn) -> None:
    """Two runs on one input must agree bit for bit (no float atomics)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"{name}: two runs on one input differ")
    emit({"phase": "kernel_check", "kernel": name,
          "case": "two runs on one input are bit-equal", "ok": True})


def require_geometry(name: str, entry, expected: tuple) -> None:
    """The built library must report the tiling the Python side computes
    grids and shared-memory sizes from."""
    buf = (ctypes.c_int * 4)()
    entry(buf)
    if tuple(buf) != tuple(expected):
        raise AssertionError(f"{name}: the library reports geometry "
                             f"{tuple(buf)}, the wrapper assumes {expected}")


BIAS_GROUPS = 256      # batch means of the signed error's standard error


def signed_error(diff: torch.Tensor, scale: float,
                 rows: torch.Tensor = None) -> dict:
    """The mean of ``diff`` over ``scale`` and its standard error by batch
    means: the flat difference cut into BIAS_GROUPS contiguous groups, the
    error the spread of the group means over sqrt(groups), so that errors
    correlated inside a neighbourhood (a pixel's channels, a row's tokens)
    do not shrink it. ``rows``, a 2-D view of ``diff``, gives the groups
    instead where the errors are correlated along another axis. ``z`` is
    the mean in standard errors: of the order of 1 for rounding noise,
    large for a bias."""
    d = diff.reshape(-1).double()
    if rows is None:
        groups = min(BIAS_GROUPS, d.numel())
        rows = d[:groups * (d.numel() // groups)].reshape(groups, -1)
    groups = rows.shape[0]
    mean = d.mean().item()
    se = (rows.double().mean(1).std().item() / groups ** 0.5
          if groups > 1 else float("inf"))
    scale = scale or 1.0
    return {"mean_signed_rel": mean / scale,
            "mean_signed_se_rel": se / scale,
            "mean_signed_z": mean / se if se > 0 else (
                0.0 if mean == 0 else float("inf"))}


def compare(name: str, case: str, got: torch.Tensor, want: torch.Tensor,
            atol: float, rtol: float, why: str,
            rms_rtol: float = None, bias_z: float = None,
            bias_rel: float = 0.0, bias_why: str = None) -> dict:
    """Emit one kernel_check line and return it; raise if a tolerance is
    exceeded.

    Every element must lie within ``atol + rtol * |want|``. ``rms_rtol``
    also bounds the rms of the error by that share of the rms of ``want``:
    an error of a few percent that is spread over all elements fails it
    even where each element stays inside its own tolerance. The line also
    carries the signed error (``signed_error``, relative to the rms of
    ``want``): it fails as biased where its mean lies more than ``bias_z``
    standard errors from 0 and above ``bias_rel`` of the values' rms."""
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        raise AssertionError(f"{name}/{case}: shape {tuple(g.shape)} vs "
                             f"{tuple(w.shape)}")
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}/{case}: kernel output is not finite")
    err = (g - w).abs()
    max_abs = err.max().item()
    max_rel = (err / w.abs().clamp(min=1e-6)).max().item()
    worst = (err - (atol + rtol * w.abs())).max().item()
    err_rms = err.pow(2).mean().sqrt().item()
    value_rms = w.pow(2).mean().sqrt().item()
    del err
    signed = signed_error(g - w, value_rms)
    unbiased = (bias_z is None or abs(signed["mean_signed_z"]) <= bias_z
                or abs(signed["mean_signed_rel"]) <= bias_rel)
    ok = (worst <= 0 and unbiased
          and (rms_rtol is None or err_rms <= rms_rtol * value_rms))
    line = {"phase": "kernel_check", "kernel": name, "case": case,
            "shape": list(g.shape), "max_abs_err": max_abs,
            "max_rel_err": max_rel, "err_rms": err_rms,
            "value_rms": value_rms, "value_max": w.abs().max().item(),
            "atol": atol, "rtol": rtol, "rms_rtol": rms_rtol,
            "least_margin": -worst, **signed, "bias_z": bias_z,
            "bias_rel": bias_rel, "tolerance_reason": why,
            "bias_reason": bias_why, "ok": ok}
    emit(line)
    if not ok:
        raise AssertionError(
            f"{name}/{case}: max abs err {max_abs} (rms {err_rms} on values "
            f"of rms {value_rms}) exceeds atol {atol} + rtol {rtol}, or "
            f"rms_rtol {rms_rtol}, or the mean signed error is "
            f"{signed['mean_signed_rel']} of the values' rms, "
            f"{signed['mean_signed_z']} standard errors from 0 (bias_z "
            f"{bias_z}, bias_rel {bias_rel})")
    return line


# ---------------------------------------------------------------- kernels

# The signed error of the attention and tail kernels (compare's bias
# bound): a kernel is biased where its mean error lies more than 8 standard
# errors from 0 and above 2^-13 of the values' rms. Readings on an H100
# (attention at every path shape and on the activations of the registry
# models and of 16 to 32 frames: |z| <= 2.3, |mean| <= 3e-6 of the rms; the
# tail: -3.7 to 1.8 on random operands, -10.4 to 3.6 on the models' own
# activations, |mean| <= 6.5e-6 of the rms, |z| growing with the frames:
# two small shifts of the mean that check_activations reports apart, the
# bf16 rounding of the upsampled image through conv2's ReLU and sums on
# the tensor cores that keep about 4e-6 less of conv2's sums than f32
# arithmetic does; Depth Anything 3's 16 views, da3_path: the attention
# kernel over 39,088 keys z 43 and -37 at |mean| <= 6.7e-6 of the rms, its
# 40 M outputs resolving a shift that small, the tails 17 and 8 at <= 7.9e-6).
# A result rounded toward zero instead of to nearest would sit near 2^-9 of
# the value, hundreds of standard errors out
BIAS = dict(bias_z=8.0, bias_rel=2.0 ** -13,
            bias_why="more than 8 standard errors from 0 and above 2^-13 of "
                     "the values' rms: readings |z| up to 43 with |mean| <= "
                     "7.9e-6 of the rms (the tail at 32 frames: bf16 "
                     "rounding through a ReLU, tensor-core sums; attention "
                     "over 39,088 keys); a result rounded toward zero would "
                     "read about 2^-9")
ATTN_TOL = dict(atol=8e-3, rtol=1.6e-2, rms_rtol=2.0 ** -7, **BIAS,
                why="4 bf16 ulps (2^-8 each) of the value: the kernel rounds "
                    "the probabilities to bf16 before it normalises, the "
                    "plain version after, and both round the result. Terms "
                    "of opposite sign cancel in the value, not in the error, "
                    "so 8e-3 absolute, 2.5 % of the values' rms of 0.3 "
                    "(scaled logits of std 3, |v| up to 5)")
TAIL_TOL = dict(atol=6e-2, rtol=1e-2, rms_rtol=2.0 ** -7, **BIAS,
                why="against the plain version in f32 arithmetic on the same "
                    "bf16 inputs. The kernel rounds the upsampled image to "
                    "bf16 (2^-9 relative on each of 9*128 products per "
                    "feature, 32 features: a noise of rms 0.01, up to 0.06 "
                    "over 3.8 M outputs) and the result (2.5 ulps); values "
                    "have rms 4 and reach 30")
SCAN_TOL = dict(atol=1e-3, rtol=1e-5,
                why="f32 sums of up to a few thousand taken in another "
                    "order (sequential runs joined by a tree against the "
                    "plain version's log-step tree)")


# The long sequences of the multi-view cells: VGGT's global calls (32 views
# of 782 tokens) and Depth Anything 3's cross-view calls (16 views of 2443)
ATTN_LONG_S = (25024, 39088)


def attention_qkv(gen: torch.Generator, batch: int, s: int, heads: int,
                  q_std: float = 3.0) -> torch.Tensor:
    """Random bf16 qkv of (batch, s, 3 * heads * 64) from ``gen``. q of
    std 3, k of std 1: q.k has std 24 over D=64, the scaled logits std 3.
    The softmax is peaked (a handful of the 2443 keys carry a row), so the
    result depends on q and k and is of the order of v. q of std 0.1 makes
    it flat: every key carries about as much as any other. The checks draw
    their flat and long cases from a generator of their own, so that no
    later check's draws depend on them."""
    qkv = torch.randn((batch, s, 3 * heads * HEAD_DIM), generator=gen,
                      device="cuda", dtype=torch.float32)
    qkv[..., :heads * HEAD_DIM] *= q_std
    return qkv.to(torch.bfloat16)


def require_masked_keys_weigh_nothing(name: str, fn, qkv: torch.Tensor,
                                      heads: int, kv: int) -> None:
    """``fn(qkv)``, a launch with ``kv`` keys of the fused projection
    ``qkv``, must not change by a bit when k and v of every key at or past
    ``kv`` are replaced by 64 and 2^120: a masked key with any weight left
    would move its rows by 2^120 times that weight."""
    junk = qkv.clone()
    hd = heads * HEAD_DIM
    junk[:, kv:, hd:2 * hd] = 64.0
    junk[:, kv:, 2 * hd:] = 2.0 ** 120
    if not torch.equal(fn(junk), fn(qkv)):
        raise AssertionError(f"{name}: kv_len={kv}: the masked keys moved "
                             f"the result")
    emit({"phase": "kernel_check", "kernel": name,
          "case": f"kv_len={kv}: masked keys of k 64 and v 2^120 leave the "
                  f"result bit-equal", "ok": True})


def check_attention(batch: int, gen: torch.Generator) -> dict:
    in_h, in_w = compute_da_resize(H, W, 518)
    s = (in_h // 14) * (in_w // 14) + 1
    c = 3 * HEADS * HEAD_DIM
    qkv = attention_qkv(gen, batch, s, HEADS)

    geo = attention_geometry(batch, HEADS, s, s)
    require_geometry("attention", kernels.lib().txr_attention_geometry,
                     (ATTN_BLOCK_Q, ATTN_BLOCK_K, geo["smem_bytes"],
                      geo["threads"]))
    got = fused_attention(qkv, HEADS, HEAD_DIM)
    want = attention_reference(qkv, HEADS, HEAD_DIM)
    err = compare("attention", f"main B={batch} S={s}", got, want,
                  **ATTN_TOL)["max_abs_err"]
    del want
    require_repeatable("attention",
                       lambda: fused_attention(qkv, HEADS, HEAD_DIM))
    own = torch.Generator(device="cuda").manual_seed(25)
    flat = attention_qkv(own, batch, s, HEADS, q_std=0.1)
    compare("attention", f"flat softmax (q std 0.1) B={batch} S={s}",
            fused_attention(flat, HEADS, HEAD_DIM),
            attention_reference(flat, HEADS, HEAD_DIM), **ATTN_TOL)
    del flat
    # ragged keys, which txr serves with its streaming kernel: one key, one
    # 64-row box, a whole number of key tiles less than S, and a ragged tile
    sub = qkv[:2].contiguous()
    for kv in (1, 64, 1984, 2000):
        compare("attention", f"kv_len={kv} B=2 S={s}",
                fused_attention(sub, HEADS, HEAD_DIM, kv),
                attention_reference(sub, HEADS, HEAD_DIM, kv), **ATTN_TOL)
        require_masked_keys_weigh_nothing(
            "attention", lambda x: fused_attention(x, HEADS, HEAD_DIM, kv),
            sub, HEADS, kv)
    # the multi-view cells' long sequences, flat and peaked (kept to time)
    long_qkv = {}
    for sl in ATTN_LONG_S:
        for label, q_std in (("flat", 0.1), ("peaked", 3.0)):
            x = attention_qkv(own, 1, sl, HEADS, q_std)
            compare("attention", f"{label} B=1 S={sl}",
                    fused_attention(x, HEADS, HEAD_DIM),
                    attention_reference_blocked(x, HEADS, HEAD_DIM),
                    **ATTN_TOL)
            torch.cuda.empty_cache()
        long_qkv[sl] = x
    # a sequence that is a multiple of both tiles; two whole key tiles and
    # a ragged query block; a short sequence: one ragged tile, fewer query
    # rows than a block
    for label, x in (("S=2432 B=2", qkv[:2, :2432].contiguous()),
                     ("S=256 B=1", qkv[:1, :256].contiguous()),
                     ("S=77 B=1", qkv[:1, :77].contiguous())):
        compare("attention", label, fused_attention(x, HEADS, HEAD_DIM),
                attention_reference(x, HEADS, HEAD_DIM), **ATTN_TOL)

    plain_ms = time_ms(lambda: attention_reference(qkv, HEADS, HEAD_DIM),
                       runs=3)
    q, k, v = split_heads(qkv, HEADS, HEAD_DIM)
    kv = 2000
    spread = time_spread({
        "kernel": lambda: fused_attention(qkv, HEADS, HEAD_DIM),
        "library": lambda: F.scaled_dot_product_attention(q, k, v),
        "kernel_kv": lambda: fused_attention(qkv, HEADS, HEAD_DIM, kv),
        "library_kv": lambda: F.scaled_dot_product_attention(
            q, k[:, :, :kv], v[:, :, :kv])})
    ms = spread["kernel"]["median"]
    flops = 4.0 * batch * HEADS * s * s * HEAD_DIM
    nbytes = 2.0 * batch * s * (c + HEADS * HEAD_DIM)
    full = bound(flops, PEAK_BF16_FLOPS, nbytes)
    kv_ms = spread["kernel_kv"]["median"]
    long_spread = time_spread(
        {sl: (lambda x=x: fused_attention(x, HEADS, HEAD_DIM))
         for sl, x in long_qkv.items()}, runs=6, warmup=1, inner=3)
    long_rows = {}
    for sl, t in long_spread.items():
        long_flops = 4.0 * HEADS * sl * sl * HEAD_DIM
        long_rows[f"(1, {sl}, {c})"] = {
            "ms": t["median"], "ms_spread": t,
            **bound(long_flops, PEAK_BF16_FLOPS, 2.0 * sl * (c + HEADS *
                                                             HEAD_DIM)),
            "tflops": long_flops / t["median"] / 1e9}
    del long_qkv
    return {"name": "attention", "route": "cuda",
            "source": "txr_torch/csrc/attention.cu",
            "replaces": "txr/ops/attention.py:170",
            "also_replaces": "txr/ops/attention.py:135 (kv_len < S)",
            "shape": [batch, s, c], "max_abs_err": err, "ms": ms,
            "ms_spread": spread["kernel"],
            "plain_ms": plain_ms, **full,
            "library_ms": spread["library"]["median"],
            "library_ms_spread": spread["library"],
            "library_call": "F.scaled_dot_product_attention",
            "tflops": flops / ms / 1e9,
            "no_slower_than_library": ms <= spread["library"]["median"],
            "within_twice_its_bound": ms <= 2 * full["bound_ms"],
            "kv_len_mode": {
                "replaces": "txr/ops/attention.py:135", "kv_len": kv,
                "shape": [batch, s, c], "ms": kv_ms,
                "ms_spread": spread["kernel_kv"],
                # row 1's work with kv_len of the S keys
                **bound(flops * kv / s, PEAK_BF16_FLOPS, nbytes),
                "library_ms": spread["library_kv"]["median"],
                "library_ms_spread": spread["library_kv"],
                "library_call": "F.scaled_dot_product_attention on the keys "
                                "and values sliced to kv_len",
                "tflops": flops * kv / s / kv_ms / 1e9},
            "long_sequences": long_rows,
            "geometry": {**geo, "grid": list(geo["grid"])}}


def check_attention_boundmax(batch: int, gen: torch.Generator) -> list:
    """Score mode ``"boundmax"`` of the attention kernel and its key-norm
    pre-pass, on the operands of ``check_attention``."""
    in_h, in_w = compute_da_resize(H, W, 518)
    s = (in_h // 14) * (in_w // 14) + 1
    c = 3 * HEADS * HEAD_DIM
    qkv = attention_qkv(gen, batch, s, HEADS)
    q, k, v = split_heads(qkv, HEADS, HEAD_DIM)

    kn_err = compare("attention_key_norm", f"B={batch} H={HEADS} S={s}",
                     attention_key_norm(qkv, HEADS, HEAD_DIM),
                     key_norm_plain(k), atol=0.0, rtol=1e-6,
                     why="sums of 64 f32 squares taken in another order "
                         "(a few ulps of a norm near 11); the max is "
                         "exact")["max_abs_err"]
    require_repeatable("attention_key_norm",
                       lambda: attention_key_norm(qkv, HEADS, HEAD_DIM))

    def bound_mode(x):
        return fused_attention(x, HEADS, HEAD_DIM, score_mode="boundmax")

    err = compare("attention_boundmax", f"main B={batch} S={s}",
                  bound_mode(qkv), attention_reference(
                      qkv, HEADS, HEAD_DIM, score_mode="boundmax"),
                  **ATTN_TOL)["max_abs_err"]
    require_repeatable("attention_boundmax", lambda: bound_mode(qkv))
    flat = attention_qkv(torch.Generator(device="cuda").manual_seed(25),
                         batch, s, HEADS, q_std=0.1)
    compare("attention_boundmax", f"flat softmax (q std 0.1) B={batch} S={s}",
            bound_mode(flat), attention_reference(
                flat, HEADS, HEAD_DIM, score_mode="boundmax"), **ATTN_TOL)
    del flat
    # a multiple of both tiles, two whole key tiles and a ragged query
    # block, and one ragged tile with fewer query rows than a block: the
    # masked keys must add nothing to the row sums
    for label, x in (("S=2432 B=2", qkv[:2, :2432].contiguous()),
                     ("S=256 B=2", qkv[:2, :256].contiguous()),
                     ("S=77 B=1", qkv[:1, :77].contiguous())):
        compare("attention_boundmax", label, bound_mode(x),
                attention_reference(x, HEADS, HEAD_DIM,
                                    score_mode="boundmax"), **ATTN_TOL)

    plain_ms = time_ms(lambda: attention_reference(
        qkv, HEADS, HEAD_DIM, score_mode="boundmax"), runs=3)
    kn_plain_ms = time_ms(lambda: key_norm_plain(k), runs=3)
    spread = time_spread({
        "boundmax": lambda: bound_mode(qkv),
        "f32max": lambda: fused_attention(qkv, HEADS, HEAD_DIM,
                                          score_mode="f32max"),
        "library": lambda: F.scaled_dot_product_attention(q, k, v),
        "key_norm": lambda: attention_key_norm(qkv, HEADS, HEAD_DIM)})
    ms = spread["boundmax"]["median"]
    flops = 4.0 * batch * HEADS * s * s * HEAD_DIM
    nbytes = 2.0 * batch * s * (c + HEADS * HEAD_DIM)
    full = bound(flops, PEAK_BF16_FLOPS, nbytes)
    kn_bytes = 2.0 * batch * s * HEADS * HEAD_DIM + 4.0 * batch * HEADS
    kn_ms = spread["key_norm"]["median"]
    return [{"name": "attention_boundmax", "route": "cuda",
             "source": "txr_torch/csrc/attention.cu",
             "replaces": "txr/ops/attention.py:217 (score_mode boundmax of "
                         "_fused_kernel_1pass, :170)",
             "shape": [batch, s, c], "max_abs_err": err, "ms": ms,
             "ms_spread": spread["boundmax"],
             "ms_includes": "the key-norm pre-pass",
             "f32max_ms": spread["f32max"]["median"],
             "f32max_ms_spread": spread["f32max"],
             "plain_ms": plain_ms, **full,
             "library_ms": spread["library"]["median"],
             "library_ms_spread": spread["library"],
             "library_call": "F.scaled_dot_product_attention",
             "tflops": flops / ms / 1e9},
            {"name": "attention_key_norm", "route": "cuda",
             "source": "txr_torch/csrc/attention.cu",
             "replaces": "txr/ops/attention.py:223 (max_k |k| inside "
                         "_fused_kernel_1pass)",
             "shape": [batch, s, c], "max_abs_err": kn_err, "ms": kn_ms,
             "ms_spread": spread["key_norm"], "plain_ms": kn_plain_ms,
             **bound(2.0 * batch * s * HEADS * HEAD_DIM, PEAK_F32_FLOPS,
                     kn_bytes),
             "library_ms": None,
             "gbytes_per_s": kn_bytes / kn_ms / 1e6}]


def require_tail_geometry(shape: tuple, sms: int) -> dict:
    """The built library must choose the tile, window and shared memory the
    wrapper computes for ``shape`` = (B, Hin, Win, C, out_h, out_w)."""
    geo = tail_geometry(*shape, sms)
    buf = (ctypes.c_int * 8)()
    rc = kernels.lib().txr_dpt_tail_geometry(*shape, sms, buf)
    want = (*geo["tile"], *geo["window"], geo["window_buffers"],
            geo["smem_bytes"], geo["grid"], geo["threads"])
    if rc != 0 or tuple(buf) != want:
        raise AssertionError(f"dpt_tail: the library reports geometry "
                             f"{rc} {tuple(buf)} for {shape}, the wrapper "
                             f"assumes {want}")
    return geo


def check_tail(batch: int, gen: torch.Generator) -> dict:
    hin, win, c, feat = 296, 528, 128, 32
    out_h, out_w = compute_da_resize(H, W, 518)
    sms = kernels.sm_count(0)

    def operands(b, hi, wi, ch, nout=1):
        x = torch.randn((b, hi, wi, ch), generator=gen, device="cuda")
        w2 = torch.randn((3, 3, ch, feat), generator=gen, device="cuda")
        w2 = w2 * 0.05 * (128 / ch) ** 0.5       # conv2's output of rms 4
        b2 = torch.randn((feat,), generator=gen, device="cuda") * 0.5
        w3 = torch.randn((1, 1, feat, nout), generator=gen, device="cuda")
        b3 = torch.randn((nout,), generator=gen, device="cuda")
        return [t.to(torch.bfloat16) for t in (x, w2, b2, w3, b3)]

    def exact(args, hs, ws):
        # the plain version in f32 arithmetic on the same bf16 values (its
        # bf16 run rounds three intermediates and is itself 0.2 off this)
        return head_tail_reference(*(t.float() for t in args), hs, ws)

    geo = require_tail_geometry((batch, hin, win, c, out_h, out_w), sms)
    args = operands(batch, hin, win, c)
    x, w2, b2, w3, b3 = args
    got = fused_head_tail(*args, out_h, out_w)
    want = exact(args, out_h, out_w)
    err = compare("dpt_tail", f"main B={batch} {hin}x{win}->{out_h}x{out_w}",
                  got, want, **TAIL_TOL)["max_abs_err"]
    del want, got
    require_repeatable("dpt_tail",
                       lambda: fused_head_tail(*args, out_h, out_w))
    # several outputs: Depth Anything 3's depth and ray branches
    for nout, (b, hi, wi, ho, wo) in ((2, (2, 20, 24, 35, 42)),
                                      (7, (2, 20, 24, 35, 42)),
                                      (7, (1, 12, 20, 21, 33))):
        many = operands(b, hi, wi, 128, nout)
        got = fused_head_tail(*many, ho, wo)
        compare("dpt_tail", f"N={nout} outputs: {hi}x{wi}x128->{ho}x{wo}",
                got, exact(many, ho, wo), **TAIL_TOL)
        if not torch.equal(got[..., 0], fused_head_tail(
                *many[:3], many[3][..., :1], many[4][:1], ho, wo)):
            raise AssertionError(f"dpt_tail: output 0 of {nout} differs "
                                 f"from the same output alone")
    # every resize ratio, every head width (C = features / 2 of the four
    # presets), an image smaller than one tile, one column past a tile,
    # fewer tiles than multiprocessors, and fusion_1's grid upsampled
    for label, (b, hi, wi, ch, ho, wo) in {
            "near-1 ratio 176->180": (1, 176, 40, 128, 180, 45),
            "downsample 64->40": (1, 64, 48, 128, 40, 30),
            "out_h == 1": (1, 32, 16, 128, 1, 20),
            "ratio 1 down, 4 across": (1, 8, 8, 64, 8, 32),
            "C=32 (vits)": (2, 20, 24, 32, 35, 42),
            "C=64 (vitb)": (2, 20, 24, 64, 35, 42),
            "C=128 (vitl)": (1, 20, 24, 128, 35, 42),
            "C=192 (vitg)": (2, 20, 24, 192, 35, 42),
            "smaller than a tile 5x7": (1, 4, 4, 128, 5, 7),
            "smaller than a tile 5x7, C=32": (1, 4, 4, 32, 5, 7),
            "out_w = tile width + 1": (1, 12, 20, 128, 21, 33),
            "out_w = tile width + 1, C=192": (2, 12, 20, 192, 21, 33),
            "10 tiles on all multiprocessors": (1, 24, 36, 128, 40, 60),
            "fusion_1 grid, B=2": (2, 74, 132, 128, 130, 231),
    }.items():
        g = require_tail_geometry((b, hi, wi, ch, ho, wo), sms)
        small = operands(b, hi, wi, ch)
        compare("dpt_tail", f"{label}: {hi}x{wi}x{ch}->{ho}x{wo}, tile "
                f"{g['tile'][0]}, grid {g['grid']}",
                fused_head_tail(*small, ho, wo), exact(small, ho, wo),
                **TAIL_TOL)
        require_repeatable("dpt_tail",
                           lambda: fused_head_tail(*small, ho, wo))

    plain_ms = time_ms(lambda: head_tail_reference(*args, out_h, out_w),
                       runs=3)
    packed = pack_params(w2, b2, w3, b3)
    xc = x.permute(0, 3, 1, 2)
    wk = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        y = F.interpolate(xc, size=(out_h, out_w), mode="bilinear",
                          align_corners=True)
        return F.conv2d(y, wk, b2, padding=1)

    spread = time_spread({
        "kernel": lambda: fused_head_tail(*args, out_h, out_w, packed),
        "kernel_packing_per_call": lambda: fused_head_tail(*args, out_h,
                                                           out_w),
        "library": library}, runs=10)
    ms = spread["kernel"]["median"]
    flops = 2.0 * 9 * c * feat * out_h * out_w * batch
    nbytes = 2.0 * (x.numel() + w2.numel() + batch * out_h * out_w)
    pos_case = check_tail_position_term(sms)
    return {"name": "dpt_tail", "route": "cuda",
            "source": "txr_torch/csrc/dpt_tail.cu",
            "replaces": "txr/ops/dpt_tail.py:114",
            "shape": [batch, hin, win, c, out_h, out_w], "max_abs_err": err,
            "ms": ms, "ms_spread": spread["kernel"],
            "ms_packing_per_call": spread["kernel_packing_per_call"],
            "plain_ms": plain_ms, **bound(flops, PEAK_BF16_FLOPS, nbytes),
            "library_ms": spread["library"]["median"],
            "library_ms_spread": spread["library"],
            "library_call": "F.interpolate + F.conv2d (conv2 only, no ReLU "
                            "or conv3)",
            "tflops": flops / ms / 1e9,
            "position_term": pos_case,
            "geometry": {k: list(v) if isinstance(v, tuple) else v
                         for k, v in geo.items()}}


# VGGT's tail: 32 views, conv1's output at 8 x the 21 x 37 patch grid,
# upsampled to 294 x 518, 2 and 4 outputs
VGGT_TAIL = (32, 168, 296, 128, 294, 518)


def check_tail_position_term(sms: int) -> dict:
    """The tail with VGGT's position term (conv2 of the embedding, added
    before the ReLU), on a generator of its own: against the plain version
    in f32 at VGGT's shape with 2 and 4 outputs and at ragged ones; a zero
    term bit-equal to no term; then the kernel with and without the term
    timed in one interleaved loop at VGGT's shape."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    feat = 32

    def operands(b, hi, wi, ch, ho, wo, nout):
        x = torch.randn((b, hi, wi, ch), generator=gen, device="cuda")
        w2 = torch.randn((3, 3, ch, feat), generator=gen, device="cuda")
        w2 = w2 * 0.05 * (128 / ch) ** 0.5
        b2 = torch.randn((feat,), generator=gen, device="cuda") * 0.5
        w3 = torch.randn((1, 1, feat, nout), generator=gen, device="cuda")
        b3 = torch.randn((nout,), generator=gen, device="cuda")
        args = [t.to(torch.bfloat16) for t in (x, w2, b2, w3, b3)]
        pe = torch.randn((ho, wo, ch), generator=gen, device="cuda") * 0.1
        return args, position_term(pe, args[1])

    b, hin, win, c, out_h, out_w = VGGT_TAIL
    cases = {f"VGGT N={n}": (b, hin, win, c, out_h, out_w, n) for n in (2, 4)}
    cases.update({"ragged 5x7, N=1": (1, 4, 4, 128, 5, 7, 1),
                  "out_w = tile width + 1, C=64": (2, 12, 20, 64, 21, 33, 4)})
    rec = []
    for label, (bb, hi, wi, ch, ho, wo, n) in cases.items():
        require_tail_geometry((bb, hi, wi, ch, ho, wo), sms)
        args, term = operands(bb, hi, wi, ch, ho, wo, n)
        got = fused_head_tail(*args, ho, wo, None, term)
        want = tail_exact((*args, ho, wo, None, term))
        rec.append(compare("dpt_tail", f"position term {label}: "
                           f"{hi}x{wi}x{ch}->{ho}x{wo}", got, want,
                           **TAIL_TOL))
        require_repeatable("dpt_tail", lambda: fused_head_tail(
            *args, ho, wo, None, term))
        if not torch.equal(fused_head_tail(*args, ho, wo),
                           fused_head_tail(*args, ho, wo, None,
                                           torch.zeros_like(term))):
            raise AssertionError(f"dpt_tail: a zero position term changes "
                                 f"the output ({label})")
        del got, want
    args, term = operands(b, hin, win, c, out_h, out_w, 2)
    packed = pack_params(*args[1:])
    spread = time_spread({
        "kernel": lambda: fused_head_tail(*args, out_h, out_w, packed),
        "kernel_position_term": lambda: fused_head_tail(
            *args, out_h, out_w, packed, term)}, runs=10)
    return {"shape": list(VGGT_TAIL), "checks": [
                {k: r.get(k) for k in ("case", "max_abs_err", "err_rms")}
                for r in rec],
            "ms": spread["kernel_position_term"]["median"],
            "ms_spread": spread["kernel_position_term"],
            "ms_without_term": spread["kernel"]["median"],
            "ms_without_term_spread": spread["kernel"],
            "term_bytes": term.numel() * 4}


def surface_points(batch: int, shift: float) -> PointSet:
    """Points of ``batch`` frames looking at a smooth surface 1 to 3 m away,
    back-projected on the model's depth grid as the main path does."""
    in_h, in_w = compute_da_resize(H, W, 518)
    sx, sy = in_w / W, in_h / H
    vv = torch.linspace(0, 1, in_h, device="cuda")[:, None]
    uu = torch.linspace(0, 1, in_w, device="cuda")[None, :]
    frames = torch.arange(batch, device="cuda", dtype=torch.float32)
    depth = (2.0 + torch.sin(6.0 * uu + 0.3 * frames[:, None, None] + shift)
             * torch.cos(5.0 * vv)) .to(torch.float32)
    rgb = torch.stack([uu.expand(in_h, in_w), vv.expand(in_h, in_w),
                       0.5 * (uu + vv)], dim=-1).expand(batch, -1, -1, -1)
    ps = backproject_world(depth, rgb, torch.eye(3, device="cuda"),
                           torch.zeros(3, device="cuda"), 0.8 * W * sx,
                           0.8 * W * sy, W / 2 * sx, H / 2 * sy, 1e-4, 1e6)
    n = batch * in_h * in_w
    return PointSet(ps.xyz.reshape(n, 3), ps.rgb.reshape(n, 3),
                    ps.mask.reshape(n))


def check_scan(batch: int, gen: torch.Generator) -> dict:
    require_geometry("segscan", kernels.lib().txr_segscan_geometry,
                     (SCAN_TILE, SCAN_THREADS, SCAN_ITEMS, SCAN_MAX_COLS))
    # Real segment structure: the sorted rows of an insert of `batch` frames
    # into a map that already holds an earlier insert.
    vm = create_offset_map(1 << 21, 0.01)
    vm = offset_map_insert(vm, surface_points(batch, 0.0))
    resident = int(offset_map_size(vm))
    wcols, starts = offset_map_scan_inputs(vm, surface_points(batch, 0.4))
    n = starts.shape[0]
    nseg = int(starts.sum())

    def plain(cols_, starts_):
        out = segmented_cumsum(torch.stack(cols_, dim=1), starts_)
        return out.t()

    def kernel(cols_, starts_):
        return torch.stack(segmented_cumsum_cols(cols_, starts_))

    err = compare("segscan", f"main N={n} cols=7 segments={nseg}",
                  kernel(wcols, starts), plain(wcols, starts),
                  **SCAN_TOL)["max_abs_err"]
    require_repeatable("segscan", lambda: kernel(wcols, starts))

    m = 1_000_003     # not a multiple of the tile
    vals = (torch.rand((m,), generator=gen, device="cuda"),)
    none = torch.zeros((m,), dtype=torch.bool, device="cuda")
    none[0] = True
    want = torch.cumsum(vals[0].double(), 0).float()[None]
    compare("segscan", f"start at row 0 only, N={m}", kernel(vals, none),
            want, atol=1e-3, rtol=1e-5,
            why="a plain f32 running sum up to 5e5 (ulp 0.03) against "
                "float64")
    every = torch.ones((m,), dtype=torch.bool, device="cuda")
    compare("segscan", f"start at every row, N={m}", kernel(vals, every),
            vals[0][None], atol=0.0, rtol=0.0,
            why="every row is its own segment: exact")
    # one segment over many tiles (a voxel hit by 300,000 rows) between
    # short ones
    long = torch.rand((m,), generator=gen, device="cuda") < 0.3
    long[200_000:500_000] = False
    long[200_000] = True
    ref = torch.zeros((m,), dtype=torch.float64, device="cuda")
    ref[200_000:500_000] = torch.cumsum(vals[0][200_000:500_000].double(), 0)
    got = kernel(vals, long)[0]
    compare("segscan", "one segment of 300,000 rows (146 tiles)",
            got[200_000:500_000], ref[200_000:500_000].float(), atol=1e-3,
            rtol=1e-5, why="a plain f32 running sum up to 1.5e5 against "
                           "float64")
    compare("segscan", "short segments around the long one", got,
            plain(vals, long)[0], **SCAN_TOL)
    eight = tuple(torch.randn((4099,), generator=gen, device="cuda")
                  for _ in range(8))
    st = torch.rand((4099,), generator=gen, device="cuda") < 0.01
    compare("segscan", "8 columns, N=4099, long segments",
            kernel(eight, st), plain(eight, st), atol=1e-3, rtol=1e-5,
            why=SCAN_TOL["why"])
    # one row; one tile less, one row short of and past a tile, two tiles
    for rows in (1, SCAN_TILE - 1, SCAN_TILE, SCAN_TILE + 1, 2 * SCAN_TILE):
        cols = tuple(c[:rows].contiguous() for c in eight[:3])
        sub = st[:rows].contiguous()
        compare("segscan", f"N={rows} cols=3, "
                f"{scan_geometry(rows)['tiles']} tile(s)", kernel(cols, sub),
                plain(cols, sub), **SCAN_TOL)
    # 7 columns, random starts: one row, one row short of and past a tile,
    # no start at all, segments over many tiles
    for rows, p in ((1, 0.5), (SCAN_TILE - 1, 0.1), (SCAN_TILE + 1, 0.1),
                    (100_003, 0.2), (100_003, 0.0), (1_000_003, 1e-5)):
        cols = tuple(torch.randn((rows,), generator=gen, device="cuda")
                     for _ in range(7))
        sub = torch.rand((rows,), generator=gen, device="cuda") < p
        compare("segscan", f"N={rows} cols=7, start share {p}",
                kernel(cols, sub), plain(cols, sub), **SCAN_TOL)
        require_repeatable("segscan", lambda: kernel(cols, sub))

    plain_ms = time_ms(lambda: plain(wcols, starts), runs=3)
    spread = time_spread({"kernel": lambda: segmented_cumsum_cols(wcols,
                                                                  starts)},
                         runs=10)
    ms = spread["kernel"]["median"]
    nbytes = n * (7 * 4 + 1 + 7 * 4)
    return {"name": "segscan", "route": "cuda",
            "source": "txr_torch/csrc/segscan.cu",
            "replaces": "txr/ops/scan.py:40",
            "shape": [7, n], "segments": nseg, "resident_voxels": resident,
            "max_abs_err": err, "ms": ms, "ms_spread": spread["kernel"],
            "plain_ms": plain_ms,
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": None, "gbytes_per_s": nbytes / ms / 1e6,
            "geometry": scan_geometry(n)}


def scattered_points(n: int, gen: torch.Generator) -> PointSet:
    """``n`` valid points spread over a 6 m cube: at 1 cm nearly every point
    is a voxel of its own, so one insert of a path step fills a 2^21 map."""
    return PointSet(torch.rand((n, 3), generator=gen, device="cuda") * 6 - 3,
                    torch.rand((n, 3), generator=gen, device="cuda"),
                    torch.ones((n,), dtype=torch.bool, device="cuda"))


def require_maps_equal(case: str, got, want) -> int:
    """The fused reduce's map against the unfused route's, column by column,
    bit for bit; returns the voxels held."""
    torch.cuda.synchronize()
    same = [bool(torch.equal(g, w)) for g, w in zip(got[:NCOLS],
                                                     want[:NCOLS])]
    voxels = int(offset_map_size(got))
    emit({"phase": "kernel_check", "kernel": "offset_reduce", "case": case,
          "rows": got.khi.shape[0], "voxels": voxels,
          "columns_bit_equal": dict(zip(("khi", "klo_x", "yzw", "rgb"),
                                        same)),
          "tolerance_reason": "the same scan core and summation order as "
                              "the standalone scan kernel of the unfused "
                              "route, and the same f32 operations after it: "
                              "bit-equal",
          "ok": all(same)})
    if not all(same):
        raise AssertionError(f"offset_reduce/{case}: the fused reduce "
                             f"differs from the unfused route ({same})")
    return voxels


def check_offset_reduce(batch: int, gen: torch.Generator) -> dict:
    """The insert's fused segment reduce against the unfused route on the
    card (``torch.sort``, the standalone scan kernel, ``torch.nonzero``
    compaction), with no host sync inside an insert or a merge."""
    in_h, in_w = compute_da_resize(H, W, 518)
    n_batch = batch * in_h * in_w
    cap = 1 << 21

    def both(case, cols, cap_, vs, fused):
        return require_maps_equal(case, fused,
                                  _reduce_unfused(cols, cap_, vs))

    def insert(vm, pts):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return offset_map_insert(vm, pts)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    # path shape: a full map and a batch of scattered points
    vm = insert(create_offset_map(cap, 0.01), scattered_points(n_batch, gen))
    if int(offset_map_size(vm)) != cap:
        raise AssertionError("offset_reduce: the map should be full")
    pts = scattered_points(n_batch, gen)
    cols = _insert_cols(vm, pts)
    n = cols[0].shape[0]
    fused = insert(vm, pts)
    both(f"full map + {n_batch} scattered points, N={n}", cols, cap,
         vm.voxel_size, fused)
    again = insert(vm, pts)
    if not all(torch.equal(a, b) for a, b in zip(fused[:NCOLS],
                                                   again[:NCOLS])):
        raise AssertionError("offset_reduce: two inserts of one batch differ")
    emit({"phase": "kernel_check", "kernel": "offset_reduce",
          "case": "two runs on one input are bit-equal", "ok": True})
    del fused, again
    # real segment structure: a surface seen twice, long voxel segments
    sv = insert(create_offset_map(cap, 0.01), surface_points(batch, 0.0))
    sp = surface_points(batch, 0.4)
    both(f"surface map + surface frames, N={cap + n_batch}",
         _insert_cols(sv, sp), cap, sv.voxel_size, insert(sv, sp))
    # an overflowing small map keeps its lowest voxel keys
    small = insert(create_offset_map(4096, 0.01), scattered_points(3000, gen))
    more = scattered_points(5000, gen)
    got = insert(small, more)
    both("overflow, cap 4096, 3000 + 5000 voxels", _insert_cols(small, more),
         4096, small.voxel_size, got)
    skey, _ = _sort_keys(_insert_cols(small, more))
    lowest = torch.unique_consecutive(skey >> 10)[:4096]
    kept = (got.khi.long() << 22) | ((got.klo_x.long() + (1 << 31)) >> 10)
    if not torch.equal(kept, lowest):
        raise AssertionError("offset_reduce: an overflowing map must keep "
                             "its lowest keys")
    # an all-invalid batch leaves a non-empty map as it was
    dead = PointSet(torch.full((1000, 3), float("nan"), device="cuda"),
                    torch.zeros((1000, 3), device="cuda"),
                    torch.zeros((1000,), dtype=torch.bool, device="cuda"))
    same = insert(small, dead)
    both("all-invalid batch into a map of 3000", _insert_cols(small, dead),
         4096, small.voxel_size, same)
    if not all(torch.equal(a, b) for a, b in zip(same[:NCOLS],
                                                   small[:NCOLS])):
        raise AssertionError("offset_reduce: an all-invalid batch changed "
                             "the map")
    # a voxel whose weight saturates at 2047
    one = PointSet(torch.full((50_000, 3), 0.25, device="cuda"),
                   torch.tensor([[0.5, 0.25, 0.75]],
                                device="cuda").expand(50_000, 3),
                   torch.ones((50_000,), dtype=torch.bool, device="cuda"))
    first = insert(create_offset_map(64, 1.0), one)
    sat = insert(first, one)
    both("weight-saturating voxel, 2 x 50,000 rows",
         _insert_cols(first, one), 64, sat.voxel_size, sat)
    if int((sat.yzw & 0x7FF).max()) != 2047:
        raise AssertionError("offset_reduce: the weight did not saturate")
    # the merge of two maps goes through the same kernel
    torch.cuda.set_sync_debug_mode("error")
    try:
        merged = offset_map_merge(sv, vm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    both("offset_map_merge of two 2^21 maps",
         tuple(torch.cat([x, y]) for x, y in zip(sv[:NCOLS], vm[:NCOLS])),
         cap, sv.voxel_size, merged)

    # timing at the path shape: the kernel alone on the sorted key (it
    # rewrites the same rows each time), against the unfused route after
    # the same sort
    skey, perm = _sort_keys(cols)
    out = tuple(create_offset_map(cap, 0.01)[:NCOLS])
    spread = time_spread({
        "kernel": lambda: offset_reduce(skey, perm, cols[2], cols[3], out),
        "sort": lambda: _sort_keys(cols),
        "unfused_with_sort": lambda: _reduce_unfused(cols, cap,
                                                     vm.voxel_size),
        "insert": lambda: offset_map_insert(vm, pts)}, runs=10)
    ms = spread["kernel"]["median"]
    nbytes = n * (8 + 8 + 4 + 4) + 16.0 * cap
    return {"entry": "txr_offset_reduce_fwd", "shape": [n],
            "kept_voxels": cap, "ms": ms, "ms_spread": spread["kernel"],
            "sort_ms": spread["sort"]["median"],
            "unfused_ms": spread["unfused_with_sort"]["median"]
            - spread["sort"]["median"],
            "unfused_with_sort_ms": spread["unfused_with_sort"]["median"],
            "unfused_route": "torch gathers and elementwise unpack, the "
                             "standalone scan kernel, torch.nonzero "
                             "compaction, torch repack",
            "insert_ms": spread["insert"]["median"],
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "gbytes_per_s": nbytes / ms / 1e6}


def merge_case(case: str, khi: torch.Tensor, klo: torch.Tensor,
               tkhi: torch.Tensor, tklo: torch.Tensor) -> tuple:
    """The merge kernel on ``case``'s head (key-ordered int32 columns) and
    tail (the batch's columns in no order) against the plain merge and
    against ``torch.sort(stable=True)`` of all rows: the keys and the
    permutation bit for bit. Returns the kernel's operands."""
    tail_key, tail_perm = torch.sort(row_keys(tkhi, tklo), stable=True)
    got = merge_sorted(khi, klo, tail_key, tail_perm)
    plain = merge_sorted_plain(khi, klo, tail_key, tail_perm)
    whole = torch.sort(row_keys(torch.cat([khi, tkhi]),
                                torch.cat([klo, tklo])), stable=True)
    require_repeatable("merge_sorted", lambda: torch.stack(
        merge_sorted(khi, klo, tail_key, tail_perm)))
    torch.cuda.synchronize()
    same = {f"{part}_vs_{ref}": bool(torch.equal(g, w))
            for ref, want in (("plain", plain), ("torch_sort", whole))
            for part, g, w in zip(("key", "perm"), got, want)}
    emit({"phase": "kernel_check", "kernel": "merge_sorted", "case": case,
          "head_rows": khi.shape[0], "tail_rows": tkhi.shape[0],
          "bit_equal": same,
          "tolerance_reason": "a merge moves keys and indices and computes "
                              "nothing: bit-equal",
          "ok": all(same.values())})
    if not all(same.values()):
        raise AssertionError(f"merge_sorted/{case}: {same}")
    return khi, klo, tail_key, tail_perm


@torch.no_grad()
def check_merge(batch: int, gen: torch.Generator) -> dict:
    """The insert's merge of the sorted batch into the map's key-ordered
    rows against the plain merge and the stable sort of all rows: heads of
    2^26 rows from real inserts (a full map and one with empty rows) with
    the batches of the DA2 (8 frames) and DA3 (16) cells, then ties of the
    full key, empty rows, an empty tail, an all-invalid batch, no head, an
    overflow and ragged lengths; timed at both cells' shapes against the
    bytes it must move. Draws from its own generator, so that the shared
    one's later checks see the numbers they saw before this check."""
    del gen
    require_geometry("merge_sorted", kernels.lib().txr_merge_geometry,
                     (MERGE_TILE, MERGE_THREADS, MERGE_ITEMS,
                      MERGE_PART_THREADS))
    own = torch.Generator(device="cuda").manual_seed(23)
    cap = 1 << 26
    full = offset_map_insert(create_offset_map(cap, 0.01),
                             scattered_points(100_000_000, own))
    part = offset_map_insert(create_offset_map(cap, 0.01),
                             scattered_points(30_000_000, own))
    if int(offset_map_size(full)) != cap:
        raise AssertionError("merge_sorted: the map should be full")
    tails = {}
    for f in (8, 16):
        tails[f] = _point_cols(surface_points(f, 0.4), full.voxel_size)[:2]
    timed = {}
    for name, vm in (("full map", full), ("map with empty rows", part)):
        for f, (tkhi, tklo) in tails.items():
            ops = merge_case(f"{name} of 2^26 rows + {f} frames "
                             f"({tkhi.shape[0]} rows)", vm.khi, vm.klo_x,
                             tkhi, tklo)
            if name == "full map":
                timed[f] = ops
    del part
    torch.cuda.empty_cache()

    # the edge cases, on a small map
    def rows(n):
        return _point_cols(scattered_points(n, own), full.voxel_size)[:2]

    small = offset_map_insert(create_offset_map(4096, 0.01),
                              scattered_points(3000, own))
    pick = torch.randint(0, 3000, (500,), generator=own, device="cuda")
    copies = (small.khi[pick], small.klo_x[pick])
    nkhi, nklo = rows(700)
    merge_case("ties of the full key with the head and within the tail",
               small.khi, small.klo_x,
               torch.cat([copies[0], nkhi, copies[0]]),
               torch.cat([copies[1], nklo, copies[1]]))
    dead = torch.full((1000,), INT_MAX, dtype=torch.int32, device="cuda")
    empty = create_offset_map(4096, 0.01)
    merge_case("empty rows on both sides", empty.khi, empty.klo_x, dead,
               dead)
    merge_case("empty map, valid batch: tiles of tail rows alone",
               empty.khi, empty.klo_x, *rows(5000))
    merge_case("empty tail", small.khi, small.klo_x, dead[:0], dead[:0])
    merge_case("all-invalid batch", small.khi, small.klo_x, dead, dead)
    merge_case("no head", dead[:0], dead[:0], *rows(5000))
    full_small = offset_map_insert(small, scattered_points(3000, own))
    merge_case("overflowing map of 4096 + 5000 new rows", full_small.khi,
               full_small.klo_x, *rows(5000))
    for nh, nt in ((1, 0), (0, 1), (1, 1), (MERGE_TILE - 1, 0),
                   (MERGE_TILE - 3, 4), (MERGE_TILE + 1, 2),
                   (3 * MERGE_TILE + 7, MERGE_TILE + 5)):
        hk = offset_map_insert(create_offset_map(max(nh, 1), 0.01),
                               scattered_points(nh, own)) if nh else None
        tk = rows(nt)
        merge_case(f"{nh} head rows, {nt} tail rows",
                   hk.khi[:nh] if nh else dead[:0],
                   hk.klo_x[:nh] if nh else dead[:0], *tk)

    # timing at the cells' shapes; the whole sort is the library yardstick,
    # the batch's sort the other half of the insert's new sort span
    out = {}
    for f, (khi, klo, tail_key, tail_perm) in timed.items():
        nh, nt = khi.shape[0], tail_key.shape[0]
        tkhi, tklo = tails[f]
        all_khi, all_klo = torch.cat([khi, tkhi]), torch.cat([klo, tklo])
        all_key = row_keys(all_khi, all_klo)
        tail_raw = row_keys(tkhi, tklo)
        cols = (all_khi, all_klo)
        spread = time_spread({
            "kernel": lambda: merge_sorted(khi, klo, tail_key, tail_perm),
            "plain": lambda: merge_sorted_plain(khi, klo, tail_key,
                                                tail_perm),
            "whole_sort": lambda: torch.sort(all_key, stable=True),
            "batch_sort": lambda: torch.sort(tail_raw, stable=True),
            "sort_span_merged": lambda: _sort_keys(cols, nh),
            "sort_span_whole": lambda: _sort_keys(cols)}, runs=10)
        ms = spread["kernel"]["median"]
        nbytes = 8 * nh + 16 * nt + 16 * (nh + nt)
        bound_ms = nbytes / PEAK_BYTES * 1e3
        out[f] = {"shape": [nh, nt], "ms": ms,
                  "ms_spread": spread["kernel"],
                  "plain_ms": spread["plain"]["median"],
                  "library_ms": spread["whole_sort"]["median"],
                  "batch_sort_ms": spread["batch_sort"]["median"],
                  "sort_span_ms": spread["sort_span_merged"]["median"],
                  "sort_span_whole_ms": spread["sort_span_whole"]["median"],
                  "bound_ms": bound_ms, "roofline_share": bound_ms / ms,
                  "gbytes_per_s": nbytes / ms / 1e6,
                  "geometry": merge_geometry(nh, nt)}
        del all_khi, all_klo, all_key, tail_raw, cols
    da2, da3 = out[8], out[16]
    return {"name": "merge_sorted", "route": "cuda",
            "source": "txr_torch/csrc/merge.cu", "replaces": None,
            **da2, "bound_by": "bytes",
            "library_call": "torch.sort(stable=True) of the map's and the "
                            "batch's keys together",
            "da3_16_frames": da3}


def bound(ops: float, peak_ops: float, nbytes: float) -> dict:
    """The least time the card could take: the larger of operations over
    their peak rate and bytes over the memory rate."""
    t_ops, t_bytes = ops / peak_ops * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


INT8_TOL = dict(bit_equal_share=0.999, atol=1e-6, rtol=2.0 ** -8,
                why="against the plain version on the card, which takes the "
                    "same integer sums exactly (float64) and the same f32 "
                    "rescale: equal bit for bit but where a quantised value "
                    "sits on a rounding tie or the two last f32 bits differ, "
                    "and then within one bf16 ulp")


def compare_bits(name: str, case: str, got: torch.Tensor,
                 want: torch.Tensor) -> dict:
    """kernel_check line for a kernel that must equal its plain version bit
    for bit nearly everywhere: the share of equal elements and the largest
    miss in ulps-of-the-value terms; raises outside INT8_TOL."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}/{case}: {got.shape} {got.dtype} vs "
                             f"{want.shape} {want.dtype}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}/{case}: kernel output is not finite")
    # counted in integers: a float32 mean over 80 M elements would round
    share = (got == want).sum().item() / got.numel()
    err = (g - w).abs()
    max_abs = err.max().item()
    worst = (err - (INT8_TOL["atol"] + INT8_TOL["rtol"] * w.abs())).max().item()
    ok = share >= INT8_TOL["bit_equal_share"] and worst <= 0
    emit({"phase": "kernel_check", "kernel": name, "case": case,
          "shape": list(g.shape), "bit_equal_share": share,
          "max_abs_err": max_abs, "value_rms": w.pow(2).mean().sqrt().item(),
          "value_max": w.abs().max().item(), "atol": INT8_TOL["atol"],
          "rtol": INT8_TOL["rtol"],
          "min_bit_equal_share": INT8_TOL["bit_equal_share"],
          "least_margin": -worst, "tolerance_reason": INT8_TOL["why"],
          "ok": ok})
    if not ok:
        raise AssertionError(
            f"{name}/{case}: {share:.6f} of the elements bit-equal, max abs "
            f"err {max_abs}")
    return {"max_abs_err": max_abs, "bit_equal_share": share}


def int8_parts(mod: Int8LinearFused, x: torch.Tensor) -> tuple:
    """The two kernels behind ``mod(x)`` as separate calls, for timing them
    apart: ``quantise()`` (rows of x -> int8 and scales) and ``gemm()`` (the
    product and its epilogue on that result). x: (M, K) bf16 on the card."""
    m, k = x.shape
    n = mod.out_features
    _, wq_nk, sw = mod._wq.get(mod.weight)
    bias = mod._b32.get(mod.bias)
    xq = torch.empty((m, k), dtype=torch.int8, device=x.device)
    sx = torch.empty((m,), dtype=torch.float32, device=x.device)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    sms = kernels.sm_count(x.device)
    lib = kernels.lib()

    def quantise():
        kernels.check(lib.txr_int8_quantize_rows(
            x.data_ptr(), xq.data_ptr(), sx.data_ptr(), m, k,
            torch.cuda.current_stream().cuda_stream), "int8_quantize_rows")
        return xq

    def gemm():
        kernels.check(lib.txr_int8_gemm(
            xq.data_ptr(), wq_nk.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            bias.data_ptr(), out.data_ptr(), m, k, n, sms,
            torch.cuda.current_stream().cuda_stream), "int8_gemm")
        return out

    quantise()
    return quantise, gemm


def check_int8_linear(batch: int, gen: torch.Generator) -> dict:
    in_h, in_w = compute_da_resize(H, W, 518)
    m = batch * ((in_h // 14) * (in_w // 14) + 1)
    sms = kernels.sm_count(0)

    def operands(rows, k, n):
        x = torch.randn((rows, k), generator=gen, device="cuda")
        # a few large entries per row, so that the row's scale matters
        cols = torch.randint(0, k, (rows, 4), generator=gen, device="cuda")
        x.scatter_(1, cols, 8.0 * torch.randn((rows, 4), generator=gen,
                                              device="cuda"))
        x[rows // 2] = 0.0                  # an all-zero row: bias only
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        b = torch.randn((n,), generator=gen, device="cuda")
        return x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)

    geo = int8_geometry(m, 4096, 1024, sms)
    require_geometry("int8_linear", kernels.lib().txr_int8_linear_geometry,
                     (TILE_M, TILE_N, STAGES, geo["smem_bytes"]))
    # one whole tile; ragged in every way; one row; one row past a tile;
    # K shorter than one swizzled row; K one 16-byte piece past a whole
    # number of stages; the narrowest N; all three at once
    for label, (rows, k, n) in {"one tile": (128, 128, 256),
                                "ragged": (300, 96, 136),
                                "one row": (1, 1024, 264),
                                "one row past a tile": (129, 256, 512),
                                "129 rows, K = N = 1024": (129, 1024, 1024),
                                "K = 16": (200, 16, 72),
                                "K = 4096 + 16": (77, 4096 + 16, 264),
                                "N = 8": (300, 128, 8),
                                "one row, K = 16, N = 8": (1, 16, 8)}.items():
        x, w, b = operands(rows, k, n)
        got = int8_linear(x, w, b)
        compare_bits("int8_linear", f"{label} M={rows} K={k} N={n}", got,
                     int8_linear_reference(x, w, b))
        if not torch.equal(got[rows // 2].float(), b.float()):
            raise AssertionError(
                f"int8_linear {label}: an all-zero row must give the bias")
        require_repeatable("int8_linear", lambda: int8_linear(x, w, b))
    # rounding ties: the row maximum 127 makes the scale 1, and every other
    # value k + 0.5 (exact in bf16 up to 64) sits between two integers
    x, w, b = operands(64, 256, 64)
    ties = (torch.arange(256, device="cuda")[None, :] * 7
            + torch.arange(64, device="cuda")[:, None]) % 128 - 64
    x = (ties.float() + 0.5).to(torch.bfloat16)
    x[:, 0] = 127.0
    if not torch.equal(x.float()[:, 1:] % 1.0, torch.full_like(
            x.float()[:, 1:], 0.5)):
        raise AssertionError("the tie inputs are not exact in bf16")
    compare_bits("int8_linear", "rounding ties x / sx = k + 0.5, M=64 K=256 "
                 "N=64", int8_linear(x, w, b), int8_linear_reference(x, w, b))

    by_shape = []
    for role, k, n in (("qkv", 1024, 3072), ("proj", 1024, 1024),
                       ("fc1", 1024, 4096), ("fc2", 4096, 1024)):
        x, w, b = operands(m, k, n)
        fused = Int8LinearFused(k, n).to("cuda", torch.bfloat16)
        lib8 = Int8Linear(k, n).to("cuda", torch.bfloat16)
        plain = torch.nn.Linear(k, n).to("cuda", torch.bfloat16)
        with torch.no_grad():
            for mod in (fused, lib8, plain):
                mod.weight.copy_(w.t())
                mod.bias.copy_(b)
            res = compare_bits("int8_linear", f"{role} M={m} K={k} N={n}",
                               fused(x), int8_linear_reference(x, w, b))
            if role == "fc2":
                require_repeatable("int8_linear", lambda: fused(x))
            plain_ms = time_ms(lambda: int8_linear_reference(x, w, b), runs=3)
            quantise, gemm = int8_parts(fused, x)
            spread = time_spread({
                "kernel": lambda: fused(x), "quantise": quantise,
                "gemm": gemm, "bf16": lambda: plain(x),
                "int_mm": lambda: lib8(x)}, runs=10)
        ms = spread["kernel"]["median"]
        ops = 2.0 * m * k * n
        nbytes = 2.0 * m * k + k * n + 8.0 * n + 2.0 * m * n
        site = int8_geometry(m, k, n, sms)
        by_shape.append({"role": role, "shape": [m, k, n], **res, "ms": ms,
                         "ms_spread": spread["kernel"],
                         "quantise_ms": spread["quantise"]["median"],
                         "quantise_ms_spread": spread["quantise"],
                         "quantise_bound_ms": 3.0 * m * k / PEAK_BYTES * 1e3,
                         "gemm_ms": spread["gemm"]["median"],
                         "gemm_ms_spread": spread["gemm"],
                         "gemm_tops": ops / spread["gemm"]["median"] / 1e9,
                         # the two kernels' own time, without the wrapper's
                         # host work that "ms" may be waiting for
                         "device_ms": spread["quantise"]["median"]
                         + spread["gemm"]["median"],
                         "plain_ms": plain_ms,
                         **bound(ops, PEAK_INT8_OPS, nbytes),
                         "library_ms": spread["bf16"]["median"],
                         "library_ms_spread": spread["bf16"],
                         "library_int8_ms": spread["int_mm"]["median"],
                         "tops": ops / ms / 1e9, "tiles": site["tiles"],
                         "waves": site["waves"], "grid": site["grid"]})
        del x, w, b, fused, lib8, plain, quantise, gemm
    fc2 = by_shape[-1]
    return {"name": "int8_linear", "route": "cuda",
            "source": "txr_torch/csrc/int8_linear.cu",
            "replaces": "txr/ops/quant_pallas.py:37",
            "shape": fc2["shape"], "shape_role": "fc2 (the other three "
            "shapes of an encoder block are under by_shape)",
            "max_abs_err": max(r["max_abs_err"] for r in by_shape),
            "bit_equal_share": min(r["bit_equal_share"] for r in by_shape),
            "ms": fc2["ms"], "ms_spread": fc2["ms_spread"],
            "plain_ms": fc2["plain_ms"],
            "bound_ms": fc2["bound_ms"], "bound_by": fc2["bound_by"],
            "library_ms": fc2["library_ms"],
            "library_call": "F.linear in bf16 (nn.Linear); library_int8_ms "
                            "is the 'int8' policy: torch._int_mm with its "
                            "quantise and rescale passes",
            "library_int8_ms": fc2["library_int8_ms"],
            "block_ms": sum(r["ms"] for r in by_shape),
            "block_device_ms": sum(r["device_ms"] for r in by_shape),
            "block_quantise_ms": sum(r["quantise_ms"] for r in by_shape),
            "block_gemm_ms": sum(r["gemm_ms"] for r in by_shape),
            "block_bound_ms": sum(r["bound_ms"] for r in by_shape),
            "block_library_ms": sum(r["library_ms"] for r in by_shape),
            "block_library_int8_ms": sum(r["library_int8_ms"]
                                         for r in by_shape),
            "tops": fc2["tops"], "by_shape": by_shape,
            "smem_bytes": geo["smem_bytes"]}


CONV_TOL = dict(atol=2e-3, rtol=2.0 ** -7, rms_rtol=2.0 ** -7,
                why="against the plain version in f32 arithmetic on the same "
                    "bf16 inputs: the kernel accumulates in f32 in another "
                    "order and rounds once to bf16, so two bf16 ulps "
                    "(2^-7 of the value) and 2e-3 absolute for values near "
                    "zero, where terms of both signs cancel")


def check_conv3x3(batch: int, gen: torch.Generator) -> dict:
    def operands(b, h, w, c, f):
        x = torch.randn((b, h, w, c), generator=gen, device="cuda").to(
            torch.bfloat16)
        wgt = (torch.randn((3, 3, c, f), generator=gen, device="cuda")
               * (9 * c) ** -0.5).to(torch.bfloat16)
        bias = torch.randn((f,), generator=gen, device="cuda").to(
            torch.bfloat16)
        return x, wgt, bias

    def exact(x, wgt, bias, relu):
        return conv3x3_reference(x.float(), wgt.float(), bias.float(), relu)

    geo = conv_geometry(batch, 148, 264, 256, 256)
    require_geometry("conv3x3", kernels.lib().txr_conv3x3_geometry,
                     (TILE_H, TILE_W, BLOCK_F, geo["smem_bytes"]))
    # one whole tile and feature block; ragged in every way: H, W, a short
    # channel chunk, few features; an image smaller than one tile; a
    # feature count that is a multiple of the feature block of no kind
    for label, shape in (("one tile 16x16 64->128", (1, 16, 16, 64, 128)),
                         ("ragged 13x21 48->40", (1, 13, 21, 48, 40)),
                         ("smaller than a tile 5x7 64->64", (1, 5, 7, 64, 64)),
                         ("F=136 20x33 256->136", (2, 20, 33, 256, 136))):
        x, wgt, bias = operands(*shape)
        for relu in (False, True):
            compare("conv3x3", f"{label} relu_in={relu}",
                    conv3x3_stripe(x, wgt, bias, relu),
                    exact(x, wgt, bias, relu), **CONV_TOL)
            require_repeatable("conv3x3",
                               lambda: conv3x3_stripe(x, wgt, bias, relu))

    by_shape = []
    for label, h, w, c, f, per_step in (
            ("fusion_1", 74, 132, 256, 256, 4),
            ("fusion_0", 148, 264, 256, 256, 4),
            ("head_conv1", 296, 528, 256, 128, 1)):
        x, wgt, bias = operands(batch, h, w, c, f)
        packed = pack_weight(wgt)
        errs = []
        for relu in (False, True):
            errs.append(compare(
                "conv3x3", f"{label} B={batch} {h}x{w} {c}->{f} "
                f"relu_in={relu}", conv3x3_stripe(x, wgt, bias, relu, packed),
                exact(x, wgt, bias, relu), **CONV_TOL)["max_abs_err"])
        relu = label != "head_conv1"          # as the path calls it
        if label == "fusion_1":
            require_repeatable("conv3x3", lambda: conv3x3_stripe(
                x, wgt, bias, relu, packed))
        plain_ms = time_ms(lambda: conv3x3_reference(x, wgt, bias, relu),
                           runs=3)
        xc = x.permute(0, 3, 1, 2)
        wk = wgt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(F.relu(xc) if relu else xc, wk, bias, padding=1)

        spread = time_spread({
            "kernel": lambda: conv3x3_stripe(x, wgt, bias, relu, packed),
            "library": library})
        ms = spread["kernel"]["median"]
        flops = 2.0 * 9 * c * f * h * w * batch
        nbytes = 2.0 * (x.numel() + wgt.numel() + batch * h * w * f) + 4.0 * f
        site = conv_geometry(batch, h, w, c, f)
        by_shape.append({"site": label, "shape": [batch, h, w, c, f],
                         "relu_in": relu, "launches_per_step": per_step,
                         "max_abs_err": max(errs), "ms": ms,
                         "ms_spread": spread["kernel"],
                         "plain_ms": plain_ms,
                         **bound(flops, PEAK_BF16_FLOPS, nbytes),
                         "library_ms": spread["library"]["median"],
                         "library_ms_spread": spread["library"],
                         "tflops": flops / ms / 1e9,
                         "grid": list(site["grid"]),
                         "stored_share": site["stored_share"]})
        del x, wgt, bias, packed, xc, wk
    mid = by_shape[1]
    step_ms = sum(r["ms"] * r["launches_per_step"] for r in by_shape)
    step_library_ms = sum(r["library_ms"] * r["launches_per_step"]
                          for r in by_shape)
    step_bound_ms = sum(r["bound_ms"] * r["launches_per_step"]
                        for r in by_shape)
    return {"name": "conv3x3", "route": "cuda",
            "source": "txr_torch/csrc/conv3x3.cu",
            "replaces": "txr/ops/conv_stripe.py:45",
            "shape": mid["shape"], "shape_site": "fusion_0 (the other two "
            "shapes of the path are under by_shape)",
            "max_abs_err": max(r["max_abs_err"] for r in by_shape),
            "ms": mid["ms"], "ms_spread": mid["ms_spread"],
            "plain_ms": mid["plain_ms"],
            "bound_ms": mid["bound_ms"], "bound_by": mid["bound_by"],
            "library_ms": mid["library_ms"],
            "library_ms_spread": mid["library_ms_spread"],
            "library_call": "F.conv2d on channels_last bf16 (F.relu in "
                            "front where relu_in)",
            "step_ms": step_ms, "step_library_ms": step_library_ms,
            "step_bound_ms": step_bound_ms,
            "no_slower_than_library": all(
                r["ms"] <= r["library_ms"] for r in by_shape),
            "within_twice_its_bound": step_ms <= 2 * step_bound_ms,
            "tflops": mid["tflops"], "by_shape": by_shape,
            "smem_bytes": geo["smem_bytes"]}


def check_attention_bhsd(batch: int, gen: torch.Generator) -> dict:
    in_h, in_w = compute_da_resize(H, W, 518)
    s = (in_h // 14) * (in_w // 14) + 1
    h, d = ODD_HEADS, HEAD_DIM
    qkv = attention_qkv(gen, batch, s, h)
    q, k, v = split_heads(qkv, h, d)          # strided views, no copy
    if q.is_contiguous():
        raise AssertionError("the head views should not be contiguous")

    err = compare("attention_bhsd", f"main B={batch} H={h} S={s} views",
                  attention_flash(q, k, v), attention_plain(q, k, v),
                  **ATTN_TOL)["max_abs_err"]
    require_repeatable("attention_bhsd", lambda: attention_flash(q, k, v))
    fq, fk, fv = split_heads(attention_qkv(
        torch.Generator(device="cuda").manual_seed(25), batch, s, h,
        q_std=0.1), h, d)
    compare("attention_bhsd", f"flat softmax (q std 0.1) B={batch} H={h} "
            f"S={s} views", attention_flash(fq, fk, fv),
            attention_plain(fq, fk, fv), **ATTN_TOL)
    del fq, fk, fv
    for kv in (1, 64, 1984, 2000):
        compare("attention_bhsd", f"kv_len={kv} B=2 H={h} S={s}",
                attention_flash(q[:2], k[:2], v[:2], kv),
                attention_plain(q[:2], k[:2], v[:2], kv), **ATTN_TOL)
        require_masked_keys_weigh_nothing(
            "attention_bhsd",
            lambda x: attention_flash(*split_heads(x, h, d), kv),
            qkv[:2].contiguous(), h, kv)
    compare("attention_bhsd", "S=77 B=1 contiguous",
            attention_flash(*(t[:1, :, :77].contiguous() for t in (q, k, v))),
            attention_plain(q[:1, :, :77], k[:1, :, :77], v[:1, :, :77]),
            **ATTN_TOL)
    # two more stride patterns beside the views of the fused projection:
    # contiguous (B, H, S, D) operands, and windows of a longer
    # (B, H, S + 40, D) buffer (row stride D, head stride not S * D) with a
    # key/value buffer of another length than the query's
    want2 = attention_plain(q[:2], k[:2], v[:2])
    compare("attention_bhsd", f"contiguous (B, H, S, D) B=2 H={h} S={s}",
            attention_flash(*(t[:2].contiguous() for t in (q, k, v))), want2,
            **ATTN_TOL)

    def window(t, pad, at):
        buf = torch.zeros((2, h, s + pad, d), dtype=t.dtype, device="cuda")
        buf[:, :, at:at + s] = t[:2]
        return buf[:, :, at:at + s]

    wq, wk, wv = window(q, 40, 8), window(k, 24, 16), window(v, 24, 0)
    if wq.is_contiguous() or wq.stride() == wk.stride():
        raise AssertionError("the windows should differ in their strides")
    compare("attention_bhsd", f"windows of longer buffers B=2 H={h} S={s}",
            attention_flash(wq, wk, wv), want2, **ATTN_TOL)
    del want2, wq, wk, wv

    plain_ms = time_ms(lambda: attention_plain(q, k, v), runs=3)
    spread = time_spread({
        "kernel": lambda: attention_flash(q, k, v),
        "library": lambda: F.scaled_dot_product_attention(q, k, v)})
    ms = spread["kernel"]["median"]
    flops = 4.0 * batch * h * s * s * d
    nbytes = 2.0 * batch * s * 4 * h * d
    full = bound(flops, PEAK_BF16_FLOPS, nbytes)
    return {"name": "attention_bhsd", "route": "cuda",
            "source": "txr_torch/csrc/attention.cu",
            "replaces": "txr/ops/attention.py:49",
            "shape": [batch, h, s, d], "max_abs_err": err, "ms": ms,
            "ms_spread": spread["kernel"],
            "plain_ms": plain_ms, **full,
            "library_ms": spread["library"]["median"],
            "library_ms_spread": spread["library"],
            "library_call": "F.scaled_dot_product_attention",
            "tflops": flops / ms / 1e9,
            "no_slower_than_library": ms <= spread["library"]["median"],
            "within_twice_its_bound": ms <= 2 * full["bound_ms"]}


# ------------------------------------------------------------ QK-norm / RoPE

# least share of q and k that the qk_prep kernel gives bit-equal to its
# plain version: only the LayerNorm's sums are taken in another order
QK_PREP_BIT_EQUAL = 0.99


def bf16_ordered(x: torch.Tensor) -> torch.Tensor:
    """bf16 bit patterns as int32 in the order of their values: neighbouring
    values differ by 1 (+0 and -0 are both 0)."""
    i = x.view(torch.int16).to(torch.int32) & 0xFFFF
    return torch.where(i >= 0x8000, 0x8000 - i, i)


def rope_term_scale(qkv: torch.Tensor, heads: int, q_norm, k_norm,
                    tables) -> torch.Tensor:
    """|x cos| + |rot(x) sin| for q and k, (B, S, 2*H*D) float32, with x
    their float32 LayerNorm: the size of the two terms whose sum the
    rotation rounds. Where they cancel, the sum's own ulp is far below the
    rounding error of either term."""
    b, s, _ = qkv.shape
    q, k, _ = qkv.view(b, s, 3, heads, -1).unbind(2)
    cos, sin = tables
    out = []
    for x, ln in ((q, q_norm), (k, k_norm)):
        x = F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(),
                         ln.bias.float(), ln.eps)
        swapped = x.unflatten(-1, (2, 2, -1)).flip(-2).flatten(-3)
        out.append(x.abs() * cos.abs() + swapped.abs() * sin.abs())
    return torch.stack(out, dim=2).view(b, s, -1)


def compare_qk_prep(case: str, got: torch.Tensor, want: torch.Tensor,
                    qkv: torch.Tensor, heads: int, q_norm, k_norm,
                    tables) -> dict:
    """Emit one kernel_check line for the qk_prep kernel's (B, S, 3*H*64)
    result against its plain version's on the input ``qkv``; raise unless v
    is bit-equal, at least QK_PREP_BIT_EQUAL of q and k are bit-equal, and
    every value of q and k lies within one bf16 ulp of the rotation's terms
    (``rope_term_scale``). The line also gives the largest difference in
    ulps of the value itself and the share beyond one: values where the
    terms cancel."""
    torch.cuda.synchronize()
    c = heads * QK_HEAD_DIM
    v_equal = torch.equal(got[..., 2 * c:], want[..., 2 * c:])
    g, w = got[..., :2 * c], want[..., :2 * c]
    own = (bf16_ordered(g) - bf16_ordered(w)).abs()
    worst_own = int(own.max().item())
    share = (own == 0).float().mean().item()
    beyond = (own > 1).float().mean().item()
    del own
    _, exp = torch.frexp(rope_term_scale(qkv, heads, q_norm, k_norm,
                                         tables))
    term_ulps = (g.float() - w.float()).abs() / torch.exp2(
        (exp - 8).float())
    worst = term_ulps.max().item()
    del term_ulps, exp
    ok = v_equal and worst <= 1 and share >= QK_PREP_BIT_EQUAL
    line = {"phase": "kernel_check", "kernel": "qk_prep", "case": case,
            "shape": list(got.shape), "v_bit_equal": v_equal,
            "bit_equal_share": share,
            "least_bit_equal_share": QK_PREP_BIT_EQUAL,
            "max_ulps_of_terms": worst, "max_ulps": worst_own,
            "share_beyond_one_ulp": beyond, "ok": ok}
    emit(line)
    if not ok:
        raise AssertionError(f"qk_prep/{case}: v bit-equal {v_equal}, "
                             f"{share} bit-equal, {worst} ulps of the "
                             f"rotation's terms at most")
    return line


def qk_prep_operands(b: int, s: int, heads: int, grid: tuple,
                     gen: torch.Generator) -> tuple:
    """A seeded bf16 qkv (values of mean 0.5 and std 2), bf16 q_norm and
    k_norm, and the rope tables of ``grid`` (1 + rows * cols = s)."""
    qkv = (torch.randn((b, s, 3 * heads * QK_HEAD_DIM), generator=gen,
                       device="cuda") * 2.0 + 0.5).to(torch.bfloat16)
    norms = []
    for _ in range(2):
        ln = torch.nn.LayerNorm(QK_HEAD_DIM, eps=1e-6, device="cuda",
                                dtype=torch.bfloat16)
        with torch.no_grad():
            ln.weight.copy_(torch.randn((QK_HEAD_DIM,), generator=gen,
                                        device="cuda") * 0.3 + 1.0)
            ln.bias.copy_(torch.randn((QK_HEAD_DIM,), generator=gen,
                                      device="cuda") * 0.1)
        norms.append(ln)
    return (qkv, heads, *norms,
            rope_tables(*grid, QK_HEAD_DIM, 100.0, "cuda"))


@torch.no_grad()
def check_qk_prep(batch: int, gen: torch.Generator) -> dict:
    """The qk_prep kernel against its plain version at DA3's 16-view step
    (16, 2443, 3072), at an odd B x S and at five heads with a ragged last
    block; then timed in place against the plain chain."""
    require_geometry("qk_prep", kernels.lib().txr_qk_prep_geometry,
                     (QK_HEAD_DIM, QK_THREADS, QK_ROWS_PER_BLOCK,
                      QK_THREADS // QK_ROWS_PER_BLOCK))
    for b, s, heads, grid in ((DA3_VIEWS, 2443, HEADS, (37, 66)),
                              (3, 1001, HEADS, (40, 25)),
                              (2, 37, 5, (6, 6))):
        qkv, *rest = qk_prep_operands(b, s, heads, grid, gen)
        want = qk_prep_plain(qkv, *rest)
        got = qk_prep(qkv.clone(), *rest)
        compare_qk_prep(f"B={b} S={s} heads={heads}", got, want, qkv,
                        *rest)
        require_repeatable("qk_prep", lambda: qk_prep(qkv.clone(), *rest))
        del qkv, want, got
    args = qk_prep_operands(DA3_VIEWS, 2443, HEADS, (37, 66), gen)
    b, s, width = args[0].shape
    # in place over and over: each call renormalises the last one's values;
    # "device" launches without the wrapper's checks on the host, which at
    # about 0.1 ms a call would otherwise set the pace
    spread = time_spread({"kernel": lambda: qk_prep(*args),
                          "device": lambda: qk_prep_launch(*args),
                          "plain": lambda: qk_prep_plain(*args)}, runs=10)
    ms = spread["device"]["median"]
    nbytes = 2 * (2 * b * s * width // 3) * 2 + 2 * s * QK_HEAD_DIM * 4
    return {"name": "qk_prep", "route": "cuda",
            "source": "txr_torch/csrc/qk_prep.cu",
            "replaces": None, "shape": [b, s, width],
            "ms": spread["kernel"]["median"], "ms_spread": spread["kernel"],
            "device_ms": ms, "device_ms_spread": spread["device"],
            "plain_ms": spread["plain"]["median"],
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": None, "gbytes_per_s": nbytes / ms / 1e6,
            "geometry": require_qk_prep_operands(*args)}


# The cached entry point at StreamVGGT's shapes: a chunk of 32 frames of 782
# tokens against the cache of 0 to 3 chunks before it
STREAM_FRAME_TOKENS = 782
STREAM_CHUNK = 32
STREAM_CHUNKS = 4


def cached_operands(gen: torch.Generator, s: int, cached: int, heads: int,
                    q_std: float = 3.0) -> tuple:
    """A chunk's bf16 qkv (1, s, 3 * heads * 64), as ``attention_qkv``
    draws it, and a cache of ``cached + s`` rows and 64 more (rows of k
    then v, 2 * heads * 64): random earlier rows, then the chunk's k and
    v, then rows past the keys the launch reads."""
    qkv = attention_qkv(gen, 1, s, heads, q_std)
    hd = heads * HEAD_DIM
    kv = torch.randn((cached + s + 64, 2 * hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    kv[cached:cached + s] = qkv[0, :, hd:]
    return qkv, kv


def cached_reference(qkv: torch.Tensor, kv: torch.Tensor, heads: int,
                     cached: int, frame_tokens: int, rows: int = 512
                     ) -> torch.Tensor:
    """``attention_plain`` (float32 products) of each block of query rows
    of one frame against the keys up to that frame's end: the cached entry
    point's mask as a key count, with no mask of its own."""
    s = qkv.shape[1]
    length = cached + s
    q = split_heads(qkv, heads, HEAD_DIM)[0]
    k, v = (kv[:length].view(1, length, 2, heads, HEAD_DIM)[:, :, i]
            .transpose(1, 2) for i in range(2))
    out = torch.empty((1, heads, s, HEAD_DIM), dtype=qkv.dtype,
                      device=qkv.device)
    for f0 in range(0, s, frame_tokens):
        end = min(s, f0 + frame_tokens)
        for i in range(f0, end, rows):
            j = min(end, i + rows)
            out[:, :, i:j] = attention_plain(q[:, :, i:j],
                                             k[:, :, :cached + end],
                                             v[:, :, :cached + end])
    return out.transpose(1, 2).reshape(1, s, heads * HEAD_DIM)


def cached_flops(s: int, cached: int, frame_tokens: int, heads: int
                 ) -> float:
    """Products of one launch under the mask: 4 D a kept query-key pair,
    every head."""
    plan = cached_kernel_plan(s, cached + s, cached, frame_tokens)
    return 4.0 * heads * HEAD_DIM * plan["pairs"]


@torch.no_grad()
def check_cached_attention(batch: int, gen: torch.Generator) -> dict:
    """The cached entry point against ``cached_reference`` in float32: at
    StreamVGGT's shapes (25,024 queries against 25,024 to 100,096 keys),
    peaked and flat; with an empty cache, frames of 77 and of 1 token
    (causal), a frame of 129 tokens and caches of 333 and 1000 rows (key
    counts of no multiple of 128); the keys past each row's limit and past
    the launch's rows of no weight, bit for bit; repeated bit for bit;
    then timed at the four chunks of a submap."""
    s = STREAM_CHUNK * STREAM_FRAME_TOKENS
    own = torch.Generator(device="cuda").manual_seed(26)
    timed = {}
    for c in range(STREAM_CHUNKS):
        cached = c * s
        for label, q_std in (("flat", 0.1), ("peaked", 3.0)):
            qkv, kv = cached_operands(own, s, cached, HEADS, q_std)
            compare("attention_cached", f"{label} S={s} cached={cached} "
                    f"frame={STREAM_FRAME_TOKENS}",
                    cached_attention(qkv, kv, HEADS, HEAD_DIM, cached,
                                     STREAM_FRAME_TOKENS),
                    cached_reference(qkv, kv, HEADS, cached,
                                     STREAM_FRAME_TOKENS), **ATTN_TOL)
            torch.cuda.empty_cache()
        timed[c] = (qkv, kv)
    for s_small, cached, frame in ((385, 0, 77), (300, 0, 1),
                                   (387, 333, 129), (387, 1000, 129),
                                   (77, 0, 77), (2 * 782, 782, 782)):
        qkv, kv = cached_operands(gen, s_small, cached, HEADS)
        run = lambda x, y: cached_attention(x, y, HEADS, HEAD_DIM, cached,
                                            frame)
        got = run(qkv, kv)
        compare("attention_cached",
                f"S={s_small} cached={cached} frame={frame}", got,
                cached_reference(qkv, kv, HEADS, cached, frame), **ATTN_TOL)
        # rows past the launch's keys, and each query frame's later
        # frames in the chunk, weigh nothing: the first frame's rows stay
        # bit for bit with k 64 and v 2^120 there
        junk = kv.clone()
        hd = HEADS * HEAD_DIM
        junk[cached + frame:, :hd] = 64.0
        junk[cached + frame:, hd:] = 2.0 ** 120
        kept = run(qkv, junk)[:, :frame]
        if not torch.equal(kept, got[:, :frame]):
            raise AssertionError(f"attention_cached: S={s_small} cached="
                                 f"{cached} frame={frame}: keys past the "
                                 f"first frame moved its rows")
        emit({"phase": "kernel_check", "kernel": "attention_cached",
              "case": f"S={s_small} cached={cached} frame={frame}: keys "
                      f"past the first frame of k 64 and v 2^120 leave its "
                      f"rows bit-equal", "ok": True})
        require_repeatable("attention_cached", lambda: run(qkv, kv))
    spread = time_spread(
        {c: (lambda x=x, c=c: cached_attention(
            x[0], x[1], HEADS, HEAD_DIM, c * s, STREAM_FRAME_TOKENS))
         for c, x in timed.items()}, runs=6, warmup=1, inner=3)
    chunks = {}
    for c, t in spread.items():
        cached = c * s
        ops = cached_flops(s, cached, STREAM_FRAME_TOKENS, HEADS)
        plan = cached_kernel_plan(s, cached + s, cached,
                                  STREAM_FRAME_TOKENS)
        nbytes = 2.0 * s * HEADS * HEAD_DIM * 2 + 2.0 * (cached + s) * 2 * \
            HEADS * HEAD_DIM
        chunks[f"chunk {c}: (1, {s}) against {cached + s} keys"] = {
            "ms": t["median"], "ms_spread": t,
            **bound(ops, PEAK_BF16_FLOPS, nbytes),
            "tflops": ops / t["median"] / 1e9,
            "tile_pairs_over_pairs": plan["tile_pairs"] / plan["pairs"]}
    del timed
    last = spread[STREAM_CHUNKS - 1]["median"]
    ops = cached_flops(s, (STREAM_CHUNKS - 1) * s, STREAM_FRAME_TOKENS,
                       HEADS)
    full = bound(ops, PEAK_BF16_FLOPS, 2.0 * 4 * s * HEADS * HEAD_DIM * 2)
    return {"name": "attention_cached", "route": "cuda",
            "source": "txr_torch/csrc/attention.cu",
            "replaces": None, "shape": [1, s, 3 * HEADS * HEAD_DIM],
            "ms": last, **full, "tflops": ops / last / 1e9,
            "plain_ms": None, "library_ms": None, "chunks": chunks}


# The residual kernel's shapes: the cells' steps (DA2's 8 frames, VGGT's 32
# views, DA3's 16 views of 1024 wide tokens, with their LayerNorm eps), the
# other widths of the port's blocks (ViT-S, ViT-B, ViT-G, VGGT's camera
# trunk) and ragged row counts (a block holds 4 rows)
RN_CELLS = ((8 * 2443, 1e-6), (32 * 782, 1e-5), (16 * 2443, 1e-6))
RN_WIDTHS = ((1001, 384), (1001, 768), (1001, 1536), (37, 2048))
RN_RAGGED = (1, 3, 5, 4097)
RN_F32_TOL = dict(
    atol=2.0 ** -17, rtol=2.0 ** -17,
    why="h in float32 (a float32 model; bf16 autocast): the kernel's two "
        "passes over its registers sum in another order than PyTorch's "
        "Welford kernel, a few float32 ulps of the normalised value")


def residual_norm_operands(rows: int, width: int, gen: torch.Generator,
                           dtypes=(torch.bfloat16,) * 3, eps: float = 1e-6
                           ) -> tuple:
    """Seeded x (std 2, mean 0.5), branch (std 1), LayerScale gamma in
    [0.01, 2) and a LayerNorm (weight about 1, bias about 0) of the given
    (x, branch, parameter) dtypes."""
    xd, bd, pd = dtypes
    x = (torch.randn((rows, width), generator=gen, device="cuda") * 2.0
         + 0.5).to(xd)
    branch = torch.randn((rows, width), generator=gen, device="cuda").to(bd)
    gamma = (torch.rand((width,), generator=gen, device="cuda") * 1.99
             + 0.01).to(pd)
    ln = torch.nn.LayerNorm(width, eps=eps, device="cuda", dtype=pd)
    with torch.no_grad():
        ln.weight.copy_(torch.randn((width,), generator=gen, device="cuda")
                        * 0.3 + 1.0)
        ln.bias.copy_(torch.randn((width,), generator=gen, device="cuda")
                      * 0.1)
    return x, branch, gamma, ln


def norm_term_scale(out: torch.Tensor, ln) -> torch.Tensor:
    """|w n| + |b| in float32, n the normalised x': the size of the two
    terms whose sum h rounds. Where they cancel, h's own ulp is far below
    the rounding error of either term."""
    n = F.layer_norm(out.float(), out.shape[-1:], eps=ln.eps)
    return (n * ln.weight.float()).abs() + ln.bias.float().abs()


def compare_residual_norm(case: str, got: tuple, want: tuple, ln) -> dict:
    """One kernel_check line: x' bit for bit; h bf16 within one bf16 ulp of
    the LayerNorm's terms (``norm_term_scale``) of the plain version's, the
    bit-equal share, the largest difference in ulps of the value itself and
    the share beyond one reported; or float32 within RN_F32_TOL. Raises
    otherwise."""
    torch.cuda.synchronize()
    (out, h), (out_w, h_w) = got, want
    if out.dtype != out_w.dtype or h.dtype != h_w.dtype:
        raise AssertionError(f"residual_norm/{case}: dtypes {out.dtype} "
                             f"{h.dtype}, plain {out_w.dtype} {h_w.dtype}")
    out_equal = torch.equal(out, out_w)
    if not torch.isfinite(h).all():
        raise AssertionError(f"residual_norm/{case}: h is not finite")
    line = {"phase": "kernel_check", "kernel": "residual_norm",
            "case": case, "shape": list(out.shape),
            "dtypes": [str(out.dtype), str(h.dtype)],
            "x_out_bit_equal": out_equal,
            "h_bit_equal_share": (h == h_w).sum().item() / h.numel()}
    if h.dtype == torch.bfloat16:
        own = (bf16_ordered(h) - bf16_ordered(h_w)).abs()
        line["h_max_ulps"] = int(own.max().item())
        line["h_share_beyond_one_ulp"] = (own > 1).sum().item() / h.numel()
        del own
        _, exp = torch.frexp(norm_term_scale(out_w, ln))
        term_ulps = (h.float() - h_w.float()).abs() / torch.exp2(
            (exp - 8).float())
        line["h_max_ulps_of_terms"] = term_ulps.max().item()
        del term_ulps, exp
        ok = line["h_max_ulps_of_terms"] <= 1
    else:
        err = (h - h_w).abs()
        worst = (err - (RN_F32_TOL["atol"] + RN_F32_TOL["rtol"]
                        * h_w.abs())).max().item()
        line.update(h_max_abs_err=err.max().item(), least_margin=-worst,
                    atol=RN_F32_TOL["atol"], rtol=RN_F32_TOL["rtol"],
                    tolerance_reason=RN_F32_TOL["why"])
        ok = worst <= 0
    line["ok"] = ok = ok and out_equal
    emit(line)
    if not ok:
        raise AssertionError(f"residual_norm/{case}: {line}")
    return line


def check_residual_norm_grads(gen: torch.Generator) -> None:
    """Under bf16 autocast from float32 master parameters, as a train step
    runs: the autograd Function's gradients of x, branch, gamma, weight and
    bias equal the plain composition's bit for bit (its backward is the
    plain version's)."""
    x, branch, gamma, ln = residual_norm_operands(
        1001, 1024, gen, (torch.float32, torch.bfloat16, torch.float32))
    leaves = [t.detach().requires_grad_() for t in (x, branch, gamma)]
    gout = torch.randn(x.shape, generator=gen, device="cuda")
    gh = torch.randn(x.shape, generator=gen, device="cuda")
    grads = []
    for fn in (residual_norm, residual_norm_plain):
        for t in (*leaves, ln.weight, ln.bias):
            t.grad = None
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out, h = fn(*leaves, ln)
        torch.autograd.backward((out, h), (gout.to(out.dtype),
                                           gh.to(h.dtype)))
        grads.append([t.grad.clone() for t in (*leaves, ln.weight, ln.bias)])
    equal = [torch.equal(a, b) for a, b in zip(*grads)]
    emit({"phase": "kernel_check", "kernel": "residual_norm",
          "case": "autocast autograd: gradients of x, branch, gamma, weight, "
                  "bias against the plain composition's",
          "bit_equal": equal, "ok": all(equal)})
    if not all(equal):
        raise AssertionError(f"residual_norm gradients: {equal}")


@torch.no_grad()
def check_residual_norm(batch: int, gen: torch.Generator) -> dict:
    """The residual kernel against its plain version: at the cells' steps,
    at the other widths of the port's blocks, on ragged row counts and in
    the dtypes of a float32 model and of bf16 autocast; x' bit for bit, h
    within one bf16 ulp of the LayerNorm's terms
    (``compare_residual_norm``); repeated bit for bit; the autograd route's
    gradients; then timed, with and without the norm, against the plain
    version's three launches and the bytes' bound."""
    require_geometry("residual_norm", kernels.lib().txr_residual_norm_geometry,
                     (RN_THREADS, RN_ROWS_PER_BLOCK, RN_VEC, RN_MAX_WIDTH))
    cases = [(rows, 1024, eps) for rows, eps in RN_CELLS]
    cases += [(rows, width, 1e-6) for rows, width in RN_WIDTHS]
    cases += [(rows, 1024, 1e-5) for rows in RN_RAGGED]
    for rows, width, eps in cases:
        x, branch, gamma, ln = residual_norm_operands(rows, width, gen,
                                                      eps=eps)
        compare_residual_norm(f"rows={rows} d={width} eps={eps}",
                              residual_norm(x, branch, gamma, ln),
                              residual_norm_plain(x, branch, gamma, ln), ln)
        alone = residual_norm(x, branch, gamma)
        if not torch.equal(alone, x + branch * gamma):
            raise AssertionError(f"residual_norm: rows={rows} d={width}: x' "
                                 f"without the norm is not bit-equal")
        require_repeatable("residual_norm", lambda: torch.cat(
            residual_norm(x, branch, gamma, ln)))
        del x, branch, gamma, ln, alone
    f32, bf16 = torch.float32, torch.bfloat16
    for dtypes, autocast in (((f32, f32, f32), False),
                             ((bf16, bf16, f32), True),
                             ((f32, bf16, f32), True),
                             ((bf16, bf16, bf16), True)):
        x, branch, gamma, ln = residual_norm_operands(1001, 1024, gen,
                                                      dtypes)
        with torch.autocast("cuda", dtype=bf16, enabled=autocast):
            compare_residual_norm(
                f"rows=1001 d=1024 x, branch, params "
                f"{[str(d) for d in dtypes]} autocast={autocast}",
                residual_norm(x, branch, gamma, ln),
                residual_norm_plain(x, branch, gamma, ln), ln)
    with torch.enable_grad():
        check_residual_norm_grads(gen)

    shapes = {}
    for (rows, eps), cell in zip(RN_CELLS, ("DA2", "VGGT", "DA3")):
        args = residual_norm_operands(rows, 1024, gen, eps=eps)
        x, branch, gamma, ln = args
        plan = require_residual_norm_operands(*args)
        plan1 = require_residual_norm_operands(x, branch, gamma)
        if cell == "DA2":
            geometry = {k: v for k, v in plan.items()
                        if not isinstance(v, torch.dtype)}
        w, b = ln.weight, ln.bias
        copy = torch.empty_like(x)          # a copy of x: 2 A, the card's pace
        # host-paced (``ms``: the wrapper, as the model calls it) and not
        # (``device_ms``)
        spread = time_spread({
            "kernel": lambda: residual_norm(*args),
            "kernel_no_norm": lambda: residual_norm(x, branch, gamma)},
            runs=10)
        spread.update(time_queued({
            "device": lambda: residual_norm_launch(x, branch, gamma, w, b,
                                                   eps, plan),
            "plain": lambda: residual_norm_plain(*args),
            "device_no_norm": lambda: residual_norm_launch(
                x, branch, gamma, None, None, 0.0, plan1),
            "plain_no_norm": lambda: residual_norm_plain(x, branch, gamma),
            "copy": lambda: copy.copy_(x)}))
        a = rows * 1024 * 2
        shapes[f"{cell} ({rows}, 1024)"] = {
            "device_ms": spread["device"]["median"],
            "ms": spread["kernel"]["median"],
            "plain_ms": spread["plain"]["median"],
            "bound_ms": 4 * a / PEAK_BYTES * 1e3,
            "device_ms_no_norm": spread["device_no_norm"]["median"],
            "ms_no_norm": spread["kernel_no_norm"]["median"],
            "plain_ms_no_norm": spread["plain_no_norm"]["median"],
            "bound_ms_no_norm": 3 * a / PEAK_BYTES * 1e3,
            "tb_per_s": 4 * a / spread["device"]["median"] / 1e9,
            "tb_per_s_no_norm":
                3 * a / spread["device_no_norm"]["median"] / 1e9,
            "copy_ms": spread["copy"]["median"],
            "spread": spread}
        del args, x, branch, gamma, ln, copy
    # the host's share: at 64 rows the card finishes each launch before the
    # next is enqueued, so a call's time is its host work
    args = residual_norm_operands(64, 1024, gen)
    host = time_spread({"kernel": lambda: residual_norm(*args),
                        "plain": lambda: residual_norm_plain(*args)},
                       runs=10, inner=50)
    da2 = shapes[f"DA2 ({RN_CELLS[0][0]}, 1024)"]
    return {"name": "residual_norm", "route": "cuda",
            "source": "txr_torch/csrc/residual_norm.cu",
            "replaces": None, "shape": [RN_CELLS[0][0], 1024],
            "ms": da2["ms"], "device_ms": da2["device_ms"],
            "plain_ms": da2["plain_ms"], "bound_ms": da2["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "gbytes_per_s": da2["tb_per_s"] * 1e3,
            "host_ms_a_call_at_64_rows": {k: v["median"]
                                          for k, v in host.items()},
            "shapes": shapes, "geometry": geometry}


# The upsample kernel's shapes: each cell's fusion blocks, (frames,
# channels, input grid, output grid), align_corners=True: DA2's four at 8
# frames of 518 x 924 (DA3's are the same grids at 16 views), VGGT's four
# at 32 views of 294 x 518 (StreamVGGT's chunks of 32 the same); the
# unfused tail's resize to the frame (the plain routes, a float32 model)
UP_CELLS = (
    ("DA2 fusion_3", 8, 256, (19, 33), (37, 66)),
    ("DA2 fusion_2", 8, 256, (37, 66), (74, 132)),
    ("DA2 fusion_1", 8, 256, (74, 132), (148, 264)),
    ("DA2 fusion_0", 8, 256, (148, 264), (296, 528)),
    ("DA3 fusion_0", 16, 256, (148, 264), (296, 528)),
    ("VGGT fusion_3", 32, 256, (11, 19), (21, 37)),
    ("VGGT fusion_2", 32, 256, (21, 37), (42, 74)),
    ("VGGT fusion_1", 32, 256, (42, 74), (84, 148)),
    ("VGGT fusion_0", 32, 256, (84, 148), (168, 296)),
    ("DA2 unfused tail", 8, 128, (296, 528), (518, 924)))
# the residual resize (align_corners=False, a residual of another grid
# than the block's input) and ragged cases: channel counts that no 16-byte
# chunk divides, odd grids up and down, one pixel, equal grids (a copy)
UP_RAGGED = (
    (8, 256, (38, 67), (37, 66)), (2, 3, (5, 7), (11, 13)),
    (2, 12, (17, 9), (8, 20)), (3, 100, (13, 11), (29, 5)),
    (2, 6, (1, 1), (4, 5)), (2, 40, (7, 9), (1, 1)),
    (2, 64, (9, 10), (9, 10)), (1, 264, (33, 31), (64, 3)))
# the timed shapes: DA2's largest block and the cells' others
UP_TIMED = ("DA2 fusion_0", "DA2 fusion_1", "DA3 fusion_0", "VGGT fusion_0",
            "VGGT fusion_1", "DA2 unfused tail")


def upsample_operand(n: int, c: int, hw: tuple, gen: torch.Generator,
                     dtype=torch.bfloat16, offset: int = 0) -> torch.Tensor:
    """A seeded (n, c, h, w) map of std 2 in channels_last memory, its
    storage ``offset`` values past an allocation (a misaligned view)."""
    h, w = hw
    flat = torch.randn((n * h * w * c + offset,), generator=gen,
                       device="cuda").mul_(2.0).to(dtype)
    return flat[offset:].view(n, h, w, c).permute(0, 3, 1, 2)


def ordered_bits(x: torch.Tensor) -> torch.Tensor:
    """bf16 or float32 bit patterns as int64 in the order of their values:
    neighbouring values differ by 1."""
    if x.dtype == torch.bfloat16:
        return bf16_ordered(x).to(torch.int64)
    i = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(i >= 0x80000000, 0x80000000 - i, i)


# PyTorch resizes a channels_last map of at least this many channels with
# its channels-last kernel, a narrower one with its NCHW kernel
UP_NHWC_MIN_CHANNELS = 16


def interpolate_channels_last(x: torch.Tensor, size: tuple,
                              align: bool) -> torch.Tensor:
    """``F.interpolate`` through PyTorch's channels-last kernel, the one
    the kernel reproduces: a map of fewer than UP_NHWC_MIN_CHANNELS
    channels is padded with zero channels and cut back (each channel is
    resized alone). PyTorch's NCHW kernel, which it takes below that
    width, is contracted into other FMAs by nvcc in float32
    (``check_upsample`` reports how far the two lie apart)."""
    n, c, h, w = x.shape
    if c >= UP_NHWC_MIN_CHANNELS:
        return upsample_bilinear_plain(x, size, align)
    pad = torch.zeros((n, h, w, UP_NHWC_MIN_CHANNELS), dtype=x.dtype,
                      device=x.device).permute(0, 3, 1, 2)
    pad[:, :c] = x
    return upsample_bilinear_plain(pad, size, align)[:, :c].contiguous(
        memory_format=torch.channels_last)


def compare_upsample(case: str, got: torch.Tensor, want: torch.Tensor,
                     x: torch.Tensor, size: tuple, align: bool) -> dict:
    """One kernel_check line: the kernel's resize of ``x`` against
    ``F.interpolate``'s (``interpolate_channels_last``) in shape, dtype
    and memory format, the bit-equal share, the largest difference in ulps
    of the value and in ulps of its terms: the resize of |x|, the size of the four weighted taps whose sum
    is rounded (where they cancel, the value's own ulp is far below the
    rounding error of any of them). Raises beyond one ulp of the terms:
    the kernel takes the FMAs of PyTorch's build, so it reads bit-equal,
    and only a contraction other than PyTorch's would move it."""
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"upsample/{case}: {tuple(got.shape)} "
                             f"{got.dtype} against {tuple(want.shape)} "
                             f"{want.dtype}")
    ulps = (ordered_bits(got) - ordered_bits(want)).abs()
    line = {"phase": "kernel_check", "kernel": "upsample", "case": case,
            "shape": list(got.shape), "dtype": str(got.dtype),
            "channels_last": got.is_contiguous(
                memory_format=torch.channels_last),
            "bit_equal_share": (ulps == 0).sum().item() / got.numel(),
            "max_ulps": int(ulps.max().item())}
    del ulps
    terms = interpolate_channels_last(x.float().abs(), size, align)
    _, exp = torch.frexp(terms)
    bits = 8 if got.dtype == torch.bfloat16 else 24
    term_ulps = (got.float() - want.float()).abs() / torch.exp2(
        (exp - bits).float())
    line["max_ulps_of_terms"] = term_ulps.max().item()
    del terms, exp, term_ulps
    line["ok"] = ok = (line["max_ulps_of_terms"] <= 1
                       and line["channels_last"])
    emit(line)
    if not ok:
        raise AssertionError(f"upsample/{case}: {line}")
    return line


def check_upsample_grads(gen: torch.Generator) -> None:
    """Under bf16 autocast, as a train step runs the head: the autograd
    Function's float32 output against ``F.interpolate``'s
    (``compare_upsample``), and x's bf16 gradient (its backward is the
    plain version's) within one bf16 ulp of its terms (the gradient of the
    resize against |cotangent|) of the plain route's: PyTorch's backward
    sums into its float32 gradient with atomics, in an order that changes
    from call to call, and where the sums cancel that moves the value by
    more than its own ulp."""
    cot = torch.randn((2, 64, 42, 74), generator=gen, device="cuda")
    for align in (True, False):
        x = upsample_operand(2, 64, (21, 37), gen)
        runs = []
        for fn in (upsample_bilinear, upsample_bilinear_plain):
            leaf = x.detach().requires_grad_()
            with torch.autocast("cuda", dtype=torch.bfloat16):
                out = fn(leaf, (42, 74), align)
            out.backward(cot.to(out.dtype))
            runs.append((out.detach(), leaf.grad))
        (out_k, g_k), (out_p, g_p) = runs
        compare_upsample(f"autocast autograd, align_corners={align}: the "
                         f"output", out_k, out_p, x, (42, 74), align)
        leaf = x.detach().float().requires_grad_()
        terms, = torch.autograd.grad(
            upsample_bilinear_plain(leaf, (42, 74), align), leaf, cot.abs())
        _, exp = torch.frexp(terms)
        term_ulps = (g_k.float() - g_p.float()).abs() / torch.exp2(
            (exp - 8).float())
        line = {"phase": "kernel_check", "kernel": "upsample",
                "case": f"autocast autograd, align_corners={align}: x's "
                        f"{g_k.dtype} gradient against F.interpolate's",
                "grad_bit_equal_share": (g_k == g_p).sum().item()
                / g_k.numel(),
                "grad_max_ulps_of_terms": term_ulps.max().item()}
        line["ok"] = line["grad_max_ulps_of_terms"] <= 1
        emit(line)
        if not line["ok"]:
            raise AssertionError(f"upsample gradients: {line}")


def check_upsample_graph(gen: torch.Generator) -> None:
    """The kernel captured in a CUDA graph and replayed on new input, as
    the fused stream's graphs run it: the replay equals an eager call."""
    x = upsample_operand(4, 256, (21, 37), gen)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        upsample_bilinear(x, (42, 74), True)          # warm-up
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = kernels.launches["upsample"]
    with torch.cuda.graph(graph):
        out = upsample_bilinear(x, (42, 74), True)
    x.copy_(upsample_operand(4, 256, (21, 37), gen))
    graph.replay()
    equal = torch.equal(out, upsample_bilinear_plain(x, (42, 74), True))
    emit({"phase": "kernel_check", "kernel": "upsample",
          "case": "CUDA graph: captured, replayed on new input, against "
                  "F.interpolate", "launches_captured":
          kernels.launches["upsample"] - before, "bit_equal": equal,
          "ok": equal})
    if not equal:
        raise AssertionError("upsample: the graph's replay differs")


@torch.no_grad()
def check_upsample(batch: int, gen: torch.Generator) -> dict:
    """The upsample kernel against ``F.interpolate`` on the card: at each
    cell's fusion-block shapes and the unfused tail's, both
    ``align_corners``, bf16, float32 and bf16 autocast (float32 out), the
    residual resize and ragged channels and grids, a misaligned input;
    within one ulp of the terms, with the bit-equal share, of PyTorch's
    channels-last kernel (``compare_upsample``; below 16 channels, where
    ``F.interpolate`` takes its NCHW kernel, that kernel's distance is
    reported beside it); repeated bit for bit; the autograd route under autocast; a CUDA graph's
    replay; then timed against ``F.interpolate`` and the bytes' bound."""
    require_geometry("upsample", kernels.lib().txr_upsample_geometry,
                     (UP_THREADS, UP_SEGMENT_CHUNKS, UP_MAX_CHUNK_BYTES,
                      UP_MAX_CHUNK_BYTES // 2))
    f32, bf16 = torch.float32, torch.bfloat16
    shares = []
    cases = [(label, n, c, hw, size, True)
             for label, n, c, hw, size in UP_CELLS]
    cases += [(f"ragged {n}x{c}x{hw[0]}x{hw[1]}", n, c, hw, size, align)
              for n, c, hw, size in UP_RAGGED for align in (True, False)]
    nchw = []
    for label, n, c, hw, size, align in cases:
        for dtype, autocast in ((bf16, False), (f32, False), (bf16, True)):
            x = upsample_operand(n, c, hw, gen, dtype)
            case = (f"{label} -> {size[0]}x{size[1]} align_corners={align} "
                    f"{dtype} autocast={autocast} vec="
                    f"{require_upsample_operands(x, size, align)['vec']}")
            with torch.autocast("cuda", dtype=bf16, enabled=autocast):
                got = upsample_bilinear(x, size, align)
                want = interpolate_channels_last(x, size, align)
                direct = upsample_bilinear_plain(x, size, align)
            shares.append(compare_upsample(case, got, want, x, size,
                                           align)["bit_equal_share"])
            if c < UP_NHWC_MIN_CHANNELS:
                ulps = (ordered_bits(got) - ordered_bits(direct)).abs()
                nchw.append({"case": case, "bit_equal_share": (
                    ulps == 0).sum().item() / ulps.numel(),
                    "max_ulps": int(ulps.max().item())})
            del x, got, want, direct
    emit({"phase": "kernel_check", "kernel": "upsample",
          "case": "against F.interpolate itself below "
                  f"{UP_NHWC_MIN_CHANNELS} channels (PyTorch's NCHW "
                  "kernel; reported, not held)", "cases": nchw, "ok": True})
    for dtype in (bf16, f32):
        x = upsample_operand(2, 64, (21, 37), gen, dtype, offset=1)
        compare_upsample(f"misaligned {dtype} vec="
                         f"{require_upsample_operands(x, (42, 74), True)['vec']}",
                         upsample_bilinear(x, (42, 74), True),
                         upsample_bilinear_plain(x, (42, 74), True), x,
                         (42, 74), True)
    x = upsample_operand(8, 256, (148, 264), gen)
    require_repeatable("upsample",
                       lambda: upsample_bilinear(x, (296, 528), True))
    del x
    with torch.enable_grad():
        check_upsample_grads(gen)
    check_upsample_graph(gen)

    shapes = {}
    for label, n, c, hw, size in UP_CELLS:
        if label not in UP_TIMED:
            continue
        x = upsample_operand(n, c, hw, gen)
        plan = require_upsample_operands(x, size, True)
        nbytes = n * c * 2 * (hw[0] * hw[1] + size[0] * size[1])
        spread = time_spread({
            "kernel": lambda: upsample_bilinear(x, size, True),
            "library": lambda: upsample_bilinear_plain(x, size, True)},
            runs=10)
        spread.update(time_queued({
            "device": lambda: upsample_launch(x, plan)}))
        shapes[label] = {
            "shape": [n, c, *hw], "size": list(size),
            "device_ms": spread["device"]["median"],
            "ms": spread["kernel"]["median"],
            "library_ms": spread["library"]["median"],
            "bound_ms": nbytes / PEAK_BYTES * 1e3,
            "tb_per_s": nbytes / spread["device"]["median"] / 1e9,
            "library_tb_per_s":
                nbytes / spread["library"]["median"] / 1e9,
            "spread": spread}
        del x
    # the host's share: on a map this small the card finishes each launch
    # before the next is enqueued, so a call's time is its host work
    x = upsample_operand(1, 256, (4, 4), gen)
    host = time_spread({
        "kernel": lambda: upsample_bilinear(x, (8, 8), True),
        "library": lambda: upsample_bilinear_plain(x, (8, 8), True)},
        runs=10, inner=50)
    da2 = shapes["DA2 fusion_0"]
    return {"name": "upsample", "route": "cuda",
            "source": "txr_torch/csrc/upsample.cu", "replaces": None,
            "shape": da2["shape"], "ms": da2["ms"],
            "device_ms": da2["device_ms"], "plain_ms": da2["library_ms"],
            "library_ms": da2["library_ms"], "bound_ms": da2["bound_ms"],
            "bound_by": "bytes", "gbytes_per_s": da2["tb_per_s"] * 1e3,
            "bit_equal_share_least": min(shares),
            "below_16_channels_vs_nchw_kernel": {
                "bit_equal_share_least": min(r["bit_equal_share"]
                                             for r in nchw),
                "max_ulps": max(r["max_ulps"] for r in nchw)},
            "host_ms_a_call_at_4x4": {k: v["median"]
                                      for k, v in host.items()},
            "shapes": shapes}


# Each kernel's on-card checks by mode (``tools/kernel_dev.py <mode>``): the
# CUDA source under txr_torch/csrc and the checks, each called as
# ``check(batch, generator)``. check_offset_reduce returns the entry of the
# segscan row that times the fused reduce, not a row of its own.
KERNEL_CHECKS = {
    "attention": ("attention.cu", (check_attention, check_attention_bhsd)),
    "boundmax": ("attention.cu", (check_attention_boundmax,)),
    "conv": ("conv3x3.cu", (check_conv3x3,)),
    "int8": ("int8_linear.cu", (check_int8_linear,)),
    "tail": ("dpt_tail.cu", (check_tail,)),
    "scan": ("segscan.cu", (check_scan, check_offset_reduce)),
    "qk_prep": ("qk_prep.cu", (check_qk_prep,)),
    "merge": ("merge.cu", (check_merge,)),
    "cached": ("attention.cu", (check_cached_attention,)),
    "residual_norm": ("residual_norm.cu", (check_residual_norm,)),
    "upsample": ("upsample.cu", (check_upsample,)),
}


# --------------------------------------------------------------- reference

def check_reference(gen: torch.Generator) -> None:
    """The port's own small check on the card: a narrow model with the
    kernels against the same weights with the plain versions, and a kernel
    insert against a CPU insert of the same points."""
    vit = ViTConfig(hidden_size=128, num_layers=2, num_heads=2,
                    out_layers=(0, 0, 1, 1))
    dpt = DPTConfig(features=32, out_channels=(16, 32, 64, 64))
    model = DepthAnything(vit, dpt)
    model.init_weights(torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.head.head_conv3.bias.fill_(1.0)
    model = model.to("cuda", torch.bfloat16,
                     memory_format=torch.channels_last).eval()
    x = torch.randn((2, 70, 98, 3), generator=gen, device="cuda").to(
        torch.bfloat16)
    with torch.no_grad():
        got = model(x)
        for blk in range(vit.num_layers):
            attn = getattr(model.encoder, f"block_{blk}").attn
            attn.cfg = replace(attn.cfg, use_flash=False)
        model.head.cfg = replace(dpt, fused_head=False)
        want = model(x)
    torch.cuda.synchronize()
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    scale = w.abs().max().item()
    if not torch.isfinite(g).all() or scale == 0 or err > 0.05 * scale + 0.05:
        raise AssertionError(f"small model: kernels vs plain versions differ "
                             f"by {err} on values up to {scale}")

    # the same with the int8 linear and 3x3 conv kernels on, against the
    # "int8" policy (the library's integer product) with every kernel off;
    # 24 x 24 patches make fusion_0's map 96 x 96, so the conv kernel's area
    # gate engages
    def small(quant, kernels_on):
        v = ViTConfig(hidden_size=128, num_layers=2, num_heads=2,
                      out_layers=(0, 0, 1, 1), quant=quant,
                      use_flash=None if kernels_on else False)
        d = DPTConfig(features=32, out_channels=(16, 32, 64, 64),
                      fused_head=None if kernels_on else False,
                      fused_convs=kernels_on)
        m = DepthAnything(v, d)
        m.init_weights(torch.Generator().manual_seed(2))
        with torch.no_grad():
            m.head.head_conv3.bias.fill_(1.0)
        return m.to("cuda", torch.bfloat16,
                    memory_format=torch.channels_last).eval()

    xq = torch.randn((1, 336, 336, 3), generator=gen, device="cuda").to(
        torch.bfloat16)
    before = dict(kernels.launches)
    with torch.no_grad():
        got_q = small("int8p", True)(xq)
        used = {k: kernels.launches[k] - before[k] for k in before}
        want_q = small("int8", False)(xq)
    torch.cuda.synchronize()
    if used["int8_linear"] != 8 or used["conv3x3"] != 5:
        raise AssertionError(f"small quantised model launched {used}")
    gq, wq = got_q.float(), want_q.float()
    err_q = (gq - wq).abs().max().item()
    scale_q = wq.abs().max().item()
    if (not torch.isfinite(gq).all() or scale_q == 0
            or err_q > 0.05 * scale_q + 0.05):
        raise AssertionError(f"small quantised model: kernels vs library "
                             f"paths differ by {err_q} on values up to "
                             f"{scale_q}")

    pts = surface_points(1, 0.0)
    gpu = offset_map_insert(create_offset_map(1 << 16, 0.02), pts)
    gpu = offset_map_insert(gpu, pts)
    cpu = offset_map_insert(create_offset_map(1 << 16, 0.02, device="cpu"),
                            pts.to("cpu"))
    cpu = offset_map_insert(cpu, pts.to("cpu"))
    same_keys = bool((gpu.khi.cpu() == cpu.khi).all()) and bool(
        ((gpu.klo_x.cpu().long() >> 10) == (cpu.klo_x.long() >> 10)).all())
    same_w = bool(((gpu.yzw.cpu() & 0x7FF) == (cpu.yzw & 0x7FF)).all())
    n = int(offset_map_size(gpu))
    if not (same_keys and same_w and n == int(offset_map_size(cpu)) and n):
        raise AssertionError("voxel map from the kernel insert differs from "
                             "the CPU insert of the same points")
    emit({"phase": "reference", "small_model_max_abs_err": err,
          "small_model_value_scale": scale,
          "small_quant_model_max_abs_err": err_q,
          "small_quant_model_value_scale": scale_q, "insert_voxels": n,
          "insert_keys_equal_cpu": same_keys, "ok": True})


# ------------------------------------------------------------------- paths

def drive_path(phase: str, frames: int, expect: dict, version: str = "v2",
               encoder: str = "vitl", built=None, capture=None,
               model_hw=None, **model_kwargs) -> tuple:
    """Drive frames -> depth -> back-projection -> voxel map with the model
    ``build_model(version, encoder, **model_kwargs)`` builds from a CPU
    generator seeded with 0, or with ``built`` (``build_model``'s triple)
    where given: one warm-up step,
    STEPS timed steps, one step with events between the stages. ``expect``
    maps a kernel to its launches per step (asserted for every counter).
    ``capture`` (a ``Capture``) sees the staged step's model input and the
    operands the model hands its kernels in that step. Returns the phase's
    line and the depth of the staged step (frames of seed 0). ``model_hw``:
    the grid the frames are resized to (Depth Anything's 518 lower bound
    where None)."""
    in_h, in_w = model_hw or compute_da_resize(H, W, 518)
    t0 = time.perf_counter()
    build_s = None
    if built is None:
        built = build_model(
            version, encoder, dtype=torch.bfloat16,
            generator=torch.Generator(device="cpu").manual_seed(0),
            **model_kwargs)
        build_s = time.perf_counter() - t0
    model, vit_cfg, dpt_cfg = built
    rng = np.random.default_rng(0)
    dev_frames = [torch.from_numpy(rng.integers(
        0, 256, (frames, H, W, 3), dtype=np.uint8)).cuda() for _ in range(2)]

    fx = fy = 0.8 * W
    cx, cy = W / 2.0, H / 2.0
    sx, sy = in_w / W, in_h / H
    mean = torch.tensor(IMAGENET_MEAN, device="cuda")
    std = torch.tensor(IMAGENET_STD, device="cuda")
    eye = torch.eye(3, device="cuda")
    zero_t = torch.zeros(3, device="cuda")
    marks = {}

    def mark(name):
        if name in marks:
            marks[name].record()

    @torch.no_grad()
    def step(frames_u8, vm, seen=None):
        mark("start")
        x = frames_u8.to(torch.float32) / 255.0
        xm = resize_bicubic(x, in_h, in_w, align_corners=False)
        xn = ((xm - mean) / std).to(torch.bfloat16)
        mark("preprocessed")
        with (seen.during(model, xn) if seen is not None
              else contextlib.nullcontext()):
            depth = model(xn).to(torch.float32)
        mark("model")
        ps = backproject_world(depth, xm, eye, zero_t, fx * sx, fy * sy,
                               cx * sx, cy * sy, 1e-4, 1e6, 1.0, 1)
        n = ps.xyz.shape[0] * ps.xyz.shape[1]
        flat = PointSet(ps.xyz.reshape(n, 3), ps.rgb.reshape(n, 3),
                        ps.mask.reshape(n))
        mark("backprojected")
        vm = offset_map_insert(vm, flat)
        mark("inserted")
        return vm, depth

    vm = create_offset_map(1 << 21, 0.01)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()

    t0 = time.perf_counter()
    vm, depth = step(dev_frames[0], vm)
    voxels = int(offset_map_size(vm))
    warmup_s = time.perf_counter() - t0
    if depth.shape != (frames, in_h, in_w):
        raise AssertionError(f"depth shape {tuple(depth.shape)}")

    t0 = time.perf_counter()
    for i in range(STEPS):
        vm, depth = step(dev_frames[(i + 1) % 2], vm)
    voxels = int(offset_map_size(vm))          # forces the full sync
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    counts = dict(kernels.launches)
    total = STEPS + 1
    for name, got in counts.items():
        per_step = expect.get(name, 0)
        if got != per_step * total:
            raise AssertionError(
                f"{phase}: {got} launches of {name} over {total} steps, "
                f"expected {per_step} per step; all counts {counts}")
    if not 0 < voxels <= (1 << 21):
        raise AssertionError(f"voxel count {voxels}")

    # one more step with events between the stages: where the time goes
    names = ["start", "preprocessed", "model", "backprojected", "inserted"]
    marks.update({k: torch.cuda.Event(enable_timing=True) for k in names})
    vm, depth = step(dev_frames[0], vm, capture)
    torch.cuda.synchronize()
    stages = {b: marks[a].elapsed_time(marks[b])
              for a, b in zip(names[:-1], names[1:])}
    marks.clear()
    if not torch.isfinite(depth).all() or not (depth != 0).any():
        raise AssertionError("depth is not finite or is all zero")
    if (depth.max() - depth.min()).item() <= 0:
        raise AssertionError("depth is constant")

    out = {"phase": phase, "model": f"{version}/{encoder}",
           "quant": vit_cfg.quant, "fused_head": dpt_cfg.fused_head,
           "fused_convs": dpt_cfg.fused_convs,
           "hidden": vit_cfg.hidden_size,
           "layers": vit_cfg.num_layers, "heads": vit_cfg.num_heads,
           "dpt_features": dpt_cfg.features,
           "dpt_out_channels": list(dpt_cfg.out_channels),
           "dtype": "bfloat16",
           "input": [H, W], "model_input": [in_h, in_w],
           "tokens": (in_h // 14) * (in_w // 14) + 1,
           "frames_per_step": frames, "steps_timed": STEPS,
           "points_per_frame": in_h * in_w, "map_capacity": 1 << 21,
           "voxel_size_m": 0.01, "build_s": build_s, "warmup_s": warmup_s,
           "ms_per_step": step_ms, "ms_per_frame": step_ms / frames,
           "stage_ms": stages, "voxels": voxels,
           "depth_mean": depth.mean().item(),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts, "launches_over_steps": total, "ok": True}
    return out, depth


# launches per step of main_path's and quant_path's configurations
# an insert: the batch merged into the map's rows, then the fused reduce
INSERT_EXPECT = {"merge_sorted": 1, "offset_reduce": 1}
# two residual_norm launches a ViT block: after attention (with norm2) and
# after the MLP
RESIDUALS = 2
# four upsample launches a DPT branch: each fusion block's resize (the
# fused tail resizes inside the tail kernel; the unfused one adds a fifth)
UPSAMPLES = 4
MAIN_EXPECT = {"attention": 24, "dpt_tail": 1, **INSERT_EXPECT,
               "residual_norm": RESIDUALS * 24, "upsample": UPSAMPLES}
QUANT_EXPECT = {**MAIN_EXPECT, "int8_linear": 96, "conv3x3": 9}
QUANT_ENV = {"TXR_FUSED_CONVS": "1", "TXR_FUSED_HEAD": "1"}


def main_path(frames: int) -> tuple:
    """The default configuration: attention, tail and fused-reduce
    kernels."""
    out, depth = drive_path("main_path", frames, MAIN_EXPECT)
    emit(out)
    return out, depth


@contextlib.contextmanager
def scoped_env(env: dict):
    """``env`` set in the environment for the block, then restored."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def path_with_env(phase: str, env: dict, frames: int, expect: dict,
                  main_depth: torch.Tensor, **model_kwargs) -> tuple:
    """``drive_path`` with ``env`` set in the environment (restored
    afterwards), and its depth against ``main_path``'s (same weights and
    frames) as a share of main_path's depth span. Returns the line and the
    depth."""
    with scoped_env(env):
        out, depth = drive_path(phase, frames, expect, **model_kwargs)
    span = (main_depth.max() - main_depth.min()).item()
    diff = (depth - main_depth).abs() / span
    out["depth_vs_main_path"] = {
        "median_share_of_span": diff.median().item(),
        "max_share_of_span": diff.max().item(), "main_depth_span": span}
    return out, depth


def quant_path(frames: int, main_depth: torch.Tensor) -> tuple:
    """The int8 encoder with the 3x3 conv kernel in the head, as a user
    reaches them: ``quant="int8p"`` and ``TXR_FUSED_CONVS=1`` /
    ``TXR_FUSED_HEAD=1``. Same weights and frames as ``main_path``. Returns
    the line and the depth."""
    out, depth = path_with_env("quant_path", QUANT_ENV, frames, QUANT_EXPECT,
                               main_depth, quant="int8p")
    if not (out["fused_convs"] and out["fused_head"]):
        raise AssertionError("quant_path: the fused head settings are off")
    emit(out)
    return out, depth


def boundmax_path(frames: int, main_depth: torch.Tensor) -> dict:
    """``main_path``'s configuration with ``TXR_ATTN_SCORES=boundmax``,
    as a user selects the score mode: every attention call takes the
    bound-shift kernel and its key-norm pre-pass, none the f32max one."""
    out, _ = path_with_env(
        "boundmax_path", {"TXR_ATTN_SCORES": "boundmax"}, frames,
        {"attention_boundmax": 24, "attention_key_norm": 24, "dpt_tail": 1,
         "residual_norm": RESIDUALS * 24, "upsample": UPSAMPLES,
         **INSERT_EXPECT}, main_depth)
    out["score_mode"] = "boundmax"
    emit(out)
    return out


def odd_heads_path(frames: int, gen: torch.Generator) -> dict:
    """A ViT encoder whose head count is odd, which sends attention through
    ``multi_head_attention`` on (B, H, S, D) views: two blocks at the real
    sequence length, against the same encoder in float32 with
    ``use_flash=False``."""
    in_h, in_w = compute_da_resize(H, W, 518)
    vit = ViTConfig(hidden_size=ODD_HEADS * HEAD_DIM, num_heads=ODD_HEADS,
                    num_layers=2, out_layers=(0, 0, 1, 1))
    model = DepthAnything(vit, DPTConfig(features=32,
                                         out_channels=(16, 32, 64, 64)))
    model.init_weights(torch.Generator().manual_seed(3))
    enc = model.encoder.to("cuda", torch.bfloat16).eval()
    x = torch.randn((frames, in_h, in_w, 3), generator=gen, device="cuda").to(
        torch.bfloat16)
    kernels.reset_launches()
    with torch.no_grad():
        got = enc(x)
        torch.cuda.synchronize()
        counts = dict(kernels.launches)
        ms = time_ms(lambda: enc(x), runs=3)
        enc = enc.float()
        for blk in range(vit.num_layers):
            attn = getattr(enc, f"block_{blk}").attn
            attn.cfg = replace(attn.cfg, use_flash=False)
        want = enc(x.float())
    if counts["attention_bhsd"] != vit.num_layers or counts["attention"]:
        raise AssertionError(f"odd_heads_path launch counts {counts}")
    # against float32, not the plain route in bf16: both bf16 routes lie as
    # far from float32 (max 0.050 to 0.058, rms 0.0052 on values of rms 1,
    # 13 seeded inputs on an H100; none over the tolerance), and against
    # each other their errors add up to 0.0625 near 1 (3 of 12 inputs over)
    tol = dict(ATTN_TOL, atol=3e-2, bias_z=None, bias_why=None,
               why="the attention tolerance with its absolute part widened "
                   "to 4 bf16 ulps of a value of 2: the kernel's attention "
                   "output is within that tolerance, and a projection, an "
                   "MLP and two LayerNorms in bf16 follow")
    errs = [compare("odd_heads_encoder", f"hidden state {i}", g, w,
                    **tol)["max_abs_err"]
            for i, (g, w) in enumerate(zip(got, want))]
    out = {"phase": "odd_heads_path", "hidden": vit.hidden_size,
           "heads": vit.num_heads, "layers": vit.num_layers,
           "tokens": got[0].shape[1], "frames": frames, "dtype": "bfloat16",
           "encoder_ms": ms, "max_abs_err": max(errs), "launches": counts,
           "launches_over_steps": 1, "ok": True}
    emit(out)
    return out


class SeededFrames(ImageSource):
    """Seeded BGR frames as a frame source of the depth pipeline (the
    folder source needs image files, and so an encoder the card's machine
    need not have)."""

    def __init__(self, frames: np.ndarray,
                 intrinsics: CameraIntrinsics = None):
        self.frames = frames
        self.index = 0
        self.intrinsics = intrinsics or CameraIntrinsics.default(W, H)

    def __next__(self):
        if self.index >= len(self.frames):
            raise StopIteration
        self.index += 1
        i = self.index - 1
        return self.frames[i], float(i), f"frame_{i:04d}"


def run_processor(model, frames: np.ndarray, out_dir: str,
                  batch_size: int, intrinsics: CameraIntrinsics = None,
                  **proc_kw) -> dict:
    """``DepthProcessor`` in point-cloud mode over ``frames``, as
    ``depth_processor_torch.py``'s ``main()`` builds it (``proc_kw``: the
    settings it passes on, such as ``max_depth``), with the stages of each
    batch timed: the device part between CUDA events (upload, preprocess,
    model, upsample, back-projection; synchronised at its end), and on the
    host clock the copies to the host, each PLY write, and the host work
    between them (stacking a batch's frames, each frame's mask
    compaction). ``depths`` keeps each batch's device depth."""
    proc = DepthProcessor(model, SeededFrames(frames, intrinsics), out_dir,
                          mode="pointcloud", batch_size=batch_size,
                          **proc_kw)
    times = {"device_ms": [], "copy_ms": [], "ply_ms": [], "peak_bytes": [],
             "depths": []}
    spans = []                                  # (stage, host start, end)
    device_batch, to_host = proc._device_batch, proc._to_host
    save = proc._save_pointcloud

    def timed_device(images):
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = device_batch(images)
        end.record()
        torch.cuda.synchronize()
        spans.append(("device_ms", t0, time.perf_counter()))
        times["device_ms"].append(start.elapsed_time(end))
        times["peak_bytes"].append(torch.cuda.max_memory_allocated())
        times["depths"].append(out[0])
        return out

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            out = fn(*args)
            t1 = time.perf_counter()
            spans.append((name, t0, t1))
            times[name].append((t1 - t0) * 1e3)
            return out
        return call

    proc._device_batch = timed_device
    proc._to_host = timed("copy_ms", to_host)
    proc._save_pointcloud = timed("ply_ms", save)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    processed = proc.process()
    wall = time.perf_counter() - t0
    # the host work between the timed stages: before a PLY write, that
    # frame's mask compaction (numpy); before a device batch, gathering and
    # stacking its frames
    gaps = {"ply_ms": [], "device_ms": []}
    prev = t0
    for name, a, b in spans:
        if name in gaps:
            gaps[name].append((a - prev) * 1e3)
        prev = b
    times.update(processed=processed, wall_s=wall,
                 compaction_ms=gaps["ply_ms"], stack_ms=gaps["device_ms"],
                 launches=dict(kernels.launches))
    return times


def ply_pixels(path: str, intr: CameraIntrinsics) -> tuple:
    """A PLY's points with the flat index of the pixel each came from
    (recovered from x / z and y / z)."""
    xyz, rgb = read_ply(path)
    u = np.rint(xyz[:, 0] / xyz[:, 2] * intr.fx + intr.cx).astype(np.int64)
    v = np.rint(xyz[:, 1] / xyz[:, 2] * intr.fy + intr.cy).astype(np.int64)
    return v * W + u, xyz, rgb


def depth_share(diff: np.ndarray, span: float) -> dict:
    """Median and largest absolute depth difference as shares of a span."""
    d = np.abs(diff.astype(np.float64)) / span
    return {"median_share_of_span": float(np.median(d)),
            "max_share_of_span": float(d.max()), "depth_span": span}


SEQ_LIMIT = dict(median=0.01, max=0.10,
                 why="the batch-1 and the batched run differ only in the "
                     "order of f32 sums inside bf16 layers (cuBLAS picks "
                     "other algorithms at M = 2443 than at 8 x 2443); a "
                     "perturbation of that kind (boundmax against f32max, "
                     "PERF.md) moved the depth by 0.21 % / 2.1 % of its span")
PLY_TOL = dict(rtol=1e-6, atol=1e-6,
               why="the same depth bits back-projected on the card and on "
                   "the CPU: the card divides by a Python number as a "
                   "multiply by its rounded reciprocal, so x and y differ by "
                   "up to 2 f32 roundings (2.4e-7 relative)")


def stage_split(run: dict, sizes: list) -> tuple:
    """``run_processor``'s stages per batch of ``sizes`` frames, and the
    host time outside every timed stage (ms)."""
    batches = []
    for b, n in enumerate(sizes):
        first = sum(sizes[:b])
        batches.append({"frames": n, "stack_ms": run["stack_ms"][b],
                        "device_ms": run["device_ms"][b],
                        "peak_memory_bytes": run["peak_bytes"][b],
                        "copy_ms": run["copy_ms"][b],
                        "compaction_ms_per_frame": statistics.mean(
                            run["compaction_ms"][first:first + n]),
                        "ply_write_ms_per_frame": statistics.mean(
                            run["ply_ms"][first:first + n])})
    staged = sum(sum(run[k]) for k in ("stack_ms", "device_ms", "copy_ms",
                                       "compaction_ms", "ply_ms"))
    return batches, run["wall_s"] * 1e3 - staged


def depth_cli_path() -> dict:
    """The depth CLI's pipeline on the card, as ``depth_processor_torch.py``
    runs it with its defaults (``DepthAnythingModel("v2", "vitl")``, bf16,
    seeded weights; ``DepthProcessor`` at batch 8) but in point-cloud mode
    (the colormap needs OpenCV) over 12 seeded 1080p frames: one batch of 8
    and one of 4, a PLY per frame at the source resolution (2,073,600
    pixels) written by the native library. Output goes to a temporary
    directory, removed afterwards."""
    lib = native.get_lib()
    if lib is None:
        raise AssertionError("the native host library did not build")
    frames = np.random.default_rng(0).integers(
        0, 256, (CLI_FRAMES, H, W, 3), dtype=np.uint8)
    intr = CameraIntrinsics.default(W, H)
    model = DepthAnythingModel("v2", "vitl")
    out_dir = tempfile.mkdtemp(prefix="depth_cli_path.")
    try:
        # 1, 3: the run itself and its launches
        run = run_processor(model, frames, os.path.join(out_dir, "batched"),
                            batch_size=8)
        counts = run["launches"]
        expect = {"attention": 24 * 2, "dpt_tail": 2,
                  "residual_norm": RESIDUALS * 24 * 2,
                  "upsample": UPSAMPLES * 2}
        wrong = {k: n for k, n in counts.items() if n != expect.get(k, 0)}
        if wrong:
            raise AssertionError(f"depth_cli_path launched {counts}, "
                                 f"expected {expect}")
        plys = sorted(os.listdir(os.path.join(out_dir, "batched",
                                              "pointclouds")))
        if run["processed"] != CLI_FRAMES or plys != [
                f"frame_{i:04d}.ply" for i in range(CLI_FRAMES)]:
            raise AssertionError(f"processed {run['processed']} frames, "
                                 f"wrote {plys}")

        # 2: each PLY against the masked back-projection of infer_batch
        ref = np.concatenate([model.infer_batch(frames[:8], intr),
                              model.infer_batch(frames[8:], intr)])
        points, ply_bytes, max_err = [], [], 0.0
        for i in range(CLI_FRAMES):
            path = os.path.join(out_dir, "batched", "pointclouds", plys[i])
            ply_bytes.append(os.path.getsize(path))
            xyz, rgb = read_ply(path)
            want = backproject(torch.from_numpy(ref[i]),
                               torch.from_numpy(frames[i, ..., ::-1].copy()),
                               intr.fx, intr.fy, intr.cx, intr.cy, 0.1, 100.0,
                               1.0, 1).to_numpy()
            if xyz.shape != want[0].shape:
                raise AssertionError(f"frame {i}: {len(xyz)} points in the "
                                     f"PLY, {len(want[0])} in the "
                                     "back-projection of infer_batch")
            err = np.abs(xyz - want[0])
            if (err > PLY_TOL["atol"] + PLY_TOL["rtol"]
                    * np.abs(want[0])).any():
                raise AssertionError(f"frame {i}: PLY positions differ by "
                                     f"{err.max()}")
            if not np.array_equal(np.rint(rgb * 255),
                                  np.rint(want[1] * 255)):
                raise AssertionError(f"frame {i}: PLY colours differ")
            points.append(len(xyz))
            max_err = max(max_err, float(err.max()) if len(err) else 0.0)
        if not 0 < min(points):
            raise AssertionError(f"points per frame {points}")

        # 4: batch 1 against the batched run, first two frames
        seq = run_processor(model, frames[:2], os.path.join(out_dir, "seq"),
                            batch_size=1)
        span = float(ref[:2].max() - ref[:2].min())
        diffs, one_side = [], 0
        for name in plys[:2]:
            gp, gx, _ = ply_pixels(os.path.join(out_dir, "seq",
                                                "pointclouds", name), intr)
            wp, wx, _ = ply_pixels(os.path.join(out_dir, "batched",
                                                "pointclouds", name), intr)
            common, gi, wi = np.intersect1d(gp, wp, return_indices=True)
            dz = np.abs(gx[gi, 2] - wx[wi, 2])
            diffs.append(dz)
            only = np.concatenate([gx[~np.isin(gp, wp), 2],
                                   wx[~np.isin(wp, gp), 2]])
            # a point on one side only crossed min_depth between the runs
            if (np.abs(only - 0.1) > SEQ_LIMIT["max"] * span).any():
                raise AssertionError(f"{name}: points kept by one run only, "
                                     "away from min_depth")
            one_side += len(only)
        dz = np.concatenate(diffs)
        seq_share = depth_share(dz, span)
        seq_share.update(points_on_one_side_only=one_side,
                         points_compared=len(dz), limit=SEQ_LIMIT)
        if (seq_share["median_share_of_span"] > SEQ_LIMIT["median"]
                or seq_share["max_share_of_span"] > SEQ_LIMIT["max"]):
            raise AssertionError(f"batch 1 against batch 8: {seq_share}")

        # 5: the --int8 policy over 8 frames
        del model
        torch.cuda.empty_cache()
        q_model = DepthAnythingModel("v2", "vitl", quant="int8")
        q_run = run_processor(q_model, frames[:8],
                              os.path.join(out_dir, "int8"), batch_size=8)
        q_depth = q_model.infer_batch(frames[:8], intr)
        if not np.isfinite(q_depth).all() or q_depth.max() <= q_depth.min():
            raise AssertionError("int8 depth is not finite or is constant")
        q_share = depth_share(q_depth - ref[:8],
                              float(ref[:8].max() - ref[:8].min()))
        del q_model
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.empty_cache()

    batches, other_ms = stage_split(run, [8, CLI_FRAMES - 8])
    out = {"phase": "depth_cli_path", "model": "v2/vitl", "dtype": "bfloat16",
           "mode": "pointcloud", "input": [H, W], "frames": CLI_FRAMES,
           "batch_size": 8, "wall_s": run["wall_s"],
           "frames_per_second": CLI_FRAMES / run["wall_s"],
           "per_batch": batches, "other_host_ms": other_ms,
           "peak_memory_bytes": max(run["peak_bytes"]),
           "pixels_per_frame": H * W, "points_per_frame": points,
           "ply_bytes_per_frame": statistics.mean(ply_bytes),
           "native_codecs": native.codecs(),
           "ply_vs_infer_batch": {"max_abs_err_m": max_err,
                                  "points_equal": True, "tolerance": PLY_TOL},
           "sequential_vs_batched": seq_share,
           "sequential_frames_per_second": 2 / seq["wall_s"],
           "int8": {"frames": 8, "depth_vs_bf16": q_share,
                    "frames_per_second": 8 / q_run["wall_s"],
                    "device_ms": q_run["device_ms"],
                    "launches": q_run["launches"]},
           "launches": counts, "launches_over_steps": 2, "ok": True}
    emit(out)
    return out


# --------------------------------------------------------------- registry

# Every distinct model configuration of the registry at full width, with
# the launches a step its code gives: one attention launch a block (every
# registry head count is even, so the fused-layout kernel) and two residual
# launches, one tail launch and one fused-reduce launch a step; "int8p" one
# int8 launch per dense layer (qkv, proj, fc1 / w12, fc2 / w3: 4 a block),
# "int8mix" one a block (the policy table, txr_torch/models/vit.py:_dense,
# puts only the fc2 role, fc2 or SwiGLU's w3, on the kernel and the rest on
# the library's torch._int_mm); TXR_FUSED_CONVS=1 nine conv launches
# (fusion_1's and fusion_0's four residual convs, the only maps of at least
# 96 x 96 pixels, and head_conv1). v1 has v2's widths per encoder, so it
# adds no shape; v3 / large is ViT-L's (v3_metric_cli_path runs it).
REGISTRY = (
    # version, encoder, quant, TXR_FUSED_CONVS, launches a step
    ("v2", "vitb", "none", False,
     {"attention": 12, "residual_norm": RESIDUALS * 12, "dpt_tail": 1,
      "upsample": UPSAMPLES, **INSERT_EXPECT}),
    ("v2", "vitb", "int8p", True,
     {"attention": 12, "residual_norm": RESIDUALS * 12, "dpt_tail": 1,
      "upsample": UPSAMPLES, **INSERT_EXPECT, "int8_linear": 48, "conv3x3": 9}),
    ("v2", "vitg", "none", False,
     {"attention": 40, "residual_norm": RESIDUALS * 40, "dpt_tail": 1,
      "upsample": UPSAMPLES, **INSERT_EXPECT}),
    ("v2", "vitg", "int8mix", False,
     {"attention": 40, "residual_norm": RESIDUALS * 40, "dpt_tail": 1,
      "upsample": UPSAMPLES, **INSERT_EXPECT, "int8_linear": 40}),
    ("v2", "vitg", "int8p", True,
     {"attention": 40, "residual_norm": RESIDUALS * 40, "dpt_tail": 1,
      "upsample": UPSAMPLES, **INSERT_EXPECT, "int8_linear": 160, "conv3x3": 9}),
    ("v2", "vitl", "int8mix", False,
     {"attention": 24, "residual_norm": RESIDUALS * 24, "dpt_tail": 1,
      "upsample": UPSAMPLES, **INSERT_EXPECT, "int8_linear": 24}),
)
# the 3x3 conv kernel's sites in the head whose operands are held to the
# plain version
CONV_SITES = ("fusion_0.rcu1.conv1", "head_conv1")
ROUTE_TOL = {
    "none": dict(median=0.01, max=0.10,
                 why="the kernels against their plain versions (ATTN_TOL, "
                     "TAIL_TOL, CONV_TOL) in every layer of a bf16 network: "
                     "readings 2.1e-2 to 3.2e-2 of the span at the most on "
                     "the registry's models (ViT-L's forward in train_path "
                     "2.1e-2); SEQ_LIMIT's bounds"),
    "int8": dict(median=0.01, max=0.20,
                 why="as for bf16, but both routes quantise each dense "
                     "layer's input rows, and the kernels' rounding moves a "
                     "value across a rounding tie now and then: a whole "
                     "int8 step that the next layers spread; readings 3.0e-2 "
                     "to 7.1e-2 of the span at the most")}


def dense_layers(block) -> dict:
    """A ViT block's dense layers by role."""
    mlp = block.mlp
    ffn = ({"w12": mlp.w12, "w3": mlp.w3} if hasattr(mlp, "w12")
           else {"fc1": mlp.fc1, "fc2": mlp.fc2})
    return {"qkv": block.attn.qkv, "proj": block.attn.proj, **ffn}


class Capture:
    """The operands a model hands its kernels in one forward, kept for
    checks on the model's own activations, all seen from the model's
    submodules: the qkv of ``blocks`` (the attention kernel's operand, a
    forward hook on the qkv layer), the input of each dense layer of
    ``int8_block`` (forward pre-hooks), the input of the 3x3 conv kernel at
    CONV_SITES and the tail's input, which is head_conv1's output. A
    ``Conv3x3`` reaches the kernel through its ``fused`` method, which hooks
    do not see, so that method is wrapped on the instance for the forward;
    on the library's conv a forward hook takes head_conv1's output."""

    def __init__(self, blocks=(), int8_block: int = None):
        self.blocks = tuple(blocks)
        self.int8_block = int8_block
        self.input = None
        self.head = None
        self.qkv = {}
        self.dense = {}
        self.tail_x = None
        self.out_hw = None
        self.convs = {}

    @contextlib.contextmanager
    def during(self, model, x: torch.Tensor):
        self.input, self.head = x, model.head
        enc, head = model.encoder, model.head
        handles = [getattr(enc, f"block_{i}").attn.qkv.register_forward_hook(
            lambda mod, args, out, i=i: self.qkv.__setitem__(i, out))
            for i in self.blocks]
        if self.int8_block is not None:
            for role, mod in dense_layers(
                    getattr(enc, f"block_{self.int8_block}")).items():
                handles.append(mod.register_forward_pre_hook(
                    lambda m, args, role=role: self.dense.__setitem__(
                        role, (m, args[0]))))
        handles.append(head.register_forward_hook(
            lambda m, args, out: setattr(self, "out_hw",
                                         tuple(out.shape[1:]))))
        handles.append(head.head_conv1.register_forward_hook(
            lambda m, args, out: setattr(
                self, "tail_x", out.permute(0, 2, 3, 1).contiguous())))
        wrapped = [head.get_submodule(site) for site in CONV_SITES]

        def watch(site, conv):
            fn = conv.fused

            def fused(x_nhwc, relu_in):
                out = fn(x_nhwc, relu_in)
                self.convs[site] = (conv, x_nhwc, relu_in)
                if site == "head_conv1":
                    self.tail_x = out
                return out
            return fused

        for site, conv in zip(CONV_SITES, wrapped):
            conv.fused = watch(site, conv)
        try:
            yield
        finally:
            for conv in wrapped:
                del conv.fused
            for h in handles:
                h.remove()

    def tail_args(self) -> tuple:
        """The tail kernel's arguments as ``DPTHead.forward`` makes them:
        head_conv1's output, conv2's and conv3's parameters, the depth's
        size and the head's cached packed operands."""
        h = self.head
        return (self.tail_x, h.head_conv2.weight.permute(2, 3, 1, 0),
                h.head_conv2.bias, h.head_conv3.weight.reshape(-1),
                h.head_conv3.bias, *self.out_hw,
                h.tail_operands() if self.tail_x.is_cuda else None)


def tail_exact(args: tuple) -> torch.Tensor:
    """The tail's plain version in f32 on the values the kernel multiplies:
    the input and conv2's weight as bf16 (the packed operand), the biases
    and conv3's weight as they are (the kernel reads them in f32)."""
    x, w2, b2, w3, b3, out_h, out_w = args[:7]
    return head_tail_reference(x.float(), w2.to(torch.bfloat16).float(),
                               b2.float(), w3.float(), b3.float(), out_h,
                               out_w, args[8] if len(args) > 8 else None)


def tail_image_rounded(args: tuple) -> tuple:
    """``tail_exact`` with the upsampled image rounded to bf16 before
    conv2, as the kernel rounds it: the plain version of the kernel's own
    arithmetic, to tell that rounding's effect on the mean (the ReLU after
    conv2 turns a noise of mean 0 into a shift) from the kernel's. Also
    returns the output's derivative in a common relative scale of conv2's
    sums (before its bias), the direction in which a product that loses a
    constant share of each sum moves the output."""
    x, w2, b2, w3, b3, out_h, out_w = args[:7]
    y = resize_bilinear(x.float(), out_h, out_w, align_corners=True)
    acc = F.conv2d(y.to(torch.bfloat16).float().permute(0, 3, 1, 2),
                   w2.to(torch.bfloat16).float().permute(3, 2, 0, 1),
                   padding=1)
    pre = acc + b2.float().reshape(1, -1, 1, 1)
    w3f = w3.float().reshape(1, -1, 1, 1)
    out = F.conv2d(F.relu(pre), w3f)[:, 0] + b3.float().reshape(-1)[0]
    return out, F.conv2d(acc * (pre > 0), w3f)[:, 0]


def check_activations(cap: Capture, vit_cfg, label: str) -> list:
    """Each kernel on the operands ``cap`` kept against its plain version on
    the same tensors, to the kernel checks' tolerances; a short record of
    each check. The attention kernel at the captured blocks, the tail with
    the head's cached packed operands and at the geometry the library
    computes, the 3x3 conv through the layer's ``fused`` (its cached packed
    weight), each held to the plain version of the layer's current weights,
    so a stale pack fails too; and each dense layer on the kernel route
    bit-equal to the int8 plain version (a layer on the library's route is
    named). The tail's line also carries the signed errors of the kernel
    against ``tail_image_rounded`` and of that against ``tail_exact``, and
    the share of conv2's sums that the kernel's products lose (fitted by
    least squares along ``tail_image_rounded``'s direction) with the
    signed error that remains."""
    rec = []
    heads = vit_cfg.num_heads
    head_dim = vit_cfg.hidden_size // heads
    for i, qkv in sorted(cap.qkv.items()):
        rec.append(compare(
            "attention", f"{label} block {i} qkv {list(qkv.shape)}",
            fused_attention(qkv, heads, head_dim),
            attention_reference(qkv, heads, head_dim), **ATTN_TOL))
        torch.cuda.empty_cache()
    if cap.tail_x is not None:
        args = cap.tail_args()
        x, out_h, out_w = args[0], args[5], args[6]
        geo = require_tail_geometry((*x.shape, out_h, out_w),
                                    kernels.sm_count(0))
        got, want = fused_head_tail(*args), tail_exact(args)
        rec.append(compare(
            "dpt_tail", f"{label} {list(x.shape)}->{out_h}x{out_w}, "
            f"{geo['chunks']} chunks, {geo['smem_bytes']} B of shared "
            f"memory, window {list(geo['window'])} x "
            f"{geo['window_buffers']}", got, want, **TAIL_TOL))
        rounded, d_scale = tail_image_rounded(args)
        rms = rec[-1]["value_rms"]
        resid = got.float() - rounded
        lost = -((resid * d_scale).sum() / d_scale.pow(2).sum()).item()
        rec[-1].update(smem_bytes=geo["smem_bytes"],
                       vs_image_rounded=signed_error(resid, rms),
                       image_rounding=signed_error(rounded - want, rms),
                       conv2_share_lost=lost,
                       vs_image_rounded_less_lost=signed_error(
                           resid + lost * d_scale, rms))
        del args, got, want, rounded, d_scale, resid
        torch.cuda.empty_cache()
    for site, (conv, x, relu) in cap.convs.items():
        w = conv.weight.permute(2, 3, 1, 0)
        rec.append(compare(
            "conv3x3", f"{label} {site} {list(x.shape)}->{w.shape[3]} "
            f"relu_in={relu}, "
            f"{conv_geometry(*x.shape, w.shape[3])['feature_blocks']} "
            f"feature blocks", conv.fused(x, relu),
            conv3x3_reference(x.float(), w.float(), conv.bias.float(), relu),
            **CONV_TOL))
        torch.cuda.empty_cache()
    for role, (mod, x) in cap.dense.items():
        case = f"{label} block {cap.int8_block} {role} {list(x.shape)} @ " \
               f"{mod.in_features}x{mod.out_features}"
        if isinstance(mod, Int8LinearFused):
            res = compare_bits("int8_linear", case, mod(x),
                               int8_linear_reference(x, mod.weight.t(),
                                                     mod.bias))
            rec.append({"kernel": "int8_linear", "case": case, **res})
        elif isinstance(mod, Int8Linear):
            rec.append({"kernel": None, "case": case,
                        "route": "library (torch._int_mm)"})
    return [{k: r.get(k) for k in ("kernel", "case", "least_margin",
                                   "max_abs_err", "bit_equal_share",
                                   "mean_signed_rel", "mean_signed_z",
                                   "route", "smem_bytes",
                                   "vs_image_rounded", "image_rounding",
                                   "conv2_share_lost",
                                   "vs_image_rounded_less_lost")
             if k in r}
            for r in rec]


def check_policy(model, vit_cfg, label: str) -> dict:
    """Every dense layer of every block is of the class the policy table
    gives its role; the count of layers on the kernel's route."""
    on_kernel = 0
    for i in range(vit_cfg.num_layers):
        for role, mod in dense_layers(getattr(model.encoder,
                                              f"block_{i}")).items():
            want = vit_dense(vit_cfg.quant,
                             "fc2" if role in ("fc2", "w3") else role)
            if type(mod) is not want:
                raise AssertionError(f"{label}: block {i} {role} is "
                                     f"{type(mod).__name__}, the policy "
                                     f"gives {want.__name__}")
            on_kernel += type(mod) is Int8LinearFused
    return {"dense_layers_on_kernel": on_kernel}


def plain_route(version: str, encoder: str, quant: str, model, x, depth,
                kernel_roles: int) -> dict:
    """The same weights built with ``use_flash=False``, ``TXR_FUSED_HEAD=0``
    and ``TXR_FUSED_CONVS=0`` (``quant`` as it is) on the staged step's
    input: no attention, tail or conv launch (the int8 kernel stays where
    the policy puts it, and the residual kernel, whose x' is the plain
    version's bit for bit, in every block), and the depth as a share of the
    plain depth's span, to ROUTE_TOL of the policy."""
    with scoped_env({"TXR_FUSED_HEAD": "0", "TXR_FUSED_CONVS": "0"}):
        plain, _, pdpt = build_model(
            version, encoder, use_flash=False, quant=quant,
            dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(0))
    plain.load_state_dict(model.state_dict())
    if pdpt.fused_head is not False or pdpt.fused_convs is not False:
        raise AssertionError("the plain route fuses the head")
    kernels.reset_launches()
    with torch.no_grad():
        want = plain(x).float()
    torch.cuda.synchronize()
    used = {k: v for k, v in kernels.launches.items() if v}
    want_used = {"residual_norm": RESIDUALS * model.encoder.cfg.num_layers,
                 "upsample": UPSAMPLES + 1}
    if kernel_roles:
        want_used["int8_linear"] = kernel_roles
    if used != want_used:
        raise AssertionError(f"plain route launched {used}")
    del plain
    if not torch.isfinite(want).all():
        raise AssertionError("plain route: depth is not finite")
    span = (want.max() - want.min()).item()
    diff = (depth - want).abs() / span
    limit = ROUTE_TOL["none" if quant == "none" else "int8"]
    out = {"median_share_of_span": diff.median().item(),
           "max_share_of_span": diff.max().item(), "plain_depth_span": span,
           **signed_error(depth - want, want.pow(2).mean().sqrt().item()),
           "launches": used, "limit": limit}
    if (out["median_share_of_span"] > limit["median"]
            or out["max_share_of_span"] > limit["max"]):
        raise AssertionError(f"kernel route against plain route: {out}")
    return out


def centre_head(model) -> float:
    """Phase setting of registry_path, not a model change: the seeded
    relative head ends in a ReLU whose input carries an offset of either
    sign common to every pixel (conv3's weights against the mean of conv2's
    ReLU features), and ViT-B's put 99.5 % of the pixels at 0. conv3's bias
    is moved by minus the lowest decile of that input on one seeded frame,
    so that about 90 % of the depth is above 0 and the median of a
    difference between two routes is not that of zeros. Returns the
    shift."""
    in_h, in_w = compute_da_resize(H, W, 518)
    frame = torch.from_numpy(np.random.default_rng(5).integers(
        0, 256, (1, H, W, 3), dtype=np.uint8)).cuda()
    mean = torch.tensor(IMAGENET_MEAN, device="cuda")
    std = torch.tensor(IMAGENET_STD, device="cuda")
    cap = Capture()
    with torch.no_grad():
        x = resize_bicubic(frame.float() / 255.0, in_h, in_w,
                           align_corners=False)
        x = ((x - mean) / std).to(torch.bfloat16)
        with cap.during(model, x):
            model(x)
        shift = -torch.quantile(tail_exact(cap.tail_args()).reshape(-1),
                                0.1).item()
        model.head.head_conv3.bias.add_(shift)
    return shift


def registry_path(frames: int) -> list:
    """Each configuration of REGISTRY at full width on ``frames`` seeded
    1080p frames, seeded weights drawn on the card: ``drive_path`` with its
    launches asserted, the kernels held to their plain versions on the
    operands the staged step handed them, the policy table checked layer by
    layer, and the depth against the same weights on the plain route. Each
    relative head is centred first (``centre_head``). One line a
    configuration."""
    lines = []
    for version, encoder, quant, convs, expect in REGISTRY:
        t_phase = time.perf_counter()
        label = f"{version}/{encoder}/{quant}" + ("+convs" if convs else "")
        env = QUANT_ENV if convs else {}
        layers = VIT_PRESETS[MODEL_CONFIGS[version][encoder]["encoder"]
                             ].num_layers
        cap = Capture(blocks=(0, layers - 1), int8_block=layers // 2)
        with scoped_env(env):
            built = build_model(
                version, encoder, dtype=torch.bfloat16, quant=quant,
                generator=torch.Generator(device="cuda").manual_seed(0))
        model, vit_cfg, dpt_cfg = built
        policy = check_policy(model, vit_cfg, label)
        head_shift = centre_head(model)
        out, depth = drive_path("registry_path", frames, expect,
                                version, encoder, built=built, capture=cap)
        if bool(dpt_cfg.fused_convs) != convs or len(cap.convs) != (
                len(CONV_SITES) if convs else 0):
            raise AssertionError(f"{label}: fused convs {dpt_cfg.fused_convs}"
                                 f", {len(cap.convs)} conv sites seen")
        if expect.get("int8_linear", 0) != policy[
                "dense_layers_on_kernel"]:
            raise AssertionError(f"{label}: {policy} against {expect}")
        checks = check_activations(cap, vit_cfg, label)
        route = plain_route(version, encoder, quant, model, cap.input, depth,
                            policy["dense_layers_on_kernel"])
        out.update(policy=quant, label=label,
                   head_bias_shift=head_shift,
                   zero_depth_share=(depth == 0).float().mean().item(),
                   kernel_checks=checks, depth_vs_plain_route=route,
                   **policy, phase_s=time.perf_counter() - t_phase)
        emit(out)
        lines.append(out)
        del model, built, cap, depth
        torch.cuda.empty_cache()
    return lines


# Depth Anything 3 any-view: views a step (the benchmark cell's), the
# cross-view layers whose qkv is checked, launches a step
DA3_VIEWS = 16
DA3_BLOCKS = (9, 23)
DA3_EXPECT = {"attention": 24, "dpt_tail": 2, **INSERT_EXPECT,
              "qk_prep": 16, "residual_norm": RESIDUALS * 24,
              "upsample": 2 * UPSAMPLES}


def attention_reference_blocked(qkv: torch.Tensor, heads: int,
                                head_dim: int, rows: int = 1024
                                ) -> torch.Tensor:
    """``attention_reference`` taken in blocks of ``rows`` query rows, each
    against every key: at S = 39,088 the whole float32 score matrix of 16
    heads would be 98 GB."""
    b, s, _ = qkv.shape
    q, k, v = split_heads(qkv, heads, head_dim)
    out = torch.empty((b, heads, s, head_dim), dtype=qkv.dtype,
                      device=qkv.device)
    for i in range(0, s, rows):
        out[:, :, i:i + rows] = attention_plain(q[:, :, i:i + rows], k, v)
    return out.transpose(1, 2).reshape(b, s, heads * head_dim)


def tail_hook(tails: dict, label: str, head, prefix: str):
    """Keeps (head, prefix, conv1's input, conv1's output NHWC) of a tail
    under ``label``: the unfused tail's input and the tail kernel's."""
    return getattr(head, prefix + "1").register_forward_hook(
        lambda mod, args, out: tails.__setitem__(label, (
            head, prefix, args[0], out.permute(0, 2, 3, 1).contiguous())))


class AnyviewCapture:
    """What a Depth Anything 3 any-view forward hands its kernels, for
    ``drive_path``'s staged step: the model's input, the qkv of the cross-view blocks
    ``blocks`` as the attention kernel reads it (the output of the block's
    QK-norm / RoPE), and for each head branch the input and output of its
    conv1 (the unfused tail's input and the tail kernel's, NHWC)."""

    name = "da3"

    def __init__(self, blocks=DA3_BLOCKS):
        self.blocks = tuple(blocks)
        self.qkv = {}
        self.pre = {}
        self.tails = {}
        self.x = None

    def preps(self, model) -> dict:
        """The QK-norm / RoPE modules of the captured blocks."""
        return {i: getattr(model.encoder, f"block_{i}").attn.qk_prep
                for i in self.blocks}

    def tail_hooks(self, model) -> list:
        return [tail_hook(self.tails, prefix, model.head, prefix)
                for prefix in ("head_conv", "ray_conv")]

    @contextlib.contextmanager
    def during(self, model, x: torch.Tensor):
        self.x = x
        handles = []
        for i, prep in self.preps(model).items():
            # the kernel updates qkv in place: keep a copy of its input
            handles.append(prep.register_forward_pre_hook(
                lambda mod, args, i=i: self.pre.__setitem__(
                    i, (mod, args[0].clone(), *args[1:]))))
            handles.append(prep.register_forward_hook(
                lambda mod, args, out, i=i: self.qkv.__setitem__(i, out)))
        handles += self.tail_hooks(model)
        try:
            yield
        finally:
            for h in handles:
                h.remove()


def check_anyview(cap: AnyviewCapture, out_hw: tuple) -> list:
    """The attention kernel at each captured cross-view layer (the step's
    views as one sequence) and the tail kernel of both head branches, on the
    staged step's own operands, each against its plain version (ATTN_TOL,
    TAIL_TOL); each tail also no further from the float32 plain version, in
    rms, than ``DPTHead._tail`` (the unfused bf16 route: upsample, conv2,
    ReLU, conv3 as separate ops) on the same conv1 input. First the
    qk_prep kernel's result at each captured block, as the model handed it
    to attention, against the plain version on the block's own pre-prep
    qkv (``compare_qk_prep``)."""
    rec = []
    for i, (mod, qkv, heads, tables) in sorted(cap.pre.items()):
        args = (qkv, heads, mod.q_norm, mod.k_norm, tables)
        with torch.no_grad():
            rec.append(compare_qk_prep(
                f"{cap.name} block {i} qkv {list(qkv.shape)}", cap.qkv[i],
                qk_prep_plain(*args), *args))
    cap.pre.clear()
    for i, qkv in sorted(cap.qkv.items()):
        one = qkv.view(1, -1, qkv.shape[-1])
        rec.append(compare(
            "attention", f"{cap.name} cross-view block {i} qkv "
            f"{list(one.shape)} "
            f"after QK-norm and RoPE", fused_attention(one, HEADS, HEAD_DIM),
            attention_reference_blocked(one, HEADS, HEAD_DIM), **ATTN_TOL))
        torch.cuda.empty_cache()
    for label, (head, prefix, y, x) in sorted(cap.tails.items()):
        conv2, conv3 = (getattr(head, f"{prefix}{i}") for i in (2, 3))
        args = (x, conv2.weight.permute(2, 3, 1, 0), conv2.bias,
                conv3.weight.permute(2, 3, 1, 0), conv3.bias, *out_hw,
                head.tail_operands(prefix),
                head.tail_position_term(prefix, *out_hw))
        geo = require_tail_geometry((*x.shape, *out_hw), kernels.sm_count(0))
        got, want = fused_head_tail(*args), tail_exact(args)
        rec.append(compare(
            "dpt_tail", f"{cap.name} {label} {list(x.shape)}->{out_hw[0]}x"
            f"{out_hw[1]}x{conv3.out_channels}, {geo['chunks']} chunks, "
            f"{geo['smem_bytes']} B of shared memory", got, want,
            **TAIL_TOL))
        with torch.no_grad():
            unfused = head._tail(y, prefix, *out_hw).permute(0, 2, 3, 1)
        rms = (unfused.float() - want).pow(2).mean().sqrt().item()
        rec[-1]["unfused_err_rms"] = rms
        if rec[-1]["err_rms"] > rms:
            raise AssertionError(
                f"dpt_tail/{cap.name} {label}: the kernel's error rms "
                f"{rec[-1]['err_rms']} exceeds the unfused route's {rms}")
        del args, got, want, unfused
        torch.cuda.empty_cache()
    return [{k: r.get(k) for k in ("kernel", "case", "least_margin",
                                   "max_abs_err", "err_rms", "value_rms",
                                   "unfused_err_rms", "mean_signed_rel",
                                   "mean_signed_z", "max_ulps_of_terms",
                                   "bit_equal_share") if k in r}
            for r in rec]


@contextlib.contextmanager
def plain_upsample():
    """The DPT heads' resizes through ``F.interpolate`` (the upsample
    kernel's plain version) for the block, in place of the kernel."""
    import txr_torch.models.dpt as dpt

    real = dpt.upsample_bilinear
    dpt.upsample_bilinear = upsample_bilinear_plain
    try:
        yield
    finally:
        dpt.upsample_bilinear = real


def upsample_route_change(model, x: torch.Tensor) -> dict:
    """Every output of ``model`` on ``x`` (its ``outputs``: rays, points,
    poses, confidences beside the depth that ``correct`` checks) through
    the upsample kernel against the same forward with the heads' resizes
    through ``F.interpolate`` (``plain_upsample``), on the card: each
    output's largest absolute change and whether it is bit-equal."""
    with torch.no_grad():
        model(x)
        got = {k: v.clone() for k, v in model.outputs.items()}
        before = kernels.launches["upsample"]
        with plain_upsample():
            model(x)
        if kernels.launches["upsample"] != before:
            raise AssertionError("the plain upsample route launched the "
                                 "kernel")
        want = model.outputs
    torch.cuda.synchronize()
    out = {}
    for name, g in got.items():
        w = want[name]
        if not torch.isfinite(g.float()).all():
            raise AssertionError(f"upsample route: {name} is not finite")
        out[name] = {"max_abs_change": (g.float() - w.float()).abs().max(
        ).item(), "max_abs": w.float().abs().max().item(),
                     "bit_equal": torch.equal(g, w)}
    del got, want
    return out


def da3_path() -> dict:
    """``drive_path`` on Depth Anything 3 any-view at full width, DA3_VIEWS
    seeded 1080p frames a step as the views of one scene, seeded weights
    drawn on the card: DA3_EXPECT's launches a step, then ``check_anyview``
    on the staged step and ``upsample_route_change`` (rays and confidences
    beside the depth, against the heads' resizes through
    ``F.interpolate``)."""
    t_phase = time.perf_counter()
    cap = AnyviewCapture()
    built = build_model(
        "v3", "large-anyview", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(0))
    out, depth = drive_path("da3_path", DA3_VIEWS, DA3_EXPECT, "v3",
                            "large-anyview", built=built, capture=cap)
    out.update(kernel_checks=check_anyview(cap, tuple(depth.shape[1:])),
               upsample_vs_plain_route=upsample_route_change(built[0],
                                                             cap.x),
               crossview_tokens=DA3_VIEWS * out["tokens"],
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    del built, cap, depth
    return out


# VGGT-1B (the benchmark's configuration): views a step (the cell's), the
# pairs whose global block's qkv is checked, launches a step, and how far
# the program's outputs may lie from the float32 reference against the
# same reference at bfloat16 (rms error over rms error)
VGGT_VIEWS = 32
VGGT_PAIRS = (11, 23)
# blocks a forward: the front's 24, the aggregator's 48 and the camera
# trunk's 4 in each of its 4 rounds
VGGT_BLOCKS = 24 + 48 + 4 * 4
VGGT_EXPECT = {"attention": 72, "dpt_tail": 2, **INSERT_EXPECT,
               "qk_prep": 48, "residual_norm": RESIDUALS * VGGT_BLOCKS,
               "upsample": 2 * UPSAMPLES}
VGGT_ERR_RATIO = 2.0


class VGGTCapture(AnyviewCapture):
    """``AnyviewCapture`` of a VGGT forward: the global blocks of the pairs
    ``pairs``, the depth and point heads' tails, and the model's input."""

    name = "vggt"

    def __init__(self, pairs=VGGT_PAIRS):
        super().__init__(pairs)

    def preps(self, model) -> dict:
        return {i: getattr(model.aggregator, f"global_{i}").attn.qk_prep
                for i in self.blocks}

    def tail_hooks(self, model) -> list:
        return [tail_hook(self.tails, name, getattr(model, name),
                          "head_conv")
                for name in ("depth_head", "point_head")]


def vggt_outputs(model, x: torch.Tensor, weights: dict, cfg: dict,
                 vref=None) -> list:
    """Each output of the program's staged step (depth, points, both
    confidences, the pose encoding) against the float32 reference on the
    same normalised input, beside the same reference at bfloat16: the
    program's rms error over the output's rms may be at most
    VGGT_ERR_RATIO times the bfloat16 reference's. ``vref``: the reference
    module (``port_bench/reference/vggt.py`` where None)."""
    if vref is None:
        from port_bench.reference import vggt as vref

    xin = x.permute(0, 3, 1, 2).float()
    with torch.no_grad(), vref.exact_float32():
        want = vref.outputs(xin, weights, cfg)
        w16 = {k: v.to(torch.bfloat16) for k, v in weights.items()}
        b16 = {k: v.float() for k, v in vref.outputs(
            xin.to(torch.bfloat16), w16, cfg).items()}
        del w16
    rec = []
    for name, ref in want.items():
        got = model.outputs[name].float()
        scale = ref.pow(2).mean().sqrt().item()
        err = (got - ref).pow(2).mean().sqrt().item() / scale
        err16 = (b16[name] - ref).pow(2).mean().sqrt().item() / scale
        r = {"output": name, "shape": list(ref.shape), "rms": scale,
             "err_rms_rel": err, "bf16_reference_err_rms_rel": err16,
             "ratio": err / err16,
             "max_abs_err": (got - ref).abs().max().item()}
        rec.append(r)
        if not err <= VGGT_ERR_RATIO * err16:
            raise AssertionError(f"vggt_path: {name}'s error {err} is more "
                                 f"than {VGGT_ERR_RATIO} x the bfloat16 "
                                 f"reference's {err16}")
    return rec


def vggt_path() -> dict:
    """``drive_path`` on VGGT-1B at published widths (the benchmark's
    ``configs/vggt-1b.json`` and its seeded weights, built by
    ``archs/vggt.py``), VGGT_VIEWS seeded 1080p frames a step at 294 x 518
    as the views of one scene: VGGT_EXPECT's launches a step; then
    ``check_anyview`` on the staged step (the ``qk_prep`` and attention
    kernels at two global blocks, S = 32 x 782, and both heads' tails with
    the position term), ``vggt_outputs`` and ``upsample_route_change``."""
    from port_bench.lib import spec, weights

    t_phase = time.perf_counter()
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "vggt-1b.json")
    arch = spec.architecture(cfg)
    w = weights.make_weights(arch, cfg, 2 ** 31 + 24, "cuda",
                             torch.bfloat16)
    model = arch.build(cfg, w, "cuda")
    w = {k: v.float() for k, v in w.items()}
    model_hw = arch.model_grid(cfg, (H, W))
    cap = VGGTCapture()
    built = (model, model.cfg.aggregator(), model.cfg.dpt())
    out, depth = drive_path("vggt_path", VGGT_VIEWS, VGGT_EXPECT, "vggt",
                            "vggt-1b", built=built, capture=cap,
                            model_hw=model_hw)
    checks = check_anyview(cap, tuple(depth.shape[1:]))
    outputs = vggt_outputs(model, cap.x, w, cfg)
    out.update(kernel_checks=checks, outputs=outputs,
               upsample_vs_plain_route=upsample_route_change(model, cap.x),
               tokens=arch.tokens(cfg, model_hw),
               crossview_tokens=VGGT_VIEWS * arch.tokens(cfg, model_hw),
               depth_quantiles=torch.quantile(
                   depth.flatten()[::97], torch.tensor(
                       [0.01, 0.1, 0.5, 0.9, 0.99], device="cuda")).tolist(),
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    del model, built, cap, depth, w
    return out


# StreamVGGT: the benchmark's streamvggt-1b, one submap of 128 keyframes a
# step in 4 chunks of 32; launches a step; the cached entry point's calls
# whose operands are checked, as (chunk, pair)
STREAM_FRAMES = STREAM_CHUNK * STREAM_CHUNKS
STREAM_CHECKED = ((0, 23), (3, 11), (3, 23))
STREAMVGGT_EXPECT = {"attention": STREAM_CHUNKS * 48,
                     "attention_cached": STREAM_CHUNKS * 24,
                     "qk_prep": STREAM_CHUNKS * 48,
                     "dpt_tail": STREAM_CHUNKS * 2,
                     "residual_norm": STREAM_CHUNKS * RESIDUALS * VGGT_BLOCKS,
                     "upsample": STREAM_CHUNKS * 2 * UPSAMPLES,
                     **INSERT_EXPECT}


class CachedCapture:
    """Keeps the operands (the chunk's qkv after QK-norm and RoPE, the
    cache's rows the call reads) and the result of the cached entry
    point's calls STREAM_CHECKED of a StreamVGGT forward (``pairs`` a
    chunk, in pair order), and the model's input."""

    def __init__(self, pairs: int):
        self.pairs = pairs
        self.calls = {}
        self.x = None

    @contextlib.contextmanager
    def during(self, model, x: torch.Tensor):
        import txr_torch.models.vit as vit

        self.x = x
        real, n = vit.cached_attention, [0]

        def keep(qkv, kv, heads, head_dim, cached, frame):
            out = real(qkv, kv, heads, head_dim, cached, frame)
            at = divmod(n[0], self.pairs)
            n[0] += 1
            if at in STREAM_CHECKED:
                rows = kv[:cached + qkv.shape[1]].clone()
                self.calls[at] = (qkv.clone(), rows, heads, cached, frame,
                                  out.clone())
            return out

        vit.cached_attention = keep
        try:
            yield
        finally:
            vit.cached_attention = real


def streamvggt_path() -> dict:
    """``drive_path`` on StreamVGGT at published widths (the benchmark's
    ``configs/streamvggt-1b.json`` and its seeded weights, built by
    ``archs/streamvggt.py``): STREAM_FRAMES seeded 1080p frames a step at
    294 x 518, one submap through the cache in chunks of STREAM_CHUNK, with
    STREAMVGGT_EXPECT's launches a step; then the cached entry point on the
    staged step's own operands at STREAM_CHECKED against
    ``cached_reference`` in float32, and ``vggt_outputs`` against
    ``port_bench/reference/streamvggt.py`` (the frame-causal forward of
    the whole submap, no cache), and ``upsample_route_change``."""
    from port_bench.lib import spec, weights
    from port_bench.reference import streamvggt as sref

    t_phase = time.perf_counter()
    cfg = spec.load_json(spec.BENCH_DIR / "configs" / "streamvggt-1b.json")
    arch = spec.architecture(cfg)
    w = weights.make_weights(arch, cfg, 2 ** 31 + 26, "cuda",
                             torch.bfloat16)
    model = arch.build(cfg, w, "cuda")
    w = {k: v.float() for k, v in w.items()}
    model_hw = arch.model_grid(cfg, (H, W))
    cap = CachedCapture(model.cfg.pairs)
    built = (model, model.cfg.aggregator(), model.cfg.dpt())
    out, depth = drive_path("streamvggt_path", STREAM_FRAMES,
                            STREAMVGGT_EXPECT, "streamvggt",
                            "streamvggt-1b", built=built, capture=cap,
                            model_hw=model_hw)
    checks = []
    for (c, pair), (qkv, kv, heads, cached, frame, got) in sorted(
            cap.calls.items()):
        s = qkv.shape[1]
        checks.append(compare(
            "attention_cached", f"streamvggt chunk {c} pair {pair}: "
            f"(1, {s}) against {cached + s} keys", got,
            cached_reference(qkv, kv, heads, cached, frame), **ATTN_TOL))
    cap.calls.clear()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    outputs = vggt_outputs(model, cap.x, w, cfg, sref)
    out.update(kernel_checks=checks, outputs=outputs,
               upsample_vs_plain_route=upsample_route_change(model, cap.x),
               reference_s=time.perf_counter() - t0,
               cache_bytes=sum(s.numel() * s.element_size()
                               for s in model.state.slabs),
               tokens=arch.tokens(cfg, model_hw),
               keys_last_chunk=STREAM_FRAMES * arch.tokens(cfg, model_hw),
               depth_quantiles=torch.quantile(
                   depth.flatten()[::97], torch.tensor(
                       [0.01, 0.1, 0.5, 0.9, 0.99], device="cuda")).tolist(),
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    del model, built, cap, depth, w
    return out


# bench.py's batch sweep (bench.py:67-69; 24 its default)
BATCH_SIZES = (16, 24, 32)
BATCH_TOL = dict(
    median=2.0 ** -10, max=2.0 ** -5,
    why="the first 8 frames of a step of 16 to 32 against main_path's "
        "8-frame step on the same frames and weights: every kernel of the "
        "port computes a frame alone, bit for bit, but cuBLAS and cuDNN "
        "choose other algorithms (tiles, split-K) at another M, which sum "
        "in another order in the bf16 layers. Readings on an H100: more "
        "than half of the pixels equal to the bit (median 0), the max "
        "1.06e-2 (bf16) and 1.28e-2 (int8p + convs) of the span; the "
        "bounds are two bf16 steps of the depth's mean over its span and "
        "2.4 times the larger reading")


def batch_path(main_depth: torch.Tensor, quant_depth: torch.Tensor) -> list:
    """``drive_path`` on v2 / ViT-L at BATCH_SIZES frames a step with
    main_path's weights, bf16 and then ``int8p`` + ``TXR_FUSED_CONVS=1``:
    launches asserted as main_path / quant_path, the map within capacity,
    each kernel held to its plain version on the operands the staged step
    of that batch handed it (``check_activations``: blocks 0 and 23, block
    12's dense layers, the tail and the conv sites, every frame of the
    step), the first 8 frames' depth against main_path's / quant_path's,
    at the largest batch every frame's depth against the plain route
    (``plain_route``), and how near the kernels' 32-bit counts come to
    their limits. A line a run."""
    lines = []
    in_h, in_w = compute_da_resize(H, W, 518)
    tokens = (in_h // 14) * (in_w // 14) + 1
    sms = kernels.sm_count(0)
    for label, env, quant, expect, ref in (
            ("bf16", {}, "none", MAIN_EXPECT, main_depth),
            ("int8p+convs", QUANT_ENV, "int8p", QUANT_EXPECT, quant_depth)):
        with scoped_env(env):
            built = build_model("v2", "vitl", dtype=torch.bfloat16,
                                quant=quant, generator=torch.Generator(
                                    device="cpu").manual_seed(0))
        model, vit_cfg, _ = built
        on_kernel = check_policy(model, vit_cfg, label)[
            "dense_layers_on_kernel"]
        for frames in BATCH_SIZES:
            t_phase = time.perf_counter()
            cap = Capture(blocks=(0, vit_cfg.num_layers - 1),
                          int8_block=vit_cfg.num_layers // 2)
            out, depth = drive_path("batch_path", frames, expect,
                                    built=built, capture=cap)
            if len(cap.convs) != (len(CONV_SITES) if env else 0):
                raise AssertionError(f"batch_path {label} {frames}: "
                                     f"{len(cap.convs)} conv sites seen")
            checks = check_activations(cap, vit_cfg,
                                       f"batch {label} {frames}")
            if frames == max(BATCH_SIZES):
                out["depth_vs_plain_route"] = plain_route(
                    "v2", "vitl", quant, model, cap.input, depth, on_kernel)
            first = depth[:ref.shape[0]]
            span = (ref.max() - ref.min()).item()
            diff = (first - ref).abs() / span
            vs = {"frames": ref.shape[0], "bit_equal": torch.equal(first, ref),
                  "differing_share": (first != ref).float().mean().item(),
                  "zero_share": (ref == 0).float().mean().item(),
                  "median_share_of_span": diff.median().item(),
                  "max_share_of_span": diff.max().item(), "limit": BATCH_TOL}
            if (vs["median_share_of_span"] > BATCH_TOL["median"]
                    or vs["max_share_of_span"] > BATCH_TOL["max"]):
                raise AssertionError(f"batch_path {label} {frames}: {vs}")
            tail = tail_geometry(frames, 296, 528, 128, in_h, in_w, sms)
            m = frames * tokens
            int8 = int8_geometry(m, 1024, 4096, sms)
            counts = {
                "tail_work_units": tail["tiles"] * 9 * tail["chunks"],
                "insert_rows": frames * in_h * in_w + (1 << 21),
                "int8_tiles_fc1": int8["tiles"],
                "int8_rows_x_k_fc2": m * 4096, "limit": 2 ** 31 - 1}
            out.update(label=label, vs_8_frame_step=vs,
                       kernel_checks=checks, counts_32_bit=counts,
                       phase_s=time.perf_counter() - t_phase)
            emit(out)
            lines.append(out)
            del depth, first, diff, cap
            torch.cuda.empty_cache()
        del built, model
        torch.cuda.empty_cache()
    return lines


# The V3 metric configuration of BENCH_CONFIGS.json
# (v3_metric_vkitti_video_50pct) and README.md:55, with a fisheye 1080p
# camera's intrinsics given explicitly (as --intrinsics does): depth is the
# metric head's sigmoid x 80 m times ((fx + fy) / 2) / 300 = 1.07, and the
# CLI keeps the points under its 80 m (the seeded head reads 24 to 78 m, a
# camera of twice that focal would keep 0.2 % of the pixels)
V3_CLI = dict(version="v3", encoder="large", metric=True, dataset="vkitti",
              max_depth=80.0)
V3_INTRINSICS = CameraIntrinsics(fx=320.0, fy=322.0, cx=959.5, cy=539.5,
                                 width=W, height=H)
V3_RESCALE_TOL = dict(rtol=1e-6, why="the device multiplies by the focal "
                      "ratio in f32, infer_batch on the host by the same "
                      "ratio rounded to f32: one rounding apart at most")


def v3_metric_cli_path() -> dict:
    """``depth_processor_torch.py --version v3 --encoder large --metric
    --dataset vkitti --max-depth 80`` with intrinsics, as its ``main()``
    builds it, over CLI_FRAMES seeded 1080p frames in point-cloud mode
    (batches of 8 and 4): depth finite and in (0, 80 f / 300] after the
    focal rescale, equal to ``infer_batch``'s host-side rescale, each PLY's
    points held to the depth at the pixel each came from, 24 attention and
    one tail launch a batch."""
    t_phase = time.perf_counter()
    intr = V3_INTRINSICS
    frames = np.random.default_rng(0).integers(
        0, 256, (CLI_FRAMES, H, W, 3), dtype=np.uint8)
    model = DepthAnythingModel(**V3_CLI)
    if not (model.dpt_cfg.metric and model.dpt_cfg.max_depth == 80.0):
        raise AssertionError(f"the V3 model's head: {model.dpt_cfg}")
    focal = (intr.fx + intr.fy) / 2.0 / model.focal_length_ref
    ceiling = float(np.float32(80.0) * np.float32(focal))
    out_dir = tempfile.mkdtemp(prefix="v3_metric_cli_path.")
    try:
        run = run_processor(model, frames, out_dir, batch_size=8,
                            intrinsics=intr, max_depth=V3_CLI["max_depth"])
        counts = run["launches"]
        # one attention and two residual launches a block and one tail
        # launch a batch
        layers = model.vit_cfg.num_layers
        expect = {"attention": layers * 2, "dpt_tail": 2,
                  "residual_norm": RESIDUALS * layers * 2,
                  "upsample": UPSAMPLES * 2}
        if {k: n for k, n in counts.items() if n} != expect:
            raise AssertionError(f"v3_metric_cli_path launched {counts}, "
                                 f"expected {expect}")
        depth = torch.cat(run["depths"]).cpu().numpy()
        if depth.shape != (CLI_FRAMES, H, W) or not np.isfinite(depth).all():
            raise AssertionError(f"V3 depth {depth.shape} is not finite")
        lo, hi = float(depth.min()), float(depth.max())
        # two f32 roundings above the head's 80 m: the bilinear lerp back
        # to the frame's size and the rescale
        if not (0.0 < lo and hi <= ceiling * (1 + 2.0 ** -22)):
            raise AssertionError(f"V3 depth in [{lo}, {hi}], outside (0, "
                                 f"{ceiling}]")
        host = model.infer_batch(frames[:8], intr)
        rescale_err = float(np.abs(host - depth[:8]).max()
                            / np.abs(depth[:8]).max())
        if rescale_err > V3_RESCALE_TOL["rtol"]:
            raise AssertionError(f"device and host rescales differ by "
                                 f"{rescale_err}")
        points, max_err = [], 0.0
        for i in range(CLI_FRAMES):
            path = os.path.join(out_dir, "pointclouds", f"frame_{i:04d}.ply")
            kept = (depth[i] > 0.1) & (depth[i] < V3_CLI["max_depth"])
            if not kept.any():
                # the processor writes no PLY for a frame without a point
                if os.path.exists(path):
                    raise AssertionError(f"frame {i}: a PLY without points")
                points.append(0)
                continue
            pix, xyz, _ = ply_pixels(path, intr)
            if len(pix) != int(kept.sum()) or not kept.reshape(-1)[pix].all():
                raise AssertionError(
                    f"frame {i}: {len(pix)} PLY points, {int(kept.sum())} "
                    "pixels inside (0.1, 80) m")
            z = depth[i].reshape(-1)[pix]
            err = np.abs(xyz[:, 2] - z)
            if (err > PLY_TOL["atol"] + PLY_TOL["rtol"] * np.abs(z)).any():
                raise AssertionError(f"frame {i}: PLY depth differs from "
                                     f"the depth by {err.max()}")
            points.append(len(pix))
            max_err = max(max_err, float(err.max()) if len(err) else 0.0)
        if not sum(points):
            raise AssertionError("no PLY holds a point")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    batches, other_ms = stage_split(run, [8, CLI_FRAMES - 8])
    raw = depth / np.float32(focal)
    out = {"phase": "v3_metric_cli_path", **V3_CLI, "mode": "pointcloud",
           "input": [H, W], "frames": CLI_FRAMES, "batch_size": 8,
           "intrinsics": {"fx": intr.fx, "fy": intr.fy, "cx": intr.cx,
                          "cy": intr.cy},
           "focal_rescale": focal, "depth_m": {
               "min": lo, "median": float(np.median(depth)), "max": hi,
               "ceiling": ceiling},
           "head_m_before_rescale": {
               "quantiles_0_10_50_90_100": [float(q) for q in np.quantile(
                   raw, [0.0, 0.1, 0.5, 0.9, 1.0])],
               "share_within_1pct_of_80": float((raw > 79.2).mean())},
           "device_vs_host_rescale_rel_err": rescale_err,
           "ply_points_per_frame": points,
           "ply_share_of_pixels": sum(points) / (CLI_FRAMES * H * W),
           "ply_vs_depth_max_abs_err_m": max_err, "ply_tolerance": PLY_TOL,
           "wall_s": run["wall_s"],
           "frames_per_second": CLI_FRAMES / run["wall_s"],
           "per_batch": batches, "other_host_ms": other_ms,
           "peak_memory_bytes": max(run["peak_bytes"]),
           "launches": counts, "launches_over_steps": 2,
           "phase_s": time.perf_counter() - t_phase, "ok": True}
    emit(out)
    del model
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------- sparse SfM

# The fusion CLI's operating point (depth_to_reconstruction.py:31-34 and
# txr/core/config.py:25-31): portrait 1080 x 1920 frames, K fx = fy = 1719,
# cx 540, cy 960; SIFT capacity 8192, 8000 features, contrast 0.01, edge 15,
# CLAHE on; ratio 0.75; TXR_PAIR_CAP 4096; 1024 hypotheses, 3 px, depth
# range 0.1 to 50 (in units of the pair's baseline, |t| = 1).
SFM_H, SFM_W = 1920, 1080
SFM_K = (1719.0, 1719.0, 540.0, 960.0)
SFM_FRAMES = 8
SFM_SIFT = dict(n_features=8000, contrast_threshold=0.01, edge_threshold=15,
                use_clahe=True, capacity=8192)
SFM_RANSAC = dict(match_ratio=0.75, ransac_threshold=3.0, min_depth=0.1,
                  max_depth=50.0, num_hypotheses=1024)
# The scene: a floor 1.4 m below the camera and a wall 3.4 m ahead, seen
# pitched 30 degrees down (depths 1.4 to 3.7 m, the wall the top 38 % of
# the frame, about 55 % of the matches: no plane holds the 70 % that makes
# pair_step take the homography, so the essential matrix is the right
# model); 8 cm sideways and 0.2 degrees of yaw a frame; 1 cm texture
# blocks. Relative depth is the metric depth over 6, so the true scale is
# 6 / 0.08 = 75 (the pair's |t| is 1), and every point stays inside the
# depth range of 50 baselines (4 m).
SFM_SCENE = dict(cam_height=1.4, wall_z=3.4, pitch_deg=30.0, baseline=0.08,
                 yaw_deg=0.2, depth_div=6.0, blocks_per_m=100.0)
SFM_TOL = dict(scale_rel=0.02, rot_deg=0.5, t_dir_deg=10.0,
               why="scale and rotation as the slice asks (the CPU golden "
                   "test allows 5 % at 256 x 192). The direction of t only "
                   "against a gross failure: a sideways baseline leaves its "
                   "forward part weakly determined, and one mismatch that a "
                   "winning hypothesis admits at its 3 px threshold turns "
                   "t by 6 degrees (R by 0.14) in txr as in the port: "
                   "RANSAC refits and refines on every inlier, unweighted")
# card against the port on the CPU, on the same inputs (tests/
# test_torch_sfm.py holds the CPU port to txr at the same tolerances)
SFM_PARITY_TOL = dict(uv_px=1e-2, desc=1.0, pose=1e-4, scale_rel=1e-5,
                      keypoint_flips=0.01,
                      why="SIFT from the BGR frame: the detector tolerances "
                          "of tests/test_torch_features.py, uv 1e-2 px and "
                          "descriptors 1.0 of 255 (CLAHE may round a blend "
                          "one grey level the other way, and cuDNN and "
                          "cuBLAS sum in another order); a keypoint whose "
                          "DoG test sits at a threshold may flip (at most "
                          "1 %). Then the CPU's features through both: the "
                          "same matches and masks, R and t 1e-4, scales "
                          "1e-5 relative")


def _rot(axis: int, deg: float) -> np.ndarray:
    a = np.radians(deg)
    c, s = np.cos(a), np.sin(a)
    i, j = [k for k in range(3) if k != axis]
    r = np.eye(3)
    r[i, i], r[i, j], r[j, i], r[j, j] = c, -s, s, c
    return r


def two_plane_scene(h: int, w: int, K: tuple, frames: int, device,
                    seed: int = 0, cams=None, **overrides) -> dict:
    """Frames of a textured floor and wall with their ground truth.

    World axes x right, y down, z ahead; camera i sits at
    (i * baseline, 0, 0), pitched down by ``pitch_deg`` and turned by
    ``i * yaw_deg`` about y. Each pixel's ray meets the floor (y =
    cam_height) or the wall (z = wall_z), whichever is nearer; the colour
    is the plane's texture there (blocky noise, ``blocks_per_m`` blocks a
    metre, nearest-upsampled 4x, sampled bilinearly by ``grid_sample``: a
    homography warp per plane). ``cams``: the camera index of each frame
    (default ``range(frames)``), so a trajectory may revisit a camera.
    Returns BGR uint8 frames, metric depth, the plane of each pixel (0
    wall, 1 floor), world -> camera poses (float64 numpy) and the scene's
    parameters."""
    p = dict(SFM_SCENE, **overrides)
    fx, fy, cx, cy = K
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def texture(blocks):
        t = torch.randint(0, 256, (1, 3, blocks, blocks), generator=gen)
        return F.interpolate(t.float(), scale_factor=4,
                             mode="nearest").to(device)

    n_blocks = int(6.0 * p["blocks_per_m"])     # both textures span 6 m
    wall_tex, floor_tex = texture(n_blocks), texture(n_blocks)
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device),
                          indexing="ij")
    rays = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)],
                       dim=-1)                              # camera frame
    pitch = _rot(0, -p["pitch_deg"])      # camera y, z turned towards +y
    bgr, depth, label, Rs, ts = [], [], [], [], []
    for i in (range(frames) if cams is None else cams):
        c2w = _rot(1, i * p["yaw_deg"]) @ pitch
        centre = np.array([i * p["baseline"], 0.0, 0.0])
        d = rays @ torch.from_numpy(c2w.T).to(device)       # world rays
        s_floor = torch.where(d[..., 1] > 1e-9,
                              p["cam_height"] / d[..., 1], torch.inf)
        s_wall = torch.where(d[..., 2] > 1e-9, p["wall_z"] / d[..., 2],
                             torch.inf)
        floor = s_floor < s_wall
        s = torch.where(floor, s_floor, s_wall)
        hit = torch.from_numpy(centre).to(device) + s[..., None] * d
        # texture coordinates in [-1, 1]: wall (x, y) over [-3, 3] m,
        # floor (x, z) over [-3, 3] x [0, 6] m
        g_wall = torch.stack([hit[..., 0] / 3, hit[..., 1] / 3], -1)
        g_floor = torch.stack([hit[..., 0] / 3, hit[..., 2] / 3 - 1], -1)
        colour = torch.where(
            floor[None, None],
            F.grid_sample(floor_tex, g_floor[None].float(), mode="bilinear",
                          padding_mode="border", align_corners=False),
            F.grid_sample(wall_tex, g_wall[None].float(), mode="bilinear",
                          padding_mode="border", align_corners=False))
        bgr.append(colour[0].permute(1, 2, 0).round().clamp(0, 255).to(
            torch.uint8))
        depth.append(s.float())       # rays have z = 1 in the camera frame
        label.append(floor.to(torch.uint8))
        Rs.append(c2w.T)
        ts.append(-c2w.T @ centre)
    return {"bgr": torch.stack(bgr), "depth": torch.stack(depth),
            "label": torch.stack(label), "R": np.stack(Rs), "t": np.stack(ts),
            "params": p}


def relative_truth(R: np.ndarray, t: np.ndarray) -> tuple:
    """Per consecutive pair, the true relative rotation and the unit
    direction of the relative translation (camera p to camera p + 1)."""
    R_rel = R[1:] @ np.swapaxes(R[:-1], 1, 2)
    t_rel = t[1:] - np.einsum("pij,pj->pi", R_rel, t[:-1])
    return R_rel, t_rel / np.linalg.norm(t_rel, axis=-1, keepdims=True)


def angle_deg(R_a: np.ndarray, R_b: np.ndarray) -> float:
    c = (np.trace(R_a.T @ R_b) - 1.0) / 2.0
    return float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0))))


def stack_features(feats: list) -> tuple:
    return (torch.stack([f.desc for f in feats]),
            torch.stack([f.mask for f in feats]),
            torch.stack([f.uv for f in feats]))


def chain_views(R_rel: np.ndarray, t_rel: np.ndarray, n_match: np.ndarray,
                n_inl: np.ndarray) -> tuple:
    """The fusion pipeline's host pose chain with the reference's skip rules
    (txr/pipelines/fusion_pipeline.py:536-560): R_prev[p] / t_prev[p] is the
    last successful pose before view p + 1. Returns (R_prev, t_prev,
    processed views)."""
    P = len(R_rel)
    poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
             (R_rel[0], t_rel[0])]
    R_prev = np.tile(np.eye(3, dtype=np.float32), (P, 1, 1))
    t_prev = np.zeros((P, 3), np.float32)
    processed = []
    for i in range(2, P + 1):
        p = i - 1
        if n_match[p] < 8 or n_inl[p] < 8:
            continue
        Rp, tp = poses[-1]
        R_prev[p], t_prev[p] = Rp, tp
        poses.append((R_rel[p] @ Rp, R_rel[p] @ tp + t_rel[p]))
        processed.append(i)
    return R_prev, t_prev, processed


def run_sparse(desc, fmask, fuv, depths, K, generator=None,
               priorities=None, no_sync: bool = False) -> dict:
    """The fusion CLI's sparse stages: every pair, the host chain, the
    scales. With ``no_sync`` the pair and scale stages run under
    ``torch.cuda.set_sync_debug_mode("error")``: any read of a value back
    to the host inside them raises."""
    cfg = SFM_RANSAC
    on_card = desc.device.type == "cuda"

    def guarded(fn):
        if not (no_sync and on_card):
            return fn()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)

    t0 = time.perf_counter()
    pairs = guarded(lambda: _pairs_batch(
        desc, fmask, fuv, K, generator, cfg["match_ratio"],
        cfg["ransac_threshold"], cfg["min_depth"], cfg["max_depth"],
        num_hypotheses=cfg["num_hypotheses"], priorities=priorities))
    R_rel, t_rel, X, valid, n_inl, n_match, uv1, uv2, ok = pairs
    if on_card:
        torch.cuda.synchronize()
    pairs_s = time.perf_counter() - t0
    R_h, t_h, ni_h, nm_h = (a.cpu().numpy() for a in
                            (R_rel, t_rel, n_inl, n_match))
    R_prev, t_prev, processed = chain_views(R_h, t_h, nm_h, ni_h)
    R_prev, t_prev = (torch.from_numpy(a).to(X.device)
                      for a in (R_prev, t_prev))
    t0 = time.perf_counter()
    s1, s2, n_valid0, sw, ok_n = guarded(lambda: _scales_batch(
        X, valid, uv1, uv2, depths, R_prev, t_prev))
    s1, s2, sw = clamp_scale(s1), clamp_scale(s2), clamp_scale(sw)
    if on_card:
        torch.cuda.synchronize()
    scales_s = time.perf_counter() - t0
    return {"R": R_h, "t": t_h, "X": X, "valid": valid, "n_inl": ni_h,
            "n_match": nm_h, "uv1": uv1, "uv2": uv2, "ok": ok,
            "s1": float(s1), "s2": float(s2), "n_valid0": int(n_valid0),
            "sw": sw.cpu().numpy(), "ok_n": ok_n.cpu().numpy(),
            "processed": processed, "pairs_s": pairs_s,
            "scales_s": scales_s}


def model_choice(uv1, uv2, ok, K, prio_e, prio_h) -> dict:
    """pair_step's model selection recomputed on a pair's rows with the
    priorities it drew: n_E, n_H and whether the homography won."""
    thr = SFM_RANSAC["ransac_threshold"]
    hyp = SFM_RANSAC["num_hypotheses"]
    _, inl_e = essential_ransac(uv1, uv2, ok, K, None, thr, hyp,
                                priorities=prio_e)
    H, _ = homography_ransac(uv1, uv2, ok, None, max(thr, 3.0), hyp,
                             priorities=prio_h)
    n_h = int((ok & (transfer_error(H, uv1, uv2) < 2.0 * thr ** 2)).sum())
    n_e = int(inl_e.sum())
    return {"n_E": n_e, "n_H": n_h, "model": "H" if n_h > 0.7 * n_e else "E"}


def plane_share(scene: dict, p: int, uv1: torch.Tensor,
                ok: torch.Tensor) -> float:
    """Share of pair p's matches whose keypoint in view p lies on the
    larger of the two planes (ground truth)."""
    u = uv1[:, 0].round().long().clamp(0, scene["label"].shape[2] - 1)
    v = uv1[:, 1].round().long().clamp(0, scene["label"].shape[1] - 1)
    lab = scene["label"][p].to(uv1.device)[v, u].float()
    okf = ok.float()
    floor = float((lab * okf).sum() / okf.sum().clamp(min=1))
    return max(floor, 1.0 - floor)


def kernel_breakdown(fn, top: int = 12) -> dict:
    """One call of ``fn`` under ``torch.profiler``: launches, device time
    and wall time (ms), and the ``top`` kernels by device time with their
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    # the raw device events: building the profiler's event tree
    # (``prof.events()``) is slow at hundreds of thousands of launches
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        name = e.name()[:90]
        row = by_name.setdefault(name, {"name": name, "calls": 0,
                                        "ms": 0.0})
        row["calls"] += 1
        row["ms"] += e.duration_ns() / 1e6
    rows = sorted(by_name.values(), key=lambda r: -r["ms"])
    return {"launches": sum(r["calls"] for r in rows),
            "device_ms": sum(r["ms"] for r in rows),
            "wall_ms_under_profiler": wall_ms, "kernels_by_device_ms":
            rows[:top], "rest_ms": sum(r["ms"] for r in rows[top:])}


def count_kernels(fn) -> tuple:
    """Kernel launches of one call of ``fn`` under ``torch.profiler``, its
    device time and its wall time under the profiler (ms)."""
    b = kernel_breakdown(fn, top=0)
    return b["launches"], b["device_ms"], b["wall_ms_under_profiler"]


def compare_keypoints(f_card, f_cpu) -> dict:
    """Card against CPU SIFT of one frame: keypoints matched by position
    (1e-2 px); the rest flipped at a threshold."""
    a_uv = f_card.uv[f_card.mask].cpu().double()
    b_uv = f_cpu.uv[f_cpu.mask].double()
    d = torch.cdist(a_uv, b_uv)
    near, j = d.min(dim=1)
    pair = near < 1e-2
    flips = int((~pair).sum()) + (len(b_uv) - int(pair.sum()))
    desc_a = f_card.desc[f_card.mask].cpu()[pair]
    desc_b = f_cpu.desc[f_cpu.mask][j[pair]]
    return {"valid_card": len(a_uv), "valid_cpu": len(b_uv),
            "flipped": flips,
            "uv_max_err_px": float(near[pair].max()) if pair.any() else 0.0,
            "desc_max_err": float((desc_a - desc_b).abs().max())
            if pair.any() else 0.0}


def sfm_parity(gen_seed: int) -> dict:
    """The port on the card against the port on the CPU: 2 frames of
    480 x 640 (W x H) of the scene, SIFT on both, then the CPU's features
    through the pair and scale stages on both with the same priorities."""
    s = 480 / SFM_W
    K4 = (SFM_K[0] * s, SFM_K[1] * s, SFM_K[2] * s, SFM_K[3] * s)
    scene = two_plane_scene(640, 480, K4, 2, "cpu", seed=1)
    depths = scene["depth"] / SFM_SCENE["depth_div"]
    cpu = SIFTDetector(**SFM_SIFT, backend="device", device="cpu")
    card = SIFTDetector(**SFM_SIFT, backend="device")
    f_cpu = cpu.detect_batch(scene["bgr"])
    f_card = card.detect_batch(scene["bgr"].cuda())
    kp = [compare_keypoints(a, b) for a, b in zip(f_card, f_cpu)]
    for k in kp:
        if (k["flipped"] > SFM_PARITY_TOL["keypoint_flips"]
                * max(k["valid_cpu"], 1) or k["uv_max_err_px"]
                > SFM_PARITY_TOL["uv_px"]
                or k["desc_max_err"] > SFM_PARITY_TOL["desc"]):
            raise AssertionError(f"sfm parity: SIFT on the card against the "
                                 f"CPU: {k}")
    desc, fmask, fuv = stack_features(f_cpu)
    Kt = torch.tensor([[K4[0], 0, K4[2]], [0, K4[1], K4[3]], [0, 0, 1]],
                      dtype=torch.float32)
    rows = min(int(os.environ.get("TXR_PAIR_CAP", "4096")) or desc.shape[1],
               desc.shape[1])
    prio = torch.rand((1, 2, SFM_RANSAC["num_hypotheses"], rows),
                      generator=torch.Generator().manual_seed(gen_seed))
    got = run_sparse(desc.cuda(), fmask.cuda(), fuv.cuda(), depths.cuda(),
                     Kt.cuda(), priorities=prio.cuda(), no_sync=True)
    want = run_sparse(desc, fmask, fuv, depths, Kt, priorities=prio)
    same_ok = torch.equal(got["ok"].cpu(), want["ok"])
    okm = want["ok"][0]
    uv2_err = float((got["uv2"].cpu()[0][okm] - want["uv2"][0][okm])
                    .abs().max())
    same_valid = torch.equal(got["valid"].cpu(), want["valid"])
    pose_err = max(float(np.abs(got["R"] - want["R"]).max()),
                   float(np.abs(got["t"] - want["t"]).max()))
    scale_err = max(abs(got[k] / want[k] - 1.0) for k in ("s1", "s2"))
    out = {"frames": 2, "input": [640, 480], "keypoints": kp,
           "matches_equal": same_ok, "matched_uv2_max_err_px": uv2_err,
           "n_match": int(want["n_match"][0]),
           "valid_equal": same_valid, "n_valid": int(want["n_valid0"]),
           "pose_max_abs_err": pose_err, "scale_max_rel_err": scale_err,
           "scales_card": [got["s1"], got["s2"]],
           "scales_cpu": [want["s1"], want["s2"]],
           "tolerance": SFM_PARITY_TOL}
    if not (same_ok and uv2_err == 0.0 and same_valid
            and pose_err <= SFM_PARITY_TOL["pose"]
            and scale_err <= SFM_PARITY_TOL["scale_rel"]):
        raise AssertionError(f"sfm parity: card against CPU {out}")
    return out


def sfm_geometry_runs(desc, fmask, fuv, depths, K, seed: int) -> dict:
    """The pair and scale stages on fixed features under other TF32
    settings of the process: PyTorch's defaults (matmul off, cuDNN on) and
    both on; and, as a control, both on with ``TXR_F32_DOTS=0``."""
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    out = {}
    try:
        for name, (mm, dnn, dots) in {
                "off_off": (False, False, "1"),
                "defaults": (False, True, "1"),
                "on_on": (True, True, "1"),
                "on_on_f32_dots_disabled": (True, True, "0")}.items():
            flags[0].allow_tf32, flags[1].allow_tf32 = mm, dnn
            os.environ["TXR_F32_DOTS"] = dots
            out[name] = run_sparse(
                desc, fmask, fuv, depths, K,
                generator=torch.Generator(device="cuda").manual_seed(seed))
    finally:
        flags[0].allow_tf32, flags[1].allow_tf32 = saved
        os.environ.pop("TXR_F32_DOTS", None)
    return out


def sfm_check_truth(run: dict, R_true, t_dir) -> tuple:
    """Per pair rotation error and translation-direction angle, per view
    scale against the truth; returns (pairs, views, worst)."""
    truth = SFM_SCENE["depth_div"] / SFM_SCENE["baseline"]
    pairs = []
    for p in range(len(run["R"])):
        cosang = float(np.clip(run["t"][p] @ t_dir[p], -1.0, 1.0))
        pairs.append({"pair": [p, p + 1],
                      "rot_err_deg": angle_deg(run["R"][p], R_true[p]),
                      "t_dir_err_deg": float(np.degrees(np.arccos(cosang))),
                      "matches": int(run["n_match"][p]),
                      "inliers": int(run["n_inl"][p])})
    views = [{"view": 0, "scale": run["s1"]}, {"view": 1, "scale": run["s2"]}]
    views += [{"view": i, "scale": float(run["sw"][i - 1]),
               "samples": int(run["ok_n"][i - 1])} for i in run["processed"]]
    for v in views:
        v["rel_err"] = v["scale"] / truth - 1.0
    worst = {"rot_err_deg": max(r["rot_err_deg"] for r in pairs),
             "t_dir_err_deg": max(r["t_dir_err_deg"] for r in pairs),
             "scale_rel_err": max(abs(v["rel_err"]) for v in views),
             "true_scale": truth}
    return pairs, views, worst


def sfm_path() -> dict:
    """The fusion CLI's sparse path on the card at its operating point: 8
    frames of 1080 x 1920 -> grey -> CLAHE -> SIFT -> ratio matching ->
    essential + homography RANSAC with model selection -> pose -> refine
    -> triangulation -> world transform -> per-view metric scale, held
    against the scene's ground truth, against the port on the CPU, and
    under the process's other TF32 settings."""
    dev = torch.device("cuda")
    K = torch.tensor([[SFM_K[0], 0, SFM_K[2]], [0, SFM_K[1], SFM_K[3]],
                      [0, 0, 1]], dtype=torch.float32, device=dev)
    scene = two_plane_scene(SFM_H, SFM_W, SFM_K, SFM_FRAMES, dev)
    depths = scene["depth"] / SFM_SCENE["depth_div"]
    R_true, t_dir = relative_truth(scene["R"], scene["t"])
    detector = SIFTDetector(**SFM_SIFT)
    if detector.backend != "device" or detector.device.type != "cuda":
        raise AssertionError(f"SIFTDetector resolved to {detector.backend} "
                             f"on {detector.device}")
    frames = scene["bgr"]
    kernels.reset_launches()

    # warm-up: cuDNN picks its convolutions, the allocator fills
    detector.detect(frames[0])
    warm = stack_features(detector.detect_batch(frames[:2]))
    run_sparse(*warm, depths[:2], K, torch.Generator(device=dev).manual_seed(9))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    t_start = time.perf_counter()
    feats, det_ms = [], []
    for i in range(SFM_FRAMES):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        feats.append(detector.detect(frames[i]))
        b.record()
        torch.cuda.synchronize()
        det_ms.append(a.elapsed_time(b))
    desc, fmask, fuv = stack_features(feats)
    seed = 0
    run = run_sparse(desc, fmask, fuv, depths, K,
                     torch.Generator(device=dev).manual_seed(seed),
                     no_sync=True)
    wall_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kernels.launches)
    if any(launches.values()):
        raise AssertionError(f"sfm_path launched port kernels: {launches}")

    # ground truth; the model each pair chose, from the priorities it drew
    pairs, views, worst = sfm_check_truth(run, R_true, t_dir)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = run["uv1"].shape[1]
    for p, row in enumerate(pairs):
        prio = [torch.rand((SFM_RANSAC["num_hypotheses"], rows),
                           generator=gen, device=dev) for _ in range(2)]
        choice = model_choice(run["uv1"][p], run["uv2"][p], run["ok"][p], K,
                              *prio)
        share = plane_share(scene, p, run["uv1"][p], run["ok"][p])
        expect = "H" if share > 0.8 else "E" if share < 0.6 else "either"
        row.update(choice, larger_plane_share=share, expected_model=expect)
    wrong = [r for r in pairs if r["expected_model"] not in
             ("either", r["model"])]
    if (worst["rot_err_deg"] > SFM_TOL["rot_deg"]
            or worst["t_dir_err_deg"] > SFM_TOL["t_dir_deg"]
            or worst["scale_rel_err"] > SFM_TOL["scale_rel"] or wrong
            or len(run["processed"]) != SFM_FRAMES - 2):
        raise AssertionError(f"sfm_path against ground truth: {worst}, "
                             f"pairs {pairs}, views {views}")

    # stage times at the path's shapes
    p0 = (desc[0], desc[1], fmask[0], fmask[1])
    match_ms = time_ms(lambda: match_l2_ratio(*p0, 0.75), runs=5)
    u1c, u2c, okc = run["uv1"][0], run["uv2"][0], run["ok"][0]

    def one_pair():
        return pair_step(u1c, u2c, okc, K,
                         torch.Generator(device=dev).manual_seed(1),
                         SFM_RANSAC["ransac_threshold"],
                         SFM_RANSAC["min_depth"], SFM_RANSAC["max_depth"],
                         num_hypotheses=SFM_RANSAC["num_hypotheses"])

    pair_ms = time_ms(one_pair, runs=3)
    R_prev = torch.eye(3, device=dev).expand(SFM_FRAMES - 1, 3, 3)
    t_prev = torch.zeros((SFM_FRAMES - 1, 3), device=dev)
    scales_ms = time_ms(lambda: _scales_batch(
        run["X"], run["valid"], run["uv1"], run["uv2"], depths, R_prev,
        t_prev), runs=5)
    sift_launches, sift_dev_ms, sift_wall = count_kernels(
        lambda: detector.detect(frames[0]))
    pair_launches, pair_dev_ms, pair_wall = count_kernels(one_pair)
    match_launches, match_dev_ms, _ = count_kernels(
        lambda: match_l2_ratio(*p0, 0.75))
    sc_launches, sc_dev_ms, _ = count_kernels(lambda: _scales_batch(
        run["X"], run["valid"], run["uv1"], run["uv2"], depths, R_prev,
        t_prev))
    n_pairs = SFM_FRAMES - 1
    device_ms = (SFM_FRAMES * sift_dev_ms
                 + n_pairs * (match_dev_ms + pair_dev_ms) + sc_dev_ms)

    # the same stages under the process's other TF32 settings
    runs = sfm_geometry_runs(desc, fmask, fuv, depths, K, seed)
    base = runs["off_off"]
    precision = {}
    for name, r in runs.items():
        diff = {"R": float(np.abs(r["R"] - base["R"]).max()),
                "t": float(np.abs(r["t"] - base["t"]).max()),
                "scale_rel": max(abs(r[k] / base[k] - 1.0)
                                 for k in ("s1", "s2")),
                "view_scale_rel": float(np.abs(r["sw"] / base["sw"] - 1.0)
                                        [np.array(run["processed"]) - 1]
                                        .max()),
                "bit_equal": bool(np.array_equal(r["R"], base["R"])
                                  and np.array_equal(r["t"], base["t"])
                                  and r["s1"] == base["s1"]
                                  and np.array_equal(r["sw"], base["sw"]))}
        precision[name] = diff
        if name in ("defaults", "on_on") and (
                diff["R"] > 1e-6 or diff["t"] > 1e-6
                or diff["scale_rel"] > 1e-6 or diff["view_scale_rel"] > 1e-6):
            raise AssertionError(f"sfm_path: TF32 setting {name} moved the "
                                 f"geometry: {diff}")
    # the whole path, SIFT included, with both TF32 switches on: SIFT and
    # CLAHE are not under f32_dots (as in txr), so keypoints may move
    flags = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = [f.allow_tf32 for f in flags]
    try:
        flags[0].allow_tf32 = flags[1].allow_tf32 = True
        f_on = stack_features(detector.detect_batch(frames))
        r_on = run_sparse(*f_on, depths, K,
                          torch.Generator(device=dev).manual_seed(seed))
    finally:
        flags[0].allow_tf32, flags[1].allow_tf32 = saved
    _, _, worst_on = sfm_check_truth(r_on, R_true, t_dir)
    precision["whole_path_on_on"] = {
        "against_truth": worst_on,
        "keypoints_valid": [int(m.sum()) for m in f_on[1]],
        "keypoints_valid_off_off": [int(m.sum()) for m in fmask]}
    if (worst_on["rot_err_deg"] > SFM_TOL["rot_deg"]
            or worst_on["scale_rel_err"] > SFM_TOL["scale_rel"]):
        raise AssertionError(f"sfm_path with TF32 on: {worst_on}")

    parity = sfm_parity(seed)
    out = {"phase": "sfm_path", "input": [SFM_H, SFM_W], "K": list(SFM_K),
           "frames": SFM_FRAMES, "sift": SFM_SIFT, "ransac": SFM_RANSAC,
           "pair_cap_rows": rows, "scene": scene["params"],
           "tolerance": SFM_TOL, "pairs": pairs, "views": views,
           "worst": worst, "keypoints_valid": [int(m.sum()) for m in fmask],
           "wall_s": wall_s, "pairs_s": run["pairs_s"],
           "scales_s": run["scales_s"],
           "sift_ms_per_frame": statistics.mean(det_ms),
           "sift_ms_per_frame_each": det_ms,
           "match_ms_per_pair": match_ms, "pair_step_ms_per_pair": pair_ms,
           "scales_batch_ms": scales_ms,
           "launches_per_frame_sift": sift_launches,
           "launches_per_pair_match": match_launches,
           "launches_per_pair_step": pair_launches,
           "launches_scales_batch": sc_launches,
           "device_ms_per_frame_sift": sift_dev_ms,
           "device_ms_per_pair": match_dev_ms + pair_dev_ms,
           "device_ms_scales_batch": sc_dev_ms,
           "wall_ms_under_profiler": {"sift_frame": sift_wall,
                                      "pair_step": pair_wall},
           "device_busy_share": device_ms / (wall_s * 1e3),
           "peak_memory_bytes": peak, "no_host_sync": True,
           "precision": precision, "card_vs_cpu": parity,
           "launches": launches, "launches_over_steps": 1, "ok": True}
    emit(out)
    return out


# ------------------------------------------------------------- fusion CLI
# fusion_cli_path: depth_to_reconstruction_torch.py's pipeline at the CLI's
# defaults (ReconstructionConfig: the intrinsics above, --subsample 2,
# --voxel-size 0.005) on sfm_path's scene: 8 views, so 8 padded pairs and 9
# views of 518,400 rows (4,665,600 rows, the single-pass route).
FUSION_VIEWS = SFM_FRAMES
FUSION_TOL = dict(plane_m=1e-4, host_m=1e-4, chunk_m=1e-4,
                  chunk_count_rel=1e-3,
                  why="a voxel mean of points of one plane lies on that "
                      "plane up to f32 round-off (coordinates up to 6 m: "
                      "ulp 5e-7); the same rows summed in float64 on the "
                      "host, and by the chunked route, agree to a few ulps "
                      "of the sums of up to a few dozen rows; the outlier "
                      "pass may move points on its threshold")
CHUNK_SINGLE_ROWS = 4194304      # TXR_DENSE_SINGLE_ROWS of the chunked check


class StageTimer:
    """Brackets every call of some functions with CUDA events, so a run's
    stages are timed on the device clock without a sync; ``ms()`` reads the
    events after the run."""

    def __init__(self):
        self.events, self.outputs, self.inputs, self._saved = {}, {}, {}, []

    def wrap(self, owner, attr: str, stage: str, keep_output=False,
             keep_input=False):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            out = fn(*args, **kwargs)
            b.record()
            self.events.setdefault(stage, []).append((a, b))
            if keep_output:
                self.outputs.setdefault(stage, []).append(out)
            if keep_input:
                self.inputs.setdefault(stage, []).append((args, kwargs))
            return out

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, timed)

    def restore(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []

    def ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: {"ms": sum(a.elapsed_time(b) for a, b in v),
                    "calls": len(v)} for k, v in self.events.items()}


def plane_distance(xyz_world: torch.Tensor) -> torch.Tensor:
    """Distance (m) of world points to the nearer of the scene's two
    planes (floor y = cam_height, wall z = wall_z)."""
    p = SFM_SCENE
    return torch.minimum((xyz_world[:, 1] - p["cam_height"]).abs(),
                         (xyz_world[:, 2] - p["wall_z"]).abs())


def host_voxel_means(rows: np.ndarray, voxel: float) -> np.ndarray:
    """float64 per-voxel means of f32 rows keyed as the port keys them (f32
    (xyz - min) / voxel, floored), in ascending voxel order."""
    k = np.floor((rows - rows.min(0)) / np.float32(voxel)).astype(np.int64)
    if k.max() >= 1 << 21:
        raise AssertionError("host_voxel_means: extent beyond 2^21 voxels")
    packed = (k[:, 0] << 42) | (k[:, 1] << 21) | k[:, 2]
    order = np.argsort(packed, kind="stable")
    ps = packed[order]
    starts = np.flatnonzero(np.r_[True, ps[1:] != ps[:-1]])
    sums = np.add.reduceat(rows[order].astype(np.float64), starts, axis=0)
    cnt = np.diff(np.r_[starts, len(ps)])
    return sums / cnt[:, None]


def scan_inputs(flat: PointSet, voxel: float) -> tuple:
    """The sorted columns and segment starts that voxel_downsample hands
    the scan kernel for these rows."""
    kx, ky, kz = _voxel_keys(flat.xyz, flat.mask, voxel)
    perm = lexsort3(kx, ky, kz)
    cols = tuple(c[perm] for c in _weighted_cols(flat))
    sk = torch.stack([kx, ky, kz], 1)[perm]
    starts = torch.cat([torch.ones(1, dtype=torch.bool, device=sk.device),
                        (sk[1:] != sk[:-1]).any(1)])
    return cols, starts


def global_cumsum_means(flat: PointSet, voxel: float) -> torch.Tensor:
    """txr's route for the same reduce (``txr/ops/segment.py:68-80``): one
    global f32 cumulative sum of the sorted rows, segment sums as
    differences at the segment ends. A diagnostic, not the port's code."""
    cols, starts = scan_inputs(flat, voxel)
    last = torch.cat([starts[1:], starts.new_ones((1,))])
    ends = torch.cumsum(torch.stack(cols, 1), 0, dtype=torch.float32)[last]
    sums = ends - torch.cat([ends.new_zeros((1, 7)), ends[:-1]])
    valid = sums[:, 6] > 0
    return sums[valid, :3] / sums[valid, 6:7]


def fusion_cli_path() -> dict:
    """depth_to_reconstruction_torch.py's pipeline on the card: 8 views of
    1080 x 1920 of sfm_path's scene, filled in as ``load_data`` would
    (the machine has no image codec), ``reconstruct()`` and
    ``save_reconstruction()``; poses and scales held to the scene's truth;
    the dense stage on the true poses held to the true planes, to a
    float64 host reduce and to the chunked route."""
    dev = torch.device("cuda")
    cfg = ReconstructionConfig()
    if (cfg.fx, cfg.fy, cfg.cx, cfg.cy) != SFM_K:
        raise AssertionError("the CLI's default intrinsics moved")
    scene = two_plane_scene(SFM_H, SFM_W, SFM_K, FUSION_VIEWS, dev)
    rel = scene["depth"] / SFM_SCENE["depth_div"]
    images = list(scene["bgr"].cpu().numpy())
    depths = list(rel.cpu().numpy())

    def pipeline():
        pipe = DepthToReconstructionPipeline(cfg)
        pipe.images, pipe.depths = list(images), list(depths)
        pipe.image_names = [f"view_{i:02d}.png" for i in range(len(images))]
        return pipe

    pipe = pipeline()
    backend = pipe.detector.backend
    if backend != "device" or pipe.device.type != "cuda":
        raise AssertionError(f"the pipeline resolved to {backend} on "
                             f"{pipe.device}")
    from txr_torch.ops import grid_knn, scan, segment
    import txr_torch.pipelines.fusion_pipeline as fp

    timer = StageTimer()
    timer.wrap(pipe.detector, "detect_batch", "features")
    timer.wrap(fp, "_pairs_batch", "pairs")
    timer.wrap(fp, "_scales_batch", "scales")
    timer.wrap(fp, "_dense_merge_batch", "dense_merge", keep_input=True)
    timer.wrap(fp, "backproject_views", "dense.backprojection")
    timer.wrap(fp, "voxel_downsample", "dense.voxel_downsample",
               keep_output=True)
    timer.wrap(segment, "lexsort3", "dense.three_key_sort")
    timer.wrap(scan, "segmented_cumsum_cols", "dense.scan", keep_input=True)
    timer.wrap(grid_knn, "auto_cell", "dense.auto_cell")
    timer.wrap(grid_knn, "grid_knn_mean_distance", "dense.grid_knn")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    narration = io.StringIO()
    try:
        with contextlib.redirect_stdout(narration):
            t0 = time.perf_counter()
            points, colors, poses = pipe.reconstruct()
            wall_s = time.perf_counter() - t0
    finally:
        timer.restore()
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    stages = timer.ms()
    vox = timer.outputs["dense.voxel_downsample"][0]
    n_voxels = int(vox.mask.sum())
    if launches["segscan"] < 1:
        raise AssertionError(f"fusion_cli_path launched no scan: {launches}")
    if points is None or not np.isfinite(points).all() or len(points) < 1:
        raise AssertionError("fusion_cli_path: no finite cloud")
    with tempfile.TemporaryDirectory() as td:
        out_ply = os.path.join(td, "reconstruction.ply")
        with contextlib.redirect_stdout(io.StringIO()):
            pipe.save_reconstruction(points, colors, out_ply)
        ply_bytes = os.path.getsize(out_ply)
        back, back_rgb = read_ply(out_ply)
    if back.shape != points.shape or not np.allclose(back, points):
        raise AssertionError("fusion_cli_path: the PLY does not read back")

    # 1. poses and scales against the truth (SFM_TOL, as sfm_path)
    R_true, t_dir = relative_truth(scene["R"], scene["t"])
    pairs = []
    for p in range(FUSION_VIEWS - 1):
        (Ra, ta), (Rb, tb) = poses[p], poses[p + 1]
        R_rel = Rb @ Ra.T
        t_rel = tb - R_rel @ ta
        cosang = float(np.clip(t_rel @ t_dir[p] / np.linalg.norm(t_rel),
                               -1.0, 1.0))
        pairs.append({"pair": [p, p + 1],
                      "rot_err_deg": angle_deg(R_rel, R_true[p]),
                      "t_dir_err_deg": float(np.degrees(np.arccos(cosang)))})
    text = narration.getvalue()
    avg = float(re.search(r"Average scale: ([0-9.]+)", text).group(1))
    view_scales = [avg, avg] + [float(s) for s in
                                re.findall(r"\(scale ([0-9.]+)\)", text)]
    truth = SFM_SCENE["depth_div"] / SFM_SCENE["baseline"]
    worst = {"rot_err_deg": max(r["rot_err_deg"] for r in pairs),
             "t_dir_err_deg": max(r["t_dir_err_deg"] for r in pairs),
             "scale_rel_err": max(abs(s / truth - 1) for s in view_scales),
             "true_scale": truth}
    if (len(poses) != FUSION_VIEWS or len(view_scales) != FUSION_VIEWS
            or worst["rot_err_deg"] > SFM_TOL["rot_deg"]
            or worst["t_dir_err_deg"] > SFM_TOL["t_dir_deg"]
            or worst["scale_rel_err"] > SFM_TOL["scale_rel"]):
        raise AssertionError(f"fusion_cli_path against the truth: {worst}, "
                             f"{pairs}, scales {view_scales}")
    # the output cloud in metric world coordinates (camera 0's frame in
    # baseline units -> metres)
    R0 = torch.from_numpy(scene["R"][0]).float().to(dev)
    pw = (torch.from_numpy(points).to(dev) * SFM_SCENE["baseline"]) @ R0
    out_near = float((plane_distance(pw) < 0.01).float().mean())

    # 2. to 4.: the dense stage on the true poses and the metric scale
    voxel = float(cfg.voxel_size)
    args = (torch.stack([torch.from_numpy(d) for d in depths]).to(dev),
            scene["bgr"], torch.from_numpy(scene["R"]).float().to(dev),
            torch.from_numpy(scene["t"]).float().to(dev),
            torch.full((FUSION_VIEWS,), SFM_SCENE["depth_div"], device=dev),
            torch.ones(FUSION_VIEWS, dtype=torch.bool, device=dev))
    cam = (cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.min_depth, cfg.max_depth,
           cfg.subsample_factor)
    flat, _ = backproject_views(*args, *cam)
    single = voxel_downsample(flat, voxel)
    means = single.xyz[single.mask]
    off = plane_distance(means)
    sp = SFM_SCENE
    edge = (((means[:, 1] - sp["cam_height"]).abs() < voxel * 1.01)
            & ((means[:, 2] - sp["wall_z"]).abs() < voxel * 1.01))
    plane_err = float(off[~edge].max())
    rows = flat.xyz[flat.mask].cpu().numpy()
    host = host_voxel_means(rows, voxel)
    host_err = float(np.abs(means.cpu().numpy() - host).max())
    ref = global_cumsum_means(flat, voxel)
    txr_route = {"max_err_vs_host_m": float(np.abs(ref.cpu().numpy()
                                                   - host).max()),
                 "median_err_vs_host_m": float(np.median(np.abs(
                     ref.cpu().numpy() - host).max(1))),
                 "max_off_plane_m": float(plane_distance(ref)[~edge].max()),
                 "share_off_plane_over_1cm": float(
                     (plane_distance(ref)[~edge] > 0.01).float().mean())}
    # the scan kernel on the columns and starts reconstruct() gave it, then
    # on the true poses' (long segments, every row kept)
    scan_err = []
    for case, (cols, starts) in (
            [("reconstruct()", a) for a, _ in timer.inputs.pop("dense.scan")]
            + [("true poses", scan_inputs(flat, voxel))]):
        scan_err.append(compare(
            "segscan", f"fusion_cli_path {case} N={starts.shape[0]} cols="
            f"{len(cols)} segments={int(starts.sum())}",
            torch.stack(segmented_cumsum_cols(cols, starts)),
            segmented_cumsum(torch.stack(cols, 1), starts).t(),
            **SCAN_TOL)["max_abs_err"])
    del cols, starts
    rows_per_view = -(-SFM_H // cam[-1]) * -(-SFM_W // cam[-1])
    chunk_views = dense_chunk_views(CHUNK_SINGLE_ROWS, rows_per_view)
    if (FUSION_VIEWS + 1) * rows_per_view <= CHUNK_SINGLE_ROWS:
        raise AssertionError("the chunked check would not take the route")
    chunked, _ = chunked_dense_voxel_merge(
        depths, images, scene["R"], scene["t"],
        np.full(FUSION_VIEWS, SFM_SCENE["depth_div"], np.float32),
        np.ones(FUSION_VIEWS, bool), fx=cfg.fx, fy=cfg.fy, cx=cfg.cx,
        cy=cfg.cy, min_depth=cfg.min_depth, max_depth=cfg.max_depth,
        subsample=cfg.subsample_factor, voxel_size=voxel,
        chunk_views=chunk_views, device=dev)
    same_voxels = int(chunked.mask.sum()) == means.shape[0]
    chunk_err = float((chunked.xyz[chunked.mask] - means).abs().max()) \
        if same_voxels else float("inf")
    kw = dict(nb_neighbors=cfg.outlier_neighbors,
              std_ratio=cfg.outlier_std_ratio)
    n_single = int(remove_statistical_outliers_grid(single, None, **kw)
                   .mask.sum())
    n_chunked = int(remove_statistical_outliers_grid(chunked, None, **kw)
                    .mask.sum())
    count_rel = abs(n_chunked / n_single - 1)
    dense = {"rows": int(flat.mask.numel()), "kept_rows": int(len(rows)),
             "voxels": int(means.shape[0]), "edge_voxels": int(edge.sum()),
             "max_off_plane_m": plane_err, "max_err_vs_host_m": host_err,
             "chunk_views": chunk_views, "chunked_same_voxels": same_voxels,
             "chunked_max_err_m": chunk_err,
             "points_after_outliers": {"single": n_single,
                                       "chunked": n_chunked},
             "txr_route_diagnostic": txr_route, "scan_max_abs_err": scan_err}
    if not (plane_err <= FUSION_TOL["plane_m"]
            and host_err <= FUSION_TOL["host_m"] and same_voxels
            and chunk_err <= FUSION_TOL["chunk_m"]
            and count_rel <= FUSION_TOL["chunk_count_rel"]):
        raise AssertionError(f"fusion_cli_path dense stage: {dense}")
    del flat, single, chunked, means, ref

    # launches and device time: the whole of reconstruct() once more on a
    # fresh pipeline under the profiler (the card's busy share is its device
    # time over the unprofiled run's wall), and the dense merge alone on
    # the run's own inputs, by kernel
    with contextlib.redirect_stdout(io.StringIO()):
        run_prof = kernel_breakdown(lambda: pipeline().reconstruct())
    dense_args, dense_kwargs = timer.inputs["dense_merge"][0]
    dense_prof = kernel_breakdown(
        lambda: _dense_merge_batch(*dense_args, **dense_kwargs))
    del dense_args, dense_kwargs
    pairs_run = fp._pad_pow2(FUSION_VIEWS - 1)
    out = {"phase": "fusion_cli_path", "input": [SFM_H, SFM_W],
           "views": FUSION_VIEWS, "config": {
               "voxel_size": voxel, "subsample": cfg.subsample_factor,
               "K": list(SFM_K), "outlier_neighbors": cfg.outlier_neighbors,
               "outlier_std_ratio": cfg.outlier_std_ratio},
           "feature_backend": backend, "tolerance": FUSION_TOL,
           "sfm_tolerance": SFM_TOL, "wall_s": wall_s,
           "stages_ms": stages, "pairs": pairs, "view_scales": view_scales,
           "worst": worst,
           "rows_in": FUSION_VIEWS * rows_per_view,
           "pairs_run": pairs_run,
           "rows_in_padded": (pairs_run + 1) * rows_per_view,
           "voxels": n_voxels, "points_out": int(len(points)),
           "ply_bytes": ply_bytes,
           "out_share_within_1cm_of_a_plane": out_near,
           "dense_true_poses": dense,
           "reconstruct_profiled": run_prof,
           "dense_merge_profiled": dense_prof,
           "device_busy_share": run_prof["device_ms"] / (wall_s * 1e3),
           "peak_memory_bytes": peak, "launches": launches,
           "launches_over_steps": 1, "ok": True}
    emit(out)
    return out


# ------------------------------------------------------ enhanced_cli_path

ENH_VIEWS = 8
ENH_SCAN_TOL = dict(rtol=1e-5, col_share=1e-5,
                    why="per column, 1e-5 of the column's largest "
                        "magnitude plus 1e-5 relative: f32 sums of a "
                        "component's rows taken in another order (counts "
                        "and centred first moments are integers, exact; "
                        "second moments reach about 1e5, the cos / sin "
                        "sums the component's size)")
BA_RISE_PX = 1e-4   # tests/test_bundle_adjustment.py's slack at convergence
LSD_CARD_TOL = dict(endpoint_px=1e-2, matched_share=0.99,
                    why="the card's blur, gradients and angles round in "
                        "another order than the CPU's, so a pixel at the "
                        "magnitude or angle threshold may join another "
                        "component: the same line count, and 99 % of the "
                        "lines within 1e-2 px of one on the CPU")


class SceneDepth:
    """The scene's relative depth as a depth model (the JAX tests'
    ``FakeDepthModel`` pattern): metric depth over ``depth_div``."""

    def __init__(self, rel: np.ndarray):
        self.rel = rel

    def infer_batch(self, images, intrinsics=None):
        if len(images) != len(self.rel):
            raise AssertionError("SceneDepth: another batch than the scene")
        return self.rel.copy()


def enh_truth(scene: dict, poses: list, text: str) -> tuple:
    """Per pair rotation and translation-direction error of the
    pipeline's poses against the scene, and its view scales (parsed from
    the narration) against the true scale."""
    R_true, t_dir = relative_truth(scene["R"], scene["t"])
    pairs = []
    for p in range(len(poses) - 1):
        (Ra, ta), (Rb, tb) = poses[p], poses[p + 1]
        R_rel = np.asarray(Rb) @ np.asarray(Ra).T
        t_rel = np.asarray(tb) - R_rel @ np.asarray(ta)
        c = float(np.clip(t_rel @ t_dir[p] / np.linalg.norm(t_rel), -1, 1))
        pairs.append({"pair": [p, p + 1],
                      "rot_err_deg": angle_deg(R_rel, R_true[p]),
                      "t_dir_err_deg": float(np.degrees(np.arccos(c)))})
    s0 = float(re.search(r"Depth scale estimate: ([0-9.]+)", text).group(1))
    scales = [s0, s0] + [float(s) for s in
                         re.findall(r"pose chained \(scale ([0-9.]+)\)",
                                    text)]
    truth = SFM_SCENE["depth_div"] / SFM_SCENE["baseline"]
    worst = {"rot_err_deg": max(r["rot_err_deg"] for r in pairs),
             "t_dir_err_deg": max(r["t_dir_err_deg"] for r in pairs),
             "scale_rel_err": max(abs(s / truth - 1) for s in scales),
             "true_scale": truth, "views": len(poses),
             "scales": len(scales)}
    return pairs, scales, worst


def enh_reconstruct(rec, out_dir: str, timer=None) -> tuple:
    """``rec.reconstruct(out_dir)`` with its narration captured; returns
    (result, narration, wall seconds)."""
    narration = io.StringIO()
    try:
        with contextlib.redirect_stdout(narration):
            t0 = time.perf_counter()
            result = rec.reconstruct(output_dir=out_dir)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        if timer is not None:
            timer.restore()
    return result, narration.getvalue(), wall


def check_lsd_scan(cols: tuple, starts: torch.Tensor, launches: int) -> dict:
    """The scan kernel at 8 columns on the columns and starts LSD handed it
    for one frame: each column against the plain version, repeatability,
    the geometry, and the time in interleaved rounds beside the bound."""
    require_geometry("segscan", kernels.lib().txr_segscan_geometry,
                     (SCAN_TILE, SCAN_THREADS, SCAN_ITEMS, SCAN_MAX_COLS))
    n, d = starts.shape[0], len(cols)
    if d != 8:
        raise AssertionError(f"LSD handed the scan {d} columns, not 8")
    got = torch.stack(segmented_cumsum_cols(cols, starts))
    want = segmented_cumsum(torch.stack(cols, 1), starts).t()
    errs = []
    for c in range(d):
        scale = float(want[c].abs().max())
        errs.append(compare(
            "segscan", f"enhanced_cli_path LSD column {c} of 8, N={n}, "
            f"segments={int(starts.sum())}", got[c], want[c],
            atol=ENH_SCAN_TOL["col_share"] * max(scale, 1.0),
            rtol=ENH_SCAN_TOL["rtol"], why=ENH_SCAN_TOL["why"])["max_abs_err"])
    require_repeatable("segscan",
                       lambda: torch.stack(segmented_cumsum_cols(cols,
                                                                 starts)))
    spread = time_spread(
        {"kernel": lambda: segmented_cumsum_cols(cols, starts),
         "plain": lambda: segmented_cumsum(torch.stack(cols, 1), starts)},
        runs=10)
    nbytes = n * (8 * 4 + 8 * 4 + 1)
    return {"columns": d, "rows": n, "segments": int(starts.sum()),
            "max_abs_err": max(errs), "ms": spread["kernel"]["median"],
            "ms_spread": spread["kernel"],
            "plain_ms": spread["plain"]["median"],
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "bytes": nbytes, "launches_on_path": launches,
            "tolerance": ENH_SCAN_TOL}


def card_against_cpu(gray: torch.Tensor) -> dict:
    """One frame's LSD, Canny, ORB and SIFT on the card against the port on
    the CPU (same grey frame)."""
    cpu = gray.cpu()
    a, b = lsd_lines(gray), lsd_lines(cpu)
    la, lb = a.lines[a.mask].cpu().double(), b.lines[b.mask].double()
    matched, worst = 0, 0.0
    if len(la) and len(lb):
        dist = (la[:, None, :] - lb[None, :, :]).abs().amax(-1).min(1)[0]
        matched = int((dist < LSD_CARD_TOL["endpoint_px"]).sum())
        worst = float(dist.max())
    lsd = {"lines_card": len(la), "lines_cpu": len(lb), "matched": matched,
           "max_endpoint_err_px": worst, "tolerance": LSD_CARD_TOL}
    if len(la) != len(lb) or matched < LSD_CARD_TOL["matched_share"] * len(la):
        raise AssertionError(f"LSD on the card against the CPU: {lsd}")
    edges_card, edges_cpu = canny(gray).cpu(), canny(cpu)
    differ = int((edges_card != edges_cpu).sum())
    if differ:
        raise AssertionError(f"Canny: {differ} pixels differ between the "
                             "card and the CPU")
    oa, ob = orb_features(gray), orb_features(cpu)
    ua, ub = oa.uv[oa.mask].cpu().double(), ob.uv[ob.mask].double()
    near = torch.cdist(ua, ub).min(1)[0] < 1e-3 if len(ua) and len(ub) \
        else torch.zeros(0, dtype=torch.bool)
    sa = sift_features(gray, capacity=3072, contrast_threshold=0.02)
    sb = sift_features(cpu, capacity=3072, contrast_threshold=0.02)
    sift = compare_keypoints(sa, sb)
    return {"lsd": lsd, "canny_pixels_differing": differ,
            "canny_edge_pixels": int((edges_cpu > 0).sum()),
            "orb": {"valid_card": len(ua), "valid_cpu": len(ub),
                    "card_keypoints_without_a_cpu_one_within_1e-3_px":
                        int((~near).sum())},
            "sift": sift}


def feature_stage_ms(gray: torch.Tensor) -> dict:
    """Each feature stage of the hybrid detector on one frame, between CUDA
    events (median of 3 after a warm-up)."""
    return {
        "sift": time_ms(lambda: sift_features(gray, capacity=3072,
                                              contrast_threshold=0.02), 3),
        "orb": time_ms(lambda: orb_features(gray, capacity=2048,
                                            n_levels=8), 3),
        "lsd": time_ms(lambda: lsd_lines(gray), 3),
        "canny": time_ms(lambda: canny(gray, 50.0, 150.0), 3)}


def enhanced_cli_path() -> dict:
    """depth_enhanced_reconstruction_torch.py's pipeline on the card: 8
    views of 1080 x 1920 of sfm_path's scene put straight into
    ``rec.images`` (the machine has no image codec). Run A: the CLI's
    default (ViT-L v2 bf16, seeded weights; ``auto`` features, which are
    the device's; voxel 0.005, subsample 4), its launches, stages and one
    profiled ``reconstruct()``. Run B: the scene's depth as the depth model
    and bundle adjustment on, held to the truth (``SFM_TOL``). Then the
    scan kernel at 8 columns on LSD's own inputs, and one frame's features
    on the card against the CPU."""
    import txr_torch.ops.lsd as lsd_mod
    import txr_torch.pipelines.enhanced_pipeline as ep
    from txr_torch.ops import scan

    t_phase = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    dev = torch.device("cuda")
    fx, fy, cx, cy = SFM_K
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)
    scene = two_plane_scene(SFM_H, SFM_W, SFM_K, ENH_VIEWS, dev)
    images = list(scene["bgr"].cpu().numpy())
    rel = (scene["depth"] / SFM_SCENE["depth_div"]).cpu().numpy()
    model = DepthAnythingModel("v2", "vitl")
    part("scene_and_model")

    def pipeline(**kw):
        rec = ep.DepthEnhancedReconstruction(K, **kw)
        rec.images = list(images)
        rec.image_names = [f"view_{i:02d}.png" for i in range(ENH_VIEWS)]
        return rec

    # ---- Run A: the CLI's default at full width
    rec = pipeline(depth_model=model)
    backend = rec.detector.backend
    if backend != "device" or rec.device.type != "cuda":
        raise AssertionError(f"the pipeline resolved to {backend} on "
                             f"{rec.device}")
    timer = StageTimer()
    timer.wrap(rec, "estimate_all_depths", "depth")
    timer.wrap(rec, "detect_all_features", "features")
    timer.wrap(rec, "_match_pair_host", "match (host)")
    timer.wrap(ep, "_enh_pairs_batch", "pairs")
    timer.wrap(ep, "_enh_scales_batch", "scales")
    timer.wrap(ep, "_enh_dense_merge", "merge")
    timer.wrap(rec, "_save_pointcloud", "write")
    timer.wrap(lsd_mod, "segmented_cumsum_cols", "lsd scan",
               keep_input=True)
    timer.wrap(scan, "segmented_cumsum_cols", "merge scan")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with tempfile.TemporaryDirectory() as td:
        result, text, wall_s = enh_reconstruct(rec, td, timer)
        launches = dict(kernels.launches)
        peak = torch.cuda.max_memory_allocated()
        if result is None:
            raise AssertionError(f"enhanced_cli_path run A gave no result: "
                                 f"{text[-2000:]}")
        points, colors, poses = result
        back, _ = read_ply(os.path.join(td, "reconstruction.ply"))
    if back.shape != points.shape or not np.allclose(back, points,
                                                     atol=1e-6):
        raise AssertionError("enhanced_cli_path: the PLY does not read back")
    if not np.isfinite(points).all() or len(points) < 1:
        raise AssertionError("enhanced_cli_path: no finite cloud")
    stages = timer.ms()
    expect = {"segscan": ENH_VIEWS + 1}
    if (launches["attention"] < 24 or launches["dpt_tail"] < 1
            or launches["segscan"] != expect["segscan"]
            or launches["residual_norm"] != RESIDUALS * launches["attention"]
            or launches["upsample"] != UPSAMPLES * launches["dpt_tail"]
            or any(n for k, n in launches.items()
                   if k not in ("attention", "dpt_tail", "segscan",
                                "residual_norm", "upsample"))):
        raise AssertionError(f"enhanced_cli_path launched {launches}; "
                             "attention >= 24, dpt_tail >= 1, segscan 9 "
                             "(LSD once a frame, the merge once), two "
                             "residual_norm an attention launch, four "
                             "upsample a tail launch")
    lsd_inputs = timer.inputs.pop("lsd scan")
    raw = [int(m) for m in re.findall(r"RANSAC-F inliers \(pair \d+\): "
                                      r"\d+/(\d+)", text)]
    inliers = [int(m) for m in re.findall(r"RANSAC-F inliers \(pair \d+\): "
                                          r"(\d+)/", text)]
    part("run_a")
    gray0 = bgr_to_gray(scene["bgr"][0])
    feature_ms = feature_stage_ms(gray0)
    with tempfile.TemporaryDirectory() as td, \
            contextlib.redirect_stdout(io.StringIO()):
        prof = kernel_breakdown(lambda: pipeline(
            depth_model=model).reconstruct(output_dir=td))
    part("feature_ops_and_profiled_run")
    run_a = {"wall_s": wall_s, "stages_ms": stages,
             "feature_stages_one_frame_ms": feature_ms,
             "peak_memory_bytes": peak, "launches": launches,
             "points_out": int(len(points)), "poses": len(poses),
             "raw_matches_per_pair": raw, "ransac_f_inliers": inliers,
             "reconstruct_profiled": prof,
             "device_busy_share": prof["device_ms"] / (wall_s * 1e3),
             "narration_tail": text.splitlines()[-3:]}

    # ---- Run B: against the truth, with bundle adjustment
    rec_b = pipeline(depth_model=SceneDepth(rel), use_ba=True)
    with tempfile.TemporaryDirectory() as td:
        result_b, text_b, wall_b = enh_reconstruct(rec_b, td)
    part("run_b")
    if result_b is None:
        raise AssertionError(f"enhanced_cli_path run B gave no result: "
                             f"{text_b[-2000:]}")
    pts_b, _, poses_b = result_b
    pairs_b, scales_b, worst_b = enh_truth(scene, poses_b, text_b)
    hist = [float(h) for h in rec_b.ba_history]
    # the RMS may not rise by more than f32 round-off at convergence
    rises = [b - a for a, b in zip(hist, hist[1:]) if b > a + BA_RISE_PX]
    R0 = torch.from_numpy(scene["R"][0]).float().to(dev)
    pw = (torch.from_numpy(pts_b).to(dev) * SFM_SCENE["baseline"]) @ R0
    near = float((plane_distance(pw) < 0.01).float().mean())
    run_b = {"wall_s": wall_b, "pairs": pairs_b, "view_scales": scales_b,
             "worst": worst_b, "ba_rms_history": hist,
             "ba_rises": rises, "points_out": int(len(pts_b)),
             "out_share_within_1cm_of_a_plane": near}
    if (worst_b["views"] != ENH_VIEWS or worst_b["scales"] != ENH_VIEWS
            or worst_b["rot_err_deg"] > SFM_TOL["rot_deg"]
            or worst_b["t_dir_err_deg"] > SFM_TOL["t_dir_deg"]
            or worst_b["scale_rel_err"] > SFM_TOL["scale_rel"]
            or rises or hist[-1] > hist[0] + BA_RISE_PX):
        raise AssertionError(f"enhanced_cli_path run B: {run_b}")

    # ---- the scan kernel at 8 columns on LSD's inputs, one frame
    (cols, starts), _ = lsd_inputs[0]
    del lsd_inputs
    scan8 = check_lsd_scan(cols, starts, launches["segscan"] - 1)
    del cols, starts
    part("scan_8_columns")
    parity = card_against_cpu(gray0)
    part("card_against_cpu")
    out = {"phase": "enhanced_cli_path", "input": [SFM_H, SFM_W],
           "views": ENH_VIEWS, "config": {
               "voxel_size": rec.voxel_size, "subsample": rec.subsample,
               "K": list(SFM_K), "model": "v2/vitl bf16 seeded",
               "match_capacity": ep.MATCH_CAPACITY},
           "feature_backend": backend, "sfm_tolerance": SFM_TOL,
           "run_a": run_a, "run_b": run_b, "scan_8_columns": scan8,
           "card_against_cpu": parity, "launches": launches,
           "launches_over_steps": 1,
           "phase_wall_s": time.perf_counter() - t_phase,
           "phase_parts_s": parts, "ok": True}
    emit(out)
    return out


STREAM_CAMS = list(range(9)) + list(range(7, -1, -1))   # 0 ... 8 ... 0
STREAM_CLI_FRAMES = 10
STREAM_PROFILE_FRAMES = 6       # frames of each stream's profiled run
# The stream's world unit is the odometry baseline (pair_step's unit t):
# 8 cm in the scene, so 1 cm voxels are 0.125 units and the scene's 1.4 to
# 3.7 m depths are 17 to 46 units (max_depth 60 units = 4.8 m).
STREAM_UNIT_M = SFM_SCENE["baseline"]
STREAM_CFG = dict(voxel_size=0.01 / STREAM_UNIT_M, max_depth=60.0,
                  keyframe_every=2, loop_min_separation=4, loop_stride=1,
                  loop_inliers=25)
STREAM_DRIFT_WHY = (
    "a closure spreads its loop edges' errors over the keyframe graph; on "
    "this noise-free scene the odometry drifts less than a loop edge errs "
    "(the depth-anchored length of a distant pair, with the scale EMA "
    "started at 1), so closure cannot lower the drift here and is held to "
    "adding no more than its worst loop edge's error; both drifts are "
    "reported")
# ICP's correspondence radius of a metric stream (0.1 m) in the stream's
# unit: the stream keeps the default 0.1 units (8 mm), at which ICP keeps no
# frame here; at this radius it is accepted (and, against a map fused while
# the scale EMA rose from 1, pulls the poses off: tools/stream_closure_drift.py)
STREAM_ICP_WIDE = 0.1 / STREAM_UNIT_M
# ICP on the card against the CPU on the same inputs: R (f32 sums of 4,096
# rows in another order); the correction's motion of the source points to
# 1 % of its size (the 6x6 system mixes rotations about an origin 17 to 46
# units away with translations, and ten Gauss-Newton steps carry its
# round-off: 7.4e-4 units of t on the card); the inlier fraction (a source
# row at the radius may fall either side: two rows of 4,096); normals up
# to sign (a near-equal 8th and 9th neighbour may swap)
ICP_CARD_ATOL = 1e-4
ICP_CARD_RTOL = 1e-2
ICP_CARD_FRAC = 2 / 4096
ICP_CARD_NORMAL_ATOL = 1e-3


class StreamDepth:
    """The scene's relative depth (metric over ``depth_div``) as a
    duck-typed depth model, one frame per call, in stream order."""

    def __init__(self, rel: torch.Tensor):
        self.rel, self.i = rel, 0

    def infer(self, bgr, intrinsics=None):
        d = self.rel[self.i]
        self.i += 1
        return d


class InsertLog:
    """Wraps ``offset_map_insert``: keeps each call's points and whether
    its map was a new one (a stream's first insert, a rebuild), to replay
    the inserts through the unfused reduce route."""

    def __init__(self, fn):
        self.fn, self.calls, self.last = fn, [], None

    def __call__(self, vm, pts):
        out = self.fn(vm, pts)
        self.calls.append((vm is not self.last, vm.khi.shape[0],
                           vm.voxel_size, PointSet(
                               pts.xyz.clone(), pts.rgb.clone(),
                               pts.mask.clone())))
        self.last = out
        return out

    def replay_unfused(self):
        vm = None
        for fresh, cap, voxel, pts in self.calls:
            if fresh:
                vm = create_offset_map(cap, float(voxel))
            vm = _reduce_unfused(_insert_cols(vm, pts), cap, vm.voxel_size)
        return vm


def stream_truth(scene: dict, poses: list) -> tuple:
    """Per consecutive pair, the rotation and translation-direction error
    of the stream's poses against the scene; the end camera's distance
    from the start camera (the trajectory ends where it began), in the
    stream's units."""
    R_true, t_dir = relative_truth(scene["R"], scene["t"])
    pairs = []
    for p in range(len(poses) - 1):
        (Ra, ta), (Rb, tb) = poses[p], poses[p + 1]
        R_rel = Rb @ Ra.T
        t_rel = tb - R_rel @ ta
        c = float(np.clip(t_rel @ t_dir[p] / np.linalg.norm(t_rel), -1, 1))
        pairs.append((angle_deg(R_rel, R_true[p]),
                      float(np.degrees(np.arccos(c)))))
    (R0, t0), (Rn, tn) = poses[0], poses[-1]
    drift = float(np.linalg.norm(-Rn.T @ tn - (-R0.T @ t0)))
    return pairs, drift


def stream_run(scene: dict, rel: torch.Tensor, closure: bool,
               timer=None, inserts=None, icp_call=None, frames=None):
    """One pass of the stepwise stream over the scene's frames (the first
    ``frames`` of them); returns (reconstructor, wall seconds).
    ``icp_call`` (a list) receives the arguments of the last frame
    refinement's ``icp_point_to_plane``."""
    import txr_torch.pipelines.streaming as st
    from txr_torch.core.config import StreamingConfig

    fx, fy, cx, cy = SFM_K
    intr = CameraIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=SFM_W,
                            height=SFM_H)
    rec = st.StreamingReconstructor(
        intr, depth_model=StreamDepth(rel), use_icp=True, verbose=False,
        config=StreamingConfig(loop_closure=closure, **STREAM_CFG))
    saved = st.offset_map_insert
    rec.edges_seen = []
    refine = rec._refine_loop_edge

    def refine_kept(old_ki, R_rel, t_rel):
        R, t = refine(old_ki, R_rel, t_rel)
        rec.edges_seen.append((old_ki, len(rec.keyframes) - 1, R_rel, t_rel,
                               R, t))
        return R, t

    rec._refine_loop_edge = refine_kept
    if icp_call is not None:
        refine_icp = rec._refine_icp

        def refine_icp_kept(ps, R, t):
            icp = st.icp_point_to_plane

            def icp_kept(*a, **k):
                icp_call[:] = [a, k]
                return icp(*a, **k)

            st.icp_point_to_plane = icp_kept
            try:
                return refine_icp(ps, R, t)
            finally:
                st.icp_point_to_plane = icp

        rec._refine_icp = refine_icp_kept
    if timer is not None:
        timer.wrap(rec.depth_model, "infer", "depth")
        timer.wrap(rec.detector, "detect", "features")
        timer.wrap(rec, "_estimate_pose_features", "pose")
        timer.wrap(rec, "_refine_icp", "icp")
        timer.wrap(st, "offset_map_insert", "insert")
        timer.wrap(rec, "_maybe_keyframe", "keyframe / loop")
    if inserts is not None:
        inserts.fn = st.offset_map_insert
        st.offset_map_insert = inserts
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(frames or len(STREAM_CAMS)):
            rec.process_frame(scene["bgr"][i], float(i), str(i))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        st.offset_map_insert = saved
        if timer is not None:
            timer.restore()
    return rec, wall


def icp_card_against_cpu(call: list) -> dict:
    """One frame's ICP refinement on the card against the same calls on the
    CPU, from the card run's inputs: ``estimate_normals`` of the target
    alone, then ``icp_point_to_plane`` alone on the card's normals. At the
    stream's correspondence radius, where the refinement is rejected, both
    must reject it; at ``STREAM_ICP_WIDE`` both must accept it (inlier
    fraction at least 0.3) with R, the fraction and the correction's
    motion of the source points held to the CPU's."""
    from txr_torch.geometry.icp import estimate_normals, icp_point_to_plane

    (src, srcm, tgt, nrm, tgtm, R0, t0), kw = call
    host = [x.cpu() for x in (src, srcm, tgt, nrm, tgtm, R0, t0)]
    n_cpu = estimate_normals(host[2], host[4], k=8)
    xs = host[0][host[1]]
    err = (nrm.cpu() - n_cpu).abs().max(dim=1).values
    # a normal's sign is free (the point-to-plane system is even in it)
    err_unsigned = torch.minimum(err, (nrm.cpu() + n_cpu).abs().max(
        dim=1).values)
    out = {"sources": int(srcm.sum()), "targets": int(tgtm.sum()),
           "normals": {"max_abs_err": float(err.max()),
                       "max_abs_err_up_to_sign": float(err_unsigned.max()),
                       "atol": ICP_CARD_NORMAL_ATOL}}
    for corr in (kw["max_correspondence"], STREAM_ICP_WIDE):
        got = [torch.as_tensor(x).cpu() for x in icp_point_to_plane(
            src, srcm, tgt, nrm, tgtm, R0, t0, kw["iterations"], corr)]
        want = icp_point_to_plane(*host, kw["iterations"], corr)
        moved = xs @ want[0].T + want[1]
        row = {"R_max_abs_err": float((got[0] - want[0]).abs().max()),
               "t_max_abs_err": float((got[1] - want[1]).abs().max()),
               # what the correction does to the source points, and how far
               # the card's moves them from where the CPU's does
               "correction_max": float((moved - xs).norm(dim=1).max()),
               "correction_diff_max": float(
                   (xs @ got[0].T + got[1] - moved).norm(dim=1).max()),
               "rmse": [float(got[2]), float(want[2])],
               "inlier_fraction": [float(got[3]), float(want[3])]}
        out[f"icp_at_{corr:g}"] = row
        kept = [f >= 0.3 for f in row["inlier_fraction"]]
        if corr != STREAM_ICP_WIDE:
            # rejected: a solve over a few % of the rows, held only to the
            # same decision
            bad = kept[0] != kept[1]
        else:
            bad = (not all(kept) or row["R_max_abs_err"] > ICP_CARD_ATOL
                   or row["correction_diff_max"]
                   > ICP_CARD_RTOL * row["correction_max"]
                   or abs(row["inlier_fraction"][0]
                          - row["inlier_fraction"][1]) > ICP_CARD_FRAC)
        if bad:
            raise AssertionError(f"stream_path: ICP on the card against the "
                                 f"CPU: {out}")
    if out["normals"]["max_abs_err_up_to_sign"] > ICP_CARD_NORMAL_ATOL:
        raise AssertionError(f"stream_path: normals on the card against the "
                             f"CPU: {out}")
    return out


class SceneSource(ImageSource):
    """A folder source's frames, handed to the CLI through ``make_source``
    (the machine has no image codec); intrinsics as a folder without a
    calibration file gets them."""

    def __init__(self, frames: list):
        self.frames = iter(frames)
        h, w = frames[0].shape[:2]
        self.intrinsics = CameraIntrinsics.default(w, h)
        self.n = 0

    def __next__(self):
        bgr = next(self.frames)
        self.n += 1
        return bgr, float(self.n - 1), f"frame_{self.n - 1:02d}"


def read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    head = data.split(b"\n", 4)
    if head[0] != b"P5" or head[3] != b"255":
        raise AssertionError(f"{path} is not the grid's binary PGM")
    w, h = map(int, head[2].split())
    img = np.frombuffer(head[4], np.uint8)
    if img.size != w * h:
        raise AssertionError(f"{path}: {img.size} pixels for {w} x {h}")
    return img.reshape(h, w)


def stream_cli_run(frames: list, out_dir: str, extra=(), warm=False
                   ) -> dict:
    """reconstruction_torch.main at its defaults (and ``extra`` arguments)
    over ``frames``: the PLY against the map, the grid's PGM / YAML read
    back against the grid the reconstructor computes, the route it took,
    the counters of its kernels. ``warm``: then a second reconstructor
    over the CLI's model and settings takes the same frames, timed (a
    fused route replays the graphs the CLI captured)."""
    import importlib.util

    import txr_torch.io.sources as sources
    import txr_torch.pipelines.streaming as st
    from txr_torch.fusion.occupancy import occupancy_grid

    spec = importlib.util.spec_from_file_location(
        "reconstruction_torch", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "reconstruction_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    built = {}

    class Recorded(st.StreamingReconstructor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built["rec"] = self

    saved = (sources.make_source, st.StreamingReconstructor)
    sources.make_source = lambda *a, **kw: SceneSource(frames)
    st.StreamingReconstructor = Recorded
    out = os.path.join(out_dir, "scene.ply")
    try:
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["--mode", "folder", "--input", out_dir,
                       "--output", out, *extra])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launches)
    finally:
        sources.make_source, st.StreamingReconstructor = saved
    rec = built["rec"]
    if rc != 0:
        raise AssertionError(f"reconstruction_torch.main returned {rc}")
    xyz, _ = read_ply(out)
    voxels = int(offset_map_size(rec.map))
    if len(xyz) != voxels or not np.isfinite(xyz).all():
        raise AssertionError(f"stream CLI: {len(xyz)} PLY points, "
                             f"{voxels} voxels")
    img = read_pgm(os.path.join(out_dir, "scene_grid.pgm"))
    with open(os.path.join(out_dir, "scene_grid.yaml")) as f:
        yaml = f.read()
    pts, _ = offset_map_points(rec.map).to_numpy()
    centers = np.stack([-R.T @ t for R, t in rec.poses])
    grid, origin = occupancy_grid(pts, camera_centers=centers)
    want_origin = f"origin: [{origin[0]:.6f}, {origin[1]:.6f}, 0.0]"
    if img.shape != grid.shape or want_origin not in yaml \
            or "image: scene_grid.pgm" not in yaml:
        raise AssertionError(f"stream CLI grid: {img.shape} against "
                             f"{grid.shape}, {yaml!r}")
    if not (launches["attention"] > 0 and launches["dpt_tail"] > 0
            and launches["offset_reduce"] > 0
            and launches["upsample"] == UPSAMPLES * launches["dpt_tail"]):
        raise AssertionError(f"stream CLI launched {launches}")
    warm_fps = None
    if warm:
        again = st.StreamingReconstructor(
            rec.intr, depth_model=rec.depth_model, config=rec.cfg,
            use_icp=rec.use_icp, metric_depth=rec.metric_depth,
            verbose=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again.run(SceneSource(frames))
        torch.cuda.synchronize()
        warm_fps = again.frames_processed / (time.perf_counter() - t0)
        if again.route != rec.route or again.poses[-1][1].tolist() \
                != rec.poses[-1][1].tolist():
            raise AssertionError("stream CLI: the warm pass differs from "
                                 "the CLI's")
    return {"route": rec.route, "wall_s": wall,
            "warm_frames_per_second": warm_fps,
            "frames": rec.frames_processed,
            "frames_per_second": rec.frames_processed / wall,
            "skipped": rec.frames_skipped, "icp_accepted": rec.icp_accepted,
            "keyframes": len(rec.keyframes), "voxels": voxels,
            "ply_points": int(len(xyz)), "grid_rows_cols": list(img.shape),
            "grid_origin": list(origin),
            "grid_cells": {"occupied": int((grid == 100).sum()),
                           "free": int((grid == 0).sum())},
            "scale": rec.scale, "launches": launches}


def stream_path() -> tuple:
    """reconstruction_torch.py's stepwise stream on the card. Run A: the
    reconstructor on a ping-pong trajectory 0 ... 8 ... 0 (17 frames of
    1080 x 1920) of sfm_path's scene, the scene's relative depth as the
    depth model (the scale anchor runs), ICP on, loop closure off and on,
    against the truth; stages, one profiled run of 6 frames, peak memory,
    and the map replayed through the unfused reduce. Run B: the CLI's main
    with --no-fused (v2 vits, seeded weights) over 10 of the scene's
    frames. Returns the phase's line and the runs stream_fused_path holds
    its fused runs against."""
    t_phase = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    dev = torch.device("cuda")
    scene = two_plane_scene(SFM_H, SFM_W, SFM_K, len(STREAM_CAMS), dev,
                            cams=STREAM_CAMS)
    rel = scene["depth"] / SFM_SCENE["depth_div"]
    part("scene")

    # ---- Run A: one run of the first frames under the profiler (also the
    # warm-up), then closure off and on, timed (the second with its inserts
    # recorded)
    prof = kernel_breakdown(lambda: stream_run(
        scene, rel, closure=False, frames=STREAM_PROFILE_FRAMES))
    part("run_a_profiled")
    icp_call = []
    off, wall_off = stream_run(scene, rel, closure=False, icp_call=icp_call)
    pairs_off, drift_off = stream_truth(scene, off.poses)
    part("run_a_closure_off")
    icp_check = icp_card_against_cpu(icp_call)
    del icp_call
    part("icp_card_against_cpu")
    timer = StageTimer()
    inserts = InsertLog(None)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    on, wall_on = stream_run(scene, rel, closure=True, timer=timer,
                             inserts=inserts)
    launches_a = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    pairs_on, drift_on = stream_truth(scene, on.poses)
    stages = timer.ms()
    n = len(STREAM_CAMS)
    part("run_a_closure_on")
    # the kernel of the path: the same inserts through the unfused route
    voxels = require_maps_equal(
        f"stream_path: {len(inserts.calls)} inserts of run A replayed "
        "through the unfused route", on.map, inserts.replay_unfused())
    del inserts
    part("replay_unfused")

    # each loop edge (feature RANSAC + depth-anchored length, then the
    # ICP between the keyframe clouds) against the truth, in stream units
    edges = []
    for old_ki, new_ki, R_raw, t_raw, R_ref, t_ref in on.edges_seen:
        a = on.keyframes[old_ki]["pose_idx"]
        b = on.keyframes[new_ki]["pose_idx"]
        R_t = scene["R"][b] @ scene["R"][a].T
        t_t = (scene["t"][b] - R_t @ scene["t"][a]) / STREAM_UNIT_M
        edges.append({
            "frames": [a, b], "cams": [STREAM_CAMS[a], STREAM_CAMS[b]],
            "true_length": float(np.linalg.norm(t_t)),
            "raw": {"rot_err_deg": angle_deg(R_raw, R_t),
                    "t_err": float(np.linalg.norm(t_raw - t_t)),
                    "length": float(np.linalg.norm(t_raw))},
            "after_icp": {"rot_err_deg": angle_deg(R_ref, R_t),
                          "t_err": float(np.linalg.norm(t_ref - t_t)),
                          "length": float(np.linalg.norm(t_ref))}})
    edge_err = max((e["after_icp"]["t_err"] for e in edges), default=0.0)
    worst = lambda prs, i: max(p[i] for p in prs)  # noqa: E731
    run_a = {
        "frames": n, "cams": STREAM_CAMS, "config": dict(
            STREAM_CFG, unit_m=STREAM_UNIT_M, use_icp=True,
            metric_depth=False, kf_working_set=on.cfg.kf_working_set),
        "closure_off": {"wall_s": wall_off,
                        "frames_per_second": n / wall_off,
                        "fused": off.frames_processed,
                        "skipped": off.frames_skipped,
                        "icp_accepted": off.icp_accepted,
                        "scale": off.scale, "end_drift_units": drift_off,
                        "worst_rot_err_deg": worst(pairs_off, 0),
                        "worst_t_dir_err_deg": worst(pairs_off, 1),
                        "pair_errors_deg": pairs_off},
        "closure_on": {"wall_s": wall_on, "frames_per_second": n / wall_on,
                       "fused": on.frames_processed,
                       "skipped": on.frames_skipped,
                       "icp_accepted": on.icp_accepted,
                       "loops_closed": on.loops_closed, "loop_edges": edges,
                       "keyframes": len(on.keyframes),
                       "spilled": sum(1 for k in on.keyframes
                                      if k.get("spilled")),
                       "scale": on.scale, "end_drift_units": drift_on,
                       "worst_rot_err_deg": worst(pairs_on, 0),
                       "worst_t_dir_err_deg": worst(pairs_on, 1),
                       "pair_errors_deg": pairs_on, "voxels": voxels,
                       "stages_ms": stages,
                       "stages_ms_per_frame": {k: v["ms"] / n
                                               for k, v in stages.items()},
                       "peak_memory_bytes": peak, "launches": launches_a,
                       "profiled": dict(prof, frames=STREAM_PROFILE_FRAMES,
                                        closure=False),
                       # device time and wall of the one profiled call (its
                       # wall carries the profiler's own host cost)
                       "device_busy_share_profiled_call": prof["device_ms"]
                       / prof["wall_ms_under_profiler"],
                       # its device time a frame over the closure-off
                       # run's wall a frame (the same seeded frames)
                       "profiled_device_ms_per_frame_over_closure_off_wall":
                       prof["device_ms"] / STREAM_PROFILE_FRAMES
                       / (wall_off * 1e3 / n)},
        "icp_card_against_cpu": icp_check,
        "drift_with_closure_over_without": drift_on / max(drift_off, 1e-12),
        "drift_bound": {"closure_off_plus_worst_loop_edge_error":
                        drift_off + edge_err, "why": STREAM_DRIFT_WHY}}
    bad = [(run, p) for run, prs in (("off", pairs_off), ("on", pairs_on))
           for p, (r, d) in enumerate(prs)
           if r > SFM_TOL["rot_deg"] or d > SFM_TOL["t_dir_deg"]]
    if (off.frames_processed != n or on.frames_processed != n or bad
            or on.loops_closed < 1 or len(edges) != on.loops_closed
            or drift_on > drift_off + edge_err
            or launches_a["offset_reduce"] < n
            or not all(np.isfinite(R).all() and np.isfinite(t).all()
                       for R, t in on.poses)):
        raise AssertionError(f"stream_path run A: pairs off SFM_TOL {bad}: "
                             f"{run_a}")

    # ---- Run B: the CLI at its defaults
    frames = list(scene["bgr"][:STREAM_CLI_FRAMES].cpu().numpy())
    del scene, rel
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        run_b = stream_cli_run(frames, td, ["--no-fused"])
    part("run_b_cli")
    out = {"phase": "stream_path", "input": [SFM_H, SFM_W],
           "sfm_tolerance": SFM_TOL, "run_a": run_a, "run_b": run_b,
           "launches": run_b["launches"], "launches_over_steps": 1,
           "phase_wall_s": time.perf_counter() - t_phase,
           "phase_parts_s": parts, "ok": True}
    emit(out)
    # stream_fused_path holds its fused runs against these stepwise ones
    return out, {"off": off, "on": on, "wall_off": wall_off,
                 "wall_on": wall_on, "run_b": run_b}


# The fused stream (stream_fused_path): the stand-in depth model keeps the
# scene's relative depth in a buffer at a fixed address, which a captured
# step reads; the source fills it as it hands each frame out.
STREAM_FUSED_BATCH = 8            # the CLI's stream_batch
STREAM_FUSED_POSE_ATOL = 1e-4     # fused against stepwise, as on the CPU


class SceneDepthModel(DepthAnythingModel):
    """A stand-in for the port's depth model (so ``run`` takes the fused
    route): its device-forward method ``_forward`` returns the relative
    depth of the frames in hand from ``buf``, which ``SceneFrames`` fills;
    ``infer`` (the stepwise route) the same for one frame."""

    def __init__(self, rel: torch.Tensor, batch: int):
        self.device = rel.device
        self.version, self.encoder, self.input_size = "v2", "scene", 518
        self.focal_length_ref, self.metric = 300.0, False
        self.rel, self.batch = rel, batch
        self.buf = torch.zeros((batch, *rel.shape[1:]), device=rel.device)

    def _forward(self, rgb_u8, in_h, in_w, out_h, out_w):
        return self.buf[:rgb_u8.shape[0]] * 1.0

    def infer(self, image, intrinsics=None):
        return self.buf[0] * 1.0


class SceneFrames:
    """The scene's frames in stream order (device tensors); handing out
    frame k puts its depth into slot k mod batch of the model's buffer.
    With ``sync_from`` set, PyTorch's sync debug mode is "error" from that
    frame on (steps enqueued between two host reads must not sync)."""

    realtime = False

    def __init__(self, scene: dict, model: SceneDepthModel, frames=None,
                 sync_from=None):
        self.bgr, self.model = scene["bgr"], model
        self.n = frames or len(STREAM_CAMS)
        self.sync_from = sync_from

    def __iter__(self):
        try:
            for k in range(self.n):
                if k == self.sync_from:
                    torch.cuda.set_sync_debug_mode("error")
                self.model.buf[k % self.model.batch].copy_(self.model.rel[k])
                yield self.bgr[k], float(k), str(k)
        finally:
            torch.cuda.set_sync_debug_mode("default")


def host_reads_allowed(fn):
    """``fn`` with the sync debug mode lifted around it: the fused runs'
    one host read per drain."""

    def wrapped(*a, **k):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("default")
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return wrapped


def fused_stream_run(scene: dict, model: SceneDepthModel, fused: bool,
                     closure: bool, frames=None, sync_from=None,
                     **cfg) -> tuple:
    """One pass of the scene through ``StreamingReconstructor.run``: the
    fused route (per frame when the model's batch is 1, else batched) or
    the stepwise one, with the generator's draws seeded 0 in both. Returns
    (reconstructor, wall seconds)."""
    import txr_torch.pipelines.streaming as st
    from txr_torch.core.config import StreamingConfig

    fx, fy, cx, cy = SFM_K
    intr = CameraIntrinsics(fx=fx, fy=fy, cx=cx, cy=cy, width=SFM_W,
                            height=SFM_H)
    rec = st.StreamingReconstructor(
        intr, depth_model=model, use_icp=True, verbose=False, fused=fused,
        config=StreamingConfig(loop_closure=closure,
                               stream_batch=model.batch,
                               **dict(STREAM_CFG, **cfg)))
    saved = st.read_rows
    st.read_rows = host_reads_allowed(saved)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.run(SceneFrames(scene, model, frames, sync_from))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        st.read_rows = saved
    return rec, wall


def routes_agree(name: str, fused, step) -> dict:
    """The fused and stepwise runs of one setting held together: the same
    fused and skipped counts, loops and ICP decisions; poses within
    STREAM_FUSED_POSE_ATOL."""
    dR = max(float(np.abs(a[0] - b[0]).max())
             for a, b in zip(fused.poses, step.poses))
    dt = max(float(np.abs(a[1] - b[1]).max())
             for a, b in zip(fused.poses, step.poses))
    out = {"fused": [fused.frames_processed, step.frames_processed],
           "skipped": [fused.frames_skipped, step.frames_skipped],
           "loops": [fused.loop_edges, step.loop_edges],
           "icp_frames": [fused.icp_frames, step.icp_frames],
           "pose_R_max_abs_diff": dR, "pose_t_max_abs_diff": dt,
           "scale": [fused.scale, step.scale],
           "voxels": [int(offset_map_size(fused.map)),
                      int(offset_map_size(step.map))]}
    if (out["fused"][0] != out["fused"][1]
            or out["skipped"][0] != out["skipped"][1]
            or fused.loop_edges != step.loop_edges
            or fused.icp_frames != step.icp_frames
            or len(fused.poses) != len(step.poses)):
        raise AssertionError(f"stream_fused_path {name}: the routes "
                             f"disagree: {out}")
    return out


def programs_of_cache() -> list:
    import txr_torch.pipelines.streaming as st

    return [p for step in st._FUSED_STEP_CACHE.values()
            for p in step.programs]


def graph_record(programs: list) -> dict:
    """Capture time, graph pool, replays and hand-kernel launches (the
    warm-up call's and per replay times the replays) of some programs."""
    launches = {}
    for p in programs:
        for k, n in p.device_launches().items():
            launches[k] = launches.get(k, 0) + n
    return {"programs": [{"name": p.name, "capture_s": p.capture_s,
                          "pool_bytes": p.pool_bytes, "replays": p.replays,
                          "launches_per_replay": {k: n for k, n in
                                                  p.launches.items() if n}}
                         for p in programs],
            "device_launches": launches}


def replay_against_eager(program) -> dict:
    """One eager call of a captured step against one replay on the same
    inputs (its static inputs as they stand): every output bit for bit."""
    want = [t.clone() for t in program.eager(*program.inputs)]
    got = program(*program.inputs)
    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if g.shape != w.shape or not torch.equal(
               g.reshape(-1).view(torch.uint8),
               w.reshape(-1).view(torch.uint8))]
    if bad:
        raise AssertionError(f"stream_fused_path: a replay of "
                             f"{program.name} differs from its eager call "
                             f"in outputs {bad}")
    return {"program": program.name, "outputs": len(want),
            "bit_equal": True}


def pair_step_graphed(scene: dict) -> dict:
    """One odometry pair's ``pair_step`` (frames 0 and 1, SIFT at the
    stream's settings) eager and as a replay of its own CUDA graph: wall
    ms a call (3 calls, host clock, ending in a sync), and one eager call's
    launches and device ms under the profiler."""
    from txr_torch.pipelines.stream_step import GraphedProgram

    det = SIFTDetector(n_features=3000, capacity=4096)
    f0, f1 = (det.detect(scene["bgr"][i]) for i in (0, 1))
    idx2, ok = match_l2_ratio(f0.desc, f1.desc, f0.mask, f1.mask, 0.75)
    K = torch.tensor(np.array([[SFM_K[0], 0, SFM_K[2]], [0, SFM_K[1],
                                                          SFM_K[3]],
                               [0, 0, 1]], np.float32), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    prio = torch.rand((2, 1024, 4096), generator=gen, device="cuda")
    args = (f0.uv, f1.uv[idx2], ok, prio)

    def fn(a, b, m, p):
        return pair_step(a, b, m, K, None, 2.0, 0.1, 600.0,
                         priorities=(p[0], p[1]))

    prog = GraphedProgram(fn, "pair_step")
    prog(*args)
    launches, device_ms, _ = count_kernels(lambda: prog.eager(*args))
    out = {"launches": launches, "device_ms": device_ms}
    for name, call in (("eager", lambda: prog.eager(*args)),
                       ("replay", lambda: prog(*args))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    got, want = prog(*args), prog.eager(*args)
    out["replay_bit_equal"] = all(torch.equal(g, w)
                                  for g, w in zip(got, want))
    if not out["replay_bit_equal"]:
        raise AssertionError(f"pair_step: a replay differs from the eager "
                             f"call: {out}")
    return out


def stream_fused_path(stepwise=None) -> dict:
    """reconstruction_torch.py's fused stream on the card. Run A': run A's
    scene (17 frames of 1080 x 1920, STREAM_CFG) through the per-frame fused
    step against the stepwise route on the same draws (stream_path's runs,
    ``stepwise``, or its own when None), closure off and on, and both once
    more at the radius at which ICP is accepted; a replay against the eager
    step; the steady state under the sync debug mode; frames/s of the three
    routes; one profiled run; pair_step eager and graphed. Run B: the CLI at
    its defaults (the batched fused route); with --no-fused it is
    stream_path's run B."""
    import txr_torch.pipelines.streaming as st

    t_phase = time.perf_counter()
    parts = {}

    def part(name):
        parts[name] = time.perf_counter() - t_phase - sum(parts.values())

    dev = torch.device("cuda")
    scene = two_plane_scene(SFM_H, SFM_W, SFM_K, len(STREAM_CAMS), dev,
                            cams=STREAM_CAMS)
    rel = scene["depth"] / SFM_SCENE["depth_div"]
    one, batched = SceneDepthModel(rel, 1), SceneDepthModel(
        rel, STREAM_FUSED_BATCH)
    st._FUSED_STEP_CACHE.clear()
    part("scene")

    # ---- per-frame fused, closure off: the first run captures the graph,
    # the second is the steady state under the sync debug mode
    kernels.reset_launches()
    cold, wall_cold = fused_stream_run(scene, one, True, False)
    capture = graph_record(programs_of_cache())
    part("fused_cold")
    torch.cuda.reset_peak_memory_stats()
    f_off, wall_f_off = fused_stream_run(scene, one, True, False,
                                         sync_from=1)
    peak_fused = torch.cuda.max_memory_allocated()
    part("fused_closure_off_sync_checked")
    if stepwise is None:
        stepwise = {}
        for key, closure in (("off", False), ("on", True)):
            rec, wall = fused_stream_run(scene, one, False, closure)
            stepwise.update({key: rec, f"wall_{key}": wall})
        part("stepwise_runs")
    s_off, wall_s_off = stepwise["off"], stepwise["wall_off"]
    off = routes_agree("closure off", f_off, s_off)
    pairs_off, drift_off = stream_truth(scene, f_off.poses)

    # ---- closure on
    f_on, wall_f_on = fused_stream_run(scene, one, True, True)
    s_on, wall_s_on = stepwise["on"], stepwise["wall_on"]
    on = routes_agree("closure on", f_on, s_on)
    pairs_on, drift_on = stream_truth(scene, f_on.poses)
    part("fused_closure_on")

    # ---- ICP at the radius at which it is accepted
    f_icp, _ = fused_stream_run(scene, one, True, False,
                                icp_max_correspondence=STREAM_ICP_WIDE)
    s_icp, _ = fused_stream_run(scene, one, False, False,
                                icp_max_correspondence=STREAM_ICP_WIDE)
    icp = routes_agree("ICP at 0.1 m", f_icp, s_icp)
    part("icp_wide_both_routes")

    # ---- a replay of the per-frame step against its eager call
    step_prog = next(p for p in programs_of_cache()
                     if p.name == "fused_stream_step")
    replay = replay_against_eager(step_prog)
    part("replay_against_eager")

    # ---- batched fused (B 8): cold, then timed; closure on once
    b_cold, wall_b_cold = fused_stream_run(scene, batched, True, False)
    b_off, wall_b_off = fused_stream_run(scene, batched, True, False)
    b_on, wall_b_on = fused_stream_run(scene, batched, True, True)
    pairs_b, _ = stream_truth(scene, b_off.poses)
    part("batched")

    # ---- one profiled run of the per-frame fused step (graphs captured)
    prof = kernel_breakdown(lambda: fused_stream_run(
        scene, one, True, False, frames=STREAM_PROFILE_FRAMES))
    part("fused_profiled")
    pair = pair_step_graphed(scene)
    part("pair_step_graphed")
    graphs = graph_record(programs_of_cache())
    n = len(STREAM_CAMS)
    err = lambda prs: {  # noqa: E731
        "worst_rot_err_deg": max(p[0] for p in prs),
        "worst_t_dir_err_deg": max(p[1] for p in prs)}
    bad = [(run, p) for run, prs in (("off", pairs_off), ("on", pairs_on),
                                     ("batched", pairs_b))
           for p, (r, d) in enumerate(prs)
           if r > SFM_TOL["rot_deg"] or d > SFM_TOL["t_dir_deg"]]
    run_a = {
        "frames": n, "cams": STREAM_CAMS,
        "frames_per_second": {"stepwise": n / wall_s_off,
                              "fused_per_frame": n / wall_f_off,
                              "fused_batched": n / wall_b_off,
                              "fused_per_frame_cold": n / wall_cold,
                              "fused_batched_cold": n / wall_b_cold},
        "closure_on_frames_per_second": {
            "stepwise": n / wall_s_on, "fused_per_frame": n / wall_f_on,
            "fused_batched": n / wall_b_on},
        "host_reads_per_frame": {"fused_per_frame": f_off.drains / n,
                                 "fused_per_frame_closure_on":
                                 f_on.drains / n,
                                 "fused_batched": b_off.drains / n},
        "closure_off": dict(off, **err(pairs_off),
                            end_drift_units=drift_off),
        "closure_on": dict(on, **err(pairs_on), end_drift_units=drift_on,
                           loops_closed=f_on.loops_closed),
        "icp_at_0.1_m": dict(icp, icp_accepted=[f_icp.icp_accepted,
                                                s_icp.icp_accepted]),
        "batched": {"fused": b_off.frames_processed,
                    "skipped": b_off.frames_skipped, **err(pairs_b),
                    "voxels": int(offset_map_size(b_off.map)),
                    "closure_on_loops": b_on.loops_closed,
                    "closure_on_fused": b_on.frames_processed},
        "sync_debug_error_between_drains": True,
        "replay_against_eager": replay,
        "capture": capture, "graphs": graphs,
        "peak_memory_bytes_fused_per_frame": peak_fused,
        "profiled": dict(prof, frames=STREAM_PROFILE_FRAMES, closure=False),
        "pair_step_eager_and_graphed": pair,
        "device_busy_share_profiled_call": prof["device_ms"]
        / prof["wall_ms_under_profiler"],
        # its device time a frame over the timed closure-off run's wall a
        # frame (the same seeded frames)
        "profiled_device_ms_per_frame_over_closure_off_wall":
        prof["device_ms"] / STREAM_PROFILE_FRAMES / (wall_f_off * 1e3 / n)}
    if (bad or f_off.frames_processed != n or f_on.loops_closed < 1
            or f_icp.icp_accepted < 1 or b_off.frames_processed != n
            or off["pose_R_max_abs_diff"] > STREAM_FUSED_POSE_ATOL
            or off["pose_t_max_abs_diff"] > STREAM_FUSED_POSE_ATOL
            or on["pose_R_max_abs_diff"] > STREAM_FUSED_POSE_ATOL
            or on["pose_t_max_abs_diff"] > STREAM_FUSED_POSE_ATOL
            or capture["device_launches"].get("offset_reduce", 0) < n):
        raise AssertionError(f"stream_fused_path run A': pairs off SFM_TOL "
                             f"{bad}: {run_a}")
    run_b_step = stepwise.get("run_b")
    del one, batched, cold, f_off, s_off, f_on, s_on, f_icp, s_icp, stepwise
    del b_cold, b_off, b_on, step_prog
    st._FUSED_STEP_CACHE.clear()

    # ---- Run B: the CLI at its defaults (batched fused); with --no-fused
    frames = list(scene["bgr"][:STREAM_CLI_FRAMES].cpu().numpy())
    del scene, rel
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as td:
        run_b = stream_cli_run(frames, td, warm=True)
    run_b["graphs"] = graph_record(programs_of_cache())
    # the depth forward's graph (attention and tail kernels inside) against
    # its eager call on its last inputs
    run_b["replay_against_eager"] = replay_against_eager(next(
        p for p in programs_of_cache() if p.name == "fused_stream_batch_head"))
    st._FUSED_STEP_CACHE.clear()
    part("run_b_cli_fused")
    if run_b_step is None:
        with tempfile.TemporaryDirectory() as td:
            run_b_step = stream_cli_run(frames, td, ["--no-fused"])
        part("run_b_cli_no_fused")
    launches = run_b["graphs"]["device_launches"]
    path_launches = {k: graphs["device_launches"].get(k, 0)
                     + launches.get(k, 0) for k in kernels.launches}
    if not (run_b["route"] == "fused_batched"
            and run_b_step["route"] == "stepwise"
            and all(launches.get(k, 0) > 0
                    for k in ("attention", "dpt_tail", "offset_reduce"))
            and launches.get("upsample") == UPSAMPLES * launches["dpt_tail"]):
        raise AssertionError(f"stream_fused_path run B: {run_b}, "
                             f"{run_b_step}")
    out = {"phase": "stream_fused_path", "input": [SFM_H, SFM_W],
           "sfm_tolerance": SFM_TOL, "run_a": run_a, "run_b": run_b,
           "run_b_no_fused": run_b_step,
           # launches on the card: each graph's per replay times its
           # replays and its warm-up calls' (run A' and B)
           "launches": path_launches,
           "launches_over_steps": 1,
           "phase_wall_s": time.perf_counter() - t_phase,
           "phase_parts_s": parts, "ok": True}
    emit(out)
    return out


def bf16_vs_f32(frames: int, int8_share: dict) -> dict:
    """The depth error of the port's bf16 arithmetic: the default model
    (bf16, attention and tail kernels) against an f32 model carrying the
    same bf16-rounded weights with ``use_flash=False`` and
    ``fused_head=False`` (``txr``'s f32 arithmetic on bf16 parameters), on
    main_path's 8 seeded 1080p frames, as a share of the f32 depth's span;
    printed beside ``int8_share``, depth_cli_path's ``"int8"`` policy
    against bf16 in the same run."""
    in_h, in_w = compute_da_resize(H, W, 518)
    bf16, _, _ = build_model("v2", "vitl", dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
    with scoped_env({"TXR_FUSED_HEAD": "0"}):
        f32, _, dpt_cfg = build_model("v2", "vitl", use_flash=False,
                                      dtype=torch.float32,
                                      generator=torch.Generator().manual_seed(0))
    f32.load_state_dict({k: v.float() for k, v in bf16.state_dict().items()})
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (frames, H, W, 3),
                                      dtype=np.uint8)).cuda()
    mean = torch.tensor(IMAGENET_MEAN, device="cuda")
    std = torch.tensor(IMAGENET_STD, device="cuda")
    with torch.no_grad():
        xm = resize_bicubic(x.to(torch.float32) / 255.0, in_h, in_w,
                            align_corners=False)
        xn = (xm - mean) / std
        kernels.reset_launches()
        d_bf16 = bf16(xn.to(torch.bfloat16)).to(torch.float32)
        torch.cuda.synchronize()
        used_bf16 = dict(kernels.launches)
        kernels.reset_launches()
        d_f32 = f32(xn)
        torch.cuda.synchronize()
        used_f32 = dict(kernels.launches)
    # both models take the residual and upsample kernels, each in its own
    # dtype (the f32 model's unfused tail a fifth resize)
    if (any(v for k, v in used_f32.items()
            if k not in ("residual_norm", "upsample"))
            or used_f32["residual_norm"] != RESIDUALS * 24
            or used_bf16["residual_norm"] != RESIDUALS * 24
            or used_f32["upsample"] != UPSAMPLES + 1
            or used_bf16["upsample"] != UPSAMPLES
            or used_bf16["attention"] != 24
            or used_bf16["dpt_tail"] != 1 or dpt_cfg.fused_head is not False):
        raise AssertionError(f"bf16 model launched {used_bf16}, f32 model "
                             f"{used_f32}")
    if not (torch.isfinite(d_f32).all() and torch.isfinite(d_bf16).all()):
        raise AssertionError("bf16_vs_f32: depth is not finite")
    ref = d_f32.cpu().numpy()
    share = depth_share(d_bf16.cpu().numpy() - ref,
                        float(ref.max() - ref.min()))
    out = {"phase": "bf16_vs_f32", "model": "v2/vitl", "frames": frames,
           "input": [H, W], "model_input": [in_h, in_w],
           "depth_bf16_vs_f32": share,
           "depth_int8_policy_vs_bf16": int8_share,
           "launches": {"bf16": used_bf16, "f32": used_f32}, "ok": True}
    emit(out)
    del bf16, f32
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- training

TRAIN_BATCH = 4                 # frames of a train step
TRAIN_WARMUP, TRAIN_TIMED = 2, 8
# make_optimizer's defaults, txr's (lr 1e-5, 100 warm-up steps). Adam's
# first step with a rate moves every weight by about that rate, all in
# step; with one warm-up step it came at 1e-4 (or 1e-5) and threw the
# seeded ViT-L's loss from 0.451 to 1.17 and its head to 20 m everywhere,
# where the sigmoid's gradient vanishes. The same jump shows on the plain
# route and in f32 without autocast (tools/train_path_dev.py --witness;
# PERF.md, train_path)
TRAIN_OPT = dict(lr=1e-5, warmup_steps=100, total_steps=10_000)
TRAIN_COMPARE_BATCH = 1
TRAIN_COMPARE_WHY = (
    "the plain attention's forward keeps its f32 scores and probabilities "
    "of every layer for the backward, 0.76 GB a frame and layer at 2443 "
    "tokens: 18 GB for 24 layers at one frame, 73 GB at four")
# the train loss and its parts, each a function of train.depth_loss_sums'
# seven sums, whose gradients the two routes compare apart. With m1 the
# mean of d = log(pred) - log(target) over valid pixels: SILog is
# log_variance + 0.5 m1^2, and only its m1 part sees a common scale of the
# prediction
LOSS_TERMS = {
    "loss": lambda s: train.loss_from_sums(s),
    "silog": lambda s: train.silog_from_sums(s[:3]),
    "gradient": lambda s: train.gradient_from_sums(s[3:]),
    "log_variance": lambda s: train.silog_from_sums(s[:3], lam=1.0),
    "mean_log_ratio": lambda s: s[0] / torch.clamp(s[2], min=1.0),
}
_TRAIN_TOL_WHY = (
    "both routes run bf16 autocast and differentiate the same plain "
    "backward; they differ where the forward rounds: the attention kernel "
    "rounds the probabilities before it normalises, the plain version "
    "after (ATTN_TOL: 4 bf16 ulps), and the tail kernel keeps its upsampled "
    "image and conv2 sums where the plain version rounds them to bf16 "
    "(TAIL_TOL). A parameter's gradient is held to a share of its norm, or "
    "of grad_floor times the global norm where its own is smaller")
TRAIN_TOL = {
    # on an H100 at 700 W, kernels against plain versions at one frame,
    # readings: loss 1.7e-3, gradient norm 3.03e-2 to 3.05e-2 in
    # four runs, worst parameter 4.7e-2. The spread is SILog's m1 part: the
    # kernel route's mean log depth sits 3.3e-3 above the plain route's
    # (m1 0.0922 against 0.0889), and |dm1| |grad m1| = 0.64 of the SILog
    # gradients' distance of 0.68. The scale-blind parts below agree 30 to
    # 150 times closer in norm
    "loss": dict(loss_rtol=2.0 ** -7, norm_rtol=2.0 ** -3, grad_rel=2.0 ** -2),
    "silog": dict(loss_rtol=2.0 ** -7, norm_rtol=2.0 ** -3, grad_rel=2.0 ** -2),
    # m1 itself (3.7e-2 apart, being near 0); its gradient 1.2e-3, 5.3e-3
    "mean_log_ratio": dict(loss_rtol=2.0 ** -3, norm_rtol=2.0 ** -7,
                           grad_rel=2.0 ** -5),
    # the backward at the plain route's d loss / d prediction: the product
    # 1.4e-2 apart, the norm 1.9e-2, worst 4.4e-2 (each route's Jacobian
    # at its own forward, the same m1 shift)
    "cotangent": dict(loss_rtol=2.0 ** -4, norm_rtol=2.0 ** -4,
                      grad_rel=2.0 ** -2),
    # the checks that hold the backward tight, scale-blind: readings 2.3e-3
    # / 1.9e-4 / 3.1e-2 (log variance) and 2.8e-3 / 1.0e-3 / 1.3e-2
    # (gradient matching); TRAIN_CONTROL must fail the first
    "log_variance": dict(loss_rtol=2.0 ** -7, norm_rtol=2.0 ** -7,
                         grad_rel=2.0 ** -4),
    "gradient": dict(loss_rtol=2.0 ** -6, norm_rtol=2.0 ** -7,
                     grad_rel=2.0 ** -4),
    # TXR_FUSED_CONVS=1 against cuDNN at 4 frames: 4.6e-7 / 3.8e-5 / 2.6e-3
    "conv": dict(loss_rtol=2.0 ** -7, norm_rtol=2.0 ** -4, grad_rel=2.0 ** -3),
}
for _t in TRAIN_TOL.values():
    _t["grad_floor"] = 2.0 ** -10
# a fault the log-variance check must reject: one block's attention
# backward handed a gradient 1 + 2^-2 times too large (a pre-hook on its
# proj), which moves that block's qkv gradients by 25 %
TRAIN_CONTROL = dict(block=12, scale=1.25, term="log_variance")
# the kernel route's forward against the plain route's at the path's batch
TRAIN_FWD_TOL = dict(
    loss_rtol=2.0 ** -7, median_share=0.01, max_share=0.10,
    why="the forward's rounding as above, over 4 frames; the depth as "
        "shares of the plain depth's span, as SEQ_LIMIT")
# the NCCL check's schedule: lr 0 at step 0, so both steps' first
# gradients are taken at the same weights, then one update at 1e-6, whose
# effect the third step's loss shows
TRAIN_NCCL_OPT = dict(lr=1e-6, warmup_steps=1, total_steps=100)
TRAIN_NCCL_TOL = dict(
    loss_rtol=1e-6, norm_rtol=1e-3, grad_rel=2.0 ** -6,
    grad_floor=2.0 ** -10, after_rtol=2.5e-3, moved_over_after=10.0,
    param_atol_lr=2.01,
    why="mesh (1, 1): the sharded step runs the unsharded step's kernels on "
        "DTensors of one rank, and the losses before the update are "
        "bit-equal; the backward is not deterministic run to run (atomic "
        "adds, as in the position embeddings' bicubic resize: the same "
        "unsharded step at the same weights gave norms 1.0e-5 apart, the "
        "sharded and unsharded 2.0e-7 and 4.3e-5 in two runs, a parameter's "
        "gradient 3.4e-3 of its norm), and Adam's first step with a rate moves each weight by "
        "+-lr whatever the gradient's size, so a flipped sign of a gradient "
        "near zero moves a parameter 2 lr (lr: the rates applied, summed; "
        "|m/sqrt(v)| <= 1.0036 at Adam's third step with its bias "
        "corrections) beyond the f32 rounding of each parameter (2 eps |p|), "
        "and the loss after the update 5.9e-4; the update itself must move "
        "the loss by moved_over_after times after_rtol (6.5e-2 measured), "
        "so a step that applies no update, or the opposite one, fails")


def train_batch(frames: int) -> tuple:
    """main_path's preprocess of ``frames`` seeded 1080p frames (518 x 924,
    2443 tokens), a seeded smooth positive metric depth (0.5 to 10 m) and
    a seeded mask with about 10 % of the pixels invalid."""
    in_h, in_w = compute_da_resize(H, W, 518)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(0, 256, (frames, H, W, 3),
                                      dtype=np.uint8)).cuda()
    mean = torch.tensor(IMAGENET_MEAN, device="cuda")
    std = torch.tensor(IMAGENET_STD, device="cuda")
    with torch.no_grad():
        xm = resize_bicubic(x.to(torch.float32) / 255.0, in_h, in_w,
                            align_corners=False)
        images = (xm - mean) / std
        coarse = torch.from_numpy(rng.uniform(
            0.5, 10.0, (frames, 1, 8, 14)).astype(np.float32)).cuda()
        target = F.interpolate(coarse, size=(in_h, in_w), mode="bilinear",
                               align_corners=True)[:, 0]
        mask = torch.from_numpy(rng.uniform(size=(frames, in_h, in_w))
                                >= 0.1).cuda()
    return images, target, mask, xm


def train_model(env: dict = None, **kw) -> tuple:
    """v2 / ViT-L with the metric head (sigmoid x 20 m: a prediction that
    is never clamped), f32 master weights drawn on the card from seed 0,
    built as a user builds it: ``TXR_FUSED_HEAD`` / ``TXR_FUSED_CONVS``
    from ``env``."""
    with scoped_env(env or {}):
        return build_model("v2", "vitl", metric=True, max_depth=20.0,
                           dtype=torch.float32,
                           generator=torch.Generator(
                               device="cuda").manual_seed(0), **kw)


def grads_of(model, images, target, mask, term: str = "loss") -> tuple:
    """One forward and backward of a LOSS_TERMS term; the term's value,
    the gradients (by name) and the launches of the forward and
    backward."""
    model.zero_grad(set_to_none=True)
    kernels.reset_launches()
    loss = LOSS_TERMS[term](train.loss_sums(model, images, target, mask))
    loss.backward()
    torch.cuda.synchronize()
    used = {k: v for k, v in kernels.launches.items() if v}
    return (loss.item(), {n: p.grad for n, p in model.named_parameters()},
            used)


def cotangent_of(model, images, target, mask) -> torch.Tensor:
    """d loss / d prediction at ``model``'s prediction (no graph kept)."""
    with torch.no_grad(), kernel_autocast("cuda"):
        pred = model(images).float()
    pred.requires_grad_(True)
    train.loss_from_sums(train.depth_loss_sums(pred, target, mask)
                         ).backward()
    return pred.grad


def vjp_of(model, images, cotangent: torch.Tensor) -> tuple:
    """The parameters' gradients of <prediction, cotangent>: the network's
    backward alone, at a cotangent both routes share; the product's value,
    the gradients and the launches, as ``grads_of``."""
    model.zero_grad(set_to_none=True)
    kernels.reset_launches()
    with kernel_autocast("cuda"):
        pred = model(images)
    dot = (pred.float() * cotangent).sum()
    dot.backward()
    torch.cuda.synchronize()
    used = {k: v for k, v in kernels.launches.items() if v}
    return (dot.item(), {n: p.grad for n, p in model.named_parameters()},
            used)


def control_fault(model):
    """TRAIN_CONTROL's fault on ``model``; returns the hook's handle."""
    proj = getattr(model.encoder, f"block_{TRAIN_CONTROL['block']}").attn.proj

    def scale_grad(_, args):
        if args[0].requires_grad:
            args[0].register_hook(lambda g: g * TRAIN_CONTROL["scale"])

    return proj.register_forward_pre_hook(scale_grad)


def grad_errors(got: dict, want: dict, floor_share: float) -> dict:
    """Gradients by name against others: the global norms, and the worst
    parameter's distance as a share of its norm, or of ``floor_share`` of
    the global norm where its own is smaller."""
    names = list(want)
    norm_g = train.global_norm([got[n] for n in names]).item()
    norm_w = train.global_norm([want[n] for n in names]).item()
    floor = floor_share * norm_w
    worst, worst_name, dots, diff2 = 0.0, None, 0.0, 0.0
    for n in names:
        g, w = got[n].float(), want[n].float()
        d = (g - w).norm().item()
        rel = d / max(w.norm().item(), floor)
        dots += (g * w).sum().item()
        diff2 += d * d
        if rel > worst:
            worst, worst_name = rel, n
    return {"grad_norm": norm_g, "grad_norm_ref": norm_w,
            "grad_norm_rel_err": abs(norm_g - norm_w) / norm_w,
            "grad_diff_norm": diff2 ** 0.5,
            "worst_param_grad_rel_err": worst, "worst_param": worst_name,
            "grad_cosine": dots / (norm_g * norm_w), "params": len(names)}


def compare_grads(case: str, got: tuple, want: tuple, tol: dict) -> dict:
    """The loss, the global gradient norm and each parameter's gradient of
    ``got`` against ``want`` (both ``grads_of``), to ``tol``."""
    loss_g, g, _ = got
    loss_w, w, _ = want
    out = {"case": case, "loss": loss_g, "loss_ref": loss_w,
           "loss_rel_err": abs(loss_g - loss_w) / abs(loss_w),
           **grad_errors(g, w, tol["grad_floor"]), "tolerance": tol}
    out["ok"] = (out["loss_rel_err"] <= tol["loss_rtol"]
                 and out["grad_norm_rel_err"] <= tol["norm_rtol"]
                 and out["worst_param_grad_rel_err"] <= tol["grad_rel"])
    if not out["ok"]:
        emit({"phase": "train_check", **out, "why": _TRAIN_TOL_WHY})
        raise AssertionError(f"train_path/{case}: {out}")
    return out


def forward_routes(model, plain_model, layers: int, images, target,
                   mask) -> dict:
    """The kernel route's loss and depth against the plain route's at the
    path's batch, forward only (the plain attention keeps nothing for a
    backward under no_grad), to TRAIN_FWD_TOL."""
    runs = {}
    with torch.no_grad():
        for name, m in (("kernels", model), ("plain", plain_model)):
            kernels.reset_launches()
            with kernel_autocast("cuda"):
                pred = m(images).float()
            loss = train.loss_from_sums(train.depth_loss_sums(pred, target,
                                                              mask))
            torch.cuda.synchronize()
            runs[name] = (loss.item(), pred, {k: v for k, v in
                                              kernels.launches.items() if v})
    (loss_k, pred_k, used_k), (loss_p, pred_p, used_p) = (runs["kernels"],
                                                          runs["plain"])
    if (used_k != {"attention": layers, "dpt_tail": 1,
                   "residual_norm": RESIDUALS * layers, "upsample": UPSAMPLES}
            or used_p != {"residual_norm": RESIDUALS * layers,
                          "upsample": UPSAMPLES + 1}):
        raise AssertionError(f"train_path/forward: kernel route launched "
                             f"{used_k}, plain route {used_p}")
    if not (torch.isfinite(pred_k).all() and torch.isfinite(pred_p).all()):
        raise AssertionError("train_path/forward: depth is not finite")
    ref = pred_p.cpu().numpy()
    share = depth_share(pred_k.cpu().numpy() - ref,
                        float(ref.max() - ref.min()))
    out = {"case": "kernels vs plain versions, forward",
           "frames": images.shape[0], "loss": loss_k, "loss_ref": loss_p,
           "loss_rel_err": abs(loss_k - loss_p) / abs(loss_p),
           "depth": share,
           "tolerance": {k: v for k, v in TRAIN_FWD_TOL.items()
                         if k != "why"}}
    out["ok"] = (out["loss_rel_err"] <= TRAIN_FWD_TOL["loss_rtol"]
                 and share["median_share_of_span"]
                 <= TRAIN_FWD_TOL["median_share"]
                 and share["max_share_of_span"] <= TRAIN_FWD_TOL["max_share"])
    if not out["ok"]:
        emit({"phase": "train_check", **out, "why": TRAIN_FWD_TOL["why"]})
        raise AssertionError(f"train_path/forward: {out}")
    return out


# a site of shift_by_layer "stands out" at this many standard errors
SHIFT_Z = 6.0


def site_groups(name: str, diff: torch.Tensor, heads: int) -> torch.Tensor:
    """The groups of ``shift_by_layer``'s standard error at a site, as the
    rows of a view of its difference: an encoder site (B, S, C) by frame
    and head, since an attention output's error carries a part common to
    all its tokens (every query of a head weighs the same keys, and nearly
    evenly in a seeded net), which contiguous cuts of tokens would count
    once per cut; a head site (B, C, H, W) by frame and channel; the log
    depth in contiguous cuts."""
    if name.startswith("block_"):
        b, t, c = diff.shape
        return diff.reshape(b, t, heads, c // heads).permute(
            0, 2, 1, 3).reshape(b * heads, -1)
    if name.startswith("head."):
        return diff.reshape(diff.shape[0] * diff.shape[1], -1)
    return None


def shift_by_layer(model, plain_model, layers: int, images) -> dict:
    """Where the kernel route's forward first departs in its mean from the
    plain route's (the seeded ViT-L's mean log depth sat 3.3e-3 higher on
    the kernel route): at the path's batch on both routes, every block's
    attention output and output, the four fusion blocks' outputs, the
    tail's input (head_conv1's output) and the log depth; at each site the
    kernel route less the plain route as ``signed_error`` over the plain
    tensor's rms (the log depth in log units), its standard error from
    ``site_groups`` (``mean_signed_z``) and, beside it, from contiguous
    cuts (``contiguous_z``). The first site whose mean lies more than
    SHIFT_Z standard errors from 0 is named. Beside them each kernel's own
    signed error on the operands the kernel route handed it (every block's
    qkv and the tail's, through ``Capture``), which no earlier layer's
    difference reaches. Last, the tail's plain version on the kernel
    route's own input with conv2's bias and conv3's weight and bias in f32
    (as the kernel reads them) and as bf16 (as autocast hands them to the
    plain route's convs): the log depth between the two."""
    def sites(m):
        named = []
        for i in range(layers):
            blk = getattr(m.encoder, f"block_{i}")
            named += [(f"block_{i}.attn", blk.attn), (f"block_{i}", blk)]
        return named + [(f"head.{n}", getattr(m.head, n)) for n in (
            "fusion_3", "fusion_2", "fusion_1", "fusion_0", "head_conv1")]

    cap = Capture(blocks=range(layers))
    acts = {}
    for route, m in (("kernels", model), ("plain", plain_model)):
        store = acts[route] = {}
        handles = [mod.register_forward_hook(
            lambda _m, _a, out, name=name: store.__setitem__(name,
                                                             out.float()))
            for name, mod in sites(m)]
        try:
            with torch.no_grad(), kernel_autocast("cuda"), (
                    cap.during(m, images) if route == "kernels"
                    else contextlib.nullcontext()):
                store["log_depth"] = m(images).float().log()
        finally:
            for h in handles:
                h.remove()
    rows = []
    for name in [n for n, _ in sites(model)] + ["log_depth"]:
        got, want = acts["kernels"].pop(name), acts["plain"].pop(name)
        scale = 1.0 if name == "log_depth" else want.pow(2).mean().sqrt(
        ).item()
        diff = got - want
        rows.append({"site": name, **signed_error(
            diff, scale, site_groups(name, diff, model.vit.num_heads)),
            "contiguous_z": signed_error(diff, scale)["mean_signed_z"]})
        del got, want, diff
    heads = model.vit.num_heads
    head_dim = model.vit.hidden_size // heads
    own = []
    with torch.no_grad():
        for i, qkv in sorted(cap.qkv.items()):
            want = attention_reference(qkv, heads, head_dim).float()
            got = fused_attention(qkv, heads, head_dim).float()
            diff, scale = got - want, want.pow(2).mean().sqrt().item()
            own.append({"kernel": "attention", "block": i, **signed_error(
                diff, scale, site_groups(f"block_{i}", diff, heads)),
                "contiguous_z": signed_error(diff, scale)["mean_signed_z"]})
            del got, want, diff
        tail = cap.tail_args()
        want = tail_exact(tail)
        got = fused_head_tail(*tail).float()
        own.append({"kernel": "dpt_tail", **signed_error(
            got - want, want.pow(2).mean().sqrt().item())})
        x, w2, b2, w3, b3, out_h, out_w = tail[:7]
        rounded = head_tail_reference(
            x.float(), *(t.to(torch.bfloat16).float()
                         for t in (w2, b2, w3, b3)), out_h, out_w)
        cfg = model.head.cfg
        head = ((lambda y: torch.sigmoid(y) * cfg.max_depth) if cfg.metric
                else F.relu)
        weights = signed_error(head(want).log() - head(rounded).log(), 1.0)
        del got, want, rounded
    del cap, acts
    torch.cuda.empty_cache()
    first = next((r["site"] for r in rows
                  if abs(r["mean_signed_z"]) > SHIFT_Z), None)
    out = {"phase": "train_shift", "frames": images.shape[0],
           "groups": "encoder: frame x head; head: frame x channel; log "
                     f"depth: {BIAS_GROUPS} contiguous",
           "stands_out_at_z": SHIFT_Z,
           "first_site_that_stands_out": first,
           "log_depth_shift": rows[-1]["mean_signed_rel"],
           "own_kernel_max_abs_z": max(abs(r["mean_signed_z"]) for r in own),
           "log_depth_shift_of_f32_tail_weights": weights["mean_signed_rel"],
           "sites": rows, "own_kernel_errors": own}
    emit(out)
    return {k: out[k] for k in ("first_site_that_stands_out",
                                "log_depth_shift", "own_kernel_max_abs_z",
                                "log_depth_shift_of_f32_tail_weights")}


def check_tail_cache(model, size: tuple, gen: torch.Generator) -> dict:
    """After optimizer steps the tail's operands derived from the weights
    (packed conv2, biases) must be those of the new weights: the kernel
    with the head's cached operands against its plain version at the
    current parameters, at the path's shape, to the kernel_check
    tolerance. ``size``: the model's input (the tail's output)."""
    head = model.head
    packed_w2 = head._tail_ops["head_conv"][0]
    key = packed_w2._key
    ph, pw = size[0] // 14, size[1] // 14
    x = torch.randn((1, 8 * ph, 8 * pw, head.head_conv2.in_channels),
                    generator=gen, device="cuda").to(torch.bfloat16)
    w2 = head.head_conv2.weight.detach().permute(2, 3, 1, 0)
    args = (w2, head.head_conv2.bias.detach(),
            head.head_conv3.weight.detach().reshape(-1),
            head.head_conv3.bias.detach())
    with torch.no_grad():
        got = fused_head_tail(x, *args, *size, head.tail_operands())
        # the kernel's operands: conv2's weight in bf16, the rest in f32
        want = head_tail_reference(
            x.float(), w2.to(torch.bfloat16).float(),
            *[a.float() for a in args[1:]], *size)
    err = compare("dpt_tail", "after optimizer steps, cached operands",
                  got, want, TAIL_TOL["atol"], TAIL_TOL["rtol"],
                  TAIL_TOL["why"], TAIL_TOL["rms_rtol"])["max_abs_err"]
    return {"case": "tail operands after optimizer steps",
            "max_abs_err": err, "derived_anew": packed_w2._key != key,
            "ok": True}


def check_conv_cache(model, key: tuple, size: tuple,
                     gen: torch.Generator) -> dict:
    """The same for the 3x3 conv's packed weight (head_conv1): ``key`` is
    the cache's key before the optimizer steps."""
    conv = model.head.head_conv1
    x = torch.randn((1, 8 * (size[0] // 14), 8 * (size[1] // 14),
                     conv.in_channels), generator=gen, device="cuda"
                    ).to(torch.bfloat16)
    with torch.no_grad():
        got = conv.fused(x, False)
        # the kernel's operands: the weight in bf16, the bias in f32
        want = conv3x3_reference(
            x.float(), conv.weight.detach().to(torch.bfloat16).float()
            .permute(2, 3, 1, 0), conv.bias.detach().float())
    err = compare("conv3x3", "after optimizer steps, cached weight", got,
                  want, CONV_TOL["atol"], CONV_TOL["rtol"], CONV_TOL["why"],
                  CONV_TOL["rms_rtol"])["max_abs_err"]
    if conv._wp._key == key:
        raise AssertionError("train_path: the packed conv weight was not "
                             "derived anew after the optimizer steps")
    return {"case": "conv weight after optimizer steps", "max_abs_err": err,
            "derived_anew": True, "ok": True}


def attention_backward_ms(batch: int, s: int, layers: int,
                          gen: torch.Generator) -> dict:
    """One layer's attention backward as the train step runs it (the
    plain version recomputed and differentiated at the saved bf16 qkv),
    at the path's shape (``s`` tokens), between CUDA events, and the
    memory it takes."""
    qkv = (torch.randn((batch, s, 3 * HEADS * HEAD_DIM), generator=gen,
                       device="cuda") * 0.5).to(torch.bfloat16)
    grad = torch.randn((batch, s, HEADS * HEAD_DIM), generator=gen,
                       device="cuda").to(torch.bfloat16)

    def run():
        x = qkv.detach().requires_grad_(True)
        y = attention_reference(x, HEADS, HEAD_DIM, score_mode="f32max")
        return torch.autograd.grad(y, x, grad)[0]

    run()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = time_ms(run, runs=5, warmup=1)
    flops = 6 * 2 * batch * HEADS * s * s * HEAD_DIM     # 2 fwd + 4 bwd
    return {"ms_per_layer": ms, "ms_per_step": ms * layers,
            "transient_bytes": torch.cuda.max_memory_allocated() - base,
            "f32_gemm_flops_per_layer": flops,
            "f32_bound_ms_per_layer": flops / PEAK_F32_FLOPS * 1e3}


def train_profile(run_step) -> dict:
    """One train step under ``torch.profiler``: device time, the largest
    kernels, and the device time under the autograd nodes of the kernels'
    plain backwards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run_step()
        torch.cuda.synchronize()
    rows, nodes = [], {}
    for e in prof.key_averages():
        total = getattr(e, "device_time_total", None)
        if total is None:
            total = e.cuda_time_total
        if e.device_type == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                rows.append({"name": e.key[:90], "calls": e.count,
                             "ms": us / 1e3})
            continue
        for node in ("_FusedAttentionBackward", "_FusedHeadTailBackward"):
            if e.key == f"autograd::engine::evaluate_function: {node}":
                nodes[node] = {"calls": e.count, "device_ms": total / 1e3}
    rows.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in rows)
    for v in nodes.values():
        v["share_of_step_device_time"] = v["device_ms"] / max(device_ms,
                                                               1e-9)
    return {"device_ms": device_ms, "launches": sum(r["calls"] for r in rows),
            "kernels_by_device_ms": rows[:12],
            "rest_ms": sum(r["ms"] for r in rows[12:]),
            "plain_backward_nodes": nodes}


def train_nccl(images: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               xm: torch.Tensor) -> dict:
    """The sharded fusion step and the sharded train step over a one-rank
    NCCL group at mesh (1, 1), on v2 / ViT-S (metric head, f32 master
    weights), each against its unsharded counterpart on the card (the
    fusion first, while both models hold the same weights). The train
    steps: three at TRAIN_NCCL_OPT; the first step's gradients parameter
    by parameter and its norm, the losses, the loss after the update, and
    the parameters after the steps."""
    store = tempfile.mkdtemp(prefix="txr_nccl_")
    torch.distributed.init_process_group(
        "nccl", init_method=f"file://{store}/store", world_size=1, rank=0)
    try:
        mesh = make_mesh(dp=1, tp=1)
        gen = torch.Generator(device="cuda").manual_seed(0)
        ref, vits_cfg, _ = build_model("v2", "vits", metric=True,
                                       max_depth=20.0, dtype=torch.float32,
                                       generator=gen)
        sharded, _, _ = build_model("v2", "vits", metric=True,
                                    max_depth=20.0, dtype=torch.float32,
                                    generator=gen)
        sharded.load_state_dict(ref.state_dict())
        shard_params(sharded, mesh)
        placed = sum(hasattr(p, "placements")
                     for p in sharded.parameters())
        dense = sum(n.split(".")[-2] in COLUMN_PARALLEL + ROW_PARALLEL
                    for n, _ in ref.named_parameters())

        in_h, in_w = xm.shape[1:3]
        intr = (0.8 * in_w, 0.8 * in_w, in_w / 2.0, in_h / 2.0)
        n = xm.shape[0]
        poses = (torch.eye(3, device="cuda").expand(n, 3, 3),
                 torch.zeros((n, 3), device="cuda"),
                 torch.ones(n, device="cuda"))
        fuse = make_sharded_fusion_step(sharded, intr, 1e-4, 1e6)
        kernels.reset_launches()
        vm = create_sharded_maps(mesh, 1 << 21, 0.01)
        for _ in range(2):
            vm = fuse(shard_batch(xm, mesh), *poses, vm)
        torch.cuda.synchronize()
        fused_launches = {k: v for k, v in kernels.launches.items() if v}
        merged = merge_sharded_maps(stack_sharded_maps(vm, mesh))
        ref_fuse = make_sharded_fusion_step(ref, intr, 1e-4, 1e6)
        want = create_offset_map(1 << 21, 0.01)
        for _ in range(2):
            want = ref_fuse(xm, *poses, want)
        voxels = int(offset_map_size(merged))
        bit_equal = all(torch.equal(a, b)
                        for a, b in zip(merged[:NCOLS], want[:NCOLS]))
        if (fused_launches.get("offset_reduce") != 2 or voxels < 1
                or voxels != int(offset_map_size(want)) or placed != dense):
            raise AssertionError(f"train_path/nccl fusion: launches "
                                 f"{fused_launches}, {voxels} voxels, "
                                 f"{placed} of {dense} dense parameters "
                                 f"sharded")
        mp, wp = offset_map_points(merged), offset_map_points(want)
        pos_err = (mp.xyz[mp.mask] - wp.xyz[wp.mask]).abs().max().item()
        if pos_err > 0.01 / 1024 * 4:
            raise AssertionError(f"train_path/nccl fusion: voxel means "
                                 f"{pos_err} m apart")

        opt = train.make_optimizer(**TRAIN_NCCL_OPT)
        runs, first_grads = {}, {}
        for name, model, make in (
                ("unsharded", ref, lambda m: train.make_train_step(m, opt)),
                ("sharded", sharded,
                 lambda m: train.make_sharded_train_step(m, opt, mesh))):
            adam, sched = opt.init(model.parameters())
            state = train.TrainState(model, adam, sched)
            step = make(model)
            kernels.reset_launches()
            losses, norms = [], []
            for i in range(3):
                state, loss = step(state, shard_batch(images, mesh),
                                   shard_batch(target, mesh),
                                   shard_batch(mask, mesh))
                losses.append(loss.item())
                norms.append(state.grad_norm.item())
                if i == 0:      # at lr 0: both at the same weights
                    first_grads[name] = {n: g.clone() for n, g in
                                         unshard_grads(model).items()}
            torch.cuda.synchronize()
            runs[name] = {"losses": losses, "grad_norms": norms,
                          "launches": {k: v for k, v in
                                       kernels.launches.items() if v}}
        tol = TRAIN_NCCL_TOL
        # the first step's gradients, parameter by parameter, clipped alike
        # (the clip scales both by their own norms, compared below)
        grads = grad_errors(first_grads["sharded"], first_grads["unsharded"],
                            tol["grad_floor"])
        del first_grads
        sh, un = runs["sharded"], runs["unsharded"]
        norm_err = abs(sh["grad_norms"][0] - un["grad_norms"][0]) / abs(
            un["grad_norms"][0])
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(
            sh["losses"][:2], un["losses"][:2]))
        after_err = abs(sh["losses"][2] - un["losses"][2]) / abs(
            un["losses"][2])
        moved = abs(un["losses"][2] - un["losses"][0]) / abs(un["losses"][0])
        full = unshard_state_dict(sharded)
        lr = sum(opt.learning_rate(i) for i in range(3))   # rates applied
        eps = torch.finfo(torch.float32).eps
        param_err = max((full[n] - p.detach()).abs().max().item()
                        for n, p in ref.named_parameters())
        # beyond the f32 rounding of each parameter (LayerNorm scales and
        # LayerScale sit at 1, whose ulp is comparable to these rates)
        param_excess = max(((full[n] - p.detach()).abs()
                            - 2 * eps * p.detach().abs()).max().item()
                           for n, p in ref.named_parameters())
        out = {"backend": torch.distributed.get_backend(), "mesh": [1, 1],
               "model": "v2/vits metric", "frames": n,
               "dtensor_params": placed,
               "fusion_launches": fused_launches, "fusion_inserts": 2,
               "voxels": voxels, "fusion_bit_equal_unsharded": bit_equal,
               "fusion_mean_max_err_m": pos_err, "train": runs,
               "optimizer": TRAIN_NCCL_OPT,
               "first_step_grads": grads, "grad_norm_rel_err": norm_err,
               "loss_rel_err": loss_err,
               "loss_after_update_rel_err": after_err,
               "loss_moved_by_update": moved,
               "param_max_err": param_err,
               "param_max_err_in_lr": param_err / lr,
               "param_max_err_beyond_f32_rounding_in_lr": param_excess / lr,
               "tolerance": {k: v for k, v in tol.items() if k != "why"}}
        if (loss_err > tol["loss_rtol"] or norm_err > tol["norm_rtol"]
                or grads["grad_norm_rel_err"] > tol["norm_rtol"]
                or grads["worst_param_grad_rel_err"] > tol["grad_rel"]
                or after_err > tol["after_rtol"]
                or moved < tol["moved_over_after"] * tol["after_rtol"]
                or param_excess > tol["param_atol_lr"] * lr
                or sh["launches"].get("attention")
                != 3 * vits_cfg.num_layers):
            emit({"phase": "train_check", "case": "nccl train step", **out,
                  "why": tol["why"]})
            raise AssertionError(f"train_path/nccl train step: {out}")
        return out
    finally:
        torch.distributed.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)


def train_path(smi: str) -> dict:
    """Fine-tuning v2 / ViT-L at full width on the card through the
    attention and tail kernels (forward) and their plain backwards:
    TRAIN_BATCH frames of main_path's preprocess, seeded metric targets,
    f32 master weights under bf16 autocast, ``make_optimizer()`` at its
    defaults (TRAIN_OPT). The kernel route's forward against the plain
    route's (TXR_FUSED_HEAD=0, the plain attention) at TRAIN_BATCH frames,
    and their gradients at TRAIN_COMPARE_BATCH frames, term by term
    (LOSS_TERMS, and the backward at a shared cotangent), with a control
    fault the tight checks must reject; the 3x3 conv kernel's step
    (TXR_FUSED_CONVS=1) against cuDNN's; the caches derived from the
    weights after optimizer steps; TRAIN_WARMUP + TRAIN_TIMED steps split
    into forward, backward and clip + optimizer between CUDA events; one
    profiled step; the plain attention backward alone; the NCCL steps."""
    t_phase = time.perf_counter()
    # the earlier phases' garbage, collected now and not inside a timed step
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(7)
    images, target, mask, xm = train_batch(TRAIN_BATCH)
    checks = []

    model, vit_cfg, dpt_cfg = train_model()
    layers = vit_cfg.num_layers
    size = tuple(images.shape[1:3])
    tokens = (size[0] // 14) * (size[1] // 14) + 1
    plain_model, _, plain_dpt = train_model({"TXR_FUSED_HEAD": "0"},
                                            use_flash=False)
    plain_model.load_state_dict(model.state_dict())
    if plain_dpt.fused_head is not False:
        raise AssertionError("train_path: the plain route fuses the head")
    # the path's own shapes, forward only
    checks.append(forward_routes(model, plain_model, layers, images, target,
                                 mask))
    shift = shift_by_layer(model, plain_model, layers, images)
    # the gradients at TRAIN_COMPARE_BATCH: the loss, each of its parts,
    # and the backward alone at a cotangent both routes share
    nb = TRAIN_COMPARE_BATCH
    one = (images[:nb], target[:nb], mask[:nb])
    cot = cotangent_of(plain_model, *one)
    for term in [*LOSS_TERMS, "cotangent"]:
        run = ((lambda m: vjp_of(m, one[0], cot)) if term == "cotangent"
               else (lambda m: grads_of(m, *one, term=term)))
        kern = run(model)
        kern = (kern[0], {n: g.clone() for n, g in kern[1].items()}, kern[2])
        plain = run(plain_model)
        if (kern[2] != {"attention": layers, "dpt_tail": 1,
                        "residual_norm": RESIDUALS * layers,
                        "upsample": UPSAMPLES}
                or plain[2] != {"residual_norm": RESIDUALS * layers,
                                "upsample": UPSAMPLES + 1}):
            raise AssertionError(f"train_path: kernel route launched "
                                 f"{kern[2]}, plain route {plain[2]}")
        checks.append(compare_grads(f"kernels vs plain versions, {term}",
                                    kern, plain, TRAIN_TOL[term]))
        checks[-1]["frames"] = nb
        if term == "loss":
            checks[-1]["cut_why"] = TRAIN_COMPARE_WHY
        if term == TRAIN_CONTROL["term"]:
            control_ref = plain[1]
        del plain, kern
    # the control: the same comparison with a fault in the kernel route's
    # backward, which the check must reject
    handle = control_fault(model)
    try:
        faulty = grads_of(model, *one, term=TRAIN_CONTROL["term"])
    finally:
        handle.remove()
    tol = TRAIN_TOL[TRAIN_CONTROL["term"]]
    control = {"case": "control: a fault the check must reject",
               **TRAIN_CONTROL,
               **grad_errors(faulty[1], control_ref, tol["grad_floor"])}
    control["rejected"] = (control["worst_param_grad_rel_err"]
                           > tol["grad_rel"]
                           or control["grad_norm_rel_err"] > tol["norm_rtol"])
    if not control["rejected"]:
        raise AssertionError(f"train_path: the check passed a faulty "
                             f"backward: {control}")
    checks.append(control)
    del cot, control_ref, faulty, plain_model
    model.zero_grad(set_to_none=True)
    torch.cuda.empty_cache()

    # the 3x3 conv kernel's step against cuDNN's, at the full batch
    cudnn = grads_of(model, images, target, mask)
    cudnn = (cudnn[0], {n: g.clone() for n, g in cudnn[1].items()},
             cudnn[2])
    model.zero_grad(set_to_none=True)
    conv_model, _, conv_dpt = train_model({"TXR_FUSED_CONVS": "1"})
    conv_model.load_state_dict(model.state_dict())
    conv = grads_of(conv_model, images, target, mask)
    if conv[2].get("conv3x3") != 9 or not conv_dpt.fused_convs:
        raise AssertionError(f"train_path: TXR_FUSED_CONVS=1 launched "
                             f"{conv[2]}")
    checks.append(compare_grads("conv3x3 kernel vs cuDNN", conv, cudnn,
                                TRAIN_TOL["conv"]))
    checks[-1]["frames"] = TRAIN_BATCH
    checks[-1]["launches"] = conv[2]
    del conv, cudnn
    # two steps (the first at lr 0) so that the conv's weights change
    opt = train.make_optimizer(**TRAIN_OPT)
    adam, sched = opt.init(conv_model.parameters())
    cstate = train.TrainState(conv_model, adam, sched)
    cstep = train.make_train_step(conv_model, opt)
    key = conv_model.head.head_conv1._wp._key
    for _ in range(2):
        cstate, _ = cstep(cstate, images, target, mask)
    checks.append(check_conv_cache(conv_model, key, size, gen))
    del conv_model, cstate, cstep
    torch.cuda.empty_cache()

    # the timed run on the kernel route
    adam, sched = opt.init(model.parameters())
    state = train.TrainState(model, adam, sched)
    step = train.make_train_step(model, opt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    losses, split = [], []
    t0 = time.perf_counter()
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        if i < TRAIN_WARMUP:
            state, loss = step(state, images, target, mask)
            losses.append(loss)
            if i == TRAIN_WARMUP - 1:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            continue
        # the shipped step's three parts, which its call runs and nothing
        # else, with events between them
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = step.forward(state, images, target, mask)
        ev[1].record()
        step.backward(loss)
        ev[2].record()
        step.update(state)
        ev[3].record()
        losses.append(loss.detach())
        split.append(ev)
    torch.cuda.synchronize()
    step_wall_ms = (time.perf_counter() - t0) / TRAIN_TIMED * 1e3
    launches = dict(kernels.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [l.item() for l in losses]
    parts = {"forward": [e[0].elapsed_time(e[1]) for e in split],
             "backward": [e[1].elapsed_time(e[2]) for e in split],
             "clip_and_optimizer": [e[2].elapsed_time(e[3]) for e in split]}
    total = TRAIN_WARMUP + TRAIN_TIMED
    per_step = {k: v / total for k, v in launches.items() if v}
    if (launches["attention"] != layers * total
            or launches["dpt_tail"] != total
            or launches["residual_norm"] != RESIDUALS * layers * total
            or launches["upsample"] != UPSAMPLES * total
            or any(v for k, v in launches.items()
                   if k not in ("attention", "dpt_tail", "residual_norm",
                                "upsample"))):
        raise AssertionError(f"train_path: launches over {total} steps "
                             f"{launches}")
    if not all(np.isfinite(losses)) or min(losses[1:]) >= losses[0]:
        raise AssertionError(f"train_path: losses {losses} do not fall "
                             f"below the first")
    checks.append(check_tail_cache(model, size, gen))
    if not checks[-1]["derived_anew"]:
        raise AssertionError("train_path: the tail's operands were not "
                             "derived anew after the optimizer steps")

    prof = train_profile(lambda: step(state, images, target, mask))
    attn_bwd = attention_backward_ms(TRAIN_BATCH, tokens, layers, gen)
    del state, adam, sched, step
    model.zero_grad(set_to_none=True)
    del model
    torch.cuda.empty_cache()
    nccl = train_nccl(images, target, mask, xm)

    med = {k: statistics.median(v) for k, v in parts.items()}
    out = {"phase": "train_path", "nvidia_smi_name_power_limit": smi,
           "model": "v2/vitl metric (sigmoid x 20 m)",
           "hidden": vit_cfg.hidden_size, "layers": vit_cfg.num_layers,
           "heads": vit_cfg.num_heads, "dpt_features": dpt_cfg.features,
           "master_weights": "float32", "autocast": "bfloat16",
           "frames_per_step": TRAIN_BATCH, "model_input": list(size),
           "tokens": tokens,
           "optimizer": {**TRAIN_OPT, "weight_decay": opt.weight_decay,
                         "max_grad_norm": opt.max_grad_norm},
           "warmup_steps_run": TRAIN_WARMUP, "timed_steps": TRAIN_TIMED,
           "shift_by_layer": shift,
           "ms_per_step": sum(med.values()), "ms_per_step_split": med,
           "ms_split_by_step": parts,
           "ms_per_step_host_clock": step_wall_ms,
           "peak_memory_bytes": peak, "losses": losses,
           "launches": launches, "launches_over_steps": total,
           "launches_per_step": per_step, "profile": prof,
           "plain_attention_backward": attn_bwd, "checks": checks,
           "nccl": nccl, "phase_s": time.perf_counter() - t_phase,
           "ok": True}
    emit(out)
    return out


def ptxas_report(log: str) -> list:
    """Registers, spills and static shared memory of each kernel, from the
    output of ``nvcc -Xptxas -v``."""
    out = []
    pat = re.compile(
        r"Compiling entry function '(\S+)' for 'sm_90a'.*?"
        r"(\d+) bytes spill stores, (\d+) bytes spill loads.*?"
        r"Used (\d+) registers(?:, used \d+ barriers)?"
        r"(?:, (\d+) bytes smem)?", re.S)
    for m in pat.finditer(log):
        out.append({"entry": m.group(1), "registers": int(m.group(4)),
                    "spill_store_bytes": int(m.group(2)),
                    "spill_load_bytes": int(m.group(3)),
                    "static_smem_bytes": int(m.group(5) or 0)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--profile", action="store_true",
                    help="build with -Xptxas -v and report each kernel's "
                         "registers and spills; a spill or a serialised "
                         "wgmma fails the run")
    args = ap.parse_args()
    if args.frames < 1:
        ap.error("--frames must be at least 1")

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_script = time.perf_counter()

    # the port's f32 paths have no matmul, but any f32 comparison made here
    # must not run in TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi_name_power_limit": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "allow_tf32": False})

    t0 = time.perf_counter()
    path = kernels.build(verbose=args.profile)
    kernels.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path),
          "sources": [os.path.relpath(s) for s in kernels.sources()],
          "flags": kernels.NVCC_FLAGS})
    if args.profile:
        report = ptxas_report(kernels.build_log)
        # ptxas says so (C7513 to C7515) when it had to serialise wgmma
        serialised = re.findall(r"\(C751[0-9]\)[^\n]*serialized[^\n]*",
                                kernels.build_log)
        emit({"phase": "ptxas", "kernels": report,
              "wgmma_serialised_warnings": len(serialised)})
        spilled = [k["entry"] for k in report
                   if k["spill_store_bytes"] or k["spill_load_bytes"]]
        if spilled or serialised:
            raise AssertionError(f"ptxas: spills in {spilled}, "
                                 f"{len(serialised)} wgmma serialisation "
                                 f"warnings: {serialised[:1]}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = []
    for _, checks in KERNEL_CHECKS.values():
        for check in checks:
            rows = check(args.frames, gen)
            if check is check_offset_reduce:
                reduce_entry = rows
            else:
                summary.extend(rows if isinstance(rows, list) else [rows])
            torch.cuda.empty_cache()
    # row 3 carries both entries of the scan core: the model paths run the
    # fused reduce, fusion_cli_path the standalone scan
    scan_row = next(k for k in summary if k["name"] == "segscan")
    scan_row["offset_reduce"] = reduce_entry
    scan_row["counters"] = ["offset_reduce", "segscan"]
    check_reference(gen)
    torch.cuda.empty_cache()

    run, main_depth = main_path(args.frames)
    torch.cuda.empty_cache()
    qrun, quant_depth = quant_path(args.frames, main_depth)
    torch.cuda.empty_cache()
    brun = boundmax_path(args.frames, main_depth)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    bruns = batch_path(main_depth, quant_depth)
    emit({"phase": "batch_path", "phase_s": time.perf_counter() - t0})
    del main_depth, quant_depth
    torch.cuda.empty_cache()
    orun = odd_heads_path(args.frames, gen)
    torch.cuda.empty_cache()
    crun = depth_cli_path()
    torch.cuda.empty_cache()
    vrun = v3_metric_cli_path()
    t0 = time.perf_counter()
    rruns = registry_path(args.frames)
    emit({"phase": "registry_path", "phase_s": time.perf_counter() - t0})
    darun = da3_path()
    torch.cuda.empty_cache()
    vgrun = vggt_path()
    torch.cuda.empty_cache()
    svrun = streamvggt_path()
    torch.cuda.empty_cache()
    bf16_vs_f32(args.frames, crun["int8"]["depth_vs_bf16"])
    srun = sfm_path()
    torch.cuda.empty_cache()
    frun = fusion_cli_path()
    torch.cuda.empty_cache()
    erun = enhanced_cli_path()
    torch.cuda.empty_cache()
    strun, stepwise = stream_path()
    torch.cuda.empty_cache()
    sfrun = stream_fused_path(stepwise)
    del stepwise
    torch.cuda.empty_cache()
    trun = train_path(smi)
    torch.cuda.empty_cache()
    # row 3's third entry: the scan at 8 columns on LSD's inputs
    scan_row["lsd_8_columns"] = erun["scan_8_columns"]
    runs = {"main_path": run, "quant_path": qrun, "boundmax_path": brun,
            **{f"batch_path {r['label']} {r['frames_per_step']}": r
               for r in bruns},
            "odd_heads_path": orun, "depth_cli_path": crun,
            "v3_metric_cli_path": vrun,
            **{f"registry_path {r['label']}": r for r in rruns},
            "da3_path": darun, "vggt_path": vgrun,
            "streamvggt_path": svrun, "sfm_path": srun,
            "fusion_cli_path": frun,
            "enhanced_cli_path": erun, "stream_path": strun,
            "stream_fused_path": sfrun, "train_path": trun}
    # the path whose count stands in the kernels line: the first that runs it
    for k in summary:
        counters = k.get("counters", [k["name"]])
        by_path = {name: sum(r["launches"][c] for c in counters)
                   for name, r in runs.items()}
        k["launches_by_path"] = by_path
        if len(counters) > 1:
            k["launches_by_path_by_entry"] = {
                c: {name: r["launches"][c] for name, r in runs.items()}
                for c in counters}
        path = next((name for name, n in by_path.items() if n), "main_path")
        k["launches"] = by_path[path]
        k["launches_in"] = path
        k["launches_over_steps"] = runs[path]["launches_over_steps"]
        if k["launches"] < 1:
            raise AssertionError(f"no path launched {counters}")
    emit({"phase": "device", "nvidia_smi_name_power_limit": smi})
    emit({"phase": "script", "wall_s": time.perf_counter() - t_script})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
