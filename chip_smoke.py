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
ragged ones (attention: S = 2432 and 77, ``kv_len`` 1 / 64 / 1984 / 2000,
score mode ``boundmax`` with its key-norm pre-pass, three stride patterns of
the (B, H, S, D) entry; conv: an image smaller than a tile, F = 136; int8
linear: M = 1 and 129, K = 16 and 4096 + 16, N = 8, an all-zero row, values
on rounding ties; tail: every head width, every resize ratio, an image
smaller than a tile; scan: the insert's real segments, one segment over 146
tiles, N = 1 and one tile +- 1 row); the fused voxel-map reduce is held bit
for bit against the unfused route (``torch.sort``, the standalone scan
kernel, ``torch.nonzero`` compaction) on a full map, an overflowing one, an
all-invalid batch, a saturating voxel and ``offset_map_merge``, with
PyTorch's sync debug mode set to fail on any host sync inside an insert or a
merge. Every kernel is run twice on one input and must repeat bit for bit,
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
read back; it must launch attention >= 24, tail >= 1 and segscan 9 times,
and prints its stages (events), each feature op on one frame, its peak
memory and one profiled ``reconstruct()``. Run B takes the scene's depth
as the model and bundle adjustment on: poses and scales are held to the
truth (``SFM_TOL``) and the RMS history may not rise. Then the scan kernel
at 8 columns is held to its plain version on the columns and starts LSD
handed it for one frame and timed beside its bound, and that frame's LSD,
Canny, ORB and SIFT on the card are held against the CPU.

Every line of standard output is one JSON object. The phases are ``device``,
``build``, ``kernel_check`` (one line per comparison), ``reference``,
``main_path``, ``quant_path``, ``boundmax_path``, ``odd_heads_path``,
``depth_cli_path``, ``bf16_vs_f32``, ``sfm_path``, ``fusion_cli_path``,
``enhanced_cli_path``, ``script`` (the whole run's wall), then the
``kernels`` summary and, last, the verdict
``{"ok": true, "device": {...}}``. Any failing phase raises and the exit
code is non-zero; nothing runs on the CPU and no kernel is swapped for its
plain version. Without a CUDA device the script exits with code 2 and
prints no result.

Options (none is needed): ``--frames N`` frames per step (default 8);
``--profile`` builds with ``-Xptxas -v`` and adds a ``ptxas`` line (each
kernel's registers and spills; a spill or a "wgmma serialized" warning
fails the run), an ``insert_profile`` line (one insert at the path's shape
under ``torch.profiler``: device time by kernel with calls, and the gaps in
which the device waited for the host) and a ``profile`` line per path (one
extra step under ``torch.profiler``: device time by kernel, largest
first).
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
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
import torch.nn.functional as F

import txr_torch._cuda as kernels
import txr_torch._native as native
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (NCOLS, _insert_cols,
                                         _reduce_unfused, _sort_keys,
                                         create_offset_map, offset_map_insert,
                                         offset_map_merge,
                                         offset_map_scan_inputs,
                                         offset_map_size)
from txr_torch.io.ply import read_ply
from txr_torch.io.sources import ImageSource
from txr_torch.models.depth_anything import (DepthAnything,
                                             DepthAnythingModel, build_model)
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.ops.attention import BLOCK_K as ATTN_BLOCK_K
from txr_torch.ops.attention import BLOCK_Q as ATTN_BLOCK_Q
from txr_torch.ops.attention import (attention_flash, attention_key_norm,
                                     attention_plain, attention_reference,
                                     fused_attention, key_norm_plain,
                                     split_heads)
from txr_torch.ops.attention import kernel_geometry as attention_geometry
from txr_torch.ops.backproject import backproject, backproject_world
from txr_torch.ops.conv_stripe import (BLOCK_F, TILE_H, TILE_W,
                                       conv3x3_reference, conv3x3_stripe,
                                       pack_weight)
from txr_torch.ops.conv_stripe import kernel_geometry as conv_geometry
from txr_torch.ops.dpt_tail import (fused_head_tail, head_tail_reference,
                                    pack_params)
from txr_torch.ops.dpt_tail import kernel_geometry as tail_geometry
from txr_torch.ops.quant import Int8Linear
from txr_torch.ops.quant_fused import (STAGES, TILE_M, TILE_N,
                                       Int8LinearFused, int8_linear,
                                       int8_linear_reference)
from txr_torch.ops.quant_fused import kernel_geometry as int8_geometry
from txr_torch.ops.resize import (IMAGENET_MEAN, IMAGENET_STD,
                                  compute_da_resize, resize_bicubic)
from txr_torch.ops.scan import ITEMS as SCAN_ITEMS
from txr_torch.ops.scan import MAX_COLS as SCAN_MAX_COLS
from txr_torch.ops.scan import THREADS as SCAN_THREADS
from txr_torch.ops.scan import TILE as SCAN_TILE
from txr_torch.ops.scan import (offset_reduce, scan_geometry,
                                segmented_cumsum_cols)
from txr_torch.ops.segment import segmented_cumsum
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


def compare(name: str, case: str, got: torch.Tensor, want: torch.Tensor,
            atol: float, rtol: float, why: str,
            rms_rtol: float = None) -> float:
    """Emit one kernel_check line; raise if a tolerance is exceeded.

    Every element must lie within ``atol + rtol * |want|``. ``rms_rtol``
    also bounds the rms of the error by that share of the rms of ``want``:
    an error of a few percent that is spread over all elements fails it
    even where each element stays inside its own tolerance."""
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
    ok = worst <= 0 and (rms_rtol is None or err_rms <= rms_rtol * value_rms)
    emit({"phase": "kernel_check", "kernel": name, "case": case,
          "shape": list(g.shape), "max_abs_err": max_abs,
          "max_rel_err": max_rel, "err_rms": err_rms, "value_rms": value_rms,
          "value_max": w.abs().max().item(), "atol": atol, "rtol": rtol,
          "rms_rtol": rms_rtol, "least_margin": -worst,
          "tolerance_reason": why, "ok": ok})
    if not ok:
        raise AssertionError(
            f"{name}/{case}: max abs err {max_abs} (rms {err_rms} on values "
            f"of rms {value_rms}) exceeds atol {atol} + rtol {rtol}, or "
            f"rms_rtol {rms_rtol}")
    return max_abs


# ---------------------------------------------------------------- kernels

ATTN_TOL = dict(atol=8e-3, rtol=1.6e-2, rms_rtol=2.0 ** -7,
                why="4 bf16 ulps (2^-8 each) of the value: the kernel rounds "
                    "the probabilities to bf16 before it normalises, the "
                    "plain version after, and both round the result. Terms "
                    "of opposite sign cancel in the value, not in the error, "
                    "so 8e-3 absolute, 2.5 % of the values' rms of 0.3 "
                    "(scaled logits of std 3, |v| up to 5)")
TAIL_TOL = dict(atol=6e-2, rtol=1e-2, rms_rtol=2.0 ** -7,
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


def check_attention(batch: int, gen: torch.Generator) -> dict:
    in_h, in_w = compute_da_resize(H, W, 518)
    s = (in_h // 14) * (in_w // 14) + 1
    c = 3 * HEADS * HEAD_DIM
    qkv = torch.randn((batch, s, c), generator=gen, device="cuda",
                      dtype=torch.float32)
    # q of std 3, k of std 1: q.k has std 24 over D=64, the scaled logits
    # std 3. The softmax is peaked (a handful of the 2443 keys carry a row),
    # so the result depends on q and k and is of the order of v.
    qkv[..., :HEADS * HEAD_DIM] *= 3.0
    qkv = qkv.to(torch.bfloat16)

    geo = attention_geometry(batch, HEADS, s, s)
    require_geometry("attention", kernels.lib().txr_attention_geometry,
                     (ATTN_BLOCK_Q, ATTN_BLOCK_K, geo["smem_bytes"],
                      geo["threads"]))
    got = fused_attention(qkv, HEADS, HEAD_DIM)
    want = attention_reference(qkv, HEADS, HEAD_DIM)
    err = compare("attention", f"main B={batch} S={s}", got, want, **ATTN_TOL)
    del want
    require_repeatable("attention",
                       lambda: fused_attention(qkv, HEADS, HEAD_DIM))
    # ragged keys, which txr serves with its streaming kernel: one key, one
    # 64-row box, a whole number of key tiles less than S, and a ragged tile
    sub = qkv[:2].contiguous()
    for kv in (1, 64, 1984, 2000):
        compare("attention", f"kv_len={kv} B=2 S={s}",
                fused_attention(sub, HEADS, HEAD_DIM, kv),
                attention_reference(sub, HEADS, HEAD_DIM, kv), **ATTN_TOL)
    # a sequence that is a multiple of both tiles
    even = qkv[:2, :2432].contiguous()
    compare("attention", "S=2432 B=2", fused_attention(even, HEADS, HEAD_DIM),
            attention_reference(even, HEADS, HEAD_DIM), **ATTN_TOL)
    del even
    # a short sequence: one ragged tile, fewer query rows than a block
    tiny = qkv[:1, :77].contiguous()
    compare("attention", "S=77 B=1", fused_attention(tiny, HEADS, HEAD_DIM),
            attention_reference(tiny, HEADS, HEAD_DIM), **ATTN_TOL)

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
            "geometry": {**geo, "grid": list(geo["grid"])}}


def check_attention_boundmax(batch: int, gen: torch.Generator) -> list:
    """Score mode ``"boundmax"`` of the attention kernel and its key-norm
    pre-pass, on the operands of ``check_attention``."""
    in_h, in_w = compute_da_resize(H, W, 518)
    s = (in_h // 14) * (in_w // 14) + 1
    c = 3 * HEADS * HEAD_DIM
    qkv = torch.randn((batch, s, c), generator=gen, device="cuda",
                      dtype=torch.float32)
    qkv[..., :HEADS * HEAD_DIM] *= 3.0          # as in check_attention
    qkv = qkv.to(torch.bfloat16)
    q, k, v = split_heads(qkv, HEADS, HEAD_DIM)

    kn_err = compare("attention_key_norm", f"B={batch} H={HEADS} S={s}",
                     attention_key_norm(qkv, HEADS, HEAD_DIM),
                     key_norm_plain(k), atol=0.0, rtol=1e-6,
                     why="sums of 64 f32 squares taken in another order "
                         "(a few ulps of a norm near 11); the max is exact")
    require_repeatable("attention_key_norm",
                       lambda: attention_key_norm(qkv, HEADS, HEAD_DIM))

    def bound_mode(x):
        return fused_attention(x, HEADS, HEAD_DIM, score_mode="boundmax")

    err = compare("attention_boundmax", f"main B={batch} S={s}",
                  bound_mode(qkv), attention_reference(
                      qkv, HEADS, HEAD_DIM, score_mode="boundmax"),
                  **ATTN_TOL)
    require_repeatable("attention_boundmax", lambda: bound_mode(qkv))
    # a multiple of both tiles, and one ragged tile with fewer query rows
    # than a block: the masked keys must add nothing to the row sums
    for label, x in (("S=2432 B=2", qkv[:2, :2432].contiguous()),
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

    def operands(b, hi, wi, ch):
        x = torch.randn((b, hi, wi, ch), generator=gen, device="cuda")
        w2 = torch.randn((3, 3, ch, feat), generator=gen, device="cuda")
        w2 = w2 * 0.05 * (128 / ch) ** 0.5       # conv2's output of rms 4
        b2 = torch.randn((feat,), generator=gen, device="cuda") * 0.5
        w3 = torch.randn((feat,), generator=gen, device="cuda")
        b3 = torch.randn((1,), generator=gen, device="cuda")
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
                  got, want, **TAIL_TOL)
    del want, got
    require_repeatable("dpt_tail",
                       lambda: fused_head_tail(*args, out_h, out_w))
    # every resize ratio, every head width (C = features / 2 of the four
    # presets), an image smaller than one tile, one column past a tile, and
    # fewer tiles than multiprocessors
    for label, (b, hi, wi, ch, ho, wo) in {
            "near-1 ratio 176->180": (1, 176, 40, 128, 180, 45),
            "downsample 64->40": (1, 64, 48, 128, 40, 30),
            "out_h == 1": (1, 32, 16, 128, 1, 20),
            "C=32 (vits)": (2, 20, 24, 32, 35, 42),
            "C=64 (vitb)": (2, 20, 24, 64, 35, 42),
            "C=192 (vitg)": (2, 20, 24, 192, 35, 42),
            "smaller than a tile 5x7": (1, 4, 4, 128, 5, 7),
            "out_w = tile width + 1": (1, 12, 20, 128, 21, 33),
            "10 tiles on all multiprocessors": (1, 24, 36, 128, 40, 60),
    }.items():
        g = require_tail_geometry((b, hi, wi, ch, ho, wo), sms)
        small = operands(b, hi, wi, ch)
        compare("dpt_tail", f"{label}: {hi}x{wi}x{ch}->{ho}x{wo}, tile "
                f"{g['tile'][0]}, grid {g['grid']}",
                fused_head_tail(*small, ho, wo), exact(small, ho, wo),
                **TAIL_TOL)

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
            "geometry": {k: list(v) if isinstance(v, tuple) else v
                         for k, v in geo.items()}}


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
                  kernel(wcols, starts), plain(wcols, starts), **SCAN_TOL)
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
    # ragged in every way; one row; one row past a tile; K shorter than one
    # swizzled row; K one 16-byte piece past a whole number of stages; the
    # narrowest N
    for label, (rows, k, n) in {"ragged": (300, 96, 136),
                                "one row": (1, 1024, 264),
                                "one row past a tile": (129, 256, 512),
                                "K = 16": (200, 16, 72),
                                "K = 4096 + 16": (77, 4096 + 16, 264),
                                "N = 8": (300, 128, 8)}.items():
        x, w, b = operands(rows, k, n)
        got = int8_linear(x, w, b)
        compare_bits("int8_linear", f"{label} M={rows} K={k} N={n}", got,
                     int8_linear_reference(x, w, b))
        if not torch.equal(got[rows // 2].float(), b.float()):
            raise AssertionError(
                f"int8_linear {label}: an all-zero row must give the bias")
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
    # ragged in every way: H, W, a short channel chunk, few features; an
    # image smaller than one tile; a feature count that is a multiple of
    # the feature block of no kind
    for label, shape in (("ragged 13x21 48->40", (1, 13, 21, 48, 40)),
                         ("smaller than a tile 5x7 64->64", (1, 5, 7, 64, 64)),
                         ("F=136 20x33 256->136", (2, 20, 33, 256, 136))):
        x, wgt, bias = operands(*shape)
        for relu in (False, True):
            compare("conv3x3", f"{label} relu_in={relu}",
                    conv3x3_stripe(x, wgt, bias, relu),
                    exact(x, wgt, bias, relu), **CONV_TOL)

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
                exact(x, wgt, bias, relu), **CONV_TOL))
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
    qkv = torch.randn((batch, s, 3 * h * d), generator=gen, device="cuda",
                      dtype=torch.float32)
    qkv[..., :h * d] *= 3.0          # peaked softmax, as in check_attention
    qkv = qkv.to(torch.bfloat16)
    q, k, v = split_heads(qkv, h, d)          # strided views, no copy
    if q.is_contiguous():
        raise AssertionError("the head views should not be contiguous")

    err = compare("attention_bhsd", f"main B={batch} H={h} S={s} views",
                  attention_flash(q, k, v), attention_plain(q, k, v),
                  **ATTN_TOL)
    require_repeatable("attention_bhsd", lambda: attention_flash(q, k, v))
    kv = 2000
    compare("attention_bhsd", f"kv_len={kv} B=2 H={h} S={s}",
            attention_flash(q[:2], k[:2], v[:2], kv),
            attention_plain(q[:2], k[:2], v[:2], kv), **ATTN_TOL)
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

def drive_path(phase: str, frames: int, profile: bool, expect: dict,
               **model_kwargs) -> tuple:
    """Drive frames -> depth -> back-projection -> voxel map with the model
    ``build_model("v2", "vitl", **model_kwargs)`` builds: one warm-up step,
    STEPS timed steps, one step with events between the stages. ``expect``
    maps a kernel to its launches per step (asserted for every counter).
    Returns the phase's line and the depth of the staged step (frames of
    seed 0)."""
    in_h, in_w = compute_da_resize(H, W, 518)
    gen = torch.Generator(device="cpu").manual_seed(0)
    model, vit_cfg, dpt_cfg = build_model("v2", "vitl", dtype=torch.bfloat16,
                                          generator=gen, **model_kwargs)
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
    def step(frames_u8, vm):
        mark("start")
        x = frames_u8.to(torch.float32) / 255.0
        xm = resize_bicubic(x, in_h, in_w, align_corners=False)
        xn = ((xm - mean) / std).to(torch.bfloat16)
        mark("preprocessed")
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
    vm, depth = step(dev_frames[0], vm)
    torch.cuda.synchronize()
    stages = {b: marks[a].elapsed_time(marks[b])
              for a, b in zip(names[:-1], names[1:])}
    marks.clear()
    if not torch.isfinite(depth).all() or not (depth != 0).any():
        raise AssertionError("depth is not finite or is all zero")
    if (depth.max() - depth.min()).item() <= 0:
        raise AssertionError("depth is constant")

    if profile:
        profile_step(phase, lambda: step(dev_frames[1], vm))

    out = {"phase": phase, "model": "v2/vitl",
           "quant": vit_cfg.quant, "fused_head": dpt_cfg.fused_head,
           "fused_convs": dpt_cfg.fused_convs,
           "hidden": vit_cfg.hidden_size,
           "layers": vit_cfg.num_layers, "heads": vit_cfg.num_heads,
           "dtype": "bfloat16",
           "input": [H, W], "model_input": [in_h, in_w],
           "tokens": (in_h // 14) * (in_w // 14) + 1,
           "frames_per_step": frames, "steps_timed": STEPS,
           "points_per_frame": in_h * in_w, "map_capacity": 1 << 21,
           "voxel_size_m": 0.01, "warmup_s": warmup_s,
           "ms_per_step": step_ms, "ms_per_frame": step_ms / frames,
           "stage_ms": stages, "voxels": voxels,
           "depth_mean": depth.mean().item(),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "launches": counts, "launches_over_steps": total, "ok": True}
    return out, depth


def main_path(frames: int, profile: bool) -> tuple:
    """The default configuration: attention, tail and fused-reduce
    kernels."""
    out, depth = drive_path("main_path", frames, profile,
                            {"attention": 24, "dpt_tail": 1,
                             "offset_reduce": 1})
    emit(out)
    return out, depth


def path_with_env(phase: str, env: dict, frames: int, profile: bool,
                  expect: dict, main_depth: torch.Tensor,
                  **model_kwargs) -> dict:
    """``drive_path`` with ``env`` set in the environment (restored
    afterwards), and its depth against ``main_path``'s (same weights and
    frames) as a share of main_path's depth span."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        out, depth = drive_path(phase, frames, profile, expect,
                                **model_kwargs)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    span = (main_depth.max() - main_depth.min()).item()
    diff = (depth - main_depth).abs() / span
    out["depth_vs_main_path"] = {
        "median_share_of_span": diff.median().item(),
        "max_share_of_span": diff.max().item(), "main_depth_span": span}
    return out


def quant_path(frames: int, profile: bool, main_depth: torch.Tensor) -> dict:
    """The int8 encoder with the 3x3 conv kernel in the head, as a user
    reaches them: ``quant="int8p"`` and ``TXR_FUSED_CONVS=1`` /
    ``TXR_FUSED_HEAD=1``. Same weights and frames as ``main_path``."""
    out = path_with_env(
        "quant_path", {"TXR_FUSED_CONVS": "1", "TXR_FUSED_HEAD": "1"},
        frames, profile,
        {"attention": 24, "dpt_tail": 1, "offset_reduce": 1,
         "int8_linear": 96, "conv3x3": 9}, main_depth, quant="int8p")
    if not (out["fused_convs"] and out["fused_head"]):
        raise AssertionError("quant_path: the fused head settings are off")
    emit(out)
    return out


def boundmax_path(frames: int, profile: bool,
                  main_depth: torch.Tensor) -> dict:
    """``main_path``'s configuration with ``TXR_ATTN_SCORES=boundmax``,
    as a user selects the score mode: every attention call takes the
    bound-shift kernel and its key-norm pre-pass, none the f32max one."""
    out = path_with_env(
        "boundmax_path", {"TXR_ATTN_SCORES": "boundmax"}, frames, profile,
        {"attention_boundmax": 24, "attention_key_norm": 24, "dpt_tail": 1,
         "offset_reduce": 1}, main_depth)
    out["score_mode"] = "boundmax"
    emit(out)
    return out


def odd_heads_path(frames: int, gen: torch.Generator) -> dict:
    """A ViT encoder whose head count is odd, which sends attention through
    ``multi_head_attention`` on (B, H, S, D) views: two blocks at the real
    sequence length, against the same encoder with ``use_flash=False``."""
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
        for blk in range(vit.num_layers):
            attn = getattr(enc, f"block_{blk}").attn
            attn.cfg = replace(attn.cfg, use_flash=False)
        want = enc(x)
    if counts["attention_bhsd"] != vit.num_layers or counts["attention"]:
        raise AssertionError(f"odd_heads_path launch counts {counts}")
    tol = dict(ATTN_TOL, atol=3e-2,
               why="the attention tolerance with its absolute part widened "
                   "to 4 bf16 ulps of a value of 2: the two runs differ in "
                   "the attention outputs by that tolerance, and a "
                   "projection, an MLP and two LayerNorms in bf16 follow")
    errs = [compare("odd_heads_encoder", f"hidden state {i}", g, w, **tol)
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

    def __init__(self, frames: np.ndarray):
        self.frames = frames
        self.index = 0
        self.intrinsics = CameraIntrinsics.default(W, H)

    def __next__(self):
        if self.index >= len(self.frames):
            raise StopIteration
        self.index += 1
        i = self.index - 1
        return self.frames[i], float(i), f"frame_{i:04d}"


def run_processor(model, frames: np.ndarray, out_dir: str,
                  batch_size: int) -> dict:
    """``DepthProcessor`` in point-cloud mode over ``frames``, as
    ``depth_processor_torch.py``'s ``main()`` builds it, with the stages of
    each batch timed: the device part between CUDA events (upload,
    preprocess, model, upsample, back-projection; synchronised at its end),
    and on the host clock the copies to the host, each PLY write, and the
    host work between them (stacking a batch's frames, each frame's mask
    compaction)."""
    proc = DepthProcessor(model, SeededFrames(frames), out_dir,
                          mode="pointcloud", batch_size=batch_size)
    times = {"device_ms": [], "copy_ms": [], "ply_ms": [], "peak_bytes": []}
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
        expect = {"attention": 24 * 2, "dpt_tail": 2}
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

    batches = []
    sizes = [8, CLI_FRAMES - 8]
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
    out = {"phase": "depth_cli_path", "model": "v2/vitl", "dtype": "bfloat16",
           "mode": "pointcloud", "input": [H, W], "frames": CLI_FRAMES,
           "batch_size": 8, "wall_s": run["wall_s"],
           "frames_per_second": CLI_FRAMES / run["wall_s"],
           "per_batch": batches,
           "other_host_ms": run["wall_s"] * 1e3 - staged,
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
                    seed: int = 0, **overrides) -> dict:
    """Frames of a textured floor and wall with their ground truth.

    World axes x right, y down, z ahead; camera i sits at
    (i * baseline, 0, 0), pitched down by ``pitch_deg`` and turned by
    ``i * yaw_deg`` about y. Each pixel's ray meets the floor (y =
    cam_height) or the wall (z = wall_z), whichever is nearer; the colour
    is the plane's texture there (blocky noise, ``blocks_per_m`` blocks a
    metre, nearest-upsampled 4x, sampled bilinearly by ``grid_sample``: a
    homography warp per plane). Returns BGR uint8 frames, metric depth, the
    plane of each pixel (0 wall, 1 floor), world -> camera poses (float64
    numpy) and the scene's parameters."""
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
    for i in range(frames):
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
            segmented_cumsum(torch.stack(cols, 1), starts).t(), **SCAN_TOL))
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
            rtol=ENH_SCAN_TOL["rtol"], why=ENH_SCAN_TOL["why"]))
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
            or any(n for k, n in launches.items()
                   if k not in ("attention", "dpt_tail", "segscan"))):
        raise AssertionError(f"enhanced_cli_path launched {launches}; "
                             "attention >= 24, dpt_tail >= 1, segscan 9 "
                             "(LSD once a frame, the merge once)")
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
    saved = os.environ.get("TXR_FUSED_HEAD")
    os.environ["TXR_FUSED_HEAD"] = "0"
    try:
        f32, _, dpt_cfg = build_model("v2", "vitl", use_flash=False,
                                      dtype=torch.float32,
                                      generator=torch.Generator().manual_seed(0))
    finally:
        if saved is None:
            os.environ.pop("TXR_FUSED_HEAD", None)
        else:
            os.environ["TXR_FUSED_HEAD"] = saved
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
    if (any(used_f32.values()) or used_bf16["attention"] != 24
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


def profile_step(phase: str, run_step) -> None:
    """One step under ``torch.profiler``; emit the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue        # an operator's row repeats its kernels' time
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if us > 0:
            rows.append({"name": e.key[:90], "calls": e.count,
                         "ms": us / 1e3})
    rows.sort(key=lambda r: -r["ms"])
    device_ms = sum(r["ms"] for r in rows)
    emit({"phase": "profile", "of": phase,
          "step_wall_ms_under_profiler": wall_ms,
          "device_ms": device_ms, "kernels_by_device_ms": rows[:30],
          "rest_ms": sum(r["ms"] for r in rows[30:])})


def scattered_points(n: int, gen: torch.Generator) -> PointSet:
    """``n`` valid points spread over a 6 m cube: at 1 cm nearly every point
    is a voxel of its own, so one insert of a path step fills a 2^21 map."""
    return PointSet(torch.rand((n, 3), generator=gen, device="cuda") * 6 - 3,
                    torch.rand((n, 3), generator=gen, device="cuda"),
                    torch.ones((n,), dtype=torch.bool, device="cuda"))


def insert_profile(frames: int) -> dict:
    """One ``offset_map_insert`` at the path's shape (a full 2^21 map at
    1 cm, ``frames`` x 478,632 points) under ``torch.profiler``: device time
    by kernel with calls, and the gaps in which the device waited for the
    host between two kernels of the insert."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    in_h, in_w = compute_da_resize(H, W, 518)
    n = frames * in_h * in_w
    gen = torch.Generator(device="cuda").manual_seed(7)
    vm = offset_map_insert(create_offset_map(1 << 21, 0.01),
                           scattered_points(n, gen))
    if int(offset_map_size(vm)) != 1 << 21:
        raise AssertionError("insert_profile: the map is not full")
    pts = scattered_points(n, gen)
    ms = time_ms(lambda: offset_map_insert(vm, pts), runs=5, warmup=2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        offset_map_insert(vm, pts)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.key)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    by_name = {}
    for start, end, name in spans:
        row = by_name.setdefault(name[:90], {"name": name[:90], "calls": 0,
                                             "ms": 0.0})
        row["calls"] += 1
        row["ms"] += (end - start) / 1e3
    gaps = [{"us": b[0] - a[1], "before": b[2][:60]}
            for a, b in zip(spans, spans[1:]) if b[0] > a[1]]
    busy = sum(r["ms"] for r in by_name.values())
    out = {"phase": "insert_profile", "rows": (1 << 21) + n,
           "batch_points": n, "map_capacity": 1 << 21, "ms": ms,
           "wall_ms_under_profiler": wall_ms, "device_ms": busy,
           "first_to_last_kernel_ms": (spans[-1][1] - spans[0][0]) / 1e3,
           "gap_ms": sum(g["us"] for g in gaps) / 1e3,
           "largest_gaps": sorted(gaps, key=lambda g: -g["us"])[:5],
           "kernels_by_device_ms": sorted(by_name.values(),
                                          key=lambda r: -r["ms"])}
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
    ap.add_argument("--profile", action="store_true")
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
    for check in (check_attention, check_attention_boundmax,
                  check_attention_bhsd, check_tail, check_scan,
                  check_int8_linear, check_conv3x3):
        rows = check(args.frames, gen)
        summary.extend(rows if isinstance(rows, list) else [rows])
        torch.cuda.empty_cache()
    # row 3 carries both entries of the scan core: the model paths run the
    # fused reduce, fusion_cli_path the standalone scan
    scan_row = next(k for k in summary if k["name"] == "segscan")
    scan_row["offset_reduce"] = check_offset_reduce(args.frames, gen)
    scan_row["counters"] = ["offset_reduce", "segscan"]
    torch.cuda.empty_cache()
    check_reference(gen)
    torch.cuda.empty_cache()
    if args.profile:
        insert_profile(args.frames)
        torch.cuda.empty_cache()

    run, main_depth = main_path(args.frames, args.profile)
    torch.cuda.empty_cache()
    qrun = quant_path(args.frames, args.profile, main_depth)
    torch.cuda.empty_cache()
    brun = boundmax_path(args.frames, args.profile, main_depth)
    del main_depth
    torch.cuda.empty_cache()
    orun = odd_heads_path(args.frames, gen)
    torch.cuda.empty_cache()
    crun = depth_cli_path()
    torch.cuda.empty_cache()
    bf16_vs_f32(args.frames, crun["int8"]["depth_vs_bf16"])
    srun = sfm_path()
    torch.cuda.empty_cache()
    frun = fusion_cli_path()
    torch.cuda.empty_cache()
    erun = enhanced_cli_path()
    torch.cuda.empty_cache()
    # row 3's third entry: the scan at 8 columns on LSD's inputs
    scan_row["lsd_8_columns"] = erun["scan_8_columns"]
    runs = {"main_path": run, "quant_path": qrun, "boundmax_path": brun,
            "odd_heads_path": orun, "depth_cli_path": crun,
            "sfm_path": srun, "fusion_cli_path": frun,
            "enhanced_cli_path": erun}
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
