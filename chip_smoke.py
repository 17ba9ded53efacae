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
2443-token sequence (the (B, H, S, D) attention entry point).

Every line of standard output is one JSON object. The phases are ``device``,
``build``, ``kernel_check`` (one line per comparison), ``reference``,
``main_path``, ``quant_path``, ``boundmax_path``, ``odd_heads_path``, then
the ``kernels`` summary and, last, the verdict ``{"ok": true, "device":
{...}}``. Any failing phase raises and the exit code is non-zero; nothing
runs on the CPU and no kernel is swapped for its plain version. Without a
CUDA device the script exits with code 2 and prints no result.

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
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

import txr_torch._cuda as kernels
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (NCOLS, _insert_cols,
                                         _reduce_unfused, _sort_keys,
                                         create_offset_map, offset_map_insert,
                                         offset_map_merge,
                                         offset_map_scan_inputs,
                                         offset_map_size)
from txr_torch.models.depth_anything import DepthAnything, build_model
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.ops.attention import BLOCK_K as ATTN_BLOCK_K
from txr_torch.ops.attention import BLOCK_Q as ATTN_BLOCK_Q
from txr_torch.ops.attention import (attention_flash, attention_key_norm,
                                     attention_plain, attention_reference,
                                     fused_attention, key_norm_plain,
                                     split_heads)
from txr_torch.ops.attention import kernel_geometry as attention_geometry
from txr_torch.ops.backproject import backproject_world
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

# Published dense peaks of one H100 SXM, used for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_BYTES = 3.35e12

H, W = 1080, 1920
HEADS, HEAD_DIM = 16, 64
ODD_HEADS = 15                  # head count of the odd-heads path
STEPS = 2                       # timed steps of a path


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
    # row 3 carries both entries of the scan core; its launches are the
    # fused reduce's, which is what the paths run
    scan_row = next(k for k in summary if k["name"] == "segscan")
    scan_row["offset_reduce"] = check_offset_reduce(args.frames, gen)
    scan_row["counter"] = "offset_reduce"
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
    runs = {"main_path": run, "quant_path": qrun, "boundmax_path": brun,
            "odd_heads_path": orun}
    # the path whose count stands in the kernels line: the first that runs it
    for k in summary:
        counter = k.get("counter", k["name"])
        by_path = {name: r["launches"][counter] for name, r in runs.items()}
        k["launches_by_path"] = by_path
        path = next((name for name, n in by_path.items() if n), "main_path")
        k["launches"] = by_path[path]
        k["launches_in"] = path
        k["launches_over_steps"] = runs[path]["launches_over_steps"]
        if k["launches"] < 1:
            raise AssertionError(f"no path launched {counter}")
    emit({"phase": "device", "nvidia_smi_name_power_limit": smi})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
