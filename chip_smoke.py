#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

builds the hand-written kernels of ``txr_torch`` from ``txr_torch/csrc``,
holds each against its plain PyTorch version on the card at the shapes the
main path gives it, and then drives the main path itself at full width:

    uint8 1080p frames -> bicubic resize + ImageNet normalize
    -> Depth Anything V2 ViT-L (bf16, seeded random weights)
    -> back-projection on the 518x924 depth grid
    -> insert into the packed mean-offset voxel map (capacity 2^21, 1 cm)

Every line of standard output is one JSON object. The phases are ``device``,
``build``, ``kernel_check`` (one line per comparison), ``reference``,
``main_path``, then the ``kernels`` summary and, last, the verdict
``{"ok": true, "device": {...}}``. Any failing phase raises and the exit
code is non-zero; nothing runs on the CPU and no kernel is swapped for its
plain version. Without a CUDA device the script exits with code 2 and
prints no result.

Options (none is needed): ``--frames N`` frames per step (default 8);
``--profile`` builds with ``-Xptxas -v`` and adds a ``ptxas`` line (each
kernel's registers and spills) and a ``profile`` line (one extra step under
``torch.profiler``: device time by kernel, largest first).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

import txr_torch._cuda as kernels
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (create_offset_map,
                                         offset_map_insert,
                                         offset_map_scan_inputs,
                                         offset_map_size)
from txr_torch.models.depth_anything import build_model
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.ops.attention import attention_reference, fused_attention
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.dpt_tail import fused_head_tail, head_tail_reference
from txr_torch.ops.resize import (IMAGENET_MEAN, IMAGENET_STD,
                                  compute_da_resize, resize_bicubic)
from txr_torch.ops.scan import segmented_cumsum_cols
from txr_torch.ops.segment import segmented_cumsum

# Published dense peaks of one H100 SXM, used for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

H, W = 1080, 1920
HEADS, HEAD_DIM = 16, 64
STEPS = 2                       # timed steps of the main path


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

    got = fused_attention(qkv, HEADS, HEAD_DIM)
    want = attention_reference(qkv, HEADS, HEAD_DIM)
    err = compare("attention", f"main B={batch} S={s}", got, want, **ATTN_TOL)
    del want
    # the ragged-key case that txr serves with its streaming kernel
    kv = 2000
    sub = qkv[:2].contiguous()
    compare("attention", f"kv_len={kv} B=2 S={s}",
            fused_attention(sub, HEADS, HEAD_DIM, kv),
            attention_reference(sub, HEADS, HEAD_DIM, kv), **ATTN_TOL)
    # a short sequence: one ragged tile, fewer query rows than a block
    tiny = qkv[:1, :77].contiguous()
    compare("attention", "S=77 B=1", fused_attention(tiny, HEADS, HEAD_DIM),
            attention_reference(tiny, HEADS, HEAD_DIM), **ATTN_TOL)

    ms = time_ms(lambda: fused_attention(qkv, HEADS, HEAD_DIM))
    plain_ms = time_ms(lambda: attention_reference(qkv, HEADS, HEAD_DIM),
                       runs=3)
    parts = qkv.view(batch, s, 3, HEADS, HEAD_DIM)
    q, k, v = (parts[:, :, i].transpose(1, 2) for i in range(3))
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    flops = 4.0 * batch * HEADS * s * s * HEAD_DIM
    nbytes = 2.0 * batch * s * (c + HEADS * HEAD_DIM)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"name": "attention", "route": "cuda",
            "source": "txr_torch/csrc/attention.cu",
            "replaces": "txr/ops/attention.py:170",
            "also_replaces": "txr/ops/attention.py:135 (kv_len < S)",
            "shape": [batch, s, c], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention",
            "tflops": flops / ms / 1e9}


def check_tail(batch: int, gen: torch.Generator) -> dict:
    hin, win, c, feat = 296, 528, 128, 32
    out_h, out_w = compute_da_resize(H, W, 518)

    def case(b, hi, wi, ho, wo):
        x = torch.randn((b, hi, wi, c), generator=gen, device="cuda").to(
            torch.bfloat16)
        return x, ho, wo

    w2 = (torch.randn((3, 3, c, feat), generator=gen, device="cuda") * 0.05
          ).to(torch.bfloat16)
    b2 = (torch.randn((feat,), generator=gen, device="cuda") * 0.5
          ).to(torch.bfloat16)
    w3 = torch.randn((feat,), generator=gen, device="cuda").to(torch.bfloat16)
    b3 = torch.randn((1,), generator=gen, device="cuda").to(torch.bfloat16)

    def exact(xs, hs, ws):
        # the plain version in f32 arithmetic on the same bf16 values (its
        # bf16 run rounds three intermediates and is itself 0.2 off this)
        return head_tail_reference(xs.float(), w2.float(), b2.float(),
                                   w3.float(), b3.float(), hs, ws)

    x, ho, wo = case(batch, hin, win, out_h, out_w)
    got = fused_head_tail(x, w2, b2, w3, b3, ho, wo)
    want = exact(x, ho, wo)
    err = compare("dpt_tail", f"main B={batch} {hin}x{win}->{ho}x{wo}", got,
                  want, **TAIL_TOL)
    del want
    for label, (hi, wi, ho2, wo2) in {
            "near-1 ratio 176->180": (176, 40, 180, 45),
            "downsample 64->40": (64, 48, 40, 30),
            "out_h == 1": (32, 16, 1, 20)}.items():
        xs, _, _ = case(1, hi, wi, ho2, wo2)
        compare("dpt_tail", label,
                fused_head_tail(xs, w2, b2, w3, b3, ho2, wo2),
                exact(xs, ho2, wo2), **TAIL_TOL)

    ms = time_ms(lambda: fused_head_tail(x, w2, b2, w3, b3, ho, wo))
    plain_ms = time_ms(lambda: head_tail_reference(x, w2, b2, w3, b3, ho, wo),
                       runs=3)
    xc = x.permute(0, 3, 1, 2)
    wk = w2.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)

    def library():
        y = F.interpolate(xc, size=(ho, wo), mode="bilinear",
                          align_corners=True)
        return F.conv2d(y, wk, b2, padding=1)

    library_ms = time_ms(library)
    flops = 2.0 * 9 * c * feat * ho * wo * batch
    nbytes = 2.0 * (x.numel() + w2.numel() + batch * ho * wo)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"name": "dpt_tail", "route": "cuda",
            "source": "txr_torch/csrc/dpt_tail.cu",
            "replaces": "txr/ops/dpt_tail.py:114",
            "shape": [batch, hin, win, c, ho, wo], "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": library_ms,
            "library_call": "F.interpolate + F.conv2d (conv2 only, no ReLU "
                            "or conv3)",
            "tflops": flops / ms / 1e9}


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

    got = torch.stack(segmented_cumsum_cols(wcols, starts))
    err = compare("segscan", f"main N={n} cols=7 segments={nseg}", got,
                  plain(wcols, starts), **SCAN_TOL)

    m = 1_000_003     # not a multiple of the tile
    vals = (torch.rand((m,), generator=gen, device="cuda"),)
    none = torch.zeros((m,), dtype=torch.bool, device="cuda")
    none[0] = True
    want = torch.cumsum(vals[0].double(), 0).float()[None]
    compare("segscan", f"start at row 0 only, N={m}",
            torch.stack(segmented_cumsum_cols(vals, none)), want,
            atol=1e-3, rtol=1e-5,
            why="a plain f32 running sum up to 5e5 (ulp 0.03) against "
                "float64")
    every = torch.ones((m,), dtype=torch.bool, device="cuda")
    compare("segscan", f"start at every row, N={m}",
            torch.stack(segmented_cumsum_cols(vals, every)), vals[0][None],
            atol=0.0, rtol=0.0, why="every row is its own segment: exact")
    eight = tuple(torch.randn((4099,), generator=gen, device="cuda")
                  for _ in range(8))
    st = torch.rand((4099,), generator=gen, device="cuda") < 0.01
    compare("segscan", "8 columns, N=4099, long segments",
            torch.stack(segmented_cumsum_cols(eight, st)), plain(eight, st),
            atol=1e-3, rtol=1e-5, why=SCAN_TOL["why"])

    ms = time_ms(lambda: segmented_cumsum_cols(wcols, starts))
    plain_ms = time_ms(lambda: plain(wcols, starts), runs=3)
    nbytes = n * (7 * 4 + 1 + 7 * 4)
    return {"name": "segscan", "route": "cuda",
            "source": "txr_torch/csrc/segscan.cu",
            "replaces": "txr/ops/scan.py:40",
            "shape": [7, n], "segments": nseg, "resident_voxels": resident,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
            "library_ms": None, "gbytes_per_s": nbytes / ms / 1e6}


# --------------------------------------------------------------- reference

def check_reference(gen: torch.Generator) -> None:
    """The port's own small check on the card: a narrow model with the
    kernels against the same weights with the plain versions, and a kernel
    insert against a CPU insert of the same points."""
    from txr_torch.models.depth_anything import DepthAnything

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
    from dataclasses import replace
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
          "small_model_value_scale": scale, "insert_voxels": n,
          "insert_keys_equal_cpu": same_keys, "ok": True})


# --------------------------------------------------------------- main path

def main_path(frames: int, profile: bool) -> dict:
    in_h, in_w = compute_da_resize(H, W, 518)
    gen = torch.Generator(device="cpu").manual_seed(0)
    model, vit_cfg, dpt_cfg = build_model("v2", "vitl", dtype=torch.bfloat16,
                                          generator=gen)
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
    if not torch.isfinite(depth).all() or not (depth != 0).any():
        raise AssertionError("depth is not finite or is all zero")

    t0 = time.perf_counter()
    for i in range(STEPS):
        vm, depth = step(dev_frames[(i + 1) % 2], vm)
    voxels = int(offset_map_size(vm))          # forces the full sync
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    counts = dict(kernels.launches)
    total = STEPS + 1
    layers = vit_cfg.num_layers
    if counts["attention"] != layers * total or counts["dpt_tail"] != total \
            or counts["segscan"] < total:
        raise AssertionError(f"launch counts {counts} for {total} steps")
    if not 0 < voxels <= (1 << 21):
        raise AssertionError(f"voxel count {voxels}")
    if not torch.isfinite(depth).all() or not (depth != 0).any():
        raise AssertionError("depth is not finite or is all zero")

    # one more step with events between the stages: where the time goes
    names = ["start", "preprocessed", "model", "backprojected", "inserted"]
    marks.update({k: torch.cuda.Event(enable_timing=True) for k in names})
    vm, _ = step(dev_frames[0], vm)
    torch.cuda.synchronize()
    stages = {b: marks[a].elapsed_time(marks[b])
              for a, b in zip(names[:-1], names[1:])}
    marks.clear()

    if profile:
        profile_step(lambda: step(dev_frames[1], vm))

    out = {"phase": "main_path", "model": "v2/vitl", "hidden": vit_cfg.hidden_size,
           "layers": layers, "heads": vit_cfg.num_heads, "dtype": "bfloat16",
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
    emit(out)
    return out


def profile_step(run_step) -> None:
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
    emit({"phase": "profile", "step_wall_ms_under_profiler": wall_ms,
          "device_ms": device_ms, "kernels_by_device_ms": rows[:30],
          "rest_ms": sum(r["ms"] for r in rows[30:])})


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
        emit({"phase": "ptxas", "kernels": ptxas_report(kernels.build_log)})

    gen = torch.Generator(device="cuda").manual_seed(0)
    summary = [check_attention(args.frames, gen),
               check_tail(args.frames, gen),
               check_scan(args.frames, gen)]
    torch.cuda.empty_cache()
    check_reference(gen)
    torch.cuda.empty_cache()

    run = main_path(args.frames, args.profile)
    for k in summary:
        k["launches"] = run["launches"][k["name"]]
        if k["launches"] < 1:
            raise AssertionError(f"the main path never launched {k['name']}")
    emit({"phase": "device", "nvidia_smi_name_power_limit": smi})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
