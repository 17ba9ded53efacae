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

``main_path`` runs it with the default configuration (attention, DPT tail
and segmented-scan kernels); ``quant_path`` with ``quant="int8p"`` and
``TXR_FUSED_CONVS=1`` (also the int8 linear and 3x3 conv kernels);
``odd_heads_path`` runs a two-block ViT encoder of 15 heads on the same
2443-token sequence (the (B, H, S, D) attention entry point).

Every line of standard output is one JSON object. The phases are ``device``,
``build``, ``kernel_check`` (one line per comparison), ``reference``,
``main_path``, ``quant_path``, ``odd_heads_path``, then the ``kernels``
summary and, last, the verdict ``{"ok": true, "device": {...}}``. Any
failing phase raises and the exit code is non-zero; nothing runs on the CPU
and no kernel is swapped for its plain version. Without a CUDA device the
script exits with code 2 and prints no result.

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
from dataclasses import replace

import numpy as np
import torch
import torch.nn.functional as F

import txr_torch._cuda as kernels
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (create_offset_map,
                                         offset_map_insert,
                                         offset_map_scan_inputs,
                                         offset_map_size)
from txr_torch.models.depth_anything import DepthAnything, build_model
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.ops.attention import (attention_flash, attention_plain,
                                     attention_reference, fused_attention,
                                     split_heads)
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.conv_stripe import (conv3x3_reference, conv3x3_stripe,
                                       pack_weight)
from txr_torch.ops.dpt_tail import fused_head_tail, head_tail_reference
from txr_torch.ops.quant import Int8Linear
from txr_torch.ops.quant_fused import (Int8LinearFused, int8_linear,
                                       int8_linear_reference)
from txr_torch.ops.resize import (IMAGENET_MEAN, IMAGENET_STD,
                                  compute_da_resize, resize_bicubic)
from txr_torch.ops.scan import segmented_cumsum_cols
from txr_torch.ops.segment import segmented_cumsum

# Published dense peaks of one H100 SXM, used for the bounds.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
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


def check_int8_linear(batch: int, gen: torch.Generator) -> dict:
    in_h, in_w = compute_da_resize(H, W, 518)
    m = batch * ((in_h // 14) * (in_w // 14) + 1)

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

    x, w, b = operands(300, 96, 136)
    got = int8_linear(x, w, b)
    compare_bits("int8_linear", "ragged M=300 K=96 N=136", got,
                 int8_linear_reference(x, w, b))
    if not torch.equal(got[150].float(), b.float()):
        raise AssertionError("int8_linear: an all-zero row must give the bias")

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
            ms = time_ms(lambda: fused(x))
            plain_ms = time_ms(lambda: int8_linear_reference(x, w, b), runs=3)
            bf16_ms = time_ms(lambda: plain(x))
            int8_ms = time_ms(lambda: lib8(x))
        ops = 2.0 * m * k * n
        nbytes = 2.0 * m * k + k * n + 8.0 * n + 2.0 * m * n
        by_shape.append({"role": role, "shape": [m, k, n], **res, "ms": ms,
                         "plain_ms": plain_ms,
                         **bound(ops, PEAK_INT8_OPS, nbytes),
                         "library_ms": bf16_ms, "library_int8_ms": int8_ms,
                         "tops": ops / ms / 1e9})
        del x, w, b, fused, lib8, plain
    fc2 = by_shape[-1]
    return {"name": "int8_linear", "route": "cuda",
            "source": "txr_torch/csrc/int8_linear.cu",
            "replaces": "txr/ops/quant_pallas.py:37",
            "shape": fc2["shape"], "shape_role": "fc2 (the other three "
            "shapes of an encoder block are under by_shape)",
            "max_abs_err": max(r["max_abs_err"] for r in by_shape),
            "bit_equal_share": min(r["bit_equal_share"] for r in by_shape),
            "ms": fc2["ms"], "plain_ms": fc2["plain_ms"],
            "bound_ms": fc2["bound_ms"], "bound_by": fc2["bound_by"],
            "library_ms": fc2["library_ms"],
            "library_call": "F.linear in bf16 (nn.Linear); library_int8_ms "
                            "is the 'int8' policy: torch._int_mm with its "
                            "quantise and rescale passes",
            "library_int8_ms": fc2["library_int8_ms"],
            "block_ms": sum(r["ms"] for r in by_shape),
            "block_library_ms": sum(r["library_ms"] for r in by_shape),
            "block_library_int8_ms": sum(r["library_int8_ms"]
                                         for r in by_shape),
            "tops": fc2["tops"], "by_shape": by_shape}


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

    x, wgt, bias = operands(1, 13, 21, 48, 40)
    for relu in (False, True):
        compare("conv3x3", f"ragged 13x21 48->40 relu_in={relu}",
                conv3x3_stripe(x, wgt, bias, relu), exact(x, wgt, bias, relu),
                **CONV_TOL)

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
        ms = time_ms(lambda: conv3x3_stripe(x, wgt, bias, relu, packed))
        plain_ms = time_ms(lambda: conv3x3_reference(x, wgt, bias, relu),
                           runs=3)
        xc = x.permute(0, 3, 1, 2)
        wk = wgt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            return F.conv2d(F.relu(xc) if relu else xc, wk, bias, padding=1)

        library_ms = time_ms(library)
        flops = 2.0 * 9 * c * f * h * w * batch
        nbytes = 2.0 * (x.numel() + wgt.numel() + batch * h * w * f) + 4.0 * f
        by_shape.append({"site": label, "shape": [batch, h, w, c, f],
                         "relu_in": relu, "launches_per_step": per_step,
                         "max_abs_err": max(errs), "ms": ms,
                         "plain_ms": plain_ms,
                         **bound(flops, PEAK_BF16_FLOPS, nbytes),
                         "library_ms": library_ms,
                         "tflops": flops / ms / 1e9})
        del x, wgt, bias, packed, xc, wk
    mid = by_shape[1]
    return {"name": "conv3x3", "route": "cuda",
            "source": "txr_torch/csrc/conv3x3.cu",
            "replaces": "txr/ops/conv_stripe.py:45",
            "shape": mid["shape"], "shape_site": "fusion_0 (the other two "
            "shapes of the path are under by_shape)",
            "max_abs_err": max(r["max_abs_err"] for r in by_shape),
            "ms": mid["ms"], "plain_ms": mid["plain_ms"],
            "bound_ms": mid["bound_ms"], "bound_by": mid["bound_by"],
            "library_ms": mid["library_ms"],
            "library_call": "F.conv2d on channels_last bf16 (F.relu in "
                            "front where relu_in)",
            "step_ms": sum(r["ms"] * r["launches_per_step"]
                           for r in by_shape),
            "step_library_ms": sum(r["library_ms"] * r["launches_per_step"]
                                   for r in by_shape),
            "tflops": mid["tflops"], "by_shape": by_shape}


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
    kv = 2000
    compare("attention_bhsd", f"kv_len={kv} B=2 H={h} S={s}",
            attention_flash(q[:2], k[:2], v[:2], kv),
            attention_plain(q[:2], k[:2], v[:2], kv), **ATTN_TOL)
    compare("attention_bhsd", "S=77 B=1 contiguous",
            attention_flash(*(t[:1, :, :77].contiguous() for t in (q, k, v))),
            attention_plain(q[:1, :, :77], k[:1, :, :77], v[:1, :, :77]),
            **ATTN_TOL)

    ms = time_ms(lambda: attention_flash(q, k, v))
    plain_ms = time_ms(lambda: attention_plain(q, k, v), runs=3)
    library_ms = time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    flops = 4.0 * batch * h * s * s * d
    nbytes = 2.0 * batch * s * 4 * h * d
    return {"name": "attention_bhsd", "route": "cuda",
            "source": "txr_torch/csrc/attention.cu",
            "replaces": "txr/ops/attention.py:49",
            "shape": [batch, h, s, d], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **bound(flops, PEAK_BF16_FLOPS, nbytes),
            "library_ms": library_ms,
            "library_call": "F.scaled_dot_product_attention",
            "tflops": flops / ms / 1e9}


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
    maps a kernel to its launches per step (asserted; ``segscan`` at
    least). Emits the phase's line and returns it with the depth of the
    staged step (frames of seed 0)."""
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
        if name == "segscan":
            ok = got >= per_step * total
        else:
            ok = got == per_step * total
        if not ok:
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
    """The default configuration: attention, tail and scan kernels."""
    out, depth = drive_path("main_path", frames, profile,
                            {"attention": 24, "dpt_tail": 1, "segscan": 1})
    emit(out)
    return out, depth


def quant_path(frames: int, profile: bool, main_depth: torch.Tensor) -> dict:
    """The int8 encoder with the 3x3 conv kernel in the head, as a user
    reaches them: ``quant="int8p"`` and ``TXR_FUSED_CONVS=1`` /
    ``TXR_FUSED_HEAD=1``. Same weights and frames as ``main_path``."""
    saved = {k: os.environ.get(k) for k in ("TXR_FUSED_CONVS",
                                            "TXR_FUSED_HEAD")}
    os.environ.update(TXR_FUSED_CONVS="1", TXR_FUSED_HEAD="1")
    try:
        out, depth = drive_path(
            "quant_path", frames, profile,
            {"attention": 24, "dpt_tail": 1, "segscan": 1, "int8_linear": 96,
             "conv3x3": 9}, quant="int8p")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if not (out["fused_convs"] and out["fused_head"]):
        raise AssertionError("quant_path: the fused head settings are off")
    span = (main_depth.max() - main_depth.min()).item()
    diff = (depth - main_depth).abs() / span
    out["depth_vs_main_path"] = {
        "median_share_of_span": diff.median().item(),
        "max_share_of_span": diff.max().item(), "main_depth_span": span}
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
    summary = []
    for check in (check_attention, check_attention_bhsd, check_tail,
                  check_scan, check_int8_linear, check_conv3x3):
        summary.append(check(args.frames, gen))
        torch.cuda.empty_cache()
    check_reference(gen)
    torch.cuda.empty_cache()

    run, main_depth = main_path(args.frames, args.profile)
    torch.cuda.empty_cache()
    qrun = quant_path(args.frames, args.profile, main_depth)
    del main_depth
    torch.cuda.empty_cache()
    orun = odd_heads_path(args.frames, gen)
    runs = {"main_path": run, "quant_path": qrun, "odd_heads_path": orun}
    # the path whose count stands in the kernels line: the first that runs it
    for k in summary:
        by_path = {name: r["launches"][k["name"]] for name, r in runs.items()}
        k["launches_by_path"] = by_path
        path = next((name for name, n in by_path.items() if n), "main_path")
        k["launches"] = by_path[path]
        k["launches_in"] = path
        k["launches_over_steps"] = runs[path]["launches_over_steps"]
        if k["launches"] < 1:
            raise AssertionError(f"no path launched {k['name']}")
    emit({"phase": "device", "nvidia_smi_name_power_limit": smi})
    emit({"kernels": summary})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
