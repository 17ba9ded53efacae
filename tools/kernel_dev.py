#!/usr/bin/env python3
"""Stand-alone check for work on one CUDA kernel of ``txr_torch``.

    timeout 240 python3 tools/kernel_dev.py attention
    timeout 240 python3 tools/kernel_dev.py boundmax
    timeout 240 python3 tools/kernel_dev.py conv
    timeout 240 python3 tools/kernel_dev.py int8
    timeout 240 python3 tools/kernel_dev.py tail
    timeout 240 python3 tools/kernel_dev.py scan
    timeout 240 python3 tools/kernel_dev.py qk_prep

builds the kernel library with ``-Xptxas -v``, prints what ptxas said about
the chosen source (registers, spills, and the "wgmma ... serialized"
warnings that cost most of the speed when they appear), holds the kernel
against its plain version at a few small and ragged shapes and at a path
shape, and times it against its library call in one interleaved loop. It is
the short first run of a changed kernel: a wrong mbarrier phase hangs
rather than fails, so run it under ``timeout`` before ``chip_smoke.py``.
Needs one CUDA device; tolerances are ``chip_smoke.py``'s.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch
import torch.nn.functional as F

import txr_torch._cuda as kernels
from chip_smoke import (ATTN_TOL, CONV_TOL, SCAN_TOL, TAIL_TOL, check_qk_prep,
                        compare, compare_bits, int8_parts, scattered_points,
                        time_spread)
from txr_torch.fusion.offset_map import (NCOLS, _insert_cols,
                                         _reduce_unfused, _sort_keys,
                                         create_offset_map, offset_map_insert)
from txr_torch.ops.attention import (attention_flash, attention_key_norm,
                                     attention_plain, attention_reference,
                                     fused_attention, key_norm_plain,
                                     split_heads)
from txr_torch.ops.conv_stripe import (conv3x3_reference, conv3x3_stripe,
                                       pack_weight)
from txr_torch.ops.dpt_tail import (fused_head_tail, head_tail_reference,
                                    pack_params)
from txr_torch.ops.quant import Int8Linear
from txr_torch.ops.quant_fused import (Int8LinearFused, int8_linear,
                                       int8_linear_reference)
from txr_torch.ops.scan import TILE, offset_reduce, segmented_cumsum_cols
from txr_torch.ops.segment import segmented_cumsum

HEADS, HEAD_DIM = 16, 64


def ptxas_lines(source: str) -> None:
    log = kernels.build_log
    start = log.find(f"== {source} ==")
    end = log.find("\n== ", start + 1)
    for line in log[start:end if end > 0 else None].splitlines():
        if any(key in line for key in ("==", "C75", "Used", "spill",
                                       "Compiling entry")):
            print(line[:200], flush=True)


def check(name, got, want, tol) -> bool:
    """One ``kernel_check`` line; False instead of an exception."""
    try:
        compare(name.split()[0], name, got, want, **tol)
    except AssertionError as exc:
        print(f"FAIL {exc}", flush=True)
        return False
    return True


def spread(fns: dict) -> None:
    """min / median / max ms of each function, timed in turns."""
    for n, t in time_spread(fns).items():
        print(f"{n:10s} min {t['min']:.4f} median {t['median']:.4f} "
              f"max {t['max']:.4f} ms", flush=True)


def attention(gen) -> bool:
    tol = ATTN_TOL

    def qkv(b, s, h=HEADS):
        x = torch.randn((b, s, 3 * h * HEAD_DIM), generator=gen,
                        device="cuda")
        x[..., :h * HEAD_DIM] *= 3.0          # a peaked softmax
        return x.to(torch.bfloat16)

    ok = True
    x = qkv(2, 2443)
    for kv in (None, 1, 64, 1984, 2000):
        ok &= check(f"attention S=2443 kv_len={kv}",
                    fused_attention(x, HEADS, HEAD_DIM, kv),
                    attention_reference(x, HEADS, HEAD_DIM, kv), tol)
    for s in (77, 256, 2432):
        xs = x[:1, :s].contiguous()
        ok &= check(f"attention S={s}", fused_attention(xs, HEADS, HEAD_DIM),
                    attention_reference(xs, HEADS, HEAD_DIM), tol)
    q, k, v = split_heads(qkv(2, 2443, 15), 15, HEAD_DIM)
    ok &= check("attention_bhsd views, 15 heads", attention_flash(q, k, v),
                attention_plain(q, k, v), tol)
    ok &= torch.equal(fused_attention(x, HEADS, HEAD_DIM),
                      fused_attention(x, HEADS, HEAD_DIM))
    if ok:
        x = qkv(8, 2443)
        q, k, v = split_heads(x, HEADS, HEAD_DIM)
        spread({"kernel": lambda: fused_attention(x, HEADS, HEAD_DIM),
                "library": lambda: F.scaled_dot_product_attention(q, k, v)})
    return ok


def boundmax(gen) -> bool:
    tol = ATTN_TOL

    def qkv(b, s):
        x = torch.randn((b, s, 3 * HEADS * HEAD_DIM), generator=gen,
                        device="cuda")
        x[..., :HEADS * HEAD_DIM] *= 3.0      # a peaked softmax
        return x.to(torch.bfloat16)

    def run(x):
        return fused_attention(x, HEADS, HEAD_DIM, score_mode="boundmax")

    ok = True
    x = qkv(2, 2443)
    ok &= check("attention_key_norm S=2443",
                attention_key_norm(x, HEADS, HEAD_DIM),
                key_norm_plain(split_heads(x, HEADS, HEAD_DIM)[1]),
                dict(atol=0.0, rtol=1e-6, why="f32 sums in another order"))
    for s in (2443, 77, 256, 2432):
        xs = x[:, :s].contiguous()
        ok &= check(f"attention_boundmax S={s}", run(xs),
                    attention_reference(xs, HEADS, HEAD_DIM,
                                        score_mode="boundmax"), tol)
    ok &= torch.equal(run(x), run(x))
    if ok:
        x = qkv(8, 2443)
        q, k, v = split_heads(x, HEADS, HEAD_DIM)
        spread({"boundmax": lambda: run(x),
                "f32max": lambda: fused_attention(x, HEADS, HEAD_DIM,
                                                  score_mode="f32max"),
                "library": lambda: F.scaled_dot_product_attention(q, k, v),
                "key_norm": lambda: attention_key_norm(x, HEADS, HEAD_DIM)})
    return ok


def scan(gen) -> bool:
    ok = True

    def kernel(cols, starts):
        return torch.stack(segmented_cumsum_cols(cols, starts))

    for n, p in ((1, 0.5), (TILE - 1, 0.1), (TILE + 1, 0.1),
                 (100_003, 0.2), (100_003, 0.0), (1_000_003, 1e-5)):
        cols = tuple(torch.randn((n,), generator=gen, device="cuda")
                     for _ in range(7))
        starts = torch.rand((n,), generator=gen, device="cuda") < p
        got = kernel(cols, starts)
        ok &= check(f"segscan N={n} start share {p}", got,
                    segmented_cumsum(torch.stack(cols, 1), starts).t(),
                    SCAN_TOL)
        ok &= torch.equal(got, kernel(cols, starts))
    # the fused reduce against the unfused route: a full map of 2^20 and a
    # batch twice its size
    cap = 1 << 20
    vm = offset_map_insert(create_offset_map(cap, 0.01),
                           scattered_points(2 * cap, gen))
    pts = scattered_points(2 * cap, gen)
    cols = _insert_cols(vm, pts)
    got = offset_map_insert(vm, pts)
    want = _reduce_unfused(cols, cap, vm.voxel_size)
    same = [bool(torch.equal(g, w)) for g, w in zip(got[:NCOLS],
                                                     want[:NCOLS])]
    print(f"offset_reduce cap {cap} rows {cols[0].shape[0]}: columns "
          f"bit-equal {same}", flush=True)
    ok &= all(same)
    if ok:
        skey, perm = _sort_keys(cols)
        out = tuple(create_offset_map(cap, 0.01)[:NCOLS])
        wcols = tuple(torch.randn((5_926_208,), generator=gen,
                                  device="cuda") for _ in range(7))
        starts = torch.rand((5_926_208,), generator=gen, device="cuda") < 0.6
        spread({"reduce": lambda: offset_reduce(skey, perm, cols[2],
                                                cols[3], out),
                "unfused": lambda: _reduce_unfused(cols, cap, vm.voxel_size),
                "sort": lambda: _sort_keys(cols),
                "scan7": lambda: segmented_cumsum_cols(wcols, starts)})
    return ok


def conv(gen) -> bool:
    tol = CONV_TOL

    def operands(b, h, w, c, f):
        x = torch.randn((b, h, w, c), generator=gen, device="cuda")
        wgt = torch.randn((3, 3, c, f), generator=gen, device="cuda")
        bias = torch.randn((f,), generator=gen, device="cuda")
        return (x.to(torch.bfloat16),
                (wgt * (9 * c) ** -0.5).to(torch.bfloat16),
                bias.to(torch.bfloat16))

    ok = True
    for shape in ((1, 16, 16, 64, 128), (1, 13, 21, 48, 40),
                  (1, 5, 7, 64, 64), (2, 20, 33, 256, 136),
                  (2, 74, 132, 256, 256)):
        x, wgt, bias = operands(*shape)
        for relu in (False, True):
            got = conv3x3_stripe(x, wgt, bias, relu)
            ok &= check(f"conv3x3 {shape} relu_in={relu}", got,
                        conv3x3_reference(x.float(), wgt.float(),
                                          bias.float(), relu), tol)
            ok &= torch.equal(got, conv3x3_stripe(x, wgt, bias, relu))
    if ok:
        for h, w, f, relu in ((74, 132, 256, True), (148, 264, 256, True),
                              (296, 528, 128, False)):
            x, wgt, bias = operands(8, h, w, 256, f)
            packed = pack_weight(wgt)
            xc = x.permute(0, 3, 1, 2)
            wk = wgt.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            print(f"(8, {h}, {w}, 256 -> {f}) relu_in={relu}")
            spread({"kernel": lambda: conv3x3_stripe(x, wgt, bias, relu,
                                                     packed),
                    "library": lambda: F.conv2d(F.relu(xc) if relu else xc,
                                                wk, bias, padding=1)})
    return ok


def int8(gen) -> bool:
    def operands(m, k, n):
        x = torch.randn((m, k), generator=gen, device="cuda")
        x[m // 2] = 0.0                     # an all-zero row: bias only
        w = torch.randn((k, n), generator=gen, device="cuda") * k ** -0.5
        b = torch.randn((n,), generator=gen, device="cuda")
        return x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)

    ok = True
    for m, k, n in ((128, 128, 256), (300, 96, 136), (1, 16, 8),
                    (129, 1024, 1024), (77, 4096 + 16, 264),
                    (2443, 1024, 3072)):
        x, w, b = operands(m, k, n)
        got = int8_linear(x, w, b)
        try:
            compare_bits("int8_linear", f"M={m} K={k} N={n}", got,
                         int8_linear_reference(x, w, b))
        except AssertionError as exc:
            print(f"FAIL {exc}", flush=True)
            ok = False
        ok &= torch.equal(got, int8_linear(x, w, b))
    if ok:
        m = 8 * 2443
        for role, k, n in (("qkv", 1024, 3072), ("proj", 1024, 1024),
                           ("fc1", 1024, 4096), ("fc2", 4096, 1024)):
            x, w, b = operands(m, k, n)
            mods = [cls(k, n).to("cuda", torch.bfloat16)
                    for cls in (Int8LinearFused, torch.nn.Linear, Int8Linear)]
            with torch.no_grad():
                for mod in mods:
                    mod.weight.copy_(w.t())
                    mod.bias.copy_(b)
                quantise, gemm = int8_parts(mods[0], x)
                print(f"{role} M={m} K={k} N={n}")
                spread({"kernel": lambda: mods[0](x), "quantise": quantise,
                        "gemm": gemm, "bf16": lambda: mods[1](x),
                        "_int_mm": lambda: mods[2](x)})
    return ok


def tail(gen) -> bool:
    def operands(b, hi, wi, c, nout=1):
        x = torch.randn((b, hi, wi, c), generator=gen, device="cuda")
        w2 = torch.randn((3, 3, c, 32), generator=gen, device="cuda") * 0.05
        b2 = torch.randn((32,), generator=gen, device="cuda") * 0.5
        w3 = torch.randn((1, 1, 32, nout), generator=gen, device="cuda")
        b3 = torch.randn((nout,), generator=gen, device="cuda")
        return [t.to(torch.bfloat16) for t in (x, w2, b2, w3, b3)]

    ok = True
    for b, hi, wi, c, ho, wo, n in ((1, 8, 8, 64, 8, 32, 1),
                                    (1, 20, 24, 128, 35, 42, 1),
                                    (1, 4, 4, 32, 5, 7, 1),
                                    (2, 12, 20, 192, 21, 33, 1),
                                    (1, 176, 40, 128, 180, 45, 1),
                                    (1, 64, 48, 128, 40, 30, 1),
                                    (1, 32, 16, 128, 1, 20, 1),
                                    (2, 74, 132, 128, 130, 231, 1),
                                    (2, 20, 24, 128, 35, 42, 2),
                                    (1, 12, 20, 128, 21, 33, 7)):
        args = operands(b, hi, wi, c, n)
        got = fused_head_tail(*args, ho, wo)
        ok &= check(f"dpt_tail {(b, hi, wi, c)} -> {(ho, wo, n)}", got,
                    head_tail_reference(*(t.float() for t in args), ho, wo),
                    TAIL_TOL)
        ok &= torch.equal(got, fused_head_tail(*args, ho, wo))
    if ok:
        x, w2, b2, w3, b3 = operands(8, 296, 528, 128)
        packed = pack_params(w2, b2, w3, b3)
        xc = x.permute(0, 3, 1, 2)
        wk = w2.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        spread({"kernel": lambda: fused_head_tail(x, w2, b2, w3, b3, 518, 924,
                                                  packed),
                "library": lambda: F.conv2d(F.interpolate(
                    xc, size=(518, 924), mode="bilinear", align_corners=True),
                    wk, b2, padding=1)})
    return ok


def qk_prep(gen) -> bool:
    """``chip_smoke.py``'s check: three shapes against the plain version
    (raises on a miss), then the launch, the wrapper and the plain chain
    timed in turns."""
    row = check_qk_prep(16, gen)
    print(f"qk_prep {row['shape']}: {row['device_ms']:.4f} ms a launch "
          f"({row['ms']:.4f} through the wrapper), bound "
          f"{row['bound_ms']:.4f} ms, {row['gbytes_per_s']:.0f} GB/s; plain "
          f"{row['plain_ms']:.4f} ms", flush=True)
    return True


MODES = {"attention": ("attention.cu", attention),
         "boundmax": ("attention.cu", boundmax), "conv": ("conv3x3.cu", conv),
         "int8": ("int8_linear.cu", int8), "tail": ("dpt_tail.cu", tail),
         "scan": ("segscan.cu", scan), "qk_prep": ("qk_prep.cu", qk_prep)}


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else ""
    if which not in MODES:
        print(__doc__)
        return 2
    if not torch.cuda.is_available():
        print("kernel_dev: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels.build(verbose=True)
    source, run = MODES[which]
    ptxas_lines(source)
    kernels.lib()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = run(gen)
    print("ok" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
