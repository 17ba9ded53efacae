"""Fused DPT output-head tail: Hopper kernel + plain PyTorch version.
Counterpart of ``txr/ops/dpt_tail.py``.

The head ends with

    y = conv1(y)                                   # (B, Hin, Win, C)
    y = resize_bilinear(y, H, W, align_corners=True)
    y = conv2_3x3(y); y = relu(y); y = conv3_1x1(y)   # -> (B, H, W, N)

and run as separate ops the resized activation (B, H, W, C) goes through
device memory twice. The kernel (``csrc/dpt_tail.cu``) replaces the TPU
kernel ``txr/ops/dpt_tail.py:_tail_kernel`` and computes the whole tail per
output tile. Once that tensor stays on chip the work is bound by conv2's
operations on this card, and with only 32 output features what stands in
the tensor cores' way is shared-memory traffic and the lerp arithmetic, so
the design overlaps the three: one persistent block per multiprocessor
keeps the packed conv2 kernel resident (loaded once, by TMA), a producer
thread brings in the window of input pixels a tile-plus-halo touches, lerp
warps build the upsampled patch of the next (tile, 64-channel chunk) from
that window in shared memory, and two consumer warpgroups run the nine taps
of the current one on ``wgmma`` with both operands in shared memory: the
patch is one flat array of pixels, so a tap is a shift of the whole array
and its operand 64 consecutive pixels (:func:`kernel_geometry` has the
arithmetic). The lerps are direct four-tap reads, so every resize ratio
takes the same path (``txr``'s row window and its ``_window_covers`` guard
are TPU-shaped and are not carried over); a downsample so strong that the
window outgrows shared memory or a TMA box is refused by name.

The kernel takes bf16, 32 conv2 features, C a multiple of 16, the conv2
kernel repacked as (9, 32, C), and any number N of conv3 outputs (Depth
Anything's heads have 1; Depth Anything 3's depth and ray branches 2 and
7), which it writes as (B, H, W, N); :func:`pack_params` makes the packed
kernel and the f32 vectors once, and ``DPTHead`` keeps them until the
parameters change. One output channel is returned as (B, H, W).

VGGT's heads add a fixed position embedding ``pe`` (H, W, C) to the
upsampled activation before conv2. conv2 is linear, so conv2(up + pe) =
conv2(up) + conv2(pe) with the same zero padding; the second term, (H, W,
F) in float32 without conv2's bias, depends on the grid and the weights
alone, so the head keeps it (``models/vggt.py:VGGTHead``) and the kernel
adds it to its accumulators before the bias and ReLU (``pos_term``). That
costs 128 bytes a pixel read (shared by the batch's images) and no
arithmetic on the upsampled patch; adding ``pe`` itself inside the kernel
would instead read 2 C bytes a pixel and add C values a pixel to the
lerp's work, which is the kernel's bottleneck. Without the term the kernel
is as before, bit for bit. The term takes its gradient like the other
operands.

``fused_head_tail`` takes the plain version only for a tensor that lies on
the CPU. For a CUDA tensor it launches the kernel or raises. Its gradient
differentiates the plain version, as ``txr/models/dpt.py:_tail_fused`` does.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from txr_torch import _cuda
from txr_torch.ops.resize import resize_bilinear

# The kernel's tiling (csrc/dpt_tail.cu; ``chip_smoke.py`` checks that the
# built library reports the same numbers).
KERNEL_FEATURES = 32         # conv2 output width the kernel is built for
TILE_W = 32                  # output pixels per tile row
PATCH_W = TILE_W + 2         # patch row: the tile and conv2's halo
PRODUCT_TILES = (4, 2)       # 64-position product tiles a tile is cut into,
                             # tried in this order (two consumer warpgroups)
CHUNK_C = 64                 # channels per unit of work (128-byte rows)
THREADS = 640                # 2 consumer warpgroups, 11 lerp warps, producer
MAX_BOX = 256                # a TMA box's extent per dimension
MAX_SMEM_BYTES = 232448      # what one block may use on an H100


def tile_height(product_tiles: int) -> int:
    """Output rows whose 34 positions each (two of them halo, computed and
    dropped) fit ``product_tiles`` tiles of 64 positions."""
    return product_tiles * 64 // PATCH_W


def patch_bytes(product_tiles: int) -> int:
    """One patch buffer: the (TH + 2) x 34 pixels the lerp writes, or the
    reach of the last product tile's shifted reads if that is more, in
    128-byte pixels, rounded up to the swizzle pattern's 1024 bytes."""
    written = (tile_height(product_tiles) + 2) * PATCH_W
    read = product_tiles * 64 + 2 * PATCH_W + 2
    return -(-max(written, read) * CHUNK_C * 2 // 1024) * 1024


TILE_HEIGHTS = tuple(tile_height(n) for n in PRODUCT_TILES)      # (7, 3)


def _scale(n_in: int, n_out: int) -> np.float32:
    if n_out <= 1:
        return np.float32(0.0)
    return np.float32(n_in - 1) / np.float32(n_out - 1)


def _origin(t0: int, scale: np.float32, n_in: int) -> int:
    """First input index the taps of a tile starting at output ``t0`` (with
    its halo) read: f32 arithmetic, as the kernel's."""
    lo = int(np.floor(np.float32(max(t0 - 1, 0)) * scale))
    return min(lo, n_in - 1)


def window_extent(n_out: int, n_in: int, tile: int) -> int:
    """Most input rows (or columns) the taps of one tile-plus-halo touch,
    over every tile of ``tile`` outputs along an axis."""
    scale = _scale(n_in, n_out)
    best = 1
    for t0 in range(0, n_out, tile):
        last = min(t0 + tile, n_out - 1)
        hi = min(int(np.floor(np.float32(last) * scale)), n_in - 1)
        hi = min(hi + 1, n_in - 1)
        best = max(best, hi - _origin(t0, scale, n_in) + 1)
    return best


@functools.lru_cache(maxsize=64)
def kernel_geometry(batch: int, hin: int, win: int, c: int, out_h: int,
                    out_w: int, sm_count: int) -> dict:
    """Tile, window box, ring depth, shared-memory bytes and grid of one
    launch on a device of ``sm_count`` multiprocessors (pure; the kernel's
    own arithmetic, kept here so that it can be tested without the card).
    The tallest tile and the deepest window ring that fit are taken. Raises
    ``ValueError`` when nothing fits. The result is kept per shape: treat
    it as read-only."""
    if min(batch, hin, win, c, out_h, out_w, sm_count) < 1:
        raise ValueError("every size and the multiprocessor count must be "
                         "positive")
    chunks = -(-c // CHUNK_C)
    weight_bytes = 9 * chunks * KERNEL_FEATURES * CHUNK_C * 2
    win_w = window_extent(out_w, win, TILE_W)
    ntx = -(-out_w // TILE_W)
    for ntiles in PRODUCT_TILES if win_w <= MAX_BOX else ():
        th = tile_height(ntiles)
        win_h = window_extent(out_h, hin, th)
        if win_h > MAX_BOX:
            continue
        p_bytes = patch_bytes(ntiles)
        win_bytes = -(-win_h * win_w * CHUNK_C * 2 // 1024) * 1024
        for nwin in (2, 1):
            # 1024 of alignment, the resident conv2 kernel, two patches,
            # the window ring, two coordinate tables (9 rows + 34 columns
            # of 16 bytes), nine mbarriers
            smem = (1024 + weight_bytes + 2 * p_bytes + nwin * win_bytes
                    + 2 * (TILE_HEIGHTS[0] + 2 + PATCH_W) * 16 + 9 * 8)
            if smem > MAX_SMEM_BYTES:
                continue
            nty = -(-out_h // th)
            tiles = batch * nty * ntx
            if tiles > (2 ** 31 - 1) // (9 * chunks):
                raise ValueError(
                    f"the DPT tail kernel counts its work in 32 bits: "
                    f"{tiles} tiles of {chunks} chunks are too many")
            return {"grid": min(tiles, sm_count), "threads": THREADS,
                    "tile": (th, TILE_W), "product_tiles": ntiles,
                    "tiles": tiles,
                    "tiles_yx": (nty, ntx), "chunks": chunks,
                    "window": (win_h, win_w), "window_buffers": nwin,
                    # innermost first: x seen as (C, Win, Hin, B), the packed
                    # conv2 kernel as (C, F, 9)
                    "window_box": (CHUNK_C, win_w, win_h, 1),
                    "weight_box": (CHUNK_C, KERNEL_FEATURES, 1),
                    "weight_bytes": weight_bytes, "patch_bytes": p_bytes,
                    "window_bytes": win_bytes, "smem_bytes": smem}
    raise ValueError(
        f"the DPT tail kernel cannot take the resize {hin}x{win} -> "
        f"{out_h}x{out_w} at {c} channels: the window of input pixels under "
        f"one output tile ({window_extent(out_h, hin, TILE_HEIGHTS[-1])} x "
        f"{win_w}) does not fit a block's shared memory or a TMA box "
        f"(a downsample this strong, or too many channels)")


def tile_origin(i: int, geo: dict) -> tuple:
    """Batch index, first output row and first output column of tile ``i``
    (x runs fastest)."""
    nty, ntx = geo["tiles_yx"]
    b, r = divmod(i, nty * ntx)
    ty, tx = divmod(r, ntx)
    return b, ty * geo["tile"][0], tx * geo["tile"][1]


def head_tail_reference(x: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                        w3: torch.Tensor, b3: torch.Tensor, out_h: int,
                        out_w: int, pos_term: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Plain PyTorch version: resize -> conv2 (+ ``pos_term``) -> relu ->
    conv3.

    x: (B, Hin, Win, C); w2: (3, 3, C, F); b2: (F,); w3: (1, 1, F, N), or
    (F,) for N = 1; b3: (N,); ``pos_term``: None, or (out_h, out_w, F)
    added to every image's conv2 output before the ReLU
    (:func:`position_term`). Returns (B, out_h, out_w, N), or (B, out_h,
    out_w) for N = 1, in x's dtype.
    """
    dt = x.dtype
    n = b3.numel()
    y = resize_bilinear(x, out_h, out_w, align_corners=True)
    y = F.conv2d(y.permute(0, 3, 1, 2), w2.to(dt).permute(3, 2, 0, 1),
                 b2.to(dt), padding=1)
    if pos_term is not None:
        y = y + pos_term.permute(2, 0, 1).to(dt)
    y = F.relu(y)
    f = w3.reshape(-1, n).t().reshape(n, -1, 1, 1).to(dt)
    out = F.conv2d(y, f) + b3.reshape(1, n, 1, 1).to(dt)
    out = out[:, 0] if n == 1 else out.permute(0, 2, 3, 1)
    return out.to(dt)


def position_term(pe: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """conv2 (3 x 3, zero padding, no bias) of a position embedding ``pe``
    (H, W, C) added to the upsampled activation: (H, W, F) float32,
    contiguous, the ``pos_term`` of :func:`fused_head_tail`. ``w2``: (3, 3,
    C, F)."""
    y = F.conv2d(pe.float().permute(2, 0, 1)[None],
                 w2.float().permute(3, 2, 0, 1), padding=1)
    return y[0].permute(1, 2, 0).contiguous()


def pack_conv2(w2: torch.Tensor) -> torch.Tensor:
    """conv2's kernel (3, 3, C, F) -> (9, F, C) bf16 (tap, feature,
    channel): the K-major B operand of the kernel's products."""
    c, feat = w2.shape[2], w2.shape[3]
    return w2.to(torch.bfloat16).permute(0, 1, 3, 2).reshape(9, feat, c
                                                             ).contiguous()


def pack_params(w2: torch.Tensor, b2: torch.Tensor, w3: torch.Tensor,
                b3: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The kernel's operands: :func:`pack_conv2` of w2, and b2 (F,), w3
    (N, F) (output-major: conv3's own OIHW order), b3 (N,) flat in f32."""
    n = b3.numel()
    return (pack_conv2(w2),
            *(t.to(torch.float32).reshape(-1).contiguous()
              for t in (b2, w3.reshape(-1, n).t(), b3)))


def _launch(x, packed, out_h: int, out_w: int, pos_term=None
            ) -> torch.Tensor:
    b, hin, win, c = x.shape
    w2p, b2f, w3f, b3f = packed
    feat = w2p.shape[1]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the DPT tail kernel takes bfloat16, got {x.dtype}")
    if feat != KERNEL_FEATURES:
        raise ValueError(
            f"the DPT tail kernel is built for {KERNEL_FEATURES} conv2 "
            f"features, got {feat}")
    if c % 16:
        raise ValueError(
            f"the DPT tail kernel needs a channel count that is a multiple "
            f"of 16, got {c}")
    if w2p.shape != (9, feat, c) or w2p.dtype != torch.bfloat16:
        raise ValueError(
            f"packed conv2 kernel must be (9, {feat}, {c}) bfloat16, got "
            f"{tuple(w2p.shape)} {w2p.dtype}")
    nout = b3f.numel()
    if (b2f.shape != (feat,) or w3f.shape != (nout * feat,)
            or b3f.shape != (nout,)):
        raise ValueError(
            f"b2 and w3 must hold {feat} and {nout * feat} values (b3's "
            f"{nout} outputs), got {tuple(b2f.shape)}, {tuple(w3f.shape)}, "
            f"{tuple(b3f.shape)}")
    if pos_term is not None and pos_term.shape != (out_h, out_w, feat):
        raise ValueError(
            f"the position term must be ({out_h}, {out_w}, {feat}), got "
            f"{tuple(pos_term.shape)}")
    dev = x.device
    operands = [("x", x, torch.bfloat16),
                ("the packed conv2 kernel", w2p, torch.bfloat16),
                ("b2", b2f, torch.float32), ("w3", w3f, torch.float32),
                ("b3", b3f, torch.float32)]
    if pos_term is not None:
        operands.append(("the position term", pos_term, torch.float32))
    for name, ten, dt in operands:
        if (ten.device != dev or ten.dtype != dt or not ten.is_contiguous()
                or ten.data_ptr() % 16):
            raise ValueError(
                f"the DPT tail kernel needs {name} contiguous, 16-byte "
                f"aligned, {dt} and on {dev}")
    sms = _cuda.sm_count(dev)
    kernel_geometry(b, hin, win, c, out_h, out_w, sms)   # raises by name
    out = torch.empty((b, out_h, out_w, nout), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().txr_dpt_tail_fwd(
            x.data_ptr(), w2p.data_ptr(), b2f.data_ptr(), w3f.data_ptr(),
            b3f.data_ptr(),
            None if pos_term is None else pos_term.data_ptr(),
            out.data_ptr(), b, hin, win, c, out_h, out_w, nout, sms,
            torch.cuda.current_stream().cuda_stream)
    _cuda.check(err, "dpt_tail")
    _cuda.launches["dpt_tail"] += 1
    return out[..., 0] if nout == 1 else out


class _FusedHeadTail(torch.autograd.Function):
    """Kernel forward; backward differentiates the plain version."""

    @staticmethod
    def forward(ctx, x, w2, b2, w3, b3, out_h, out_w, packed, pos_term):
        ctx.save_for_backward(x, w2, b2, w3, b3,
                              *(() if pos_term is None else (pos_term,)))
        ctx.size = (out_h, out_w)
        if x.device.type == "cpu":
            return head_tail_reference(x, w2, b2, w3, b3, out_h, out_w,
                                       pos_term)
        if packed is None:
            packed = pack_params(*(t.to(x.device) for t in (w2, b2, w3, b3)))
        return _launch(x, packed, out_h, out_w, pos_term)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True) for t in saved]
            y = head_tail_reference(*leaves[:5], *ctx.size, *leaves[5:])
            grads = torch.autograd.grad(y, leaves, grad, allow_unused=True)
        return (*grads[:5], None, None, None, *(grads[5:] or (None,)))


def fused_head_tail(x: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
                    w3: torch.Tensor, b3: torch.Tensor, out_h: int,
                    out_w: int,
                    packed: Optional[Tuple[torch.Tensor, ...]] = None,
                    pos_term: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Fused resize(align_corners=True) + conv2(3x3, pad 1) + ReLU +
    conv3(1x1) for the DPT output head.

    x: (B, Hin, Win, C) NHWC contiguous conv1 output.
    w2: (3, 3, C, F), b2: (F,), w3: (1, 1, F, N) or, for N = 1, (F,), b3:
    (N,). Returns the N pre-activation outputs (B, out_h, out_w, N), or
    (B, out_h, out_w) for N = 1, in x's dtype. ``packed`` may carry
    ``pack_params(w2, b2, w3, b3)`` made earlier, which saves the repack on
    a CUDA call. ``pos_term`` (out_h, out_w, F) float32, contiguous: added
    to conv2's output of every image before the ReLU (VGGT's position
    embedding through conv2, :func:`position_term`), and takes its
    gradient.
    """
    if x.dim() != 4 or w2.dim() != 4 or w2.shape[:3] != (3, 3, x.shape[3]):
        raise ValueError(
            f"expected x (B, Hin, Win, C) and w2 (3, 3, C, F), got "
            f"{tuple(x.shape)} and {tuple(w2.shape)}")
    if b3.numel() < 1 or w3.numel() != w2.shape[3] * b3.numel():
        raise ValueError(
            f"w3 must hold {w2.shape[3]} weights for each of b3's "
            f"{b3.numel()} outputs, got {tuple(w3.shape)}")
    if out_h < 1 or out_w < 1:
        raise ValueError("output size must be positive")
    return _FusedHeadTail.apply(x, w2, b2, w3, b3, out_h, out_w, packed,
                                pos_term)
