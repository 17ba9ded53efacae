"""Depth Anything 3 any-view (DA3-LARGE), in plain float32 PyTorch.

Written from the published description (arXiv:2511.10647, "Depth Anything
3: Recovering the Visual Space from Any Views"; github.com/ByteDance-Seed/
Depth-Anything-3), as this benchmark's configuration states it
(``configs/da3-large-anyview.json``):

- preprocess as Depth Anything V2 (``reference/depth_anything_v2.py``);
- a DINOv2 ViT whose blocks are Depth Anything V2's, but from layer
  ``alt_start`` on the odd layers attend over every token of every view of
  the step (one sequence of views x tokens) and the even ones within each
  view; from ``qknorm_start`` on q and k take a LayerNorm (weight, bias,
  eps 1e-6) over the head dimension, and from ``rope_start`` on a 2-D
  rotary embedding: the head's first half turns with the token's row, the
  second with its column, each half as a 1-D RoPE of base ``rope_freq``
  (frequencies ``base^(-2j / half)``, the angle table concatenated with
  itself, ``x cos + rotate_half(x) sin``), the special token at position
  (0, 0) and patch (r, c) at (r + 1, c + 1);
- at layer ``alt_start`` a learned camera token replaces the cls token:
  ``camera_token[0, 0]`` in view 0, ``camera_token[0, 1]`` in the others;
- each taken layer hands on the concatenation of the last within-view
  layer's output and its own, each after the final LayerNorm (2 x width);
- a dual DPT head: per taken layer a 1 x 1 projection from 2 x width and
  Depth Anything V2's resizes and 3 x 3 scratch convs, shared; then two
  fusion stacks and two output tails (conv 3 x 3, bilinear upsample to
  the model grid, conv 3 x 3, ReLU, conv 1 x 1): the depth branch's 2
  channels give depth exp(y0) and its confidence 1 + exp(y1), the ray
  branch's 7 give 6 ray components (linear) and a confidence 1 + exp(y6).

Recalled, not read from the published code (no file of it is here), and
so listed under the configuration's ``assumed``: the start layers (8) and
cross-view attention on the odd ones, the taken layers (11, 15, 19, 23),
the camera token's two entries, the RoPE convention and base, the QK-norm
eps, the head's outputs and activations, and that the scratch convs are
shared. Departures from the published model that are known: the published
code may give the cross-view layers other RoPE positions and may apply the
final LayerNorm to the cross-view half of a joined feature only; its head
may add position encodings to the projected features and may give the
ray branch an output size of its own. None of these is modelled here:
this is the model the configuration states, which the program must match.

No kernel, no cache, no batching beyond the step's views. Attention is
taken in blocks of query rows, so that no score matrix passes about
2^29 entries (a full cross-view one at 16 views of 2443 tokens and 16
heads would be 98 GB in float32). ``reference`` turns TF32 off for its
call.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench.reference.depth_anything_v2 import (_conv, _fusion, _lin,
                                                    _ln, _up, exact_float32,
                                                    preprocess)

SCORE_ENTRIES = 1 << 29


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
           ) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v on (B, H, S, d), in blocks of query
    rows."""
    b, h, s, d = q.shape
    rows = max(1, SCORE_ENTRIES // (b * h * k.shape[2]))
    out = torch.empty_like(q)
    for i in range(0, s, rows):
        att = torch.softmax(q[:, :, i:i + rows] @ k.transpose(-1, -2)
                            * d ** -0.5, dim=-1)
        out[:, :, i:i + rows] = att @ v
    return out


def _rope_1d(x: torch.Tensor, pos: torch.Tensor, base: float
             ) -> torch.Tensor:
    """1-D RoPE of x (..., S, n) at integer positions pos (S,)."""
    n = x.shape[-1]
    inv = 1.0 / base ** (torch.arange(0, n, 2, device=x.device,
                                      dtype=torch.float32) / n)
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    x1, x2 = x[..., :n // 2], x[..., n // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * ang.cos().to(x.dtype) + rotated * ang.sin().to(x.dtype)


def rope_2d(x: torch.Tensor, ph: int, pw: int, base: float
            ) -> torch.Tensor:
    """2-D RoPE of x (B, H, 1 + ph*pw, d): rows on the first half of d,
    columns on the second; the special token at (0, 0), patches at their
    (row, col) + 1."""
    dev = x.device
    r = torch.arange(ph, device=dev).repeat_interleave(pw) + 1
    c = torch.arange(pw, device=dev).repeat(ph) + 1
    zero = torch.zeros(1, dtype=r.dtype, device=dev)
    r, c = torch.cat([zero, r]), torch.cat([zero, c])
    half = x.shape[-1] // 2
    return torch.cat([_rope_1d(x[..., :half], r, base),
                      _rope_1d(x[..., half:], c, base)], dim=-1)


def encoder(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
            ) -> List[torch.Tensor]:
    """Normalised NCHW views of one scene -> the taken layers' joined
    features, (B, 1 + ph*pw, 2 x width) each."""
    d, heads, p = (cfg["hidden_size"], cfg["num_attention_heads"],
                   cfg["patch_size"])
    hd = d // heads
    b, _, h, wd = x.shape
    ph, pw = h // p, wd // p
    alt, qkn, rs = cfg["alt_start"], cfg["qknorm_start"], cfg["rope_start"]
    t = _conv(x, w, "encoder.patch_embed", stride=p)
    t = t.flatten(2).transpose(1, 2)
    pos = w["encoder.pos_embed"]
    g = cfg["pos_embed_grid"]
    if (ph, pw) != (g, g):
        grid = pos[:, 1:].reshape(1, g, g, d).permute(0, 3, 1, 2)
        grid = F.interpolate(grid, size=(ph, pw), mode="bicubic",
                             align_corners=False)
        pos = torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], 1)
    t = torch.cat([w["encoder.cls_token"].expand(b, -1, -1), t], 1) + pos
    n = t.shape[1]
    taken, local = {}, t
    for i in range(cfg["num_hidden_layers"]):
        k = f"encoder.block_{i}."
        if i == alt:
            cam = w["encoder.camera_token"]
            cams = torch.cat([cam[:, :1], cam[:, 1:].expand(b - 1, -1, -1)])
            t = torch.cat([cams, t[:, 1:]], 1)
        cross = 0 <= alt <= i and i % 2 == 1
        y = _ln(t, w, k + "norm1")
        qkv = _lin(y, w, k + "attn.qkv").reshape(b, n, 3, heads, hd)
        q, kk, v = qkv.permute(2, 0, 3, 1, 4)              # (B, H, S, hd)
        if 0 <= qkn <= i:
            q = _ln(q, w, k + "attn.qk_prep.q_norm")
            kk = _ln(kk, w, k + "attn.qk_prep.k_norm")
        if 0 <= rs <= i:
            q = rope_2d(q, ph, pw, cfg["rope_freq"])
            kk = rope_2d(kk, ph, pw, cfg["rope_freq"])
        if cross:
            # the views in a row: (1, H, B * S, hd)
            q, kk, v = (z.transpose(0, 1).reshape(1, heads, b * n, hd)
                        for z in (q, kk, v))
            o = attend(q, kk, v).reshape(heads, b, n, hd).transpose(0, 1)
        else:
            o = attend(q, kk, v)
        o = o.transpose(1, 2).reshape(b, n, d)
        t = t + _lin(o, w, k + "attn.proj") * w[k + "ls1"]
        y = _ln(t, w, k + "norm2")
        y = _lin(F.gelu(_lin(y, w, k + "mlp.fc1")), w, k + "mlp.fc2")
        t = t + y * w[k + "ls2"]
        if not cross:
            local = t
        if i in cfg["out_indices"]:
            taken[i] = torch.cat([_ln(local, w, "encoder.norm"),
                                  _ln(t, w, "encoder.norm")], dim=-1)
    return [taken[i] for i in cfg["out_indices"]]


def _branch(feats, w, fusion: str, tail: str, ph: int, pw: int, p: int
            ) -> torch.Tensor:
    f1, f2, f3, f4 = feats
    y = _fusion(f4, w, fusion + "3", size=f3.shape[2:])
    y = _fusion(y, w, fusion + "2", f3, size=f2.shape[2:])
    y = _fusion(y, w, fusion + "1", f2, size=f1.shape[2:])
    y = _fusion(y, w, fusion + "0", f1)
    y = _conv(y, w, tail + "1", padding=1)
    y = _up(y, (ph * p, pw * p), True)
    y = F.relu(_conv(y, w, tail + "2", padding=1))
    return _conv(y, w, tail + "3")


def head(hidden: List[torch.Tensor], w: Dict[str, torch.Tensor], cfg: dict,
         ph: int, pw: int) -> Dict[str, torch.Tensor]:
    feats = []
    for i, hs in enumerate(hidden):
        x = hs[:, 1:].transpose(1, 2).reshape(hs.shape[0], -1, ph, pw)
        x = _conv(x, w, f"head.project_{i}")
        if i == 0:
            x = F.conv_transpose2d(x, w["head.resize_0.weight"],
                                   w["head.resize_0.bias"], stride=4)
        elif i == 1:
            x = F.conv_transpose2d(x, w["head.resize_1.weight"],
                                   w["head.resize_1.bias"], stride=2)
        elif i == 3:
            x = _conv(x, w, "head.resize_3", stride=2, padding=1)
        feats.append(_conv(x, w, f"head.scratch_{i}", padding=1, bias=False))
    p = cfg["patch_size"]
    y = _branch(feats, w, "head.fusion_", "head.head_conv", ph, pw, p)
    r = _branch(feats, w, "head.ray_fusion_", "head.ray_conv", ph, pw, p)
    return {"depth": torch.exp(y[:, 0]), "confidence": 1 + torch.exp(y[:, 1]),
            "rays": r[:, :6].permute(0, 2, 3, 1),
            "ray_confidence": 1 + torch.exp(r[:, 6])}


def outputs(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
            ) -> Dict[str, torch.Tensor]:
    """Normalised NCHW views of one scene -> depth and confidence (B, h,
    w), rays (B, h, w, 6) and their confidence (B, h, w)."""
    p = cfg["patch_size"]
    return head(encoder(x, w, cfg), w, cfg, x.shape[2] // p,
                x.shape[3] // p)


@torch.no_grad()
def reference(frames_u8: torch.Tensor, w: Dict[str, torch.Tensor],
              cfg: dict, model_hw, dtype: torch.dtype = torch.float32
              ) -> tuple:
    """A step's views (B, H, W, 3) uint8 -> (depth (B, h, w) float32,
    colour image (B, h, w, 3)), all views at once, with TF32 off.
    ``dtype`` other than float32 computes the network in that type (a
    control)."""
    wd = {k: v.to(dtype) for k, v in w.items()}
    with exact_float32():
        colour, x = preprocess(frames_u8, model_hw)
        d = outputs(x.to(dtype), wd, cfg)["depth"].to(torch.float32)
    return d, colour
