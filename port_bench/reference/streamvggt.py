"""StreamVGGT, in plain float32 PyTorch: VGGT's forward with causal
attention over frames, without a cache.

Written from the paper (Zhuo et al., *Streaming 4D Visual Geometry
Transformer*, 2025, arXiv:2507.11539; github.com/wzzheng/StreamVGGT) as
recalled, and as this benchmark's configuration states it
(``configs/streamvggt-1b.json``, whose ``assumed`` lists each recalled
detail): VGGT-1B (``reference/vggt.py``, whose front, frame blocks, DPT heads
and preprocessing this file uses as they are) with

- the global blocks causal over frames: a token of frame f attends to every
  token of frames 0 ... f and to none later;
- the camera head's trunk causal over frames in the same way (one token a
  frame);
- frame 0 taking the first of each pair of learned camera / register
  tokens, every later frame the second (VGGT's view 0 and other views).

StreamVGGT runs the causal model frame by frame with a key / value cache;
this computes the whole step's frames at once, so it is what any split of
the frames into chunks through a cache has to give. No kernel, no cache, no
chunks. Causal attention is taken in blocks of query rows that never cross
a frame, each against the keys up to the end of its frame, so no score
outside the mask is computed and no block passes about 2^29 scores (the
last frame of 128 against all 100,096 keys of a step, 16 heads, would be 5
GB in float32 a frame). The heads run on 32 frames at a time (they see one
frame each; 128 frames at once would hold about 30 GB of float32 maps).
``reference`` turns TF32 off for its call.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from port_bench.reference import vggt as base
from port_bench.reference.depth_anything_v2 import (_lin, exact_float32,
                                                    preprocess)

HEAD_FRAMES = 32


def attend_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  frame_tokens: int) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v on (B, H, S, d) where query row r sees
    keys 0 ... (r // frame_tokens + 1) * frame_tokens - 1: in blocks of
    rows of one frame, each against the keys up to its frame's end."""
    b, h, s, d = q.shape
    rows = max(1, min(frame_tokens, base.SCORE_ENTRIES // (b * h * s)))
    out = torch.empty_like(q)
    for f0 in range(0, s, frame_tokens):
        end = min(s, f0 + frame_tokens)
        for i in range(f0, end, rows):
            j = min(end, i + rows)
            att = torch.softmax(q[:, :, i:j] @ k[:, :, :end].transpose(-1, -2)
                                * d ** -0.5, dim=-1)
            out[:, :, i:j] = att @ v[:, :, :end]
    return out


def block(t, w, k, heads, eps, rope=None, frames=None):
    """``reference/vggt.py:block`` with causal attention over frames:
    ``frames`` (B, N, D) frames of N tokens attend as one sequence of B N
    tokens, frame-causally (the global blocks); ``frames`` None, B
    sequences of N tokens, one token a frame (the camera trunk)."""
    b, n, d = t.shape
    hd = d // heads
    y = base._ln(t, w, k + "norm1", eps)
    qkv = _lin(y, w, k + "attn.qkv").reshape(b, n, 3, heads, hd)
    q, kk, v = qkv.permute(2, 0, 3, 1, 4)                  # (B, H, N, hd)
    if rope is not None:
        q = base.rope_2d(base._ln(q, w, k + "attn.qk_prep.q_norm", eps),
                         *rope)
        kk = base.rope_2d(base._ln(kk, w, k + "attn.qk_prep.k_norm", eps),
                          *rope)
    if frames:
        q, kk, v = (z.transpose(0, 1).reshape(1, heads, b * n, hd)
                    for z in (q, kk, v))
        o = attend_causal(q, kk, v, n).reshape(heads, b, n, hd).transpose(
            0, 1)
    else:
        o = attend_causal(q, kk, v, 1)
    o = o.transpose(1, 2).reshape(b, n, d)
    t = t + _lin(o, w, k + "attn.proj") * w[k + "ls1"]
    y = base._ln(t, w, k + "norm2", eps)
    y = _lin(F.gelu(_lin(y, w, k + "mlp.fc1")), w, k + "mlp.fc2")
    return t + y * w[k + "ls2"]


def aggregator(patches: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
               ph: int, pw: int) -> Dict[int, torch.Tensor]:
    """``reference/vggt.py:aggregator`` with causal global blocks."""
    s = patches.shape[0]
    specials = 1 + cfg["num_registers"]
    tok = torch.cat([w["aggregator.camera_token"],
                     w["aggregator.register_token"]], dim=2)[0]
    tok = torch.cat([tok[:1], tok[1:].expand(s - 1, -1, -1)])
    t = torch.cat([tok, patches], 1)
    rope = (ph, pw, specials, cfg["rope_freq"])
    heads = cfg["num_attention_heads"]
    want = set(cfg["out_indices"]) | {cfg["aa_pairs"] - 1}
    out = {}
    for i in range(cfg["aa_pairs"]):
        t = base.block(t, w, f"aggregator.frame_{i}.", heads, base.AGG_EPS,
                       rope)
        local = t
        t = block(t, w, f"aggregator.global_{i}.", heads, base.AGG_EPS,
                  rope, frames=s)
        if i in want:
            out[i] = torch.cat([local, t], dim=-1)
    return out


def camera(joined: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
           ) -> torch.Tensor:
    """``reference/vggt.py:camera`` with a causal trunk."""
    k = "camera_head."
    t = base._ln(joined[:, 0], w, k + "token_norm", base.AGG_EPS)[None]
    pred = None
    for _ in range(cfg["camera_iterations"]):
        src = (w[k + "empty_pose_tokens"].expand(1, t.shape[1], -1)
               if pred is None else pred)
        m = _lin(F.silu(_lin(src, w, k + "embed_pose")), w,
                 k + "modulation")
        shift, scale, gate = m.chunk(3, dim=-1)
        normed = F.layer_norm(t, (t.shape[-1],), eps=1e-6)
        x = gate * (normed * (1 + scale) + shift) + t
        for i in range(cfg["camera_layers"]):
            x = block(x, w, f"{k}block_{i}.", cfg["num_attention_heads"],
                      base.AGG_EPS)
        x = base._ln(x, w, k + "trunk_norm", base.AGG_EPS)
        delta = _lin(F.gelu(_lin(x, w, k + "pose_branch.fc1")), w,
                     k + "pose_branch.fc2")
        pred = delta if pred is None else pred + delta
    return torch.cat([pred[0, :, :7], F.relu(pred[0, :, 7:])], dim=-1)


def outputs(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
            ) -> Dict[str, torch.Tensor]:
    """Normalised NCHW frames of one stream, in order -> depth,
    depth_confidence (S, h, w), points (S, h, w, 3), points_confidence
    (S, h, w) and pose_encoding (S, 9)."""
    p = cfg["patch_size"]
    ph, pw = x.shape[2] // p, x.shape[3] // p
    joined = aggregator(base.front(x, w, cfg), w, cfg, ph, pw)
    feats = [joined[i] for i in cfg["out_indices"]]
    d, pts = [], []
    for i in range(0, x.shape[0], HEAD_FRAMES):
        part = [f[i:i + HEAD_FRAMES] for f in feats]
        d.append(base.dpt(part, w, cfg, "depth_head.", ph, pw))
        pts.append(base.dpt(part, w, cfg, "point_head.", ph, pw))
    d, pts = torch.cat(d), torch.cat(pts)
    xyz = pts[:, :3].permute(0, 2, 3, 1)
    return {"depth": torch.exp(d[:, 0]),
            "depth_confidence": 1 + torch.exp(d[:, 1]),
            "points": torch.sign(xyz) * torch.expm1(xyz.abs()),
            "points_confidence": 1 + torch.exp(pts[:, 3]),
            "pose_encoding": camera(joined[cfg["aa_pairs"] - 1], w, cfg)}


@torch.no_grad()
def reference(frames_u8: torch.Tensor, w: Dict[str, torch.Tensor],
              cfg: dict, model_hw, dtype: torch.dtype = torch.float32
              ) -> tuple:
    """A step's frames (S, H, W, 3) uint8, one stream in order -> (depth
    (S, h, w) float32, colour image (S, h, w, 3)), all frames at once, with
    TF32 off. ``dtype`` other than float32 computes the network in that
    type (a control)."""
    wd = {k: v.to(dtype) for k, v in w.items()}
    with exact_float32():
        colour, x = preprocess(frames_u8, model_hw)
        d = outputs(x.to(dtype), wd, cfg)["depth"].to(torch.float32)
    return d, colour
