"""VGGT (VGGT-1B), in plain float32 PyTorch.

Written from the published code (github.com/facebookresearch/vggt:
``vggt/models/vggt.py``, ``vggt/models/aggregator.py``,
``vggt/layers/{block,attention,rope,vision_transformer}.py``,
``vggt/heads/{dpt_head,camera_head,head_act,utils}.py``; arXiv:2503.11651)
as recalled, and as this benchmark's configuration states it
(``configs/vggt-1b.json``, whose ``assumed`` lists each recalled detail):

- preprocess as Depth Anything V2 (``reference/depth_anything_v2.py``):
  bicubic resize of the whole frame to the model grid (VGGT's "crop"
  preprocessing gives 294 x 518 for 1080 x 1920 without cropping), then
  the ImageNet mean and std (VGGT's ``_RESNET_MEAN`` / ``_RESNET_STD``);
- the front, DINOv2 ViT-L/14 with registers (``dinov2_vitl14_reg``): patch
  conv, cls token, the position embedding resized bicubically with
  antialiasing by size and added, then 4 register tokens after the cls
  token; pre-norm blocks (LayerNorm eps 1e-6, LayerScale, exact GELU); the
  final LayerNorm; the patch tokens (``x_norm_patchtokens``);
- the aggregator: per view a camera token and 4 register tokens (the first
  of each pair of learned tokens for view 0, the second for the others)
  before the patches; 24 pairs of blocks (LayerNorm eps 1e-5, LayerScale,
  QK-norm with eps 1e-5, 2-D RoPE of base 100 with the 5 special tokens at
  (0, 0) and patch (r, c) at (r + 1, c + 1)): the first attends within
  each view, the second over all tokens of all views; each pair's output
  is the frame block's and the global block's outputs joined (2048);
- two DPT heads (depth: 2 channels, exp and 1 + exp; points: 4, the
  inverse log transform sign(y) (exp|y| - 1) and 1 + exp) on pairs 4, 11,
  17, 23: each drops the special tokens, applies its own LayerNorm (eps
  1e-5), projects, adds the UV sine-cosine position embedding (x 0.1),
  resizes, then the scratch convs and the fusion blocks, whose residual
  units add their branch to relu(x) (``nn.ReLU(inplace=True)`` rectifies
  the unit's input in place), conv 3 x 3, bilinear upsample to the model
  grid, the position embedding again, conv 3 x 3, ReLU, conv 1 x 1;
- the camera head on the camera token of pair 23: LayerNorm, then 4
  iterations of adaLN modulation (``gate * (norm(x) (1 + scale) +
  shift) + x`` from SiLU and a linear layer of the embedded current
  estimate, the first from a learned empty pose), a trunk of 4 blocks 2048
  wide (16 heads of 128, LayerNorm eps 1e-5), LayerNorm and an MLP to 9
  numbers added to the estimate; the last estimate, field of view through
  ReLU, is the pose encoding.

Departures from the published code: it runs the heads in float32 with
autocast off and the aggregator under bfloat16 autocast; this runs every
part in the one dtype it is given. It processes the heads 8 frames at a
time; this takes all views at once (the same values). Its position
embedding's grid is made in the activation's dtype; here in float64 and
rounded once. The track head runs only with query points and is left out.

No kernel, no cache, no batching beyond the step's views. Attention is
taken in blocks of query rows, so that no score matrix passes about 2^29
entries (a whole global one at 32 views of 782 tokens and 16 heads would be
40 GB in float32). ``reference`` turns TF32 off for its call.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from port_bench.reference.depth_anything_v2 import (_conv, _lin, _up,
                                                    exact_float32,
                                                    preprocess)

SCORE_ENTRIES = 1 << 29
POS_SCALE = 0.1
FRONT_EPS, AGG_EPS = 1e-6, 1e-5


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


def _ln(x, w, p, eps):
    return F.layer_norm(x, (x.shape[-1],), w[p + ".weight"], w[p + ".bias"],
                        eps=eps)


def _rope_1d(x: torch.Tensor, pos: torch.Tensor, base: float
             ) -> torch.Tensor:
    """VGGT's 1-D RoPE of x (..., S, n) at integer positions pos (S,):
    frequencies base^(-2j / n), the angle table joined to itself, x cos +
    rotate_half(x) sin."""
    n = x.shape[-1]
    inv = 1.0 / base ** (torch.arange(0, n, 2, device=x.device,
                                      dtype=torch.float32) / n)
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    x1, x2 = x[..., :n // 2], x[..., n // 2:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return x * ang.cos().to(x.dtype) + rotated * ang.sin().to(x.dtype)


def rope_2d(x: torch.Tensor, ph: int, pw: int, specials: int, base: float
            ) -> torch.Tensor:
    """VGGT's 2-D RoPE of x (B, H, specials + ph*pw, d): rows on the first
    half of d, columns on the second; the special tokens at (0, 0), patches
    at (row, col) + 1."""
    dev = x.device
    r = torch.arange(ph, device=dev).repeat_interleave(pw) + 1
    c = torch.arange(pw, device=dev).repeat(ph) + 1
    zero = torch.zeros(specials, dtype=r.dtype, device=dev)
    r, c = torch.cat([zero, r]), torch.cat([zero, c])
    half = x.shape[-1] // 2
    return torch.cat([_rope_1d(x[..., :half], r, base),
                      _rope_1d(x[..., half:], c, base)], dim=-1)


def block(t, w, k, heads, eps, rope=None, views=None):
    """A pre-norm block on (B, N, D). ``rope``: (ph, pw, specials, base)
    for QK-norm and RoPE; ``views``: attend over all (views x N) tokens as
    one sequence (B = views)."""
    b, n, d = t.shape
    hd = d // heads
    y = _ln(t, w, k + "norm1", eps)
    qkv = _lin(y, w, k + "attn.qkv").reshape(b, n, 3, heads, hd)
    q, kk, v = qkv.permute(2, 0, 3, 1, 4)                  # (B, H, N, hd)
    if rope is not None:
        q = rope_2d(_ln(q, w, k + "attn.qk_prep.q_norm", eps), *rope)
        kk = rope_2d(_ln(kk, w, k + "attn.qk_prep.k_norm", eps), *rope)
    if views:
        q, kk, v = (z.transpose(0, 1).reshape(1, heads, b * n, hd)
                    for z in (q, kk, v))
        o = attend(q, kk, v).reshape(heads, b, n, hd).transpose(0, 1)
    else:
        o = attend(q, kk, v)
    o = o.transpose(1, 2).reshape(b, n, d)
    t = t + _lin(o, w, k + "attn.proj") * w[k + "ls1"]
    y = _ln(t, w, k + "norm2", eps)
    y = _lin(F.gelu(_lin(y, w, k + "mlp.fc1")), w, k + "mlp.fc2")
    return t + y * w[k + "ls2"]


def front(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
          ) -> torch.Tensor:
    """Normalised NCHW views -> the front's patch tokens (S, ph*pw, D)."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    s, _, h, wd = x.shape
    ph, pw = h // p, wd // p
    t = _conv(x, w, "front.patch_embed", stride=p).flatten(2).transpose(1, 2)
    pos = w["front.pos_embed"]
    g = cfg["pos_embed_grid"]
    if (ph, pw) != (g, g):
        grid = pos[:, 1:].reshape(1, g, g, d).permute(0, 3, 1, 2)
        grid = F.interpolate(grid.float(), size=(ph, pw), mode="bicubic",
                             align_corners=False, antialias=True)
        grid = grid.to(pos.dtype)
        pos = torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], 1)
    t = torch.cat([w["front.cls_token"].expand(s, -1, -1), t], 1) + pos
    reg = w["front.register_tokens"].expand(s, -1, -1)
    t = torch.cat([t[:, :1], reg, t[:, 1:]], 1)
    for i in range(cfg["front_layers"]):
        t = block(t, w, f"front.block_{i}.", cfg["num_attention_heads"],
                  FRONT_EPS)
    t = _ln(t, w, "front.norm", FRONT_EPS)
    return t[:, 1 + cfg["num_registers"]:]


def aggregator(patches: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict,
               ph: int, pw: int) -> Dict[int, torch.Tensor]:
    """(S, P, D) patch tokens -> {pair: (S, 5 + P, 2 D)} for the pairs the
    heads read."""
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
        t = block(t, w, f"aggregator.frame_{i}.", heads, AGG_EPS, rope)
        local = t
        t = block(t, w, f"aggregator.global_{i}.", heads, AGG_EPS, rope,
                  views=s)
        if i in want:
            out[i] = torch.cat([local, t], dim=-1)
    return out


def uv_embed(h: int, w: int, channels: int, aspect: float, dtype, device
             ) -> torch.Tensor:
    """VGGT's ``create_uv_grid`` + ``position_grid_to_embed`` (omega_0
    100) times 0.1: (1, channels, h, w)."""
    diag = (aspect ** 2 + 1.0) ** 0.5
    sx, sy = aspect / diag, 1.0 / diag
    xs = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w,
                        dtype=torch.float64, device=device)
    ys = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h,
                        dtype=torch.float64, device=device)
    uu, vv = torch.meshgrid(xs, ys, indexing="xy")          # (h, w) each

    def sincos(pos, dim):
        omega = torch.arange(dim // 2, dtype=torch.float64, device=device)
        omega = 1.0 / 100.0 ** (omega / (dim / 2.0))
        out = pos.reshape(-1)[:, None] * omega[None]
        return torch.cat([out.sin(), out.cos()], dim=1)

    emb = torch.cat([sincos(uu, channels // 2), sincos(vv, channels // 2)],
                    dim=-1).reshape(h, w, channels)
    return (emb * POS_SCALE).permute(2, 0, 1)[None].to(dtype)


def _rcu(x, w, p):
    r = F.relu(x)
    h = _conv(r, w, p + ".conv1", padding=1)
    return r + _conv(F.relu(h), w, p + ".conv2", padding=1)


def _fusion(x, w, p, residual=None, size=None):
    if residual is not None:
        x = x + _rcu(residual, w, p + ".rcu1")
    x = _rcu(x, w, p + ".rcu2")
    if size is None:
        size = (x.shape[2] * 2, x.shape[3] * 2)
    return _conv(_up(x, size, True), w, p + ".project")


def dpt(feats: List[torch.Tensor], w: Dict[str, torch.Tensor], cfg: dict,
        prefix: str, ph: int, pw: int) -> torch.Tensor:
    """One DPT head on the taken pairs' joined tokens -> its raw output
    (S, channels, h, w)."""
    p = cfg["patch_size"]
    specials = 1 + cfg["num_registers"]
    aspect = pw / ph
    maps = []
    for i, hs in enumerate(feats):
        x = _ln(hs[:, specials:], w, prefix + "norm", AGG_EPS)
        x = x.transpose(1, 2).reshape(hs.shape[0], -1, ph, pw)
        x = _conv(x, w, f"{prefix}project_{i}")
        x = x + uv_embed(ph, pw, x.shape[1], aspect, x.dtype, x.device)
        if i == 0:
            x = F.conv_transpose2d(x, w[prefix + "resize_0.weight"],
                                   w[prefix + "resize_0.bias"], stride=4)
        elif i == 1:
            x = F.conv_transpose2d(x, w[prefix + "resize_1.weight"],
                                   w[prefix + "resize_1.bias"], stride=2)
        elif i == 3:
            x = _conv(x, w, prefix + "resize_3", stride=2, padding=1)
        maps.append(_conv(x, w, f"{prefix}scratch_{i}", padding=1,
                          bias=False))
    f1, f2, f3, f4 = maps
    y = _fusion(f4, w, prefix + "fusion_3", size=f3.shape[2:])
    y = _fusion(y, w, prefix + "fusion_2", f3, size=f2.shape[2:])
    y = _fusion(y, w, prefix + "fusion_1", f2, size=f1.shape[2:])
    y = _fusion(y, w, prefix + "fusion_0", f1)
    y = _conv(y, w, prefix + "head_conv1", padding=1)
    y = _up(y, (ph * p, pw * p), True)
    y = y + uv_embed(ph * p, pw * p, y.shape[1], aspect, y.dtype, y.device)
    y = F.relu(_conv(y, w, prefix + "head_conv2", padding=1))
    return _conv(y, w, prefix + "head_conv3")


def camera(joined: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
           ) -> torch.Tensor:
    """The camera head on the last pair's joined tokens -> the pose
    encoding (S, 9) of its last iteration."""
    k = "camera_head."
    t = _ln(joined[:, 0], w, k + "token_norm", AGG_EPS)[None]   # (1, S, C)
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
                      AGG_EPS)
        x = _ln(x, w, k + "trunk_norm", AGG_EPS)
        delta = _lin(F.gelu(_lin(x, w, k + "pose_branch.fc1")), w,
                     k + "pose_branch.fc2")
        pred = delta if pred is None else pred + delta
    return torch.cat([pred[0, :, :7], F.relu(pred[0, :, 7:])], dim=-1)


def outputs(x: torch.Tensor, w: Dict[str, torch.Tensor], cfg: dict
            ) -> Dict[str, torch.Tensor]:
    """Normalised NCHW views of one scene -> depth, depth_confidence (S,
    h, w), points (S, h, w, 3), points_confidence (S, h, w) and
    pose_encoding (S, 9)."""
    p = cfg["patch_size"]
    ph, pw = x.shape[2] // p, x.shape[3] // p
    joined = aggregator(front(x, w, cfg), w, cfg, ph, pw)
    feats = [joined[i] for i in cfg["out_indices"]]
    d = dpt(feats, w, cfg, "depth_head.", ph, pw)
    pts = dpt(feats, w, cfg, "point_head.", ph, pw)
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
    """A step's views (S, H, W, 3) uint8 -> (depth (S, h, w) float32,
    colour image (S, h, w, 3)), all views at once, with TF32 off.
    ``dtype`` other than float32 computes the network in that type (a
    control)."""
    wd = {k: v.to(dtype) for k, v in w.items()}
    with exact_float32():
        colour, x = preprocess(frames_u8, model_hw)
        d = outputs(x.to(dtype), wd, cfg)["depth"].to(torch.float32)
    return d, colour
