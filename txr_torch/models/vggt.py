"""VGGT, the Visual Geometry Grounded Transformer (Wang et al., CVPR 2025,
arXiv:2503.11651; github.com/facebookresearch/vggt, ``vggt/models/
{vggt,aggregator}.py``, ``vggt/heads/{dpt_head,camera_head}.py``), on the
port's modules. Not in ``txr``.

A call takes the views of one scene, a step's frames (S, h, w, 3),
normalised, and gives each view's depth (S, h, w); the other outputs of
the call are on ``VGGT.outputs``. Its parts:

- the front: every view through a DINOv2 ViT-L/14 with 4 registers
  (``ViTEncoder`` with ``num_registers`` and DINOv2-reg's antialiased
  position-embedding resize), its patch tokens after the final norm;
- the aggregator (``Aggregator``): a camera token and 4 register tokens
  before each view's patches (one set for view 0, one shared by the
  others), then pairs of the shared ``Block``: the first attends within
  each view, the second across every token of every view of the step (the
  (S, P, 3D) projection viewed as (1, S*P, 3D), as Depth Anything 3's
  cross-view layers); each with QK-norm and 2-D RoPE (``QKPrep``: the
  ``qk_prep`` kernel on the card) whose five special tokens sit at (0, 0),
  and LayerNorms of eps 1e-5. A pair hands on its two outputs joined (2 D
  channels);
- the depth and point heads (``VGGTHead``, VGGT's DPT: a ``DPTHead``
  with a LayerNorm of its own over the joined tokens, VGGT's UV
  sine-cosine position embedding after each projection and before the
  tail's conv2, residual units that add relu(x), exp / inv_log outputs),
  on the joined outputs of the taken pairs, each tail through the tail
  kernel with the embedding folded through conv2 into its position term;
- the camera head (``CameraHead``): view tokens of the last pair through a
  trunk of the shared ``Block`` 2 D wide, refined over a few iterations
  with adaLN modulation, to VGGT's 9-number pose encoding (translation,
  quaternion, field of view). Its attention, over the S view tokens with
  heads of 128, is the plain version (``use_flash=False``): the kernels
  take heads of 64.

``outputs`` holds ``depth`` and ``depth_confidence`` (S, h, w), ``points``
(S, h, w, 3) and ``points_confidence`` (S, h, w), and ``pose_encoding``
(S, 9), all float32. VGGT's track head runs only when query points are
given, and is not here.

StreamVGGT (Zhuo et al., 2025, arXiv:2507.11539; github.com/wzzheng/
StreamVGGT) is VGGT with causal global attention: a frame's tokens attend
to their own frame's and every earlier frame's, and at inference each
global layer keeps the keys and values of the frames seen so far. The RoPE
has no time term, so a cached key is never rotated again, and feeding
frames in chunks through the cache gives what a frame-causal forward of all
of them gives. ``StreamVGGT`` (``StreamVGGTConfig``: ``cache_frames``, the
capacity, and ``stream_chunk_frames``) holds a ``StreamState``: one K/V
slab per global layer, allocated once for ``cache_frames`` frames, the
count of frames held and the last pair's camera tokens of those frames.
``step`` runs one chunk: the front and the frame blocks as VGGT's, the
global blocks through the cache (``models/vit.py:KVSlot``; on the card the
attention kernel's cached entry point), the heads on the chunk's frames,
and the camera head, causal over frames, recomputed over every frame held
(at most ``cache_frames`` tokens). The first frame of a stream takes view
0's camera and register tokens, every later frame the other set.
``reset`` empties the state; the module's call on a submap resets it and
steps through the submap in chunks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from txr_torch.core.derived import Derived
from txr_torch.models.dpt import DPTConfig, DPTHead, _bilinear
from txr_torch.models.vit import Block, KVSlot, Mlp, ViTConfig, ViTEncoder
from txr_torch.ops.dpt_tail import position_term
from txr_torch.ops.qk_prep import rope_tables
from txr_torch.utils.profiling import count, span

# VGGT's pose encoding "absT_quaR_FoV": translation (3), quaternion (4),
# field of view (2)
POSE_DIM = 9
# channels of the depth and point heads' outputs
HEAD_CHANNELS = {"depth": 2, "points": 4}
# the heads' LayerNorm eps (nn.LayerNorm's default) and the scale of their
# position embedding
HEAD_NORM_EPS, POS_SCALE = 1e-5, 0.1


@dataclass(frozen=True)
class VGGTConfig:
    hidden_size: int = 1024
    num_heads: int = 16
    mlp_ratio: float = 4.0
    patch_size: int = 14
    front_layers: int = 24             # DINOv2 ViT-L/14 with registers
    num_registers: int = 4
    pos_embed_size: int = 37           # the front's native grid (518 / 14)
    pairs: int = 24                    # frame / global attention pairs
    rope_base: float = 100.0
    out_layers: Tuple[int, ...] = (4, 11, 17, 23)   # pairs the heads read
    features: int = 256
    out_channels: Tuple[int, ...] = (256, 512, 1024, 1024)
    head_hidden: int = 32
    camera_layers: int = 4
    camera_iterations: int = 4
    # the int8 policy of the front's and the aggregator's dense layers
    quant: str = "none"
    # the heads' tails through the tail kernel (None / True) or as
    # separate ops (False)
    fused_head: Optional[bool] = None

    @property
    def special_tokens(self) -> int:
        """The camera token and the registers before each view's
        patches."""
        return 1 + self.num_registers

    def front(self) -> ViTConfig:
        return ViTConfig(hidden_size=self.hidden_size,
                         num_layers=self.front_layers,
                         num_heads=self.num_heads,
                         patch_size=self.patch_size,
                         mlp_ratio=self.mlp_ratio,
                         pos_embed_size=self.pos_embed_size,
                         out_layers=(self.front_layers - 1,),
                         quant=self.quant,
                         num_registers=self.num_registers,
                         pos_embed_antialias=True)

    def aggregator(self) -> ViTConfig:
        """Block 2 i of this configuration is pair i's within-view block,
        block 2 i + 1 its cross-view one: the any-view layout from layer
        0 (``ViTConfig.crossview``)."""
        return ViTConfig(hidden_size=self.hidden_size,
                         num_layers=2 * self.pairs,
                         num_heads=self.num_heads,
                         patch_size=self.patch_size,
                         mlp_ratio=self.mlp_ratio, quant=self.quant,
                         anyview_start=0, norm_eps=1e-5)

    def camera(self) -> ViTConfig:
        return ViTConfig(hidden_size=2 * self.hidden_size,
                         num_layers=self.camera_layers,
                         num_heads=self.num_heads,
                         mlp_ratio=self.mlp_ratio, norm_eps=1e-5,
                         use_flash=False)

    def dpt(self) -> DPTConfig:
        return DPTConfig(features=self.features,
                         out_channels=tuple(self.out_channels),
                         head_hidden=self.head_hidden,
                         fused_head=self.fused_head,
                         special_tokens=self.special_tokens,
                         relu_skip=True)


@dataclass(frozen=True)
class StreamVGGTConfig(VGGTConfig):
    stream_chunk_frames: int = 32      # keyframes one update takes
    cache_frames: int = 128            # the submap: the cache's capacity


class StreamState:
    """A stream's state: per global layer a slab of ``capacity`` frames'
    rows, each 2 D wide (k of every head, then v, after QK-norm and RoPE),
    and ``camera``, the last pair's joined camera token of each frame held
    (the camera head's input), all allocated once for a frame size, dtype
    and device and kept while those stay; ``frames`` held. ``reset``
    empties it without freeing."""

    def __init__(self, layers: int, capacity: int, width: int):
        self.layers, self.capacity, self.width = layers, capacity, width
        self.slabs: List[torch.Tensor] = []
        self.camera: Optional[torch.Tensor] = None
        self.frame_tokens = 0
        self.frames = 0

    def reset(self) -> None:
        self.frames = 0

    def reserve(self, frames: int, frame_tokens: int, dtype, device
                ) -> None:
        """Room for ``frames`` more frames of ``frame_tokens`` tokens:
        raises past the capacity or for another frame size mid-stream."""
        if self.frames + frames > self.capacity:
            raise ValueError(f"the stream holds {self.frames} of "
                             f"{self.capacity} frames; {frames} more do not "
                             f"fit: reset() first")
        if self.frames and frame_tokens != self.frame_tokens:
            raise ValueError(f"a stream of {self.frame_tokens}-token frames "
                             f"got frames of {frame_tokens}")
        have = self.slabs[0] if self.slabs else None
        if (have is None or frame_tokens != self.frame_tokens
                or have.dtype != dtype or have.device != device):
            self.slabs, self.camera = [], None       # freed before the new
            rows = self.capacity * frame_tokens
            self.slabs = [torch.empty((rows, self.width), dtype=dtype,
                                      device=device)
                          for _ in range(self.layers)]
            self.camera = torch.empty((self.capacity, self.width),
                                      dtype=dtype, device=device)
            self.frame_tokens = frame_tokens

    def slot(self, layer: int) -> KVSlot:
        return KVSlot(self.slabs[layer], self.frames * self.frame_tokens)


def uv_pos_embed(h: int, w: int, channels: int, aspect: float, dtype,
                 device) -> torch.Tensor:
    """VGGT's position embedding of an (h, w) map (``heads/utils.py``:
    ``create_uv_grid`` and ``position_grid_to_embed``, ``omega_0`` 100)
    times 0.1, as (1, channels, h, w) in channels_last memory: u and v
    span the image's diagonal-normalised extent at pixel centres (``aspect``
    = width / height of the image); the first half of the channels is u's
    sines then cosines, the second v's, at frequencies 100^(-k / q) for
    the q = channels / 4 values of k. Computed in float64 and rounded once
    to ``dtype``."""
    f64 = torch.float64
    diag = math.sqrt(aspect * aspect + 1.0)
    sx, sy = aspect / diag, 1.0 / diag
    u = torch.linspace(-sx * (w - 1) / w, sx * (w - 1) / w, w, dtype=f64,
                       device=device)
    v = torch.linspace(-sy * (h - 1) / h, sy * (h - 1) / h, h, dtype=f64,
                       device=device)
    q = channels // 4
    omega = 100.0 ** -(torch.arange(q, dtype=f64, device=device) / q)
    eu, ev = u[:, None] * omega, v[:, None] * omega
    eu = torch.cat([eu.sin(), eu.cos()], dim=1)                   # (w, 2q)
    ev = torch.cat([ev.sin(), ev.cos()], dim=1)                   # (h, 2q)
    emb = torch.cat([eu[None].expand(h, w, 2 * q),
                     ev[:, None].expand(h, w, 2 * q)], dim=-1)
    emb = (POS_SCALE * emb).permute(2, 0, 1)[None].to(dtype)
    return emb.contiguous(memory_format=torch.channels_last)


def _conv2_term(weight: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The tail kernel's position term of conv2 (OIHW ``weight``) at an
    (h, w) map: ``position_term`` of the embedding of its input
    channels."""
    pe = uv_pos_embed(h, w, weight.shape[1], w / h, torch.float32,
                      weight.device)
    return position_term(pe[0].permute(1, 2, 0), weight.permute(2, 3, 1, 0))


class VGGTHead(DPTHead):
    """VGGT's DPT head (``heads/dpt_head.py``): ``kind`` "depth" gives
    depth exp(y0) and its confidence 1 + exp(y1), "points" world points
    sign(y) (exp|y| - 1) and their confidence 1 + exp(y3), as a dict in
    float32. It normalises the joined tokens with a LayerNorm of its own
    and adds ``uv_pos_embed`` after each projection and to the upsampled
    activation before conv2; the tail kernel adds that embedding through
    conv2 as its position term. The embeddings depend on the grid alone
    and are kept per grid and width; the term is kept per grid and
    conv2's parameter state. Each lookup counts
    ``models.head_pos_embed_hits`` or ``models.head_pos_embed_misses``."""

    def __init__(self, cfg: DPTConfig, hidden_size: int, kind: str):
        super().__init__(cfg, hidden_size)
        self.kind = kind
        self.span_name = ("models.head.points" if kind == "points"
                          else "models.head")
        self.head_conv3 = nn.Conv2d(cfg.head_hidden, HEAD_CHANNELS[kind], 1)
        self.norm = nn.LayerNorm(hidden_size, eps=HEAD_NORM_EPS)
        # (h, w, channels, dtype, device) -> the embedding; a head sees
        # one grid a resolution
        self._embeds: Dict[tuple, torch.Tensor] = {}
        self._pos_term = Derived(_conv2_term)

    def _embed(self, x: torch.Tensor) -> torch.Tensor:
        """``uv_pos_embed`` of the map ``x`` (B, C, h, w), in its dtype and
        on its device, kept."""
        _, c, h, w = x.shape
        key = (h, w, c, x.dtype, x.device)
        pe = self._embeds.get(key)
        count("models.head_pos_embed_misses" if pe is None
              else "models.head_pos_embed_hits", 1)
        if pe is None:
            pe = self._embeds[key] = uv_pos_embed(h, w, c, w / h, x.dtype,
                                                  x.device)
        return pe

    def _project(self, i: int, x: torch.Tensor, ph: int,
                 pw: int) -> torch.Tensor:
        x = super()._project(i, self.norm(x), ph, pw)
        return x + self._embed(x)

    def _tail(self, y, prefix: str, out_h: int, out_w: int):
        """The unfused tail: conv1, upsample, the embedding, conv2, ReLU,
        conv3."""
        conv1, conv2, conv3 = (getattr(self, f"{prefix}{i}")
                               for i in (1, 2, 3))
        y = _bilinear(conv1(y), (out_h, out_w), align_corners=True)
        y = F.relu(conv2(y + self._embed(y)))
        return conv3(y)

    def tail_position_term(self, prefix: str, out_h: int, out_w: int
                           ) -> torch.Tensor:
        conv2 = getattr(self, f"{prefix}2")
        if torch.is_grad_enabled() and conv2.weight.requires_grad:
            # not kept, so that autograd reaches conv2 through the term
            return _conv2_term(conv2.weight, out_h, out_w)
        term = self._pos_term.get(conv2.weight, out_h, out_w)
        count("models.head_pos_embed_misses" if self._pos_term.computed
              else "models.head_pos_embed_hits", 1)
        return term

    def _outputs(self, feats, out_h: int, out_w: int) -> dict:
        y = self._branch(feats, "fusion_", "head_conv", out_h, out_w)
        if self.kind == "depth":
            return {"depth": y[..., 0].exp(),
                    "depth_confidence": 1 + y[..., 1].exp()}
        p = y[..., :3]
        return {"points": p.sign() * p.abs().expm1(),
                "points_confidence": 1 + y[..., 3].exp()}


class Aggregator(nn.Module):
    """VGGT's alternating attention over the views' patch tokens."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        a = cfg.aggregator()
        d = cfg.hidden_size
        # (1, 2, n, d): view 0's tokens, then those of every other view
        self.camera_token = nn.Parameter(torch.zeros(1, 2, 1, d))
        self.register_token = nn.Parameter(
            torch.zeros(1, 2, cfg.num_registers, d))
        for i in range(cfg.pairs):
            self.add_module(f"frame_{i}", Block(a, 2 * i))
            self.add_module(f"global_{i}", Block(a, 2 * i + 1))

    def _specials(self, views: int, dtype, first: bool = True
                  ) -> torch.Tensor:
        """(views, 1 + registers, d): the camera and register tokens, view
        0's first where ``first``, the others' on every view else."""
        t = torch.cat([self.camera_token, self.register_token], dim=2)[0]
        if not first:
            return t[1:].expand(views, -1, -1).to(dtype)
        return torch.cat([t[:1], t[1:].expand(views - 1, -1, -1)]).to(dtype)

    def forward(self, patches: torch.Tensor, ph: int, pw: int,
                stream: Optional[StreamState] = None
                ) -> Dict[int, torch.Tensor]:
        """(S, ph*pw, d) patch tokens -> {pair: (S, 5 + ph*pw, 2 d)}, the
        joined within-view and cross-view outputs of the pairs the heads
        read (the taken ones and the last). With ``stream`` (room reserved
        for the S frames) the global blocks attend through its cache,
        frame-causally, after the frames it holds."""
        with span("models.aggregator", patches):
            c = self.cfg
            s = patches.shape[0]
            first = stream is None or stream.frames == 0
            x = torch.cat([self._specials(s, patches.dtype, first), patches],
                          dim=1)
            rope = rope_tables(ph, pw, c.hidden_size // c.num_heads,
                               c.rope_base, x.device, c.special_tokens)
            want = set(c.out_layers) | {c.pairs - 1}
            out = {}
            for i in range(c.pairs):
                x = getattr(self, f"frame_{i}")(x, rope)
                local = x
                x = getattr(self, f"global_{i}")(
                    x, rope, cache=None if stream is None
                    else stream.slot(i))
                if i in want:
                    out[i] = torch.cat([local, x], dim=-1)
            return out


class CameraHead(nn.Module):
    """VGGT's camera head: each view's camera token of the last pair,
    normed, then ``camera_iterations`` rounds of adaLN modulation by the
    current pose estimate, the trunk and the pose branch, each adding its
    delta to the estimate. Returns the activated encoding of every round
    (translation and quaternion linear, field of view ReLU), (S, 9) float32
    each."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.camera()
        d = c.hidden_size
        for i in range(c.num_layers):
            self.add_module(f"block_{i}", Block(c))
        self.token_norm = nn.LayerNorm(d, eps=c.norm_eps)
        self.trunk_norm = nn.LayerNorm(d, eps=c.norm_eps)
        self.empty_pose_tokens = nn.Parameter(torch.zeros(1, 1, POSE_DIM))
        self.embed_pose = nn.Linear(POSE_DIM, d)
        self.modulation = nn.Linear(d, 3 * d)
        self.adaln_norm = nn.LayerNorm(d, eps=1e-6, elementwise_affine=False)
        self.pose_branch = Mlp(d, d // 2, POSE_DIM)

    def forward(self, joined: torch.Tensor, causal: bool = False
                ) -> List[torch.Tensor]:
        """``causal``: each view's token attends in the trunk to its own
        and the earlier views' tokens only (StreamVGGT)."""
        with span("models.camera_head", joined):
            t = self.token_norm(joined[:, 0])[None]          # (1, S, 2 d)
            dt = t.dtype
            pred = None                                      # float32
            out = []
            for _ in range(self.cfg.camera_iterations):
                src = (self.empty_pose_tokens.expand(1, t.shape[1], -1)
                       if pred is None else pred.to(dt))
                shift, scale, gate = self.modulation(
                    F.silu(self.embed_pose(src))).chunk(3, dim=-1)
                x = gate * (self.adaln_norm(t) * (1 + scale) + shift) + t
                for i in range(self.cfg.camera_layers):
                    x = getattr(self, f"block_{i}")(
                        x, frame_tokens=1 if causal else None)
                delta = self.pose_branch(self.trunk_norm(x)).float()
                pred = delta if pred is None else pred + delta
                out.append(torch.cat([pred[0, :, :7], F.relu(pred[0, :, 7:])],
                                     dim=-1))
            return out


class VGGT(nn.Module):
    """The front, the aggregator, the depth, point and camera heads. The
    call maps a step's normalised views (S, h, w, 3) to depth (S, h, w);
    every output of the latest call is in ``outputs``."""

    def __init__(self, cfg: VGGTConfig):
        super().__init__()
        self.cfg = cfg
        self.front = ViTEncoder(cfg.front())
        self.aggregator = Aggregator(cfg)
        self.depth_head = VGGTHead(cfg.dpt(), 2 * cfg.hidden_size, "depth")
        self.point_head = VGGTHead(cfg.dpt(), 2 * cfg.hidden_size, "points")
        self.camera_head = CameraHead(cfg)
        self.outputs: Dict[str, torch.Tensor] = {}

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        p = c.patch_size
        ph, pw = pixels.shape[1] // p, pixels.shape[2] // p
        with span("models.forward", pixels):
            patches = self.front(pixels)[0][:, 1:]
            joined = self.aggregator(patches, ph, pw)
            feats = [joined[i] for i in c.out_layers]
            poses = self.camera_head(joined[c.pairs - 1])
            out = dict(self.depth_head(feats, ph, pw, p))
            out.update(self.point_head(feats, ph, pw, p))
            out["pose_encoding"] = poses[-1]
            self.outputs = out
            return out["depth"]


class StreamVGGT(VGGT):
    """StreamVGGT on VGGT's modules and weights (the module docstring). The
    call maps a submap's normalised frames (S, h, w, 3), S at most
    ``cache_frames``, to depth (S, h, w): ``reset``, then ``step`` over
    chunks of ``stream_chunk_frames``; ``outputs`` holds every frame's.
    A live caller calls ``reset`` and ``step`` itself."""

    def __init__(self, cfg: StreamVGGTConfig):
        super().__init__(cfg)
        self.state = StreamState(cfg.pairs, cfg.cache_frames,
                                 2 * cfg.hidden_size)

    def reset(self) -> None:
        """Start a new stream: the cache holds no frame."""
        self.state.reset()

    def step(self, pixels: torch.Tensor) -> torch.Tensor:
        """One chunk of normalised frames (n, h, w, 3) after the frames
        held: their depth (n, h, w); their outputs on ``outputs``."""
        c = self.cfg
        p = c.patch_size
        n, ph, pw = pixels.shape[0], pixels.shape[1] // p, pixels.shape[2] // p
        st = self.state
        with span("models.stream.chunk", pixels):
            patches = self.front(pixels)[0][:, 1:]
            st.reserve(n, c.special_tokens + ph * pw, patches.dtype,
                       patches.device)
            joined = self.aggregator(patches, ph, pw, st)
            feats = [joined[i] for i in c.out_layers]
            held = st.frames
            st.camera[held:held + n].copy_(joined[c.pairs - 1][:, 0])
            poses = self.camera_head(st.camera[:held + n, None], causal=True)
            out = dict(self.depth_head(feats, ph, pw, p))
            out.update(self.point_head(feats, ph, pw, p))
            out["pose_encoding"] = poses[-1][held:]
            st.frames = held + n
            self.outputs = out
            return out["depth"]

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        chunk = self.cfg.stream_chunk_frames
        with span("models.forward", pixels):
            self.reset()
            parts = []
            for i in range(0, pixels.shape[0], chunk):
                self.step(pixels[i:i + chunk])
                parts.append(self.outputs)
            self.outputs = {k: torch.cat([o[k] for o in parts])
                            for k in parts[0]}
            return self.outputs["depth"]
