"""Depth Anything 3 any-view (DA3-LARGE): a DINOv2 ViT whose odd layers
from ``alt_start`` on attend across every view of the step, with QK-norm,
2-D RoPE and a camera token, and a dual DPT head (depth and rays). A step's
frames are the views of one scene, so each frame's depth depends on every
frame of its step. The architecture of every configuration that names
``"architecture": "depth_anything_3"``; ``spec.architecture`` says what
such a file gives.

The program side is the port's public ``DepthAnything`` built from the
configuration's keys (``models/vit.py``'s ``anyview_start``,
``models/dpt.py``'s ``dual`` head); the reference is
``reference/depth_anything_3.py``.

The weights' law is Depth Anything V2's (``archs/depth_anything_v2.py``),
with the camera token as the cls token (std 0.02) and the QK-norms as
LayerNorms (scale 1, bias std 0.02). The depth branch's last conv
(``head.head_conv3``, 2 output channels) takes its std and bias from the
configuration file (``weights``) and is centred (its mean over both
channels taken out), so that exp(y0) sits where the configuration says on
every seed; the ray branch's last conv has the law of any conv.

Operations are counted as Depth Anything V2's are (products only, two a
multiply-add): a within-view layer's attention is 4 B S^2 D, a cross-view
layer's 4 (B S)^2 D; QK-norm, RoPE, activations and resizes are left out.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

# Depth Anything's lower-bound resize to the model grid, as V2's
from port_bench.archs.depth_anything_v2 import model_grid  # noqa: F401
from port_bench.reference.depth_anything_3 import reference  # noqa: F401
from txr_torch.models.depth_anything import DepthAnything
from txr_torch.models.dpt import DEPTH_CHANNELS, RAY_CHANNELS, DPTConfig
from txr_torch.models.vit import ROPE_BASE, ViTConfig

# the control: the port's int8 route of the encoder's dense layers
CONTROL = "int8p"

Leaf = Tuple[str, Tuple[int, ...], float, float]      # name, shape, mean, std
CENTRED = {"head.head_conv3.weight"}


def leaves(cfg: dict) -> List[Leaf]:
    """(name, shape, mean, std) of every parameter of the configuration."""
    d = cfg["hidden_size"]
    p = cfg["patch_size"]
    g = cfg["pos_embed_grid"]
    hd = d // cfg["num_attention_heads"]
    mlp = int(d * cfg["mlp_ratio"])
    feats = cfg["features"]
    oc = cfg["out_channels"]
    hh = cfg["head_hidden"]
    din = 2 * d                                   # joined features
    out: List[Leaf] = []

    def mat(name, shape, fan_in):
        out.append((name, tuple(shape), 0.0, 1.0 / math.sqrt(fan_in)))

    def bias(name, n):
        out.append((name, (n,), 0.0, 0.02))

    def const(name, shape, value):
        out.append((name, tuple(shape), value, 0.0))

    def norm(name, n):
        const(name + ".weight", (n,), 1.0)
        bias(name + ".bias", n)

    e = "encoder."
    out.append((e + "cls_token", (1, 1, d), 0.0, 0.02))
    out.append((e + "pos_embed", (1, 1 + g * g, d), 0.0, 0.02))
    mat(e + "patch_embed.weight", (d, 3, p, p), 3 * p * p)
    bias(e + "patch_embed.bias", d)
    out.append((e + "camera_token", (1, 2, d), 0.0, 0.02))
    for i in range(cfg["num_hidden_layers"]):
        b = f"{e}block_{i}."
        const(b + "ls1", (d,), 1.0)
        const(b + "ls2", (d,), 1.0)
        norm(b + "norm1", d)
        mat(b + "attn.qkv.weight", (3 * d, d), d)
        bias(b + "attn.qkv.bias", 3 * d)
        if i >= cfg["qknorm_start"]:
            norm(b + "attn.qk_prep.q_norm", hd)
            norm(b + "attn.qk_prep.k_norm", hd)
        mat(b + "attn.proj.weight", (d, d), d)
        bias(b + "attn.proj.bias", d)
        norm(b + "norm2", d)
        mat(b + "mlp.fc1.weight", (mlp, d), d)
        bias(b + "mlp.fc1.bias", mlp)
        mat(b + "mlp.fc2.weight", (d, mlp), mlp)
        bias(b + "mlp.fc2.bias", d)
    norm(e + "norm", d)

    h = "head."
    for i, c in enumerate(oc):
        mat(f"{h}project_{i}.weight", (c, din, 1, 1), din)
        bias(f"{h}project_{i}.bias", c)
        mat(f"{h}scratch_{i}.weight", (feats, c, 3, 3), c * 9)
    mat(h + "resize_0.weight", (oc[0], oc[0], 4, 4), oc[0] * 16)
    bias(h + "resize_0.bias", oc[0])
    mat(h + "resize_1.weight", (oc[1], oc[1], 2, 2), oc[1] * 4)
    bias(h + "resize_1.bias", oc[1])
    mat(h + "resize_3.weight", (oc[3], oc[3], 3, 3), oc[3] * 9)
    bias(h + "resize_3.bias", oc[3])
    for prefix in ("fusion_", "ray_fusion_"):
        for blk, units in ((3, ("rcu2",)), (2, ("rcu1", "rcu2")),
                           (1, ("rcu1", "rcu2")), (0, ("rcu1", "rcu2"))):
            for u in units:
                for conv in ("conv1", "conv2"):
                    mat(f"{h}{prefix}{blk}.{u}.{conv}.weight",
                        (feats, feats, 3, 3), feats * 9)
                    bias(f"{h}{prefix}{blk}.{u}.{conv}.bias", feats)
            mat(f"{h}{prefix}{blk}.project.weight", (feats, feats, 1, 1),
                feats)
            bias(f"{h}{prefix}{blk}.project.bias", feats)
    for tail, outs in (("head_conv", DEPTH_CHANNELS),
                       ("ray_conv", RAY_CHANNELS)):
        mat(f"{h}{tail}1.weight", (feats // 2, feats, 3, 3), feats * 9)
        bias(f"{h}{tail}1.bias", feats // 2)
        mat(f"{h}{tail}2.weight", (hh, feats // 2, 3, 3), feats // 2 * 9)
        bias(f"{h}{tail}2.bias", hh)
        if tail == "head_conv":
            w3 = cfg["weights"]
            out.append((h + "head_conv3.weight", (outs, hh, 1, 1), 0.0,
                        w3["head_conv3_std"] / math.sqrt(hh)))
            const(h + "head_conv3.bias", (outs,), w3["head_conv3_bias"])
        else:
            mat(f"{h}{tail}3.weight", (outs, hh, 1, 1), hh)
            bias(f"{h}{tail}3.bias", outs)
    return out


def check_config(cfg: dict) -> None:
    """Raises where the configuration's own keys cannot describe a model."""
    layers = cfg["num_hidden_layers"]
    if cfg["hidden_size"] % cfg["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of "
                         "num_attention_heads")
    if (cfg["hidden_size"] // cfg["num_attention_heads"]) % 4:
        raise ValueError("2-D RoPE needs a head size that is a multiple "
                         "of 4")
    if not len(cfg["out_indices"]) == len(cfg["out_channels"]) == 4:
        raise ValueError("the DPT head takes four layers: out_indices and "
                         "out_channels need four entries each")
    for k in ("alt_start", "qknorm_start", "rope_start"):
        if not 0 <= cfg[k] < layers:
            raise ValueError(f"{k} must name a layer, 0 to {layers - 1}")
    if not cfg["alt_start"] == cfg["qknorm_start"] == cfg["rope_start"] or \
            cfg["rope_freq"] != ROPE_BASE:
        raise ValueError(f"the port runs cross-view attention, QK-norm and "
                         f"RoPE from one layer on, at base {ROPE_BASE}")
    if not all(0 <= i < layers for i in cfg["out_indices"]):
        raise ValueError("out_indices must name layers")


# ------------------------------------------------------------ the program

def vit_config(cfg: dict, quant: str = "none") -> ViTConfig:
    return ViTConfig(hidden_size=cfg["hidden_size"],
                     num_layers=cfg["num_hidden_layers"],
                     num_heads=cfg["num_attention_heads"],
                     patch_size=cfg["patch_size"],
                     mlp_ratio=float(cfg["mlp_ratio"]),
                     layerscale_init=1.0,
                     pos_embed_size=cfg["pos_embed_grid"],
                     out_layers=tuple(cfg["out_indices"]), quant=quant,
                     anyview_start=cfg["alt_start"])


def build(cfg: dict, weights: dict, device, quant: str = "none"
          ) -> DepthAnything:
    """The configuration's model on ``device`` holding ``weights`` in
    bfloat16 (``quant``: the port's int8 policy of the encoder's dense
    layers, for the control). Its call maps a step's views to their depth;
    confidence and rays are on ``model.outputs``."""
    dpt = DPTConfig(features=cfg["features"],
                    out_channels=tuple(cfg["out_channels"]),
                    head_hidden=cfg["head_hidden"], dual=True)
    with torch.device("meta"):
        model = DepthAnything(vit_config(cfg, quant), dpt)
    model = model.to_empty(device=device).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def attention_modules(model: DepthAnything) -> list:
    """(start, proj) of each encoder block: the QK-norm / RoPE module where
    the block has one, else the qkv product; attention proper (the kernel
    alone) runs between the end of the first and the start of the
    second."""
    out = []
    for i in range(model.encoder.cfg.num_layers):
        attn = getattr(model.encoder, f"block_{i}").attn
        out.append((attn.qk_prep if attn.qk_prep is not None else attn.qkv,
                    attn.proj))
    return out


# ------------------------------------------------------------ the counts

def tokens(cfg: dict, model_hw) -> int:
    p = cfg["patch_size"]
    return 1 + (model_hw[0] // p) * (model_hw[1] // p)


def crossview_layers(cfg: dict) -> int:
    a, n = cfg["alt_start"], cfg["num_hidden_layers"]
    return sum(1 for i in range(a, n) if i % 2 == 1)


def attention_calls(cfg: dict) -> int:
    """One attention call a layer, within-view or cross-view."""
    return cfg["num_hidden_layers"]


def attention_flops(cfg: dict, model_hw, frames: int) -> float:
    """All the step's attention calls: 4 B S^2 D for each within-view
    layer, 4 (B S)^2 D for each cross-view one."""
    s, d = tokens(cfg, model_hw), cfg["hidden_size"]
    cross = crossview_layers(cfg)
    local = cfg["num_hidden_layers"] - cross
    return (local * 4.0 * frames * s * s * d
            + cross * 4.0 * (frames * s) ** 2 * d)


def dense_flops(cfg: dict, model_hw) -> float:
    """Encoder products of one view other than attention proper."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    s = tokens(cfg, model_hw)
    mlp = d * cfg["mlp_ratio"]
    per_layer = 2.0 * s * d * 3 * d + 2.0 * s * d * d + 2.0 * 2 * s * d * mlp
    return 2.0 * (s - 1) * d * 3 * p * p + cfg["num_hidden_layers"] * \
        per_layer


def _conv(h, w, cin, cout, k):
    return 2.0 * h * w * cin * cout * k * k


def head_flops(cfg: dict, model_hw) -> float:
    """Dual head operations of one view: the shared projections (from the
    joined 2 D channels), resizes and scratch convs, then two fusion
    stacks and two tails (2 and 7 output channels)."""
    p, d = cfg["patch_size"], cfg["hidden_size"]
    oc, f, hh = cfg["out_channels"], cfg["features"], cfg["head_hidden"]
    ph, pw = model_hw[0] // p, model_hw[1] // p
    h3, w3 = (ph + 1) // 2, (pw + 1) // 2
    sizes = [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw), (h3, w3)]
    ops = sum(_conv(ph, pw, 2 * d, c, 1) for c in oc)            # project
    ops += _conv(ph, pw, oc[0], oc[0], 4)                        # 4x up
    ops += _conv(ph, pw, oc[1], oc[1], 2)                        # 2x up
    ops += _conv(h3, w3, oc[3], oc[3], 3)                        # 2x down
    ops += sum(_conv(h, w, c, f, 3) for (h, w), c in zip(sizes, oc))
    units = {3: 1, 2: 2, 1: 2, 0: 2}
    out_size = {3: sizes[2], 2: sizes[1], 1: sizes[0],
                0: (8 * ph, 8 * pw)}
    fusion = 0.0
    for i in (3, 2, 1, 0):
        h, w = sizes[i]
        fusion += units[i] * 2 * _conv(h, w, f, f, 3)
        fusion += _conv(*out_size[i], f, f, 1)
    ops += 2 * fusion
    for outs in (DEPTH_CHANNELS, RAY_CHANNELS):
        ops += _conv(8 * ph, 8 * pw, f, f // 2, 3)               # conv1
        ops += _conv(ph * p, pw * p, f // 2, hh, 3)              # conv2
        ops += _conv(ph * p, pw * p, hh, outs, 1)                # conv3
    return ops


def step_flops(cfg: dict, model_hw, frames: int) -> float:
    """Encoder and head operations of a step of ``frames`` views."""
    return (frames * (dense_flops(cfg, model_hw) + head_flops(cfg, model_hw))
            + attention_flops(cfg, model_hw, frames))
