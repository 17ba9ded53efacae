"""Depth Anything V2 with its metric head: a DINOv2 ViT encoder and a DPT
head, run one frame at a time (each frame's depth depends on that frame
alone). The architecture of every configuration that names
``"architecture": "depth_anything_v2"``; ``spec.architecture`` says what
such a file gives.

The program side is the port's public ``DepthAnything`` built from the
configuration's keys; the reference is ``reference/depth_anything_v2.py``.

The weights' law: matrices and conv kernels std 1/sqrt(fan_in), position
embedding and cls token std 0.02, biases std 0.02 around 0, LayerNorm
scales 1, LayerScale 1. The metric head's last conv (``head.head_conv3``)
takes its std and bias from the configuration file (``weights``) and its
weights are centred (their mean taken out): its inputs follow a ReLU, so
weights of nonzero mean shift y = conv3(...) by a seed-dependent amount,
and a seed whose y sits far up the sigmoid puts the depth against 20 m,
where sigmoid flattens whatever error the network carries below the
depth's own rounding. With the mean out, y sits near the configured bias
on every seed. Leaf names are the state-dict names of the port's
``DepthAnything``, which are a checkpoint format.

Operations are counted from the configuration's shapes. Only products
count (matrix products, convolutions, attention's two products), two
operations a multiply-add, as a model's FLOPs are usually counted;
normalisation, activations, softmax and resizes are left out.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from port_bench.reference.depth_anything_v2 import reference  # noqa: F401
from txr_torch.models.depth_anything import DepthAnything
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig

# the control: the port's int8 route of the encoder's dense layers
CONTROL = "int8p"

Leaf = Tuple[str, Tuple[int, ...], float, float]      # name, shape, mean, std
CENTRED = {"head.head_conv3.weight"}


def leaves(cfg: dict) -> List[Leaf]:
    """(name, shape, mean, std) of every parameter of the configuration."""
    d = cfg["hidden_size"]
    p = cfg["patch_size"]
    g = cfg["pos_embed_grid"]
    mlp = int(d * cfg["mlp_ratio"])
    feats = cfg["features"]
    oc = cfg["out_channels"]
    hh = cfg["head_hidden"]
    out: List[Leaf] = []

    def mat(name, shape, fan_in):
        out.append((name, tuple(shape), 0.0, 1.0 / math.sqrt(fan_in)))

    def bias(name, n):
        out.append((name, (n,), 0.0, 0.02))

    def const(name, shape, value):
        out.append((name, tuple(shape), value, 0.0))

    e = "encoder."
    out.append((e + "cls_token", (1, 1, d), 0.0, 0.02))
    out.append((e + "pos_embed", (1, 1 + g * g, d), 0.0, 0.02))
    mat(e + "patch_embed.weight", (d, 3, p, p), 3 * p * p)
    bias(e + "patch_embed.bias", d)
    for i in range(cfg["num_hidden_layers"]):
        b = f"{e}block_{i}."
        const(b + "ls1", (d,), 1.0)
        const(b + "ls2", (d,), 1.0)
        const(b + "norm1.weight", (d,), 1.0)
        bias(b + "norm1.bias", d)
        mat(b + "attn.qkv.weight", (3 * d, d), d)
        bias(b + "attn.qkv.bias", 3 * d)
        mat(b + "attn.proj.weight", (d, d), d)
        bias(b + "attn.proj.bias", d)
        const(b + "norm2.weight", (d,), 1.0)
        bias(b + "norm2.bias", d)
        mat(b + "mlp.fc1.weight", (mlp, d), d)
        bias(b + "mlp.fc1.bias", mlp)
        mat(b + "mlp.fc2.weight", (d, mlp), mlp)
        bias(b + "mlp.fc2.bias", d)
    const(e + "norm.weight", (d,), 1.0)
    bias(e + "norm.bias", d)

    h = "head."
    for i, c in enumerate(oc):
        mat(f"{h}project_{i}.weight", (c, d, 1, 1), d)
        bias(f"{h}project_{i}.bias", c)
        mat(f"{h}scratch_{i}.weight", (feats, c, 3, 3), c * 9)
    mat(h + "resize_0.weight", (oc[0], oc[0], 4, 4), oc[0] * 16)
    bias(h + "resize_0.bias", oc[0])
    mat(h + "resize_1.weight", (oc[1], oc[1], 2, 2), oc[1] * 4)
    bias(h + "resize_1.bias", oc[1])
    mat(h + "resize_3.weight", (oc[3], oc[3], 3, 3), oc[3] * 9)
    bias(h + "resize_3.bias", oc[3])
    for blk, units in (("fusion_3", ("rcu2",)),
                       ("fusion_2", ("rcu1", "rcu2")),
                       ("fusion_1", ("rcu1", "rcu2")),
                       ("fusion_0", ("rcu1", "rcu2"))):
        for u in units:
            for conv in ("conv1", "conv2"):
                mat(f"{h}{blk}.{u}.{conv}.weight", (feats, feats, 3, 3),
                    feats * 9)
                bias(f"{h}{blk}.{u}.{conv}.bias", feats)
        mat(f"{h}{blk}.project.weight", (feats, feats, 1, 1), feats)
        bias(f"{h}{blk}.project.bias", feats)
    mat(h + "head_conv1.weight", (feats // 2, feats, 3, 3), feats * 9)
    bias(h + "head_conv1.bias", feats // 2)
    mat(h + "head_conv2.weight", (hh, feats // 2, 3, 3), feats // 2 * 9)
    bias(h + "head_conv2.bias", hh)
    w3 = cfg["weights"]
    out.append((h + "head_conv3.weight", (1, hh, 1, 1), 0.0,
                w3["head_conv3_std"] / math.sqrt(hh)))
    const(h + "head_conv3.bias", (1,), w3["head_conv3_bias"])
    return out


def model_grid(cfg: dict, frame_hw) -> tuple:
    """Depth Anything's lower-bound resize: the short side scales to
    ``input_size`` and both sides round to the nearest multiple of
    ``patch_size`` (upward where that falls under ``input_size``)."""
    h, w = frame_hw
    target, multiple = cfg["input_size"], cfg["patch_size"]
    s = max(target / h, target / w)

    def fit(v):
        out = int(round(v / multiple) * multiple)
        if out < target:
            out = int(-(-v // multiple) * multiple)
        return max(out, multiple)

    return fit(s * h), fit(s * w)


def check_config(cfg: dict) -> None:
    """Raises where the configuration's own keys cannot describe a model."""
    if cfg["hidden_size"] % cfg["num_attention_heads"]:
        raise ValueError("hidden_size is not a multiple of "
                         "num_attention_heads")
    if not len(cfg["out_indices"]) == len(cfg["out_channels"]) == 4:
        raise ValueError("the DPT head takes four layers: out_indices and "
                         "out_channels need four entries each")


# ------------------------------------------------------------ the program

def build(cfg: dict, weights: dict, device, quant: str = "none"
          ) -> DepthAnything:
    """The configuration's model on ``device`` holding ``weights`` in
    bfloat16 (``quant``: the port's int8 policy of the encoder's dense
    layers, for the control)."""
    vit = ViTConfig(hidden_size=cfg["hidden_size"],
                    num_layers=cfg["num_hidden_layers"],
                    num_heads=cfg["num_attention_heads"],
                    patch_size=cfg["patch_size"],
                    mlp_ratio=float(cfg["mlp_ratio"]),
                    layerscale_init=1.0,
                    pos_embed_size=cfg["pos_embed_grid"],
                    out_layers=tuple(cfg["out_indices"]), quant=quant)
    dpt = DPTConfig(features=cfg["features"],
                    out_channels=tuple(cfg["out_channels"]),
                    head_hidden=cfg["head_hidden"], metric=True,
                    max_depth=float(cfg["max_depth"]))
    with torch.device("meta"):
        model = DepthAnything(vit, dpt)
    model = model.to_empty(device=device).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def attention_modules(model: DepthAnything) -> list:
    """(qkv, proj) of each encoder block: attention proper runs between
    the end of the first and the start of the second."""
    enc = model.encoder
    return [(getattr(enc, f"block_{i}").attn.qkv,
             getattr(enc, f"block_{i}").attn.proj)
            for i in range(enc.cfg.num_layers)]


# ------------------------------------------------------------ the counts

def tokens(cfg: dict, model_hw) -> int:
    p = cfg["patch_size"]
    return 1 + (model_hw[0] // p) * (model_hw[1] // p)


def layer_attention_flops(cfg: dict, model_hw, frames: int) -> float:
    """One layer's attention proper: 4 B H S^2 D (q k^T and the weighted
    sum of values)."""
    s = tokens(cfg, model_hw)
    return 4.0 * frames * s * s * cfg["hidden_size"]


def vit_flops(cfg: dict, model_hw) -> float:
    """Encoder operations of one frame."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    s = tokens(cfg, model_hw)
    mlp = d * cfg["mlp_ratio"]
    patches = s - 1
    per_layer = (2.0 * s * d * 3 * d + 2.0 * s * d * d
                 + 2.0 * 2 * s * d * mlp
                 + layer_attention_flops(cfg, model_hw, 1))
    return 2.0 * patches * d * 3 * p * p + cfg["num_hidden_layers"] * \
        per_layer


def _conv(h, w, cin, cout, k):
    return 2.0 * h * w * cin * cout * k * k


def dpt_flops(cfg: dict, model_hw) -> float:
    """Head operations of one frame."""
    p, d = cfg["patch_size"], cfg["hidden_size"]
    oc, f, hh = cfg["out_channels"], cfg["features"], cfg["head_hidden"]
    ph, pw = model_hw[0] // p, model_hw[1] // p
    h3, w3 = (ph + 1) // 2, (pw + 1) // 2
    sizes = [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw), (h3, w3)]
    ops = sum(_conv(ph, pw, d, c, 1) for c in oc)                # project
    ops += _conv(ph, pw, oc[0], oc[0], 4)                        # 4x up
    ops += _conv(ph, pw, oc[1], oc[1], 2)                        # 2x up
    ops += _conv(h3, w3, oc[3], oc[3], 3)                        # 2x down
    ops += sum(_conv(h, w, c, f, 3) for (h, w), c in zip(sizes, oc))
    # fusion blocks: residual units at their input size, the projection
    # at the upsampled size
    units = {3: 1, 2: 2, 1: 2, 0: 2}
    out_size = {3: sizes[2], 2: sizes[1], 1: sizes[0],
                0: (8 * ph, 8 * pw)}
    for i in (3, 2, 1, 0):
        h, w = sizes[i]
        ops += units[i] * 2 * _conv(h, w, f, f, 3)
        ops += _conv(*out_size[i], f, f, 1)
    h0, w0 = 8 * ph, 8 * pw
    ops += _conv(h0, w0, f, f // 2, 3)                           # conv1
    ops += _conv(ph * p, pw * p, f // 2, hh, 3)                  # conv2
    ops += _conv(ph * p, pw * p, hh, 1, 1)                       # conv3
    return ops


def step_flops(cfg: dict, model_hw, frames: int) -> float:
    """Encoder and head operations of a step of ``frames`` frames."""
    return frames * (vit_flops(cfg, model_hw) + dpt_flops(cfg, model_hw))


def attention_calls(cfg: dict) -> int:
    """One attention call a layer."""
    return cfg["num_hidden_layers"]


def attention_flops(cfg: dict, model_hw, frames: int) -> float:
    """All the step's attention calls: each attends within its frame."""
    return attention_calls(cfg) * layer_attention_flops(cfg, model_hw,
                                                        frames)
