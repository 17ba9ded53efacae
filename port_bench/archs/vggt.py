"""VGGT (VGGT-1B): a DINOv2 ViT-L/14 front with registers on every view,
an aggregator of frame / global attention pairs over all views of the step,
and depth, point and camera heads. A step's frames are the views of one
scene, so each frame's depth depends on every frame of its step. The
architecture of every configuration that names ``"architecture":
"vggt"``; ``spec.architecture`` says what such a file gives.

The program side is the port's public ``VGGT`` (``txr_torch/models/
vggt.py``) built from the configuration's keys; the reference is
``reference/vggt.py``. The program's call gives depth; the check compares
depth, points and the map (``lib/check.py``), so the camera and point
heads' own outputs are held only by ``chip_smoke.py``'s ``vggt_path`` and
the CPU tests.

The weights' law is Depth Anything V2's (``archs/depth_anything_v2.py``):
matrices and conv kernels std 1/sqrt(fan_in), tokens and the position
embedding std 0.02, biases std 0.02, LayerNorm scales 1, LayerScale 1 (the
published initialisation puts 0.01 in the aggregator and the camera
trunk; trained values are not known, and 1 keeps every block's part in the
depth as large as the check can see). The depth head's last conv
(``depth_head.head_conv3``, 2 channels) takes its std and bias from the
configuration file (``weights``) and is centred, so that exp(y0) sits
where the configuration says on every seed.

Operations are counted as Depth Anything V2's are (products only, two a
multiply-add): attention 4 B S^2 D within a view, 4 (B S)^2 D across the
views; QK-norm, RoPE, activations, resizes, the position embeddings
(the tail's term is made once per grid) and the camera head's
modulation's elementwise work are left out.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from port_bench.reference.vggt import reference  # noqa: F401
from txr_torch.models.vggt import HEAD_CHANNELS, POSE_DIM, VGGT, VGGTConfig
from txr_torch.models.vit import ROPE_BASE

# the control: the port's int8 route of the front's and the aggregator's
# dense layers
CONTROL = "int8p"

Leaf = Tuple[str, Tuple[int, ...], float, float]      # name, shape, mean, std
CENTRED = {"depth_head.head_conv3.weight"}
HEADS = ("depth_head", "point_head")


def model_grid(cfg: dict, frame_hw) -> Tuple[int, int]:
    """VGGT's "crop" preprocessing: width ``input_size``, height scaled
    with it and rounded to a multiple of the patch (1080 x 1920 -> 294 x
    518). A frame taller than that would be cropped, which the program's
    step does not do."""
    h, w = frame_hw
    side, p = cfg["input_size"], cfg["patch_size"]
    out_h = int(round(h * (side / w) / p)) * p
    if out_h > side:
        raise ValueError(f"a {h} x {w} frame is cropped by VGGT's "
                         f"preprocessing; the program's step resizes whole "
                         f"frames")
    return out_h, side


def leaves(cfg: dict) -> List[Leaf]:
    """(name, shape, mean, std) of every parameter of the configuration."""
    d = cfg["hidden_size"]
    p = cfg["patch_size"]
    g = cfg["pos_embed_grid"]
    hd = d // cfg["num_attention_heads"]
    feats = cfg["features"]
    oc = cfg["out_channels"]
    hh = cfg["head_hidden"]
    regs = cfg["num_registers"]
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

    def linear(name, n_out, n_in):
        mat(name + ".weight", (n_out, n_in), n_in)
        bias(name + ".bias", n_out)

    def blk(b, width, qk_norm):
        mlp = int(width * cfg["mlp_ratio"])
        const(b + "ls1", (width,), 1.0)
        const(b + "ls2", (width,), 1.0)
        norm(b + "norm1", width)
        linear(b + "attn.qkv", 3 * width, width)
        if qk_norm:
            norm(b + "attn.qk_prep.q_norm", hd)
            norm(b + "attn.qk_prep.k_norm", hd)
        linear(b + "attn.proj", width, width)
        norm(b + "norm2", width)
        linear(b + "mlp.fc1", mlp, width)
        linear(b + "mlp.fc2", width, mlp)

    f = "front."
    out.append((f + "cls_token", (1, 1, d), 0.0, 0.02))
    out.append((f + "pos_embed", (1, 1 + g * g, d), 0.0, 0.02))
    mat(f + "patch_embed.weight", (d, 3, p, p), 3 * p * p)
    bias(f + "patch_embed.bias", d)
    out.append((f + "register_tokens", (1, regs, d), 0.0, 0.02))
    for i in range(cfg["front_layers"]):
        blk(f"{f}block_{i}.", d, False)
    norm(f + "norm", d)

    a = "aggregator."
    out.append((a + "camera_token", (1, 2, 1, d), 0.0, 0.02))
    out.append((a + "register_token", (1, 2, regs, d), 0.0, 0.02))
    for i in range(cfg["aa_pairs"]):
        blk(f"{a}frame_{i}.", d, True)
        blk(f"{a}global_{i}.", d, True)

    din = 2 * d                                   # joined features
    for h in HEADS:
        h += "."
        norm(h + "norm", din)
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
        for fb, units in ((3, ("rcu2",)), (2, ("rcu1", "rcu2")),
                          (1, ("rcu1", "rcu2")), (0, ("rcu1", "rcu2"))):
            for u in units:
                for conv in ("conv1", "conv2"):
                    mat(f"{h}fusion_{fb}.{u}.{conv}.weight",
                        (feats, feats, 3, 3), feats * 9)
                    bias(f"{h}fusion_{fb}.{u}.{conv}.bias", feats)
            mat(f"{h}fusion_{fb}.project.weight", (feats, feats, 1, 1),
                feats)
            bias(f"{h}fusion_{fb}.project.bias", feats)
        mat(h + "head_conv1.weight", (feats // 2, feats, 3, 3), feats * 9)
        bias(h + "head_conv1.bias", feats // 2)
        mat(h + "head_conv2.weight", (hh, feats // 2, 3, 3), feats // 2 * 9)
        bias(h + "head_conv2.bias", hh)
        outs = HEAD_CHANNELS["depth" if h == "depth_head." else "points"]
        if h == "depth_head.":
            w3 = cfg["weights"]
            out.append((h + "head_conv3.weight", (outs, hh, 1, 1), 0.0,
                        w3["head_conv3_std"] / math.sqrt(hh)))
            const(h + "head_conv3.bias", (outs,), w3["head_conv3_bias"])
        else:
            mat(h + "head_conv3.weight", (outs, hh, 1, 1), hh)
            bias(h + "head_conv3.bias", outs)

    c = "camera_head."
    for i in range(cfg["camera_layers"]):
        blk(f"{c}block_{i}.", din, False)
    norm(c + "token_norm", din)
    norm(c + "trunk_norm", din)
    out.append((c + "empty_pose_tokens", (1, 1, POSE_DIM), 0.0, 0.02))
    linear(c + "embed_pose", din, POSE_DIM)
    linear(c + "modulation", 3 * din, din)
    linear(c + "pose_branch.fc1", din // 2, din)
    linear(c + "pose_branch.fc2", POSE_DIM, din // 2)
    return out


def check_config(cfg: dict) -> None:
    """Raises where the configuration's own keys cannot describe a model
    the program runs."""
    d, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    if d % heads or (d // heads) % 4:
        raise ValueError("hidden_size must split into heads of a multiple "
                         "of 4 (2-D RoPE)")
    if (2 * d) % heads:
        raise ValueError("the camera trunk (2 x hidden_size) must split "
                         "into num_attention_heads heads")
    if len(cfg["out_indices"]) != 4 or len(cfg["out_channels"]) != 4:
        raise ValueError("the DPT heads take four pairs: out_indices and "
                         "out_channels need four entries each")
    if not all(0 <= i < cfg["aa_pairs"] for i in cfg["out_indices"]):
        raise ValueError("out_indices must name aggregator pairs")
    if cfg["rope_freq"] != ROPE_BASE:
        raise ValueError(f"the port runs 2-D RoPE at base {ROPE_BASE}")
    if cfg["head_hidden"] != 32:
        raise ValueError("the tail kernel is built for 32 conv2 features")
    if cfg["camera_layers"] < 1 or cfg["camera_iterations"] < 1:
        raise ValueError("the camera head needs a layer and an iteration")


# ------------------------------------------------------------ the program

def model_config(cfg: dict, quant: str = "none") -> VGGTConfig:
    return VGGTConfig(hidden_size=cfg["hidden_size"],
                      num_heads=cfg["num_attention_heads"],
                      mlp_ratio=float(cfg["mlp_ratio"]),
                      patch_size=cfg["patch_size"],
                      front_layers=cfg["front_layers"],
                      num_registers=cfg["num_registers"],
                      pos_embed_size=cfg["pos_embed_grid"],
                      pairs=cfg["aa_pairs"],
                      rope_base=float(cfg["rope_freq"]),
                      out_layers=tuple(cfg["out_indices"]),
                      features=cfg["features"],
                      out_channels=tuple(cfg["out_channels"]),
                      head_hidden=cfg["head_hidden"],
                      camera_layers=cfg["camera_layers"],
                      camera_iterations=cfg["camera_iterations"],
                      quant=quant)


def build(cfg: dict, weights: dict, device, quant: str = "none") -> VGGT:
    """The configuration's model on ``device`` holding ``weights`` in
    bfloat16 (``quant``: the port's int8 policy of the front's and the
    aggregator's dense layers, for the control). Its call maps a step's
    views to their depth; the other outputs are on ``model.outputs``."""
    with torch.device("meta"):
        model = VGGT(model_config(cfg, quant))
    model = model.to_empty(device=device).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    model.load_state_dict(weights, strict=True)
    return model.eval()


def attention_modules(model: VGGT) -> list:
    """(start, proj) of each attention call that goes through the
    attention kernel: the front's blocks (from the qkv product), then each
    pair's frame and global blocks (from the QK-norm / RoPE module);
    attention proper runs between the end of the first and the start of
    the second. The camera trunk's calls (32 tokens, heads of 128, the
    plain attention) are not among them."""
    out = []
    for i in range(model.cfg.front_layers):
        attn = getattr(model.front, f"block_{i}").attn
        out.append((attn.qkv, attn.proj))
    for i in range(model.cfg.pairs):
        for kind in ("frame", "global"):
            attn = getattr(model.aggregator, f"{kind}_{i}").attn
            out.append((attn.qk_prep, attn.proj))
    return out


# ------------------------------------------------------------ the counts

def tokens(cfg: dict, model_hw) -> int:
    """Tokens a view: the front's (cls and registers) and the aggregator's
    (camera token and registers) are as many."""
    p = cfg["patch_size"]
    return 1 + cfg["num_registers"] + (model_hw[0] // p) * (model_hw[1] // p)


def attention_calls(cfg: dict) -> int:
    """The kernel's calls a step: one a front block, two a pair."""
    return cfg["front_layers"] + 2 * cfg["aa_pairs"]


def attention_flops(cfg: dict, model_hw, frames: int) -> float:
    """The kernel's calls of a step: 4 B S^2 D in each front block and
    frame block, 4 (B S)^2 D in each global block."""
    s, d = tokens(cfg, model_hw), cfg["hidden_size"]
    local = cfg["front_layers"] + cfg["aa_pairs"]
    return (local * 4.0 * frames * s * s * d
            + cfg["aa_pairs"] * 4.0 * (frames * s) ** 2 * d)


def block_dense_flops(cfg: dict, n: int, width: int) -> float:
    """A block's products other than attention proper, on n tokens."""
    mlp = width * cfg["mlp_ratio"]
    return 2.0 * n * width * (3 * width + width + 2 * mlp)


def encoder_dense_flops(cfg: dict, model_hw) -> float:
    """The front's and the aggregator's products of one view other than
    attention proper."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    s = tokens(cfg, model_hw)
    patches = (model_hw[0] // p) * (model_hw[1] // p)
    blocks = cfg["front_layers"] + 2 * cfg["aa_pairs"]
    return 2.0 * patches * d * 3 * p * p + blocks * block_dense_flops(
        cfg, s, d)


def _conv(h, w, cin, cout, k):
    return 2.0 * h * w * cin * cout * k * k


def head_flops(cfg: dict, model_hw, outs: int) -> float:
    """One DPT head's operations on one view: projections from the joined
    2 D channels, resizes, scratch convs, one fusion stack and the tail."""
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
    for i in (3, 2, 1, 0):
        h, w = sizes[i]
        ops += units[i] * 2 * _conv(h, w, f, f, 3)
        ops += _conv(*out_size[i], f, f, 1)
    ops += _conv(8 * ph, 8 * pw, f, f // 2, 3)                   # conv1
    ops += _conv(ph * p, pw * p, f // 2, hh, 3)                  # conv2
    ops += _conv(ph * p, pw * p, hh, outs, 1)                    # conv3
    return ops


def camera_flops(cfg: dict, frames: int) -> float:
    """The camera head's products a step: per iteration the pose
    embedding, the modulation, the trunk on the views' tokens (2 D wide)
    and the pose branch."""
    w = 2 * cfg["hidden_size"]
    trunk = cfg["camera_layers"] * (block_dense_flops(cfg, frames, w)
                                    + 4.0 * frames * frames * w)
    one = (2.0 * frames * POSE_DIM * w + 2.0 * frames * w * 3 * w + trunk
           + 2.0 * frames * (w * (w // 2) + (w // 2) * POSE_DIM))
    return cfg["camera_iterations"] * one


def step_flops(cfg: dict, model_hw, frames: int) -> float:
    """The model's operations for a step of ``frames`` views."""
    heads = sum(head_flops(cfg, model_hw, n) for n in HEAD_CHANNELS.values())
    return (frames * (encoder_dense_flops(cfg, model_hw) + heads)
            + attention_flops(cfg, model_hw, frames)
            + camera_flops(cfg, frames))
