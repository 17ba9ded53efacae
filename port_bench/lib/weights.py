"""Seeded weights of a Depth Anything V2 configuration, made by the harness
and handed to both the program and the reference.

Every leaf is ``mean + std * z`` with ``z`` standard normal: one ``randn``
over all leaves on the card from a generator seeded with the run's seed,
an in-place affine per leaf view, and one cast to the served dtype. The law:
matrices and conv kernels std 1/sqrt(fan_in), position embedding and cls
token std 0.02, biases std 0.02 around 0, LayerNorm scales 1, LayerScale 1.
The metric head's last conv (``head.head_conv3``) takes its std and bias
from the configuration file (``weights``) and its weights are centred (their
mean taken out): its inputs follow a ReLU, so weights of nonzero mean shift
y = conv3(...) by a seed-dependent amount, and a seed whose y sits far up
the sigmoid puts the depth against 20 m, where sigmoid flattens whatever
error the network carries below the depth's own rounding. With the mean
out, y sits near the configured bias on every seed.

Leaf names are the state-dict names of the program's ``DepthAnything``,
which are a checkpoint format: the program loads the dict with
``load_state_dict(strict=True)``, the reference reads it by the same names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

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


def make_weights(cfg: dict, seed: int, device, dtype: torch.dtype
                 ) -> Dict[str, torch.Tensor]:
    """The configuration's weights for ``seed`` on ``device`` in ``dtype``:
    views into one flat buffer."""
    specs = leaves(cfg)
    sizes = [math.prod(s) for _, s, _, _ in specs]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device,
                       dtype=torch.float32)
    for (name, _, mean, std), part in zip(specs, flat.split(sizes)):
        part.mul_(std).add_(mean)
        if name in CENTRED:
            part.sub_(part.mean())
    flat = flat.to(dtype)
    return {name: part.view(shape) for (name, shape, _, _), part
            in zip(specs, flat.split(sizes))}
