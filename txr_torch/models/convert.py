"""Weights across: ``txr``'s parameter tree, or a published Depth Anything
state dict, -> a ``DepthAnything`` state dict. Counterpart of
``txr/models/convert.py``.

``convert_state_dict`` maps both naming schemes of the published weights,
Hugging Face ``DepthAnythingForDepthEstimation`` (``backbone.embeddings...``,
``neck.reassemble_stage...``, ``head.conv1...``) and the original
Depth-Anything repository (``pretrained.blocks...``, ``depth_head.scratch...``),
onto the port's module names. Those weights are PyTorch's already, so no
layout changes: q, k, v are concatenated into the fused ``qkv``, the fusion
stages are renumbered (HF layer j is ``fusion_{3-j}``), and the
``residual_layer1`` that HF ships for its first fusion layer, which never
runs, is dropped.

``from_txr_params`` is the inverse of ``txr/models/convert.py``'s layout
rules, applied leaf by leaf to the nested dict of arrays that ``txr`` calls
its params (``{"encoder": {...}, "head": {...}}``):

- Dense ``kernel`` (in, out)            -> ``nn.Linear.weight`` (out, in)
- Conv ``kernel`` HWIO (kh, kw, I, O)   -> ``nn.Conv2d.weight`` OIHW
- ConvTranspose ``kernel`` (``resize_0``, ``resize_1``): ``txr`` stores it
  spatially FLIPPED for its framework's convention, (kh, kw, I, O); PyTorch's
  ``ConvTranspose2d.weight`` is (I, O, kh, kw) unflipped, so the flip is
  undone here
- LayerNorm ``scale``                   -> ``weight``
- everything else (biases, cls_token, pos_embed, ls1, ls2) keeps its name

The fused qkv kernel stays fused and component-major. Module names in
``txr_torch.models`` mirror the tree's, so a leaf's path is its key.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _normalize_names(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Rewrite original-repository names (``pretrained.*`` for DINOv2,
    ``depth_head.*`` for DPT) to the HF scheme so one mapping serves both."""
    if not any(k.startswith("pretrained.") for k in sd):
        return dict(sd)
    out: Dict[str, Any] = {}
    for k, v in sd.items():
        nk = None
        if k == "pretrained.cls_token":
            nk = "backbone.embeddings.cls_token"
        elif k == "pretrained.pos_embed":
            nk = "backbone.embeddings.position_embeddings"
        elif k.startswith("pretrained.patch_embed.proj."):
            nk = k.replace("pretrained.patch_embed.proj.",
                           "backbone.embeddings.patch_embeddings.projection.")
        elif k.startswith("pretrained.norm."):
            nk = k.replace("pretrained.norm.", "backbone.layernorm.")
        elif k.startswith("pretrained.blocks."):
            i, sub = k[len("pretrained.blocks."):].split(".", 1)
            sub = (sub
                   .replace("attn.qkv.", "attention.attention.qkv.")
                   .replace("attn.proj.", "attention.output.dense.")
                   .replace("ls1.gamma", "layer_scale1.lambda1")
                   .replace("ls2.gamma", "layer_scale2.lambda1"))
            nk = f"backbone.encoder.layer.{i}.{sub}"
        elif k.startswith("depth_head.projects."):
            i, rest = k[len("depth_head.projects."):].split(".", 1)
            nk = f"neck.reassemble_stage.layers.{i}.projection.{rest}"
        elif k.startswith("depth_head.resize_layers."):
            i, rest = k[len("depth_head.resize_layers."):].split(".", 1)
            nk = f"neck.reassemble_stage.layers.{i}.resize.{rest}"
        elif k.startswith("depth_head.scratch.layer"):
            # depth_head.scratch.layer{n}_rn.weight, n counted from 1
            n = int(k.split("layer")[1].split("_")[0])
            nk = f"neck.convs.{n - 1}.weight"
        elif k.startswith("depth_head.scratch.refinenet"):
            # refinenet{n}, n in 1..4; HF numbers its fusion layers the other
            # way round: refinenet4 is layer 0, refinenet1 layer 3
            n = int(k.split("refinenet")[1].split(".")[0])
            sub = k.split(f"refinenet{n}.")[1]
            sub = (sub
                   .replace("resConfUnit1.", "residual_layer1.")
                   .replace("resConfUnit2.", "residual_layer2.")
                   .replace("conv1.", "convolution1.")
                   .replace("conv2.", "convolution2.")
                   .replace("out_conv.", "projection."))
            nk = f"neck.fusion_stage.layers.{4 - n}.{sub}"
        elif k.startswith("depth_head.scratch.output_conv1."):
            nk = k.replace("depth_head.scratch.output_conv1.", "head.conv1.")
        elif k.startswith("depth_head.scratch.output_conv2.0."):
            nk = k.replace("depth_head.scratch.output_conv2.0.", "head.conv2.")
        elif k.startswith("depth_head.scratch.output_conv2.2."):
            nk = k.replace("depth_head.scratch.output_conv2.2.", "head.conv3.")
        if nk is not None:
            out[nk] = v
    return out


def convert_state_dict(sd: Mapping[str, torch.Tensor], num_layers: int
                       ) -> Dict[str, torch.Tensor]:
    """HF- or original-named state dict -> ``state_dict`` for
    ``txr_torch.models.depth_anything.DepthAnything`` with ``num_layers``
    encoder blocks. A missing source tensor raises ``KeyError``."""
    sd = _normalize_names(sd)
    out: Dict[str, torch.Tensor] = {}

    def put(dst: str, src: str, names=("weight", "bias")) -> None:
        for n in names:
            out[f"{dst}.{n}"] = sd[f"{src}.{n}"]

    emb = "backbone.embeddings."
    out["encoder.cls_token"] = sd[emb + "cls_token"].reshape(1, 1, -1)
    out["encoder.pos_embed"] = sd[emb + "position_embeddings"]
    put("encoder.patch_embed", emb + "patch_embeddings.projection")
    put("encoder.norm", "backbone.layernorm")
    for i in range(num_layers):
        src = f"backbone.encoder.layer.{i}"
        dst = f"encoder.block_{i}"
        put(f"{dst}.norm1", f"{src}.norm1")
        put(f"{dst}.norm2", f"{src}.norm2")
        att = f"{src}.attention.attention"
        if f"{att}.qkv.weight" in sd:          # original: fused already
            put(f"{dst}.attn.qkv", f"{att}.qkv")
        else:                                  # HF: separate q, k, v
            for n in ("weight", "bias"):
                out[f"{dst}.attn.qkv.{n}"] = torch.cat(
                    [sd[f"{att}.{part}.{n}"]
                     for part in ("query", "key", "value")], dim=0)
        put(f"{dst}.attn.proj", f"{src}.attention.output.dense")
        out[f"{dst}.ls1"] = sd[f"{src}.layer_scale1.lambda1"]
        out[f"{dst}.ls2"] = sd[f"{src}.layer_scale2.lambda1"]
        if f"{src}.mlp.fc1.weight" in sd:
            put(f"{dst}.mlp.fc1", f"{src}.mlp.fc1")
            put(f"{dst}.mlp.fc2", f"{src}.mlp.fc2")
        else:                                  # SwiGLU (vitg)
            put(f"{dst}.mlp.w12", f"{src}.mlp.w12")
            put(f"{dst}.mlp.w3", f"{src}.mlp.w3")

    for i in range(4):
        src = f"neck.reassemble_stage.layers.{i}"
        put(f"head.project_{i}", f"{src}.projection")
        if i != 2:
            put(f"head.resize_{i}", f"{src}.resize")
        put(f"head.scratch_{i}", f"neck.convs.{i}", names=("weight",))
    for j in range(4):
        src = f"neck.fusion_stage.layers.{j}"
        dst = f"head.fusion_{3 - j}"
        put(f"{dst}.project", f"{src}.projection")
        units = ("rcu2",) if j == 0 else ("rcu1", "rcu2")
        for unit in units:
            layer = "residual_layer1" if unit == "rcu1" else "residual_layer2"
            put(f"{dst}.{unit}.conv1", f"{src}.{layer}.convolution1")
            put(f"{dst}.{unit}.conv2", f"{src}.{layer}.convolution2")
    for n in (1, 2, 3):
        put(f"head.head_conv{n}", f"head.conv{n}")
    return out

_TRANSPOSED_CONVS = ("resize_0", "resize_1")


def _leaf(path: tuple, value: np.ndarray):
    """(state-dict key, array) for one leaf of the txr tree."""
    v = np.asarray(value)
    name = path[-1]
    module = path[-2] if len(path) > 1 else ""
    if name == "kernel":
        if v.ndim == 2:
            v = v.T
        elif v.ndim == 4 and module in _TRANSPOSED_CONVS:
            v = v[::-1, ::-1].transpose(2, 3, 0, 1)
        elif v.ndim == 4:
            v = v.transpose(3, 2, 0, 1)
        else:
            raise ValueError(f"kernel {'.'.join(path)} has rank {v.ndim}")
        name = "weight"
    elif name == "scale":
        name = "weight"
    return ".".join(path[:-1] + (name,)), np.ascontiguousarray(v)


def from_txr_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (``txr`` params) -> ``state_dict`` for
    ``txr_torch.models.depth_anything.DepthAnything``.

    Arrays keep their dtype where PyTorch has it (float32, float16); any
    other floating type (bfloat16 arrays have no numpy dtype PyTorch reads)
    goes through float32. Load with ``model.load_state_dict(sd)``, which
    casts to the model's dtype.
    """
    out: Dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, child in node.items():
                walk(child, path + (str(k),))
            return
        key, arr = _leaf(path, node)
        if arr.dtype not in (np.float32, np.float16, np.float64):
            arr = arr.astype(np.float32)
        out[key] = torch.from_numpy(np.array(arr))   # a writable copy

    walk(params, ())
    return out
