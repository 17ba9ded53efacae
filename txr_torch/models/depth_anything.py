"""Depth Anything V1/V2/V3: registry, model, and inference API. The
counterpart of ``txr/models/depth_anything.py``.

- the same version/encoder registry MODEL_CONFIGS (v1 {vits,vitb,vitl},
  v2 {+vitg}, v3 {large}) with features/out_channels per entry,
- relative heads (ReLU disparity) and metric heads (sigmoid * max_depth),
- infer() with the DA lower-bound multiple-of-14 resize, bilinear
  (align_corners=True) upsample back to source resolution, and the V3
  focal-length scaling depth *= ((fx+fy)/2)/300.0.

Everything runs on the CUDA device unless the caller passes
``device="cpu"``. ``checkpoint_path`` reads ``.safetensors`` / ``.pth``
files in Hugging Face or original Depth-Anything naming, or a directory
written by ``txr_torch.models.checkpoint.save_params``; without it the model
starts from seeded random weights, as ``txr`` does without a checkpoint.
``quant`` selects the int8 policy of the encoder's dense layers, and the
environment variables ``TXR_FUSED_HEAD`` / ``TXR_FUSED_CONVS`` ("1" / "0")
force the head's kernels on or off, as in ``txr``.
"""

from __future__ import annotations

import logging
import math
import os
from dataclasses import replace
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from txr_torch.core.device import resolve_device
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.models.dpt import DPTConfig, DPTHead
from txr_torch.models.vit import VIT_PRESETS, ViTConfig, ViTEncoder
from txr_torch.ops.resize import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    compute_da_resize,
    resize_bicubic,
    resize_bilinear,
)

logger = logging.getLogger(__name__)

# Mirror of the reference registry.
MODEL_CONFIGS: Dict[str, Dict[str, Dict[str, Any]]] = {
    "v1": {
        "vits": {"encoder": "vits", "features": 64, "out_channels": [48, 96, 192, 384]},
        "vitb": {"encoder": "vitb", "features": 128, "out_channels": [96, 192, 384, 768]},
        "vitl": {"encoder": "vitl", "features": 256, "out_channels": [256, 512, 1024, 1024]},
    },
    "v2": {
        "vits": {"encoder": "vits", "features": 64, "out_channels": [48, 96, 192, 384]},
        "vitb": {"encoder": "vitb", "features": 128, "out_channels": [96, 192, 384, 768]},
        "vitl": {"encoder": "vitl", "features": 256, "out_channels": [256, 512, 1024, 1024]},
        "vitg": {"encoder": "vitg", "features": 384, "out_channels": [1536, 1536, 1536, 1536]},
    },
    "v3": {
        "large": {"encoder": "vitl", "features": 256, "out_channels": [256, 512, 1024, 1024]},
    },
}

# HF hub names per (version, encoder), relative heads.
HF_MODEL_MAP = {
    ("v1", "vits"): "LiheYoung/depth-anything-small-hf",
    ("v1", "vitb"): "LiheYoung/depth-anything-base-hf",
    ("v1", "vitl"): "LiheYoung/depth-anything-large-hf",
    ("v2", "vits"): "depth-anything/Depth-Anything-V2-Small-hf",
    ("v2", "vitb"): "depth-anything/Depth-Anything-V2-Base-hf",
    ("v2", "vitl"): "depth-anything/Depth-Anything-V2-Large-hf",
}


def hf_model_name(version: str, encoder: str, metric: bool = False,
                  dataset: str = "hypersim") -> Optional[str]:
    """HF checkpoint name, incl. metric Hypersim/VKITTI variants."""
    if metric and version == "v2":
        ds = "Hypersim" if dataset == "hypersim" else "VKITTI"
        size = {"vits": "Small", "vitb": "Base", "vitl": "Large"}.get(encoder)
        if size is None:
            return None
        return f"depth-anything/Depth-Anything-V2-Metric-{ds}-{size}-hf"
    return HF_MODEL_MAP.get((version, encoder))


class DepthAnything(nn.Module):
    """ViT encoder + DPT head operating on preprocessed (B, H, W, 3) input
    (``txr``'s DepthAnythingFlax)."""

    def __init__(self, vit: ViTConfig, dpt: DPTConfig):
        super().__init__()
        self.vit = vit
        self.dpt = dpt
        self.encoder = ViTEncoder(vit)
        self.head = DPTHead(dpt, vit.hidden_size)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        ph = pixels.shape[1] // self.vit.patch_size
        pw = pixels.shape[2] // self.vit.patch_size
        hidden = self.encoder(pixels)
        return self.head(hidden, ph, pw, self.vit.patch_size)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded random weights in the manner of ``txr``'s init: kernels
        normal with variance 1/fan_in, position embeddings normal(0.02),
        biases and the cls token zero, LayerScale at its configured value,
        LayerNorm at identity. Drawn on the generator's device and copied to
        the parameters'."""
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "pos_embed":
                std = 0.02
            elif leaf == "weight" and p.dim() >= 2:
                fan_in = p[0].numel()
                if "resize_0" in name or "resize_1" in name:
                    # ConvTranspose2d weight is (in, out, kh, kw)
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                std = 1.0 / math.sqrt(fan_in)
            elif leaf in ("ls1", "ls2"):
                p.fill_(float(self.vit.layerscale_init))
                continue
            elif leaf == "weight":          # LayerNorm scale
                p.fill_(1.0)
                continue
            else:                           # biases, cls token
                p.zero_()
                continue
            draw = torch.randn(p.shape, generator=generator,
                               device=generator.device, dtype=torch.float32)
            p.copy_((draw * std).to(device=p.device, dtype=p.dtype))


def build_model(version: str = "v2", encoder: str = "vitl",
                metric: bool = False, max_depth: float = 20.0,
                use_flash: Optional[bool] = None, quant: str = "none",
                device: Optional[Union[str, torch.device]] = None,
                dtype: torch.dtype = torch.float32,
                generator: Optional[torch.Generator] = None,
                ) -> Tuple[DepthAnything, ViTConfig, DPTConfig]:
    """Construct the model for a registry entry on ``device`` (``None``:
    the CUDA device) with weights drawn from ``generator`` (``None``: a CPU
    generator seeded with 0) and cast to ``dtype``.

    ``TXR_FUSED_HEAD`` and ``TXR_FUSED_CONVS`` set to "1" or "0" force
    ``DPTConfig.fused_head`` / ``fused_convs`` on or off; unset (or any
    other value) leaves the config defaults."""
    dev = resolve_device(device)
    version = version.lower()
    # v3's registry keys its large model "large"; accept both spellings.
    if version == "v3" and encoder == "vitl":
        encoder = "large"
    cfg = MODEL_CONFIGS.get(version, {}).get(encoder)
    if cfg is None:
        raise ValueError(
            f"Invalid version/encoder combination: {version}/{encoder}")
    vit = VIT_PRESETS[cfg["encoder"]]
    if use_flash is not None:
        vit = replace(vit, use_flash=use_flash)
    if quant != "none":
        vit = replace(vit, quant=quant)
    knob = {"1": True, "0": False}
    dpt = DPTConfig(
        features=cfg["features"],
        out_channels=tuple(cfg["out_channels"]),
        metric=metric,
        max_depth=max_depth,
        fused_head=knob.get(os.environ.get("TXR_FUSED_HEAD", "")),
        fused_convs=knob.get(os.environ.get("TXR_FUSED_CONVS", "")),
    )
    model = DepthAnything(vit, dpt)
    if generator is None:
        generator = torch.Generator(device="cpu").manual_seed(0)
    model.init_weights(generator)
    model = model.to(device=dev, dtype=dtype,
                     memory_format=torch.channels_last)
    return model.eval(), vit, dpt


class DepthAnythingModel:
    """Inference wrapper with the reference's API shape.

    infer(bgr_image, intrinsics) -> (H, W) float32 depth: relative disparity
    or metric meters.

    ``txr`` holds bf16 parameters but feeds f32 pixels, which its layers
    promote to f32 arithmetic; PyTorch does not mix dtypes, so here pixels
    are cast to ``param_dtype`` and the network runs in that type.
    """

    def __init__(
        self,
        version: str = "v2",
        encoder: str = "vitl",
        checkpoint_path: Optional[str] = None,
        metric: bool = False,
        max_depth: float = 20.0,
        dataset: str = "hypersim",
        input_size: int = 518,
        focal_length_ref: float = 300.0,
        param_dtype: torch.dtype = torch.bfloat16,
        use_flash: Optional[bool] = None,
        quant: str = "none",
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
    ):
        self.device = resolve_device(device)
        self.version = version.lower()
        self.encoder = encoder
        self.metric = metric
        self.max_depth = max_depth
        self.dataset = dataset
        self.input_size = input_size
        self.focal_length_ref = focal_length_ref
        self.param_dtype = param_dtype

        gen = torch.Generator(device="cpu").manual_seed(seed)
        self.model, self.vit_cfg, self.dpt_cfg = build_model(
            version, encoder, metric, max_depth, use_flash, quant=quant,
            device=self.device, dtype=param_dtype, generator=gen)
        if checkpoint_path:
            from txr_torch.models.checkpoint import load_checkpoint

            # load_state_dict copies into the parameters, so the tensors land
            # on the model's device in its dtype
            self.model.load_state_dict(
                load_checkpoint(checkpoint_path, self.vit_cfg.num_layers))
            logger.info("Loaded checkpoint from %s", checkpoint_path)
        else:
            logger.warning(
                "No checkpoint provided or found, using uninitialized model")

    @torch.no_grad()
    def _forward(self, rgb_u8: torch.Tensor, in_h: int, in_w: int,
                 out_h: int, out_w: int) -> torch.Tensor:
        """ONE preprocess/forward/postprocess body for both the single-frame
        and batched paths: (B, H, W, 3) uint8 RGB -> (B, out_h, out_w)."""
        x = rgb_u8.to(torch.float32) / 255.0
        x = resize_bicubic(x, in_h, in_w, align_corners=False)
        mean = x.new_tensor(IMAGENET_MEAN)
        std = x.new_tensor(IMAGENET_STD)
        x = ((x - mean) / std).to(self.param_dtype)
        depth = self.model(x).to(torch.float32)          # (B, in_h, in_w)
        return resize_bilinear(depth[..., None], out_h, out_w,
                               align_corners=True)[..., 0]

    def infer(self, image: np.ndarray,
              intrinsics: Optional[CameraIntrinsics] = None) -> np.ndarray:
        """BGR uint8 (H, W, 3) -> depth (H, W) float32 at source resolution."""
        return self.infer_batch(image[None], intrinsics)[0]

    def infer_batch(self, images: np.ndarray,
                    intrinsics: Optional[CameraIntrinsics] = None
                    ) -> np.ndarray:
        """Batched inference: (B, H, W, 3) BGR uint8 -> (B, H, W) depth."""
        h, w = images.shape[1:3]
        in_h, in_w = compute_da_resize(h, w, self.input_size)
        rgb = torch.from_numpy(np.ascontiguousarray(images[..., ::-1]))
        depth = self._forward(rgb.to(self.device), in_h, in_w, h, w)
        depth = depth.cpu().numpy().astype(np.float32)
        # V3 focal-length scaling.
        if self.version == "v3" and intrinsics is not None:
            focal_pixels = (intrinsics.fx + intrinsics.fy) / 2.0
            depth = depth * np.float32(focal_pixels / self.focal_length_ref)
        return depth


class DepthEstimator:
    """Reference-named facade: estimate(bgr) / estimate_batch(list) on the
    DA-V2-Large operating point."""

    def __init__(self, model_name: Optional[str] = None,
                 device: Optional[Union[str, torch.device]] = None, **kwargs):
        # model_name kept for signature parity; the registry entry it mapped
        # to (Depth-Anything-V2-Large) is the default here.
        self.model = DepthAnythingModel(version="v2", encoder="vitl",
                                        device=device, **kwargs)

    def estimate(self, bgr: np.ndarray) -> np.ndarray:
        return self.model.infer(bgr)

    def estimate_batch(self, images) -> list:
        if len({im.shape for im in images}) == 1:
            return list(self.model.infer_batch(np.stack(images)))
        return [self.model.infer(im) for im in images]
