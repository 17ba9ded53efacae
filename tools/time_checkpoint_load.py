#!/usr/bin/env python3
"""Time ``txr_torch.models.checkpoint.load_checkpoint`` on a ViT-L-shaped
Depth Anything V2 checkpoint, on the CPU.

    python3 tools/time_checkpoint_load.py [--runs 3]

No weights can be downloaded, so the script synthesises the file: a
Hugging Face ``DepthAnythingForDepthEstimation`` at DA-V2-Large's published
dimensions (hidden 1024, 24 layers, 16 heads, neck 256/512/1024/1024,
fusion 256; ``transformers`` builds it with its own random init), saved as
one f32 ``.safetensors`` file in a temporary directory that is removed
afterwards. It then loads that file with ``load_checkpoint`` (read, rename
to the port's keys, fuse q/k/v) ``--runs`` times, and once more into a bf16
``DepthAnything`` with ``load_state_dict``. Prints one JSON object.

This is what ``DepthAnythingModel(checkpoint_path=...)`` pays at every
start; ``txr`` instead caches a converted copy of such a file
(``load_params_cached``), which the port does not need.
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import statistics
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from txr_torch.models.checkpoint import load_checkpoint  # noqa: E402
from txr_torch.models.depth_anything import build_model  # noqa: E402

VITL = dict(hidden=1024, layers=24, heads=16, out_indices=(5, 12, 18, 24),
            neck=(256, 512, 1024, 1024), fusion=256)


def hf_state_dict() -> dict:
    from transformers import (DepthAnythingConfig,
                              DepthAnythingForDepthEstimation)
    from transformers.models.dinov2 import Dinov2Config

    c = VITL
    bc = Dinov2Config(hidden_size=c["hidden"], num_hidden_layers=c["layers"],
                      num_attention_heads=c["heads"], patch_size=14,
                      image_size=518, layerscale_value=1.0,
                      out_indices=list(c["out_indices"]),
                      apply_layernorm=True, reshape_hidden_states=False)
    cfg = DepthAnythingConfig(
        backbone_config=bc, reassemble_hidden_size=c["hidden"],
        neck_hidden_sizes=list(c["neck"]), fusion_hidden_size=c["fusion"],
        head_hidden_size=32, patch_size=14,
        depth_estimation_type="relative", max_depth=1)
    torch.manual_seed(0)
    return DepthAnythingForDepthEstimation(cfg).eval().state_dict()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    from safetensors.torch import save_file

    with tempfile.TemporaryDirectory(prefix="ckpt_timing.") as tmp:
        path = os.path.join(tmp, "depth_anything_v2_vitl.safetensors")
        sd = hf_state_dict()
        n_params = sum(v.numel() for v in sd.values())
        save_file({k: v.contiguous() for k, v in sd.items()}, path)
        del sd
        size = os.path.getsize(path)
        times = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            state = load_checkpoint(path, VITL["layers"])
            times.append(time.perf_counter() - t0)
        model, _, _ = build_model("v2", "vitl", device="cpu",
                                  dtype=torch.bfloat16)
        t0 = time.perf_counter()
        model.load_state_dict(state)
        into_model = time.perf_counter() - t0
    print(json.dumps({
        "what": "load_checkpoint on a DA-V2-Large-shaped .safetensors (f32)",
        "file_bytes": size, "parameters": n_params, "tensors": len(state),
        "load_checkpoint_s": times,
        "load_checkpoint_median_s": statistics.median(times),
        "load_state_dict_into_bf16_model_s": into_model,
        "cpu": platform.processor() or platform.machine(),
        "cpu_count": os.cpu_count(), "torch_threads": torch.get_num_threads(),
        "torch": torch.__version__}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
