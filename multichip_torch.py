#!/usr/bin/env python3
"""The port's single-device compile check and multi-rank dry run, the
counterpart of ``__graft_entry__.py``.

    python3 multichip_torch.py [N]     # the dry run on N gloo ranks (4)

``entry()`` returns ``(fn, example_args)`` for the flagship forward: Depth
Anything V2 ViT-L at the 518x518 operating point in bf16, on the card
unless the caller names the CPU. ``dryrun_multichip(n)`` runs the whole
multi-rank path on n CPU ranks of a gloo group
(``txr_torch.parallel.launch.run_ranks``): ``txr``'s tiny model on a
(dp, tp) mesh (tp 2 when n is even), one sharded train step, then the
sharded depth -> fusion step and the exact merge of the per-rank maps.
"""

from __future__ import annotations

import sys
from typing import Optional, Union

import numpy as np
import torch


def entry(device: Optional[Union[str, torch.device]] = None):
    """(fn, example_args): ``fn(pixels)`` runs the v2 ViT-L model (seeded
    weights, bf16) on (1, 518, 518, 3) normalized pixels."""
    from txr_torch.core.device import resolve_device
    from txr_torch.models.depth_anything import build_model

    dev = resolve_device(device)
    model, _, _ = build_model("v2", "vitl", device=dev, dtype=torch.bfloat16,
                              generator=torch.Generator().manual_seed(0))

    @torch.no_grad()
    def fn(pixels: torch.Tensor) -> torch.Tensor:
        return model(pixels)

    return fn, (torch.zeros((1, 518, 518, 3), dtype=torch.bfloat16,
                            device=dev),)


def tiny_model():
    """``txr``'s dry-run model: hidden 64, 2 layers, 4 heads, DPT 32."""
    from txr_torch.models.depth_anything import DepthAnything
    from txr_torch.models.dpt import DPTConfig
    from txr_torch.models.vit import ViTConfig

    return DepthAnything(
        ViTConfig(hidden_size=64, num_layers=2, num_heads=4,
                  pos_embed_size=4, out_layers=(0, 0, 1, 1)),
        DPTConfig(features=32, out_channels=(16, 16, 32, 32),
                  head_hidden=16))


def _dryrun_body(rank: int, world: int) -> dict:
    """One rank of the dry run: a sharded train step, then the sharded
    fusion step and the merge."""
    from txr_torch.fusion.offset_map import offset_map_size
    from txr_torch.parallel.mesh import make_mesh, shard_batch
    from txr_torch.parallel.pipeline import (create_sharded_maps,
                                             make_sharded_fusion_step,
                                             merge_sharded_maps,
                                             stack_sharded_maps)
    from txr_torch.train import (init_train_state, make_optimizer,
                                 make_sharded_train_step)

    tp = 2 if world % 2 == 0 else 1
    dp = world // tp
    mesh = make_mesh(dp=dp, tp=tp)
    batch, h, w = dp * 2, 14 * 4, 14 * 4
    model = tiny_model()
    optimizer = make_optimizer(lr=1e-4)
    state = init_train_state(model, optimizer,
                             torch.Generator().manual_seed(0), device="cpu",
                             mesh=mesh)
    step = make_sharded_train_step(model, optimizer, mesh)
    images = shard_batch(torch.ones((batch, h, w, 3)), mesh)
    target = shard_batch(torch.full((batch, h, w), 2.0), mesh)
    mask = shard_batch(torch.ones((batch, h, w), dtype=torch.bool), mesh)
    state, loss = step(state, images, target, mask)
    loss = loss.item()
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")

    frames = shard_batch(torch.full((batch, h, w, 3), 0.5), mesh)
    fuse = make_sharded_fusion_step(model, (50.0, 50.0, w / 2.0, h / 2.0),
                                    min_depth=1e-4, max_depth=1e4)
    n = frames.shape[0]
    vm = create_sharded_maps(mesh, 2048, 0.05)
    vm = fuse(frames, torch.eye(3).expand(n, 3, 3), torch.zeros(n, 3),
              torch.ones(n), vm)
    merged = merge_sharded_maps(stack_sharded_maps(vm, mesh))
    n_vox = int(offset_map_size(merged))
    if n_vox <= 0:
        raise AssertionError("sharded fusion produced an empty map")
    return {"dp": dp, "tp": tp, "loss": loss, "voxels": n_vox,
            "step": state.step}


def dryrun_multichip(n_devices: int) -> list:
    """The multi-rank path on ``n_devices`` gloo CPU ranks; returns each
    rank's summary and prints rank 0's."""
    from txr_torch.parallel.launch import run_ranks

    out = run_ranks(_dryrun_body, int(n_devices))
    r = out[0]
    print(f"dryrun_multichip OK: mesh dp={r['dp']} tp={r['tp']}, one train "
          f"step (loss={r['loss']:.4f}) + sharded fusion step "
          f"({r['voxels']} voxels)")
    return out


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
