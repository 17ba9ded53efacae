#!/usr/bin/env python3
"""``chip_smoke.py``'s ``train_path`` phase alone on one CUDA card, or the
same model trained on three routes side by side.

    python3 tools/train_path_dev.py [--lr R --warmup N --total N]
    python3 tools/train_path_dev.py --witness [--lr R --warmup N --total N]
                                    [--frames F --steps S]

Without ``--witness``: builds the kernels and runs the phase (about a
minute with the build), its checks and its timings, printed as the phase's
JSON line. ``--lr``, ``--warmup`` and ``--total`` replace the phase's
``make_optimizer`` settings (``chip_smoke.TRAIN_OPT``); the phase still
fails unless the loss falls below the first.

``--witness``: the phase's seeded v2 / ViT-L (metric head) and batch, at
``--frames`` frames, trained ``--steps`` steps under the schedule given, on
three routes from the same weights: ``kernels`` (the attention and tail
kernels under bf16 autocast, as the phase), ``plain`` (``TXR_FUSED_HEAD=0``
and the plain attention under the same autocast) and ``f32`` (the plain
route without autocast: f32 throughout). One JSON line a route: the loss
and gradient norm of each step and, after each step, the prediction's range
and the share of its pixels within 1 % of the head's ends (0 and 20 m).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import time
from unittest import mock

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import txr_torch.train as train  # noqa: E402

ROUTES = {"kernels": ({}, {}, True),
          "plain": ({"TXR_FUSED_HEAD": "0"}, {"use_flash": False}, True),
          "f32": ({"TXR_FUSED_HEAD": "0"}, {"use_flash": False}, False)}
MAX_DEPTH = 20.0          # chip_smoke.train_model's head


def witness(route: str, frames: int, steps: int, opt_kw: dict) -> dict:
    env, kw, autocast = ROUTES[route]
    model, _, _ = chip_smoke.train_model(env, **kw)
    images, target, mask, _ = chip_smoke.train_batch(frames)
    opt = train.make_optimizer(**opt_kw)
    adam, sched = opt.init(model.parameters())
    state = train.TrainState(model, adam, sched)
    step = train.make_train_step(model, opt)
    # the f32 route: the step's forward without its bf16 autocast
    off = (contextlib.nullcontext() if autocast else mock.patch.object(
        train, "kernel_autocast", lambda _: contextlib.nullcontext()))
    losses, norms, preds = [], [], []
    with off:
        for _ in range(steps):
            state, loss = step(state, images, target, mask)
            losses.append(loss.item())
            norms.append(state.grad_norm.item())
            with torch.no_grad(), train.kernel_autocast("cuda"):
                pred = model(images).float()
            preds.append({
                "min": pred.min().item(), "max": pred.max().item(),
                "share_near_max": (pred > 0.99 * MAX_DEPTH).float().mean()
                .item(),
                "share_near_0": (pred < 0.01 * MAX_DEPTH).float().mean()
                .item()})
    out = {"phase": "train_witness", "route": route, "frames": frames,
           "optimizer": opt_kw, "losses": losses, "grad_norms": norms,
           "prediction_after_each_step": preds}
    del model, state, step, adam, sched
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float)
    ap.add_argument("--warmup", type=int)
    ap.add_argument("--total", type=int)
    ap.add_argument("--witness", action="store_true")
    ap.add_argument("--frames", type=int, default=1)
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_path_dev: no CUDA device is available", file=sys.stderr)
        return 2
    opt_kw = dict(chip_smoke.TRAIN_OPT)
    for key, value in (("lr", args.lr), ("warmup_steps", args.warmup),
                       ("total_steps", args.total)):
        if value is not None:
            opt_kw[key] = value
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    chip_smoke.kernels.build()
    chip_smoke.kernels.lib()
    chip_smoke.emit({"phase": "build", "seconds": time.perf_counter() - t0,
                     "nvidia_smi_name_power_limit": smi})
    if args.witness:
        for route in ROUTES:
            chip_smoke.emit({**witness(route, args.frames, args.steps,
                                       opt_kw),
                             "nvidia_smi_name_power_limit": smi})
        return 0
    chip_smoke.TRAIN_OPT.update(opt_kw)
    chip_smoke.train_path(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
