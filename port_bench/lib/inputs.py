"""Inputs made from the seed: frames, and the schedule of frames and poses.

Every stream of random numbers has its own generator, seeded from the run's
seed and the stream's number, so one seed gives the same inputs whatever
the card's speed. The work a step does is set by the traffic file alone;
the seed chooses only values and order.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WEIGHTS, FRAMES, ORDER, SAMPLE = range(4)


def stream_seed(seed: int, stream: int) -> int:
    return (seed * 1_000_003 + stream * 7_919) % (1 << 62)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def make_frames(n: int, hw, seed: int, device) -> torch.Tensor:
    """(n, H, W, 3) uint8 camera frames: a smooth colour field (coarse noise
    on a 64-pixel grid, upsampled) with fine noise on top."""
    h, w = hw
    g = generator(seed, FRAMES, device)
    coarse = torch.rand((n, 3, h // 64 + 2, w // 64 + 2), generator=g,
                        device=device)
    img = F.interpolate(coarse, size=(h, w), mode="bilinear",
                        align_corners=False) * 200.0
    img += torch.rand((n, 3, h, w), generator=g, device=device) * 55.0
    return img.to(torch.uint8).permute(0, 2, 3, 1).contiguous()


def frame_order(count: int, pool: int, seed: int) -> np.ndarray:
    """Which pool frame each frame of the run shows."""
    rng = np.random.default_rng(stream_seed(seed, ORDER))
    return rng.integers(0, pool, size=count)


class PoseTable:
    """World-to-camera (R, t) of ``frames_per_step`` frames from frame
    ``first`` on: the camera looks along the tunnel axis (world z) and frame
    i stands at z = advance * i, so X_w = X_c + (0, 0, advance * i). Made on
    the card without a copy from the host: the frame index enters as a
    scalar argument of the kernels."""

    def __init__(self, frames_per_step: int, advance: float, device):
        self.advance = advance
        self.R = torch.eye(3, device=device).expand(frames_per_step, 3, 3)
        self.ar = torch.arange(frames_per_step, device=device,
                               dtype=torch.float32)
        self.zero = torch.zeros((frames_per_step, 2), device=device)

    def at(self, first: int) -> tuple:
        tz = (self.ar + float(first)) * (-self.advance)
        return self.R, torch.cat([self.zero, tz[:, None]], dim=1)


def sample_step(seed: int, first_steps: int) -> int:
    """The step, among the first ``first_steps``, whose outputs the check
    reads besides the window's last."""
    rng = np.random.default_rng(stream_seed(seed, SAMPLE))
    return int(rng.integers(0, max(1, first_steps)))
