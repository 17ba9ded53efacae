"""A toy architecture for the harness's own tests, whose weight layout is
not Depth Anything's and whose every frame's depth depends on every frame
of its step, as cross-view attention makes it. Its program side is a small
module of its own (the port has no such model); its reference is
``reference/toy_crossview.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from port_bench.reference.toy_crossview import reference  # noqa: F401

# the control: the linear layers' weights rounded to int8 a row
CONTROL = "int8"
CENTRED = frozenset()


def leaves(cfg: dict) -> list:
    c, p = cfg["width"], cfg["patch_size"]
    out = [("stem.weight", (c, 3, p, p), 0.0, (3 * p * p) ** -0.5),
           ("stem.bias", (c,), 0.0, 0.02)]
    for i in range(cfg["layers"]):
        out += [(f"views.{i}.qkv.weight", (3 * c, c), 0.0, c ** -0.5),
                (f"views.{i}.qkv.bias", (3 * c,), 0.0, 0.02),
                (f"views.{i}.out.weight", (c, c), 0.0, c ** -0.5),
                (f"views.{i}.out.bias", (c,), 0.0, 0.02)]
    out += [("readout.weight", (1, c), 0.0, 0.5 * c ** -0.5),
            ("readout.bias", (1,), -1.0, 0.0)]
    return out


def model_grid(cfg: dict, frame_hw) -> tuple:
    """Half the frame, down to whole patches."""
    p = cfg["patch_size"]
    return tuple(max(v // 2 // p * p, p) for v in frame_hw)


def check_config(cfg: dict) -> None:
    if cfg["width"] % cfg["heads"]:
        raise ValueError("width is not a multiple of heads")


class View(nn.Module):
    def __init__(self, c: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(c, 3 * c)
        self.out = nn.Linear(c, c)

    def forward(self, t):
        n, c = t.shape[1], t.shape[2]
        q, k, v = self.qkv(t).reshape(1, n, 3, self.heads,
                                      c // self.heads).permute(2, 0, 3, 1, 4)
        att = torch.softmax(q @ k.transpose(-1, -2) *
                            (c // self.heads) ** -0.5, dim=-1)
        o = att @ v
        return self.out(o.transpose(1, 2).reshape(1, n, c))


class ToyCrossView(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        c, p = cfg["width"], cfg["patch_size"]
        self.max_depth = cfg["max_depth"]
        self.stem = nn.Conv2d(3, c, p, stride=p)
        self.views = nn.ModuleList(View(c, cfg["heads"])
                                   for _ in range(cfg["layers"]))
        self.readout = nn.Linear(c, 1)

    def forward(self, pixels):
        """(B, h, w, 3) -> depth (B, h, w)."""
        x = pixels.permute(0, 3, 1, 2)
        b, _, h, w = x.shape
        t = self.stem(x)
        ph, pw = t.shape[2:]
        t = t.flatten(2).transpose(1, 2).reshape(1, b * ph * pw, -1)
        for view in self.views:
            t = t + view(t)
        y = self.readout(t).reshape(b, ph, pw, 1).permute(0, 3, 1, 2)
        y = F.interpolate(y, size=(h, w), mode="bilinear",
                          align_corners=False)
        return torch.sigmoid(y[:, 0]) * self.max_depth


def build(cfg: dict, weights: dict, device, quant: str = "none"):
    model = ToyCrossView(cfg).to(device=device, dtype=torch.bfloat16)
    model.load_state_dict(weights, strict=True)
    if quant == "int8":
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, nn.Linear):
                    s = m.weight.abs().amax(1, keepdim=True) / 127
                    m.weight.copy_((m.weight / s).round() * s)
    return model.eval()


def attention_modules(model: ToyCrossView) -> list:
    return [(v.qkv, v.out) for v in model.views]


def tokens(cfg: dict, model_hw) -> int:
    p = cfg["patch_size"]
    return (model_hw[0] // p) * (model_hw[1] // p)


def attention_calls(cfg: dict) -> int:
    return cfg["layers"]


def attention_flops(cfg: dict, model_hw, frames: int) -> float:
    """Each layer attends over every token of the step: 4 T^2 C."""
    t = frames * tokens(cfg, model_hw)
    return cfg["layers"] * 4.0 * t * t * cfg["width"]


def step_flops(cfg: dict, model_hw, frames: int) -> float:
    c, p = cfg["width"], cfg["patch_size"]
    t = frames * tokens(cfg, model_hw)
    dense = 2.0 * t * c * (3 * c + c)
    return (2.0 * t * c * 3 * p * p + cfg["layers"] * dense
            + attention_flops(cfg, model_hw, frames) + 2.0 * t * c)
