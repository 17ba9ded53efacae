"""StreamVGGT (arXiv:2507.11539): VGGT-1B whose global attention is causal
over frames, streamed through a key / value cache of the global layers. A
step is one submap of ``cache_frames`` keyframes of one stream, in order:
the program's call resets its cache and runs the submap in chunks of
``stream_chunk_frames``, each chunk's queries against the cache of every
frame before it and its own frames up to their ends. The architecture of
every configuration that names ``"architecture": "streamvggt"``;
``spec.architecture`` says what such a file gives.

The weights are VGGT's (``archs/vggt.py``: the same leaves, laws and
centred depth conv, and the same model grid); the program side is the
port's public ``StreamVGGT`` (``txr_torch/models/vggt.py``); the reference
is ``reference/streamvggt.py``, VGGT's forward over the whole submap with
causal global blocks and camera trunk, no cache and no chunks.

Operations are counted as VGGT's are (products only, two a multiply-add),
with attention counted exactly under the frame-causal mask: a frame's P
queries against the P tokens of each frame up to its own, 4 P^2 D
n (n + 1) / 2 a global layer for n frames, and the camera trunk's n tokens
4 w n (n + 1) / 2 a layer. The camera head is counted once over the
submap, as the reference computes it; the program recomputes it over the
frames held at each chunk (a few GFLOP more a step).
"""

from __future__ import annotations

from dataclasses import fields
import torch

from port_bench.archs import vggt as base
from port_bench.reference.streamvggt import reference  # noqa: F401
from txr_torch.models.vggt import (HEAD_CHANNELS, POSE_DIM, StreamVGGT,
                                   StreamVGGTConfig)

# the control: the port's int8 route of the front's and the aggregator's
# dense layers
CONTROL = "int8p"

CENTRED = base.CENTRED
leaves = base.leaves
model_grid = base.model_grid
tokens = base.tokens
attention_modules = base.attention_modules


def check_config(cfg: dict) -> None:
    """Raises where the configuration's own keys cannot describe a model
    the program runs: VGGT's checks, then the stream's."""
    base.check_config(cfg)
    if cfg["causal"] != "frame":
        raise ValueError("StreamVGGT's global attention is causal over "
                         "frames: \"causal\" must be \"frame\"")
    if not 1 <= cfg["stream_chunk_frames"] <= cfg["cache_frames"]:
        raise ValueError("stream_chunk_frames must lie in 1 ... "
                         "cache_frames")


# ------------------------------------------------------------ the program

def model_config(cfg: dict, quant: str = "none") -> StreamVGGTConfig:
    v = base.model_config(cfg, quant)
    return StreamVGGTConfig(
        **{f.name: getattr(v, f.name) for f in fields(v)},
        stream_chunk_frames=cfg["stream_chunk_frames"],
        cache_frames=cfg["cache_frames"])


def build(cfg: dict, weights: dict, device, quant: str = "none"
          ) -> StreamVGGT:
    """The configuration's model on ``device`` holding ``weights`` in
    bfloat16 (``quant``: the port's int8 policy of the front's and the
    aggregator's dense layers, for the control). Its call maps a submap's
    frames to their depth; the other outputs are on ``model.outputs``. Its
    cache is allocated at the first chunk."""
    with torch.device("meta"):
        model = StreamVGGT(model_config(cfg, quant))
    model = model.to_empty(device=device).to(
        dtype=torch.bfloat16, memory_format=torch.channels_last)
    model.load_state_dict(weights, strict=True)
    return model.eval()


# ------------------------------------------------------------ the counts

def chunks(cfg: dict) -> int:
    """Chunks of a step: one submap of ``cache_frames`` frames."""
    return -(-cfg["cache_frames"] // cfg["stream_chunk_frames"])


def attention_calls(cfg: dict) -> int:
    """The kernel's calls a step: per chunk one a front block and two a
    pair (the frame block's and the global block's, the latter through
    the cached entry point); the camera trunk's take the plain route."""
    return chunks(cfg) * base.attention_calls(cfg)


def causal_frame_pairs(frames: int) -> int:
    """(query frame, key frame) pairs under the frame-causal mask."""
    return frames * (frames + 1) // 2


def cached_attention_flops(cfg: dict, model_hw, frames: int) -> float:
    """The global calls of a step of ``frames`` frames alone: 4 P^2 D for
    each pair of a query frame and a frame at or before it, each global
    layer."""
    s, d = tokens(cfg, model_hw), cfg["hidden_size"]
    return cfg["aa_pairs"] * 4.0 * s * s * d * causal_frame_pairs(frames)


def attention_flops(cfg: dict, model_hw, frames: int) -> float:
    """The kernel's calls of a step: 4 B S^2 D in each front block and
    frame block, and the global calls under the mask."""
    s, d = tokens(cfg, model_hw), cfg["hidden_size"]
    local = cfg["front_layers"] + cfg["aa_pairs"]
    return (local * 4.0 * frames * s * s * d
            + cached_attention_flops(cfg, model_hw, frames))


def camera_flops(cfg: dict, frames: int) -> float:
    """The camera head's products over ``frames`` frames once: per
    iteration the pose embedding, the modulation, the trunk (2 D wide,
    causal attention) and the pose branch."""
    w = 2 * cfg["hidden_size"]
    trunk = cfg["camera_layers"] * (
        base.block_dense_flops(cfg, frames, w)
        + 4.0 * w * causal_frame_pairs(frames))
    one = (2.0 * frames * POSE_DIM * w + 2.0 * frames * w * 3 * w + trunk
           + 2.0 * frames * (w * (w // 2) + (w // 2) * POSE_DIM))
    return cfg["camera_iterations"] * one


def step_flops(cfg: dict, model_hw, frames: int) -> float:
    """The model's operations for a step of ``frames`` frames of one
    submap."""
    heads = sum(base.head_flops(cfg, model_hw, n)
                for n in HEAD_CHANNELS.values())
    return (frames * (base.encoder_dense_flops(cfg, model_hw) + heads)
            + attention_flops(cfg, model_hw, frames)
            + camera_flops(cfg, frames))

