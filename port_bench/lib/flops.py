"""Operations of a Depth Anything V2 forward, counted from the
configuration's shapes, and the card's published peaks.

Only products count (matrix products, convolutions, attention's two
products), two operations a multiply-add, as a model's FLOPs are usually
counted; normalisation, activations, softmax and resizes are left out.
"""

from __future__ import annotations

# One H100 SXM, NVIDIA's data sheet, dense: bf16 tensor-core operations a
# second and HBM3 bytes a second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def tokens(cfg: dict, model_hw) -> int:
    p = cfg["patch_size"]
    return 1 + (model_hw[0] // p) * (model_hw[1] // p)


def attention_flops(cfg: dict, model_hw, frames: int) -> float:
    """One layer's attention proper: 4 B H S^2 D (q k^T and the weighted
    sum of values)."""
    s = tokens(cfg, model_hw)
    return 4.0 * frames * s * s * cfg["hidden_size"]


def vit_flops(cfg: dict, model_hw) -> float:
    """Encoder operations of one frame."""
    d, p = cfg["hidden_size"], cfg["patch_size"]
    s = tokens(cfg, model_hw)
    mlp = d * cfg["mlp_ratio"]
    patches = s - 1
    per_layer = (2.0 * s * d * 3 * d + 2.0 * s * d * d
                 + 2.0 * 2 * s * d * mlp) + attention_flops(cfg, model_hw, 1)
    return 2.0 * patches * d * 3 * p * p + cfg["num_hidden_layers"] * \
        per_layer


def _conv(h, w, cin, cout, k):
    return 2.0 * h * w * cin * cout * k * k


def dpt_flops(cfg: dict, model_hw) -> float:
    """Head operations of one frame."""
    p, d = cfg["patch_size"], cfg["hidden_size"]
    oc, f, hh = cfg["out_channels"], cfg["features"], cfg["head_hidden"]
    ph, pw = model_hw[0] // p, model_hw[1] // p
    h3, w3 = (ph + 1) // 2, (pw + 1) // 2
    sizes = [(4 * ph, 4 * pw), (2 * ph, 2 * pw), (ph, pw), (h3, w3)]
    ops = sum(_conv(ph, pw, d, c, 1) for c in oc)                # project
    ops += _conv(ph, pw, oc[0], oc[0], 4)                        # 4x up
    ops += _conv(ph, pw, oc[1], oc[1], 2)                        # 2x up
    ops += _conv(h3, w3, oc[3], oc[3], 3)                        # 2x down
    ops += sum(_conv(h, w, c, f, 3) for (h, w), c in zip(sizes, oc))
    # fusion blocks: residual units at their input size, the projection
    # at the upsampled size
    units = {3: 1, 2: 2, 1: 2, 0: 2}
    out_size = {3: sizes[2], 2: sizes[1], 1: sizes[0],
                0: (8 * ph, 8 * pw)}
    for i in (3, 2, 1, 0):
        h, w = sizes[i]
        ops += units[i] * 2 * _conv(h, w, f, f, 3)
        ops += _conv(*out_size[i], f, f, 1)
    h0, w0 = 8 * ph, 8 * pw
    ops += _conv(h0, w0, f, f // 2, 3)                           # conv1
    ops += _conv(ph * p, pw * p, f // 2, hh, 3)                  # conv2
    ops += _conv(ph * p, pw * p, hh, 1, 1)                       # conv3
    return ops


def model_flops(cfg: dict, model_hw) -> float:
    return vit_flops(cfg, model_hw) + dpt_flops(cfg, model_hw)


def insert_bytes(capacity: int, points: int) -> float:
    """Least bytes an insert moves: the map's rows (four int32) read once
    and written once, and the batch's points (xyz and rgb float32, a bool
    mask) read once."""
    return 2.0 * capacity * 16 + points * (12 + 12 + 1)
