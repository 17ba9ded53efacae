"""The card's published peaks, and the least bytes the insert moves.

What a model computes is its architecture's to count
(``archs/<architecture>.py``: ``step_flops``, ``attention_flops``).
"""

from __future__ import annotations

# One H100 SXM, NVIDIA's data sheet, dense: bf16 tensor-core operations a
# second and HBM3 bytes a second.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def insert_bytes(capacity: int, points: int) -> float:
    """Least bytes an insert moves: the map's rows (four int32) read once
    and written once, and the batch's points (xyz and rgb float32, a bool
    mask) read once."""
    return 2.0 * capacity * 16 + points * (12 + 12 + 1)
