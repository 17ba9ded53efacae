"""The operation and byte counts the per-layer metrics divide by, at known
shapes: by hand for ViT-L at 518 x 924, and against PyTorch's own count of
the reference model's products at a small size."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.lib import flops, spec, weights
from port_bench.reference import depth_anything_v2 as ref

VITL = spec.load_json(spec.BENCH_DIR / "configs" / "da2-vitl-metric.json")
DA2 = spec.architecture(VITL)


def test_tokens_of_1080p():
    assert DA2.tokens(VITL, (518, 924)) == 2443


def test_vitl_by_hand():
    s, d = 2443, 1024
    layer = 2 * s * d * (3 * d + d + 2 * 4 * d) + 4 * s * s * d
    want = 24 * layer + 2 * (s - 1) * d * 3 * 14 * 14
    assert DA2.vit_flops(VITL, (518, 924)) == pytest.approx(want,
                                                            rel=1e-12)
    assert DA2.layer_attention_flops(VITL, (518, 924), 8) == \
        8 * 4 * s * s * d
    assert DA2.attention_calls(VITL) == 24
    assert DA2.attention_flops(VITL, (518, 924), 8) == \
        24 * 8 * 4 * s * s * d
    assert DA2.step_flops(VITL, (518, 924), 1) == pytest.approx(2.5831e12,
                                                                rel=1e-4)
    assert DA2.step_flops(VITL, (518, 924), 8) == \
        8 * DA2.step_flops(VITL, (518, 924), 1)


def test_insert_bytes():
    assert flops.insert_bytes(1 << 21, 8 * 478632) == \
        2 * (1 << 21) * 16 + 8 * 478632 * 25


@pytest.mark.parametrize("hw", [(56, 84), (70, 98)])
def test_counts_match_the_reference_products(hw):
    cfg = dict(VITL, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, out_indices=[0, 0, 1, 1], features=16,
               out_channels=[8, 16, 32, 32])
    w = weights.make_weights(DA2, cfg, 1, "cpu", torch.float32)
    x = torch.zeros((1, 3) + hw)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.depth(x, w, cfg)
    assert counter.get_total_flops() == pytest.approx(
        DA2.step_flops(cfg, hw, 1), rel=1e-9)
