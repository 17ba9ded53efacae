"""The DA3-LARGE any-view configuration and its architecture: the published
widths and what ``check_config`` refuses, the operation counts by hand at
16 views and against PyTorch's count of the reference's products, and a
tiny cell run on the CPU to ``correct`` with its control not."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.lib import check, spec, weights

VITL = spec.load_json(spec.BENCH_DIR / "configs" / "da2-vitl-metric.json")
DA2 = spec.architecture(VITL)
DA3L = spec.load_json(spec.BENCH_DIR / "configs" / "da3-large-anyview.json")
DA3 = spec.architecture(DA3L)


def test_the_da3_configuration_is_at_published_widths():
    assert DA3L["architecture"] == "depth_anything_3"
    assert DA3L["reduced"] == []
    assert {k: DA3L[k] for k in (
        "hidden_size", "num_hidden_layers", "num_attention_heads",
        "mlp_ratio", "patch_size", "features", "out_channels",
        "out_indices", "alt_start", "qknorm_start", "rope_start",
        "rope_freq")} == {
        "hidden_size": 1024, "num_hidden_layers": 24,
        "num_attention_heads": 16, "mlp_ratio": 4, "patch_size": 14,
        "features": 256, "out_channels": [256, 512, 1024, 1024],
        "out_indices": [11, 15, 19, 23], "alt_start": 8,
        "qknorm_start": 8, "rope_start": 8, "rope_freq": 100.0}
    assert set(DA3L["assumed"]) >= {"alternation", "qk_norm", "rope",
                                    "camera_token", "taken_layers", "head",
                                    "grid", "weights", "camera"}
    assert DA3.model_grid(DA3L, (1080, 1920)) == (518, 924)
    with pytest.raises(ValueError):
        DA3.check_config(dict(DA3L, hidden_size=1020,
                              num_attention_heads=170))     # 6 wide
    with pytest.raises(ValueError):
        DA3.check_config(dict(DA3L, alt_start=24))
    with pytest.raises(ValueError):
        DA3.check_config(dict(DA3L, rope_start=9))
    with pytest.raises(ValueError):
        DA3.check_config(dict(DA3L, out_indices=[11, 15, 19]))


def test_da3_large_by_hand():
    """16 views of 2443 tokens: 16 within-view layers of 4 B S^2 D, 8
    cross-view ones of 4 (B S)^2 D; the dense products as ViT-L's; the
    head's projections from 2048 channels and two fusion stacks and
    tails."""
    s, d, v = 2443, 1024, 16
    assert DA3.tokens(DA3L, (518, 924)) == s
    assert DA3.crossview_layers(DA3L) == 8
    assert DA3.attention_calls(DA3L) == 24
    attention = 16 * 4 * v * s * s * d + 8 * 4 * (v * s) ** 2 * d
    assert DA3.attention_flops(DA3L, (518, 924), v) == attention
    assert attention == pytest.approx(56.32e12, rel=1e-3)
    dense = 24 * 2 * s * d * (3 * d + d + 2 * 4 * d) + \
        2 * (s - 1) * d * 3 * 14 * 14
    ph, pw, f = 37, 66, 256
    head = 2 * ph * pw * 2 * d * (256 + 512 + 1024 + 1024)     # projections
    head += DA2.dpt_flops(VITL, (518, 924)) - \
        2 * ph * pw * d * (256 + 512 + 1024 + 1024)            # DA2's rest
    fusion = 0
    for (h, w), units, out in (((19, 33), 1, (37, 66)),
                               ((37, 66), 2, (74, 132)),
                               ((74, 132), 2, (148, 264)),
                               ((148, 264), 2, (296, 528))):
        fusion += units * 2 * 2 * h * w * f * f * 9
        fusion += 2 * out[0] * out[1] * f * f
    head += fusion                                             # ray fusion
    head += 2 * 296 * 528 * f * 128 * 9 + 2 * 518 * 924 * 128 * 32 * 9
    head += 2 * 518 * 924 * 32 * (2 + 7) - 2 * 518 * 924 * 32  # conv3s
    want = v * (dense + head) + attention
    assert DA3.step_flops(DA3L, (518, 924), v) == pytest.approx(want,
                                                                rel=1e-12)
    assert DA3.step_flops(DA3L, (518, 924), v) == pytest.approx(94.87e12,
                                                                rel=1e-3)


@pytest.mark.parametrize("views", [1, 3])
def test_da3_counts_match_the_reference_products(views):
    cfg = dict(DA3L, hidden_size=64, num_hidden_layers=4,
               num_attention_heads=4, alt_start=1, qknorm_start=1,
               rope_start=1, out_indices=[0, 1, 2, 3], features=16,
               out_channels=[8, 16, 32, 32])
    from port_bench.reference import depth_anything_3 as ref3

    w = weights.make_weights(DA3, cfg, 1, "cpu", torch.float32)
    x = torch.zeros((views, 3, 56, 84))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref3.outputs(x, w, cfg)
    assert counter.get_total_flops() == pytest.approx(
        DA3.step_flops(cfg, (56, 84), views), rel=1e-9)


def test_a_tiny_da3_cell_is_correct_and_its_control_is_not():
    """The new cell's files at a CPU size (8 layers of 64, cross-view from
    layer 2, 4 views of 168 x 280 a step, a map of 2^12): ``Run``, the
    window and ``check.judge`` give ``correct``; the int8 control fails a
    limit."""
    from port_bench.lib.bench import Run

    c = spec.load_cell("da3l-anyview-offline-v16")
    c.config = dict(c.config, hidden_size=64, num_hidden_layers=8,
                    num_attention_heads=4, alt_start=2, qknorm_start=2,
                    rope_start=2, out_indices=[3, 5, 6, 7], features=16,
                    out_channels=[8, 16, 32, 32], input_size=84)
    trf = copy.deepcopy(c.traffic)
    trf.update(frame_hw=[168, 280], pool_frames=4, check_first_steps=2,
               frames_per_step=4)
    trf["map"]["capacity_log2"] = 12
    c.traffic = trf
    verdicts = []
    for quant in ("none", c.arch.CONTROL):
        run = Run(c, "cpu", quant=quant)
        run.prepare(2 ** 31 + 29)
        res = run.window(0.3, False)
        run.release()
        numbers = check.judge(run, res["checked"], control=quant != "none")
        verdicts.append(check.verdict(numbers, c.limits)[0])
    assert verdicts == [True, False]
