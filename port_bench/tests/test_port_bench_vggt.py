"""The VGGT-1B configuration and its architecture: the published widths and
what ``check_config`` refuses, the model grid, the leaves against the
model's state dict, the operation counts by hand at 32 views of 294 x 518
and against PyTorch's count of the reference's products, and a tiny cell
run on the CPU to ``correct`` with its control not."""

import copy

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench.lib import check, spec, weights

CFG = spec.load_json(spec.BENCH_DIR / "configs" / "vggt-1b.json")
ARCH = spec.architecture(CFG)
TINY = dict(CFG, hidden_size=64, num_attention_heads=4, front_layers=2,
            aa_pairs=2, out_indices=[0, 1, 1, 1], features=16,
            out_channels=[8, 16, 32, 32], pos_embed_grid=4, camera_layers=2,
            camera_iterations=2)


def test_the_configuration_is_at_published_widths():
    assert CFG["architecture"] == "vggt"
    assert CFG["reduced"] == []
    assert {k: CFG[k] for k in (
        "hidden_size", "num_attention_heads", "mlp_ratio", "patch_size",
        "front_layers", "num_registers", "pos_embed_grid", "aa_pairs",
        "rope_freq", "out_indices", "features", "out_channels",
        "head_hidden", "camera_layers", "camera_iterations",
        "input_size")} == {
        "hidden_size": 1024, "num_attention_heads": 16, "mlp_ratio": 4,
        "patch_size": 14, "front_layers": 24, "num_registers": 4,
        "pos_embed_grid": 37, "aa_pairs": 24, "rope_freq": 100.0,
        "out_indices": [4, 11, 17, 23], "features": 256,
        "out_channels": [256, 512, 1024, 1024], "head_hidden": 32,
        "camera_layers": 4, "camera_iterations": 4, "input_size": 518}
    assert set(CFG["assumed"]) >= {
        "dtype", "weights", "depth", "poses", "views", "track_head",
        "front", "aggregator", "rope", "dpt_heads", "camera_head", "grid",
        "camera"}
    ARCH.check_config(CFG)
    for bad in (dict(CFG, hidden_size=1020, num_attention_heads=170),
                dict(CFG, out_indices=[4, 11, 17]),
                dict(CFG, out_indices=[4, 11, 17, 24]),
                dict(CFG, rope_freq=10000.0),
                dict(CFG, head_hidden=64),
                dict(CFG, camera_iterations=0)):
        with pytest.raises(ValueError):
            ARCH.check_config(bad)


def test_model_grid_is_vggt_crop_preprocessing():
    assert ARCH.model_grid(CFG, (1080, 1920)) == (294, 518)
    assert ARCH.model_grid(CFG, (480, 640)) == (392, 518)
    with pytest.raises(ValueError):
        ARCH.model_grid(CFG, (1920, 1080))            # would be cropped


def test_leaves_are_the_models_state_dict():
    from txr_torch.models.vggt import VGGT

    for cfg in (CFG, TINY):
        with torch.device("meta"):
            model = VGGT(ARCH.model_config(cfg))
        sd = model.state_dict()
        got = {n: s for n, s, _, _ in ARCH.leaves(cfg)}
        assert list(got) == list(dict.fromkeys(got))      # no name twice
        assert {n: tuple(t.shape) for n, t in sd.items()} == got
    n = sum(m * 1 for m in (torch.Size(s).numel()
                            for _, s, _, _ in ARCH.leaves(CFG)))
    assert n == pytest.approx(1.1906e9, rel=1e-3)


def test_vggt_1b_by_hand():
    """32 views of 782 tokens (777 patches, the camera token and 4
    registers): 24 front and 24 frame blocks of 4 B S^2 D, 24 global ones
    of 4 (B S)^2 D; every block's dense products as ViT-L's; two DPT heads
    from 2048 channels; the camera head's 4 iterations of a 4-block trunk
    2048 wide on 32 tokens."""
    s, d, v = 782, 1024, 32
    assert ARCH.tokens(CFG, (294, 518)) == s
    assert ARCH.attention_calls(CFG) == 72
    attention = 48 * 4 * v * s * s * d + 24 * 4 * (v * s) ** 2 * d
    assert ARCH.attention_flops(CFG, (294, 518), v) == attention
    assert 24 * 4 * (v * s) ** 2 * d == pytest.approx(61.56e12, rel=1e-3)
    dense = 72 * 2 * s * d * (3 * d + d + 2 * 4 * d) + \
        2 * 777 * d * 3 * 14 * 14
    ph, pw, f = 21, 37, 256
    head = 2 * ph * pw * 2 * d * (256 + 512 + 1024 + 1024)      # projections
    head += 2 * ph * pw * 256 * 256 * 16 + 2 * ph * pw * 512 * 512 * 4
    head += 2 * 11 * 19 * 1024 * 1024 * 9                     # resize_3
    head += 2 * f * 9 * (84 * 148 * 256 + 42 * 74 * 512 + 21 * 37 * 1024
                         + 11 * 19 * 1024)                     # scratch
    for (h, w), units, out in (((11, 19), 1, (21, 37)),
                               ((21, 37), 2, (42, 74)),
                               ((42, 74), 2, (84, 148)),
                               ((84, 148), 2, (168, 296))):
        head += units * 2 * 2 * h * w * f * f * 9
        head += 2 * out[0] * out[1] * f * f
    head += 2 * 168 * 296 * f * 128 * 9 + 2 * 294 * 518 * 128 * 32 * 9
    heads = 2 * head + 2 * 294 * 518 * 32 * (2 + 4)
    c = 2 * d
    trunk = 4 * (2 * v * c * (3 * c + c + 2 * 4 * c) + 4 * v * v * c)
    camera = 4 * (2 * v * 9 * c + 2 * v * c * 3 * c + trunk
                  + 2 * v * (c * c // 2 + c // 2 * 9))
    want = v * (dense + heads) + attention + camera
    got = ARCH.step_flops(CFG, (294, 518), v)
    assert got == pytest.approx(want, rel=1e-12)
    assert got == pytest.approx(121.7e12, rel=1e-3)
    assert 24 * 4 * (v * s) ** 2 * d / got == pytest.approx(0.506, abs=1e-3)
    aggregator = 24 * (v * 2 * 2 * s * d * 12 * d + 4 * v * s * s * d
                       + 4 * (v * s) ** 2 * d)
    assert aggregator / got == pytest.approx(0.770, abs=1e-3)
    assert camera == pytest.approx(0.0555e12, rel=1e-2)


@pytest.mark.parametrize("views", [1, 3])
def test_counts_match_the_reference_products(views):
    from port_bench.reference import vggt as ref

    w = weights.make_weights(ARCH, TINY, 1, "cpu", torch.float32)
    x = torch.zeros((views, 3, 56, 84))
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        ref.outputs(x, w, TINY)
    assert counter.get_total_flops() == pytest.approx(
        ARCH.step_flops(TINY, (56, 84), views), rel=1e-9)


def test_a_tiny_vggt_cell_is_correct_and_its_control_is_not():
    """The new cell's files at a CPU size (2 front blocks and 2 pairs of
    64, 4 views of 168 x 280 a step at 56 x 84, a map of 2^12): ``Run``,
    the window and ``check.judge`` give ``correct``; the int8 control fails
    a limit."""
    from port_bench.lib.bench import Run

    c = spec.load_cell("vggt-offline-v32")
    c.config = dict(TINY, input_size=84)
    trf = copy.deepcopy(c.traffic)
    trf.update(frame_hw=[168, 280], pool_frames=4, check_first_steps=2,
               frames_per_step=4)
    trf["map"]["capacity_log2"] = 12
    c.traffic = trf
    verdicts = []
    for quant in ("none", c.arch.CONTROL):
        run = Run(c, "cpu", quant=quant)
        run.prepare(2 ** 31 + 31)
        res = run.window(0.3, False)
        run.release()
        numbers = check.judge(run, res["checked"], control=quant != "none")
        verdicts.append(check.verdict(numbers, c.limits)[0])
    assert verdicts == [True, False]
