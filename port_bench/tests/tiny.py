"""A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds: the
same files, with the model narrowed to 64 wide and 2 layers, frames of
168 x 280 (an 84 x 140 model grid) and a map of 2^12 voxels."""

import copy

from port_bench.lib import spec


def tiny_cell(name: str) -> spec.Cell:
    c = spec.load_cell(name)
    c.config = dict(c.config, hidden_size=64, num_hidden_layers=2,
                    num_attention_heads=2, out_indices=[0, 0, 1, 1],
                    features=16, out_channels=[8, 16, 32, 32],
                    input_size=84)
    trf = copy.deepcopy(c.traffic)
    trf.update(frame_hw=[168, 280], pool_frames=4, check_first_steps=2)
    trf["map"]["capacity_log2"] = 12
    c.traffic = trf
    return c
