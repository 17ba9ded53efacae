"""Device milliseconds a frame of the program's ``models.aggregator`` span
(VGGT's and StreamVGGT's frame / global pairs, the cache append and cached
attention among them), between the span's own CUDA events, over the
window's profiled part. A program that does not time its spans, or a model
without an aggregator, gives none."""

from port_bench.lib.program_spans import ms_a_frame


def read(rec):
    return ms_a_frame(rec, ["models.aggregator"])
