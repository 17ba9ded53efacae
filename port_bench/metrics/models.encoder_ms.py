"""Device milliseconds a frame of the program's ``models.encoder`` span
(the ViT encoder; VGGT's and StreamVGGT's DINOv2 front), between the
span's own CUDA events, over the window's profiled part. A program that
does not time its spans gives none."""

from port_bench.lib.program_spans import ms_a_frame


def read(rec):
    return ms_a_frame(rec, ["models.encoder"])
