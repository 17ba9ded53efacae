"""Device milliseconds a frame of the program's DPT heads: the spans
``models.head`` (the depth head; Depth Anything 3's ray branch
``models.head.ray`` nests in it and is not added) and ``models.head.points``
(VGGT's point head, beside it), between their own CUDA events, over the
window's profiled part. A program that does not time its spans gives
none."""

from port_bench.lib.program_spans import ms_a_frame


def read(rec):
    return ms_a_frame(rec, ["models.head", "models.head.points"])
