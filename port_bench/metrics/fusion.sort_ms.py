"""Device milliseconds a frame of the program's ``fusion.insert.sort``
span (the sort of the batch's keys and the merge kernel into the map's
rows), between the span's own CUDA events, over the window's profiled
part. A program that does not time its spans gives none."""

from port_bench.lib.program_spans import ms_a_frame


def read(rec):
    return ms_a_frame(rec, ["fusion.insert.sort"])
