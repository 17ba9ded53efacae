"""Rows the insert sorts for each valid point it fuses: the program's
counters ``fusion.rows_sorted`` (map capacity plus batch rows, each
insert) over ``fusion.points_valid`` (the batch's mask summed on the
device). The program keeps them only while a profiler records, so they
sum over the inserts of the window's profiled part."""

from port_bench.lib.spans import program_counters


def read(rec):
    if not (rec.get("trace") or {}).get("frames"):
        return None
    c = program_counters()
    rows = c.get("fusion.rows_sorted")
    points = c.get("fusion.points_valid")
    if not rows or not points:
        return None
    return rows / points
