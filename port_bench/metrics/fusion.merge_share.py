"""Share of the rows the insert orders that it merges without sorting
them, in %: the program's counters ``fusion.rows_merged`` (the map's rows,
already in key order, each insert) over that plus ``fusion.rows_sorted``
(the rows it sorts). The program keeps them only while a profiler records,
so they sum over the inserts of the window's profiled part; a program that
keeps no ``fusion.rows_merged`` gives none."""

from port_bench.lib.spans import program_counters


def read(rec):
    if not (rec.get("trace") or {}).get("frames"):
        return None
    c = program_counters()
    merged = c.get("fusion.rows_merged")
    sorted_rows = c.get("fusion.rows_sorted")
    if not merged or sorted_rows is None:
        return None
    return 100.0 * merged / (merged + sorted_rows)
