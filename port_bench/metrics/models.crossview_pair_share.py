"""Share of the encoder's attention query-key pairs that cross views, in %:
the program's counters ``models.attention_pairs_crossview`` over that plus
``models.attention_pairs_local`` (B S^2 summed over each kind of call).
Fixed by the shapes, so it says that cross-view attention ran. The
program keeps the counters only while a profiler records, so they sum
over the forwards of the window's profiled part; a program that keeps
neither gives none."""

from port_bench.lib.spans import program_counters


def read(rec):
    if not (rec.get("trace") or {}).get("frames"):
        return None
    c = program_counters()
    cross = c.get("models.attention_pairs_crossview", 0)
    local = c.get("models.attention_pairs_local", 0)
    if not cross + local:
        return None
    return 100.0 * cross / (cross + local)
