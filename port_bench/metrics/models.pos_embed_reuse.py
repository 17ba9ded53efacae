"""Share of the encoder's resized position-embedding lookups that reused
the kept resize, in %: the program's counters ``models.pos_embed_hits``
over ``models.pos_embed_hits`` + ``models.pos_embed_misses``. The program
keeps them only while a profiler records, so they sum over the forwards
of the window's profiled part; a program that keeps neither gives none."""

from port_bench.lib.spans import program_counters


def read(rec):
    if not (rec.get("trace") or {}).get("frames"):
        return None
    c = program_counters()
    hits = c.get("models.pos_embed_hits", 0)
    misses = c.get("models.pos_embed_misses", 0)
    if not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
