"""Share of the heads' position-embedding lookups that reused a kept
embedding, in %: the program's counters ``models.head_pos_embed_hits``
over ``models.head_pos_embed_hits`` + ``models.head_pos_embed_misses``
(VGGT's DPT heads: the embedding after each projection and the tail's term
of conv2, each kept per grid and parameter state). The program keeps them
only while a profiler records, so they sum over the forwards of the
window's profiled part; a program that keeps neither gives none."""

from port_bench.lib.spans import program_counters


def read(rec):
    if not (rec.get("trace") or {}).get("frames"):
        return None
    c = program_counters()
    hits = c.get("models.head_pos_embed_hits", 0)
    misses = c.get("models.head_pos_embed_misses", 0)
    if not hits + misses:
        return None
    return 100.0 * hits / (hits + misses)
