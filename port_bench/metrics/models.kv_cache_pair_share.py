"""Share of a streaming model's global-attention query-key pairs that read
the key / value cache, in %: the program's counters
``models.kv_pairs_cached`` (pairs of a chunk's queries with the rows of
earlier chunks) over that plus ``models.kv_pairs_fresh`` (pairs with the
chunk's own rows), both after the frame-causal mask. Fixed by the shapes
(74.4 for 4 chunks of 32 frames), so it says that the cache was read; a
program that recomputed past frames, or skipped the cache, would read 0.
The program keeps the counters only while a profiler records, so they sum
over the forwards of the window's profiled part; a program that keeps
neither gives none."""

from port_bench.lib.spans import program_counters


def read(rec):
    if not (rec.get("trace") or {}).get("frames"):
        return None
    c = program_counters()
    cached = c.get("models.kv_pairs_cached", 0)
    fresh = c.get("models.kv_pairs_fresh", 0)
    if not cached + fresh:
        return None
    return 100.0 * cached / (cached + fresh)
