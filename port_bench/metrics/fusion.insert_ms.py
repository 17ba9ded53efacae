"""Milliseconds a frame between CUDA events around ``offset_map_insert``
(pack, sort, fused reduce), median over steps outside the profiled part of
the window."""

import statistics


def read(rec):
    xs = [s["insert_ms"] for s in rec["steps"]
          if "insert_ms" in s and not s.get("profiled")]
    return statistics.median(xs) if xs else None
