"""Attention's share of its roofline, in %, from the program alone: its
counter ``models.attention_flops`` (4 H D times the query-key pairs each
attention call computes, summed over every call: within-view, cross-view,
cached, and the plain calls of VGGT's camera trunk) over 989 TFLOP/s,
divided by the device seconds of the spans around those calls,
``models.encoder.attention``, ``models.encoder.crossview`` and
``models.encoder.cached``, between their own CUDA events. Both are kept
over the window's profiled part; a program without the counter or the
span times gives none."""

from port_bench.lib.program_spans import span_ms
from port_bench.lib.spans import program_counters

SPANS = ("models.encoder.attention", "models.encoder.crossview",
         "models.encoder.cached")


def read(rec):
    if not (rec.get("trace") or {}).get("frames"):
        return None
    ms = span_ms(SPANS)
    ops = program_counters().get("models.attention_flops")
    if not ms or not ops:
        return None
    return 100.0 * ops / rec["peak_flops"] / (ms * 1e-3)
