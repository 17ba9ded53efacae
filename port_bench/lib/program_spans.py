"""The program's own span times, read from the program after the window.

While a profiler records, each ``txr.`` span of the port times itself
with a pair of CUDA events on its tensor's stream
(``txr_torch/utils/profiling.py:span_times``): its calls and device
milliseconds between its events, summed over the calls. In a traced run
of ``run.py`` the program records them over the window's profiled part,
the steps ``rec["trace"]["frames"]`` counts. The readers of the span
metrics read them here, as ``spans.program_counters`` reads the
counters; a program without ``span_times`` gives none.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional


def span_times() -> Dict[str, dict]:
    """The program's span times (one sync); empty where it keeps none."""
    from txr_torch.utils import profiling

    read = getattr(profiling, "span_times", None)
    return read() if read is not None else {}


def span_ms(names: Iterable[str]) -> Optional[float]:
    """Device milliseconds of the spans ``names``, summed; None where the
    program recorded none of them."""
    times = span_times()
    found = [times[n]["device_ms"] for n in names if n in times]
    return sum(found) if found else None


def ms_a_frame(rec: dict, names: Iterable[str]) -> Optional[float]:
    """``span_ms(names)`` over the frames of the window's profiled part."""
    frames = (rec.get("trace") or {}).get("frames")
    if not frames:
        return None
    ms = span_ms(names)
    return None if ms is None else ms / frames
