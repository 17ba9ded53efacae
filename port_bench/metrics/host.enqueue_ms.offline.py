"""Host milliseconds to enqueue one step of the closed loop: the median of
the probe steps the traced run makes after its window, each on an idle
card (inside the window the host waits on a full launch queue, so its
step times are the card's)."""

import statistics


def read(rec):
    probes = rec.get("probe_enqueue_ms")
    return statistics.median(probes) if probes else None
