"""Share of the traced window, in %, in which no operation ran on the device:
one minus the union of kernel, copy and set intervals over the span from
the first to the last of them."""

def read(rec):
    tr = rec.get("trace") or {}
    if not tr.get("window_s"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
