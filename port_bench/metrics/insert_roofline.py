"""The insert's share of its roofline, in %: its least bytes (the map's rows,
four int32, read once and written once; the batch's points, xyz and rgb
float32 and a bool mask, read once) over 3.35 TB/s, divided by the device
time of the kernels launched inside ``offset_map_insert`` (the ``insert``
range of the trace)."""

def read(rec):
    tr = rec.get("trace") or {}
    secs = tr.get("range_device_s", {}).get("insert")
    calls = tr.get("range_calls", {}).get("insert")
    if not secs or not calls:
        return None
    nbytes = 2.0 * rec["capacity"] * 16 + rec["points_per_step"] * 25
    return 100.0 * calls * nbytes / rec["peak_bytes"] / secs
