"""Attention's share of its roofline, in %: the operations of attention
proper at the cell's shapes, 4 B H S^2 D a layer (q k^T and the weighted
sum of values; bound by operations: bytes read and written are a few MB
against hundreds of GFLOP), over 989 TFLOP/s, divided by the device time
of the kernels launched between the end of each block's qkv product and
the start of its projection (the ``attention`` range of the trace)."""

def read(rec):
    tr = rec.get("trace") or {}
    secs = tr.get("range_device_s", {}).get("attention")
    calls = tr.get("range_calls", {}).get("attention")
    if not secs or not calls:
        return None
    cfg, (h, w) = rec["config"], rec["model_hw"]
    s = 1 + (h // cfg["patch_size"]) * (w // cfg["patch_size"])
    ops = 4.0 * rec["frames_per_step"] * s * s * cfg["hidden_size"]
    return 100.0 * calls * ops / rec["peak_flops"] / secs
