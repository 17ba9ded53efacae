"""The attention kernel's cached entry point's share of its roofline, in
%: the operations of a step's global calls under the frame-causal mask
(the architecture's ``cached_attention_flops``, counted from the cell's
shapes; bound by operations) times the traced steps, over 989 TFLOP/s,
divided by the device time of the entry point's kernel
(``attention_cached_kernel``) in the trace's time by name. A program or an
architecture without it gives none."""

from port_bench.lib import spec

KERNEL = "attention_cached_kernel"


def read(rec):
    tr = rec.get("trace") or {}
    secs = sum(t for name, t in tr.get("by_name", []) if KERNEL in name)
    frames = tr.get("frames")
    if not secs or not frames:
        return None
    count = getattr(spec.architecture(rec["config"]),
                    "cached_attention_flops", None)
    if count is None:
        return None
    b = rec["frames_per_step"]
    ops = frames / b * count(rec["config"], rec["model_hw"], b)
    return 100.0 * ops / rec["peak_flops"] / secs
