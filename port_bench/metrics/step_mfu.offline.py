"""The whole step's share of the card's bf16 peak, in %: the model's
operations a frame (ViT and DPT head, counted from the configuration's
shapes) times the frames the traced window completed, over the window's
seconds and 989 TFLOP/s."""

from port_bench.lib.flops import model_flops


def read(rec):
    if not rec["frames"] or rec["window_s"] <= 0:
        return None
    ops = model_flops(rec["config"], rec["model_hw"]) * rec["frames"]
    return 100.0 * ops / rec["window_s"] / rec["peak_flops"]
