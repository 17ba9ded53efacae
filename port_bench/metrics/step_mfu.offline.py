"""The whole step's share of the card's bf16 peak, in %: the model's
operations a step (the architecture's ``step_flops``, counted from the
configuration's shapes) times the steps the traced window completed, over
the window's seconds and 989 TFLOP/s."""


def read(rec):
    if not rec["frames"] or rec["window_s"] <= 0:
        return None
    ops = rec["step_flops"] * (rec["frames"] / rec["frames_per_step"])
    return 100.0 * ops / rec["window_s"] / rec["peak_flops"]
