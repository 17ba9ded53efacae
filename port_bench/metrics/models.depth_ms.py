"""Milliseconds a frame between CUDA events before the preprocess and after
the model's forward (resize, normalisation, ViT, DPT head), median over
steps outside the profiled part of the window."""

import statistics


def read(rec):
    xs = [s["depth_ms"] for s in rec["steps"]
          if "depth_ms" in s and not s.get("profiled")]
    return statistics.median(xs) if xs else None
