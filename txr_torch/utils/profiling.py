"""Profiling and throughput instrumentation, the counterpart of
``txr/utils/profiling.py``.

``maybe_trace`` records a ``torch.profiler`` trace of the block (host and,
when a card is present, its kernels) as a Chrome trace under
``$TXR_TRACE_DIR/<name>/trace.json`` when ``TXR_TRACE_DIR`` is set, and
does nothing otherwise. ``FPSCounter`` is the reference's frames-per-second
counter with its every-N logging contract.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def maybe_trace(name: str = "txr"):
    """Trace the block with ``torch.profiler`` when TXR_TRACE_DIR is set.

    View with chrome://tracing or https://ui.perfetto.dev."""
    trace_dir = os.environ.get("TXR_TRACE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = os.path.join(trace_dir, name)
    os.makedirs(path, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    out = os.path.join(path, "trace.json")
    prof.export_chrome_trace(out)
    logger.info("torch.profiler trace -> %s", out)


class FPSCounter:
    """Wall-clock FPS with every-N logging (reference contract)."""

    def __init__(self, log_every: int = 10, name: str = "pipeline"):
        self.log_every = log_every
        self.name = name
        self.count = 0
        self.start = time.time()

    def tick(self) -> float:
        self.count += 1
        elapsed = max(time.time() - self.start, 1e-9)
        fps = self.count / elapsed
        if self.count % self.log_every == 0:
            logger.info("%s: processed %d frames (%.1f fps)",
                        self.name, self.count, fps)
        return fps

    def summary(self) -> str:
        elapsed = max(time.time() - self.start, 1e-9)
        return (f"{self.name}: {self.count} frames in {elapsed:.1f}s "
                f"({self.count / elapsed:.1f} fps)")
