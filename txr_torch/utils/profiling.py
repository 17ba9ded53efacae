"""Spans, counters and the Chrome-trace exporter: the port's tracing, the
counterpart of ``txr/utils/profiling.py``.

``span(name, on)`` is one shared no-op context unless a profiler is
recording, so the layers of the main path (the encoder, its attention,
the head; the insert's pack, sort and reduce; in Depth Anything 3's
any-view model also the QK-norm and RoPE ``models.encoder.qk_prep``, the
cross-view attention calls ``models.encoder.crossview`` apart from the
within-view ``models.encoder.attention``, and the head's ray branch
``models.head.ray``; in VGGT the front as ``models.encoder``, the
aggregator ``models.aggregator`` around its blocks' attention, QK-norm /
RoPE and cross-view spans, ``models.camera_head``, the depth head as
``models.head`` and the point head ``models.head.points``) carry their
ranges at no cost when nobody traces. While a profiler records, a span is
a ``torch.profiler`` range named ``txr.<name>``, and, unless a CUDA
stream is capturing, it also times itself: a timing mark at entry and one
at exit on the current stream of ``on``'s device (a tensor), CUDA events
on the card, the host's clock for a CPU tensor or none.
Ranges nest as the calls do; neither a range nor a mark launches a
kernel, and nothing is marked while a stream captures, so a CUDA-graph
capture is unaffected. A range is recorded as a host operation
(``_RecordFunctionFast``), not as a user annotation (``record_function``):
it adds no range to the device's timeline, which a reading of the trace
would count as device work, and the kernels the port launches itself
(``txr_torch._cuda``, outside any PyTorch operation) are linked to the
innermost span that launched them.

``span_times()`` waits for the marks once and gives each span's calls
and milliseconds between its marks, summed over its calls: the device's
time on the card, the host's on the CPU. A nested span counts its own
interval, which its parent's contains. Marks come from a pool per device:
a span whose marks have been passed returns them when a mark is next
wanted and the pool is empty, or at ``span_times()``, so a traced loop
creates marks for the steps in flight only.

``count(name, value)`` adds a host int or a 0-d tensor to the counter
``name``, again only while a profiler is recording and never while a CUDA
stream is capturing. Tensor values are summed on their device, one int64
tensor per name, and read with one sync by ``counters()``;
``reset_counters()`` clears them all and the spans' times. The main path
keeps ``models.pos_embed_hits`` / ``models.pos_embed_misses`` (host ints:
each resized position-embedding lookup the encoder reused or recomputed,
``models/vit.py``), ``models.attention_pairs_local`` /
``models.attention_pairs_crossview`` (host ints: the query-key pairs of
each within-view and cross-view attention call, B S^2, ``models/vit.py``)
and ``models.attention_flops`` (host int: 4 H D times those pairs, every
attention call), ``models.head_pos_embed_hits`` /
``models.head_pos_embed_misses`` (host ints: each of VGGT's heads' kept
position embeddings and tail terms reused or recomputed,
``models/dpt.py``), ``models.upsample_kernel_calls`` /
``models.upsample_plain_calls`` (host ints: each bilinear resize of a DPT
head through the kernel or the plain version, ``models/dpt.py``) and
``fusion.rows_sorted`` / ``fusion.rows_merged`` /
``fusion.points_valid`` (the insert's rows sorted, the map's rows merged
with them unsorted, and the batch's mask summed on its device,
``fusion/offset_map.py``).

``maybe_trace`` records a ``torch.profiler`` trace of the block (host and,
when a card is present, its kernels, with the ``txr.*`` spans) as a Chrome
trace under ``$TXR_TRACE_DIR/<name>/trace.json`` when ``TXR_TRACE_DIR`` is
set, and does nothing otherwise.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple, Union

import torch
import torch.autograd.profiler as _profiler

logger = logging.getLogger(__name__)

PREFIX = "txr."
_OFF = contextlib.nullcontext()
_Range = torch._C._profiler._RecordFunctionFast

_host_counts: Dict[str, int] = {}
_device_counts: Dict[str, torch.Tensor] = {}

# the spans' marks: closed spans in the order they closed, (name, device,
# start, end), until their marks are passed; the sums of those read; the
# marks free for the next span, by device (None: the host's clock)
_span_marks: Deque[Tuple[str, Optional[torch.device], object, object]] = \
    deque()
_span_sums: Dict[str, List] = {}
_mark_pool: Dict[Optional[torch.device], List] = {}


def _capturing() -> bool:
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def recording() -> bool:
    """Whether counters are kept: a ``torch.profiler`` records in this
    process and no CUDA stream is capturing."""
    return _profiler._is_profiler_enabled and not _capturing()


def span(name: str, on: Optional[torch.Tensor] = None):
    """The range ``txr.<name>`` while a profiler records, timed on the
    current stream of ``on``'s device unless a stream is capturing; a
    no-op else."""
    if _profiler._is_profiler_enabled:
        if _capturing():
            return _Range(PREFIX + name)
        return _TimedSpan(name, on)
    return _OFF


class _HostMark:
    """A CPU span's timing mark, read as a CUDA event is: the host's clock
    at ``record``."""

    __slots__ = ("ns",)

    def record(self, stream=None) -> None:
        self.ns = time.perf_counter_ns()

    def query(self) -> bool:
        return True

    def elapsed_time(self, end: "_HostMark") -> float:
        return (end.ns - self.ns) * 1e-6


def _new_mark(dev: Optional[torch.device]):
    if dev is None:
        return _HostMark()
    return torch.cuda.Event(enable_timing=True)


def _mark(dev: Optional[torch.device]):
    """A mark recorded now on ``dev``'s current stream, from the pool."""
    free = _mark_pool.setdefault(dev, [])
    if not free:
        _fold(wait=False)
    m = free.pop() if free else _new_mark(dev)
    m.record(None if dev is None else torch.cuda.current_stream(dev))
    return m


def _fold(wait: bool) -> None:
    """Add the closed spans whose marks have been passed (all of them with
    ``wait``, the caller having synchronised) to the sums, oldest first,
    and return their marks to the pool. A span's two marks are on one
    stream, so its end passed means its start did."""
    while _span_marks:
        name, dev, start, end = _span_marks[0]
        if not wait and not end.query():
            return
        _span_marks.popleft()
        acc = _span_sums.setdefault(name, [0, 0.0])
        acc[0] += 1
        acc[1] += start.elapsed_time(end)
        _mark_pool.setdefault(dev, []).extend((start, end))


class _TimedSpan:
    """A recording span: the range and a mark at each end."""

    __slots__ = ("name", "dev", "range", "start")

    def __init__(self, name: str, on):
        self.name = name
        self.dev = on.device if on is not None and on.is_cuda else None
        self.range = _Range(PREFIX + name)

    def __enter__(self):
        self.range.__enter__()
        self.start = _mark(self.dev)
        return self

    def __exit__(self, *exc):
        _span_marks.append((self.name, self.dev, self.start,
                            _mark(self.dev)))
        return self.range.__exit__(*exc)


def span_times() -> Dict[str, Dict[str, float]]:
    """Each span's calls and milliseconds between its marks since the last
    ``reset_counters()``, summed (device time on the card, host time on
    the CPU); waits once for the card."""
    devs = {d for _, d, _, _ in _span_marks if d is not None}
    for d in devs:
        torch.cuda.synchronize(d)
    _fold(wait=True)
    return {k: {"calls": v[0], "device_ms": v[1]}
            for k, v in _span_sums.items()}


def count(name: str, value: Union[int, torch.Tensor]) -> None:
    """Add ``value`` (a host int or a 0-d tensor) to the counter ``name``
    while a profiler records and no stream is capturing."""
    if not recording():
        return
    if isinstance(value, torch.Tensor):
        acc = _device_counts.get(name)
        if acc is None:
            _device_counts[name] = value.detach().to(torch.int64).clone()
        else:
            acc.add_(value.detach())
    else:
        _host_counts[name] = _host_counts.get(name, 0) + int(value)


def counters() -> Dict[str, int]:
    """Every counter's total; tensor counters are read together, one
    device-to-host copy for all of them."""
    out = dict(_host_counts)
    if _device_counts:
        names = list(_device_counts)
        by_device: Dict[torch.device, list] = {}
        for n in names:
            by_device.setdefault(_device_counts[n].device, []).append(n)
        for group in by_device.values():
            vals = torch.stack([_device_counts[n] for n in group]).tolist()
            for n, v in zip(group, vals):
                out[n] = out.get(n, 0) + int(v)
    return out


def reset_counters() -> None:
    """Clear every counter and the spans' times."""
    _host_counts.clear()
    _device_counts.clear()
    while _span_marks:
        _, dev, start, end = _span_marks.popleft()
        _mark_pool.setdefault(dev, []).extend((start, end))
    _span_sums.clear()


@contextlib.contextmanager
def maybe_trace(name: str = "txr"):
    """Trace the block with ``torch.profiler`` when TXR_TRACE_DIR is set.

    View with chrome://tracing or https://ui.perfetto.dev."""
    trace_dir = os.environ.get("TXR_TRACE_DIR")
    if not trace_dir:
        yield
        return
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
