"""Spans, counters and the Chrome-trace exporter: the port's tracing, the
counterpart of ``txr/utils/profiling.py``.

``span(name)`` is a ``torch.profiler`` range named ``txr.<name>`` while a
profiler is recording, and one shared no-op context otherwise, so the
layers of the main path (the encoder, its attention and position
embedding, the head; the insert's pack, sort and reduce; in Depth
Anything 3's any-view model also the QK-norm and RoPE
``models.encoder.qk_prep``, the cross-view attention calls
``models.encoder.crossview`` apart from the within-view
``models.encoder.attention``, and the head's ray branch
``models.head.ray``; in VGGT the front as ``models.encoder``, the
aggregator ``models.aggregator`` around its blocks' attention, QK-norm /
RoPE and cross-view spans, ``models.camera_head``, the depth head as
``models.head`` and the point head ``models.head.points``) carry their
ranges at no cost when nobody traces. Ranges nest as the calls do; they
launch no device work, so a CUDA-graph capture is unaffected. A range is
recorded as a host operation (``_RecordFunctionFast``), not as a user
annotation (``record_function``): it adds no range to the device's
timeline, which a reading of the trace would count as device work, and
the kernels the port launches itself (``txr_torch._cuda``, outside any
PyTorch operation) are linked to the innermost span that launched them.

``count(name, value)`` adds a host int or a 0-d tensor to the counter
``name``, again only while a profiler is recording and never while a CUDA
stream is capturing. Tensor values are summed on their device, one int64
tensor per name, and read with one sync by ``counters()``;
``reset_counters()`` clears them all. The main path keeps
``models.pos_embed_hits`` / ``models.pos_embed_misses`` (host ints: each
resized position-embedding lookup the encoder reused or recomputed,
``models/vit.py``), ``models.attention_pairs_local`` /
``models.attention_pairs_crossview`` (host ints: the query-key pairs of
each within-view and cross-view attention call, B S^2, ``models/vit.py``),
``models.head_pos_embed_hits`` / ``models.head_pos_embed_misses`` (host
ints: each of VGGT's heads' kept position embeddings and tail terms
reused or recomputed, ``models/dpt.py``)
and ``fusion.rows_sorted`` / ``fusion.rows_merged`` /
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
from typing import Dict, Union

import torch
import torch.autograd.profiler as _profiler

logger = logging.getLogger(__name__)

PREFIX = "txr."
_OFF = contextlib.nullcontext()
_Range = torch._C._profiler._RecordFunctionFast

_host_counts: Dict[str, int] = {}
_device_counts: Dict[str, torch.Tensor] = {}


def _capturing() -> bool:
    return torch.cuda.is_initialized() and \
        torch.cuda.is_current_stream_capturing()


def recording() -> bool:
    """Whether counters are kept: a ``torch.profiler`` records in this
    process and no CUDA stream is capturing."""
    return _profiler._is_profiler_enabled and not _capturing()


def span(name: str):
    """The range ``txr.<name>`` while a profiler records; a no-op else."""
    if _profiler._is_profiler_enabled:
        return _Range(PREFIX + name)
    return _OFF


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
    _host_counts.clear()
    _device_counts.clear()


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
