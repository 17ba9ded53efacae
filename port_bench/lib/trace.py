"""Spans and the device trace of a traced run (``--trace 1``).

Spans are ``torch.profiler`` ranges that the harness opens around its calls
into the program (``port_bench.<name>``), and CUDA events at the stage
boundaries of each step. The attention range is opened by a forward hook
at the end of each attention call's opening module and closed by a
pre-hook at the start of its closing one (the architecture's
``attention_modules``: a block's qkv product and its output projection,
in Depth Anything V2), so it holds attention proper whatever kernel
computes it.

``reduce`` turns the profiler's events into what the metric readers read:
the traced window, the union of device activity (busy seconds), the device
time of the kernels launched inside each harness range (by the profiler's
link from a kernel to the host operation that launched it), device time by
operation name, and the longest idle gaps named by the host operation (and
the harness ranges around it) whose launch ended each.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List

import torch
from torch.autograd.profiler import record_function

PREFIX = "port_bench."
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")


class Scopes:
    """Named host ranges around the harness's calls; no-ops when off."""

    def __init__(self, on: bool):
        self.on = on

    def __call__(self, name: str):
        from contextlib import nullcontext
        return record_function(PREFIX + name) if self.on else nullcontext()


class AttentionHooks:
    """Opens ``port_bench.attention`` after each pair's first module and
    closes it before the pair's second."""

    def __init__(self, pairs: list):
        self.open: List[record_function] = []
        self.handles = []
        for start, end in pairs:
            self.handles.append(start.register_forward_hook(self._start))
            self.handles.append(end.register_forward_pre_hook(self._stop))

    def _start(self, module, args, output):
        rf = record_function(PREFIX + "attention")
        rf.__enter__()
        self.open.append(rf)

    def _stop(self, module, args):
        if self.open:
            self.open.pop().__exit__(None, None, None)

    def remove(self):
        for h in self.handles:
            h.remove()
        self.handles = []


def _kind(e) -> str:
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


def _is_device(e) -> bool:
    return e.device_type() != torch.autograd.DeviceType.CPU


def reduce(prof, top: int = 10) -> dict:
    """The traced window's device activity and the harness ranges."""
    evs = prof.profiler.kineto_results.events()
    device, ranges, cpu_start = [], defaultdict(list), {}
    for e in evs:
        if _is_device(e):
            kind = _kind(e)
            # the device-side copies of the harness's ranges are spans,
            # not work
            if e.name().startswith(PREFIX) or (
                    kind and not any(k in kind for k in DEVICE_KINDS)):
                continue
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           e.name(), e.linked_correlation_id()))
        else:
            s, d, name = e.start_ns(), e.duration_ns(), e.name()
            if name.startswith("cu"):          # CUDA API calls
                continue
            cpu_start[e.correlation_id()] = (s, e.start_thread_id(), name)
            if name.startswith(PREFIX):
                ranges[name[len(PREFIX):]].append(
                    (s, s + d, e.start_thread_id()))
    device.sort()
    out = {"device_ops": 0, "busy_s": 0.0, "window_s": 0.0,
           "range_device_s": {}, "range_calls": {}, "by_name": [],
           "idle_gaps": [], "unlinked_device_s": 0.0}
    if not device:
        return out
    # union of device intervals, and the gaps between them
    busy, gaps = 0, []
    cur_s, cur_e = device[0][0], device[0][1]
    for s, e, _, _ in device[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    out["device_ops"] = len(device)
    out["busy_s"] = busy * 1e-9
    out["window_s"] = (cur_e - device[0][0]) * 1e-9

    by_name = defaultdict(int)
    for s, e, name, _ in device:
        by_name[name] += e - s
    out["by_name"] = [[n, t * 1e-9] for n, t in
                      sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]

    # device time of the kernels launched inside each harness range
    sorted_ranges = {k: sorted(v) for k, v in ranges.items()}
    starts = {k: [r[0] for r in v] for k, v in sorted_ranges.items()}
    totals, unlinked = defaultdict(int), 0
    for s, e, _, corr in device:
        launch = cpu_start.get(corr) if corr else None
        if launch is None:
            unlinked += e - s
            continue
        t, tid, _ = launch
        for name, rs in sorted_ranges.items():
            i = bisect.bisect_right(starts[name], t) - 1
            if i >= 0 and rs[i][0] <= t <= rs[i][1] and rs[i][2] == tid:
                totals[name] += e - s
    out["range_device_s"] = {k: v * 1e-9 for k, v in totals.items()}
    out["range_calls"] = {k: len(v) for k, v in sorted_ranges.items()}
    out["unlinked_device_s"] = unlinked * 1e-9

    # the longest idle gaps, named by the host operation whose launch ended
    # each (host and device clocks differ by more than a short gap, so the
    # host's activity at the gap's start on the trace's timeline is not to
    # be trusted; the link from the next device operation to its launch is)
    first_after = {s: corr for s, _, _, corr in device}
    gaps.sort(key=lambda g: g[0] - g[1])
    for gs, ge in gaps[:top]:
        launch = cpu_start.get(first_after.get(ge))
        if launch is None:
            label = "unlinked"
        else:
            t, tid, op = launch
            where = [name for name, rs in sorted_ranges.items()
                     for i in [bisect.bisect_right(starts[name], t) - 1]
                     if i >= 0 and rs[i][0] <= t <= rs[i][1]]
            label = "/".join(sorted(where) + [op]) if where else op
        out["idle_gaps"].append([label, (ge - gs) * 1e-9])
    return out
