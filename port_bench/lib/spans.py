"""The program's own spans and counters, read from a ``torch.profiler``
recording of the port's main path.

The port opens a ``torch.profiler`` range ``txr.<name>`` at each layer
boundary of its main path (``txr_torch/utils/profiling.py:span``): the
model's forward, the encoder with its position embedding and attention,
the head; the insert with its pack, sort and reduce. ``reduce`` reads the
same profiler object as ``trace.reduce`` and gives, for each span name:

- ``device_s``: device time of the kernels, copies and sets launched inside
  it on the same host thread, linked by correlation id as ``trace.reduce``
  links them; a span counts what its nested spans launch;
- ``calls`` and ``host_s``: how often it was entered and its host seconds.

Besides, ``syncs``: the host-blocking CUDA runtime calls made inside
``txr.`` spans (stream, device and event synchronisation, a synchronous
copy, a device-to-host copy); ``clock_skew_us``: the largest amount by
which a kernel's start precedes the start of its launch on the trace,
against the runtime's launch call and against the host operation that
made it, with ``launch_lag_us_median`` (kernel start less launch call
start); and ``idle_gaps_by_span``: the longest idle gaps of the device,
each named by the innermost ``txr.`` span open on the launching thread at
the gap's start shifted into host time by the skew, or ``"unresolved"``
where the gap is shorter than twice the skew.

``program_counters`` reads the program's counters
(``txr_torch/utils/profiling.py:counters``), which the port keeps only
while a profiler records: in a traced run of ``run.py``, the window's
profiled part. ``tools/trace_cost.py`` prints ``reduce``'s result for
each profiled block of its loop; ``bench.py`` does not call it.
"""

from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

from port_bench.lib import trace

PREFIX = "txr."
BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize")
NO_SPAN = "(no span)"


def _blocking(name: str, copy_name: str) -> bool:
    if name in BLOCKING:
        return True
    return name.startswith("cudaMemcpy") and (
        "Async" not in name or "DtoH" in copy_name)


class _Open:
    """The ``txr.`` spans of each host thread, by name, sorted by start."""

    def __init__(self, spans):
        self.by_tid = defaultdict(dict)
        for name, rs in spans.items():
            per = defaultdict(list)
            for s, e, tid in rs:
                per[tid].append((s, e))
            for tid, v in per.items():
                v.sort()
                self.by_tid[tid][name] = ([r[0] for r in v], v)

    def at(self, t, tid=None) -> list:
        """(start, name) of each span open at ``t`` on ``tid`` (any thread
        where ``tid`` is None)."""
        tids = self.by_tid if tid is None else [tid]
        out = []
        for k in tids:
            for name, (starts, rs) in self.by_tid.get(k, {}).items():
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and rs[i][1] >= t:
                    out.append((rs[i][0], name))
        return out

    def innermost(self, t, tid) -> str:
        found = self.at(t, tid)
        return max(found, key=lambda p: (p[0], len(p[1])))[1] if found \
            else NO_SPAN


def reduce(prof, top: int = 10) -> dict:
    """The ``txr.`` spans of the profiled part, the blocking calls inside
    them, the clock skew and the idle gaps named by span."""
    evs = prof.profiler.kineto_results.events()
    device, spans, ops, runtime, copies = [], defaultdict(list), {}, [], {}
    for e in evs:
        name = e.name()
        if trace._is_device(e):
            kind = trace._kind(e)
            if name.startswith(PREFIX) or name.startswith(trace.PREFIX) or (
                    kind and not any(k in kind for k in trace.DEVICE_KINDS)):
                continue
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           e.correlation_id(), e.linked_correlation_id()))
            if name.startswith("Memcpy"):
                copies[e.correlation_id()] = name
            continue
        s, d = e.start_ns(), e.duration_ns()
        if name.startswith("cu"):          # CUDA runtime calls
            runtime.append((s, name, e.correlation_id(),
                            e.linked_correlation_id()))
            continue
        # the profiler's own events inside an operation ("Command Buffer
        # Full", "Lazy Function Loading") carry its correlation id; the
        # operation starts first. Id 0 links nothing.
        corr = e.correlation_id()
        if corr and (corr not in ops or s < ops[corr][0]):
            ops[corr] = (s, e.start_thread_id())
        if name.startswith(PREFIX):
            spans[name[len(PREFIX):]].append((s, s + d,
                                              e.start_thread_id()))
    out = {"device_s": {}, "calls": {k: len(v) for k, v in spans.items()},
           "host_s": {k: sum(r[1] - r[0] for r in v) * 1e-9
                      for k, v in spans.items()},
           "syncs": 0, "syncs_by_span": {}, "unlinked_device_s": 0.0,
           "clock_skew_us": None, "clock_skew_parts_us": {},
           "launch_lag_us_median": None, "idle_gaps_by_span": []}
    opened = _Open(spans)

    # device time of the work launched inside each span
    totals, unlinked = defaultdict(int), 0
    for s, e, _, linked in device:
        launch = ops.get(linked)
        if launch is None:
            unlinked += e - s
            continue
        for _, name in opened.at(*launch):
            totals[name] += e - s
    out["device_s"] = {k: v * 1e-9 for k, v in totals.items()}
    out["unlinked_device_s"] = unlinked * 1e-9

    # blocking runtime calls inside txr. spans
    syncs = defaultdict(int)
    for s, name, corr, linked in runtime:
        if not _blocking(name, copies.get(corr, "")):
            continue
        launch = ops.get(linked)
        t, tid = launch if launch is not None else (s, None)
        found = opened.at(t, tid)
        if found:
            syncs[max(found)[1] + "/" + name] += 1
    out["syncs"] = sum(syncs.values())
    out["syncs_by_span"] = dict(syncs)

    # the clock skew: a kernel cannot start before its launch
    launch_start = {corr: s for s, _, corr, _ in runtime}
    lags = {"launch": [], "op": []}
    for s, _, corr, linked in device:
        if corr in launch_start:
            lags["launch"].append(s - launch_start[corr])
        if linked in ops:
            lags["op"].append(s - ops[linked][0])
    parts = {k: max(0, -min(v)) * 1e-3 for k, v in lags.items() if v}
    if parts:
        out["clock_skew_parts_us"] = parts
        out["clock_skew_us"] = max(parts.values())
        lag = lags["launch"] or lags["op"]
        out["launch_lag_us_median"] = statistics.median(lag) * 1e-3
    if device:
        out["idle_gaps_by_span"] = _gaps(sorted(device), ops, opened,
                                         out["clock_skew_us"] or 0.0, top)
    return out


def _gaps(device, ops, opened, skew_us, top) -> list:
    """The ``top`` longest idle gaps, each named by the innermost span open
    on the thread that launched the work ending it, at the gap's start
    moved into host time by ``skew_us``."""
    gaps, cur_e = [], device[0][1]
    for s, e, _, linked in device[1:]:
        if s > cur_e:
            gaps.append((cur_e, s, linked))
        cur_e = max(cur_e, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    tids = [ops[lk][1] for _, _, _, lk in device if lk in ops]
    main_tid = statistics.mode(tids) if tids else None
    skew_ns = skew_us * 1e3
    out = []
    for gs, ge, linked in gaps[:top]:
        if ge - gs < 2 * skew_ns:
            label = "unresolved"
        else:
            tid = ops[linked][1] if linked in ops else main_tid
            label = opened.innermost(gs + skew_ns, tid)
        out.append([label, (ge - gs) * 1e-9])
    return out


def program_counters() -> dict:
    """The program's counters, read once (one sync); empty where the
    program keeps none."""
    from txr_torch.utils import profiling

    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}
