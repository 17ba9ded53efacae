"""The port's spans and counters (``txr_torch/utils/profiling.py``) on the
main path, and the benchmark's reduction of them (``port_bench/lib/
spans.py``) and readers of them (``port_bench/lib/program_spans.py``), on
the CPU with a tiny model and map.

With a profiler recording, one step (the model's forward, then the insert
of the step's points) opens every ``txr.*`` span, nested as the calls
are, times each between its own marks (``span_times``), and counts the
rows sorted, the rows merged and the valid points; with none, no profiler
range is entered, no mark is made, no counter is kept and the insert runs
no extra reduction. ``spans.reduce`` gives each span's calls and host
time, and the ``txr.*`` ranges leave ``trace.reduce``'s device numbers as
they were without them.
"""

import time
from types import SimpleNamespace

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from port_bench.lib import spans as spans_mod
from port_bench.lib import trace
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import create_offset_map, offset_map_insert
from txr_torch.models.depth_anything import DepthAnything
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.utils import profiling

CAPACITY = 1 << 10
FRAMES, H, W = 2, 84, 140        # a 6 x 10 patch grid; the embedding's is 4
LAYERS = 2

# span -> the innermost txr. span around it (None: outermost)
PARENT = {
    "txr.models.forward": None,
    "txr.models.encoder": "txr.models.forward",
    "txr.models.encoder.attention": "txr.models.encoder",
    "txr.models.head": "txr.models.forward",
    "txr.fusion.insert": None,
    "txr.fusion.insert.pack": "txr.fusion.insert",
    "txr.fusion.insert.count": "txr.fusion.insert",
    "txr.fusion.insert.sort": "txr.fusion.insert",
    "txr.fusion.insert.reduce": "txr.fusion.insert",
}
CALLS = {name[len("txr."):]: (LAYERS if name.endswith("attention") else 1)
         for name in PARENT}


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    vit = ViTConfig(hidden_size=32, num_layers=LAYERS, num_heads=2,
                    pos_embed_size=4, out_layers=(0, 0, 1, 1))
    dpt = DPTConfig(features=8, out_channels=(8, 8, 16, 16), head_hidden=8,
                    metric=True)
    return DepthAnything(vit, dpt).eval()


def points(n, seed):
    g = torch.Generator().manual_seed(seed)
    xyz = torch.rand(n, 3, generator=g) * 0.5
    rgb = torch.rand(n, 3, generator=g)
    mask = torch.rand(n, generator=g) > 0.3
    return PointSet(xyz, rgb, mask)


@torch.no_grad()
def step(model, vm, seed=0):
    """The main path's shape: depth from the model, then its pixels'
    points into the map."""
    g = torch.Generator().manual_seed(seed)
    depth = model(torch.rand(FRAMES, H, W, 3, generator=g))
    pts = points(depth.numel(), seed)
    return offset_map_insert(vm, pts), pts


def profiled(fn):
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return prof, out


def txr_parent(ev):
    p = ev.cpu_parent
    while p is not None and not p.name.startswith("txr."):
        p = p.cpu_parent
    return None if p is None else p.name


def test_spans_nest_as_the_calls(model):
    prof, _ = profiled(lambda: step(model, create_offset_map(CAPACITY,
                                                             0.01, "cpu")))
    evs = [e for e in prof.events() if e.name.startswith("txr.")]
    assert {e.name for e in evs} == set(PARENT)
    for e in evs:
        assert txr_parent(e) == PARENT[e.name], e.name
    start = {e.name: e.time_range.start for e in evs}
    assert start["txr.fusion.insert.pack"] < start["txr.fusion.insert.sort"] \
        < start["txr.fusion.insert.reduce"]
    assert start["txr.models.encoder"] < start["txr.models.head"]


class CountingRange:
    entered = 0

    def __init__(self, name):
        self.inner = CountingRange.real(name)

    def __enter__(self):
        CountingRange.entered += 1
        return self.inner.__enter__()

    def __exit__(self, *exc):
        return self.inner.__exit__(*exc)


class MaskReductions(TorchDispatchMode):
    """Records each reduction whose input is ``mask``."""

    def __init__(self, mask):
        super().__init__()
        self.mask, self.seen = mask, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if "sum" in str(func) and any(a is self.mask for a in args):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("recording", [False, True, "capturing"])
def test_without_a_profiler_nothing_is_entered_or_counted(
        model, monkeypatch, recording):
    CountingRange.real = profiling._Range
    CountingRange.entered = 0
    monkeypatch.setattr(profiling, "_Range", CountingRange)
    vm = create_offset_map(CAPACITY, 0.01, "cpu")
    pts = points(3000, 7)
    mode = MaskReductions(pts.mask)

    def run():
        step(model, vm)
        with mode, torch.no_grad():
            offset_map_insert(vm, pts)

    if recording == "capturing":
        # a CUDA graph being captured: spans only, no counter, no sum
        monkeypatch.setattr(profiling, "_capturing", lambda: True)
        profiled(run)
        assert CountingRange.entered >= sum(CALLS.values())
        assert mode.seen == [] and profiling.counters() == {}
    elif recording:
        profiled(run)
        assert CountingRange.entered >= sum(CALLS.values())
        assert mode.seen and profiling.counters()
    else:
        profiling.reset_counters()
        run()
        assert CountingRange.entered == 0
        assert mode.seen == []
        assert profiling.counters() == {}
        assert profiling.span("models.encoder") is \
            profiling.span("fusion.insert")


@pytest.mark.parametrize("inserts", [1, 2])
def test_insert_counters(inserts):
    vm = create_offset_map(CAPACITY, 0.01, "cpu")
    batches = [points(2500 + 100 * i, i) for i in range(inserts)]

    def run():
        out = vm
        for b in batches:
            out = offset_map_insert(out, b)
        return out

    profiled(run)
    got = profiling.counters()
    assert got["fusion.points_valid"] == sum(int(b.mask.sum())
                                             for b in batches)
    # only the batch's rows are sorted; the map's are merged without a sort
    assert got["fusion.rows_sorted"] == sum(b.mask.shape[0]
                                            for b in batches)
    assert got["fusion.rows_merged"] == CAPACITY * inserts
    profiling.reset_counters()
    assert profiling.counters() == {}


def test_pos_embed_counters_over_two_profiled_forwards(model):
    """The first forward after a parameter change resizes the embedding,
    the second reuses it; the counters say so, and no span of its own
    opens around the lookup."""
    with torch.no_grad():
        model.encoder.pos_embed.add_(0.0)    # a new version: one miss
    x = torch.rand(FRAMES, H, W, 3, generator=torch.Generator().manual_seed(3))

    def run():
        with torch.no_grad():
            model(x)
            model(x)

    prof, _ = profiled(run)
    got = profiling.counters()
    assert got["models.pos_embed_misses"] == 1
    assert got["models.pos_embed_hits"] == 1
    calls = spans_mod.reduce(prof)["calls"]
    assert calls["models.encoder"] == 2
    assert "models.encoder.pos_embed" not in calls


# Depth Anything 3 any-view: layers 0 to 2 within each view, layer 3 across
# the views; QK-norm and RoPE on layers 2 and 3; the dual head's ray branch
ANYVIEW_SPANS = {
    "txr.models.encoder.qk_prep": ("txr.models.encoder", 2),
    "txr.models.encoder.crossview": ("txr.models.encoder", 1),
    "txr.models.encoder.attention": ("txr.models.encoder", 3),
    "txr.models.head.ray": ("txr.models.head", 1),
}


@pytest.fixture(scope="module")
def anyview():
    torch.manual_seed(1)
    vit = ViTConfig(hidden_size=32, num_layers=4, num_heads=2,
                    pos_embed_size=4, out_layers=(0, 1, 2, 3),
                    anyview_start=2)
    dpt = DPTConfig(features=8, out_channels=(8, 8, 16, 16), head_hidden=8,
                    dual=True)
    return DepthAnything(vit, dpt).eval()


@pytest.mark.parametrize("recording", [True, False])
def test_anyview_spans_and_pair_counters(anyview, recording):
    """Under a profiler an any-view forward opens the QK-norm / RoPE, the
    cross-view and the ray-branch spans, and counts B S^2 query-key pairs
    a call of each kind; without one it enters no range and counts
    nothing."""
    x = torch.rand(FRAMES, H, W, 3, generator=torch.Generator().manual_seed(5))
    s = 1 + (H // 14) * (W // 14)

    def run():
        with torch.no_grad():
            return anyview(x)

    if not recording:
        CountingRange.real = profiling._Range
        CountingRange.entered = 0
        profiling.reset_counters()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(profiling, "_Range", CountingRange)
            run()
        assert CountingRange.entered == 0
        assert profiling.counters() == {}
        return
    prof, _ = profiled(run)
    evs = [e for e in prof.events() if e.name.startswith("txr.")]
    for name, (parent, calls) in ANYVIEW_SPANS.items():
        got = [e for e in evs if e.name == name]
        assert len(got) == calls, name
        assert all(txr_parent(e) == parent for e in got), name
    got = profiling.counters()
    assert got["models.attention_pairs_local"] == 3 * FRAMES * s * s
    assert got["models.attention_pairs_crossview"] == (FRAMES * s) ** 2


# VGGT: the front (one block), two frame / global pairs, the camera head
# (one block, one iteration), the depth and point heads; span -> (the
# innermost txr. span around it, calls)
VGGT_SPANS = {
    "txr.models.forward": (None, 1),
    "txr.models.encoder": ("txr.models.forward", 1),
    "txr.models.aggregator": ("txr.models.forward", 1),
    "txr.models.encoder.qk_prep": ("txr.models.aggregator", 4),
    "txr.models.encoder.crossview": ("txr.models.aggregator", 2),
    "txr.models.camera_head": ("txr.models.forward", 1),
    "txr.models.head": ("txr.models.forward", 1),
    "txr.models.head.points": ("txr.models.forward", 1),
}


@pytest.fixture(scope="module")
def vggt():
    from txr_torch.models.vggt import VGGT, VGGTConfig

    torch.manual_seed(2)
    cfg = VGGTConfig(hidden_size=32, num_heads=2, front_layers=1,
                     pos_embed_size=4, pairs=2, out_layers=(0, 1, 1, 1),
                     features=8, out_channels=(8, 8, 16, 16),
                     camera_layers=1, camera_iterations=1)
    return VGGT(cfg).eval()


def test_vggt_spans_and_counters(vggt):
    """Under a profiler a VGGT forward opens the aggregator, camera-head
    and point-head spans beside the front's and the depth head's, with the
    QK-norm / RoPE and cross-view spans inside the aggregator; it counts
    the query-key pairs of each kind and each head's kept embeddings (four
    projections, kept per width, and the tail's term a head: misses and
    hits, then hits)."""
    x = torch.rand(FRAMES, 28, 42, 3,
                   generator=torch.Generator().manual_seed(6))
    s = 5 + 2 * 3

    def run():
        with torch.no_grad():
            vggt(x)
            first = profiling.counters()
            vggt(x)
            return first

    prof, first = profiled(run)
    evs = [e for e in prof.events() if e.name.startswith("txr.")]
    for name, (parent, calls) in VGGT_SPANS.items():
        got = [e for e in evs if e.name == name]
        assert len(got) == 2 * calls, name
        assert all(txr_parent(e) == parent for e in got), name
    attention = [txr_parent(e) for e in evs
                 if e.name == "txr.models.encoder.attention"]
    assert sorted(set(attention)) == ["txr.models.aggregator",
                                      "txr.models.camera_head",
                                      "txr.models.encoder"]
    # per head: stages 0 and 1 (8 wide) share an embedding, as do 2 and
    # 3 (16 wide), beside the tail's term
    assert first["models.head_pos_embed_misses"] == 6
    assert first["models.head_pos_embed_hits"] == 4
    got = profiling.counters()
    assert got["models.head_pos_embed_hits"] == 4 + 10
    assert got["models.head_pos_embed_misses"] == 6
    assert got["models.attention_pairs_crossview"] == 2 * 2 * (FRAMES * s) ** 2
    assert got["models.qk_prep_plain_calls"] == 2 * 4
    profiling.reset_counters()


# StreamVGGT: 4 frames in two chunks of 2 through the cache (the front of
# one block, two pairs, the camera head of one block and one iteration);
# span -> (the innermost txr. span around it, calls)
STREAM_SPANS = {
    "txr.models.forward": (None, 1),
    "txr.models.stream.chunk": ("txr.models.forward", 2),
    "txr.models.encoder": ("txr.models.stream.chunk", 2),
    "txr.models.aggregator": ("txr.models.stream.chunk", 2),
    "txr.models.aggregator.kv_append": ("txr.models.aggregator", 4),
    "txr.models.encoder.cached": ("txr.models.aggregator", 4),
    "txr.models.camera_head": ("txr.models.stream.chunk", 2),
    "txr.models.head": ("txr.models.stream.chunk", 2),
}


@pytest.fixture(scope="module")
def stream():
    from txr_torch.models.vggt import StreamVGGT, StreamVGGTConfig

    torch.manual_seed(3)
    cfg = StreamVGGTConfig(hidden_size=32, num_heads=2, front_layers=1,
                           pos_embed_size=4, pairs=2,
                           out_layers=(0, 1, 1, 1), features=8,
                           out_channels=(8, 8, 16, 16), camera_layers=1,
                           camera_iterations=1, stream_chunk_frames=2,
                           cache_frames=4)
    return StreamVGGT(cfg).eval()


@pytest.mark.parametrize("recording", [True, False])
def test_stream_spans_and_cache_counters(stream, recording):
    """Under a profiler a StreamVGGT call opens a chunk span a chunk, the
    cache's append and the cached attention inside the aggregator a global
    layer a chunk, and counts the rows written and the query-key pairs the
    frame-causal mask keeps, against cached rows and the chunk's own, as
    the shapes give them; without one it enters no range and counts
    nothing."""
    x = torch.rand(4, 28, 42, 3, generator=torch.Generator().manual_seed(7))
    s, layers = 5 + 2 * 3, 2

    def run():
        with torch.no_grad():
            return stream(x)

    if not recording:
        CountingRange.real = profiling._Range
        CountingRange.entered = 0
        profiling.reset_counters()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(profiling, "_Range", CountingRange)
            run()
        assert CountingRange.entered == 0
        assert profiling.counters() == {}
        return
    prof, _ = profiled(run)
    evs = [e for e in prof.events() if e.name.startswith("txr.")]
    for name, (parent, calls) in STREAM_SPANS.items():
        got = [e for e in evs if e.name == name]
        assert len(got) == calls, name
        assert all(txr_parent(e) == parent for e in got), name
    assert "txr.models.encoder.crossview" not in {e.name for e in evs}
    got = profiling.counters()
    # chunk 0: 2 frames against their own rows (3 frame pairs); chunk 1:
    # the same, and its 2 s rows against the 2 s rows held
    assert got["models.kv_rows_written"] == layers * 4 * s
    assert got["models.kv_pairs_fresh"] == layers * 2 * 3 * s * s
    assert got["models.kv_pairs_cached"] == layers * (2 * s) ** 2
    assert got["models.attention_pairs_crossview"] == layers * 10 * s * s
    # a chunk's front block and two frame blocks on 2 frames, and the
    # camera trunk on 2 then 4 tokens, each against itself and earlier ones
    assert got["models.attention_pairs_local"] == (
        2 * (1 + layers) * 2 * s * s + (3 + 10))
    profiling.reset_counters()


def test_trace_cost_sums_the_spans_a_step():
    """``tools/trace_cost.py``'s summary: each ``txr.`` span's device ms
    a step, the new spans among them, and the model's spans' share of the
    forward's."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "trace_cost.py"
    spec = importlib.util.spec_from_file_location("trace_cost", path)
    tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tc)
    red = {"device_s": {"models.forward": 0.9, "models.aggregator": 0.6,
                        "models.camera_head": 0.03, "models.head": 0.1,
                        "models.head.points": 0.1, "models.encoder": 0.06,
                        "fusion.insert": 0.03}}
    got = tc.span_ms_per_step(red, steps=3)
    assert got["models.aggregator"] == pytest.approx(200.0)
    assert got["models.camera_head"] == pytest.approx(10.0)
    assert got["models.head.points"] == pytest.approx(100.0 / 3)
    assert list(got) == sorted(got, key=lambda k: -got[k])
    assert tc.span_ms_per_step({"device_s": {}}, steps=3) == {}


def test_trace_cost_puts_the_event_times_beside_the_linked_ones():
    """``tools/trace_cost.py``: the program's ``span_times`` a step,
    largest first, and each span's event time over its linked device
    time, less 1, for the spans both have."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "tools" / "trace_cost.py"
    spec = importlib.util.spec_from_file_location("trace_cost", path)
    tc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tc)
    times = {"models.encoder": {"calls": 3, "device_ms": 63.0},
             "models.head": {"calls": 3, "device_ms": 30.0},
             "fusion.insert.sort": {"calls": 3, "device_ms": 3.3}}
    event = tc.span_event_ms_per_step(times, steps=3)
    assert list(event) == ["models.encoder", "models.head",
                           "fusion.insert.sort"]
    assert event["models.encoder"] == pytest.approx(21.0)
    linked = {"models.encoder": 20.0, "fusion.insert.sort": 1.0,
              "fusion.insert.count": 0.5}
    gap = tc.span_event_gap(event, linked)
    assert gap == pytest.approx({"models.encoder": 0.05,
                                 "fusion.insert.sort": 0.1})


def test_a_tensor_counter_sums_on_its_device_and_reads_once():
    profiled(lambda: [profiling.count("t", torch.tensor(v))
                      for v in (3, 4, True)] + [profiling.count("h", 5)])
    got = profiling.counters()
    assert got == {"t": 8, "h": 5}
    assert profiling._device_counts["t"].dtype == torch.int64


def test_span_reduction_on_a_cpu_profile(model):
    prof, _ = profiled(lambda: step(model, create_offset_map(CAPACITY,
                                                             0.01, "cpu")))
    red = spans_mod.reduce(prof)
    assert red["calls"] == CALLS
    host = red["host_s"]
    for name, parent in PARENT.items():
        assert host[name[4:]] > 0
        if parent is not None:
            assert host[name[4:]] <= host[parent[4:]], name
    assert red["syncs"] == 0 and red["device_s"] == {}


# ----------------------------------------- a trace with device activity

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev(SimpleNamespace):
    """One event of a profiler's trace, with the accessors both reducers
    call; ``kind`` None stands for a PyTorch whose events have no
    ``activity_type``."""

    def name(self):
        return self.n

    def device_type(self):
        return self.dev

    def activity_type(self):
        if self.kind is None:
            raise AttributeError("activity_type")
        return self.kind

    def start_ns(self):
        return self.s

    def duration_ns(self):
        return self.d

    def correlation_id(self):
        return self.corr

    def linked_correlation_id(self):
        return self.link

    def start_thread_id(self):
        return self.tid


class Prof:
    """What ``trace.reduce`` and ``spans.reduce`` read of a profiler."""

    def __init__(self, events):
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: list(events)))


def synthetic_trace(skew_ns=0, kinds=True, device_ranges=False):
    """Two steps on one host thread: a harness range around an encoder
    span holding two launches; an insert span holding a sort (with the
    profiler's own "Command Buffer Full" under its correlation id), a
    kernel the span launches itself (no PyTorch operation around it) and a
    blocking device-to-host copy; the device's work, with idle gaps between
    them. Device times read ``skew_ns`` early. ``device_ranges`` adds the
    device-side copies a user-annotation range would have."""
    evs, corr = [], [100]

    def nxt():
        corr[0] += 1
        return corr[0]

    def ev(**kw):
        kw["kind"] = kw["kind"] if kinds else None
        evs.append(Ev(**kw))
        return evs[-1]

    for k in range(2):
        t0 = k * 1_000_000
        ev(n="port_bench.depth", dev=CPU, kind="user_annotation", s=t0,
           d=400_000, corr=nxt(), link=0, tid=1)
        enc = ev(n="txr.models.encoder", dev=CPU, kind="cpu_op",
                 s=t0 + 10_000, d=300_000, corr=nxt(), link=0, tid=1)
        ins = ev(n="txr.fusion.insert", dev=CPU, kind="cpu_op",
                 s=t0 + 500_000, d=200_000, corr=nxt(), link=0, tid=1)
        launches = [(t0 + 20_000, "aten::mm", "gemm", 300_000),
                    (t0 + 30_000, "aten::add", "add", 100_000),
                    (t0 + 510_000, "aten::sort", "radix_sort", 150_000),
                    (t0 + 600_000, None, "offset_reduce", 50_000)]
        dev_t = t0 + 40_000
        for s, op, kern, dur in launches:
            c_rt = nxt()
            if op is None:                 # launched by the span itself
                c_op = ins.corr
            else:
                c_op = nxt()
                ev(n=op, dev=CPU, kind="cpu_op", s=s, d=5_000, corr=c_op,
                   link=0, tid=1)
            if op == "aten::sort":
                ev(n="Command Buffer Full", dev=CPU, kind="overhead",
                   s=s + 1_500, d=100, corr=c_op, link=0, tid=1)
            ev(n="cudaLaunchKernel", dev=CPU, kind="cuda_runtime",
               s=s + 1_000, d=2_000, corr=c_rt, link=c_op, tid=1)
            dev_t = max(dev_t, s + 3_000)
            ev(n=kern, dev=CUDA, kind="kernel", s=dev_t - skew_ns, d=dur,
               corr=c_rt, link=c_op, tid=7)
            dev_t += dur + 20_000
        c_op, c_rt = nxt(), nxt()
        ev(n="aten::item", dev=CPU, kind="cpu_op", s=t0 + 680_000,
           d=10_000, corr=c_op, link=0, tid=1)
        ev(n="cudaMemcpyAsync", dev=CPU, kind="cuda_runtime",
           s=t0 + 681_000, d=5_000, corr=c_rt, link=c_op, tid=1)
        ev(n="Memcpy DtoH (Device -> Pinned)", dev=CUDA, kind="gpu_memcpy",
           s=dev_t - skew_ns, d=1_000, corr=c_rt, link=c_op, tid=7)
        if device_ranges:
            for span in (enc, ins):
                ev(n=span.n, dev=CUDA, kind="gpu_user_annotation",
                   s=span.s + 30_000 - skew_ns, d=span.d, corr=0, link=0,
                   tid=7)
    return evs


def without_txr(events):
    return [e for e in events if not e.name().startswith("txr.")]


class Filtered:
    """A real profile with its ``txr.`` events taken out."""

    def __init__(self, prof):
        evs = without_txr(prof.profiler.kineto_results.events())
        self.profiler = SimpleNamespace(
            kineto_results=SimpleNamespace(events=lambda: evs))


def test_spans_are_host_operations(model):
    """A span is recorded as a host operation, not a user annotation, so it
    puts no range on the device's timeline."""
    prof, _ = profiled(lambda: step(model, create_offset_map(CAPACITY,
                                                             0.01, "cpu")))
    kinds = {e.activity_type() for e in prof.profiler.kineto_results.events()
             if e.name().startswith("txr.")}
    assert kinds == {"cpu_op"}


@pytest.mark.parametrize("source", ["host_spans", "device_ranges", "cpu"])
def test_txr_spans_leave_the_device_trace_as_it_was(model, source):
    if source == "cpu":
        with_spans, _ = profiled(lambda: step(
            model, create_offset_map(CAPACITY, 0.01, "cpu")))
        without = Filtered(with_spans)
    else:
        # host spans on a PyTorch without activity kinds; device-side
        # ranges where the kinds tell them from work
        evs = synthetic_trace(kinds=source == "device_ranges",
                              device_ranges=source == "device_ranges")
        with_spans, without = Prof(evs), Prof(without_txr(evs))
    a, b = trace.reduce(with_spans), trace.reduce(without)
    for key in ("busy_s", "window_s", "by_name", "device_ops"):
        assert a[key] == b[key], key
    # the same gaps; a kernel that no PyTorch operation launched is no
    # longer "unlinked" but named by the span that launched it
    assert [g[1] for g in a["idle_gaps"]] == [g[1] for g in b["idle_gaps"]]
    for (la, _), (lb, _) in zip(a["idle_gaps"], b["idle_gaps"]):
        assert la == lb or (lb == "unlinked" and la.startswith("txr.")), \
            (la, lb)
    if source != "cpu":
        assert a["device_ops"] == 10 and a["busy_s"] > 0
        assert b["unlinked_device_s"] == pytest.approx(2 * 50e-6)
        assert a["unlinked_device_s"] == 0.0


@pytest.mark.parametrize("zero_id_event", [False, True])
def test_synthetic_span_reduction(zero_id_event):
    evs = synthetic_trace(kinds=False)
    if zero_id_event:
        # a kernel that nothing launched, and a host event with
        # correlation id 0 after it: neither is linked to the other
        evs += [Ev(n="Activity Buffer Request", dev=CPU, kind=None,
                   s=1_990_000, d=1_000, corr=0, link=0, tid=1),
                Ev(n="memset", dev=CUDA, kind=None, s=1_950_000, d=1_000,
                   corr=999, link=0, tid=7)]
    red = spans_mod.reduce(Prof(evs))
    assert red["calls"] == {"models.encoder": 2, "fusion.insert": 2}
    assert red["device_s"]["models.encoder"] == pytest.approx(2 * 400e-6)
    # the sort, the span's own kernel and the copy
    assert red["device_s"]["fusion.insert"] == pytest.approx(2 * 201e-6)
    assert red["unlinked_device_s"] == pytest.approx(
        1e-6 if zero_id_event else 0.0)
    assert red["syncs"] == 2
    assert red["syncs_by_span"] == {"fusion.insert/cudaMemcpyAsync": 2}
    assert red["clock_skew_us"] == 0.0
    assert red["launch_lag_us_median"] > 0
    labels = {g[0] for g in red["idle_gaps_by_span"]}
    assert labels <= {"models.encoder", "fusion.insert", spans_mod.NO_SPAN}
    assert len(red["idle_gaps_by_span"]) == (10 if zero_id_event else 9)


def test_a_skewed_device_clock_is_measured_and_bounds_the_gaps():
    skew = 50_000
    red = spans_mod.reduce(Prof(synthetic_trace(skew_ns=skew)))
    # the sort's kernel starts 2 us after its launch call, 3 us after its
    # operation
    assert red["clock_skew_parts_us"] == pytest.approx(
        {"launch": (skew - 2_000) / 1e3, "op": (skew - 3_000) / 1e3})
    assert red["clock_skew_us"] == pytest.approx((skew - 2_000) / 1e3)
    for label, secs in red["idle_gaps_by_span"]:
        assert (label == "unresolved") == (secs * 1e9 < 2 * (skew - 2_000))
    assert any(g[0] == "unresolved" for g in red["idle_gaps_by_span"])
    assert any(g[0] != "unresolved" for g in red["idle_gaps_by_span"])


# ----------------------------------------------- the spans' own times


def test_span_times_sum_nested_intervals_and_count_calls():
    """Each span's calls, and its intervals summed; a nested span's
    interval inside its parent's. On the CPU the marks read the host's
    clock."""
    def run():
        for _ in range(3):
            with profiling.span("outer", torch.zeros(1)):
                time.sleep(0.002)
                with profiling.span("outer.inner"):
                    time.sleep(0.003)

    t0 = time.perf_counter_ns()
    profiled(run)
    wall_ms = (time.perf_counter_ns() - t0) * 1e-6
    got = profiling.span_times()
    assert {k: v["calls"] for k, v in got.items()} == {"outer": 3,
                                                       "outer.inner": 3}
    assert got["outer.inner"]["device_ms"] >= 3 * 3.0
    assert got["outer"]["device_ms"] >= got["outer.inner"]["device_ms"] + \
        3 * 2.0
    assert got["outer"]["device_ms"] <= wall_ms
    assert profiling.span_times() == got       # a second read adds nothing


def test_span_times_of_a_step(model):
    """One profiled step times every span it opens, once a call, each
    nested span within its parent."""
    profiled(lambda: step(model, create_offset_map(CAPACITY, 0.01, "cpu")))
    got = profiling.span_times()
    assert {k: v["calls"] for k, v in got.items()} == CALLS
    for name, parent in PARENT.items():
        assert got[name[4:]]["device_ms"] > 0, name
        if parent is not None:
            assert got[name[4:]]["device_ms"] <= \
                got[parent[4:]]["device_ms"], name


@pytest.fixture
def marks_made(monkeypatch):
    """Each timing mark the spans create, by device, from an empty pool."""
    made, real = [], profiling._new_mark
    monkeypatch.setattr(profiling, "_mark_pool", {})

    def new(dev):
        made.append(dev)
        return real(dev)

    monkeypatch.setattr(profiling, "_new_mark", new)
    return made


def test_no_mark_without_a_profiler_and_none_after_the_first_step(
        model, marks_made):
    vm = create_offset_map(CAPACITY, 0.01, "cpu")
    profiling.reset_counters()
    step(model, vm)
    assert marks_made == [] and profiling.span_times() == {}
    profiled(lambda: step(model, vm))
    first = len(marks_made)
    assert first > 0 and set(marks_made) == {None}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        step(model, vm)
        step(model, vm)
    assert len(marks_made) == first         # taken from the pool
    assert profiling.span_times()["models.forward"]["calls"] == 3


def test_no_mark_while_a_stream_captures(model, monkeypatch, marks_made):
    """A CUDA graph being captured: the ranges open, nothing is timed."""
    monkeypatch.setattr(profiling, "_capturing", lambda: True)
    prof, _ = profiled(lambda: step(model, create_offset_map(CAPACITY, 0.01,
                                                             "cpu")))
    assert {e.name for e in prof.events() if e.name.startswith("txr.")} \
        == set(PARENT) - {"txr.fusion.insert.count"}
    assert marks_made == [] and profiling.span_times() == {}


def test_reset_counters_clears_the_span_times(model):
    profiled(lambda: step(model, create_offset_map(CAPACITY, 0.01, "cpu")))
    assert profiling.span_times()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("pending"):
            pass
    profiling.reset_counters()
    assert profiling.span_times() == {}


@pytest.mark.chip
def test_a_capturing_stream_records_no_span_time():
    """On the card: a span opened while a CUDA graph captures is not
    timed, one around the graph's replay is, on its CUDA events."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip")
    x = torch.ones(1 << 20, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1)                            # warm-up before capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    profiling.reset_counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        with torch.cuda.graph(graph):
            with profiling.span("captured", x):
                x.add_(1)
        with profiling.span("replayed", x):
            graph.replay()
    got = profiling.span_times()
    assert "captured" not in got
    assert got["replayed"]["calls"] == 1 and got["replayed"]["device_ms"] > 0
    profiling.reset_counters()


# ------------------------------------------------ attention's operations

HD = 32                         # the tiny models' heads x head size


def attention_flops(run):
    profiled(run)
    got = profiling.counters()
    profiling.reset_counters()
    return got["models.attention_flops"]


def test_attention_flops_da2(model):
    x = torch.rand(FRAMES, H, W, 3, generator=torch.Generator().manual_seed(8))
    s = 1 + (H // 14) * (W // 14)
    with torch.no_grad():
        got = attention_flops(lambda: model(x))
    assert got == 4 * HD * LAYERS * FRAMES * s * s


def test_attention_flops_da3_crossview(anyview):
    x = torch.rand(FRAMES, H, W, 3, generator=torch.Generator().manual_seed(9))
    s = 1 + (H // 14) * (W // 14)
    with torch.no_grad():
        got = attention_flops(lambda: anyview(x))
    assert got == 4 * HD * (3 * FRAMES * s * s + (FRAMES * s) ** 2)


def test_attention_flops_vggt_with_the_camera_trunk(vggt):
    """The front's block, two frame blocks and two global ones (heads of
    16), and the camera trunk's plain call over one token a view (twice
    as wide)."""
    x = torch.rand(FRAMES, 28, 42, 3,
                   generator=torch.Generator().manual_seed(10))
    s = 5 + 2 * 3
    with torch.no_grad():
        got = attention_flops(lambda: vggt(x))
    assert got == 4 * HD * (3 * FRAMES * s * s + 2 * (FRAMES * s) ** 2) \
        + 4 * (2 * HD) * FRAMES ** 2


def test_attention_flops_stream_cached_and_frame_causal(stream):
    """Two chunks of two frames: each chunk's front and frame blocks, the
    cached global calls (the pairs the mask keeps, against the cache and
    the chunk's own rows), and the camera trunk's frame-causal calls."""
    x = torch.rand(4, 28, 42, 3, generator=torch.Generator().manual_seed(11))
    s, layers = 5 + 2 * 3, 2
    with torch.no_grad():
        got = attention_flops(lambda: stream(x))
    assert got == 4 * HD * (2 * (1 + layers) * 2 * s * s
                            + layers * 10 * s * s) + 4 * (2 * HD) * (3 + 10)


# ------------------------------------------- the span metrics' readers

SPAN_METRICS = ("models.encoder_ms.offline", "models.aggregator_ms.offline",
                "models.head_ms.offline", "fusion.sort_ms.offline",
                "fusion.reduce_ms.offline",
                "kernels.attention_roofline.offline")


def read_metrics(frames):
    from port_bench.lib import spec

    rec = {"trace": {"frames": frames}, "peak_flops": 989e12}
    return {m: spec.metric_reader(m)(rec) for m in SPAN_METRICS}


@pytest.mark.parametrize("arch", ["da2", "vggt"])
def test_span_readers_on_a_profiled_step(arch, model, vggt):
    """Each reader gives its spans' milliseconds a frame (the roofline:
    the counter's operations over the attention spans' seconds); the
    aggregator's only where the model has one."""
    if arch == "da2":
        run = lambda: step(model, create_offset_map(CAPACITY, 0.01, "cpu"))
    else:
        x = torch.rand(FRAMES, 28, 42, 3,
                       generator=torch.Generator().manual_seed(12))

        def run():
            with torch.no_grad():
                depth = vggt(x)
            return offset_map_insert(create_offset_map(CAPACITY, 0.01, "cpu"),
                                     points(depth.numel(), 12))
    profiled(run)
    t = {k: v["device_ms"] for k, v in profiling.span_times().items()}
    flops = profiling.counters()["models.attention_flops"]
    got = read_metrics(FRAMES)
    profiling.reset_counters()
    assert got["models.encoder_ms.offline"] == pytest.approx(
        t["models.encoder"] / FRAMES)
    assert got["models.head_ms.offline"] == pytest.approx(
        (t["models.head"] + t.get("models.head.points", 0.0)) / FRAMES)
    assert got["fusion.sort_ms.offline"] == pytest.approx(
        t["fusion.insert.sort"] / FRAMES)
    assert got["fusion.reduce_ms.offline"] == pytest.approx(
        t["fusion.insert.reduce"] / FRAMES)
    attn = sum(t.get(k, 0.0) for k in ("models.encoder.attention",
                                        "models.encoder.crossview"))
    assert got["kernels.attention_roofline.offline"] == pytest.approx(
        100.0 * flops / 989e12 / (attn * 1e-3))
    if arch == "da2":
        assert got["models.aggregator_ms.offline"] is None
    else:
        assert "models.head.points" in t
        assert got["models.aggregator_ms.offline"] == pytest.approx(
            t["models.aggregator"] / FRAMES)


def test_span_readers_read_nothing_without_the_programs_span_times(
        model, monkeypatch):
    profiled(lambda: step(model, create_offset_map(CAPACITY, 0.01, "cpu")))
    monkeypatch.delattr(profiling, "span_times")
    assert read_metrics(FRAMES) == dict.fromkeys(SPAN_METRICS)
    profiling.reset_counters()


def test_span_readers_read_nothing_outside_a_trace(model):
    profiled(lambda: step(model, create_offset_map(CAPACITY, 0.01, "cpu")))
    assert read_metrics(0) == dict.fromkeys(SPAN_METRICS)
    profiling.reset_counters()


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_are_entries_of_the_benchmark(name):
    """Each span metric is an entry of ``BENCHMARK.json``, read from the
    program's spans, moving ``frames_per_s``, with a reader of its own."""
    import json
    from pathlib import Path

    from port_bench.lib import spec

    bench = json.loads((Path(spec.ROOT) / "BENCHMARK.json").read_text())
    entry = {m["name"]: m for m in bench["per_layer"]}[name]
    assert entry["source"] == "program_span"
    assert entry["moves"] == "frames_per_s"
    assert callable(spec.metric_reader(name))
    cells = [w["name"] for w in bench["workloads"]]
    assert entry["workloads"] == (cells[2:] if "aggregator" in name
                                  else cells)
