"""One run of a cell: set-up, the measured window, the records the metric
readers read, and the check against the reference.

The loop is closed: each step takes ``frames_per_step`` frames from a pool
staged on the card; the host enqueues steps back to back and synchronises
only at the window's edges, so the card sets the pace.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from port_bench.lib import flops, inputs, spec, trace, weights
from port_bench.lib.check import Captured


# frames in the drawn order before it repeats: more than any window shows
ORDER_LENGTH = 1 << 17


class HostMark:
    """Stands in for a CUDA event where the step runs on the CPU (tests)."""

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


class Run:
    """A cell on one device. ``quant`` other than "none" runs the port's
    int8 policy (the control of the model's precision: the architecture's
    ``CONTROL``)."""

    def __init__(self, cell: spec.Cell, device, quant: str = "none"):
        self.cell = cell
        self.cfg, self.trf, self.arch = cell.config, cell.traffic, cell.arch
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.quant = quant
        self.model_hw = self.arch.model_grid(self.cfg,
                                             self.trf["frame_hw"])
        self.B = self.trf["frames_per_step"]
        self.map_cfg = self.trf["map"]
        self.capacity = 1 << self.map_cfg["capacity_log2"]
        self.model = None

    # ------------------------------------------------------------ set-up

    def event(self):
        return torch.cuda.Event(enable_timing=True) if self.cuda \
            else HostMark()

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def prepare(self, seed: int, trace_on: bool = False) -> None:
        """Weights, frames, an empty map and the warm-up steps, all from
        ``seed``."""
        from port_bench.lib import program

        self.program = program
        self.seed = seed
        trf, dev = self.trf, self.dev
        parts, t = {}, time.perf_counter()

        def lap(name):
            nonlocal t
            self.sync()
            now = time.perf_counter()
            parts[name] = now - t
            t = now

        w = weights.make_weights(self.arch, self.cfg, inputs.stream_seed(
            seed, inputs.WEIGHTS), dev, torch.bfloat16)
        if self.model is None:
            self.model = self.arch.build(self.cfg, w, dev, self.quant)
        else:
            self.model.load_state_dict(w, strict=True)
        del w
        lap("weights_and_model")
        self.step_fn = program.Step(self.model, self.cfg, trf,
                                    self.model_hw, dev)
        pool = trf["pool_frames"]
        self.pool = inputs.make_frames(pool, trf["frame_hw"], seed, dev)
        self.order = inputs.frame_order(ORDER_LENGTH, pool, seed)
        self.order_dev = torch.from_numpy(self.order).to(dev).view(-1,
                                                                   self.B)
        self.poses = inputs.PoseTable(self.B, trf["advance_m"], dev)
        lap("frames")
        self.vm = program.create_map(self.capacity, self.map_cfg["voxel_m"],
                                     dev)
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        lap("map")
        if trace_on and self.cuda:
            # the profiler's first start loads CUPTI: not in the window
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                torch.ones(1, device=dev).add_(1)
        for i in range(trf["warmup_steps"]):
            self._one(i, -(i + 1) * self.B)
            lap(f"warmup_{i}")
        self.setup_parts = parts

    def _frames(self, i: int):
        """The frames of step ``i`` on the card."""
        return self.pool.index_select(
            0, self.order_dev[i % self.order_dev.shape[0]])

    def _one(self, i: int, first: int, marks=None, scope=None):
        R, t = self.poses.at(first)
        prev = self.vm
        self.vm, depth, pts = self.step_fn(self._frames(i), R, t, prev,
                                           marks, scope)
        return Captured(step=i, first=first, before=prev, after=self.vm,
                        depth=depth, points=pts)

    # ------------------------------------------------------------ window

    def window(self, seconds: float, trace_on: bool,
               profile_s: float = 4.0) -> dict:
        """The measured window; returns the records and the captured
        outputs of the checked steps. Traced, the profiler covers the
        window's last ``profile_s`` seconds (at most 40 % of it): stopping
        it takes the host a while, and no step should wait behind that."""
        sample = inputs.sample_step(self.seed, self.trf["check_first_steps"])
        return self._closed(seconds, trace_on, sample,
                            min(profile_s, 0.4 * seconds))

    def _profiler(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        return torch.profiler.profile(activities=acts)

    def _closed(self, seconds, trace_on, sample, p_len):
        scope = trace.Scopes(trace_on)
        steps: List[dict] = []
        events = []
        prof, hooks, prof_frames = None, None, 0
        checked: Dict[str, object] = {}
        self.sync()
        t0 = time.perf_counter()
        i = 0
        while True:
            h0 = time.perf_counter()
            if h0 - t0 >= seconds:
                break
            if trace_on and prof is None and h0 - t0 >= seconds - p_len:
                self.sync()
                prof = self._profiler()
                prof.start()
                hooks = trace.AttentionHooks(
                    self.arch.attention_modules(self.model))
                p_start = i
            marks = None
            if trace_on:
                ev = [self.event() for _ in range(4)]
                events.append(ev)
                marks = lambda k, ev=ev: ev[k].record()
            cap = self._one(i, i * self.B, marks, scope)
            if i == sample:
                checked["sample"] = cap
            checked["last"] = cap
            steps.append({"enqueue_ms": (time.perf_counter() - h0) * 1e3,
                          "profiled": prof is not None})
            i += 1
        self.sync()
        t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
            hooks.remove()
            prof_frames = (i - p_start) * self.B
        rec = self._records(steps, events, i * self.B, t1 - t0)
        if prof is not None:
            rec["probe_enqueue_ms"] = self._probe(i)
            rec["trace"] = self._reduce(prof, prof_frames)
        return {"records": rec, "checked": checked,
                "attempted": i * self.B, "failed": 0}

    def _probe(self, i: int, count: int = 5) -> List[float]:
        """Host milliseconds to enqueue one step on an idle card (after
        the window; the closed loop's own steps wait on a full queue)."""
        out = []
        for k in range(count):
            self.sync()
            h0 = time.perf_counter()
            self._one(i + k, (i + k) * self.B)
            out.append((time.perf_counter() - h0) * 1e3)
        self.sync()
        return out

    def _records(self, steps, events, frames, window_s) -> dict:
        for st, ev in zip(steps, events):
            st["depth_ms"] = ev[0].elapsed_time(ev[1]) / self.B
            st["backproject_ms"] = ev[1].elapsed_time(ev[2]) / self.B
            st["insert_ms"] = ev[2].elapsed_time(ev[3]) / self.B
        return {"cell": self.cell.name, "config": self.cfg,
                "traffic": self.trf, "model_hw": list(self.model_hw),
                "frames_per_step": self.B, "capacity": self.capacity,
                "points_per_step": self.B * self.model_hw[0] *
                self.model_hw[1],
                "frames": frames,
                "window_s": window_s, "steps": steps,
                "step_flops": self.arch.step_flops(self.cfg, self.model_hw,
                                                   self.B),
                "attention_flops": self.arch.attention_flops(
                    self.cfg, self.model_hw, self.B),
                "attention_calls": self.arch.attention_calls(self.cfg),
                "peak_flops": flops.PEAK_BF16_FLOPS,
                "peak_bytes": flops.PEAK_BYTES}

    def _reduce(self, prof, frames: int) -> dict:
        out = trace.reduce(prof)
        out["frames"] = frames
        return out

    # ------------------------------------------------------------ results

    def end_to_end(self, result: dict, setup_s: float) -> dict:
        rec = result["records"]
        return {"setup_s": setup_s,
                "frames_per_s": rec["frames"] / rec["window_s"]}

    def release(self) -> None:
        """Drop the program's state that the check does not read."""
        self.model = None
        self.step_fn = None
        self.vm = None
        self.order_dev = None
        if self.cuda:
            torch.cuda.empty_cache()
