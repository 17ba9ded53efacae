"""The streaming reconstruction's fused step, the counterpart of
``txr/pipelines/stream_step.py``.

The stepwise ``StreamingReconstructor`` (``pipelines/streaming.py``) reads
half a dozen values back to the host per frame (the valid count and the
scale of ``pair_step``, ICP's cloud counts and inlier fraction, the chain
of poses kept in numpy), each a wait for the card. Here the whole chain of
a frame is enqueued with no host read:

    frame u8 -> [ depth (the model's device body) -> grey + CLAHE -> SIFT
                  -> ratio matching against the previous frame -> pair_step
                  -> scale EMA -> pose chain -> back-projection
                  -> point-to-plane ICP against the map -> voxel-map insert ]
             -> (state', diagnostics)

``txr``'s ``jnp.where`` / ``lax.cond`` are ``torch.where`` selections:
ICP runs on every frame and its result is taken where
``do_icp & (icp_frac >= 0.3)``. The state (map, previous features, pose,
scale, frames fused) stays on the device; the host reads one small row of
diagnostics per frame, in the chunks the runner drains, and the depth and
features only on keyframes.

On the card each step is one CUDA graph (``GraphedProgram``): captured at
its first call after one eager warm-up call, then replayed, the port's
counterpart of ``jax.jit`` over fixed shapes. The hand kernels (attention,
the DPT tail, the fused voxel-map reduce) launch on the current stream and
are recorded in the graph with the rest. On the CPU the same functions run
eagerly: that is the plain version the tests hold against ``txr``.

RANSAC draws are not made inside a step: the runner draws each non-initial
frame's essential and homography priorities (in that order, from the
reconstructor's generator or its ``priorities=``) into the step's input,
the draws the stepwise path makes, in its order.

Semantics are the stepwise path's (``MIN_INLIERS``, constant position and
the ICP rescue, the scale EMA in float64 as the stepwise path keeps it on
the host), with ``txr``'s fused deltas: ICP's world correction is folded
into the pose and moves the points instead of a second back-projection,
and the batched step (``build_fused_stream_batch_step``) keeps the three
deltas its docstring lists.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from txr_torch.core.precision import f32_dots
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (OffsetVoxelMap, create_offset_map,
                                         offset_map_insert,
                                         offset_map_points, offset_map_size)
from txr_torch.geometry.features import bgr_to_gray
from txr_torch.geometry.icp import estimate_normals, icp_point_to_plane
from txr_torch.geometry.scale import clamp_scale, ema_scale, estimate_scale
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.clahe import clahe
from txr_torch.ops.matching import match_l2_ratio
from txr_torch.ops.resize import compute_da_resize
from txr_torch.ops.sift import sift_features
from txr_torch.pipelines.fusion_pipeline import pair_step

MIN_INLIERS = 15  # rtabmap rgbd_odometry Vis/MinInliers (slam.launch.py:115)
PAIR_HYPOTHESES = 1024

# The diagnostic row of one frame (float64; R and t are f32 values, the
# counts integers, all exact): what the host reads per frame.
ROW_R = slice(0, 9)
ROW_T = slice(9, 12)
(ROW_SCALE, ROW_MATCHES, ROW_INLIERS, ROW_FUSED, ROW_ICP_FRAC,
 ROW_ICP_APPLIED, ROW_MAP_SIZE) = range(12, 19)
ROW = 19


class GraphedProgram:
    """``fn`` over a fixed tuple of tensors, returning a tuple of tensors.

    Where the first input lies on the CPU, a call runs ``fn`` eagerly. On
    the card the first call runs ``fn`` eagerly twice (kernels built,
    algorithms picked, constants put on the card; the second call under
    PyTorch's sync debug mode "error", so an op that reads back, which
    would break the capture, raises where it stands) and captures it as one
    CUDA graph over static copies of the inputs; every call then copies its
    arguments into those inputs (an argument that is one of them is not
    copied) and replays the graph. The outputs of a replay are static
    buffers that the next replay overwrites. A capture that fails raises:
    nothing falls back to eager calls.

    Kept for the record: ``capture_s`` (the capture and the graph's
    instantiation), ``pool_bytes`` (device memory reserved by the capture),
    ``launches`` (hand-kernel launches recorded in the graph, by wrapper
    counter), ``warmup_launches`` and ``replays``."""

    def __init__(self, fn: Callable, name: str):
        self.fn, self.name = fn, name
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.inputs: tuple = ()
        self.outputs: tuple = ()
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.launches: dict = {}
        self.warmup_launches: dict = {}

    @property
    def graphed(self) -> bool:
        return self.graph is not None

    def __call__(self, *args: torch.Tensor) -> tuple:
        if args[0].device.type != "cuda":
            with torch.no_grad():
                return self.fn(*args)
        if self.graph is None:
            self._capture(args)
        for static, a in zip(self.inputs, args):
            if static is not a:
                static.copy_(a)
        self.graph.replay()
        self.replays += 1
        return self.outputs

    def eager(self, *args: torch.Tensor) -> tuple:
        """One eager call of ``fn`` (what a replay must equal)."""
        with torch.no_grad():
            return self.fn(*args)

    def _capture(self, args) -> None:
        from txr_torch import _cuda

        self.inputs = tuple(a.clone() for a in args)
        before = dict(_cuda.launches)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        mode = torch.cuda.get_sync_debug_mode()
        with torch.cuda.stream(side), torch.no_grad():
            self.fn(*self.inputs)
            torch.cuda.set_sync_debug_mode("error")
            try:
                self.fn(*self.inputs)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        mid = dict(_cuda.launches)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph), torch.no_grad():
                outputs = self.fn(*self.inputs)
        except Exception as e:
            raise RuntimeError(f"{self.name}: capturing the step as a CUDA "
                               f"graph failed: {e}") from e
        torch.cuda.synchronize()
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.warmup_launches = {k: mid[k] - before[k] for k in before}
        self.launches = {k: _cuda.launches[k] - mid[k] for k in mid}
        self.outputs = tuple(outputs)
        self.graph = graph

    def device_launches(self) -> dict:
        """Hand-kernel launches this program made on the card: the warm-up
        calls' and the graph's per replay times the replays."""
        return {k: self.warmup_launches.get(k, 0) + n * self.replays
                for k, n in self.launches.items()}


def _own(t: torch.Tensor, program: GraphedProgram) -> torch.Tensor:
    """A replay's output that the caller keeps: copied out of the graph's
    static buffer (device to device, asynchronously) before the next replay
    overwrites it."""
    return t.clone() if program.graphed else t


class FusedStreamState(NamedTuple):
    """Device-resident streaming state (everything the next frame needs)."""

    vm: OffsetVoxelMap
    prev_uv: torch.Tensor    # (cap, 2) f32 previous-frame keypoints
    prev_desc: torch.Tensor  # (cap, 128) f32 previous-frame descriptors
    prev_mask: torch.Tensor  # (cap,) bool
    R: torch.Tensor          # (3, 3) f32 world->camera of the last fused frame
    t: torch.Tensor          # (3,) f32
    scale: torch.Tensor      # () float64 running depth-scale EMA
    n_fused: torch.Tensor    # () int32 frames fused so far


N_STATE = 12   # the state's tensors, flattened (the map is five)


def _flat_state(st: FusedStreamState) -> tuple:
    return (*st.vm, *st[1:])


def _state_of(flat, program: GraphedProgram) -> FusedStreamState:
    f = [_own(t, program) for t in flat[:N_STATE]]
    return FusedStreamState(OffsetVoxelMap(*f[:5]), *f[5:])


class FusedStreamDiag(NamedTuple):
    """Per-frame outputs. ``row`` (``ROW`` float64) is what the host reads
    per frame (see ``read_rows``); ``depth`` and the features are device
    tensors, read only on keyframes."""

    row: torch.Tensor
    depth: torch.Tensor      # (H, W) f32
    uv: torch.Tensor         # (cap, 2) this frame's features
    desc: torch.Tensor       # (cap, 128)
    fmask: torch.Tensor      # (cap,)


class FusedStreamBatchDiag(NamedTuple):
    """Per-frame outputs of the batched step, the batch leading. Each row's
    map size is ``map_size``, the map's after the batch's insert. ``kf_*`` is each frame's CAMERA-frame
    keyframe cloud (``kf_cloud_points`` rows), so keyframe bookkeeping
    needs no second back-projection. Rows past the batch's valid frames
    are zeros."""

    rows: torch.Tensor       # (B, ROW)
    map_size: torch.Tensor   # () int32
    depth: torch.Tensor      # (B, H, W)
    uv: torch.Tensor         # (B, cap, 2)
    desc: torch.Tensor       # (B, cap, 128)
    fmask: torch.Tensor      # (B, cap)
    kf_xyz: torch.Tensor     # (B, kf_cloud_points, 3)
    kf_rgb: torch.Tensor     # (B, kf_cloud_points, 3)
    kf_mask: torch.Tensor    # (B, kf_cloud_points)


class DiagRows(NamedTuple):
    """Host view of a stack of diagnostic rows (numpy)."""

    R: np.ndarray            # (n, 3, 3) f32
    t: np.ndarray            # (n, 3) f32
    scale: np.ndarray        # (n,) float64
    n_matches: np.ndarray    # (n,) int
    n_inliers: np.ndarray
    fused: np.ndarray        # (n,) bool
    icp_frac: np.ndarray     # (n,) float64; -1 where ICP did not run
    icp_applied: np.ndarray  # (n,) bool
    map_size: np.ndarray     # (n,) int


def read_rows(rows: torch.Tensor) -> DiagRows:
    """(n, ROW) diagnostic rows -> their fields on the host (one read)."""
    a = rows.cpu().numpy().reshape(-1, ROW)
    as_int = lambda c: a[:, c].astype(np.int64)  # noqa: E731
    return DiagRows(
        R=a[:, ROW_R].reshape(-1, 3, 3).astype(np.float32),
        t=a[:, ROW_T].astype(np.float32), scale=a[:, ROW_SCALE],
        n_matches=as_int(ROW_MATCHES), n_inliers=as_int(ROW_INLIERS),
        fused=a[:, ROW_FUSED] > 0, icp_frac=a[:, ROW_ICP_FRAC],
        icp_applied=a[:, ROW_ICP_APPLIED] > 0, map_size=as_int(ROW_MAP_SIZE))


def init_fused_state(map_capacity: int, voxel_size: float,
                     feature_capacity: int, device) -> FusedStreamState:
    dev = torch.device(device)
    return FusedStreamState(
        vm=create_offset_map(map_capacity, voxel_size, dev),
        prev_uv=torch.zeros((feature_capacity, 2), dtype=torch.float32,
                            device=dev),
        prev_desc=torch.zeros((feature_capacity, 128), dtype=torch.float32,
                              device=dev),
        prev_mask=torch.zeros((feature_capacity,), dtype=torch.bool,
                              device=dev),
        R=torch.eye(3, dtype=torch.float32, device=dev),
        t=torch.zeros(3, dtype=torch.float32, device=dev),
        scale=torch.ones((), dtype=torch.float64, device=dev),
        n_fused=torch.zeros((), dtype=torch.int32, device=dev))


class _Carry(NamedTuple):
    """What one frame of the chain reads and writes: the state less the
    map (the batched step inserts once per batch)."""

    prev_uv: torch.Tensor
    prev_desc: torch.Tensor
    prev_mask: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    scale: torch.Tensor
    n_fused: torch.Tensor


class _Frame(NamedTuple):
    """One frame's chain outputs."""

    carry: _Carry
    ps: PointSet             # world points after ICP, insert mask applied
    cam_mask: torch.Tensor   # the back-projection's mask (keyframe cloud)
    R: torch.Tensor          # the frame's pose (after ICP)
    t: torch.Tensor
    row: torch.Tensor        # (ROW,) float64, map size -1


class _Chain:
    """The per-frame chain shared by both steps, with its constants."""

    def __init__(self, model, intr, cfg, h: int, w: int, *,
                 feature_capacity: int, n_features: Optional[int],
                 contrast_threshold: float, edge_threshold: float,
                 use_clahe: bool, use_icp: bool, metric_depth: bool,
                 icp_sample: int, device):
        self.model = model
        self.h, self.w = h, w
        self.in_hw = compute_da_resize(h, w, model.input_size)
        # v3's metric heads scale by focal length (depth_anything.py:infer)
        self.v3_factor = (float((intr.fx + intr.fy) / 2.0
                                / model.focal_length_ref)
                          if model.version == "v3" else 1.0)
        self.fx, self.fy = float(intr.fx), float(intr.fy)
        self.cx, self.cy = float(intr.cx), float(intr.cy)
        self.min_depth = float(cfg.min_depth)
        self.max_depth = float(cfg.max_depth)
        self.stride = int(cfg.subsample_factor)
        self.icp_iters = int(cfg.icp_iterations)
        self.icp_max_corr = float(cfg.icp_max_correspondence)
        self.cap = int(feature_capacity)
        self.n_features = n_features
        self.contrast_threshold = float(contrast_threshold)
        self.edge_threshold = float(edge_threshold)
        self.use_clahe = use_clahe
        self.use_icp = use_icp
        self.metric_depth = metric_depth
        self.icp_sample = int(icp_sample)
        self.device = torch.device(device)
        self.K = torch.from_numpy(
            intr.to_matrix().astype(np.float32)).to(self.device)

    def depth(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB -> (B, H, W) f32 depth: the model's
        device body (``DepthAnythingModel._forward``) and v3's factor."""
        depth = self.model._forward(rgb, *self.in_hw, self.h, self.w)
        return depth * self.v3_factor if self.v3_factor != 1.0 else depth

    def features(self, bgr: torch.Tensor):
        """SIFTDetector's device path on the frame's grey."""
        gray = bgr_to_gray(bgr)
        if self.use_clahe:
            gray = clahe(gray, 2.0, 8)
        f = sift_features(gray, capacity=self.cap,
                          contrast_threshold=self.contrast_threshold,
                          edge_threshold=self.edge_threshold,
                          n_features=self.n_features)
        return f.uv, f.desc, f.mask

    def icp_target(self, vm: OffsetVoxelMap):
        """The map's strided sample (the map is key-sorted, so a prefix
        would be one corner of the scene), its normals and whether it holds
        the 100 points ICP needs."""
        map_ps = offset_map_points(vm)
        n = map_ps.xyz.shape[0]
        tcap = min(self.icp_sample * 4, n)
        tstep = max(1, n // tcap)
        xyz = map_ps.xyz[::tstep][:tcap]
        mask = map_ps.mask[::tstep][:tcap]
        normals = estimate_normals(xyz, mask, 8, compact=False)
        return xyz, mask, normals, mask.sum() >= 100

    def frame(self, c: _Carry, rgb: torch.Tensor, depth: torch.Tensor,
              feats, prio: torch.Tensor, tgt) -> _Frame:
        """One frame of the chain (``txr``'s step body; the batched step's
        scan body). ``tgt`` is ``icp_target``'s tuple (None without ICP)."""
        uv, desc, fmask = feats
        dev = depth.device
        eye = torch.eye(3, dtype=torch.float32, device=dev)
        first = c.n_fused == 0
        with f32_dots():
            # relative pose against the previous frame (the stepwise
            # _estimate_pose_features)
            idx2, ok = match_l2_ratio(c.prev_desc, desc, c.prev_mask, fmask,
                                      0.75)
            uv2 = uv[idx2]
            R_rel, t_rel, X, valid, n_inl = pair_step(
                c.prev_uv, uv2, ok, self.K, None, 2.0, self.min_depth,
                self.max_depth * 10, priorities=(prio[0], prio[1]))
            # X is in the previous camera's frame; the depth pairs with
            # the CURRENT pixels, so transform first
            X_curr = X @ R_rel.T + t_rel
            s_i = clamp_scale(estimate_scale(X_curr, uv2, valid, depth))
            R_chain = R_rel @ c.R
            t_chain = R_rel @ c.t + t_rel
        n_inl = torch.where(first, 0, n_inl)
        feat_ok = ~first & (n_inl >= MIN_INLIERS)
        # first -> identity; features kept -> chained; else constant
        # position (ICP may rescue it)
        R_pose = torch.where(first, eye, torch.where(feat_ok, R_chain, c.R))
        t_pose = torch.where(first, 0.0, torch.where(feat_ok, t_chain, c.t))
        upd = feat_ok & (valid.sum() >= 5) & (not self.metric_depth)
        scale = torch.where(
            first, torch.ones_like(c.scale),
            torch.where(upd, ema_scale(c.scale, s_i.to(torch.float64)),
                        c.scale))
        # without ICP a frame whose features fail is skipped
        fused = (first | feat_ok) if not self.use_icp \
            else torch.ones_like(first)

        ps = backproject_world(
            depth, rgb, R_pose, t_pose, self.fx, self.fy, self.cx, self.cy,
            self.min_depth, self.max_depth,
            scale if not self.metric_depth else 1.0, self.stride)
        xyz = ps.xyz
        icp_frac = torch.full((), -1.0, dtype=torch.float32, device=dev)
        applied = torch.zeros((), dtype=torch.bool, device=dev)
        if self.use_icp:
            tgt_xyz, tgt_mask, normals, have_map = tgt
            n = xyz.shape[0]
            sstep = max(1, n // self.icp_sample)
            src_xyz = xyz[::sstep][:self.icp_sample]
            src_mask = ps.mask[::sstep][:self.icp_sample]
            do_icp = ~first & have_map & (src_mask.sum() >= 100)
            # run on every frame, taken where it succeeded: on the first
            # frame the target is empty and the result may be non-finite
            Rc, tc, _, frac = icp_point_to_plane(
                src_xyz, src_mask, tgt_xyz, normals, tgt_mask, eye,
                torch.zeros(3, dtype=torch.float32, device=dev),
                self.icp_iters, self.icp_max_corr, 1024, compact=False)
            with f32_dots():
                # the world correction X' = Rc X + tc folded into the pose
                R_new = R_pose @ Rc.T
                t_new = t_pose - R_new @ tc
                xyz_c = xyz @ Rc.T + tc[None, :]
            # as the stepwise path: kept only where it moves the pose
            moved = ~(torch.isclose(R_new, R_pose).all()
                      & torch.isclose(t_new, t_pose).all())
            applied = do_icp & (frac >= 0.3) & moved
            R_pose = torch.where(applied, R_new, R_pose)
            t_pose = torch.where(applied, t_new, t_pose)
            xyz = torch.where(applied, torch.where(ps.mask[:, None], xyz_c,
                                                   0.0), xyz)
            icp_frac = torch.where(do_icp, frac.to(torch.float32), -1.0)

        carry = _Carry(uv, desc, fmask,
                       torch.where(fused, R_pose, c.R),
                       torch.where(fused, t_pose, c.t),
                       scale, c.n_fused + fused.to(torch.int32))
        f64 = lambda v: v.to(torch.float64).reshape(-1)  # noqa: E731
        row = torch.cat([f64(R_pose), f64(t_pose), f64(scale), f64(ok.sum()),
                         f64(n_inl), f64(fused), f64(icp_frac), f64(applied),
                         f64(torch.full((), -1, device=dev))])
        return _Frame(carry, PointSet(xyz, ps.rgb, ps.mask & fused), ps.mask,
                      R_pose, t_pose, row)


class FusedStreamStep:
    """The per-frame fused step for one frame shape:
    ``step(state, bgr_u8, prio) -> (state', FusedStreamDiag)``.

    ``prio`` is the (2, 1024, feature_capacity) essential and homography
    priorities of this frame's pair (any values on a stream's first
    frame). The returned state and diagnostics belong to the caller."""

    def __init__(self, chain: _Chain):
        self.chain = chain
        self.program = GraphedProgram(self._fn, "fused_stream_step")

    @property
    def programs(self) -> List[GraphedProgram]:
        return [self.program]

    def _fn(self, *flat):
        ch = self.chain
        vm = OffsetVoxelMap(*flat[:5])
        carry = _Carry(*flat[5:N_STATE])
        bgr, prio = flat[N_STATE:]
        rgb = bgr.flip(-1)
        depth = ch.depth(rgb[None])[0]
        feats = ch.features(bgr)
        tgt = ch.icp_target(vm) if ch.use_icp else None
        fr = ch.frame(carry, rgb, depth, feats, prio, tgt)
        vm = offset_map_insert(vm, fr.ps)
        row = torch.cat([fr.row[:ROW_MAP_SIZE],
                         offset_map_size(vm).to(torch.float64).reshape(1)])
        return (*vm, *fr.carry, row, depth, *feats)

    def __call__(self, state: FusedStreamState, bgr: torch.Tensor,
                 prio: torch.Tensor):
        out = self.program(*_flat_state(state), bgr, prio)
        own = [_own(t, self.program) for t in out[N_STATE:]]
        return _state_of(out, self.program), FusedStreamDiag(*own)


def build_fused_stream_step(model, intr, cfg, *, h: int, w: int,
                            feature_capacity: int = 4096,
                            n_features: Optional[int] = None,
                            contrast_threshold: float = 0.01,
                            edge_threshold: float = 15.0,
                            use_clahe: bool = True, use_icp: bool = True,
                            metric_depth: bool = False,
                            icp_sample: int = 4096,
                            device=None) -> FusedStreamStep:
    """The per-frame step for one frame shape (``txr``'s
    ``build_fused_stream_step``). model: the port's ``DepthAnythingModel``
    (its ``_forward``, ``input_size``, ``version``, ``focal_length_ref``);
    intr: CameraIntrinsics; cfg: StreamingConfig; device: where the state
    lives (None: the model's)."""
    return FusedStreamStep(_Chain(
        model, intr, cfg, h, w, feature_capacity=feature_capacity,
        n_features=n_features, contrast_threshold=contrast_threshold,
        edge_threshold=edge_threshold, use_clahe=use_clahe, use_icp=use_icp,
        metric_depth=metric_depth, icp_sample=icp_sample,
        device=device if device is not None else model.device))


class FusedStreamBatchStep:
    """The batched fused step (``txr``'s ``build_fused_stream_batch_step``)
    for one frame shape and batch B, as three programs: the depth forward
    at batch B and the ICP target of the batch-start map (``head``), the
    per-frame chain replayed once per valid frame (``body``, ``txr``'s
    ``lax.scan`` body, detection included), and one insert of every fused
    frame's points (``tail``).

    ``step(state, frames_u8 (B, H, W, 3), n_valid, draw, first) ->
    (state', FusedStreamBatchDiag)``: ``draw()`` returns the next
    non-initial frame's (2, 1024, cap) priorities, called in frame order;
    ``first`` says the state has fused no frame yet (frame 0 then draws
    nothing). Frames at or past ``n_valid`` are padding: the chain does not
    run for them, so they draw nothing, never fuse and leave the state
    alone.

    ``txr``'s three documented deltas from the per-frame step hold: ICP
    registers each frame against the map as of the batch start; the insert
    is one merge (per-voxel sums equal up to summation order); a loop
    closure that rebuilds the map mid-batch replaces the whole batch's
    insert with the keyframe-only re-fusion."""

    def __init__(self, chain: _Chain, batch: int, kf_cloud_points: int):
        self.chain, self.B, self.P = chain, int(batch), int(kf_cloud_points)
        self.head = GraphedProgram(self._head, "fused_stream_batch_head")
        self.body = GraphedProgram(self._body, "fused_stream_batch_body")
        self.tail = GraphedProgram(self._tail, "fused_stream_batch_tail")

    @property
    def programs(self) -> List[GraphedProgram]:
        return [self.head, self.body, self.tail]

    def _head(self, *flat):
        ch = self.chain
        vm = OffsetVoxelMap(*flat[:5])
        depth = ch.depth(flat[5].flip(-1))
        return (depth, *ch.icp_target(vm)) if ch.use_icp else (depth,)

    def _body(self, *flat):
        ch = self.chain
        carry = _Carry(*flat[:7])
        bgr, depth, prio = flat[7:10]
        tgt = flat[10:] if ch.use_icp else None
        rgb = bgr.flip(-1)
        feats = ch.features(bgr)
        fr = ch.frame(carry, rgb, depth, feats, prio, tgt)
        # the CAMERA-frame keyframe cloud: the world points mapped back
        # through the frame's (post-ICP) pose, padded to P rows
        n = fr.ps.xyz.shape[0]
        kstep = max(1, n // self.P)
        with f32_dots():
            kf_xyz = fr.ps.xyz[::kstep][:self.P] @ fr.R.T + fr.t[None, :]
        kf = (kf_xyz, fr.ps.rgb[::kstep][:self.P], fr.cam_mask[::kstep]
              [:self.P])
        pad = self.P - kf[0].shape[0]
        if pad > 0:
            kf = (torch.nn.functional.pad(kf[0], (0, 0, 0, pad)),
                  torch.nn.functional.pad(kf[1], (0, 0, 0, pad)),
                  torch.nn.functional.pad(kf[2], (0, pad)))
        return (*fr.carry, fr.ps.xyz, fr.ps.rgb, fr.ps.mask, fr.row, *feats,
                *kf)

    def _tail(self, *flat):
        vm = offset_map_insert(OffsetVoxelMap(*flat[:5]),
                               PointSet(*flat[5:8]))
        return (*vm, offset_map_size(vm))

    def __call__(self, state: FusedStreamState, frames: torch.Tensor,
                 n_valid: int, draw: Callable[[], torch.Tensor],
                 first: bool):
        B, P, ch = self.B, self.P, self.chain
        dev = frames.device
        head = self.head(*state.vm, frames)
        depth = _own(head[0], self.head)
        tgt = head[1:]
        carry = tuple(state[1:])
        zero_prio = torch.zeros((2, PAIR_HYPOTHESES, ch.cap),
                                dtype=torch.float32, device=dev)
        slots = None
        for i in range(int(n_valid)):
            prio = zero_prio if (first and i == 0) else draw()
            out = self.body(*carry, frames[i], depth[i], prio, *tgt)
            carry = out[:7]
            if slots is None:   # per-frame outputs, zeros past n_valid
                slots = [torch.zeros((B, *t.shape), dtype=t.dtype,
                                     device=dev) for t in out[7:]]
            for s, t in zip(slots, out[7:]):
                s[i].copy_(t)
        new_carry = [_own(t, self.body) for t in carry]
        xyz, rgb, mask, rows, uv, desc, fmask, kf_xyz, kf_rgb, kf_mask = \
            slots
        tail = self.tail(*state.vm, xyz.reshape(-1, 3), rgb.reshape(-1, 3),
                         mask.reshape(-1))
        vm = OffsetVoxelMap(*(_own(t, self.tail) for t in tail[:5]))
        map_size = _own(tail[5], self.tail)
        rows[:, ROW_MAP_SIZE] = map_size.to(torch.float64)
        new_state = FusedStreamState(vm, *new_carry)
        return new_state, FusedStreamBatchDiag(
            rows, map_size, depth, uv, desc, fmask, kf_xyz, kf_rgb, kf_mask)


def build_fused_stream_batch_step(model, intr, cfg, *, h: int, w: int,
                                  batch: int, feature_capacity: int = 4096,
                                  n_features: Optional[int] = None,
                                  contrast_threshold: float = 0.01,
                                  edge_threshold: float = 15.0,
                                  use_clahe: bool = True,
                                  use_icp: bool = True,
                                  metric_depth: bool = False,
                                  icp_sample: int = 4096,
                                  kf_cloud_points: int = 16384,
                                  device=None) -> FusedStreamBatchStep:
    """The batched step for one frame shape and batch (see
    ``FusedStreamBatchStep``)."""
    return FusedStreamBatchStep(_Chain(
        model, intr, cfg, h, w, feature_capacity=feature_capacity,
        n_features=n_features, contrast_threshold=contrast_threshold,
        edge_threshold=edge_threshold, use_clahe=use_clahe, use_icp=use_icp,
        metric_depth=metric_depth, icp_sample=icp_sample,
        device=device if device is not None else model.device),
        batch, kf_cloud_points)
