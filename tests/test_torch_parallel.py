"""The port's scale-out (``txr_torch/parallel``, the sharded train step of
``txr_torch/train.py``, ``multichip_torch.py``) on gloo CPU ranks, against
single-process runs and, for the map merge, against ``txr``.

One launch of 4 ranks on a dp 2 x tp 2 mesh (``_mesh_rank``) runs every
check that needs a group and hands its results back; the tests read them.
The rank functions live at the top of this module, which imports neither
JAX nor ``txr`` at the top (the ranks import it by name); the tests that
compare with ``txr`` import it where they need it.
"""

import numpy as np
import pytest
import torch

from multichip_torch import tiny_model
from txr_torch.core.types import PointSet
from txr_torch.fusion.offset_map import (NCOLS, OffsetVoxelMap,
                                         create_offset_map, offset_map_insert,
                                         offset_map_points, offset_map_size)
from txr_torch.ops.backproject import backproject_world
from txr_torch.ops.resize import IMAGENET_MEAN, IMAGENET_STD
from txr_torch.parallel.launch import run_ranks
from torch.distributed.tensor import Replicate, Shard
from txr_torch.parallel.mesh import (batch_sharding, make_mesh,
                                     param_placement, param_shardings,
                                     replicated, shard_batch, shard_params,
                                     unshard_grads, unshard_state_dict)
from txr_torch.parallel.pipeline import (create_sharded_maps,
                                         make_sharded_fusion_step,
                                         merge_sharded_maps,
                                         stack_sharded_maps)
import txr_torch.train as train

torch.set_num_threads(1)

DP, TP = 2, 2
LR = 1e-3
# the sharded and unsharded steps add in another order (row-parallel
# all-reduces, the loss's sums over dp, the norm over tp shards): f32
# round-off only
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5
# the parameters after three steps: f32 round-off moved through Adam
# (measured 0.14 lr); a skipped or halved third update is 1 or 0.5 lr off
PARAM_ATOL = 0.4 * LR
FWD_TOL = dict(rtol=1e-4, atol=1e-5)      # txr's test_sharded_forward
VOXEL = 0.05


def seeded_tiny():
    model = tiny_model()
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head.head_conv3.bias.add_(1.0)   # a positive prediction
    return model


def train_batch(b=4, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, 56, 56, 3)).astype(np.float32)
    tgt = rng.uniform(0.5, 3.0, (b, 56, 56)).astype(np.float32)
    mask = rng.uniform(size=(b, 56, 56)) < 0.9
    return [torch.from_numpy(a) for a in (img, tgt, mask)]


class StubDepth:
    """``txr``'s idea: depth from pixel intensity, no tp numerics, so the
    sharded points equal the single-process ones bit for bit."""

    def __call__(self, frames):
        return 1.0 + 3.0 * frames.mean(-1)


def fusion_inputs(b=8, h=16, w=24, seed=0):
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.uniform(0, 1, (b, h, w, 3)).astype(
        np.float32))
    ths = np.linspace(0, 0.3, b).astype(np.float32)
    Rs = torch.from_numpy(np.stack([np.array(
        [[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]],
        np.float32) for t in ths]))
    ts = torch.from_numpy(np.stack([np.array([0.1 * i, 0, 0], np.float32)
                                    for i in range(b)]))
    scales = torch.from_numpy(np.linspace(0.9, 1.1, b).astype(np.float32))
    return frames, Rs, ts, scales, (20.0, 20.0, w / 2.0, h / 2.0)


def _mesh_rank(rank: int, world: int) -> dict:
    mesh = make_mesh(dp=DP, tp=TP)
    out = {"mesh": (mesh["dp"].size(), mesh["tp"].size()),
           "coord": (mesh.get_local_rank("dp"), mesh.get_local_rank("tp"))}

    # the divisibility error fires before anything is moved
    from txr_torch.models.depth_anything import DepthAnything
    from txr_torch.models.dpt import DPTConfig
    from txr_torch.models.vit import ViTConfig

    errors = []
    for hidden, heads in ((99, 3), (64, 1)):
        bad = DepthAnything(
            ViTConfig(hidden_size=hidden, num_layers=1, num_heads=heads,
                      pos_embed_size=4, out_layers=(0, 0, 0, 0)),
            DPTConfig(features=32, out_channels=(16, 16, 32, 32),
                      head_hidden=16))
        try:
            shard_params(bad, mesh)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    out["errors"] = errors

    # forward: this rank's dp slice through the tp-sharded model
    model = seeded_tiny()
    out["rules"] = {n: tuple(repr(p) for p in pl)
                    for n, pl in param_shardings(model, mesh).items()}
    shard_params(model, mesh)
    out["placements"] = {
        n: str(tuple(p.placements)) if hasattr(p, "placements") else None
        for n, p in model.named_parameters()}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 56, 56, 3)).astype(np.float32))
    with torch.no_grad():
        out["forward"] = model(shard_batch(x, mesh)).numpy()

    # three sharded train steps on the global batch
    model = seeded_tiny()
    opt = train.make_optimizer(lr=LR, warmup_steps=1, total_steps=100)
    shard_params(model, mesh)
    adam, sched = opt.init(model.parameters())
    state = train.TrainState(model, adam, sched)
    step = train.make_sharded_train_step(model, opt, mesh)
    local = [shard_batch(t, mesh) for t in train_batch()]
    losses, norms = [], []
    for i in range(3):
        state, loss = step(state, *local)
        losses.append(loss.item())
        norms.append(state.grad_norm.item())
        if i == 0:
            out["grads"] = {k: v.numpy().copy() for k, v in
                           unshard_grads(model).items()}
    out["losses"], out["norms"] = losses, norms
    out["params"] = {k: v.numpy() for k, v in
                     unshard_state_dict(model).items()}
    out["moments"] = {
        n: [str(tuple(state.optimizer.state[p][k].placements))
            if hasattr(p, "placements") else None
            for k in ("exp_avg", "exp_avg_sq")]
        for n, p in model.named_parameters()}

    # the sharded fusion step, twice, then the merge of the dp maps
    frames, Rs, ts, scales, intr = fusion_inputs()
    fuse = make_sharded_fusion_step(StubDepth(), intr,
                                    min_depth=1e-3, max_depth=100.0)
    vm = create_sharded_maps(mesh, 4096, VOXEL)
    args = [shard_batch(t, mesh) for t in (frames, Rs, ts, scales)]
    vm = fuse(*args, vm)
    vm = fuse(*args, vm)
    merged = merge_sharded_maps(stack_sharded_maps(vm, mesh))
    out["merged"] = [c.numpy() for c in merged[:NCOLS]]
    return out


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_mesh_rank, DP * TP, timeout_s=240)


def test_mesh_shape(ranks):
    assert all(r["mesh"] == (DP, TP) for r in ranks)
    coords = sorted(r["coord"] for r in ranks)
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_param_placements_by_rule(ranks):
    rules, placed = ranks[0]["rules"], ranks[0]["placements"]
    assert rules["encoder.block_0.attn.qkv.weight"] == ("Replicate()",
                                                        "Shard(dim=0)")
    assert rules["encoder.block_0.attn.qkv.bias"] == ("Replicate()",
                                                      "Shard(dim=0)")
    assert rules["encoder.block_1.attn.proj.weight"] == ("Replicate()",
                                                         "Shard(dim=1)")
    assert rules["encoder.block_1.mlp.fc2.bias"] == ("Replicate()",
                                                     "Replicate()")
    assert rules["encoder.patch_embed.weight"] == ("Replicate()",
                                                   "Replicate()")
    assert param_placement("x.mlp.w12.weight").is_shard(0)
    assert param_placement("x.mlp.w3.weight").is_shard(1)
    assert batch_sharding(None) == (Shard(0), Replicate())
    assert replicated(None) == (Replicate(), Replicate())
    for name, rule in rules.items():
        if rule[1] == "Replicate()":
            # replicated parameters stay plain tensors, except the bias of
            # a row-parallel layer, which the layer replicates on tp
            assert placed[name] in (None, "(Replicate(),)"), name
        else:
            assert placed[name] == f"({rule[1]},)", name
    assert sum(p is not None and "Shard" in p for p in placed.values()) == 12


def test_divisibility_error_names_the_parameter(ranks):
    odd, heads = ranks[0]["errors"]
    assert "encoder.block_0.attn.qkv.weight" in odd
    assert "not divisible by tp=2" in odd
    assert "encoder.block_0.attn.qkv.weight" in heads and "heads" in heads


def test_sharded_forward_matches_single(ranks):
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 56, 56, 3)).astype(np.float32))
    with torch.no_grad():
        want = seeded_tiny()(x).numpy()
    by_coord = {r["coord"]: r["forward"] for r in ranks}
    for (d, t), got in by_coord.items():
        np.testing.assert_allclose(got, want[d * 2:(d + 1) * 2], **FWD_TOL,
                                   err_msg=f"rank at dp {d}, tp {t}")


def test_sharded_train_step_matches_unsharded(ranks):
    """The same global batch through the unsharded step: the losses, the
    gradient norm (a factor of dp in the gradients shows here), the
    gradients after the first step and the parameters after three."""
    model = seeded_tiny()
    opt = train.make_optimizer(lr=LR, warmup_steps=1, total_steps=100)
    adam, sched = opt.init(model.parameters())
    state = train.TrainState(model, adam, sched)
    step = train.make_train_step(model, opt)
    batch = train_batch()
    losses, norms = [], []
    for i in range(3):
        state, loss = step(state, *batch)
        losses.append(loss.item())
        norms.append(state.grad_norm.item())
        if i == 0:
            grads = {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()}
    params = dict(model.named_parameters())
    for r in ranks:
        np.testing.assert_allclose(r["losses"], losses, rtol=LOSS_RTOL)
        # the first two steps start from the same weights (lr 0 at step 0);
        # the third from weights already apart by Adam's round-off flips
        np.testing.assert_allclose(r["norms"][:2], norms[:2], rtol=LOSS_RTOL)
        for name, g in grads.items():
            np.testing.assert_allclose(
                r["grads"][name], g, rtol=GRAD_RTOL,
                atol=GRAD_ATOL_OF_MAX * np.abs(g).max(), err_msg=name)
        for name, p in params.items():
            np.testing.assert_allclose(r["params"][name],
                                       p.detach().numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=name)


def test_moments_placed_like_their_params(ranks):
    for r in ranks:
        for name, (m, v) in r["moments"].items():
            assert m == v == r["placements"][name], name


def _key_sorted(vm: OffsetVoxelMap):
    p = offset_map_points(vm)
    m = p.mask.numpy()
    xyz, rgb = p.xyz.numpy()[m], p.rgb.numpy()[m]
    o = np.lexsort(np.floor(xyz / VOXEL).astype(np.int64).T)
    return xyz[o], rgb[o]


def test_sharded_fusion_matches_sequential(ranks):
    """The dp maps merged against one map fed every frame's points
    (twice), as ``txr``'s ``test_sharded_matches_sequential``."""
    frames, Rs, ts, scales, (fx, fy, cx, cy) = fusion_inputs()
    mean = torch.tensor(IMAGENET_MEAN)
    std = torch.tensor(IMAGENET_STD)
    depth = StubDepth()((frames - mean) / std)
    ps = backproject_world(depth, frames, Rs, ts, fx, fy, cx, cy, 1e-3,
                           100.0, scales.reshape(-1, 1, 1), 1)
    n = ps.xyz.shape[0] * ps.xyz.shape[1]
    flat = PointSet(ps.xyz.reshape(n, 3), ps.rgb.reshape(n, 3),
                    ps.mask.reshape(n))
    ref = create_offset_map(4096, VOXEL, device="cpu")
    ref = offset_map_insert(offset_map_insert(ref, flat), flat)
    for r in ranks:
        merged = OffsetVoxelMap(*[torch.from_numpy(c) for c in r["merged"]],
                                torch.tensor(VOXEL))
        assert int(offset_map_size(merged)) == int(offset_map_size(ref)) > 0
        mxyz, mrgb = _key_sorted(merged)
        rxyz, rrgb = _key_sorted(ref)
        # one more merge level than the sequential map: each re-quantizes
        # the means at voxel / 1024 (txr's tolerance)
        np.testing.assert_allclose(mxyz, rxyz, atol=VOXEL * 4e-3)
        np.testing.assert_allclose(mrgb, rrgb, atol=8e-3)


@pytest.mark.parametrize("dp", [2, 5])
def test_merge_equals_txr(dp):
    """``merge_sharded_maps`` against ``txr``'s on the same stacked maps,
    bit for bit (5: the odd map carried to the next round)."""
    import jax.numpy as jnp
    from txr.fusion.offset_map import OffsetVoxelMap as TxrMap
    from txr.parallel.pipeline import merge_sharded_maps as txr_merge

    rng = np.random.default_rng(dp)
    maps = []
    for i in range(dp):
        xyz = rng.normal(0, 0.4, (500, 3)).astype(np.float32)
        rgb = rng.uniform(0, 1, (500, 3)).astype(np.float32)
        pts = PointSet.from_numpy(xyz, rgb, device="cpu")
        maps.append(offset_map_insert(
            create_offset_map(4096, VOXEL, device="cpu"), pts))
    stacked = OffsetVoxelMap(*[torch.stack([m[c] for m in maps])
                               for c in range(NCOLS)], maps[0].voxel_size)
    got = merge_sharded_maps(stacked)
    want = txr_merge(TxrMap(*[jnp.asarray(c.numpy()) for c in stacked[:NCOLS]],
                            jnp.float32(VOXEL)))
    for g, w in zip(got[:NCOLS], want[:NCOLS]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(offset_map_size(got)) > 0


def _failing_rank(rank: int, world: int) -> int:
    if rank == 1:
        raise ValueError("rank one fails on purpose")
    return rank


def test_launcher_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank one fails on purpose"):
        run_ranks(_failing_rank, 2, timeout_s=120)


def test_dryrun_multichip():
    import multichip_torch

    out = multichip_torch.dryrun_multichip(4)
    assert [(r["dp"], r["tp"]) for r in out] == [(2, 2)] * 4
    assert all(np.isfinite(r["loss"]) and r["voxels"] > 0 and r["step"] == 1
               for r in out)
    assert len({r["loss"] for r in out}) == 1


def test_entry_returns_the_flagship_forward(monkeypatch):
    """``multichip_torch.entry`` builds v2 / ViT-L and an example input at
    518 x 518 in bf16; here with the registry entry narrowed, on the CPU."""
    import multichip_torch
    import txr_torch.models.depth_anything as pda
    from txr_torch.models.vit import ViTConfig

    monkeypatch.setitem(pda.VIT_PRESETS, "vitl", ViTConfig(
        hidden_size=32, num_layers=2, num_heads=2, out_layers=(0, 0, 1, 1)))
    monkeypatch.setitem(pda.MODEL_CONFIGS["v2"], "vitl", {
        "encoder": "vitl", "features": 16, "out_channels": [8, 12, 16, 16]})
    fn, (pixels,) = multichip_torch.entry(device="cpu")
    assert pixels.shape == (1, 518, 518, 3) and pixels.dtype == torch.bfloat16
    depth = fn(pixels)
    assert depth.shape == (1, 518, 518) and depth.dtype == torch.bfloat16
    assert torch.isfinite(depth.float()).all()
