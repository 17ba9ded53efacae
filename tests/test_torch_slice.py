"""The whole main-path step through ``txr`` and through the port at a tiny
size: uint8 frames -> bicubic resize + normalize -> depth model ->
back-projection on the model's depth grid -> voxel-map insert.

The step is the one ``bench.py`` times (and ``chip_smoke.py`` drives on the
card): 4 frames of 60x80, a narrow 2-layer model, map capacity 4096. The
``txr`` side runs its Pallas attention and tail kernels in interpret mode;
the port runs with ``device="cpu"``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from txr.core.types import PointSet as JPointSet
from txr.fusion import offset_map as jo
from txr.models.depth_anything import DepthAnythingFlax
from txr.models.dpt import DPTConfig as JDPTConfig
from txr.models.vit import ViTConfig as JViTConfig
from txr.ops import resize as jr
from txr.ops.backproject import backproject_world as j_backproject_world

from txr_torch.core.types import PointSet
from txr_torch.fusion import offset_map as po
from txr_torch.models.convert import from_txr_params
from txr_torch.models.depth_anything import DepthAnything
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.ops import resize as tr
from txr_torch.ops.backproject import backproject_world

torch.set_num_threads(1)

H, W, FRAMES, CAP, VOXEL = 60, 80, 4, 4096, 0.25
FX = FY = 0.8 * W
CX, CY = W / 2.0, H / 2.0


def _models():
    kw = dict(hidden_size=32, num_layers=2, num_heads=2, pos_embed_size=4,
              out_layers=(0, 0, 1, 1))
    jd = dict(features=16, out_channels=(8, 12, 16, 16), head_hidden=8)
    fm = DepthAnythingFlax(vit=JViTConfig(use_flash=True, **kw),
                           dpt=JDPTConfig(fused_head=True, **jd))
    params = fm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 56, 56, 3), jnp.float32))["params"]
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    # lift the final ReLU's input so most pixels carry a positive depth
    params["head"]["head_conv3"]["bias"] = \
        params["head"]["head_conv3"]["bias"] + 1.0
    pm = DepthAnything(ViTConfig(**kw), DPTConfig(**jd)).eval()
    pm.load_state_dict(from_txr_params(params))
    return fm, jax.tree_util.tree_map(jnp.asarray, params), pm


def _keys(khi, klo_x, yzw):
    occ = (np.asarray(yzw).astype(np.uint32) & 0x7FF) > 0
    k = (np.asarray(khi).astype(np.int64) << 32) | \
        ((np.asarray(klo_x).astype(np.int64) + (1 << 31)) >> 10)
    return k[occ], occ


def test_whole_step_matches_txr():
    fm, jparams, pm = _models()
    in_h, in_w = jr.compute_da_resize(H, W, 56)
    assert (in_h, in_w) == tr.compute_da_resize(H, W, 56) == (56, 70)
    sx, sy = in_w / W, in_h / H
    frames = np.random.default_rng(0).integers(0, 256, (FRAMES, H, W, 3),
                                               dtype=np.uint8)

    # ---- txr
    x = jnp.asarray(frames).astype(jnp.float32) / 255.0
    xm = jr.resize_bicubic(x, in_h, in_w, align_corners=False)
    xn = (xm - jnp.asarray(jr.IMAGENET_MEAN)) / jnp.asarray(jr.IMAGENET_STD)
    jdepth = fm.apply({"params": jparams}, xn).astype(jnp.float32)
    eye, zero = jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)
    ps = jax.vmap(lambda d, c: j_backproject_world(
        d, c, eye, zero, FX * sx, FY * sy, CX * sx, CY * sy, 1e-4, 1e6, 1.0,
        1))(jdepth, xm)
    n = FRAMES * in_h * in_w
    jvm = jo.offset_map_insert(
        jo.create_offset_map(CAP, VOXEL),
        JPointSet(ps.xyz.reshape(n, 3), ps.rgb.reshape(n, 3),
                  ps.mask.reshape(n)))

    # ---- port
    with torch.no_grad():
        t = torch.from_numpy(frames).to(torch.float32) / 255.0
        tm = tr.resize_bicubic(t, in_h, in_w, align_corners=False)
        tn = (tm - tm.new_tensor(tr.IMAGENET_MEAN)) / \
            tm.new_tensor(tr.IMAGENET_STD)
        pdepth = pm(tn).to(torch.float32)
        pps = backproject_world(pdepth, tm, torch.eye(3), torch.zeros(3),
                                FX * sx, FY * sy, CX * sx, CY * sy, 1e-4,
                                1e6, 1.0, 1)
        pvm = po.offset_map_insert(
            po.create_offset_map(CAP, VOXEL, device="cpu"),
            PointSet(pps.xyz.reshape(n, 3), pps.rgb.reshape(n, 3),
                     pps.mask.reshape(n)))

    # the depth itself: f32 on both sides, 2e-4 (1e-4 for the model as in
    # test_torch_model.py, plus the preprocessing's own reordering)
    assert pdepth.shape == (FRAMES, in_h, in_w)
    np.testing.assert_allclose(pdepth.numpy(), np.asarray(jdepth),
                               rtol=2e-4, atol=2e-4)
    valid = float((pdepth > 1e-4).float().mean())
    assert valid > 0.5, valid

    # the map: a depth difference below 1e-4 can carry a point across a
    # voxel face, which moves one count between two neighbouring voxels (or
    # creates / empties one at the rim), so the voxel SETS are compared by
    # overlap and the means only where both sides counted the same points
    gk, gocc = _keys(pvm.khi.numpy(), pvm.klo_x.numpy(), pvm.yzw.numpy())
    wk, wocc = _keys(jvm.khi, jvm.klo_x, jvm.yzw)
    size = int(po.offset_map_size(pvm))
    assert size == len(gk) and 100 < size < CAP
    common = np.intersect1d(gk, wk)
    overlap = len(common) / len(np.union1d(gk, wk))
    assert overlap >= 0.99, overlap

    gp = po.offset_map_points(pvm)
    wp = jo.offset_map_points(jvm)
    gi = np.flatnonzero(gocc)[np.isin(gk, common)]
    wi = np.flatnonzero(wocc)[np.isin(wk, common)]
    gw = pvm.count.numpy()[gi]
    ww = np.asarray(jvm.count)[wi]
    same = gw == ww
    assert same.mean() > 0.98
    dxyz = np.abs(gp.xyz.numpy()[gi] - np.asarray(wp.xyz)[wi])[same]
    drgb = np.abs(gp.rgb.numpy()[gi] - np.asarray(wp.rgb)[wi])[same]
    # one stored quantum, plus the depth tolerance carried into the mean
    assert dxyz.max() <= VOXEL / 1024 + 3e-4, dxyz.max()
    assert drgb.max() <= 1.0 / 256 + 1e-4, drgb.max()
