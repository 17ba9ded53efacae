"""The registry's model configurations at their real widths, on the CPU.

Parity: ViT-B, ViT-G (bf16 policy and ``int8mix``) and the V3 metric
model (``large``, VKITTI head, 80 m) at their full widths (hidden size,
heads, SwiGLU, DPT features and reassembly channels as the registry gives
them) cut to 2 blocks, through both packages' ``DepthAnythingModel`` on
56 x 56 frames in f32, one perturbed weight set carried from ``txr`` to the
port by ``from_txr_params``; ``txr`` runs its defaults on the CPU and the
port its plain versions (``device="cpu"``).

Geometry: the kernels' launch plans (pure functions of the shapes) at every
registry entry's shapes and at 1, 8, 24 and 32 frames a step, the shapes
``chip_smoke.py``'s ``registry_path`` and ``batch_path`` launch on the
card.
"""

from dataclasses import replace

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import txr.models.depth_anything as jda
import txr.models.vit as jvit
from txr.core.intrinsics import CameraIntrinsics as TxrIntrinsics

import txr_torch.models.depth_anything as pda
import txr_torch.models.vit as pvit
from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.models.convert import from_txr_params
from txr_torch.ops import attention, conv_stripe, dpt_tail, quant_fused
from txr_torch.ops.resize import compute_da_resize

torch.set_num_threads(4)

BLOCKS, IMG = 2, 56
# As shares of the depth's span. f32 on both sides over sums of up to 4096
# terms (SwiGLU's w3) taken in another order, through LayerNorms and a DPT
# head of 1536 channels: readings 2.1e-6 to 4.9e-6 (max), 0 to 4.9e-7
# (median). int8mix: the two packages agree on every quantised integer but
# where a value sits on a rounding tie within float error (txr's kernel
# divides by 127.0, the port by a tensor of 127): 0.06 % of one w3
# product's outputs at K = 4096 move by a quantum, and two blocks and the
# head spread it; readings 1.2e-2 (max) and 0 (median); where a flip lands
# is the draw's, so the narrow models' bounds (tests/test_torch_quant.py)
# with the max doubled
SPAN_TOL = {"none": dict(max=1e-4, median=1e-6),
            "int8mix": dict(max=5e-2, median=1e-3)}

CASES = {
    "v2-vitb": dict(version="v2", encoder="vitb"),
    "v2-vitg": dict(version="v2", encoder="vitg"),
    "v2-vitg-int8mix": dict(version="v2", encoder="vitg", quant="int8mix"),
    "v3-large-metric-vkitti": dict(version="v3", encoder="large",
                                   metric=True, dataset="vkitti",
                                   max_depth=80.0),
}


def _two_blocks(monkeypatch, encoder: str) -> None:
    """Both packages' preset of ``encoder``'s registry entry at its full
    width with its first two blocks."""
    version = "v3" if encoder == "large" else "v2"
    key = pda.MODEL_CONFIGS[version][encoder]["encoder"]
    for presets, cfg in ((jvit.VIT_PRESETS, jvit.ViTConfig),
                         (pvit.VIT_PRESETS, pvit.ViTConfig)):
        full = presets[key]
        assert isinstance(full, cfg)
        monkeypatch.setitem(presets, key, replace(
            full, num_layers=BLOCKS, out_layers=(0, 0, 1, 1)))


def _jit_init(monkeypatch) -> None:
    """txr's ``DepthAnythingModel`` initialises its parameters eagerly
    (14 s for ViT-G's two blocks and head on the CPU); the same ``init``
    under ``jax.jit`` takes half that."""
    init = nn.Module.init
    monkeypatch.setattr(
        jda.DepthAnythingFlax, "init",
        lambda self, key, x: jax.jit(lambda k, y: init(self, k, y))(key, x))


def _perturbed(params, seed: int):
    """txr's init leaves every bias at zero and LayerNorm and LayerScale at
    one: those leaves get a seeded perturbation of 0.02, so that no term of
    the forward is switched off; the random kernels stay as drawn."""
    rng = np.random.default_rng(seed)

    def bump(a):
        a = np.asarray(a, np.float32)
        if a.std() > 0:
            return a
        return a + 0.02 * rng.standard_normal(a.shape, dtype=np.float32)

    return jax.tree_util.tree_map(bump, params)


@pytest.mark.parametrize("case", list(CASES))
def test_full_width_two_blocks_match_txr(case, monkeypatch):
    kw = CASES[case]
    _two_blocks(monkeypatch, kw["encoder"])
    _jit_init(monkeypatch)
    jm = jda.DepthAnythingModel(param_dtype=jnp.float32, input_size=IMG,
                                seed=0, **kw)
    params = _perturbed(jm.params, seed=11)
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    pm = pda.DepthAnythingModel(param_dtype=torch.float32, input_size=IMG,
                                device="cpu", **kw)
    loaded = pm.model.load_state_dict(from_txr_params(params), strict=True)
    assert not loaded.missing_keys and not loaded.unexpected_keys

    vit, dpt = pm.vit_cfg, pm.dpt_cfg
    entry = pda.MODEL_CONFIGS[kw["version"]][kw["encoder"]]
    full = pvit.VIT_PRESETS[entry["encoder"]]
    assert (vit.hidden_size, vit.num_heads, vit.use_swiglu) == (
        full.hidden_size, full.num_heads, full.use_swiglu)
    assert vit.num_layers == BLOCKS and vit.quant == kw.get("quant", "none")
    assert dpt.features == entry["features"]
    assert list(dpt.out_channels) == entry["out_channels"]
    assert dpt.metric == kw.get("metric", False)
    assert dpt.max_depth == kw.get("max_depth", 20.0)

    images = np.random.default_rng(12).integers(0, 256, (2, IMG, IMG, 3),
                                                dtype=np.uint8)
    assert compute_da_resize(IMG, IMG, IMG) == (IMG, IMG)
    k = dict(fx=61.0, fy=63.0, cx=28.0, cy=28.0, width=IMG, height=IMG)
    want = jm.infer_batch(images, TxrIntrinsics(**k))
    got = pm.infer_batch(images, CameraIntrinsics(**k))
    assert got.shape == want.shape == (2, IMG, IMG)
    assert np.isfinite(got).all()
    span = float(want.max() - want.min())
    assert span > 1e-3
    rel = np.abs(got - want) / span
    tol = SPAN_TOL[kw.get("quant", "none")]
    assert rel.max() <= tol["max"], rel.max()
    assert np.median(rel) <= tol["median"], np.median(rel)
    if kw["version"] == "v3":
        # the focal rescale: sigmoid x 80 m times ((fx + fy) / 2) / 300
        unscaled = pm.infer_batch(images)
        np.testing.assert_allclose(got, unscaled * (62.0 / 300.0),
                                   rtol=1e-6)
        assert 0 < unscaled.min() and unscaled.max() <= 80.0


# ------------------------------------------------------------- geometry

SMS = 132                        # an H100 SXM's multiprocessors
BATCHES = (1, 8, 24, 32)
REGISTRY = [(v, e) for v, entries in pda.MODEL_CONFIGS.items()
            for e in entries]
IN_H, IN_W = compute_da_resize(1080, 1920, 518)          # 518 x 924
PH, PW = IN_H // 14, IN_W // 14
TOKENS = PH * PW + 1                                     # 2443


def _vit(version: str, encoder: str):
    return pvit.VIT_PRESETS[pda.MODEL_CONFIGS[version][encoder]["encoder"]]


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("version,encoder", REGISTRY)
def test_tail_plan_fits_every_registry_head(version, encoder, batch):
    """The tail at each head's width (features / 2) on the real 296 x 528
    -> 518 x 924 resize: a plan within a block's shared memory, every
    channel chunk resident, 32-bit work counts."""
    c = pda.MODEL_CONFIGS[version][encoder]["features"] // 2
    geo = dpt_tail.kernel_geometry(batch, 8 * PH, 8 * PW, c, IN_H, IN_W,
                                   SMS)
    assert geo["smem_bytes"] <= dpt_tail.MAX_SMEM_BYTES
    assert geo["chunks"] == -(-c // dpt_tail.CHUNK_C)
    assert geo["weight_bytes"] == 9 * geo["chunks"] * 32 * 64 * 2
    assert geo["tiles"] * 9 * geo["chunks"] < 2 ** 31
    assert geo["grid"] == min(geo["tiles"], SMS)
    nty, ntx = geo["tiles_yx"]
    assert nty * geo["tile"][0] >= IN_H and ntx * geo["tile"][1] >= IN_W
    if c == 192:
        # ViT-G: the tightest plan any launch makes, 2,648 B under the limit
        assert geo["smem_bytes"] == 229800
        assert geo["window_buffers"] == 2


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("features", [64, 128, 256, 384])
def test_conv_plan_fits_every_fusion_width(features, batch):
    """The 3x3 conv at each registry width F = C on fusion_0's and
    fusion_1's maps, and head_conv1's F -> F / 2 on 296 x 528: the grid
    within CUDA's limits, one block's shared memory within the card's."""
    for h, w, f_out in ((2 * PH, 2 * PW, features),
                        (4 * PH, 4 * PW, features),
                        (8 * PH, 8 * PW, features // 2)):
        geo = conv_stripe.kernel_geometry(batch, h, w, features, f_out)
        gx, gy, gz = geo["grid"]
        assert gz == batch * -(-f_out // conv_stripe.BLOCK_F) < 65536
        assert gy < 65536 and gx * conv_stripe.TILE_W >= w
        assert geo["smem_bytes"] <= conv_stripe.MAX_SMEM_BYTES
        assert geo["chunks"] == -(-features // conv_stripe.CHUNK_C)


def _dense_shapes(vit) -> dict:
    d = vit.hidden_size
    mlp = int(d * vit.mlp_ratio)
    if vit.use_swiglu:
        sw = (int(mlp * 2 / 3) + 7) // 8 * 8
        ffn = {"w12": (d, 2 * sw), "w3": (sw, d)}
    else:
        ffn = {"fc1": (d, mlp), "fc2": (mlp, d)}
    return {"qkv": (d, 3 * d), "proj": (d, d), **ffn}


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("version,encoder", REGISTRY)
def test_int8_plan_fits_every_dense_role(version, encoder, batch):
    """The int8 product at every (M, K, N) of a block's four dense roles
    (qkv, proj and fc1 / fc2 or w12 / w3), M the step's tokens: the
    kernel's shape rules, 32-bit tile counts and offsets."""
    vit = _vit(version, encoder)
    m = batch * TOKENS
    for role, (k, n) in _dense_shapes(vit).items():
        assert k % 16 == 0 and n % 8 == 0, role
        geo = quant_fused.kernel_geometry(m, k, n, SMS)
        assert geo["smem_bytes"] <= quant_fused.MAX_SMEM_BYTES
        assert geo["tiles"] == -(-m // 128) * -(-n // 256)
        assert geo["grid"] == min(geo["tiles"], SMS)
        assert m * k < 2 ** 31 and m * n < 2 ** 31, role
    if encoder == "vitg":
        assert _dense_shapes(vit)["w12"] == (1536, 8192)
        assert _dense_shapes(vit)["w3"] == (4096, 1536)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("version,encoder", REGISTRY)
def test_attention_plan_fits_every_head_count(version, encoder, batch):
    """The attention kernel at each preset's head count (64 each) on the
    2443-token sequence: one block a (query tile, head, frame)."""
    vit = _vit(version, encoder)
    assert vit.hidden_size // vit.num_heads == 64 and vit.num_heads % 2 == 0
    geo = attention.kernel_geometry(batch, vit.num_heads, TOKENS, TOKENS)
    assert geo["grid"] == (-(-TOKENS // attention.BLOCK_Q), vit.num_heads,
                           batch)
    assert geo["grid"][2] < 65536 and geo["smem_bytes"] <= 232448
