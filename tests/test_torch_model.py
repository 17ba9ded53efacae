"""Parity of the port's Depth Anything model with ``txr`` and with the
installed ``transformers`` implementation, on the CPU at a narrow size.

One strongly randomized parameter set (a HF-layout state dict with O(1)
output variance) is fed to all three: to ``transformers`` natively, to
``txr`` through ``convert_state_dict``, and to the port through
``convert_state_dict`` -> ``from_txr_params``. The ``txr`` side runs with
``use_flash=True`` and ``fused_head=True`` so its Pallas kernels execute in
interpret mode; the port runs with ``device="cpu"``, so with the plain
versions of its kernels.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from txr.core.intrinsics import CameraIntrinsics as TxrIntrinsics
from txr.models.convert import convert_state_dict
from txr.models.depth_anything import DepthAnythingFlax
from txr.models.depth_anything import DepthAnythingModel as TxrModel
from txr.models.dpt import DPTConfig as TxrDPTConfig
from txr.models.dpt import DPTHead as TxrDPTHead
from txr.models.vit import ViTConfig as TxrViTConfig
from txr.models.vit import ViTEncoder as TxrViTEncoder

from txr_torch.core.intrinsics import CameraIntrinsics
from txr_torch.models.convert import from_txr_params
from txr_torch.models.depth_anything import (
    MODEL_CONFIGS, DepthAnything, DepthAnythingModel, build_model,
    hf_model_name)
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import VIT_PRESETS, ViTConfig

torch.set_num_threads(1)

HIDDEN, LAYERS, HEADS, IMG = 32, 4, 2, 56
OUT_IDX = (1, 2, 3, 4)
NECK, FUSION, HEAD_HIDDEN = (8, 12, 16, 16), 16, 8
# f32 on both sides; the sums run in another order in the two frameworks
# (and through the interpreted kernels on the txr side), nothing else.
TOL = dict(rtol=1e-4, atol=1e-4)


def make_triple(metric: bool, seed: int = 0):
    """(transformers model, txr module, txr params, port model) sharing one
    strongly randomized weight set."""
    from transformers import (DepthAnythingConfig,
                              DepthAnythingForDepthEstimation)
    from transformers.models.dinov2 import Dinov2Config

    bc = Dinov2Config(
        hidden_size=HIDDEN, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, patch_size=14, image_size=IMG,
        layerscale_value=1.0, out_indices=list(OUT_IDX),
        apply_layernorm=True, reshape_hidden_states=False)
    cfg = DepthAnythingConfig(
        backbone_config=bc, reassemble_hidden_size=HIDDEN,
        neck_hidden_sizes=list(NECK), fusion_hidden_size=FUSION,
        head_hidden_size=HEAD_HIDDEN, patch_size=14,
        depth_estimation_type="metric" if metric else "relative",
        max_depth=5.0 if metric else 1)
    torch.manual_seed(seed)
    tm = DepthAnythingForDepthEstimation(cfg).eval()
    # Randomize far beyond the init so outputs have O(1) variance: a weak
    # perturbation can hide a transposed-conv kernel flip under the
    # tolerance. The numbers come from numpy, not from torch's generator.
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(torch.from_numpy(
                (rng.standard_normal(tuple(p.shape)) * 0.1
                 ).astype(np.float32)))
        # Keep the relative head's final ReLU from saturating to zeros.
        tm.head.conv3.bias.add_(1.0)

    out_layers = tuple(i - 1 for i in OUT_IDX)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = convert_state_dict(sd, num_layers=LAYERS)

    jvit = TxrViTConfig(hidden_size=HIDDEN, num_layers=LAYERS,
                        num_heads=HEADS, patch_size=14,
                        pos_embed_size=IMG // 14, out_layers=out_layers,
                        use_flash=True)
    jdpt = TxrDPTConfig(features=FUSION, out_channels=NECK,
                        head_hidden=HEAD_HIDDEN, metric=metric,
                        max_depth=5.0, fused_head=True)
    fm = DepthAnythingFlax(vit=jvit, dpt=jdpt)

    pvit = ViTConfig(hidden_size=HIDDEN, num_layers=LAYERS, num_heads=HEADS,
                     patch_size=14, pos_embed_size=IMG // 14,
                     out_layers=out_layers)
    pdpt = DPTConfig(features=FUSION, out_channels=NECK,
                     head_hidden=HEAD_HIDDEN, metric=metric, max_depth=5.0)
    pm = DepthAnything(pvit, pdpt).eval()
    missing = pm.load_state_dict(from_txr_params(params), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    return tm, fm, jax.tree_util.tree_map(jnp.asarray, params), pm


@pytest.fixture(scope="module", params=[False, True], ids=["relative",
                                                           "metric"])
def triple(request):
    return make_triple(request.param)


def _pixels(shape=(2, 70, 84, 3), seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


class TestModelParity:
    def test_vit_hidden_states_match_txr(self, triple):
        _, fm, params, pm = triple
        x = _pixels()
        want = TxrViTEncoder(fm.vit).apply({"params": params["encoder"]},
                                           jnp.asarray(x))
        with torch.no_grad():
            got = pm.encoder(torch.from_numpy(x))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)

    def test_dpt_head_matches_txr(self, triple):
        _, fm, params, pm = triple
        rng = np.random.default_rng(2)
        ph, pw = 5, 6
        hs = [rng.standard_normal((2, 1 + ph * pw, HIDDEN)).astype(
            np.float32) for _ in range(4)]
        want = TxrDPTHead(fm.dpt).apply(
            {"params": params["head"]}, [jnp.asarray(h) for h in hs], ph, pw)
        with torch.no_grad():
            got = pm.head([torch.from_numpy(h) for h in hs], ph, pw)
        assert got.shape == (2, ph * 14, pw * 14)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    def test_full_forward_matches_txr(self, triple):
        _, fm, params, pm = triple
        x = _pixels()
        want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
        with torch.no_grad():
            got = pm(torch.from_numpy(x)).numpy()
        assert got.shape == want.shape == (2, 70, 84)
        assert np.isfinite(got).all() and got.std() > 1e-3
        np.testing.assert_allclose(got, want, **TOL)

    def test_full_forward_matches_transformers(self, triple):
        """Pins the un-flip of the transposed-conv kernels: transformers
        uses torch's own ConvTranspose2d on the original weights."""
        tm, _, _, pm = triple
        x = _pixels((1, 56, 70, 3), seed=3)
        with torch.no_grad():
            want = tm(pixel_values=torch.from_numpy(x).permute(0, 3, 1, 2)
                      ).predicted_depth.numpy()
            got = pm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)

    def test_unfused_head_equals_fused_head(self, triple):
        _, _, _, pm = triple
        from dataclasses import replace
        x = torch.from_numpy(_pixels((1, 56, 56, 3), seed=4))
        with torch.no_grad():
            fused = pm(x)
            pm.head.cfg = replace(pm.head.cfg, fused_head=False)
            try:
                plain = pm(x)
            finally:
                pm.head.cfg = replace(pm.head.cfg, fused_head=None)
        np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=1e-5,
                                   atol=1e-5)


class TestInferApi:
    @pytest.mark.parametrize("version,encoder", [("v2", "vits"),
                                                 ("v3", "vitl")])
    def test_infer_matches_txr(self, version, encoder, monkeypatch):
        """infer / infer_batch on a 60x80 BGR image with one weight set in
        both packages; v3 adds the focal scaling. f32 parameters on both
        sides; 2e-4 because the 1/255, resize and normalization steps add
        their own reordering on top of the model's."""
        import txr.models.depth_anything as jda
        import txr_torch.models.depth_anything as pda

        small = TxrViTConfig(hidden_size=32, num_layers=2, num_heads=2,
                             out_layers=(0, 0, 1, 1), use_flash=True)
        psmall = ViTConfig(hidden_size=32, num_layers=2, num_heads=2,
                           out_layers=(0, 0, 1, 1))
        key = "vits" if encoder == "vits" else "vitl"
        monkeypatch.setitem(jda.VIT_PRESETS, key, small)
        monkeypatch.setitem(pda.VIT_PRESETS, key, psmall)
        entry = {"encoder": key, "features": 16,
                 "out_channels": [8, 12, 16, 16]}
        reg = "large" if version == "v3" else encoder
        monkeypatch.setitem(jda.MODEL_CONFIGS[version], reg, entry)
        monkeypatch.setitem(pda.MODEL_CONFIGS[version], reg, entry)
        monkeypatch.setenv("TXR_FUSED_HEAD", "1")   # txr: run its tail kernel

        jm = TxrModel(version=version, encoder=encoder,
                      param_dtype=jnp.float32, input_size=56, seed=0)
        # txr's random init leaves every bias at zero; perturb all leaves so
        # no term of the forward is switched off
        rng = np.random.default_rng(5)
        jm.params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.standard_normal(
                a.shape).astype(np.float32)), jm.params)
        pm = DepthAnythingModel(version=version, encoder=encoder,
                                param_dtype=torch.float32, input_size=56,
                                device="cpu")
        pm.model.load_state_dict(from_txr_params(
            jax.tree_util.tree_map(np.asarray, jm.params)))

        img = np.random.default_rng(6).integers(0, 256, (2, 60, 80, 3),
                                                dtype=np.uint8)
        k = TxrIntrinsics(fx=450.0, fy=470.0, cx=40.0, cy=30.0, width=80,
                          height=60)
        pk = CameraIntrinsics(fx=450.0, fy=470.0, cx=40.0, cy=30.0, width=80,
                              height=60)
        want1 = jm.infer(img[0], k)
        got1 = pm.infer(img[0], pk)
        assert got1.shape == (60, 80) and got1.dtype == np.float32
        np.testing.assert_allclose(got1, want1, rtol=2e-4, atol=2e-4)
        wantb = jm.infer_batch(img, k)
        gotb = pm.infer_batch(img, pk)
        assert gotb.shape == (2, 60, 80)
        np.testing.assert_allclose(gotb, wantb, rtol=2e-4, atol=2e-4)
        if version == "v3":
            unscaled = pm.infer(img[0])
            np.testing.assert_allclose(got1, unscaled * (460.0 / 300.0),
                                       rtol=1e-6)


class TestRegistry:
    def test_registry_equals_txr(self):
        import txr.models.depth_anything as jda
        import txr.models.vit as jvit

        assert MODEL_CONFIGS == jda.MODEL_CONFIGS
        for name, want in jvit.VIT_PRESETS.items():
            got = VIT_PRESETS[name]
            for f in ("hidden_size", "num_layers", "num_heads", "patch_size",
                      "mlp_ratio", "pos_embed_size", "use_swiglu",
                      "out_layers"):
                assert getattr(got, f) == getattr(want, f), (name, f)
        for args in [("v2", "vitl"), ("v1", "vits"), ("v2", "vitg"),
                     ("v3", "large")]:
            assert hf_model_name(*args) == jda.hf_model_name(*args)
        assert hf_model_name("v2", "vitb", True, "vkitti") == \
            jda.hf_model_name("v2", "vitb", True, "vkitti")

    def test_build_model_rejects_unknown_and_unported(self):
        """Every configuration txr's models have is ported, so nothing
        raises NotImplementedError any more: an unknown registry entry or
        quant policy is a ValueError, a missing checkpoint file an OSError,
        and the quant policies and fused_convs build."""
        with pytest.raises(ValueError):
            build_model("v9", "vitl", device="cpu")
        with pytest.raises(ValueError):
            build_model("v2", "vits", quant="int4", device="cpu")
        with pytest.raises(OSError):
            DepthAnythingModel("v2", "vits", checkpoint_path="x.pth",
                               device="cpu")
        for quant in ("int8", "int8p", "int8mix"):
            _, vit, _ = build_model("v2", "vits", quant=quant, device="cpu")
            assert vit.quant == quant
        from txr_torch.models.dpt import DPTHead
        DPTHead(DPTConfig(fused_convs=True), 384)

    @pytest.mark.parametrize("head", ["1", "0", None])
    @pytest.mark.parametrize("convs", ["1", "0", None])
    def test_fused_env_knobs_equal_txr(self, head, convs, monkeypatch):
        """TXR_FUSED_HEAD / TXR_FUSED_CONVS: "1" / "0" force, unset leaves
        the config default, exactly as txr's build_model reads them."""
        import txr.models.depth_anything as jda

        for name, val in (("TXR_FUSED_HEAD", head),
                          ("TXR_FUSED_CONVS", convs)):
            if val is None:
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, val)
        _, _, want = jda.build_model("v2", "vits")
        model, _, got = build_model("v2", "vits", device="cpu")
        assert (got.fused_head, got.fused_convs) == \
            (want.fused_head, want.fused_convs)
        knob = {"1": True, "0": False, None: None}
        assert got.fused_head is knob[head]
        assert got.fused_convs is knob[convs]
        assert model.head.fusion_0.fused is bool(knob[convs])

    def test_fused_env_knobs_ignore_other_values(self, monkeypatch):
        monkeypatch.setenv("TXR_FUSED_CONVS", "yes")
        _, _, dpt = build_model("v2", "vits", device="cpu")
        assert dpt.fused_convs is None

    def test_swiglu_block_matches_txr(self):
        """The vitg feed-forward (w12 / w3) through both packages."""
        from txr.models.vit import Block as TxrBlock
        from txr_torch.models.vit import Block

        jcfg = TxrViTConfig(hidden_size=48, num_layers=1, num_heads=2,
                            use_swiglu=True, use_flash=True)
        pcfg = ViTConfig(hidden_size=48, num_layers=1, num_heads=2,
                         use_swiglu=True)
        rng = np.random.default_rng(7)
        x = rng.standard_normal((2, 9, 48)).astype(np.float32)
        jb = TxrBlock(jcfg)
        params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a) + 0.1 * rng.standard_normal(
                a.shape).astype(np.float32), params)
        want = np.asarray(jb.apply({"params": params}, jnp.asarray(x)))
        pb = Block(pcfg).eval()
        pb.load_state_dict(from_txr_params(params))
        with torch.no_grad():
            got = pb(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, **TOL)
