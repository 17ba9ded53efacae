"""The port's int8 policies against ``txr``'s: ``txr_torch.ops.quant`` /
``quant_fused`` against ``txr.ops.quant`` / ``quant_pallas`` (the Pallas
kernel in interpret mode), and a narrow Depth Anything model under each
policy with one weight set in both packages.

The port runs on the CPU here, so ``int8_linear`` takes its plain version;
the CUDA kernel is held against that plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from txr.models.depth_anything import DepthAnythingFlax
from txr.models.dpt import DPTConfig as TxrDPTConfig
from txr.models.vit import ViTConfig as TxrViTConfig
from txr.ops import quant as jq
from txr.ops import quant_pallas as jqp

from txr_torch.models.convert import from_txr_params
from txr_torch.models.depth_anything import DepthAnything, build_model
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import Mlp, SwiGLU, ViTConfig, _dense
from txr_torch.ops import quant as pq
from txr_torch.ops import quant_fused as pqf

torch.set_num_threads(1)

# f32 on both sides, identical integer sums; the rescale multiplies in
# another association on neither side, so what is left is the last bit of
# the scales' divisions and of the final product.
TOL = dict(rtol=2e-5, atol=2e-5)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


class TestQuantOps:
    @pytest.mark.parametrize("shape", [(64, 32), (96, 130), (7, 5)])
    def test_quantize_weight_matches_txr(self, shape):
        """W_q bit-equal; scales rtol 1e-6 (one f32 division)."""
        w = _rand(shape, 1)
        w[:, 0] = 0.0                       # an all-zero column: scale 1e-12
        wq_j, s_j = jq.quantize_weight(jnp.asarray(w))
        wq_p, s_p = pq.quantize_weight(torch.from_numpy(w))
        assert wq_p.dtype == torch.int8 and s_p.dtype == torch.float32
        np.testing.assert_array_equal(wq_p.numpy(), np.asarray(wq_j))
        np.testing.assert_allclose(s_p.numpy(), np.asarray(s_j), rtol=1e-6)
        assert s_p[0].item() == pytest.approx(1e-12, rel=1e-6)

    def test_quantize_weight_of_a_linear_weight_view(self):
        """The transposed view of an (out, in) weight quantises to the same
        values as the (K, N) array it stands for."""
        w = _rand((40, 24), 2)              # (K, N)
        lin = torch.from_numpy(np.ascontiguousarray(w.T))   # (N, K)
        wq_a, s_a = pq.quantize_weight(torch.from_numpy(w))
        wq_b, s_b = pq.quantize_weight(lin.t())
        assert torch.equal(wq_a, wq_b) and torch.equal(s_a, s_b)

    @pytest.mark.parametrize("m,k,n", [(128, 96, 80), (300, 96, 130),
                                       (5, 4096, 24)])
    def test_int8_matmul_matches_txr(self, m, k, n):
        """K = 4096 pushes the integer sums past 2^24: the plain product
        must still be exact."""
        x = _rand((m, k), 3)
        x[1] = 0.0                          # an all-zero row
        if k == 4096:
            x[2] = 3.0                      # every x_q = 127: sums of 6e7
        w = _rand((k, n), 4)
        if k == 4096:
            w[:, 3] = 1.0
        wq_j, s_j = jq.quantize_weight(jnp.asarray(w))
        want = np.asarray(jq.int8_matmul(jnp.asarray(x), wq_j, s_j,
                                         out_dtype=jnp.float32))
        wq_p, s_p = pq.quantize_weight(torch.from_numpy(w))
        got = pq.int8_matmul(torch.from_numpy(x), wq_p, s_p,
                             out_dtype=torch.float32)
        assert got.shape == (m, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert not got[1].any()

    def test_int_product_is_exact_beyond_float32(self):
        xq = torch.full((3, 4096), 127, dtype=torch.int8)
        wq = torch.full((4096, 2), 127, dtype=torch.int8)
        wq[-1, 1] = 126                     # 66,064,383: odd, above 2^24
        got = pq.int_product(xq, wq)
        exact = np.array([127 * 127 * 4096, 127 * 127 * 4096 - 127],
                         dtype=np.int64)
        np.testing.assert_array_equal(
            got.numpy(), np.broadcast_to(exact.astype(np.float32), (3, 2)))

    def test_leading_dims_and_out_dtype(self):
        x = torch.from_numpy(_rand((2, 3, 16), 5)).to(torch.bfloat16)
        wq, sw = pq.quantize_weight(torch.from_numpy(_rand((16, 8), 6)))
        y = pq.int8_matmul(x, wq, sw)
        assert y.shape == (2, 3, 8) and y.dtype == torch.bfloat16


class TestInt8LinearFused:
    @pytest.mark.parametrize("bias", [True, False])
    @pytest.mark.parametrize("m,k,n", [(300, 96, 130), (37, 64, 24)])
    def test_matches_txr_kernel_interpreted(self, m, k, n, bias):
        """Ragged M and N against the Pallas kernel in interpret mode."""
        x = _rand((m, k), 7)
        x[0] = 0.0
        x[5, 3] = 40.0                      # one large entry sets that row's scale
        w = _rand((k, n), 8)
        b = _rand((n,), 9) if bias else None
        want = np.asarray(jqp.int8_linear(
            jnp.asarray(x), jnp.asarray(w),
            None if b is None else jnp.asarray(b), block_m=128, block_n=128))
        tb = None if b is None else torch.from_numpy(b)
        got = pqf.int8_linear(torch.from_numpy(x), torch.from_numpy(w), tb)
        assert got.shape == (m, n) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        ref = pqf.int8_linear_reference(torch.from_numpy(x),
                                        torch.from_numpy(w), tb)
        assert torch.equal(got, ref)        # the CPU dispatch IS the plain version
        if bias:
            np.testing.assert_array_equal(got[0].numpy(), b)

    def test_wide_k_is_exact(self):
        """K = 4096 with saturated rows against txr's kernel."""
        x = np.full((4, 4096), 2.0, np.float32)
        x[1] *= -1.0
        w = np.full((4096, 8), 0.5, np.float32)
        w[:, 1] = _rand((4096,), 10)
        want = np.asarray(jqp.int8_linear(jnp.asarray(x), jnp.asarray(w),
                                          block_m=128, block_n=128))
        got = pqf.int8_linear(torch.from_numpy(x), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(got[0, 0].item(), 4096.0, rtol=1e-6)

    def test_bf16_activations_round_once(self):
        x = torch.from_numpy(_rand((9, 32), 11)).to(torch.bfloat16)
        w = torch.from_numpy(_rand((32, 16), 12))
        b = torch.from_numpy(_rand((16,), 13))
        y = pqf.int8_linear(x, w, b)
        assert y.dtype == torch.bfloat16
        exact = pqf.int8_linear(x.float(), w, b)
        assert torch.equal(y, exact.to(torch.bfloat16))

    def test_bad_shapes_raise(self):
        with pytest.raises(ValueError):
            pqf.int8_linear(torch.zeros(3, 5), torch.zeros(4, 2))


class TestModules:
    @pytest.mark.parametrize("cls", [pq.Int8Linear, pqf.Int8LinearFused])
    def test_state_dict_is_nn_linears(self, cls):
        ref = torch.nn.Linear(12, 7)
        mod = cls(12, 7)
        assert set(mod.state_dict()) == set(ref.state_dict()) == {"weight",
                                                                  "bias"}
        assert mod.weight.shape == (7, 12)
        mod.load_state_dict(ref.state_dict())
        assert cls(12, 7, bias=False).bias is None

    @pytest.mark.parametrize("cls,jcls", [
        (pq.Int8Linear, jq.Int8Dense),
        (pqf.Int8LinearFused, jq.Int8DensePallas)])
    def test_forward_matches_txr_module(self, cls, jcls):
        x = _rand((2, 11, 24), 14)
        kernel, bias = _rand((24, 40), 15, 0.3), _rand((40,), 16, 0.3)
        want = np.asarray(jcls(40).apply(
            {"params": {"kernel": jnp.asarray(kernel),
                        "bias": jnp.asarray(bias)}}, jnp.asarray(x)))
        mod = cls(24, 40)
        mod.load_state_dict({"weight": torch.from_numpy(kernel.T.copy()),
                             "bias": torch.from_numpy(bias)})
        with torch.no_grad():
            got = mod(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    @pytest.mark.parametrize("cls", [pq.Int8Linear, pqf.Int8LinearFused])
    def test_quantised_weight_follows_the_parameter(self, cls):
        """load_state_dict, an in-place update and .to(dtype) must each
        reach the next forward."""
        mod = cls(16, 8)
        x = torch.from_numpy(_rand((5, 16), 17))
        with torch.no_grad():
            y0 = mod(x)
            assert torch.equal(mod(x), y0)          # reused, same answer
            new = {"weight": torch.from_numpy(_rand((8, 16), 18)),
                   "bias": torch.from_numpy(_rand((8,), 19))}
            mod.load_state_dict(new)
            y1 = mod(x)
            fresh = cls(16, 8)
            fresh.load_state_dict(new)
            assert torch.equal(y1, fresh(x)) and not torch.equal(y1, y0)
            mod.weight.mul_(2.0)
            y2 = mod(x)
            fresh.weight.copy_(mod.weight)
            assert torch.equal(y2, fresh(x)) and not torch.equal(y2, y1)
            mod.to(torch.bfloat16)
            y3 = mod(x.to(torch.bfloat16))
            again = cls(16, 8).to(torch.bfloat16)
            again.load_state_dict(mod.state_dict())
            assert y3.dtype == torch.bfloat16
            assert torch.equal(y3, again(x.to(torch.bfloat16)))

    def test_policy_table_is_txrs(self):
        import txr.models.vit as jvit

        names = {jq.Int8Dense: pq.Int8Linear,
                 jq.Int8DensePallas: pqf.Int8LinearFused}
        for quant in ("none", "int8", "int8p", "int8mix"):
            for role in ("", "fc1", "fc2"):
                want = names.get(jvit._dense(quant, role), torch.nn.Linear)
                assert _dense(quant, role) is want, (quant, role)
        mlp = Mlp(8, 16, 8, quant="int8mix")
        assert type(mlp.fc1) is pq.Int8Linear
        assert type(mlp.fc2) is pqf.Int8LinearFused
        sw = SwiGLU(8, 16, 8, quant="int8mix")
        assert type(sw.w12) is pq.Int8Linear
        assert type(sw.w3) is pqf.Int8LinearFused

    def test_unknown_policy_raises(self):
        with pytest.raises(ValueError, match="quant"):
            _dense("int4")
        with pytest.raises(ValueError, match="quant"):
            build_model("v2", "vits", quant="fp8", device="cpu")


# ------------------------------------------------------------- whole model

def _pair(quant: str, swiglu: bool, seed: int = 0):
    """A narrow Depth Anything in both packages under ``quant`` with one
    perturbed random weight set."""
    kw = dict(hidden_size=64, num_layers=3, num_heads=2, pos_embed_size=4,
              out_layers=(0, 1, 2, 2), use_swiglu=swiglu, quant=quant)
    jvit = TxrViTConfig(use_flash=True, **kw)
    jdpt = TxrDPTConfig(features=16, out_channels=(8, 12, 16, 16),
                        head_hidden=8, fused_head=True)
    fm = DepthAnythingFlax(vit=jvit, dpt=jdpt)
    x = _rand((2, 56, 70, 3), seed + 1)
    params = fm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed + 2)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    params["head"]["head_conv3"]["bias"] = \
        params["head"]["head_conv3"]["bias"] + 1.0
    pm = DepthAnything(ViTConfig(**kw),
                       DPTConfig(features=16, out_channels=(8, 12, 16, 16),
                                 head_hidden=8)).eval()
    pm.load_state_dict(from_txr_params(params))
    return fm, jax.tree_util.tree_map(jnp.asarray, params), pm, x


@pytest.mark.parametrize("quant,swiglu", [
    ("int8", False), ("int8p", False), ("int8mix", False),
    ("int8mix", True)])
def test_model_under_policy_matches_txr(quant, swiglu):
    """Same weights, same policy, f32. The two sides agree on every
    quantised integer except where a value sits on a rounding tie within
    float error, so: max difference <= 2 % and median <= 0.1 % of the
    depth's span."""
    fm, params, pm, x = _pair(quant, swiglu)
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    span = float(want.max() - want.min())
    assert span > 1e-3 and np.isfinite(got).all()
    rel = np.abs(got - want) / span
    assert np.median(rel) <= 1e-3, np.median(rel)
    assert rel.max() <= 2e-2, rel.max()


def test_policy_changes_the_answer_but_not_by_much():
    """int8p against the unquantised model on the same weights: it must
    differ (the policy is really on) and stay within txr's own bound of a
    few percent of the span."""
    _, _, pq_model, x = _pair("int8p", False)
    _, _, pf_model, _ = _pair("none", False)
    with torch.no_grad():
        dq = pq_model(torch.from_numpy(x)).numpy()
        df = pf_model(torch.from_numpy(x)).numpy()
    span = float(df.max() - df.min())
    rel = np.abs(dq - df) / span
    assert rel.max() > 0 and np.median(rel) < 0.02 and rel.max() < 0.15


# ------------------------------------------------- the kernel's host side

def _widths():
    from txr_torch.models.depth_anything import MODEL_CONFIGS
    from txr_torch.models.vit import VIT_PRESETS

    return sorted({VIT_PRESETS[c["encoder"]].hidden_size
                   for entries in MODEL_CONFIGS.values()
                   for c in entries.values()})


class TestKernelGeometry:
    """``quant_fused.kernel_geometry``: the product kernel's persistent
    grid, tiles and shared memory, as pure arithmetic."""

    @pytest.mark.parametrize("m,k,n,sms", [
        (300, 96, 136, 132), (1, 16, 8, 132), (129, 1024, 1024, 132),
        (2443, 1024, 3072, 7), (19544, 4096, 1024, 132), (513, 64, 520, 1)])
    def test_tiles_cover_the_output_exactly_once(self, m, k, n, sms):
        geo = pqf.kernel_geometry(m, k, n, sms)
        assert 1 <= geo["grid"] <= sms
        assert geo["tiles"] == geo["m_tiles"] * geo["n_tiles"]
        assert geo["waves"] * geo["grid"] >= geo["tiles"]
        assert geo["k_slices"] * pqf.STAGE_K >= k > (geo["k_slices"] - 1
                                                     ) * pqf.STAGE_K
        seen = np.zeros((m, n), np.int32)
        walked = 0
        for block in range(geo["grid"]):        # the kernel's own walk
            for i in range(block, geo["tiles"], geo["grid"]):
                r0, c0 = pqf.tile_origin(i, geo["n_tiles"])
                assert r0 < m and c0 < n
                seen[r0:r0 + pqf.TILE_M, c0:c0 + pqf.TILE_N] += 1
                walked += 1
        assert walked == geo["tiles"] and (seen == 1).all()

    @pytest.mark.parametrize("hidden", _widths())
    def test_shared_memory_fits_every_model_width(self, hidden):
        for k, n in ((hidden, 3 * hidden), (hidden, hidden),
                     (hidden, 4 * hidden), (4 * hidden, hidden)):
            geo = pqf.kernel_geometry(8 * 2443, k, n, 132)
            assert geo["smem_bytes"] <= pqf.MAX_SMEM_BYTES == 232448
            assert geo["stage_bytes"] % 1024 == 0   # swizzled tiles stay aligned
            assert geo["x_box"] == (128, 128) and geo["w_box"] == (128, 256)
            assert geo["grid"] == 132

    def test_launch_limits_raise(self):
        with pytest.raises(ValueError, match="positive"):
            pqf.kernel_geometry(0, 16, 8, 132)
        with pytest.raises(ValueError, match="positive"):
            pqf.kernel_geometry(16, 16, 8, 0)
        with pytest.raises(ValueError, match="32 bits"):
            pqf.kernel_geometry(2 ** 31, 16, 2 ** 20, 132)

    def test_what_the_kernel_refuses_raises_by_name(self):
        """The checks in front of the launch need no card."""
        wq = torch.zeros((8, 32), dtype=torch.int8)
        vec = torch.zeros((8,))
        with pytest.raises(TypeError, match="bfloat16"):
            pqf._launch(torch.zeros((4, 32)), wq, vec, vec)
        with pytest.raises(ValueError, match="multiple of 16"):
            pqf._launch(torch.zeros((4, 24), dtype=torch.bfloat16),
                        torch.zeros((8, 24), dtype=torch.int8), vec, vec)
        with pytest.raises(ValueError, match="multiple of 8"):
            pqf._launch(torch.zeros((4, 32), dtype=torch.bfloat16),
                        torch.zeros((12, 32), dtype=torch.int8),
                        torch.zeros((12,)), torch.zeros((12,)))
