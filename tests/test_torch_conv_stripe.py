"""``txr_torch.ops.conv_stripe`` against ``txr.ops.conv_stripe`` (the Pallas
kernel in interpret mode and its XLA oracle), and the DPT head with
``fused_convs`` on in both packages.

The port runs on the CPU here, so ``conv3x3_stripe`` takes its plain
version; the CUDA kernel is held against that plain version on the card by
``chip_smoke.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from txr.models.dpt import DPTConfig as TxrDPTConfig
from txr.models.dpt import DPTHead as TxrDPTHead
from txr.models.dpt import FeatureFusionBlock as TxrFusionBlock
from txr.ops import conv_stripe as jc

from txr_torch.models.convert import from_txr_params
from txr_torch.models.dpt import (Conv3x3, DPTConfig, DPTHead,
                                  FeatureFusionBlock)
from txr_torch.ops import conv_stripe as pc

torch.set_num_threads(1)

# f32 on both sides: 9*C products per output summed in another order
TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


class TestConvParity:
    @pytest.mark.parametrize("relu_in", [False, True])
    @pytest.mark.parametrize("shape,feat", [((2, 13, 21, 16), 24),
                                            ((1, 37, 19, 8), 8),
                                            ((1, 5, 3, 24), 16)])
    def test_matches_txr_kernel_and_oracle(self, shape, feat, relu_in):
        """H and W are multiples of nothing (the kernel's row block is 16,
        its stripe 8)."""
        x = _rand(shape, 1)
        w = _rand((3, 3, shape[3], feat), 2, 0.2)
        b = _rand((feat,), 3)
        kern = np.asarray(jc.conv3x3_stripe(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu_in=relu_in,
            interpret=True))
        oracle = np.asarray(jc.conv3x3_reference(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), relu_in))
        tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
        got = pc.conv3x3_stripe(tx, tw, tb, relu_in)
        ref = pc.conv3x3_reference(tx, tw, tb, relu_in)
        assert got.shape == shape[:3] + (feat,) and got.dtype == torch.float32
        assert torch.equal(got, ref)        # the CPU dispatch IS the plain version
        np.testing.assert_allclose(got.numpy(), kern, **TOL)
        np.testing.assert_allclose(got.numpy(), oracle, **TOL)

    def test_border_is_zero_padding_and_relu_comes_first(self):
        """A negative constant image: with relu_in the conv sees zeros and
        returns the bias; without it the border outputs see fewer taps."""
        x = torch.full((1, 4, 5, 8), -1.0)
        w = torch.ones((3, 3, 8, 8))
        b = torch.full((8,), 0.5)
        assert torch.equal(pc.conv3x3_stripe(x, w, b, True),
                           torch.full((1, 4, 5, 8), 0.5))
        y = pc.conv3x3_stripe(x, w, b, False)
        assert y[0, 0, 0, 0].item() == 0.5 - 4 * 8
        assert y[0, 1, 1, 0].item() == 0.5 - 9 * 8
        assert y[0, 0, 2, 0].item() == 0.5 - 6 * 8

    def test_bf16_keeps_dtype(self):
        x = torch.from_numpy(_rand((1, 6, 7, 8), 4)).to(torch.bfloat16)
        w = torch.from_numpy(_rand((3, 3, 8, 8), 5, 0.2))
        b = torch.from_numpy(_rand((8,), 6))
        y = pc.conv3x3_stripe(x, w, b, True)
        assert y.dtype == torch.bfloat16
        want = np.asarray(jc.conv3x3_reference(
            jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
            jnp.asarray(w.numpy()), jnp.asarray(b.numpy()), True
        ).astype(jnp.float32))
        # bf16 3e-2: the port's plain version rounds weights and bias to
        # bf16 as well, txr's oracle only the activations
        np.testing.assert_allclose(y.float().numpy(), want, rtol=3e-2,
                                   atol=3e-2)

    def test_pack_weight_layout(self):
        w = torch.from_numpy(_rand((3, 3, 16, 8), 7))
        wp = pc.pack_weight(w)
        assert wp.shape == (9, 8, 16) and wp.dtype == torch.bfloat16
        assert wp.is_contiguous()
        for di, dj, c, f in [(0, 0, 0, 0), (1, 2, 5, 7), (2, 1, 15, 3)]:
            assert wp[3 * di + dj, f, c] == w[di, dj, c, f].to(torch.bfloat16)

    @pytest.mark.parametrize("relu_in", [False, True])
    def test_backward_matches_txr_vjp(self, relu_in):
        """The autograd.Function's backward against jax.vjp of txr's
        oracle; f32 1e-4 on gradients of order 1 to 10."""
        x, w, b = _rand((1, 6, 7, 8), 8), _rand((3, 3, 8, 4), 9, 0.3), \
            _rand((4,), 10)
        g = _rand((1, 6, 7, 4), 11)
        _, vjp = jax.vjp(lambda a, k, bb: jc.conv3x3_reference(a, k, bb,
                                                               relu_in),
                         jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
        want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, w, b)]
        pc.conv3x3_stripe(*leaves, relu_in).backward(torch.from_numpy(g))
        for leaf, wnt in zip(leaves, want):
            np.testing.assert_allclose(leaf.grad.numpy(), wnt, rtol=1e-4,
                                       atol=1e-4)

    def test_bad_arguments_raise(self):
        x = torch.zeros((1, 4, 4, 8))
        with pytest.raises(ValueError):
            pc.conv3x3_stripe(x, torch.zeros((3, 3, 4, 8)), torch.zeros(8))
        with pytest.raises(ValueError):
            pc.conv3x3_stripe(x, torch.zeros((3, 3, 8, 8)), torch.zeros(4))
        with pytest.raises(ValueError):
            pc.conv3x3_stripe(x[0], torch.zeros((3, 3, 8, 8)), torch.zeros(8))


# ----------------------------------------------------------------- the head

FEAT = 16
NECK = (8, 8, 16, 16)


def _head_pair(fused_head, fused_convs, ph, pw, seed=0):
    jcfg = TxrDPTConfig(features=FEAT, out_channels=NECK, head_hidden=8,
                        fused_head=fused_head, fused_convs=fused_convs)
    jh = TxrDPTHead(jcfg)
    hs = [_rand((1, 1 + ph * pw, 24), seed + i) for i in range(4)]
    params = jh.init(jax.random.PRNGKey(seed), [jnp.asarray(h) for h in hs],
                     ph, pw)["params"]
    rng = np.random.default_rng(seed + 9)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    params["head_conv3"]["bias"] = params["head_conv3"]["bias"] + 1.0
    ph_ = DPTHead(DPTConfig(features=FEAT, out_channels=NECK, head_hidden=8,
                            fused_head=fused_head, fused_convs=fused_convs),
                  24).eval()
    ph_.load_state_dict(from_txr_params(params))
    return jh, jax.tree_util.tree_map(jnp.asarray, params), ph_, hs


@pytest.fixture
def conv_calls(monkeypatch):
    """The (H, W) of every map the head sends through conv3x3_stripe."""
    import txr_torch.models.dpt as pdpt

    calls = []

    def spy(x, *rest):
        calls.append(tuple(x.shape[1:3]))
        return pc.conv3x3_stripe(x, *rest)

    monkeypatch.setattr(pdpt, "conv3x3_stripe", spy)
    return calls


class TestFusedConvHead:
    def test_head_with_area_gate_engaged_matches_txr(self, conv_calls):
        """ph = pw = 24: fusion_0's map is 96 x 96, so its residual units
        (and head_conv1) go through the conv kernel on the txr side
        (interpreted) and through conv3x3_stripe on the port's. 5e-4: the
        same f32 sums in another order through some twenty layers."""
        jh, params, ph_, hs = _head_pair(True, True, 24, 24)
        want = np.asarray(jh.apply({"params": params},
                                   [jnp.asarray(h) for h in hs], 24, 24))
        with torch.no_grad():
            got = ph_([torch.from_numpy(h) for h in hs], 24, 24).numpy()
        # fusion_0: rcu1 and rcu2, two convs each, on 96 x 96; head_conv1 on
        # 192 x 192; the smaller stages stay on the library conv
        assert conv_calls == [(96, 96)] * 4 + [(192, 192)]
        assert got.shape == want.shape == (1, 336, 336)
        assert got.std() > 1e-3
        np.testing.assert_allclose(got, want, rtol=5e-4, atol=5e-4)

    def test_fusion_block_gate_follows_txr(self, conv_calls):
        """FeatureFusionBlock(fused=True) alone: below 96*96 pixels the
        library conv runs, at 96*96 the kernel path; both equal txr's."""
        for side, fused_calls in ((40, 0), (96, 4)):
            x = _rand((1, side, side, FEAT), side)
            res = _rand((1, side, side, FEAT), side + 1)
            jb = TxrFusionBlock(FEAT, fused=True)
            params = jb.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             jnp.asarray(res))["params"]
            rng = np.random.default_rng(side)
            params = jax.tree_util.tree_map(
                lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
                    a.shape).astype(np.float32), params)
            want = np.asarray(jb.apply(
                {"params": jax.tree_util.tree_map(jnp.asarray, params)},
                jnp.asarray(x), jnp.asarray(res)))
            pb = FeatureFusionBlock(FEAT, fused=True).eval()
            pb.load_state_dict(from_txr_params(params))
            del conv_calls[:]
            with torch.no_grad():
                got = pb(torch.from_numpy(x).permute(0, 3, 1, 2),
                         torch.from_numpy(res).permute(0, 3, 1, 2))
            assert len(conv_calls) == fused_calls
            np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                                       rtol=5e-4, atol=5e-4)

    def test_head_conv1_needs_the_fused_tail_too(self, conv_calls):
        """fused_convs with fused_head=False leaves head_conv1 to the
        library conv, as in txr."""
        _, _, ph_, hs = _head_pair(False, True, 4, 5)
        with torch.no_grad():
            ph_([torch.from_numpy(h) for h in hs], 4, 5)
        assert conv_calls == []

    def test_state_dict_is_unchanged_by_fused_convs(self):
        a = DPTHead(DPTConfig(features=FEAT, out_channels=NECK), 24)
        b = DPTHead(DPTConfig(features=FEAT, out_channels=NECK,
                              fused_convs=True), 24)
        sa, sb = a.state_dict(), b.state_dict()
        assert list(sa) == list(sb)
        assert all(sa[k].shape == sb[k].shape for k in sa)
        assert isinstance(b.head_conv1, Conv3x3)
        assert isinstance(b.head_conv1, torch.nn.Conv2d)

    def test_gradient_through_fused_head_equals_unfused(self):
        """Training through the fused head (both Functions differentiate
        their plain versions) gives the unfused gradients; f32 1e-4."""
        _, _, fused, hs = _head_pair(True, True, 24, 24, seed=3)
        plain = DPTHead(DPTConfig(features=FEAT, out_channels=NECK,
                                  head_hidden=8, fused_head=False), 24)
        plain.load_state_dict(fused.state_dict())
        grads = []
        for head in (fused, plain):
            head.zero_grad()
            y = head([torch.from_numpy(h) for h in hs], 24, 24)
            ((y - 2.0) ** 2).mean().backward()
            grads.append({k: p.grad.clone()
                          for k, p in head.named_parameters()})
        assert grads[0].keys() == grads[1].keys()
        for k in grads[0]:
            np.testing.assert_allclose(grads[0][k].numpy(),
                                       grads[1][k].numpy(), rtol=1e-3,
                                       atol=1e-4, err_msg=k)


# ------------------------------------------------- host side of the kernel

class TestKernelGeometry:
    """The grid, TMA boxes and shared-memory arithmetic the CUDA kernel is
    launched with (pure Python; the kernel itself runs only on the card)."""

    @pytest.mark.parametrize("shape,feat", [
        ((8, 74, 132, 256), 256),      # fusion_1
        ((8, 148, 264, 256), 256),     # fusion_0
        ((8, 296, 528, 256), 128),     # head_conv1
        ((1, 13, 21, 48), 40),         # ragged everywhere, a short chunk
        ((1, 5, 7, 64), 64),           # smaller than one tile
        ((2, 20, 33, 256), 136),       # F a multiple of no feature block
    ])
    def test_grid_boxes_and_shared_memory(self, shape, feat):
        b, h, w, c = shape
        geo = pc.kernel_geometry(b, h, w, c, feat)
        gx, gy, gz = geo["grid"]
        assert (gx - 1) * pc.TILE_W < w <= gx * pc.TILE_W
        assert (gy - 1) * pc.TILE_H < h <= gy * pc.TILE_H
        nfb = geo["feature_blocks"]
        assert gz == b * nfb
        assert (nfb - 1) * pc.BLOCK_F < feat <= nfb * pc.BLOCK_F
        chunks = geo["chunks"]
        assert (chunks - 1) * pc.CHUNK_C < c <= chunks * pc.CHUNK_C
        assert geo["depth_steps"] == 9 * geo["chunks"]
        # a box row is one 128-byte swizzle line; a box dimension holds at
        # most 256 elements
        assert geo["patch_box"] == (64, pc.TILE_W + 2, pc.TILE_H + 2, 1)
        assert geo["weight_box"] == (64, pc.BLOCK_F, 1)
        assert geo["patch_box"][0] * 2 == 128 == geo["weight_box"][0] * 2
        assert max(geo["patch_box"] + geo["weight_box"]) <= 256
        assert geo["smem_bytes"] <= pc.MAX_SMEM_BYTES
        patch = geo["patch_box"][1] * geo["patch_box"][2] * 128
        assert geo["smem_bytes"] >= 2 * patch + pc.W_SLOTS * pc.BLOCK_F * 128
        assert 0 < geo["stored_share"] <= 1
        assert geo["stored_share"] == pytest.approx(
            h * w / (gx * gy * pc.TILE_H * pc.TILE_W))
        assert gy <= 65535 and gz <= 65535

    def test_launch_limits_raise(self):
        # the grid's z dimension: batch x feature blocks
        assert pc.kernel_geometry(40000, 4, 4, 8, 256)["grid"][2] > 65535


class TestPackedWeight:
    @pytest.mark.parametrize("c,feat", [(16, 8), (48, 40), (8, 136)])
    def test_round_trip_against_txr_packing(self, c, feat):
        """The port packs (9, F, C), txr (3, C, 3F) as
        transpose(w, (1, 2, 0, 3)); both hold the same bf16 values, and HWIO
        comes back from either."""
        w = _rand((3, 3, c, feat), 21, 0.3)
        wp = pc.pack_weight(torch.from_numpy(w))
        assert wp.shape == (9, feat, c) and wp.is_contiguous()
        back = wp.reshape(3, 3, feat, c).permute(0, 1, 3, 2)      # HWIO
        assert torch.equal(back, torch.from_numpy(w).to(torch.bfloat16))
        txr_packed = np.asarray(jnp.transpose(
            jnp.asarray(w), (1, 2, 0, 3)).reshape(3, c, 3 * feat).astype(
                jnp.bfloat16).astype(jnp.float32))
        mine = back.permute(1, 2, 0, 3).reshape(3, c, 3 * feat).float()
        np.testing.assert_array_equal(mine.numpy(), txr_packed)

    @pytest.mark.parametrize("relu_in", [False, True])
    def test_products_from_the_packed_weight_equal_the_reference(self,
                                                                relu_in):
        """The kernel's sum, written out on the packed layout: nine shifted
        (pixels x C) @ (C x F) products plus the bias; f32 2e-4 on the
        bf16-rounded weight."""
        x = torch.from_numpy(_rand((1, 6, 7, 16), 22))
        w = torch.from_numpy(_rand((3, 3, 16, 24), 23, 0.3)
                             ).to(torch.bfloat16).float()
        b = torch.from_numpy(_rand((24,), 24))
        wp = pc.pack_weight(w).float()
        xin = torch.relu(x) if relu_in else x
        xpad = torch.nn.functional.pad(xin, (0, 0, 1, 1, 1, 1))
        out = b.expand(1, 6, 7, 24).clone()
        for tap in range(9):
            di, dj = divmod(tap, 3)
            out += xpad[:, di:di + 6, dj:dj + 7] @ wp[tap].t()
        np.testing.assert_allclose(
            out.numpy(), pc.conv3x3_reference(x, w, b, relu_in).numpy(),
            **TOL)
