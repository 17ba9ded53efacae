"""``txr_torch.ops.dpt_tail`` against ``txr.ops.dpt_tail``.

On the CPU the port's ``fused_head_tail`` takes its plain version, which is
held here against ``txr``'s Pallas kernel in interpret mode and against
``txr``'s XLA reference, at an upsample, at ratios ``txr``'s row window
cannot cover (near 1, downsample, one output row) and at the border.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F

from txr.ops import dpt_tail as jt
from txr_torch.ops import dpt_tail as pt

torch.set_num_threads(1)


def make_case(b, hin, win, c, feat, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hin, win, c)).astype(np.float32),
            (rng.standard_normal((3, 3, c, feat)) * 0.1).astype(np.float32),
            rng.standard_normal((feat,)).astype(np.float32),
            rng.standard_normal((feat,)).astype(np.float32),
            rng.standard_normal((1,)).astype(np.float32))


SHAPES = [
    # b, hin, win, hout, wout, c, feat
    (2, 32, 32, 36, 42, 16, 8),     # upsample, the fused path in txr
    (1, 16, 16, 30, 28, 128, 32),   # the head's channel widths
    (1, 176, 16, 180, 20, 8, 8),    # near-1 ratio
    (1, 64, 16, 40, 20, 8, 8),      # downsample
    (1, 32, 16, 1, 20, 8, 8),       # out_h == 1
]


class TestTailParity:
    @pytest.mark.parametrize("shape", SHAPES)
    def test_f32_matches_txr(self, shape):
        """f32 2e-4 (txr's own tolerance for its kernel): 9*C products per
        feature summed in another order."""
        b, hin, win, hout, wout, c, feat = shape
        args = make_case(b, hin, win, c, feat, seed=hin)
        jargs = [jnp.asarray(a) for a in args]
        kern = np.asarray(jt.fused_head_tail(*jargs, hout, wout,
                                             interpret=True))
        ref = np.asarray(jt.head_tail_reference(*jargs, hout, wout))
        targs = [torch.from_numpy(a) for a in args]
        got = pt.fused_head_tail(*targs, hout, wout)
        assert got.shape == (b, hout, wout) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), kern, rtol=2e-4, atol=2e-4)
        np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-4)
        plain = pt.head_tail_reference(*targs, hout, wout)
        assert torch.equal(got, plain)

    def test_bf16_matches_txr(self):
        """bf16 0.1 / 0.12 (txr's own): the two sides round the resized
        image, conv2 and conv3 at different places."""
        args = make_case(1, 32, 32, 128, 32, seed=5)
        want = np.asarray(jt.fused_head_tail(
            *[jnp.asarray(a, jnp.bfloat16) for a in args], 36, 42,
            interpret=True).astype(jnp.float32))
        got = pt.fused_head_tail(
            *[torch.from_numpy(a).to(torch.bfloat16) for a in args], 36, 42)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=0.1,
                                   atol=0.12)

    def test_edge_zero_padding(self):
        """conv2's zero padding applies at the border of the UPSAMPLED
        image: a constant input stays constant inside but not at the
        edges."""
        b, hin, win, hout, wout, c, feat = 1, 16, 16, 30, 28, 64, 8
        x = np.ones((b, hin, win, c), np.float32)
        w2 = np.full((3, 3, c, feat), 0.01, np.float32)
        b2 = np.zeros((feat,), np.float32)
        w3 = np.ones((feat,), np.float32)
        b3 = np.zeros((1,), np.float32)
        want = np.asarray(jt.head_tail_reference(
            *[jnp.asarray(a) for a in (x, w2, b2, w3, b3)], hout, wout))
        got = pt.fused_head_tail(
            *[torch.from_numpy(a) for a in (x, w2, b2, w3, b3)], hout,
            wout).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        assert got[0, 0, 0] < got[0, hout // 2, wout // 2]
        assert got[0, 0, wout // 2] < got[0, hout // 2, wout // 2]

    def test_w3_as_conv_kernel_and_backward(self):
        """w3 may come as the (1, 1, F, 1) conv kernel; the gradient is the
        plain version's."""
        args = make_case(1, 6, 7, 4, 3, seed=7)
        targs = [torch.from_numpy(a).requires_grad_(True) for a in args]
        out = pt.fused_head_tail(targs[0], targs[1], targs[2],
                                 targs[3].reshape(1, 1, 3, 1), targs[4], 9, 11)
        g = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (1, 9, 11)).astype(np.float32))
        out.backward(g)
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
        pt.head_tail_reference(*leaves, 9, 11).backward(g)
        for a, b in zip(targs, leaves):
            np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(),
                                       rtol=1e-5, atol=1e-5)

    def test_bad_arguments_raise(self):
        x = torch.zeros((1, 4, 4, 8))
        w2 = torch.zeros((3, 3, 4, 8))
        z = torch.zeros((8,))
        with pytest.raises(ValueError):
            pt.fused_head_tail(x, w2, z, z, z[:1], 8, 8)
        with pytest.raises(ValueError):
            pt.fused_head_tail(x, torch.zeros((3, 3, 8, 8)), z, z, z[:1],
                               0, 8)


class TestSeveralOutputs:
    """Depth Anything 3's branches end in conv3s of 2 and 7 outputs: w3 as
    the (1, 1, F, N) conv kernel, b3 (N,), the result (B, H, W, N)."""

    @pytest.mark.parametrize("nout", [2, 7])
    def test_each_output_is_the_one_output_tail(self, nout):
        """Output o of N is the tail computed with w3[..., o] and b3[o]
        alone, and the NCHW convs' conv3 channel o, to f32 rounding (the
        1x1 conv sums F products in another order at another N)."""
        x, w2, b2, _, _ = (torch.from_numpy(a) for a in
                           make_case(2, 6, 7, 16, 8, seed=nout))
        g = torch.Generator().manual_seed(nout)
        w3 = torch.randn((1, 1, 8, nout), generator=g)
        b3 = torch.randn((nout,), generator=g)
        got = pt.fused_head_tail(x, w2, b2, w3, b3, 9, 11)
        assert got.shape == (2, 9, 11, nout)
        assert torch.equal(got, pt.head_tail_reference(x, w2, b2, w3, b3,
                                                       9, 11))
        for o in range(nout):
            one = pt.fused_head_tail(x, w2, b2, w3[..., o:o + 1],
                                     b3[o:o + 1], 9, 11)
            assert one.shape == (2, 9, 11)
            torch.testing.assert_close(got[..., o], one, rtol=1e-6,
                                       atol=1e-6)
        y = F.interpolate(x.permute(0, 3, 1, 2), size=(9, 11),
                          mode="bilinear", align_corners=True)
        y = F.relu(F.conv2d(y, w2.permute(3, 2, 0, 1), b2, padding=1))
        want = F.conv2d(y, w3.permute(3, 2, 0, 1), b3).permute(0, 2, 3, 1)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)

    def test_packed_w3_is_output_major(self):
        """The kernel reads w3 as (N, F): conv3's own OIHW weight
        flattened."""
        g = torch.Generator().manual_seed(3)
        conv3 = torch.randn((7, 32, 1, 1), generator=g)      # OIHW
        w2 = torch.zeros((3, 3, 16, 32))
        _, _, w3f, b3f = pt.pack_params(w2, torch.zeros(32),
                                        conv3.permute(2, 3, 1, 0),
                                        torch.arange(7.0))
        assert torch.equal(w3f, conv3.reshape(-1))
        assert torch.equal(b3f, torch.arange(7.0))

    def test_a_w3_of_another_size_raises(self):
        x = torch.zeros((1, 4, 4, 8))
        w2 = torch.zeros((3, 3, 8, 4))
        with pytest.raises(ValueError, match="for each of b3"):
            pt.fused_head_tail(x, w2, torch.zeros(4),
                               torch.zeros((1, 1, 4, 2)), torch.zeros(3),
                               8, 8)


# ------------------------------------------------- the kernel's host side

def _head_widths():
    from txr_torch.models.depth_anything import MODEL_CONFIGS

    return sorted({c["features"] // 2 for entries in MODEL_CONFIGS.values()
                   for c in entries.values()})


GEOMETRY_SHAPES = [
    # b, hin, win, c, hout, wout
    (8, 296, 528, 128, 518, 924),   # the head at 1080p
    (1, 176, 40, 128, 180, 45),     # near-1 ratio
    (1, 64, 48, 128, 40, 30),       # downsample
    (1, 32, 16, 128, 1, 20),        # out_h == 1
    (1, 4, 4, 32, 5, 7),            # smaller than one tile
    (2, 12, 20, 192, 21, 33),       # one column past a tile
]


class TestKernelGeometry:
    """``dpt_tail.kernel_geometry``: tile, input window, shared memory and
    persistent grid of the kernel, as pure arithmetic."""

    @pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
    @pytest.mark.parametrize("sms", [1, 132])
    def test_tiles_cover_the_image_exactly_once(self, shape, sms):
        b, hin, win, c, hout, wout = shape
        geo = pt.kernel_geometry(*shape, sms)
        assert 1 <= geo["grid"] <= sms
        assert geo["smem_bytes"] <= pt.MAX_SMEM_BYTES == 232448
        th, tw = geo["tile"]
        seen = np.zeros((b, hout, wout), np.int32)
        walked = 0
        for block in range(geo["grid"]):        # the kernel's own walk
            for i in range(block, geo["tiles"], geo["grid"]):
                bi, y0, x0 = pt.tile_origin(i, geo)
                assert bi < b and y0 < hout and x0 < wout
                seen[bi, y0:y0 + th, x0:x0 + tw] += 1
                walked += 1
        assert walked == geo["tiles"] and (seen == 1).all()

    @pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
    def test_window_holds_every_tap(self, shape):
        """Each in-range position of a tile-plus-halo reads four taps whose
        clamped indices lie inside the tile's window box (f32 coordinates,
        as in the kernel)."""
        b, hin, win, c, hout, wout = shape
        geo = pt.kernel_geometry(*shape, 132)
        (th, tw), (wh, ww) = geo["tile"], geo["window"]
        assert wh <= pt.MAX_BOX and ww <= pt.MAX_BOX
        for n_out, n_in, tile, ext in ((hout, hin, th, wh),
                                       (wout, win, tw, ww)):
            scale = pt._scale(n_in, n_out)
            widest = 0
            for t0 in range(0, n_out, tile):
                org = pt._origin(t0, scale, n_in)
                for o in range(max(t0 - 1, 0), min(t0 + tile, n_out - 1) + 1):
                    i0 = int(np.floor(np.float32(o) * scale))
                    i0 = min(max(i0, 0), n_in - 1)
                    i1 = min(i0 + 1, n_in - 1)
                    assert org <= i0 and i1 - org < ext
                    widest = max(widest, i1 - org + 1)
            assert widest == ext == pt.window_extent(n_out, n_in, tile)

    @pytest.mark.parametrize("c", _head_widths())
    def test_every_head_width_fits(self, c):
        assert c in (32, 64, 128, 192)
        geo = pt.kernel_geometry(8, 296, 528, c, 518, 924, 132)
        assert geo["smem_bytes"] <= 232448 and geo["grid"] == 132
        assert geo["chunks"] == -(-c // 64)
        assert geo["weight_bytes"] == 9 * geo["chunks"] * 32 * 128
        assert geo["window_box"] == (64, *geo["window"][::-1], 1)
        parts = (1024 + geo["weight_bytes"] + 2 * geo["patch_bytes"]
                 + geo["window_buffers"] * geo["window_bytes"] + 2 * 43 * 16
                 + 72)
        assert parts == geo["smem_bytes"]
        assert geo["patch_bytes"] % 1024 == geo["window_bytes"] % 1024 == 0

    def test_launch_limits_raise(self):
        with pytest.raises(ValueError, match="positive"):
            pt.kernel_geometry(1, 8, 8, 128, 0, 8, 132)
        with pytest.raises(ValueError, match="positive"):
            pt.kernel_geometry(1, 8, 8, 128, 8, 8, 0)
        with pytest.raises(ValueError, match="downsample"):
            pt.kernel_geometry(1, 2000, 2000, 128, 40, 40, 132)
        with pytest.raises(ValueError, match="32 bits"):
            pt.kernel_geometry(2 ** 22, 8, 8, 128, 518, 924, 132)

    def test_what_the_kernel_refuses_raises_by_name(self):
        """The checks in front of the launch need no card."""
        def packed(c, feat, dtype=torch.bfloat16):
            return pt.pack_params(torch.zeros((3, 3, c, feat), dtype=dtype),
                                  torch.zeros((feat,)), torch.zeros((feat,)),
                                  torch.zeros((1,)))

        x = torch.zeros((1, 4, 4, 32), dtype=torch.bfloat16)
        with pytest.raises(TypeError, match="bfloat16"):
            pt._launch(x.float(), packed(32, 32), 8, 8)
        with pytest.raises(ValueError, match="32 conv2 features"):
            pt._launch(x, packed(32, 16), 8, 8)
        with pytest.raises(ValueError, match="multiple of 16"):
            pt._launch(torch.zeros((1, 4, 4, 24), dtype=torch.bfloat16),
                       packed(24, 32), 8, 8)
        with pytest.raises(ValueError, match=r"\(9, 32, 32\)"):
            pt._launch(x, packed(48, 32), 8, 8)
        with pytest.raises(ValueError, match="b2 and w3"):
            w2p, b2, w3, b3 = packed(32, 32)
            pt._launch(x, (w2p, b2[:8], w3, b3), 8, 8)


class TestPackedOperands:
    def test_pack_params_layout(self):
        """(3, 3, C, F) -> (tap, feature, channel), f32 vectors."""
        x, w2, b2, w3, b3 = (torch.from_numpy(a) for a in
                             make_case(1, 4, 4, 16, 32, seed=3))
        w2p, b2f, w3f, b3f = pt.pack_params(w2, b2, w3.reshape(1, 1, 32, 1),
                                            b3)
        assert w2p.shape == (9, 32, 16) and w2p.dtype == torch.bfloat16
        assert w2p.is_contiguous()
        for tap in range(9):
            want = w2[tap // 3, tap % 3].t().to(torch.bfloat16)
            assert torch.equal(w2p[tap], want)
        assert all(t.dtype == torch.float32 for t in (b2f, w3f, b3f))
        assert torch.equal(b2f, b2) and torch.equal(w3f, w3)
        assert b3f.shape == (1,) and torch.equal(b3f, b3)

    def test_head_derives_them_once_and_follows_the_parameters(self):
        from txr_torch.models.dpt import DPTConfig, DPTHead

        cfg = DPTConfig(features=32, out_channels=(8, 8, 8, 8))
        head = DPTHead(cfg, hidden_size=16)
        keys = set(head.state_dict())
        ops = head.tail_operands()
        assert set(head.state_dict()) == keys
        assert not any("tail" in k for k in keys)

        def per_call():
            return pt.pack_params(
                head.head_conv2.weight.detach().permute(2, 3, 1, 0),
                head.head_conv2.bias.detach(),
                head.head_conv3.weight.detach().reshape(-1),
                head.head_conv3.bias.detach())

        for got, want in zip(ops, per_call()):
            assert got.dtype == want.dtype and torch.equal(got, want)
        again = head.tail_operands()
        assert all(a is b for a, b in zip(ops, again))    # reused
        with torch.no_grad():
            head.head_conv2.weight.mul_(2.0)
            head.head_conv3.bias.add_(1.0)
        changed = head.tail_operands()
        assert changed[0] is not ops[0] and changed[3] is not ops[3]
        assert changed[1] is ops[1] and changed[2] is ops[2]
        for got, want in zip(changed, per_call()):
            assert torch.equal(got, want)
        head.load_state_dict({k: torch.zeros_like(v)
                              for k, v in head.state_dict().items()})
        assert not head.tail_operands()[0].any()

    def test_packed_argument_changes_nothing_on_the_cpu(self):
        args = [torch.from_numpy(a) for a in make_case(1, 6, 7, 16, 32,
                                                       seed=9)]
        want = pt.fused_head_tail(*args, 9, 11)
        got = pt.fused_head_tail(*args, 9, 11, pt.pack_params(*args[1:]))
        assert torch.equal(got, want)
