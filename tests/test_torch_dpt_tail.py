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
