"""``txr_torch.ops.resize`` against ``txr.ops.resize`` on the same inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from txr.ops import resize as jr
from txr_torch.ops import resize as tr

torch.set_num_threads(1)


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


CASES = [((2, 7, 9, 3), 13, 20), ((1, 8, 8, 2), 19, 11),
         ((1, 12, 10, 4), 5, 7), ((3, 5, 6, 1), 1, 9)]


class TestResizeParity:
    @pytest.mark.parametrize("align", [True, False])
    @pytest.mark.parametrize("shape,h,w", CASES)
    def test_bilinear_f32(self, shape, h, w, align):
        """f32 1e-5: same taps and weights, products summed in another
        order (txr multiplies by an interpolation matrix)."""
        x = _x(shape)
        want = np.asarray(jr.resize_bilinear(jnp.asarray(x), h, w,
                                             align_corners=align))
        got = tr.resize_bilinear(torch.from_numpy(x), h, w,
                                 align_corners=align)
        assert got.dtype == torch.float32 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("align", [True, False])
    @pytest.mark.parametrize("shape,h,w", CASES)
    def test_bicubic_f32(self, shape, h, w, align):
        """f32 1e-4: four taps with weights of both signs."""
        x = _x(shape, 1)
        want = np.asarray(jr.resize_bicubic(jnp.asarray(x), h, w,
                                            align_corners=align))
        got = tr.resize_bicubic(torch.from_numpy(x), h, w,
                                align_corners=align)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
    def test_bf16(self, mode):
        """bf16 3e-2: txr rounds the interpolation weights to bf16 as well,
        the port only data and result; the input type is kept."""
        x = _x((1, 7, 9, 4), 2)
        jf = getattr(jr, f"resize_{mode}")
        pf = getattr(tr, f"resize_{mode}")
        want = np.asarray(jf(jnp.asarray(x).astype(jnp.bfloat16), 15, 21
                             ).astype(jnp.float32))
        got = pf(torch.from_numpy(x).to(torch.bfloat16), 15, 21)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                                   atol=3e-2)

    def test_leading_dims_and_uint8(self):
        x = np.random.default_rng(3).integers(0, 256, (2, 3, 6, 5, 3),
                                              dtype=np.uint8)
        want = np.asarray(jr.resize_bicubic(jnp.asarray(x), 9, 8))
        got = tr.resize_bicubic(torch.from_numpy(x), 9, 8)
        assert got.shape == (2, 3, 9, 8, 3) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=2e-3)


class TestStridedResize:
    @pytest.mark.parametrize("align", [True, False])
    @pytest.mark.parametrize("shape,h,w,rs,cs", [
        ((2, 7, 9, 3), 13, 20, 2, 3), ((1, 8, 8, 2), 19, 11, 1, 2),
        ((1, 12, 10, 1), 5, 7, 4, 1), ((3, 5, 6, 1), 1, 9, 2, 2)])
    def test_strided_matches_txr_and_the_full_resize(self, shape, h, w, rs,
                                                     cs, align):
        """f32 1e-5 against txr's strided resize and against the strided
        slice of the port's full resize: same taps and weights."""
        x = _x(shape, 4)
        want = np.asarray(jr.resize_bilinear_strided(
            jnp.asarray(x), h, w, align_corners=align, row_stride=rs,
            col_stride=cs))
        tx = torch.from_numpy(x)
        got = tr.resize_bilinear_strided(tx, h, w, align, rs, cs)
        full = tr.resize_bilinear(tx, h, w, align_corners=align)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.numpy(),
                                   full[..., ::rs, ::cs, :].numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_strided_keeps_a_floating_dtype(self):
        x = torch.from_numpy(_x((1, 6, 5, 2), 5)).to(torch.bfloat16)
        y = tr.resize_bilinear_strided(x, 12, 9, True, 2, 2)
        assert y.dtype == torch.bfloat16 and y.shape == (1, 6, 5, 2)
        u8 = torch.zeros((1, 4, 4, 1), dtype=torch.uint8)
        assert tr.resize_bilinear_strided(u8, 8, 8).dtype == torch.float32


class TestDaResize:
    @pytest.mark.parametrize("target", [518, 224, 56])
    def test_compute_da_resize_equal_over_a_grid(self, target):
        sizes = [(1080, 1920), (480, 640), (720, 1280), (60, 80), (518, 518),
                 (1, 1), (37, 1000), (1000, 37), (519, 517), (2160, 3840)]
        sizes += [(h, w) for h in range(40, 700, 97)
                  for w in range(50, 900, 131)]
        for h, w in sizes:
            for lower in (True, False):
                assert tr.compute_da_resize(h, w, target, 14, lower) == \
                    jr.compute_da_resize(h, w, target, 14, lower), (h, w)
        assert tr.compute_da_resize(1080, 1920, 518) == (518, 924)

    def test_constants_and_rounding(self):
        assert tr.IMAGENET_MEAN == jr.IMAGENET_MEAN
        assert tr.IMAGENET_STD == jr.IMAGENET_STD
        for v in (0.0, 6.9, 7.0, 7.1, 20.9, 21.0, 517.9, 525.0):
            for m in (0, 14, 518):
                assert tr.constrain_to_multiple_of(v, 14, m) == \
                    jr.constrain_to_multiple_of(v, 14, m)
