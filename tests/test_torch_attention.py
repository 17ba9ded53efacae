"""``txr_torch.ops.attention`` against ``txr.ops.attention``.

On the CPU the port's ``fused_attention`` takes its plain version, which is
held here against ``txr``'s Pallas kernels run in interpret mode (the
single-pass kernel for full keys, the streaming kernel for ``kv_len < S``)
and against ``txr``'s XLA reference.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from txr.ops import attention as ja
from txr_torch.ops import attention as pa

torch.set_num_threads(1)

H, D = 2, 8


def _qkv(b, s, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, s, 3 * H * D)).astype(np.float32)


class TestAttentionParity:
    @pytest.mark.parametrize("s", [5, 17, 130])
    @pytest.mark.parametrize("ragged", [False, True])
    def test_f32_matches_txr_kernel(self, s, ragged):
        """f32 3e-5: exp2 with a folded scale and another summation order
        on the txr side; S is a multiple of no block size."""
        kv = max(1, (2 * s) // 3) if ragged else None
        x = _qkv(2, s, seed=s)
        want = np.asarray(ja.attention_flash_fused(
            jnp.asarray(x), H, D, kv_len=kv, block_q=16))
        got = pa.fused_attention(torch.from_numpy(x), H, D, kv)
        assert got.shape == (2, s, H * D)
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
        ref = np.asarray(ja._fused_reference(jnp.asarray(x), H, D, kv))
        np.testing.assert_allclose(got.numpy(), ref, rtol=3e-5, atol=3e-5)

    @pytest.mark.parametrize("s", [17, 130])
    def test_bf16_matches_txr_kernel(self, s):
        """bf16 2e-2: txr's kernel also rounds the pre-scaled q to bf16."""
        x = _qkv(1, s, seed=s + 1)
        want = np.asarray(ja.attention_flash_fused(
            jnp.asarray(x).astype(jnp.bfloat16), H, D, block_q=16
        ).astype(jnp.float32))
        got = pa.fused_attention(torch.from_numpy(x).to(torch.bfloat16), H, D)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)

    def test_reference_is_what_cpu_dispatch_runs(self):
        x = torch.from_numpy(_qkv(1, 9))
        assert torch.equal(pa.fused_attention(x, H, D, 4),
                           pa.attention_reference(x, H, D, 4))

    @pytest.mark.parametrize("kv", [None, 7])
    def test_backward_matches_txr_vjp(self, kv):
        """The autograd.Function's backward against jax.vjp of txr's
        reference; f32 1e-4 on gradients of order 1."""
        x = _qkv(2, 11, seed=3)
        g = np.random.default_rng(4).standard_normal((2, 11, H * D)).astype(
            np.float32)
        _, vjp = jax.vjp(lambda a: ja._fused_reference(a, H, D, kv),
                         jnp.asarray(x))
        want = np.asarray(vjp(jnp.asarray(g))[0])
        xt = torch.from_numpy(x).requires_grad_(True)
        pa.fused_attention(xt, H, D, kv).backward(torch.from_numpy(g))
        np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4)

    def test_bad_arguments_raise(self):
        x = torch.zeros((1, 4, 3 * H * D))
        with pytest.raises(ValueError):
            pa.fused_attention(x, H, D + 1)
        with pytest.raises(ValueError):
            pa.fused_attention(x, H, D, kv_len=0)
        with pytest.raises(ValueError):
            pa.fused_attention(x, H, D, kv_len=5)
