"""``txr_torch.ops.attention`` against ``txr.ops.attention``.

On the CPU the port's ``fused_attention`` takes its plain version, which is
held here against ``txr``'s Pallas kernels run in interpret mode (the
single-pass kernel for full keys, the streaming kernel for ``kv_len < S``)
and against ``txr``'s XLA reference. ``attention_flash`` /
``multi_head_attention`` on (B, H, S, D) operands are held against ``txr``'s
``attention_flash`` (its third Pallas kernel, interpreted) and
``attention_xla``, and an odd-head ViT encoder against ``txr``'s.
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


class TestBoundmaxParity:
    """Score mode ``"boundmax"`` against ``txr``'s single-pass kernel in
    that mode (interpret mode), which zero-pads S to its block and removes
    the pads' mass from the normaliser where the port masks."""

    @pytest.mark.parametrize("s", [64, 75, 130])
    def test_f32_matches_txr_kernel(self, s):
        """f32 3e-5, txr's own tolerance for this mode; S = 75 and 130 are
        multiples of no block."""
        x = _qkv(2, s, seed=20 + s)
        want = np.asarray(ja.attention_flash_fused(
            jnp.asarray(x), H, D, block_q=16, score_mode="boundmax"))
        got = pa.fused_attention(torch.from_numpy(x), H, D,
                                 score_mode="boundmax")
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
        ref = np.asarray(ja._fused_reference(jnp.asarray(x), H, D))
        np.testing.assert_allclose(got.numpy(), ref, rtol=3e-5, atol=3e-5)

    @pytest.mark.parametrize("s", [17, 130])
    def test_bf16_matches_txr_kernel(self, s):
        """bf16 2e-2: both round q c and p to bf16."""
        x = _qkv(1, s, seed=30 + s)
        want = np.asarray(ja.attention_flash_fused(
            jnp.asarray(x).astype(jnp.bfloat16), H, D, block_q=16,
            score_mode="boundmax").astype(jnp.float32))
        got = pa.fused_attention(torch.from_numpy(x).to(torch.bfloat16), H,
                                 D, score_mode="boundmax")
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)

    @pytest.mark.parametrize("scale", [6.0, 8.0])
    def test_extreme_logits_finite_and_equal(self, scale):
        """Logits far past the bound's 83 nats saturate p at 2^60 on both
        sides; the results stay finite and agree to the bf16 tolerance."""
        h, d, s = 2, 64, 64
        x = (np.random.default_rng(40).standard_normal((1, s, 3 * h * d))
             * scale).astype(np.float32)
        want = np.asarray(ja.attention_flash_fused(
            jnp.asarray(x), h, d, block_q=32, score_mode="boundmax"))
        got = pa.fused_attention(torch.from_numpy(x), h, d,
                                 score_mode="boundmax").numpy()
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)

    def test_env_is_read_at_call_time(self, monkeypatch):
        x = torch.from_numpy(_qkv(2, 33, seed=41) * 3.0)
        bound = pa.attention_reference(x, H, D, score_mode="boundmax")
        exact = pa.attention_reference(x, H, D, score_mode="f32max")
        assert not torch.equal(bound, exact)
        monkeypatch.setenv("TXR_ATTN_SCORES", "boundmax")
        assert torch.equal(pa.fused_attention(x, H, D), bound)
        monkeypatch.setenv("TXR_ATTN_SCORES", "f32max")
        assert torch.equal(pa.fused_attention(x, H, D), exact)
        monkeypatch.delenv("TXR_ATTN_SCORES")
        assert torch.equal(pa.fused_attention(x, H, D), exact)

    def test_kv_len_and_bhsd_routes_ignore_the_mode(self, monkeypatch):
        """txr's streaming and (B, H, S, D) kernels take no score mode."""
        x = _qkv(2, 40, seed=42)
        want = np.asarray(ja.attention_flash_fused(
            jnp.asarray(x), H, D, kv_len=25, block_q=16,
            score_mode="boundmax"))
        xt = torch.from_numpy(x)
        got = pa.fused_attention(xt, H, D, 25, score_mode="boundmax")
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
        assert torch.equal(got, pa.fused_attention(xt, H, D, 25,
                                                   score_mode="f32max"))
        q, k, v = pa.split_heads(xt, H, D)
        plain = pa.attention_flash(q, k, v)
        monkeypatch.setenv("TXR_ATTN_SCORES", "boundmax")
        assert torch.equal(pa.attention_flash(q, k, v), plain)

    def test_unknown_mode_raises(self, monkeypatch):
        x = torch.zeros((1, 4, 3 * H * D))
        with pytest.raises(ValueError):
            pa.fused_attention(x, H, D, score_mode="bf16max")
        monkeypatch.setenv("TXR_ATTN_SCORES", "nope")
        with pytest.raises(ValueError):
            pa.fused_attention(x, H, D)
        with pytest.raises(ValueError):
            pa.attention_reference(x, H, D)

    def test_key_norm_and_backward(self):
        """The pre-pass's plain version against numpy; the backward in this
        mode differentiates the f32max reference, as txr's custom VJP."""
        x = _qkv(2, 11, seed=43)
        k = x[..., H * D:2 * H * D].reshape(2, 11, H, D)
        want = np.sqrt((k.astype(np.float64) ** 2).sum(-1).max(1))
        got = pa.attention_key_norm(torch.from_numpy(x), H, D)
        assert got.shape == (2, H) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
        g = torch.from_numpy(np.random.default_rng(44).standard_normal(
            (2, 11, H * D)).astype(np.float32))
        grads = []
        for mode in ("boundmax", "f32max"):
            xt = torch.from_numpy(x).requires_grad_(True)
            pa.fused_attention(xt, H, D, score_mode=mode).backward(g)
            grads.append(xt.grad)
        assert torch.equal(grads[0], grads[1])


def _bhsd(b, h, s, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, s, d)).astype(np.float32)
                 for _ in range(3))


class TestBhsdAttentionParity:
    @pytest.mark.parametrize("s", [5, 17, 130])
    @pytest.mark.parametrize("ragged", [False, True])
    def test_f32_matches_txr_flash_kernel(self, s, ragged):
        """Three heads (odd), f32 3e-5 as above; S is a multiple of no
        block size, so txr's kernel pads and masks."""
        kv = max(1, (2 * s) // 3) if ragged else None
        q, k, v = _bhsd(2, 3, s, D, seed=s)
        want = np.asarray(ja.attention_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=kv,
            block_q=16, block_k=16))
        ref = np.asarray(ja.attention_xla(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), kv_len=kv))
        tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
        got = pa.attention_flash(tq, tk, tv, kv)
        assert got.shape == (2, 3, s, D)
        np.testing.assert_allclose(got.numpy(), want, rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(got.numpy(), ref, rtol=3e-5, atol=3e-5)
        for use_flash in (None, True, False):
            assert torch.equal(
                pa.multi_head_attention(tq, tk, tv, kv, use_flash), got)

    def test_bf16_matches_txr_flash_kernel(self):
        """bf16 2e-2: both round the probabilities to bf16 before PV."""
        q, k, v = _bhsd(1, 3, 40, D, seed=5)
        want = np.asarray(ja.attention_flash(
            *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
            block_q=16, block_k=16).astype(jnp.float32))
        got = pa.attention_flash(
            *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)))
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2e-2,
                                   atol=2e-2)

    def test_strided_views_of_a_fused_projection(self):
        """The views a ViT slices from its qkv projection are not
        contiguous; the result equals the fused entry point's."""
        x = torch.from_numpy(_qkv(2, 19, seed=7))
        q, k, v = pa.split_heads(x, H, D)
        assert not q.is_contiguous() and q.shape == (2, H, 19, D)
        o = pa.attention_flash(q, k, v, 11)
        np.testing.assert_allclose(
            o.transpose(1, 2).reshape(2, 19, H * D).numpy(),
            pa.fused_attention(x, H, D, 11).numpy(), rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("kv", [None, 7])
    def test_backward_matches_txr_vjp(self, kv):
        q, k, v = _bhsd(1, 3, 11, D, seed=8)
        g = np.random.default_rng(9).standard_normal((1, 3, 11, D)).astype(
            np.float32)
        _, vjp = jax.vjp(lambda a, b, c: ja.attention_xla(a, b, c, kv),
                         jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
        leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        pa.attention_flash(*leaves, kv).backward(torch.from_numpy(g))
        for leaf, wnt in zip(leaves, want):
            np.testing.assert_allclose(leaf.grad.numpy(), wnt, rtol=1e-4,
                                       atol=1e-4)

    def test_bad_arguments_raise(self):
        q = torch.zeros((1, 3, 4, D))
        with pytest.raises(ValueError):
            pa.attention_flash(q, q[:, :2], q)
        with pytest.raises(ValueError):
            pa.attention_flash(q, q, q, kv_len=5)
        with pytest.raises(ValueError):
            pa.multi_head_attention(q, q, q, kv_len=0, use_flash=False)


@pytest.mark.parametrize("use_flash", [True, False])
def test_odd_head_encoder_matches_txr(use_flash):
    """A ViT with three heads takes the (B, H, S, D) path in both packages
    (txr's flash kernel interpreted when use_flash); f32 1e-4 through two
    blocks."""
    from txr.models.vit import ViTConfig as TxrViTConfig
    from txr.models.vit import ViTEncoder as TxrViTEncoder
    from txr_torch.models.convert import from_txr_params
    from txr_torch.models.vit import ViTConfig, ViTEncoder

    kw = dict(hidden_size=48, num_layers=2, num_heads=3, pos_embed_size=4,
              out_layers=(0, 0, 1, 1), use_flash=use_flash)
    x = np.random.default_rng(10).standard_normal((2, 56, 70, 3)).astype(
        np.float32)
    enc = TxrViTEncoder(TxrViTConfig(**kw))
    params = enc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(11)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32), params)
    want = enc.apply({"params": jax.tree_util.tree_map(jnp.asarray, params)},
                     jnp.asarray(x))
    port = ViTEncoder(ViTConfig(**kw)).eval()
    port.load_state_dict(from_txr_params(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# ------------------------------------------------- host side of the kernel

S_PATH = 2443        # tokens of a 518 x 924 input at patch 14, plus cls


class TestKernelGeometry:
    """The grid, tile and shared-memory arithmetic the CUDA kernel is
    launched with (pure Python; the kernel itself runs only on the card)."""

    @pytest.mark.parametrize("batch,heads,s,kv", [
        (8, 16, S_PATH, S_PATH),      # main_path and quant_path
        (8, 15, S_PATH, S_PATH),      # odd_heads_path
        (8, 16, S_PATH, 2000),        # the kv_len mode
        (2, 16, 2432, 2432),          # a multiple of both tiles
        (1, 16, 77, 77),              # fewer rows than one block
        (2, 16, S_PATH, 1),           # one key
        (2, 16, S_PATH, 64),
        (2, 16, S_PATH, 1984),
    ])
    def test_grid_tiles_and_shared_memory(self, batch, heads, s, kv):
        geo = pa.kernel_geometry(batch, heads, s, kv)
        gx, gy, gz = geo["grid"]
        assert (gy, gz) == (heads, batch)
        # every query row has a block, and no block is without rows
        assert (gx - 1) * pa.BLOCK_Q < s <= gx * pa.BLOCK_Q
        tiles = geo["key_tiles"]
        assert tiles >= 1
        assert (tiles - 1) * pa.BLOCK_K < kv <= tiles * pa.BLOCK_K
        assert geo["masked_keys_in_last_tile"] == tiles * pa.BLOCK_K - kv
        assert 0 <= geo["masked_keys_in_last_tile"] < pa.BLOCK_K
        assert geo["smem_bytes"] <= pa.MAX_SMEM_BYTES
        # q, the K/V ring, the barriers and the alignment slack
        tile = pa.BLOCK_K * pa.HEAD_DIM * 2
        assert geo["smem_bytes"] >= (pa.BLOCK_Q * pa.HEAD_DIM * 2
                                     + 2 * pa.STAGES * tile)
        assert gy <= 65535 and gz <= 65535

    def test_path_shape_numbers(self):
        geo = pa.kernel_geometry(8, 16, S_PATH, S_PATH)
        assert geo["grid"] == (-(-S_PATH // pa.BLOCK_Q), 16, 8)
        assert geo["key_tiles"] == -(-S_PATH // pa.BLOCK_K)
        assert pa.STAGES >= 3 and pa.HEAD_DIM == 64


def _cpu_bhsd(b, h, s, d=64):
    return torch.zeros((b, h, s, d), dtype=torch.bfloat16)


class TestTensorMapOperands:
    """What a tensor map can describe is accepted without a copy; what it
    cannot describe raises in the wrapper's check."""

    def test_views_of_a_fused_projection(self):
        qkv = torch.zeros((2, 19, 3 * 4 * 64), dtype=torch.bfloat16)
        for name, t in zip("qkv", pa.split_heads(qkv, 4, 64)):
            assert not t.is_contiguous()
            got = pa.tma_operand_strides(name, t.shape, t.stride(),
                                         t.data_ptr())
            assert got == (19 * 768, 64, 768)

    def test_contiguous_and_bshd_storage(self):
        t = _cpu_bhsd(2, 3, 10)
        assert pa.tma_operand_strides("q", t.shape, t.stride(),
                                      t.data_ptr()) == (1920, 640, 64)
        u = torch.zeros((2, 10, 3, 64), dtype=torch.bfloat16
                        ).permute(0, 2, 1, 3)
        assert pa.tma_operand_strides("q", u.shape, u.stride(),
                                      u.data_ptr()) == (1920, 64, 192)

    def test_window_of_a_longer_buffer(self):
        t = _cpu_bhsd(2, 3, 50)[:, :, 8:18]
        assert pa.tma_operand_strides("k", t.shape, t.stride(),
                                      t.data_ptr()) == (9600, 3200, 64)

    def test_stride_of_a_size_one_dimension_is_ignored(self):
        t = _cpu_bhsd(1, 1, 10)
        got = pa.tma_operand_strides("q", t.shape, (7, 3, 64, 1),
                                     t.data_ptr())
        assert got == (64, 64, 64)

    @pytest.mark.parametrize("case", ["transposed", "row_stride", "offset",
                                      "broadcast", "head_dim", "rank"])
    def test_what_a_map_cannot_describe_raises(self, case):
        base = torch.zeros(1 << 16, dtype=torch.bfloat16)
        if case == "transposed":         # rows of D are not contiguous
            t = torch.zeros((1, 2, 64, 64), dtype=torch.bfloat16
                            ).transpose(2, 3)
        elif case == "row_stride":       # 68 elements: not 16-byte steps
            t = base.as_strided((1, 2, 10, 64), (8192, 2720, 68, 1))
        elif case == "offset":           # base 8 bytes off a 16-byte line
            t = base.as_strided((1, 2, 10, 64), (8192, 640, 64, 1), 4)
        elif case == "broadcast":        # a zero stride
            t = torch.zeros((1, 1, 10, 64), dtype=torch.bfloat16
                            ).expand(1, 4, 10, 64)
        elif case == "head_dim":
            t = torch.zeros((1, 2, 10, 32), dtype=torch.bfloat16)
        else:
            t = torch.zeros((2, 10, 64), dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            pa.tma_operand_strides("k", t.shape, t.stride(), t.data_ptr())
