"""StreamVGGT on the port (``txr_torch.models.vggt.StreamVGGT``), on the CPU
at ViT-S widths (384 wide, 6 heads of 64; 2 front blocks, 2 frame / global
pairs) over 6 frames, against the plain float32 frame-causal reference
``port_bench/reference/streamvggt.py`` on seeded weights: depth, points,
both confidences and the pose encoding; chunks of 1, 2 and 3 frames and
frame-by-frame ``reset`` + ``step`` give the same; a cached run equals one
that recomputes every chunk from the stream's start; ``reset`` empties the
cache; the cached entry point's CPU route against ``attention_plain`` with
each query frame's keys as its key count."""

from dataclasses import fields

import pytest
import torch

from port_bench.lib import spec, weights
from port_bench.reference import streamvggt as ref
from txr_torch.models.vggt import StreamVGGT, StreamVGGTConfig
from txr_torch.ops.attention import (attention_cached_plain, attention_plain,
                                     cached_attention, cached_kernel_plan,
                                     key_limits, split_heads)

CFG = spec.load_json(spec.BENCH_DIR / "configs" / "streamvggt-1b.json")
ARCH = spec.architecture(CFG)
# ViT-S widths: 384 wide, 6 heads of 64; 2 front blocks and 2 pairs (the
# heads read pairs 0, 1, 1, 1); a camera trunk of 2 blocks 768 wide and 2
# iterations; a stream of up to 6 frames
SMALL = dict(CFG, hidden_size=384, num_attention_heads=6, front_layers=2,
             aa_pairs=2, out_indices=[0, 1, 1, 1], features=16,
             out_channels=[8, 16, 32, 32], pos_embed_grid=4,
             camera_layers=2, camera_iterations=2, stream_chunk_frames=2,
             cache_frames=6)
FRAMES, H, W = 6, 28, 42             # a 2 x 3 patch grid, 11 tokens a frame
OUTPUTS = ("depth", "depth_confidence", "points", "points_confidence",
           "pose_encoding")
# float32 against float32, the same operations in another order (the
# fused qkv, the cache's rows, the reference's frame blocks, the heads'
# NHWC memory, the tail's folded position term): about 1e-6 relative is
# seen; 1e-4 leaves two orders of rounding room, as tests/test_torch_vggt.py
RTOL, ATOL = 1e-4, 1e-5


def stream_model(w, chunk=2, cache=FRAMES):
    base = ARCH.model_config(SMALL)
    m = StreamVGGT(StreamVGGTConfig(
        **{f.name: getattr(base, f.name) for f in fields(base)
           if f.name not in ("stream_chunk_frames", "cache_frames")},
        stream_chunk_frames=chunk, cache_frames=cache))
    m.load_state_dict(w, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def small():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        w = weights.make_weights(ARCH, SMALL, 2 ** 31 + 26, "cpu",
                                 torch.float32)
        x = torch.randn(FRAMES, H, W, 3,
                        generator=torch.Generator().manual_seed(26))
        with torch.no_grad():
            model = stream_model(w)
            depth = model(x)
            want = ref.outputs(x.permute(0, 3, 1, 2), w, SMALL)
    finally:
        torch.set_num_threads(threads)
    return w, x, depth, model, want


@pytest.mark.parametrize("name", OUTPUTS)
def test_outputs_match_the_frame_causal_reference(small, name):
    _, _, _, model, want = small
    got = model.outputs[name]
    assert got.shape == want[name].shape and got.dtype == torch.float32
    torch.testing.assert_close(got, want[name], rtol=RTOL, atol=ATOL)


def test_the_call_returns_every_frames_depth(small):
    _, _, depth, model, _ = small
    assert depth.shape == (FRAMES, H, W)
    assert torch.equal(depth, model.outputs["depth"])
    assert model.state.frames == FRAMES
    assert model.outputs["pose_encoding"].shape == (FRAMES, 9)


@pytest.mark.parametrize("chunk", [1, 3, "steps"])
def test_chunks_and_steps_agree(small, chunk):
    """Chunks of 1 and 3 frames, and ``reset`` + ``step`` frame by frame
    as a live caller would, against the call in chunks of 2."""
    w, x, _, model, _ = small
    with torch.no_grad():
        if chunk == "steps":
            other = stream_model(w)
            other.reset()
            parts = []
            for i in range(FRAMES):
                depth = other.step(x[i:i + 1])
                assert torch.equal(depth, other.outputs["depth"])
                parts.append(other.outputs)
            got = {k: torch.cat([p[k] for p in parts]) for k in OUTPUTS}
        else:
            other = stream_model(w, chunk=chunk)
            other(x)
            got = other.outputs
    for name in OUTPUTS:
        torch.testing.assert_close(got[name], model.outputs[name],
                                   rtol=RTOL, atol=ATOL)


def test_a_cached_run_equals_recomputing_from_the_start(small):
    """Each chunk of the cached run against a fresh stream that takes the
    frames from the start up to the chunk's end as one chunk, without a
    cache to read."""
    w, x, _, model, _ = small
    with torch.no_grad():
        for end in (2, 4, 6):
            whole = stream_model(w, chunk=end)
            whole(x[:end])
            for name in OUTPUTS:
                torch.testing.assert_close(
                    whole.outputs[name][end - 2:end],
                    model.outputs[name][end - 2:end], rtol=RTOL, atol=ATOL)


def test_reset_empties_the_cache(small):
    """After a stream, ``reset`` and one more chunk give that chunk what a
    fresh model gives it: frame 0 again, view 0's tokens, no earlier keys;
    the slabs stay allocated. Past the capacity a step raises."""
    w, x, _, _, _ = small
    model = stream_model(w)
    with torch.no_grad():
        model(x)
        slabs = [s.data_ptr() for s in model.state.slabs]
        with pytest.raises(ValueError, match="reset"):
            model.step(x[:1])
        model.reset()
        assert model.state.frames == 0
        again = model.step(x[3:5])
        fresh = stream_model(w).step(x[3:5])
    assert [s.data_ptr() for s in model.state.slabs] == slabs
    assert torch.equal(again, fresh)
    assert model.state.frames == 2


def test_a_frame_sees_only_earlier_frames(small):
    """Changing the last frame moves no earlier frame's depth or pose;
    changing the first moves the last frame's; later frames take the
    second set of learned tokens."""
    w, x, _, _, _ = small
    other = x.clone()
    other[-1] = -other[-1]
    first = x.clone()
    first[0] = -first[0]
    m = stream_model(w)
    with torch.no_grad():
        m(x)
        base = dict(m.outputs)
        m(other)
        late = dict(m.outputs)
        m(first)
        early = dict(m.outputs)
    for name in ("depth", "pose_encoding"):
        assert torch.equal(late[name][:-1], base[name][:-1])
        assert (early[name][-1] - base[name][-1]).abs().max() > 1e-4
    agg = m.aggregator
    later = agg._specials(2, torch.float32, first=False)
    start = agg._specials(2, torch.float32)
    assert torch.equal(later[0], start[1]) and torch.equal(later[1],
                                                           start[1])
    assert not torch.equal(start[0], start[1])


@pytest.mark.parametrize("s,cached,frame", [
    (33, 0, 11), (33, 22, 11), (12, 0, 1), (10, 7, 5), (9, 130, 3)])
def test_cached_route_is_attention_plain_per_frame(s, cached, frame):
    """The CPU route of the cached entry point against ``attention_plain``
    of each query frame with the keys up to its end as its key count, on
    bf16 operands (the kernel's): the cache's rows before ``cached``, then
    the chunk's k and v; rows past them are never read."""
    g = torch.Generator().manual_seed(s + cached)
    heads, d = 2, 64
    qkv = torch.randn(1, s, 3 * heads * d, generator=g).to(torch.bfloat16)
    kv = torch.randn(cached + s + 5, 2 * heads * d,
                     generator=g).to(torch.bfloat16)
    kv[cached:cached + s] = qkv[0, :, heads * d:]
    got = cached_attention(qkv, kv, heads, d, cached, frame)
    q, k, v = split_heads(qkv, heads, d)
    keys = split_heads(torch.cat([torch.zeros(1, cached + s, heads * d,
                                              dtype=kv.dtype),
                                  kv[None, :cached + s]], -1), heads, d)
    want = torch.empty_like(q)
    for f0 in range(0, s, frame):
        end = min(s, f0 + frame)
        want[:, :, f0:end] = attention_plain(q[:, :, f0:end], keys[1],
                                             keys[2], cached + end)
    assert torch.equal(got, want.transpose(1, 2).reshape(1, s, heads * d))
    junk = kv.clone()
    junk[cached + s:] = 2.0 ** 100
    assert torch.equal(cached_attention(qkv, junk, heads, d, cached, frame),
                       got)


def test_frame_causal_with_frames_of_one_token_is_causal():
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(1, 2, 7, 16, generator=g) for _ in range(3))
    mask = torch.ones(7, 7, dtype=torch.bool).tril()
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v, mask)
    torch.testing.assert_close(attention_cached_plain(q, k, v, 0, 1), want,
                               rtol=1e-5, atol=1e-6)


def test_key_limits_and_the_kernels_plan():
    """The limits by hand, and the tiles the kernel streams at the cell's
    last chunk: every pair the mask keeps lies in a block's tiles, and the
    tiles hold under 1 % more pairs than the mask keeps."""
    assert key_limits(7, 10, 3, 17).tolist() == [13, 13, 13, 16, 16, 16,
                                                  17]
    assert key_limits(4, 0, 2, 3).tolist() == [2, 2, 3, 3]
    s, p = 32 * 782, 782
    plan = cached_kernel_plan(s, 4 * s, 3 * s, p)
    assert len(plan["blocks"]) == -(-s // 192)
    assert plan["pairs"] == s * 3 * s + p * p * 32 * 33 // 2
    assert plan["pairs"] <= plan["tile_pairs"] < 1.01 * plan["pairs"]
    for blk in plan["blocks"]:
        last = min(blk["q0"] + 192, s) - 1
        assert blk["key_tiles"] * 128 >= 3 * s + (last // p + 1) * p
        assert blk["first_masked"] * 128 <= 3 * s + (blk["q0"] // p + 1) * p
