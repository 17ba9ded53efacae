"""The encoder's resized position embedding, kept per parameter state and
patch grid (``txr_torch/models/vit.py:interpolate_pos_embed`` through
``txr_torch/core/derived.py:Derived``), on the CPU with a tiny encoder.

A second forward at the same grid reuses the resize and gives the same
bits as the uncached resize; an in-place update, a weight load or a new
grid resizes again; the native grid never reaches the cache; a call
through which autograd can reach ``pos_embed`` resizes anew and gives the
uncached gradient.
"""

import copy

import pytest
import torch

from txr_torch.core import derived
from txr_torch.models.vit import ViTConfig, ViTEncoder, _resize_pos_embed
from txr_torch.utils import profiling

GRID = 4                        # the stored embedding's grid
PH, PW = 6, 10                  # the frames' grid
CFG = ViTConfig(hidden_size=32, num_layers=2, num_heads=2,
                pos_embed_size=GRID, out_layers=(0, 1))
HITS, MISSES = "models.pos_embed_hits", "models.pos_embed_misses"


def encoder(seed=0):
    torch.manual_seed(seed)
    enc = ViTEncoder(CFG).eval()
    with torch.no_grad():
        enc.pos_embed.normal_(0.0, 0.02)
    return enc


def pixels(ph=PH, pw=PW, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(2, ph * 14, pw * 14, 3, generator=g)


def profiled(fn):
    """``fn()`` under a CPU profiler, with the counters it kept."""
    profiling.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        out = fn()
    got = profiling.counters()
    profiling.reset_counters()
    return out, {k: got[k] for k in (HITS, MISSES) if k in got}


def uncached(enc, ph=PH, pw=PW):
    return _resize_pos_embed(enc.pos_embed.detach(), ph, pw)


def test_second_forward_reuses_the_resize_bit_for_bit():
    enc, x = encoder(), pixels()
    with torch.no_grad():
        outs, counts = profiled(lambda: [enc(x), enc(x)])
    assert counts == {MISSES: 1, HITS: 1}
    # the same forward with autograd reaching pos_embed takes the
    # uncached resize
    want = [h.detach() for h in enc(x)]
    for out in outs:
        assert all(torch.equal(a, b) for a, b in zip(out, want))
    with torch.no_grad():
        assert torch.equal(enc.interpolate_pos_embed(PH, PW), uncached(enc))


def test_resize_keeps_the_cls_row_and_resizes_the_patch_rows():
    enc = encoder()
    pos = uncached(enc)
    assert pos.shape == (1, 1 + PH * PW, CFG.hidden_size)
    assert torch.equal(pos[:, 0], enc.pos_embed.detach()[:, 0])
    # at its own grid the bicubic resize is the identity
    assert torch.allclose(uncached(enc, GRID, GRID), enc.pos_embed.detach(),
                          atol=1e-7)


@pytest.mark.parametrize("change", ["add_", "load_state_dict", "to"])
def test_a_new_parameter_state_resizes_again(change):
    enc, x = encoder(), pixels()
    with torch.no_grad():
        before = enc.interpolate_pos_embed(PH, PW).clone()
        if change == "add_":
            enc.pos_embed.add_(0.5)
        elif change == "load_state_dict":
            enc.load_state_dict(encoder(seed=7).state_dict())
        else:
            enc.to(torch.float64)
            x = x.to(torch.float64)
        (_, got), counts = profiled(lambda: (enc(x),
                                             enc.interpolate_pos_embed(PH,
                                                                       PW)))
    assert counts == {MISSES: 1, HITS: 1}
    assert torch.equal(got, uncached(enc))
    if change == "to":
        assert got.dtype == torch.float64
    else:
        assert not torch.equal(got, before)


def test_a_new_grid_resizes_again_and_keeps_only_the_latest():
    enc = encoder()
    grids = [(PH, PW), (5, 7), (5, 7), (PH, PW)]
    with torch.no_grad():
        got, counts = profiled(lambda: [enc.interpolate_pos_embed(*g)
                                        for g in grids])
    assert counts == {MISSES: 3, HITS: 1}
    for g, pos in zip(grids, got):
        assert torch.equal(pos, uncached(enc, *g))
    assert got[1] is got[2] and got[0] is not got[3]


def test_the_native_grid_never_touches_the_cache():
    enc = encoder()
    with torch.no_grad():
        (pos, _), counts = profiled(lambda: (
            enc.interpolate_pos_embed(GRID, GRID), enc(pixels(GRID, GRID))))
    assert pos is enc.pos_embed
    assert counts == {} and enc._pos_resized._key is None


@pytest.mark.parametrize("warm", [False, True])
def test_gradient_to_pos_embed_is_the_uncached_ones(warm):
    enc, x = encoder(), pixels()
    ref = copy.deepcopy(enc)
    if warm:                     # a filled cache must not cut the graph
        with torch.no_grad():
            enc(x)
    _, counts = profiled(lambda: sum(h.square().sum()
                                     for h in enc(x)).backward())
    assert counts == {}
    # the reference: the same forward spelled out with the uncached resize
    b = x.shape[0]
    tok = ref.patch_embed(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)
    h = torch.cat([ref.cls_token.expand(b, -1, -1), tok], 1) + \
        _resize_pos_embed(ref.pos_embed, PH, PW)
    loss = 0
    for i in range(CFG.num_layers):
        h = getattr(ref, f"block_{i}")(h)
        loss = loss + ref.norm(h).square().sum()
    loss.backward()
    assert enc.pos_embed.grad.abs().sum() > 0
    torch.testing.assert_close(enc.pos_embed.grad, ref.pos_embed.grad,
                               rtol=1e-5, atol=1e-7)


def test_a_frozen_pos_embed_under_grad_takes_the_cache():
    enc, x = encoder(), pixels()
    enc.pos_embed.requires_grad_(False)
    _, counts = profiled(lambda: [enc(x), enc(x)])
    assert counts == {MISSES: 1, HITS: 1}


def test_a_value_a_graph_captured_outlives_the_next_grid(monkeypatch):
    enc = encoder()
    with torch.no_grad():
        monkeypatch.setattr(derived, "_capturing", lambda: True)
        captured = enc.interpolate_pos_embed(PH, PW)
        enc.interpolate_pos_embed(PH, PW)
        monkeypatch.setattr(derived, "_capturing", lambda: False)
        other = enc.interpolate_pos_embed(5, 7)
    held = enc._pos_resized._captured
    assert len(held) == 1 and held[0] is captured
    assert enc._pos_resized._value is other
