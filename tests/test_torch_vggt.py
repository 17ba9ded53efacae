"""VGGT on the port (``txr_torch.models.vggt``), on the CPU at a small size,
against the plain float32 reference ``port_bench/reference/vggt.py`` on
seeded weights: depth, its confidence, the point map, its confidence and
the pose encoding; what each of VGGT's parts adds to the shared modules
(the RoPE tables' special tokens, DINOv2-reg's registers and antialiased
position-embedding resize, the tail's position term, the heads' kept
embeddings); the views attending to each other; the configuration at its
published widths on the meta device."""

import os
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from port_bench.lib import spec, weights
from port_bench.reference import vggt as ref
from txr_torch.models.vggt import VGGT, uv_pos_embed
from txr_torch.models.vit import ViTConfig, ViTEncoder, _resize_pos_embed
from txr_torch.ops.dpt_tail import (fused_head_tail, head_tail_reference,
                                    position_term)
from txr_torch.ops.qk_prep import rope_tables
from txr_torch.ops.resize import resize_bilinear
from txr_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
CFG = spec.load_json(spec.BENCH_DIR / "configs" / "vggt-1b.json")
ARCH = spec.architecture(CFG)
# width 64, 4 heads of 16, 2 front blocks, 2 frame / global pairs (the
# heads read pairs 0, 1, 1, 1), a camera trunk of 2 blocks 128 wide and 2
# iterations
TINY = dict(CFG, hidden_size=64, num_attention_heads=4, front_layers=2,
            aa_pairs=2, out_indices=[0, 1, 1, 1], features=16,
            out_channels=[8, 16, 32, 32], pos_embed_grid=4, camera_layers=2,
            camera_iterations=2)
VIEWS, H, W = 3, 28, 42              # a 2 x 3 patch grid a view
OUTPUTS = ("depth", "depth_confidence", "points", "points_confidence",
           "pose_encoding")

# float32 against float32, the same operations in another order (the
# fused qkv layout, the query blocks, the heads' NHWC memory, the tail's
# position term through conv2's linearity): at most about 1e-6 relative
# is seen; 1e-4 leaves two orders of rounding room, and the same model at
# bfloat16 misses it on every output by more than 50 times (68 to 880
# here; test_tolerance_is_missed_at_bfloat16).
RTOL, ATOL = 1e-4, 1e-5


def port_model(cfg, w, fused_head=None):
    m = VGGT(replace(ARCH.model_config(cfg), fused_head=fused_head))
    m.load_state_dict(w, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def tiny():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w = weights.make_weights(ARCH, TINY, 2 ** 31 + 24, "cpu",
                                 torch.float32)
        g = torch.Generator().manual_seed(24)
        x = torch.randn(VIEWS, H, W, 3, generator=g)
        with torch.no_grad():
            model = port_model(TINY, w)
            depth = model(x)
            want = ref.outputs(x.permute(0, 3, 1, 2), w, TINY)
    finally:
        torch.set_num_threads(threads)
    return w, x, depth, model.outputs, want


@pytest.mark.parametrize("name", OUTPUTS)
def test_outputs_match_the_reference_in_float32(tiny, name):
    _, _, _, got, want = tiny
    assert got[name].shape == want[name].shape
    assert got[name].dtype == torch.float32
    torch.testing.assert_close(got[name], want[name], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", OUTPUTS)
def test_tolerance_is_missed_at_bfloat16(tiny, name):
    """The comparison is tight enough that the reference computed in
    bfloat16 fails it, output by output."""
    w, x, _, _, want = tiny
    w16 = {k: v.to(torch.bfloat16) for k, v in w.items()}
    with torch.no_grad():
        got = ref.outputs(x.permute(0, 3, 1, 2).to(torch.bfloat16), w16,
                          TINY)[name].float()
    err = ((got - want[name]).abs() /
           (ATOL + RTOL * want[name].abs())).max()
    assert err > 10


def test_the_call_returns_depth_and_keeps_the_outputs(tiny):
    _, _, depth, got, _ = tiny
    assert torch.equal(depth, got["depth"])
    assert depth.shape == (VIEWS, H, W)
    assert got["points"].shape == (VIEWS, H, W, 3)
    assert got["pose_encoding"].shape == (VIEWS, 9)
    assert (got["depth_confidence"] > 1).all()
    assert (got["points_confidence"] > 1).all()
    assert (got["pose_encoding"][:, 7:] >= 0).all()       # field of view


def test_the_unfused_tails_agree(tiny):
    """``fused_head=False`` (upsample, embedding, conv2, ReLU, conv3 as
    separate ops) against the tail's route with the folded term."""
    w, x, _, got, _ = tiny
    model = port_model(TINY, w, fused_head=False)
    with torch.no_grad():
        model(x)
    for name in OUTPUTS:
        torch.testing.assert_close(model.outputs[name], got[name],
                                   rtol=RTOL, atol=ATOL)


def test_both_tails_take_the_tail_route_with_the_position_term(
        tiny, monkeypatch):
    import txr_torch.models.dpt as dpt_mod

    w, x, _, _, _ = tiny
    calls = []
    real = dpt_mod.fused_head_tail

    def counting(*args):
        calls.append((args[3].shape, None if args[8] is None
                      else tuple(args[8].shape)))
        return real(*args)

    monkeypatch.setattr(dpt_mod, "fused_head_tail", counting)
    with torch.no_grad():
        port_model(TINY, w)(x)
    hh = TINY["head_hidden"]
    assert calls == [((1, 1, hh, 2), (H, W, hh)),
                     ((1, 1, hh, 4), (H, W, hh))]


def test_views_attend_to_each_other(tiny):
    """Changing view 2 moves view 0's depth and pose, in the port and in
    the reference (the global blocks); view 0's camera and register tokens
    are the first of each learned pair, the other views' the second."""
    w, x, _, _, _ = tiny
    other = x.clone()
    other[2] = -other[2]
    model = port_model(TINY, w)
    with torch.no_grad():
        a = (model(x)[0], model.outputs["pose_encoding"][0])
        b = (model(other)[0], model.outputs["pose_encoding"][0])
        ra = ref.outputs(x.permute(0, 3, 1, 2), w, TINY)
        rb = ref.outputs(other.permute(0, 3, 1, 2), w, TINY)
    assert (a[0] - b[0]).abs().max() > 1e-3
    assert (a[1] - b[1]).abs().max() > 1e-4
    assert (ra["depth"][0] - rb["depth"][0]).abs().max() > 1e-3
    tok = model.aggregator._specials(3, torch.float32)
    assert torch.equal(tok[1], tok[2]) and not torch.equal(tok[0], tok[1])
    assert tok.shape == (3, 1 + TINY["num_registers"], TINY["hidden_size"])


def test_rope_tables_with_five_special_tokens():
    """The tables against the direct formula: the 5 special tokens at
    (0, 0), patch (r, c) at (r + 1, c + 1), rows on the first half of the
    head, columns on the second, frequencies 100^(-2j / 32) a half."""
    ph, pw, hd, base = 3, 4, 64, 100.0
    cos, sin = rope_tables(ph, pw, hd, base, "cpu", specials=5)
    assert cos.shape == sin.shape == (5 + ph * pw, 1, hd)
    half = hd // 2
    for n in range(5 + ph * pw):
        r, c = (0, 0) if n < 5 else divmod(n - 5, pw)
        r, c = (r + 1, c + 1) if n >= 5 else (0, 0)
        for j in range(hd):
            pos = r if j < half else c
            k = (j % half) % (half // 2)
            ang = torch.tensor(pos * base ** (-2.0 * k / half))
            assert cos[n, 0, j] == pytest.approx(float(ang.cos()), abs=1e-6)
            assert sin[n, 0, j] == pytest.approx(float(ang.sin()), abs=1e-6)
    one = rope_tables(ph, pw, hd, base, "cpu")
    assert torch.equal(one[0][0], cos[4]) and torch.equal(one[0][1:], cos[5:])


def test_rope_tables_match_the_reference_rotation():
    g = torch.Generator().manual_seed(7)
    x = torch.randn(2, 4, 5 + 6, 16, generator=g)           # (B, H, S, d)
    cos, sin = rope_tables(2, 3, 16, 100.0, "cpu", specials=5)
    from txr_torch.ops.qk_prep import apply_rope
    got = apply_rope(x.transpose(1, 2), cos, sin).transpose(1, 2)
    torch.testing.assert_close(got, ref.rope_2d(x, 2, 3, 5, 100.0),
                               rtol=1e-6, atol=1e-6)


def test_dinov2_reg_resize_is_antialiased_bicubic():
    """37 x 37 -> 21 x 37 as ``F.interpolate(..., bicubic, antialias)`` in
    float32, cls row first; it differs from the resize without
    antialiasing, which stays as it was."""
    g = torch.Generator().manual_seed(9)
    pos = torch.randn(1, 1 + 37 * 37, 16, generator=g)
    got = _resize_pos_embed(pos, 21, 37, antialias=True)
    grid = pos[:, 1:].reshape(1, 37, 37, 16).permute(0, 3, 1, 2)
    want = F.interpolate(grid, size=(21, 37), mode="bicubic",
                         align_corners=False, antialias=True)
    want = torch.cat([pos[:, :1], want.flatten(2).transpose(1, 2)], 1)
    assert torch.equal(got, want)
    plain = _resize_pos_embed(pos, 21, 37)
    assert (plain - got).abs().max() > 1e-2
    no_aa = F.interpolate(grid, size=(21, 37), mode="bicubic",
                          align_corners=False)
    assert torch.equal(plain[:, 1:], no_aa.flatten(2).transpose(1, 2))


def test_registers_follow_cls_and_leave_the_output():
    """DINOv2-reg: the registers sit after the cls token without position
    embedding, take part in attention, and are not in the output."""
    cfg = ViTConfig(hidden_size=32, num_layers=2, num_heads=2,
                    pos_embed_size=4, out_layers=(1,), num_registers=4,
                    pos_embed_antialias=True)
    torch.manual_seed(3)
    enc = ViTEncoder(cfg).eval()
    with torch.no_grad():
        for p in enc.parameters():
            p.normal_(0, 0.2)
    x = torch.randn(2, 28, 42, 3)
    with torch.no_grad():
        out = enc(x)[0]
        assert out.shape == (2, 1 + 6, 32)
        enc.register_tokens.copy_(torch.randn(1, 4, 32))
        moved = enc(x)[0]
    assert (out - moved).abs().max() > 1e-3
    assert enc.register_tokens.shape == (1, 4, 32)


def test_position_term_against_separate_ops():
    """The tail with the folded term (what the kernel computes) against
    the embedding added to the upsampled activation before conv2, as
    separate ops, in float64; and no term is the tail as before."""
    g = torch.Generator().manual_seed(11)
    f64 = torch.float64
    x = torch.randn(2, 6, 9, 16, generator=g, dtype=f64)
    w2 = torch.randn(3, 3, 16, 32, generator=g, dtype=f64) * 0.1
    b2 = torch.randn(32, generator=g, dtype=f64) * 0.1
    w3 = torch.randn(1, 1, 32, 3, generator=g, dtype=f64) * 0.2
    b3 = torch.randn(3, generator=g, dtype=f64)
    pe = uv_pos_embed(14, 21, 16, 21 / 14, f64, "cpu")       # (1, C, h, w)
    term = position_term(pe[0].permute(1, 2, 0), w2)
    assert term.shape == (14, 21, 32) and term.dtype == torch.float32
    term = position_term(pe[0].permute(1, 2, 0).double(), w2.double())
    got = head_tail_reference(x, w2, b2, w3, b3, 14, 21, term.double())
    up = resize_bilinear(x, 14, 21, align_corners=True)
    y = up.permute(0, 3, 1, 2) + pe
    y = F.relu(F.conv2d(y, w2.permute(3, 2, 0, 1), b2, padding=1))
    want = (F.conv2d(y, w3.reshape(32, 3).t()[..., None, None]) +
            b3[:, None, None]).permute(0, 2, 3, 1)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    # float32 rounding of the term alone
    got32 = fused_head_tail(x.float(), w2.float(), b2.float(), w3.float(),
                            b3.float(), 14, 21, None,
                            position_term(pe[0].permute(1, 2, 0).float(),
                                          w2.float()))
    torch.testing.assert_close(got32.double(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(
        head_tail_reference(x, w2, b2, w3, b3, 14, 21),
        head_tail_reference(x, w2, b2, w3, b3, 14, 21, None))


def test_uv_embedding_against_the_reference():
    got = uv_pos_embed(5, 7, 16, 7 / 5, torch.float32, "cpu")
    want = ref.uv_embed(5, 7, 16, 7 / 5, torch.float32, "cpu")
    assert got.shape == want.shape == (1, 16, 5, 7)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-7)
    # the first quarter turns with u along a row, the third with v down
    # a column; both grids are centred, so the sines sum to zero
    assert (got[0, 0, :, 1:] > got[0, 0, :, :-1]).all()
    assert (got[0, 8, 1:] > got[0, 8, :-1]).all()
    torch.testing.assert_close(got[0, 0].sum(dim=1), torch.zeros(5),
                               atol=1e-6, rtol=0)
    torch.testing.assert_close(got[0, 8].sum(dim=0), torch.zeros(7),
                               atol=1e-6, rtol=0)


def test_heads_keep_their_embeddings_per_grid(tiny):
    """Under a profiler each head looks up its four projections'
    embeddings, kept per grid and width (the two 32-wide stages share
    one), and its tail's term: 4 misses and 1 hit a head on the first
    forward, all 5 hits on the next, 4 misses again at another grid."""
    w, x, _, _, _ = tiny
    model = port_model(TINY, w)
    profiling.reset_counters()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]), torch.no_grad():
        model(x)
        first = profiling.counters()
        model(x)
        second = profiling.counters()
        model(torch.randn(VIEWS, 42, 28, 3))
        third = profiling.counters()
    profiling.reset_counters()
    assert first.get("models.head_pos_embed_misses") == 8
    assert first.get("models.head_pos_embed_hits") == 2
    assert second["models.head_pos_embed_misses"] == 8
    assert second["models.head_pos_embed_hits"] == 2 + 10
    assert third["models.head_pos_embed_misses"] == 8 + 8
    assert third["models.head_pos_embed_hits"] == 12 + 2
    assert len(model.depth_head._embeds) == 3 + 3


def test_the_position_term_takes_its_gradient():
    """Training through a VGGT head: conv2's weight gets the same gradient
    on the tail's route (the embedding through conv2 as the term, kept
    out of the cache) as from the separate ops; the tail op's gradient
    of the term itself passes ``gradcheck``."""
    from txr_torch.models.dpt import DPTConfig
    from txr_torch.models.vggt import VGGTHead

    torch.manual_seed(5)
    grads = []
    for fused in (None, False):
        cfg = DPTConfig(features=8, out_channels=(8, 8, 16, 16),
                        head_hidden=8, fused_head=fused, special_tokens=5,
                        relu_skip=True)
        torch.manual_seed(5)
        head = VGGTHead(cfg, 32, "points")
        torch.manual_seed(6)
        hs = [torch.randn(2, 5 + 6, 32) for _ in range(4)]
        out = head(hs, 2, 3)
        (out["points"].square().sum() + out["points_confidence"].sum()
         ).backward()
        grads.append(head.head_conv2.weight.grad)
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=1e-6)
    assert grads[0].abs().max() > 0
    g = torch.Generator().manual_seed(8)
    f64 = dict(dtype=torch.float64)
    x = torch.randn(1, 2, 3, 4, generator=g, **f64)
    w2 = torch.randn(3, 3, 4, 5, generator=g, **f64)
    b2, w3, b3 = (torch.randn(*s, generator=g, **f64)
                  for s in ((5,), (1, 1, 5, 2), (2,)))
    term = torch.randn(4, 5, 5, generator=g, **f64).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda t: fused_head_tail(x, w2, b2, w3, b3, 4, 5, None, t),
        (term,))


def test_vggt_1b_builds_at_published_widths_on_meta():
    with torch.device("meta"):
        model = VGGT(ARCH.model_config(CFG))
    cfg = model.cfg
    assert (cfg.hidden_size, cfg.num_heads, cfg.front_layers, cfg.pairs,
            cfg.num_registers) == (1024, 16, 24, 24, 4)
    assert model.front.register_tokens.shape == (1, 4, 1024)
    assert model.aggregator.camera_token.shape == (1, 2, 1, 1024)
    assert model.aggregator.register_token.shape == (1, 2, 4, 1024)
    agg = model.aggregator
    assert not agg.frame_0.attn.crossview and agg.global_0.attn.crossview
    assert agg.frame_5.attn.qk_prep.q_norm.eps == 1e-5
    assert model.front.block_0.norm1.eps == 1e-6
    assert agg.global_23.norm1.eps == 1e-5
    assert model.camera_head.block_0.attn.qkv.weight.shape == (6144, 2048)
    # heads of 128: the plain attention, chosen by configuration
    assert model.camera_head.block_0.attn.cfg.use_flash is False
    assert agg.global_0.attn.cfg.use_flash is not False
    assert model.depth_head.head_conv3.weight.shape == (2, 32, 1, 1)
    assert model.point_head.head_conv3.weight.shape == (4, 32, 1, 1)
    assert model.depth_head.norm.normalized_shape == (2048,)
    names = set(model.state_dict())
    assert names == {n for n, *_ in ARCH.leaves(CFG)}
    n = sum(p.numel() for p in model.parameters())
    assert 1.18e9 < n < 1.20e9
    assert len(ARCH.attention_modules(model)) == 72


def test_reference_imports_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, port_bench.reference.vggt\n"
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'txr', 'txr_torch', 'jax', 'jaxlib', 'flax'}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
