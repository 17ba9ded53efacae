"""Depth Anything 3 any-view on the port (``txr_torch``), on the CPU at a
small size, against the plain float32 reference
``port_bench/reference/depth_anything_3.py`` on seeded weights: depth,
confidence and rays; one view's depth moving with another's only through
cross-view attention; QK-norm and RoPE alone; the registry entry at its
published widths; and Depth Anything V2's forward, which the any-view
fields leave byte for byte as it was."""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from port_bench.lib import spec, weights
from port_bench.reference import depth_anything_3 as ref
from txr_torch.models.depth_anything import (DepthAnything,
                                             DepthAnythingModel,
                                             build_model)
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import QKPrep, ViTConfig
from txr_torch.ops.qk_prep import apply_rope, rope_tables
from txr_torch.ops import attention

ROOT = Path(__file__).resolve().parents[1]
DA3L = spec.load_json(spec.BENCH_DIR / "configs" / "da3-large-anyview.json")
ARCH = spec.architecture(DA3L)
# width 64, 4 heads of 16, 8 layers: alternation, QK-norm and RoPE from
# layer 2 (cross-view layers 3, 5, 7), taken layers 3, 5, 6, 7
TINY = dict(DA3L, hidden_size=64, num_attention_heads=4,
            num_hidden_layers=8, alt_start=2, qknorm_start=2, rope_start=2,
            out_indices=[3, 5, 6, 7], features=16, out_channels=[8, 16, 32, 32],
            pos_embed_grid=4)
VIEWS, H, W = 3, 28, 42              # a 2 x 3 patch grid a view

# float32 against float32, the same operations in another order (the
# fused qkv layout, the query blocks, the head's NHWC memory): about 1e-6
# relative is seen; 1e-4 leaves two orders of rounding room, and the same
# model at bfloat16 misses it over a hundredfold (about 370 times here;
# test_tolerance_is_missed_by_the_model_at_bfloat16).
RTOL, ATOL = 1e-4, 1e-5


def port_model(cfg, w, fused_head=None):
    vit = ARCH.vit_config(cfg)
    dpt = DPTConfig(features=cfg["features"],
                    out_channels=tuple(cfg["out_channels"]),
                    head_hidden=cfg["head_hidden"], dual=True,
                    fused_head=fused_head)
    m = DepthAnything(vit, dpt)
    m.load_state_dict(w, strict=True)
    return m.eval()


@pytest.fixture(scope="module")
def tiny():
    w = weights.make_weights(ARCH, TINY, 2 ** 31 + 20, "cpu", torch.float32)
    g = torch.Generator().manual_seed(20)
    x = torch.randn(VIEWS, H, W, 3, generator=g)
    with torch.no_grad():
        model = port_model(TINY, w)
        model(x)
        want = ref.outputs(x.permute(0, 3, 1, 2), w, TINY)
    return w, x, model.outputs, want


@pytest.mark.parametrize("name", ["depth", "confidence", "rays",
                                  "ray_confidence"])
def test_outputs_match_the_reference_in_float32(tiny, name):
    _, _, got, want = tiny
    assert got[name].shape == want[name].shape
    assert got[name].dtype == torch.float32
    torch.testing.assert_close(got[name], want[name], rtol=RTOL, atol=ATOL)


def test_the_call_returns_the_depth_branch(tiny):
    w, x, got, _ = tiny
    with torch.no_grad():
        depth = port_model(TINY, w)(x)
    assert torch.equal(depth, got["depth"])
    assert depth.shape == (VIEWS, H, W)
    assert got["rays"].shape == (VIEWS, H, W, 6)
    assert (got["confidence"] > 1).all() and (got["ray_confidence"] > 1).all()


def test_both_tails_take_the_tail_route(tiny, monkeypatch):
    """Both branches' tails go through ``fused_head_tail`` (2 and 7
    outputs), with each branch's own packed operands, and agree with the
    unfused route (``fused_head=False``) to float32 rounding."""
    import txr_torch.models.dpt as dpt_mod
    from txr_torch.ops.dpt_tail import pack_params

    w, x, got, _ = tiny
    calls = []
    real = dpt_mod.fused_head_tail

    def counting(*args):
        calls.append(args[3].shape)
        return real(*args)

    monkeypatch.setattr(dpt_mod, "fused_head_tail", counting)
    with torch.no_grad():
        port_model(TINY, w)(x)
    hh = TINY["head_hidden"]
    assert calls == [(1, 1, hh, 2), (1, 1, hh, 7)]
    head = port_model(TINY, w).head
    for prefix in ("head_conv", "ray_conv"):
        c2, c3 = (getattr(head, f"{prefix}{i}") for i in (2, 3))
        want = pack_params(c2.weight.detach().permute(2, 3, 1, 0),
                           c2.bias.detach(),
                           c3.weight.detach().permute(2, 3, 1, 0),
                           c3.bias.detach())
        for a, b in zip(head.tail_operands(prefix), want):
            assert torch.equal(a, b)
    unfused = port_model(TINY, w, fused_head=False)
    with torch.no_grad():
        unfused(x)
    for name, t in got.items():
        torch.testing.assert_close(t, unfused.outputs[name], rtol=RTOL,
                                   atol=ATOL)


def test_tolerance_is_missed_by_the_model_at_bfloat16(tiny):
    """The comparison is tight enough that a lower precision than the
    configuration's float32 fails it."""
    w, x, _, want = tiny
    w16 = {k: v.to(torch.bfloat16) for k, v in w.items()}
    with torch.no_grad():
        d16 = ref.outputs(x.permute(0, 3, 1, 2).to(torch.bfloat16), w16,
                          TINY)["depth"].float()
    err = ((d16 - want["depth"]).abs() /
           (ATOL + RTOL * want["depth"].abs())).max()
    assert err > 100


def _view0_moves(model_fn, x):
    other = x.clone()
    other[2] = -other[2]
    with torch.no_grad():
        return model_fn(x)[0], model_fn(other)[0]


@pytest.mark.parametrize("alternate", [True, False])
def test_another_view_moves_view_0_only_through_crossview(tiny, alternate):
    """Changing view 2 changes view 0's depth, in the port and in the
    reference; with the alternation off (every layer within its view, the
    QK-norm, RoPE, camera token and joined features kept) it leaves view
    0's depth exactly as it was."""
    w, x, _, _ = tiny
    cfg = TINY if alternate else dict(TINY, alt_start=-1)
    model = port_model(TINY, w)
    if not alternate:
        for i in range(TINY["num_hidden_layers"]):
            getattr(model.encoder, f"block_{i}").attn.crossview = False

    def reference(v):
        return ref.outputs(v.permute(0, 3, 1, 2), w, cfg)["depth"]

    for fn in (model, reference):
        a, b = _view0_moves(fn, x)
        if alternate:
            assert (a - b).abs().max() > 1e-3
        else:
            assert torch.equal(a, b)


def test_qk_prep_alone_matches_the_reference():
    heads, hd, ph, pw = 4, 16, 3, 5
    s = 1 + ph * pw
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, s, 3 * heads * hd, generator=g)
    prep = QKPrep(hd)
    w = {}
    with torch.no_grad():
        for name, p in prep.named_parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3 + 1.0)
            w[name] = p.clone()
        got = prep(qkv, heads, rope_tables(ph, pw, hd, 100.0, "cpu"))
    q, k, v = qkv.reshape(2, s, 3, heads, hd).permute(2, 0, 3, 1, 4)
    want = []
    for t, n in ((q, "q_norm"), (k, "k_norm")):
        t = ref._ln(t, w, n)
        want.append(ref.rope_2d(t, ph, pw, 100.0))
    want = torch.stack(want + [v], dim=2)            # (B, H, 3, S, hd)
    want = want.permute(0, 3, 2, 1, 4).reshape(2, s, -1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    # v passes through untouched
    assert torch.equal(got.view(2, s, 3, -1)[:, :, 2],
                       qkv.view(2, s, 3, -1)[:, :, 2])


def test_rope_at_position_0_is_the_identity():
    g = torch.Generator().manual_seed(4)
    x = torch.randn(2, 7, 4, 16, generator=g)          # (B, S, H, D)
    cos, sin = rope_tables(2, 3, 16, 100.0, "cpu")
    y = apply_rope(x, cos, sin)
    assert torch.equal(cos[0], torch.ones_like(cos[0]))
    assert torch.equal(sin[0], torch.zeros_like(sin[0]))
    assert torch.equal(y[:, 0], x[:, 0])
    assert not torch.allclose(y[:, 1:], x[:, 1:])
    xr = x.permute(0, 2, 1, 3)                          # (B, H, S, D)
    assert torch.equal(ref.rope_2d(xr, 2, 3, 100.0)[:, :, 0], xr[:, :, 0])
    # a rotation keeps each half's norm
    torch.testing.assert_close(y.norm(dim=-1), x.norm(dim=-1))


def test_reference_imports_nothing_of_the_program():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, port_bench.reference.depth_anything_3\n"
         "print(sorted({m.split('.')[0] for m in sys.modules} & "
         "{'txr', 'txr_torch', 'jax', 'jaxlib', 'flax'}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_large_anyview_builds_at_published_widths_on_meta():
    model, vit, dpt = build_model("v3", "large-anyview", device="meta")
    assert (vit.hidden_size, vit.num_layers, vit.num_heads,
            vit.mlp_ratio) == (1024, 24, 16, 4.0)
    assert vit.anyview_start == 8
    assert vit.out_layers == (11, 15, 19, 23)
    assert dpt.dual
    enc = model.encoder
    assert enc.camera_token.shape == (1, 2, 1024)
    assert [i for i in range(24) if enc.cfg.crossview(i)] == \
        [9, 11, 13, 15, 17, 19, 21, 23]
    assert [i for i in range(24)
            if getattr(enc, f"block_{i}").attn.qk_prep is not None] == \
        list(range(8, 24))
    assert enc.block_8.attn.qk_prep.q_norm.weight.shape == (64,)
    assert model.head.project_0.weight.shape == (256, 2048, 1, 1)
    assert model.head.head_conv3.weight.shape == (2, 32, 1, 1)
    assert model.head.ray_conv3.weight.shape == (7, 32, 1, 1)
    names = set(model.state_dict())
    assert names == {n for n, *_ in ARCH.leaves(DA3L)}
    n = sum(p.numel() for p in model.parameters())
    assert 0.33e9 < n < 0.36e9
    wrapped = DepthAnythingModel(version="v3", encoder="large-anyview",
                                 device="meta")
    assert wrapped.dpt_cfg.dual and wrapped.vit_cfg == vit


def test_crossview_attention_plan():
    """A cross-view call of the 16-view cell is one sequence of 39,088
    tokens: 204 query blocks x 16 heads fill the 132 multiprocessors."""
    s = 16 * 2443
    geo = attention.kernel_geometry(1, 16, s, s)
    assert geo["grid"] == (204, 16, 1)
    assert geo["key_tiles"] == 306 and geo["smem_bytes"] <= 232448


# Taken at the commit before the any-view fields: the bytes of a tiny
# Depth Anything V2 forward on the CPU in one thread (metric head through
# the tail's plain version, in float32 and bfloat16; the relative head
# through the unfused tail).
DA2_SHA256 = {
    (torch.float32, True, None):
        "1cdcec071f16cf55a9040d05e36726c3c26de1d8e973592ae583554ad1532875",
    (torch.bfloat16, True, None):
        "c0a68ad1119a7da8d0d9cc733e476574c43558e6973a9d31fd6f4b1394a6a0bd",
    (torch.float32, False, False):
        "2b788fdf0974aca3198bd466156d454c35b7dffbca4c68323a36d01be4bfeb8d",
}


@pytest.mark.parametrize("dtype,metric,fused_head", list(DA2_SHA256))
def test_da2_forward_is_byte_for_byte_as_before(dtype, metric, fused_head):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        vit = ViTConfig(hidden_size=64, num_layers=3, num_heads=4,
                        pos_embed_size=4, out_layers=(0, 1, 2, 2))
        dpt = DPTConfig(features=16, out_channels=(8, 16, 32, 32),
                        head_hidden=8, metric=metric, fused_head=fused_head)
        m = DepthAnything(vit, dpt)
        g = torch.Generator().manual_seed(20)
        sd = {}
        for name, p in sorted(m.state_dict().items()):
            std = p[0].numel() ** -0.5 if p.dim() > 1 else 0.1
            sd[name] = torch.randn(p.shape, generator=g) * std
        m.load_state_dict(sd)
        m = m.to(dtype).eval()
        x = torch.randn(2, 42, 70, 3, generator=g).to(dtype)
        with torch.no_grad():
            d = m(x)
    finally:
        torch.set_num_threads(threads)
    assert d.shape == (2, 42, 70)
    got = hashlib.sha256(
        d.contiguous().view(torch.uint8).numpy().tobytes()).hexdigest()
    assert got == DA2_SHA256[(dtype, metric, fused_head)]


# Taken at the commit before VGGT's fields (registers, the antialiased
# resize, LayerNorm eps per configuration, the special tokens' count in
# the RoPE tables, the tail's position term): the bytes of the tiny
# any-view model's four outputs on the CPU in one thread, through the
# tail's plain version in float32 and bfloat16 and the unfused tail.
DA3_SHA256 = {
    (torch.float32, None):
        "4dbe5f34e29e06baaa0ff061c0b08fdfcd7300a90b6dda0c743557e49cbfc9dd",
    (torch.bfloat16, None):
        "d2e24696f52aa44100c93604023ad2e183b46a240da039c101bc6b23f7f394c1",
    (torch.float32, False):
        "4dbe5f34e29e06baaa0ff061c0b08fdfcd7300a90b6dda0c743557e49cbfc9dd",
}


@pytest.mark.parametrize("dtype,fused_head", list(DA3_SHA256))
def test_da3_forward_is_byte_for_byte_as_before(dtype, fused_head):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        w = weights.make_weights(ARCH, TINY, 2 ** 31 + 20, "cpu",
                                 torch.float32)
        x = torch.randn(VIEWS, H, W, 3,
                        generator=torch.Generator().manual_seed(20))
        m = port_model(TINY, w, fused_head=fused_head).to(dtype)
        with torch.no_grad():
            m(x.to(dtype))
    finally:
        torch.set_num_threads(threads)
    h = hashlib.sha256()
    for k in ("depth", "confidence", "rays", "ray_confidence"):
        h.update(m.outputs[k].contiguous().view(torch.uint8).numpy()
                 .tobytes())
    assert h.hexdigest() == DA3_SHA256[(dtype, fused_head)]
