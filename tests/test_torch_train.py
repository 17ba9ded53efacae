"""Parity of the port's fine-tuning (``txr_torch/train.py``) with
``txr/train.py`` on the CPU, at ``tests/test_parallel.py:tiny_pair``'s size.

Inputs come from a numpy seed, and ``txr``'s weights are carried across
with ``from_txr_params``. The port runs with ``device="cpu"``, so in f32
with the plain versions of its kernels. The head's last bias is raised by
1 on both sides, so the prediction starts positive: at ``txr``'s zero bias
most pixels sit at ReLU's zero, where the loss takes ``log(1e-6)`` and its
gradient rests on a few pixels near zero.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import txr.train as txr_train
from txr.models.depth_anything import DepthAnythingFlax
from txr.models.dpt import DPTConfig as TxrDPTConfig
from txr.models.vit import ViTConfig as TxrViTConfig

import txr_torch.train as train
from txr_torch.models.convert import from_txr_params
from txr_torch.models.depth_anything import DepthAnything
from txr_torch.models.dpt import DPTConfig
from txr_torch.models.vit import ViTConfig
from txr_torch.ops.dpt_tail import pack_params

torch.set_num_threads(1)

LR = 1e-3
# f32 on both sides; sums run in another order in the two frameworks
LOSS_RTOL = 1e-5
# a parameter's gradient: 1e-4 of each value plus 1e-5 of the parameter's
# largest gradient (measured: 6e-6 of the largest with txr's kernels on)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5
# the parameters after three steps, in units of lr. Plain: f32 round-off
# only (measured 0.07 lr). txr's kernels on: its forward rounds otherwise
# than the port's plain versions, and Adam turns a gradient near zero
# whose sign that flips into a step of up to 2 lr; of the three steps
# only two have a non-zero rate, and no parameter may be off by more than
# one flip (measured 0.89 lr)
PARAM_ATOL_LR = {False: 0.25, True: 2.0}
# the loss after the third update (one more forward on both sides). Plain:
# LOSS_RTOL (measured 2.2e-6). txr's kernels on: the flips above move it
# (measured 4.3e-5). The update itself moves it 5.4e-2, and must move it
# by 20 times the bound, so a skipped or halved update fails
AFTER_RTOL = {False: LOSS_RTOL, True: 2.5e-4}


def txr_tiny(flash: bool):
    vit = TxrViTConfig(hidden_size=64, num_layers=2, num_heads=4,
                       pos_embed_size=4, out_layers=(0, 0, 1, 1),
                       use_flash=flash)
    dpt = TxrDPTConfig(features=32, out_channels=(16, 16, 32, 32),
                       head_hidden=16, fused_head=True if flash else None)
    return DepthAnythingFlax(vit=vit, dpt=dpt)


def port_tiny() -> DepthAnything:
    return DepthAnything(
        ViTConfig(hidden_size=64, num_layers=2, num_heads=4,
                  pos_embed_size=4, out_layers=(0, 0, 1, 1)),
        DPTConfig(features=32, out_channels=(16, 16, 32, 32),
                  head_hidden=16))


@pytest.fixture(scope="module")
def weights():
    params = txr_tiny(False).init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 56, 56, 3)))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    params["head"]["head_conv3"]["bias"] = (
        params["head"]["head_conv3"]["bias"] + np.float32(1.0))
    return params


def batch(b=2, seed=0, float_mask=False):
    rng = np.random.default_rng(seed)
    img = rng.normal(size=(b, 56, 56, 3)).astype(np.float32)
    tgt = rng.uniform(0.5, 3.0, (b, 56, 56)).astype(np.float32)
    valid = rng.uniform(size=(b, 56, 56)) < 0.9
    if float_mask:
        mask = np.where(valid, rng.uniform(0.25, 1.0, valid.shape),
                        0.0).astype(np.float32)
    else:
        mask = valid
    return img, tgt, mask


def port_model(params) -> DepthAnything:
    m = port_tiny()
    m.load_state_dict(from_txr_params(params))
    return m


def as_port(params) -> dict:
    return {k: v.numpy() for k, v in from_txr_params(
        jax.tree_util.tree_map(np.asarray, params)).items()}


class TestLosses:
    @pytest.mark.parametrize("float_mask", [False, True],
                             ids=["bool_mask", "float_mask"])
    def test_losses_equal_txr(self, float_mask):
        rng = np.random.default_rng(3)
        pred = rng.uniform(0.0, 4.0, (2, 20, 24)).astype(np.float32)
        pred[0, :3] = 0.0                   # at the clamp
        _, tgt, mask = batch(2, 1, float_mask)
        tgt, mask = tgt[:, :20, :24], mask[:, :20, :24]
        for ours, theirs in ((train.silog_loss, txr_train.silog_loss),
                             (train.gradient_matching_loss,
                              txr_train.gradient_matching_loss)):
            got = ours(torch.from_numpy(pred), torch.from_numpy(tgt),
                       torch.from_numpy(mask)).item()
            want = float(theirs(jnp.asarray(pred), jnp.asarray(tgt),
                                jnp.asarray(mask)))
            assert got == pytest.approx(want, rel=LOSS_RTOL), ours.__name__

    def test_silog_zero_for_exact_and_empty_mask(self):
        pred = torch.full((1, 8, 8), 3.0)
        assert train.silog_loss(pred, pred, torch.ones(1, 8, 8, dtype=bool)
                                ).item() == pytest.approx(0.0, abs=1e-7)
        # no valid pixel: the counts clamp to 1, the loss is 0, not NaN
        none = torch.zeros(1, 8, 8, dtype=bool)
        assert train.silog_loss(pred * 2, pred, none).item() == 0.0
        assert train.gradient_matching_loss(pred * 2, pred, none).item() == 0.0


class TestOptimizer:
    @pytest.mark.parametrize("warmup,total", [(1, 100), (10, 50), (0, 20),
                                              (30, 5)])
    def test_schedule_equals_optax(self, warmup, total):
        opt = train.make_optimizer(lr=3e-4, warmup_steps=warmup,
                                   total_steps=total)
        want = optax.warmup_cosine_decay_schedule(
            0.0, 3e-4, warmup, max(total, warmup + 1))
        adam, sched = opt.init([torch.nn.Parameter(torch.zeros(1))])
        # optax evaluates the schedule in f32, the port in float64
        tol = dict(rel=1e-6, abs=1e-7 * 3e-4)
        for step in range(max(total, warmup + 1) + 3):
            w = float(want(step))
            assert opt.learning_rate(step) == pytest.approx(w, **tol)
            # what AdamW is handed at this step
            assert adam.param_groups[0]["lr"] == pytest.approx(w, **tol)
            adam.step()
            sched.step()
        if warmup:
            assert opt.learning_rate(0) == 0.0

    @pytest.mark.parametrize("scale", [0.01, 0.999, 1.0, 7.5])
    def test_clip_equals_optax(self, scale):
        rng = np.random.default_rng(5)
        grads = [rng.normal(size=s).astype(np.float32)
                 for s in ((3, 4), (7,), (2, 2, 5))]
        norm = math.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                             for g in grads))
        grads = [g * np.float32(scale / norm) for g in grads]
        clip = optax.clip_by_global_norm(1.0)
        want, _ = clip.update([jnp.asarray(g) for g in grads],
                              clip.init(None))
        got = [torch.from_numpy(g.copy()) for g in grads]
        n = train.clip_by_global_norm_(got, 1.0)
        assert n.item() == pytest.approx(scale, rel=1e-6)
        for a, b, g in zip(got, want, grads):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=0)
            if scale < 1.0:                 # below the norm: untouched
                np.testing.assert_array_equal(a.numpy(), g)


def _txr_loss(model, params, img, tgt, mask):
    pred = model.apply({"params": params}, img)
    return (txr_train.silog_loss(pred, tgt, mask)
            + 0.5 * txr_train.gradient_matching_loss(pred, tgt, mask))


def _txr_grads(model, params, img, tgt, mask):
    return jax.value_and_grad(
        lambda p: _txr_loss(model, p, img, tgt, mask))(params)


@pytest.mark.parametrize("flash", [False, True],
                         ids=["txr_plain", "txr_kernels"])
def test_three_steps_equal_txr(weights, flash):
    """The loss of each step, the gradients at the start (the first step
    has lr 0, so the second starts from the same weights), the parameters
    after three steps and the loss at them, against
    ``txr.train.make_train_step``.
    ``txr_kernels``: ``txr``'s attention and tail run as Pallas kernels
    (interpret mode) forward and its XLA reference backward, the semantics
    the port's kernels keep on the card."""
    jm = txr_tiny(flash)
    img, tgt, mask = batch()
    J = [jnp.asarray(a) for a in (img, tgt, mask)]
    P = [torch.from_numpy(a) for a in (img, tgt, mask)]
    params = jax.tree_util.tree_map(jnp.asarray, weights)

    want_loss, want_grads = _txr_grads(jm, params, *J)
    pm = port_model(weights)
    loss = train.loss_fn(pm, *P)
    loss.backward()
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    want_grads = as_port(want_grads)
    for name, p in pm.named_parameters():
        w = want_grads[name]
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * np.abs(w).max(), err_msg=name)

    jopt = txr_train.make_optimizer(lr=LR, warmup_steps=1, total_steps=100)
    jstate = txr_train.TrainState(params, jopt.init(params),
                                  jnp.zeros((), jnp.int32))
    jstep = jax.jit(txr_train.make_train_step(jm, jopt))
    opt = train.make_optimizer(lr=LR, warmup_steps=1, total_steps=100)
    pm = port_model(weights)
    adam, sched = opt.init(pm.parameters())
    state = train.TrainState(pm, adam, sched)
    step = train.make_train_step(pm, opt)
    for i in range(3):
        jstate, jl = jstep(jstate, *J)
        state, pl = step(state, *P)
        assert pl.item() == pytest.approx(float(jl), rel=LOSS_RTOL), i
    assert state.step == 3 == int(jstate.step)
    want = as_port(jstate.params)
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=PARAM_ATOL_LR[flash] * LR,
                                   err_msg=name)
    # the third update shows in no step's loss: one more forward on both
    # sides, which must have moved well past the tolerance since the third
    with torch.no_grad():
        after = train.loss_fn(pm, *P).item()
    want_after = float(_txr_loss(jm, jstate.params, *J))
    assert abs(want_after - float(jl)) > 20 * AFTER_RTOL[flash] * want_after
    assert after == pytest.approx(want_after, rel=AFTER_RTOL[flash])


def test_train_step_reduces_loss():
    """The counterpart of ``test_parallel.py::test_train_step_reduces_loss``
    on the port: seeded weights from ``init_train_state``."""
    rng = np.random.default_rng(0)
    model = port_tiny()
    opt = train.make_optimizer(lr=1e-3, warmup_steps=1, total_steps=100)
    state = train.init_train_state(model, opt,
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
    step = train.make_train_step(model, opt)
    images = torch.from_numpy(rng.normal(size=(2, 56, 56, 3)).astype(
        np.float32))
    target = torch.full((2, 56, 56), 2.5)
    mask = torch.ones((2, 56, 56), dtype=torch.bool)
    state, loss0 = step(state, images, target, mask)
    losses = []
    for _ in range(25):
        state, loss = step(state, images, target, mask)
        losses.append(loss.item())
    assert min(losses) < loss0.item()
    assert state.step == 26
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_step_repacks_the_tail_operands(weights):
    """The tail's packed operands are derived from the parameters' storage
    and version: after an optimizer step they are those of the new
    weights, not the old ones."""
    pm = port_model(weights)
    head = pm.head
    before = [t.clone() for t in head.tail_operands()]
    opt = train.make_optimizer(lr=LR, warmup_steps=0, total_steps=10)
    adam, sched = opt.init(pm.parameters())
    state = train.TrainState(pm, adam, sched)
    step = train.make_train_step(pm, opt)
    state, _ = step(state, *[torch.from_numpy(a) for a in batch()])
    after = head.tail_operands()
    w2 = head.head_conv2.weight.detach().permute(2, 3, 1, 0)
    want = pack_params(w2, head.head_conv2.bias.detach(),
                       head.head_conv3.weight.detach().reshape(-1),
                       head.head_conv3.bias.detach())
    for a, b, w in zip(before, after, want):
        torch.testing.assert_close(b, w, rtol=0, atol=0)
    assert not torch.equal(before[0], after[0])


def test_init_train_state_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    opt = train.make_optimizer()
    with pytest.raises(RuntimeError, match="CUDA"):
        train.init_train_state(port_tiny(), opt,
                               torch.Generator().manual_seed(0))
