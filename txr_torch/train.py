"""Depth-model fine-tuning: losses, optimizer, train steps. The counterpart
of ``txr/train.py``.

A scale-invariant log loss (SILog) plus an image-gradient matching term,
AdamW under a warm-up + cosine schedule with a global-norm clip, and a train
step that runs on one device or over a (dp, tp) mesh
(``txr_torch.parallel.mesh``: batch over dp, the encoder's dense layers
over tp).

**Precision.** Parameters are f32 master weights. On the card the forward
runs under bf16 autocast (``core.precision.kernel_autocast``), so the fused
qkv product reaches the attention kernel and the head's conv1 output the
DPT tail kernel in bf16, the only type they take; a kernel handed f32
raises by name, and nothing casts around it. LayerNorm runs in f32 under
autocast, and the residual stream stays f32 from the first block on (the
patch embedding and its position embeddings add in bf16, as in the bf16
inference model: ``models/vit.py``). Each kernel's backward differentiates
its plain version at the bf16 inputs it saved (``ops/attention.py``,
``ops/dpt_tail.py``, ``ops/conv_stripe.py``), as ``txr``'s custom VJPs
differentiate the XLA reference; the plain attention keeps its products in
f32 under autocast, as the kernel does. The losses are formed in f32 from
the prediction cast up. On the CPU nothing is autocast: everything is f32,
which is what the parity tests hold against ``txr``.

**Optimizer.** ``txr``'s optax chain, held exactly:

- ``optax.warmup_cosine_decay_schedule(0, lr, warmup, max(total,
  warmup + 1))``: lr 0 at step 0, linear to ``lr`` at ``warmup``, then a
  cosine over the remaining ``decay_steps - warmup`` steps down to 0;
- ``optax.clip_by_global_norm(1.0)``: the gradients become ``g / |g| * 1``
  only when ``|g| >= 1`` and stay as they are below (not
  ``torch.nn.utils.clip_grad_norm_``'s ``g * 1 / (|g| + 1e-6)``);
- ``optax.adamw``: ``torch.optim.AdamW`` over every parameter (eps 1e-8,
  no eps under the root, weight decay on all of them; a parameter that got
  no gradient is decayed with a zero gradient, as optax does).

The schedule is a ``LambdaLR``; the clip runs in the step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
from torch.optim.lr_scheduler import LambdaLR

from txr_torch.core.device import resolve_device
from txr_torch.core.precision import kernel_autocast


def _log_diff(pred: torch.Tensor, target: torch.Tensor,
              eps: float) -> torch.Tensor:
    return (torch.log(torch.clamp(pred, min=eps))
            - torch.log(torch.clamp(target, min=eps)))


def silog_sums(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """(sum d w, sum d^2 w, sum w) with d = log(pred) - log(target) and
    w = mask in pred's dtype (a float mask weighs its pixels)."""
    d = _log_diff(pred, target, eps)
    w = mask.to(pred.dtype)
    return torch.stack([(d * w).sum(), (d * d * w).sum(), w.sum()])


def silog_from_sums(sums: torch.Tensor, lam: float = 0.5) -> torch.Tensor:
    n = torch.clamp(sums[2], min=1.0)
    m1 = sums[0] / n
    return sums[1] / n - lam * m1 * m1


def silog_loss(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               lam: float = 0.5, eps: float = 1e-6) -> torch.Tensor:
    """Scale-invariant log loss over valid pixels:
    L = mean(d^2) - lam * mean(d)^2, d = log(pred) - log(target)."""
    return silog_from_sums(silog_sums(pred, target, mask, eps), lam)


def gradient_sums(pred: torch.Tensor, target: torch.Tensor,
                  mask: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(sum |dx| wx, sum wx, sum |dy| wy, sum wy) of the log-depth
    difference's forward differences, over pairs of valid pixels. The mask
    is cast to bool first (nonzero is valid), as ``txr`` does, so a float
    mask is accepted."""
    dl = _log_diff(pred, target, eps)
    gx = (dl[:, :, 1:] - dl[:, :, :-1]).abs()
    gy = (dl[:, 1:, :] - dl[:, :-1, :]).abs()
    mb = mask.bool()
    wx = (mb[:, :, 1:] & mb[:, :, :-1]).to(pred.dtype)
    wy = (mb[:, 1:, :] & mb[:, :-1, :]).to(pred.dtype)
    return torch.stack([(gx * wx).sum(), wx.sum(), (gy * wy).sum(),
                        wy.sum()])


def gradient_from_sums(sums: torch.Tensor) -> torch.Tensor:
    return (sums[0] / torch.clamp(sums[1], min=1.0)
            + sums[2] / torch.clamp(sums[3], min=1.0))


def gradient_matching_loss(pred: torch.Tensor, target: torch.Tensor,
                           mask: torch.Tensor,
                           eps: float = 1e-6) -> torch.Tensor:
    """Image-gradient matching term (sharpens edges)."""
    return gradient_from_sums(gradient_sums(pred, target, mask, eps))


def depth_loss_sums(pred: torch.Tensor, target: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """The seven sums both losses are formed from. They add over frames,
    so a data-parallel step sums them over its ranks before forming the
    loss: SILog is not a mean of per-shard losses."""
    return torch.cat([silog_sums(pred, target, mask),
                      gradient_sums(pred, target, mask)])


def loss_from_sums(sums: torch.Tensor, grad_weight: float = 0.5
                   ) -> torch.Tensor:
    return (silog_from_sums(sums[:3])
            + grad_weight * gradient_from_sums(sums[3:]))


def loss_fn(model: nn.Module, images: torch.Tensor, target: torch.Tensor,
            mask: torch.Tensor, grad_weight: float = 0.5) -> torch.Tensor:
    """SILog + ``grad_weight`` x gradient matching of ``model(images)``
    against ``target`` over ``mask`` (``txr``'s loss)."""
    return loss_from_sums(loss_sums(model, images, target, mask),
                          grad_weight)


def loss_sums(model: nn.Module, images: torch.Tensor, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """``depth_loss_sums`` of ``model(images)``, the forward under
    ``kernel_autocast``, the sums in f32."""
    with kernel_autocast(images.device.type):
        pred = model(images)
    return depth_loss_sums(pred.float(), target.float(), mask)


@dataclass(frozen=True)
class Optimizer:
    """``txr``'s ``make_optimizer`` chain: the schedule and clip values,
    and :meth:`init`, which builds the AdamW and its schedule over a set
    of parameters (optax's ``init``)."""

    lr: float = 1e-5
    weight_decay: float = 1e-2
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0

    def learning_rate(self, step: int) -> float:
        """``optax.warmup_cosine_decay_schedule(0, lr, warmup,
        max(total, warmup + 1))`` at ``step``."""
        warmup = self.warmup_steps
        if step < warmup:
            return self.lr * step / warmup
        decay = max(self.total_steps, warmup + 1) - warmup
        count = min(step - warmup, decay)
        return self.lr * 0.5 * (1.0 + math.cos(math.pi * count / decay))

    def init(self, params) -> Tuple[torch.optim.AdamW, LambdaLR]:
        params = list(params)
        # AdamW's multi-tensor update takes DTensors (tensor-parallel
        # layers) and plain tensors only in separate lists: two groups
        sharded = [p for p in params if hasattr(p, "placements")]
        if sharded:
            params = [{"params": [p for p in params
                                  if not hasattr(p, "placements")]},
                      {"params": sharded}]
        opt = torch.optim.AdamW(params, lr=self.lr, betas=(0.9, 0.999),
                                eps=1e-8, weight_decay=self.weight_decay)
        lr = self.lr
        sched = LambdaLR(opt, lambda step: (self.learning_rate(step) / lr
                                            if lr else 0.0))
        return opt, sched


def make_optimizer(lr: float = 1e-5, weight_decay: float = 1e-2,
                   warmup_steps: int = 100,
                   total_steps: int = 10_000) -> Optimizer:
    return Optimizer(lr, weight_decay, warmup_steps, total_steps)


@dataclass
class TrainState:
    """The model (its parameters are the f32 master weights), the AdamW
    over them, its schedule, the number of steps taken, and the global
    gradient norm of the last step (before its clip; a 0-d tensor)."""

    model: nn.Module
    optimizer: torch.optim.AdamW
    scheduler: LambdaLR
    step: int = 0
    grad_norm: Optional[torch.Tensor] = None


def _local(t: torch.Tensor) -> torch.Tensor:
    """A gradient's storage on this rank (a DTensor's local shard)."""
    return t.to_local() if hasattr(t, "to_local") else t


def _is_sharded(t: torch.Tensor) -> bool:
    return any(p.is_shard() for p in getattr(t, "placements", ()))


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every gradient's squares,
    as a 0-d f32 tensor. A tensor-parallel gradient's shards are summed
    over its mesh, so the norm is that of the whole parameters."""
    rep = [_local(g) for g in grads if not _is_sharded(g)]
    shard = [g for g in grads if _is_sharded(g)]
    dev = _local(grads[0]).device
    total = torch.zeros((), dtype=torch.float32, device=dev)
    if rep:
        total = total + torch.stack(
            [n.float() for n in torch._foreach_norm(rep)]).square().sum()
    if shard:
        part = torch.stack([n.float() for n in torch._foreach_norm(
            [_local(g) for g in shard])]).square().sum()
        torch.distributed.all_reduce(
            part, group=shard[0].device_mesh.get_group())
        total = total + part
    return total.sqrt()


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: each gradient becomes
    ``g / norm * max_norm`` when ``norm >= max_norm`` and stays as it is
    below. Returns the norm (before the clip). No host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    one = torch.ones((), dtype=norm.dtype, device=norm.device)
    locals_ = [_local(g) for g in grads]
    torch._foreach_div_(locals_, torch.where(keep, one, norm))
    torch._foreach_mul_(locals_, torch.where(keep, one, one * max_norm))
    return norm


def apply_gradients(state: TrainState, max_norm: float) -> torch.Tensor:
    """The update half of a step: the clip, one AdamW step at the
    schedule's rate, the schedule advanced. Returns the gradient norm."""
    params = [p for g in state.optimizer.param_groups for p in g["params"]]
    for p in params:
        if p.grad is None:          # optax decays it with a zero gradient
            p.grad = torch.zeros_like(p)
    state.grad_norm = clip_by_global_norm_([p.grad for p in params],
                                           max_norm)
    state.optimizer.step()
    state.scheduler.step()
    state.step += 1
    return state.grad_norm


class _SumOverRanks(torch.autograd.Function):
    """The loss's sums added over the dp ranks. Every rank then forms the
    same loss from the same sums, so the gradient reaching a rank's own
    sums is the loss's gradient itself: the backward passes it through,
    and the parameter gradients are summed over dp afterwards
    (``_dp_sum_grads``), which makes them the global loss's."""

    @staticmethod
    def forward(ctx, sums, group):
        out = sums.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _dp_sum_grads(model: nn.Module, group) -> None:
    """Sum the (f32) gradients over the dp ranks in one all-reduce."""
    grads = [_local(p.grad) for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    torch.distributed.all_reduce(flat, group=group)
    torch._foreach_copy_(grads, [c.view_as(g) for c, g in zip(
        flat.split([g.numel() for g in grads]), grads)])


class TrainStep:
    """``step(state, images, target, mask) -> (state, loss)``: the call runs
    :meth:`forward`, :meth:`backward` and :meth:`update` in that order and
    nothing else, so a caller can time each part of the step it ships.
    The loss comes back as a 0-d tensor, not read to the host."""

    def __init__(self, model: nn.Module, optimizer: Optimizer,
                 grad_weight: float = 0.5, mesh=None):
        self.model = model
        self.optimizer = optimizer
        self.grad_weight = grad_weight
        self.dp_group = None if mesh is None else mesh["dp"].get_group()

    def forward(self, state: TrainState, images, target, mask
                ) -> torch.Tensor:
        """The gradients cleared, then the loss of the (global) batch."""
        if state.model is not self.model:
            raise ValueError("the state holds another model than the step")
        state.optimizer.zero_grad(set_to_none=True)
        sums = loss_sums(self.model, images, target, mask)
        if self.dp_group is not None:
            sums = _SumOverRanks.apply(sums, self.dp_group)
        return loss_from_sums(sums, self.grad_weight)

    def backward(self, loss: torch.Tensor) -> None:
        """The loss's gradients, summed over dp on a mesh."""
        loss.backward()
        if self.dp_group is not None:
            _dp_sum_grads(self.model, self.dp_group)

    def update(self, state: TrainState) -> torch.Tensor:
        """``apply_gradients``: the clip, AdamW, the schedule."""
        return apply_gradients(state, self.optimizer.max_grad_norm)

    def __call__(self, state: TrainState, images, target, mask):
        loss = self.forward(state, images, target, mask)
        self.backward(loss)
        self.update(state)
        return state, loss.detach()


def make_train_step(model: nn.Module, optimizer: Optimizer,
                    grad_weight: float = 0.5) -> TrainStep:
    """The step on one device. ``images`` (B, H, W, 3) normalized,
    ``target`` (B, H, W), ``mask`` (B, H, W) bool or float, all on the
    model's device."""
    return TrainStep(model, optimizer, grad_weight)


def make_sharded_train_step(model: nn.Module, optimizer: Optimizer, mesh,
                            grad_weight: float = 0.5) -> TrainStep:
    """The step over a (dp, tp) mesh (``txr_torch.parallel.mesh``): the
    model was laid out by ``shard_params``, and each rank passes its dp
    slice of the global batch (``shard_batch``). The loss's sums are summed
    over dp before the loss is formed, the gradients summed over dp (see
    ``_SumOverRanks``), and the clip's norm is that of the whole
    parameters; Adam's moments take their parameters' placements. Every
    rank returns the loss of the global batch."""
    return TrainStep(model, optimizer, grad_weight, mesh)


def init_train_state(model: nn.Module, optimizer: Optimizer,
                     generator: torch.Generator,
                     device: Optional[Union[str, torch.device]] = None,
                     mesh=None) -> TrainState:
    """Put ``model`` on ``device`` (``None``: the CUDA device) as f32
    master weights drawn from ``generator`` (``DepthAnything.init_weights``),
    lay it out on ``mesh`` when one is given, and build the optimizer over
    its parameters."""
    dev = resolve_device(device)
    model.to(device=dev, dtype=torch.float32)
    model.init_weights(generator)
    if mesh is not None:
        from txr_torch.parallel.mesh import shard_params

        shard_params(model, mesh)
    opt, sched = optimizer.init(model.parameters())
    return TrainState(model, opt, sched, 0)
