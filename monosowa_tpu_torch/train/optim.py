"""Optimizer + LR schedule (torch).

Behavioral contract (MonoDETR/lib/helpers/optimizer_helper.py:6-129,
scheduler_helper.py:6-88; the JAX package's ``train/optim.py``): AdamW
(b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay) with weight decay only
on weight matrices; step decay x0.1 at epochs [125, 165]; optional cosine
warmup over the first epochs; an optional clip of the gradients' global
norm before AdamW (``grad_clip``, optax's rule).

The decay mask follows the JAX package's rule on the Flax leaf name, not
the rank alone: a parameter decays if its Flax leaf is ``kernel`` (or
``embedding``) and it has rank >= 2.  So the raw tables ``level_embed``,
``query_embed`` and ``depth_pos_embed`` take no decay.  Leaf names come from
the weight bridge's table (``convert.flax_leaf``).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
from torch import nn

from monosowa_tpu_torch.convert import flax_leaf


def weight_decay_mask(model: nn.Module) -> Dict[str, bool]:
    """Parameter name -> True (decay) for dense and convolution kernels,
    False for biases, norm scales and raw tables."""
    return {name: p.dim() >= 2
            and flax_leaf(model, name) in ("kernel", "embedding")
            for name, p in model.named_parameters()}


def make_lr_schedule(base_lr: float, steps_per_epoch: int,
                     decay_epochs: Sequence[int] = (125, 165),
                     decay_rate: float = 0.1,
                     warmup_epochs: int = 0) -> Callable[[int], float]:
    """The learning rate as a plain function of the optimizer step (the
    number of updates made before this one), as ``optax`` schedules it."""
    boundaries = [int(e * steps_per_epoch) for e in decay_epochs]
    warmup_steps = warmup_epochs * steps_per_epoch

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (1 - math.cos(math.pi * step / warmup_steps)) / 2
        lr = base_lr
        for boundary in boundaries:
            if step >= boundary:
                lr *= decay_rate
        return lr

    return schedule


@torch.no_grad()
def clip_by_global_norm(params, max_norm: float) -> torch.Tensor:
    """``optax.clip_by_global_norm``'s rule on the parameters' gradients,
    in place: the global norm sqrt(sum of every gradient's squares); below
    ``max_norm`` the gradients stay, else each becomes g / norm * max_norm
    (not ``clip_grad_norm_``'s max_norm / (norm + 1e-6)).  No host sync.
    Returns the norm."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    norm = torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))
    return norm


class ClippedAdamW(torch.optim.AdamW):
    """AdamW whose ``step`` first clips the gradients of all its groups
    together by their global norm (``optax.chain(clip_by_global_norm,
    adamw)``).  The train step calls ``step`` after the data-parallel
    all-reduce, so the clip sees the summed gradients."""

    def __init__(self, params, grad_clip: float, **kw):
        super().__init__(params, **kw)
        self.grad_clip = float(grad_clip)

    def step(self, closure=None):
        clip_by_global_norm([p for group in self.param_groups
                             for p in group["params"]], self.grad_clip)
        return super().step(closure)


def make_optimizer(model: nn.Module, base_lr: float = 2e-4,
                   weight_decay: float = 1e-4,
                   grad_clip: float = 0.0) -> torch.optim.AdamW:
    """AdamW over two parameter groups: the decayed kernels and the rest;
    with ``grad_clip`` > 0 the gradients are clipped first by their global
    norm (:class:`ClippedAdamW`).  The train step sets the groups' ``lr``
    from its schedule."""
    mask = weight_decay_mask(model)
    decay = [p for n, p in model.named_parameters() if mask[n]]
    rest = [p for n, p in model.named_parameters() if not mask[n]]
    groups = [{"params": decay, "weight_decay": weight_decay},
              {"params": rest, "weight_decay": 0.0}]
    kw = dict(lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    if grad_clip > 0:
        return ClippedAdamW(groups, grad_clip, **kw)
    return torch.optim.AdamW(groups, **kw)


def optimizer_step(optimizer: torch.optim.Optimizer) -> int:
    """The number of updates the optimizer has made (its state's count,
    which a checkpoint carries)."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            state = optimizer.state.get(p)
            if state and "step" in state:
                return int(state["step"])
    return 0
