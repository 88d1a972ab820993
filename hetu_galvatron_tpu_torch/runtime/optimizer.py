"""Learning-rate schedules and the AdamW chain, in plain PyTorch.

Counterpart of ``hetu_galvatron_tpu/runtime/optimizer.py`` (optax there).
The update follows ``make_optimizer``'s chain exactly, step for step:

1. clip by global norm: ``g * max_norm / norm`` only when ``norm >=
   max_norm`` (optax ``clip_by_global_norm``);
2. Adam with bias correction, ``eps`` outside the square root
   (``scale_by_adam``);
3. decoupled weight decay ``+ wd * p`` on parameters with ``ndim >= 2``
   (``add_decayed_weights`` with the decay mask);
4. ``* -lr(count)`` with ``count`` starting at 0 (``scale_by_learning_rate``),
   so with warmup the first update is zero.

Parameters are updated in place (``torch._foreach_*`` over the leaves),
where the JAX package returns new arrays. MoE ``expert_bias`` buffers are
not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List

import torch

from hetu_galvatron_tpu_torch.core.args_schema import TrainArgs

Schedule = Callable[[int], float]


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init

    def fn(count):
        c = min(max(count, 0), steps)
        return (init - end) * (1 - c / steps) + end
    return fn


def _join(schedules: List[Schedule], boundaries: List[int]) -> Schedule:
    """optax.join_schedules."""
    def fn(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out
    return fn


def make_lr_schedule(train: TrainArgs) -> Schedule:
    """Warmup + decay (constant / linear / cosine / inverse-square-root /
    WSD), the same arithmetic as the JAX package's optax schedules."""
    peak, floor = train.lr, train.min_lr
    warmup = max(train.lr_warmup_iters, 0)
    total = train.lr_decay_iters or train.train_iters
    decay_steps = max(total - warmup, 1)
    style = train.lr_decay_style

    if style == "constant":
        def body(step):
            return peak
    elif style == "linear":
        body = _linear(peak, floor, decay_steps)
    elif style == "cosine":
        alpha = floor / max(peak, 1e-12)

        def body(step):
            c = min(step, decay_steps)
            cos = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
            return peak * ((1 - alpha) * cos + alpha)
    elif style == "inverse-square-root":
        def body(step):
            s = step + warmup + 1.0
            return max(peak * math.sqrt(warmup + 1.0) / math.sqrt(s), floor)
    elif style == "WSD":
        wsd = max(train.lr_wsd_decay_iters, 1)
        stable = max(decay_steps - wsd, 0)
        body = _join([lambda step: peak, _linear(peak, floor, wsd)], [stable])
    else:
        raise ValueError(f"unknown lr_decay_style {style}")

    if warmup == 0:
        return body
    return _join([_linear(0.0, peak, warmup), body], [warmup])


def global_grad_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """fp32 global L2 norm over every gradient leaf."""
    norms = torch._foreach_norm([g.float() for g in grads])
    return torch.linalg.vector_norm(torch.stack(norms))


@dataclass
class AdamState:
    count: int = 0  # updates applied so far (optax's count, host side)
    mu: List[torch.Tensor] = field(default_factory=list)
    nu: List[torch.Tensor] = field(default_factory=list)


class AdamW:
    """The clip -> Adam -> weight decay -> -lr chain of ``make_optimizer``
    over a list of fp32 leaves."""

    def __init__(self, train: TrainArgs):
        self.clip = train.clip_grad
        self.b1, self.b2, self.eps = (train.adam_beta1, train.adam_beta2,
                                      train.adam_eps)
        self.weight_decay = train.weight_decay
        self.schedule = make_lr_schedule(train)

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(
            mu=[torch.zeros_like(p, dtype=torch.float32) for p in params],
            nu=[torch.zeros_like(p, dtype=torch.float32) for p in params])

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState, gnorm: torch.Tensor) -> AdamState:
        """Apply one update in place; ``gnorm`` is global_grad_norm(grads).
        ``grads`` are consumed (scaled in place)."""
        grads = [g.float() for g in grads]
        if self.clip and self.clip > 0:
            # optax: select(norm < max_norm, g, g / norm * max_norm)
            factor = torch.where(gnorm < self.clip, torch.ones_like(gnorm),
                                 self.clip / gnorm)
            torch._foreach_mul_(grads, factor)
        b1, b2 = self.b1, self.b2
        torch._foreach_lerp_(state.mu, grads, 1.0 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, grads, grads, value=1.0 - b2)
        count = state.count + 1
        mu_hat = torch._foreach_div(state.mu, 1.0 - b1 ** count)
        denom = torch._foreach_div(state.nu, 1.0 - b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            decayed = [i for i, p in enumerate(params) if p.ndim >= 2]
            torch._foreach_add_([upd[i] for i in decayed],
                                [params[i] for i in decayed],
                                alpha=self.weight_decay)
        lr = self.schedule(state.count)
        torch._foreach_add_(params, upd, alpha=-lr)
        state.count = count
        return state


def make_optimizer(train: TrainArgs) -> AdamW:
    return AdamW(train)
