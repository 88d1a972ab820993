"""Learning-rate schedules and the AdamW chain, in plain PyTorch.

Counterpart of ``hetu_galvatron_tpu/runtime/optimizer.py`` (optax there).
The update follows ``make_optimizer``'s chain exactly, step for step:

1. clip by global norm: ``g * max_norm / norm`` only when ``norm >=
   max_norm`` (optax ``clip_by_global_norm``);
2. Adam with bias correction, ``eps`` outside the square root
   (``scale_by_adam``);
3. decoupled weight decay ``+ wd * p`` on parameters with ``ndim >= 2``
   (``add_decayed_weights`` with the decay mask); a caller whose leaves
   carry leading axes that are not the parameter's own (the compiled
   pipeline's ``[pp]`` stage axis) passes them to :meth:`AdamW.init`
   (``lead_axes``), so a stacked bias or norm weight stays undecayed (JAX
   ``compiled_pipeline._stacked_decay_mask`` :113);
4. ``* -lr(count)`` with ``count`` starting at 0 (``scale_by_learning_rate``),
   so with warmup the first update is zero.

MoE ``expert_bias`` leaves (named ``...expert_bias``) take plain SGD with
lr = 1 instead, as ``partition_expert_bias`` routes them: their gradient is
minus the router's balancing update (``models/moe.py``). The clip then
divides by the global norm of the Adam leaves only, as optax's clip inside
the partition does.

``make_pipeline_optimizer`` is the chain without step 1, JAX
``runtime/pipeline.py::_pipeline_optimizer`` :72: the pipeline engine
clips across all its stages, multiplying the gradients by the global
scale itself before each stage's update (``runtime/pipeline.py``).

Parameters are updated in place (``torch._foreach_*`` over the leaves),
where the JAX package returns new arrays, in groups of leaves of at most
``GROUP_BYTES`` of fp32 (a larger leaf forms its own group): the update's
two temporaries then take twice the largest group, not twice the model.
Grouping leaves the arithmetic of every element as it is.

Over a plan split across ranks (``parallel/spmd.py``) the chain runs
unchanged on each rank's leaves, or on ZeRO-2's slices of them; only the
clip's norm is the sharded one (:func:`sharded_grad_norm`), which counts
each logical element once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import torch

from hetu_galvatron_tpu_torch.core.args_schema import TrainArgs

Schedule = Callable[[int], float]
GROUP_BYTES = 1 << 30  # fp32 bytes of the leaves one foreach group updates


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


def sharded_grad_norm(counted: List[torch.Tensor],
                      all_reduce: Callable[[torch.Tensor], torch.Tensor],
                      device) -> torch.Tensor:
    """fp32 global L2 norm of a model whose gradient leaves are split over
    ranks (``parallel/spmd.py``): ``counted`` holds the gradients this
    rank counts (each logical element is counted by one rank, however many
    hold it) and ``all_reduce`` sums the squares over the ranks."""
    sq = torch.zeros((), dtype=torch.float32, device=device)
    if counted:
        norms = torch._foreach_norm([g.float() for g in counted])
        sq = torch.stack(norms).square().sum()
    return torch.sqrt(all_reduce(sq))


@dataclass
class AdamState:
    count: int = 0  # updates applied so far (optax's count, host side)
    # leaf indices: the Adam chain's, with mu / nu in their order, and the
    # expert-bias leaves' (SGD, lr = 1)
    adam: List[int] = field(default_factory=list)
    sgd: List[int] = field(default_factory=list)
    mu: List[torch.Tensor] = field(default_factory=list)
    nu: List[torch.Tensor] = field(default_factory=list)
    # per Adam leaf: takes the weight decay; None decays the ``ndim >= 2``
    # leaves
    decay: Optional[List[bool]] = None


def leaf_groups(numels: Sequence[int], group_bytes: Optional[int]
                ) -> List[List[int]]:
    """Consecutive positions in groups of at most ``group_bytes`` of fp32; a
    larger leaf is a group of its own, and None puts all in one group."""
    groups: List[List[int]] = [[]]
    size = 0
    for i, n in enumerate(numels):
        if (group_bytes is not None and groups[-1]
                and size + 4 * n > group_bytes):
            groups.append([])
            size = 0
        groups[-1].append(i)
        size += 4 * n
    return [g for g in groups if g]


class AdamW:
    """The clip -> Adam -> weight decay -> -lr chain of ``make_optimizer``
    over a list of fp32 leaves, with SGD(lr = 1) on expert-bias leaves."""

    def __init__(self, train: TrainArgs):
        self.clip = train.clip_grad
        self.b1, self.b2, self.eps = (train.adam_beta1, train.adam_beta2,
                                      train.adam_eps)
        self.weight_decay = train.weight_decay
        self.schedule = make_lr_schedule(train)

    def init(self, params: List[torch.Tensor],
             names: Optional[Sequence[str]] = None,
             lead_axes: Optional[Sequence[int]] = None) -> AdamState:
        """``names`` (dotted paths, ``builder.named_leaves``) mark the
        expert-bias leaves; without them every leaf is an Adam leaf.
        ``lead_axes`` gives per leaf the leading axes the decay rule does
        not count (a stacked leaf's ``[pp]``); without it every leaf with
        ``ndim >= 2`` is decayed."""
        sgd = [i for i, n in enumerate(names or ())
               if n.endswith("expert_bias")]
        adam = sorted(set(range(len(params))) - set(sgd))
        decay = (None if lead_axes is None else
                 [params[i].ndim - lead_axes[i] >= 2 for i in adam])
        return AdamState(
            adam=adam, sgd=sgd, decay=decay,
            mu=[torch.zeros_like(params[i], dtype=torch.float32)
                for i in adam],
            nu=[torch.zeros_like(params[i], dtype=torch.float32)
                for i in adam])

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
               state: AdamState, gnorm: torch.Tensor) -> AdamState:
        """Apply one update in place. ``gnorm`` is global_grad_norm(grads)
        over every leaf, the clip's norm when every leaf is an Adam leaf;
        with expert-bias leaves the clip takes the Adam leaves' own norm.
        ``grads`` are consumed (scaled in place)."""
        for i in state.sgd:
            params[i].sub_(grads[i].float())  # optax.sgd(1): p + (-1 * g)
        params = [params[i] for i in state.adam]
        grads = [grads[i].float() for i in state.adam]
        clip = self.clip and self.clip > 0
        if clip:
            if state.sgd:
                gnorm = global_grad_norm(grads)
            # optax: select(norm < max_norm, g, g / norm * max_norm)
            factor = torch.where(gnorm < self.clip, torch.ones_like(gnorm),
                                 self.clip / gnorm)
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        lr = self.schedule(state.count)
        for group in leaf_groups([p.numel() for p in params], GROUP_BYTES):
            p, g = [params[i] for i in group], [grads[i] for i in group]
            mu, nu = [state.mu[i] for i in group], [state.nu[i] for i in group]
            if clip:
                torch._foreach_mul_(g, factor)
            torch._foreach_lerp_(mu, g, 1.0 - b1)
            torch._foreach_mul_(nu, b2)
            torch._foreach_addcmul_(nu, g, g, value=1.0 - b2)
            upd = torch._foreach_div(mu, 1.0 - b1 ** count)  # mu_hat
            denom = torch._foreach_div(nu, 1.0 - b2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            torch._foreach_div_(upd, denom)
            del denom
            decayed = [i for i, t in enumerate(p)
                       if (t.ndim >= 2 if state.decay is None
                           else state.decay[group[i]])]
            if self.weight_decay and decayed:
                torch._foreach_add_([upd[i] for i in decayed],
                                    [p[i] for i in decayed],
                                    alpha=self.weight_decay)
            torch._foreach_add_(p, upd, alpha=-lr)
            del upd  # before the next group's temporaries
        state.count = count
        return state


def make_optimizer(train: TrainArgs) -> AdamW:
    return AdamW(train)


def make_pipeline_optimizer(train: TrainArgs) -> AdamW:
    """AdamW with weight decay and the LR schedule and no clip: the
    pipeline engine's per-stage update (expert biases still take SGD)."""
    tx = AdamW(train)
    tx.clip = 0.0
    return tx
