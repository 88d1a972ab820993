"""Single-device training step: loss, microbatched gradients, AdamW update.

Counterpart of ``hetu_galvatron_tpu/runtime/trainer.py`` (``make_loss_fn``,
``microbatch_weights``, ``make_train_step``). ``chunks`` splits the global
batch into microbatches whose fp32 gradients accumulate weighted by each
microbatch's share of valid tokens, so a chunked step equals the unchunked
one even under a non-uniform loss mask. The step runs eagerly: PyTorch has
no counterpart of the jitted scan, and none is needed here.

Not ported yet, and raising: the hierarchical dp reduction (``hier``) and
MoE aux statistics (``aux_stats``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models.builder import causal_lm_loss, named_leaves
from hetu_galvatron_tpu_torch.models.modules import split_rng
from hetu_galvatron_tpu_torch.runtime.optimizer import AdamW, global_grad_norm


def make_loss_fn(cfg: ModelArgs, *, compute_dtype=torch.bfloat16,
                 remat_flags=None, layer_overrides=None
                 ) -> Callable[[Any, Dict[str, Any]], torch.Tensor]:
    def loss_fn(params, batch):
        return causal_lm_loss(params, batch, cfg, compute_dtype=compute_dtype,
                              remat_flags=remat_flags,
                              layer_overrides=layer_overrides)
    return loss_fn


def microbatch_weights(loss_mask: Optional[torch.Tensor],
                       chunks: int) -> torch.Tensor:
    """Per-microbatch token-share weights from a ``[chunks, ...]``-stacked
    loss mask; ``None`` -> uniform ``1/chunks``."""
    if loss_mask is None:
        return torch.full((chunks,), 1.0 / chunks, dtype=torch.float32)
    counts = loss_mask.float().sum(dim=tuple(range(1, loss_mask.dim())))
    return counts / counts.sum().clamp_min(1.0)


def _split_batch(batch: Dict[str, Any], chunks: int):
    bsz = batch["tokens"].shape[0]
    if bsz % chunks:
        raise ValueError(f"batch size {bsz} is not divisible by "
                         f"chunks={chunks}; adjust global_train_batch_size "
                         "or chunks")
    return [{k: v.reshape((chunks, bsz // chunks) + tuple(v.shape[1:]))[c]
             for k, v in batch.items()} for c in range(chunks)]


def make_train_step(loss_fn: Callable, tx: AdamW, *, chunks: int = 1,
                    aux_stats: bool = False, hier: Optional[Any] = None
                    ) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; parameters and the optimizer state are updated in place and
    returned. ``batch`` holds tensors on the run's device and may carry a
    per-step ``dropout_rng`` (a ``torch.Generator``)."""
    if hier is not None:
        raise NotImplementedError(
            "the hierarchical dp gradient reduction (hier_dp) is not ported "
            "yet")
    if aux_stats:
        raise NotImplementedError("MoE aux statistics are not ported yet")

    def step(params, opt_state, batch):
        leaves = [t for _, t in named_leaves(params)]
        if chunks <= 1:
            loss = loss_fn(params, batch)
            grads = list(torch.autograd.grad(loss, leaves))
            loss = loss.detach()
        else:
            # the per-step generator is not a [B, ...] array: each
            # microbatch gets a child stream instead of a slice
            batch = dict(batch)
            rng = batch.pop("dropout_rng", None)
            mbs = _split_batch(batch, chunks)
            mask = batch.get("loss_mask")
            weights = microbatch_weights(
                None if mask is None else
                mask.reshape((chunks, -1) + tuple(mask.shape[1:])), chunks)
            weights = weights.to(leaves[0].device)
            grads = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves[0].device)
            for mb, w, child in zip(mbs, weights, split_rng(rng, chunks)):
                if child is not None:
                    mb["dropout_rng"] = child
                l = loss_fn(params, mb)
                g = torch.autograd.grad(l, leaves)
                torch._foreach_add_(grads, [x.float() * w for x in g])
                loss = loss + w * l.detach()
        gnorm = global_grad_norm(grads)
        opt_state = tx.update(leaves, grads, opt_state, gnorm)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    return step
