"""Single-device training step: loss, microbatched gradients, AdamW update.

Counterpart of ``hetu_galvatron_tpu/runtime/trainer.py`` (``make_loss_fn``,
``microbatch_weights``, ``make_train_step``). ``chunks`` splits the global
batch into microbatches whose fp32 gradients accumulate weighted by each
microbatch's share of valid tokens, so a chunked step equals the unchunked
one even under a non-uniform loss mask. The step runs eagerly: PyTorch has
no counterpart of the jitted scan, and none is needed here.

``make_forward_backward`` is the step's first half (loss, gradients,
norm) and leaves the parameters untouched; ``make_train_step`` adds the
in-place AdamW update.

With ``aux_stats`` the loss function returns ``(loss, stats)`` (the MoE
layers' router statistics by ``layer{i}``) and the stats come back in
``metrics["moe"]``: over microbatches, loss-like stats are weighted by each
microbatch's token share and ``tokens_per_expert`` is summed.

Not ported yet, and raising: the hierarchical dp reduction (``hier``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import torch

from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs
from hetu_galvatron_tpu_torch.models.builder import causal_lm_loss, named_leaves
from hetu_galvatron_tpu_torch.models.modules import split_rng
from hetu_galvatron_tpu_torch.runtime.optimizer import AdamW, global_grad_norm


def make_loss_fn(cfg: ModelArgs, *, compute_dtype=torch.bfloat16,
                 remat_flags=None, layer_overrides=None,
                 enc_remat_flags=None, enc_layer_overrides=None,
                 with_moe_stats: bool = False) -> Callable:
    """``loss_fn(params, batch)``: the loss, or ``(loss, MoE stats)`` with
    ``with_moe_stats`` (the loss function of an ``aux_stats`` step). The
    ``enc_*`` pair indexes a t5 model's encoder stack."""
    def loss_fn(params, batch):
        return causal_lm_loss(params, batch, cfg, compute_dtype=compute_dtype,
                              remat_flags=remat_flags,
                              layer_overrides=layer_overrides,
                              enc_remat_flags=enc_remat_flags,
                              enc_layer_overrides=enc_layer_overrides,
                              with_moe_stats=with_moe_stats)
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


def _reduce_stats(stacked: List[Dict[str, Dict[str, torch.Tensor]]],
                 weights: torch.Tensor) -> Dict[str, Dict[str, torch.Tensor]]:
    """Per-microbatch MoE stats -> the step's: ``tokens_per_expert`` summed,
    every other stat weighted by the microbatch token shares."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer in stacked[0]:
        out[layer] = {}
        for key in stacked[0][layer]:
            s = torch.stack([st[layer][key] for st in stacked])
            if key == "tokens_per_expert":
                out[layer][key] = s.sum(0)
            else:
                w = weights.to(s.device).reshape((-1,) + (1,) * (s.dim() - 1))
                out[layer][key] = (w * s).sum(0)
    return out


def _grads(loss: torch.Tensor, leaves: List[torch.Tensor]):
    """d loss / d leaf; zeros for a leaf the loss does not reach (an expert
    bias under sinkhorn routing), as JAX's grad gives."""
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, grads)]


def make_forward_backward(loss_fn: Callable, *, chunks: int = 1,
                          aux_stats: bool = False) -> Callable:
    """Returns ``forward_backward(params, batch) -> (grads, metrics)``: the
    first half of a training step, which leaves the parameters untouched.
    ``metrics`` holds the step's ``loss``, the global ``grad_norm`` and,
    with ``aux_stats``, the MoE stats under ``moe``. The launcher calls
    the two halves apart so that its rerun machine can judge the loss,
    and re-run forward and backward on the same leaves, before the
    in-place update; :func:`make_train_step` joins them."""

    def forward_backward(params, batch):
        leaves = [t for _, t in named_leaves(params)]
        stats: Dict[str, Any] = {}
        if chunks <= 1:
            loss = loss_fn(params, batch)
            if aux_stats:
                loss, stats = loss
            grads = _grads(loss, leaves)
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
            stacked = []
            for mb, w, child in zip(mbs, weights, split_rng(rng, chunks)):
                if child is not None:
                    mb["dropout_rng"] = child
                l = loss_fn(params, mb)
                if aux_stats:
                    l, st = l
                    stacked.append(st)
                g = _grads(l, leaves)
                torch._foreach_add_(grads, [x.float() * w for x in g])
                loss = loss + w * l.detach()
            if aux_stats:
                stats = _reduce_stats(stacked, weights)
        metrics = {"loss": loss, "grad_norm": global_grad_norm(grads)}
        if aux_stats:
            metrics["moe"] = stats
        return grads, metrics

    return forward_backward


def make_train_step(loss_fn: Callable, tx: AdamW, *, chunks: int = 1,
                    aux_stats: bool = False, hier: Optional[Any] = None
                    ) -> Callable:
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``; parameters and the optimizer state are updated in place and
    returned. ``batch`` holds tensors on the run's device and may carry a
    per-step ``dropout_rng`` (a ``torch.Generator``). ``opt_state`` comes
    from ``tx.init`` over ``named_leaves(params)`` (with the names, so that
    expert-bias leaves take SGD)."""
    if hier is not None:
        raise NotImplementedError(
            "the hierarchical dp gradient reduction (hier_dp) is not ported "
            "yet")
    forward_backward = make_forward_backward(loss_fn, chunks=chunks,
                                             aux_stats=aux_stats)

    def step(params, opt_state, batch):
        grads, metrics = forward_backward(params, batch)
        leaves = [t for _, t in named_leaves(params)]
        opt_state = tx.update(leaves, grads, opt_state, metrics["grad_norm"])
        return params, opt_state, metrics

    return step
