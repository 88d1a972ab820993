"""Single-device training step: loss, microbatched gradients, AdamW update.

Counterpart of ``hetu_galvatron_tpu/runtime/trainer.py`` (``make_loss_fn``,
``microbatch_weights``, ``make_train_step``, ``train_loop`` :238,
``make_telemetry`` :365). ``chunks`` splits the global
batch into microbatches whose fp32 gradients accumulate weighted by each
microbatch's share of valid tokens, so a chunked step equals the unchunked
one even under a non-uniform loss mask. The step runs eagerly: PyTorch has
no counterpart of the jitted scan, and none is needed here.

``make_forward_backward`` is the step's first half (loss, gradients,
norm) and leaves the parameters untouched; ``make_train_step`` adds the
in-place AdamW update. ``train_loop`` is the minimal host-side loop
around a step (hooks, preemption at a step boundary, goodput, cadence
saves, an owned telemetry); ``cli/train_dist.py`` runs its own loop with
the fault lifecycle on top.

With ``aux_stats`` the loss function returns ``(loss, stats)`` (the MoE
layers' router statistics by ``layer{i}``) and the stats come back in
``metrics["moe"]``: over microbatches, loss-like stats are weighted by each
microbatch's token share and ``tokens_per_expert`` is summed.

Over several ranks the step is ``parallel/spmd.SpmdEngine``'s, which
reuses this module's microbatch split and token-share weights: microbatch
c holds global rows ``[c B / chunks, (c + 1) B / chunks)`` on every rank,
each layer takes its dp shard of them, and every rank's loss is over the
microbatch's global token count.

Not ported yet, and raising: the hierarchical dp reduction (``hier``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs, ModelArgs
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


def to_device(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device``; int32 ids become int64
    embedding / gather indices."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def train_loop(
    args: CoreArgs,
    params: Any,
    data_iter,
    *,
    train_step: Optional[Callable] = None,
    tx: Optional[AdamW] = None,
    device_put: Optional[Callable[[Dict[str, Any]], Dict[str, Any]]] = None,
    hooks: Tuple[Callable, ...] = (),
    telemetry: Optional[Any] = None,
    preemption: Optional[Any] = None,
    goodput: Optional[Any] = None,
    checkpoint: Optional[Any] = None,
) -> Tuple[Any, Any, list]:
    """Host-side iteration loop: fetch a batch, run the step, invoke the
    hooks. Returns the final ``(params, opt_state, losses)``; parameters
    are updated in place.

    ``hooks`` are ``h(it, metrics)`` callables invoked after every step
    with the step's metrics, still tensors on the device — hooks must not
    force a device sync. ``preemption`` is an optional object with a
    ``requested() -> bool`` method (``runtime.supervisor.PreemptionGuard``)
    checked at every step boundary: once true the loop stops cleanly after
    the in-flight step. ``telemetry`` is an optional
    ``observability.telemetry.TrainingTelemetry`` appended to the hooks;
    it is final-flushed when the loop exits (even on error) and left open
    for the caller. When ``args.observability.enabled`` and no instance is
    passed, one is built from the args (:func:`make_telemetry`) and closed
    with the loop. ``goodput`` is an optional
    ``observability.goodput.GoodputTracker``: each iteration's host wall
    is booked as ``productive_step``, the first as ``recompile``.
    ``checkpoint`` is an optional ``runtime.checkpoint.CheckpointCadence``:
    when due, the post-update state is saved through it, and any in-flight
    write is drained when the loop exits — even on error. The step and
    the fetch run inside the ``train/step`` and ``train/fetch`` spans.

    Without ``train_step`` the loop builds the plain step of
    ``args.model`` at ``args.parallel.mixed_precision`` with
    ``max(args.parallel.chunks, 1)`` microbatches, as JAX does; without
    ``device_put`` batches go to the parameters' device."""
    from hetu_galvatron_tpu_torch.models.modules import compute_dtype_of
    from hetu_galvatron_tpu_torch.observability.tracing import span
    from hetu_galvatron_tpu_torch.runtime.optimizer import make_optimizer

    owns_telemetry = telemetry is None and args.observability.enabled
    if owns_telemetry:
        telemetry = make_telemetry(args)

    tx = tx or make_optimizer(args.train)
    if train_step is None:
        loss_fn = make_loss_fn(
            args.model,
            compute_dtype=compute_dtype_of(args.parallel.mixed_precision))
        train_step = make_train_step(loss_fn, tx,
                                     chunks=max(args.parallel.chunks, 1))
    names, leaves = zip(*named_leaves(params))
    opt_state = tx.init(list(leaves), list(names))
    device_losses = []
    device = next(t for _, t in named_leaves(params)).device
    put = device_put or (lambda b: to_device(b, device))
    use_dropout = (args.model.hidden_dropout > 0.0
                   or args.model.attention_dropout > 0.0)
    all_hooks = hooks + ((telemetry,) if telemetry is not None else ())
    try:
        for it in range(args.train.train_iters):
            it_t0 = time.perf_counter()
            with span("train/fetch"):
                batch = put(next(data_iter))
            if use_dropout:
                # the launcher's per-iteration stream, from (seed, it)
                dev = next(iter(batch.values())).device
                batch["dropout_rng"] = torch.Generator(
                    device=dev).manual_seed(
                        args.train.seed * 1_000_003 + it)
            with span("train/step"):
                params, opt_state, metrics = train_step(
                    params, opt_state, batch)
            # keep losses on the device: a float() here would wait for
            # the step and serialize host batch prep against the card
            device_losses.append(metrics["loss"])
            for h in all_hooks:
                h(it, metrics)
            if goodput is not None:
                goodput.add("recompile" if it == 0 else "productive_step",
                            time.perf_counter() - it_t0)
            if checkpoint is not None and checkpoint.due(it):
                # after the goodput booking: the cadence books its own
                # wall to checkpoint_save
                checkpoint.save(it + 1, params, opt_state)
            if preemption is not None and preemption.requested():
                # step boundary: the update above is complete and safe to
                # checkpoint; never abandon a step mid-flight
                break
    finally:
        if checkpoint is not None:
            try:
                checkpoint.drain()
            except Exception as e:  # noqa: BLE001 — never mask loop error
                print(f"warning: checkpoint drain at loop exit failed "
                      f"({type(e).__name__}: {e})", flush=True)
        if telemetry is not None:
            if owns_telemetry:
                telemetry.close()
                telemetry.registry.close()  # the stream's file descriptor
            else:
                telemetry.flush(final=True)
    losses = [float(l) for l in device_losses]
    return params, opt_state, losses


def make_telemetry(args: CoreArgs, *, registry: Any = None,
                   world_size: int = 1,
                   global_batch_size: Optional[int] = None) -> Any:
    """Build a ``TrainingTelemetry`` hook (and its JSONL sink) from
    ``args.observability``. When no ``registry`` is passed the
    process-wide default registry is (re)configured with the sink, so
    library-level instrumentation (rerun counters, profiler histograms,
    spans, checkpoint gauges) lands in the same file."""
    from hetu_galvatron_tpu_torch.observability.registry import (
        configure,
        metrics_path_of,
    )
    from hetu_galvatron_tpu_torch.observability.telemetry import (
        TrainingTelemetry,
    )

    obs = args.observability
    if registry is None:
        registry = configure(
            jsonl_path=metrics_path_of(args),
            tensorboard_dir=(args.logging.tensorboard_dir
                             if obs.tensorboard else None))
    return TrainingTelemetry(
        registry,
        model=args.model,
        global_batch_size=(global_batch_size
                           or args.parallel.global_train_batch_size),
        seq_length=args.model.seq_length,
        world_size=world_size,
        peak_tflops_per_device=obs.peak_tflops,
        flush_interval=obs.flush_interval,
    )
