"""Training launcher: ``python -m hetu_galvatron_tpu_torch.cli.train_dist
<config.yaml> [key=value ...]``.

Counterpart of ``hetu_galvatron_tpu/cli/train_dist.py`` for its pp=1,
single-device branch: load config -> initialize -> plan -> init model ->
optimizer -> data -> step loop with timing and loss log -> exit code. On a
CUDA device with ``model.use_flash_attn`` every layer's attention core is
the port's ``flash_sdpa`` (the CUDA kernels K1-K3), the counterpart of the
JAX launcher choosing the Pallas kernel on a TPU. The run goes to the GPU
unless ``device=cpu`` is given.

Flags outside this slice raise with their name rather than being ignored.
"""

from __future__ import annotations

import sys
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch


def unsupported_flags(args) -> list:
    """Names of the set flags this slice of the port does not run."""
    flags = {
        "ckpt.load": args.ckpt.load, "ckpt.save": args.ckpt.save,
        "rerun.enable": args.rerun.enable,
        "rerun.inject_kind": args.rerun.inject_kind != "none",
        "chaos.enable": args.chaos.enable,
        "chaos.kind": args.chaos.kind != "none",
        "observability.enabled": args.observability.enabled,
        "observability.flight_dir": args.observability.flight_dir,
        "tp_overlap.enable": args.tp_overlap.enable,
        "parallel.hier_dp": args.parallel.hier_dp,
        "train.rampup_batch_size": args.train.rampup_batch_size,
        "supervisor.auto_restart": args.supervisor.auto_restart,
        "logging.tensorboard_dir": args.logging.tensorboard_dir,
        "logging.wandb_project": args.logging.wandb_project,
        "model.use_fused_ce": args.model.use_fused_ce,
    }
    return [name for name, value in flags.items() if value]


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if t.dtype == torch.int32:
            t = t.long()  # embedding / gather indices
        out[k] = t.to(device, non_blocking=True)
    return out


def attention_overrides(cfg, device) -> Dict[int, Dict[str, Any]]:
    """Per-layer attention core: the flash kernels on a CUDA device when
    ``use_flash_attn``, else the plain core."""
    if not (cfg.use_flash_attn and device.type == "cuda"):
        return {}
    from hetu_galvatron_tpu_torch.ops.flash_attention import flash_sdpa

    return {i: {"sdpa_fn": flash_sdpa}
            for i in range(cfg.num_hidden_layers)}


def train(args, on_step: Optional[Callable[[int, Dict[str, Any]], None]]
          = None) -> Dict[str, Any]:
    """Run ``args.train.train_iters`` steps; ``on_step(it, metrics)`` is
    called after each (tools hook timers and the profiler here)."""
    from hetu_galvatron_tpu_torch.core.profiler.runtime_profiler import (
        RuntimeProfiler,
    )
    from hetu_galvatron_tpu_torch.models.builder import (
        init_causal_lm,
        named_leaves,
    )
    from hetu_galvatron_tpu_torch.models.modules import compute_dtype_of
    from hetu_galvatron_tpu_torch.runtime.dataloader import (
        get_train_valid_test_data_iterators,
    )
    from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
        get_hybrid_parallel_config,
    )
    from hetu_galvatron_tpu_torch.runtime.initialize import initialize
    from hetu_galvatron_tpu_torch.runtime.optimizer import make_optimizer
    from hetu_galvatron_tpu_torch.runtime.trainer import (
        make_loss_fn,
        make_train_step,
    )

    bad = unsupported_flags(args)
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not ported to hetu_galvatron_tpu_torch yet "
            "(this slice runs plain single-device training)")
    state = initialize(args)
    device = state.device
    hpc = get_hybrid_parallel_config(args, state.world_size)
    state.log(f"parallel plan: {hpc.describe()}")

    cfg = args.model
    params = init_causal_lm(cfg, seed=args.train.seed, device=device)
    tx = make_optimizer(args.train)
    train_iter, valid_iter, test_iter = get_train_valid_test_data_iterators(
        args, global_batch_size=hpc.global_bsz)
    compute_dtype = compute_dtype_of(args.parallel.mixed_precision)
    overrides = attention_overrides(cfg, device)
    if overrides:
        state.log("attention: flash kernels (CUDA K1-K3) on every layer")
    loss_fn = make_loss_fn(cfg, compute_dtype=compute_dtype,
                           layer_overrides=overrides)
    step = make_train_step(loss_fn, tx, chunks=hpc.chunks)
    opt_state = tx.init([t for _, t in named_leaves(params)])
    profiler = RuntimeProfiler(args, device=device)
    use_dropout = cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0

    def run_eval(iterator) -> float:
        with torch.no_grad():
            vs = [float(loss_fn(params, _to_device(next(iterator), device)))
                  for _ in range(max(args.train.eval_iters, 1))]
        return float(np.mean(vs))

    losses, val_losses = [], []
    for it in range(args.train.train_iters):
        profiler.time_start(it)
        batch = _to_device(next(train_iter), device)
        if use_dropout:
            # per-iteration stream, reproducible from (seed, it)
            batch["dropout_rng"] = torch.Generator(device=device).manual_seed(
                args.train.seed * 1_000_003 + it)
        params, opt_state, metrics = step(params, opt_state, batch)
        profiler.time_end(it)
        profiler.iteration_log(it, metrics, lr=tx.schedule(it))
        losses.append(float(metrics["loss"]))
        if on_step is not None:
            on_step(it, metrics)
        if (valid_iter is not None and args.train.eval_interval
                and (it + 1) % args.train.eval_interval == 0):
            v = run_eval(valid_iter)
            val_losses.append({"iter": it + 1, "loss": v})
            state.log(f"iter {it + 1}: validation loss {v:.4f}")
    test_loss = None
    if test_iter is not None and losses:
        test_loss = run_eval(test_iter)
        state.log(f"test loss {test_loss:.4f}")
    if args.profile.profile:
        state.log(f"mean iter time: {profiler.filtered_time_ms():.2f} ms")
    return {"losses": losses, "val_losses": val_losses,
            "test_loss": test_loss, "iter_ms": profiler.filtered_time_ms(),
            "params": params, "exit_code": None}


def _finish(out: Dict[str, Any]) -> int:
    if out.get("exit_code") is not None:
        return out["exit_code"]
    if not out["losses"]:
        print("training done: 0 iters (nothing left to train)")
        return 0
    final = out["losses"][-1]
    print(f"training done: {len(out['losses'])} iters, final loss {final:.4f}")
    return 0 if np.isfinite(final) else 1


def main(argv=None) -> int:
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli

    args = args_from_cli(list(argv if argv is not None else sys.argv[1:]),
                         mode="train_dist")
    return _finish(train(args))


if __name__ == "__main__":
    sys.exit(main())
