"""Training launcher: ``python -m hetu_galvatron_tpu_torch.cli.train_dist
<config.yaml> [key=value ...]``.

Counterpart of ``hetu_galvatron_tpu/cli/train_dist.py`` for its pp=1
single-device branch and its pipeline branch (:880-932):
load config -> initialize -> plan -> init model -> optimizer -> data ->
resume -> step loop with timing, loss log, fault checks and checkpoints
-> exit code. A plan with ``pp_deg > 1`` whose stages each run one rank
(``parallel.num_devices`` equal to ``pp_deg``; GLOBAL mode's
``parallel.pp_deg``, ``pipeline_type``, ``virtual_pp_deg``, or a JSON
plan's ``pp_deg``, ``pp_division``, ``vpp_deg``) trains through
``runtime/pipeline.PipelineEngine``: the model is split into stage trees,
the optimizer state, checkpoints and the resume are per stage, the
evaluations run ``eval_step``, and the ramp passes its microbatch count.
The stages run the plain cross-entropy whatever ``model.use_fused_ce``
says, as JAX's do. ``pipeline.schedule_impl=compiled`` selects the engine
as JAX does (:880-915): a plan the compiled schedule can express trains
through ``runtime/compiled_pipeline.CompiledPipelineEngine`` (the lockstep
1F1B step replayed as one CUDA graph a microbatch count, the stacked
layout in its state and checkpoints; the log line gives its
``bubble_frac``), and a plan it cannot express through the host engine,
with the reason logged in JAX's words (on a CUDA device a dropout plan is
one: a captured graph would repeat its masks). ``train()`` returns which
engine ran, its captures and its recorded program costs under
``"pipeline"``. On a CUDA device with
``model.use_flash_attn`` every layer's attention core is the port's
``flash_sdpa`` (the CUDA kernels K1-K3); ``model.use_fused_ce`` runs the
loss through ``fused_ce_nll`` (K4/K5) and ``parallel.global_checkpoint``
remats every layer under ``model.remat_policy``. A config with
``model.num_experts`` (Mixtral) runs its MoE layers and returns their
router statistics in each step's ``metrics["moe"]``, which the iteration
log prints per layer. BERT trains on masked-LM batches with bidirectional
flash; T5 trains its encoder-decoder pair on the seq2seq split, flash as
the core of the encoder's self-attention, the decoder's causal
self-attention and the cross-attention, and the plan's combined-stack
remat flags split per stack. The run goes to the GPU unless
``device=cpu`` is given.

``parallel.config_mode=json parallel.galvatron_config_path=<plan>`` trains
a plan written by ``cli/search_dist.py`` (``runtime/hybrid_config.py``:
its global batch, chunks and per-layer remat flags; a plan wider than one
device raises by name). The run logs the plan's ``describe()`` and, at
the end, its ``predicted_time_cost_ms`` beside the measured step time
(``profile.profile=1``); ``train()`` returns the prediction too.

Under ``python -m torch.distributed.run --nproc_per_node W -m
hetu_galvatron_tpu_torch.cli.train_dist <yaml> ...`` (or
``parallel/launch.spawn_world``) each process runs one rank of a pp=1
plan over W ranks, in GLOBAL or JSON mode (JAX's pp=1 SPMD branch):
``runtime/initialize.py`` joins the process group (nccl where every rank
has a card, gloo where ranks share one), every rank builds the model from
the seed and keeps its slices, and ``parallel/spmd.SpmdEngine`` runs the
step under the plan's per-layer DP / ZeRO-2 / ZeRO-3 / Megatron TP+SP and
vocab TP, with the flash kernels on each rank's heads and the
vocab-parallel K4/K5. Rank 0 logs and writes the telemetry stream (the
global loss and tokens/s); the other ranks stay quiet. Saving, resuming
and the supervisor's restarts at a world above 1 are ROADMAP item 15b and
raise by name.

The checkpoint and fault lifecycle (JAX ``cli/train_dist.py:391-760`` and
``main`` :1039-1060):

* ``ckpt.save`` with ``ckpt.save_interval`` / ``ckpt.interval_s`` saves
  through ``runtime/checkpoint.py`` (``ckpt.async_save``,
  ``ckpt.snapshot_async``, ``ckpt.keep_last``, ``ckpt.save_timeout_s``);
  ``ckpt.load`` resumes from the newest readable committed step (falling
  back past a corrupt one), restores the AdamW state, the rerun
  machine's history and the data position (``skip_batches`` replays
  ``batches_consumed``), so the resumed run repeats the bits of a run
  that never stopped;
* SIGTERM / SIGINT (``supervisor.graceful_signals``) stop the loop at the
  next step boundary with a checkpoint and exit 18 / 130;
* ``rerun.*`` validates every step's loss before the update (the step is
  split in ``forward_backward`` and the in-place AdamW update, so a
  re-run sees the same leaves) and on a fault saves the untouched state
  and exits 16 or 17; ``rerun.inject_kind`` drills nan / spike / crash /
  preempt once at ``rerun.inject_at_iter``;
* ``chaos.*`` fires the fault plan of ``runtime/chaos.py`` before each
  step and in the save's commit window;
* ``supervisor.auto_restart`` restarts the run in this process
  (``run_with_restarts``) or, with ``supervisor.mode=process``, hands it
  to ``cli/supervise.py``, which relaunches this module per attempt.

The exit code is 0 when training completes, 16 / 17 on a rerun-machine
fault, 18 after a preemption checkpoint, 130 after an operator's SIGINT,
and 1 when the final loss is not finite.

``train.rampup_batch_size=[start, increment, ramp_samples]`` ramps the
global batch size (JAX :343-375): the micro size ``global_bsz / chunks``
stays fixed and only the microbatch count a step varies
(``runtime/microbatches.py``; ``make_forward_backward(chunks=N)``). The
data stream is read in microbatches, so ``batches_consumed`` and the
resume's ``skip_batches`` count microbatches; ``train_state`` carries
``consumed_samples``, and a resume inside the ramp replays the schedule to
restart at the right batch size and data position.

Observability (JAX :160-206, :1018): ``observability.enabled`` writes the
JSONL metrics stream (``observability.metrics_path``) through
``runtime/trainer.make_telemetry`` — tokens/s, step time, MFU, memory,
the ``train/fetch`` / ``train/step`` spans, the profiler's and the
lifecycle's counters, the ``plan`` event and, at exit, the ``goodput/*``
gauges; the goodput tracker's state rides every checkpoint's
``train_state["goodput"]``. A flight recorder (``observability.flight_dir``,
else the stream's directory when enabled) dumps ``flight_<ts>.json`` on a
crash, a rerun-machine exit (``rerun_exit_<code>``) and a trapped signal
(``signal:<name>``, at the step boundary). ``profile.trace_dir`` captures
a ``torch.profiler`` trace of ``profile.trace_iters`` iterations from
``profile.profile_warmup``. The telemetry reads only host floats the loop
already has.

``extra.summary_path=<file>`` appends one JSON line per run to the file:
the exit code, the first step, every loss (exact), each step's global
batch size, evaluation losses, the step time, the checkpoint saves and
load (ms and bytes), the goodput totals, the flight dumps, the kernel
launch counts, the peak device memory and a SHA-256 of every parameter.
It is how ``chip_smoke.py`` reads the children of a supervised drill.

Flags outside this slice raise with their name rather than being ignored:
``ckpt.load_format=hf``; tp overlap and the hierarchical dp reduction;
the logging writers (``logging.tensorboard_dir``,
``logging.wandb_project``) and ``observability.tensorboard``; the plan
audit over a captured trace (``observability.audit`` with
``profile.trace_dir`` — set ``observability.audit=false`` to trace),
``observability.audit_hardware_config`` and
``observability.calibration_dir``. A checkpoint of another world size
raises ``WorldSizeMismatchError``. This module imports torch only inside
its functions, so the cross-process supervisor can share its flag check
without touching the card.
"""

from __future__ import annotations

import hashlib
import json
import math
import sys
from typing import Any, Callable, Dict, Optional

import numpy as np


def unsupported_flags(args) -> list:
    """Names of the set flags this slice of the port does not run."""
    from hetu_galvatron_tpu_torch.core.args_schema import launch_env

    obs = args.observability
    wide = (launch_env() or {}).get("world_size", 1) > 1
    flags = {
        # the lifecycle of a multi-process run is ROADMAP item 15b
        "ckpt.save (world above 1, ROADMAP item 15b)":
            wide and bool(args.ckpt.save),
        "ckpt.load (world above 1, ROADMAP item 15b)":
            wide and bool(args.ckpt.load),
        "supervisor.auto_restart (world above 1, ROADMAP item 15b)":
            wide and args.supervisor.auto_restart,
        "ckpt.load_format": args.ckpt.load_format == "hf",
        "tp_overlap.enable": args.tp_overlap.enable,
        "parallel.hier_dp": args.parallel.hier_dp,
        # multi-slice layouts (JAX's pp + outer dp across DCN)
        "parallel.dcn_slices > 1": args.parallel.dcn_slices > 1,
        "logging.tensorboard_dir": args.logging.tensorboard_dir,
        "logging.wandb_project": args.logging.wandb_project,
        "observability.tensorboard": obs.tensorboard,
        # the plan audit of a captured trace needs the cost model
        "observability.audit (with profile.trace_dir)":
            obs.audit and args.profile.trace_dir,
        "observability.audit_hardware_config": obs.audit_hardware_config,
        "observability.calibration_dir": obs.calibration_dir,
    }
    return [name for name, value in flags.items() if value]


def check_flags(args) -> None:
    bad = unsupported_flags(args)
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)}: not ported to hetu_galvatron_tpu_torch yet "
            "(this slice runs single-device, one-rank-a-stage pipeline and "
            "pp=1 SPMD training with the batch-size ramp, checkpoints, the "
            "fault lifecycle and observability)")


def _concat(mbs):
    """One step's batch from its microbatches, in order."""
    if len(mbs) == 1:
        return mbs[0]
    return {k: np.concatenate([mb[k] for mb in mbs]) for k in mbs[0]}


def attention_overrides(cfg, device, n_layers: Optional[int] = None,
                        cross: bool = False) -> Dict[int, Dict[str, Any]]:
    """Per-layer attention core of ``n_layers`` layers (the decoder stack
    by default): the flash kernels on a CUDA device when
    ``use_flash_attn``, else the plain core. ``cross`` (t5 decoder layers)
    also sets the cross-attention's core."""
    if not (cfg.use_flash_attn and device.type == "cuda"):
        return {}
    from hetu_galvatron_tpu_torch.ops.flash_attention import flash_sdpa

    kw = {"sdpa_fn": flash_sdpa}
    if cross:
        kw["cross_sdpa_fn"] = flash_sdpa
    n = cfg.num_hidden_layers if n_layers is None else n_layers
    return {i: dict(kw) for i in range(n)}


def train(args, on_step: Optional[Callable[[int, Dict[str, Any]], None]]
          = None) -> Dict[str, Any]:
    """Run ``args.train.train_iters`` steps, resuming from ``ckpt.load``;
    ``on_step(it, metrics)`` is called after each step (tools hook timers
    and the profiler here)."""
    import time

    import torch

    from hetu_galvatron_tpu_torch.core.profiler.runtime_profiler import (
        RuntimeProfiler,
    )
    from hetu_galvatron_tpu_torch.models.builder import (
        init_causal_lm,
        named_leaves,
    )
    from hetu_galvatron_tpu_torch.models.modules import compute_dtype_of
    from hetu_galvatron_tpu_torch.observability.goodput import GoodputTracker
    from hetu_galvatron_tpu_torch.observability.registry import (
        get_registry,
        set_registry,
    )
    from hetu_galvatron_tpu_torch.observability.tracing import span
    from hetu_galvatron_tpu_torch.runtime.chaos import make_chaos
    from hetu_galvatron_tpu_torch.runtime.ckpt_paths import clear_resume_pin
    from hetu_galvatron_tpu_torch.runtime.checkpoint import (
        CheckpointCadence,
        latest_checkpoint,
        load_latest_resilient,
        save_checkpoint,
        try_read_checkpoint_meta,
    )
    from hetu_galvatron_tpu_torch.runtime.dataloader import (
        get_train_valid_test_data_iterators,
        skip_batches,
    )
    from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
        get_hybrid_parallel_config,
    )
    from hetu_galvatron_tpu_torch.runtime.initialize import initialize
    from hetu_galvatron_tpu_torch.runtime.microbatches import (
        MicroBatchCalculator,
        MicrobatchIterator,
    )
    from hetu_galvatron_tpu_torch.runtime.optimizer import make_optimizer
    from hetu_galvatron_tpu_torch.runtime.compiled_pipeline import (
        CompiledPipelineEngine,
    )
    from hetu_galvatron_tpu_torch.runtime.pipeline import PipelineEngine
    from hetu_galvatron_tpu_torch.runtime.rerun_machine import (
        FaultDrill,
        RerunDataIterator,
        RerunStateMachine,
    )
    from hetu_galvatron_tpu_torch.runtime.supervisor import PreemptionGuard
    from hetu_galvatron_tpu_torch.runtime.trainer import (
        make_forward_backward,
        make_loss_fn,
        make_telemetry,
        to_device,
    )

    check_flags(args)
    # wall-clock partitioned into productive / recompile / save /
    # resume-replay / restart-lost; snapshots ride every checkpoint
    goodput = GoodputTracker()
    state = initialize(args)
    device = state.device
    hpc = get_hybrid_parallel_config(args, state.world_size)
    state.log(f"parallel plan: {hpc.describe()}")
    pipe = hpc.pp_deg > 1
    spmd = state.distributed
    lead = state.rank == 0  # the rank that logs and writes the streams

    cfg = args.model
    params = init_causal_lm(cfg, seed=args.train.seed, device=device)
    tx = make_optimizer(args.train)
    base_iter, valid_iter, test_iter = get_train_valid_test_data_iterators(
        args, global_batch_size=hpc.global_bsz)
    # batch-size ramp: the micro size gbsz/chunks stays FIXED; only the
    # microbatch count varies per step. The stream is read in
    # microbatches, so the rerun machine's cache and the resume's skip
    # count microbatches
    calc = None
    micro = hpc.global_bsz // hpc.chunks
    if args.train.rampup_batch_size:
        start = int(args.train.rampup_batch_size[0])
        if start < micro and not args.train.decrease_batch_size_if_needed:
            raise ValueError(
                f"rampup start batch size {start} is below the fixed micro "
                f"size global_bsz/chunks = {micro}: the ramp varies the "
                "microbatch COUNT at a constant micro shape, so start must "
                "be >= global_bsz/chunks — lower chunks, raise the start, "
                "or set train.decrease_batch_size_if_needed=true to clamp")
        calc = MicroBatchCalculator(
            hpc.global_bsz, micro, 1, args.train.rampup_batch_size,
            args.train.decrease_batch_size_if_needed)
        state.log(
            f"batch-size ramp: start {calc.start_global_batch_size} "
            f"(running {calc.current_running_global_batch_size}) -> "
            f"{hpc.global_bsz} by {calc.batch_size_increment} over "
            f"{calc.ramp_samples} samples (micro {calc.micro_batch_size})")
        data_iter = RerunDataIterator(MicrobatchIterator(base_iter, micro))
    else:
        data_iter = RerunDataIterator(base_iter)
    # the metrics stream: configures the process-wide registry with the
    # JSONL sink, so the profiler's histograms, the lifecycle's counters
    # and the derived throughput/MFU land in one file
    prev_registry = get_registry()
    telemetry = None
    if args.observability.enabled and lead:
        from hetu_galvatron_tpu_torch.observability.telemetry import (
            emit_plan_telemetry,
        )

        # MFU over the cards the ranks run on: ranks sharing a card
        # share its peak
        telemetry = make_telemetry(
            args, world_size=len(set(state.devices)),
            global_batch_size=hpc.global_bsz)
        if spmd:
            state.log("telemetry: no plan event (the predicted collective "
                      "volume of a plan over several ranks is ROADMAP item "
                      "10b)")
        else:
            emit_plan_telemetry(
                telemetry.registry, hpc, cfg,
                mixed_precision=args.parallel.mixed_precision != "fp32")
        if telemetry.peak_flops:
            state.log(f"telemetry: MFU against "
                      f"{telemetry.peak_flops / 1e12:.0f} TFLOP/s")
    # crash forensics: flight_<ts>.json on crash / trapped signal / rerun
    # halt, in observability.flight_dir or next to the metrics stream
    recorder = None
    if lead and (telemetry is not None or args.observability.flight_dir):
        from hetu_galvatron_tpu_torch.observability.recorder import (
            FlightRecorder,
            flight_dir_of,
        )

        recorder = FlightRecorder(
            registry=telemetry.registry if telemetry is not None else None,
            out_dir=flight_dir_of(args),
            capacity=args.observability.flight_events)
        recorder.note("run_start", plan=hpc.describe(),
                      world=state.world_size)
    compute_dtype = compute_dtype_of(args.parallel.mixed_precision)
    t5 = cfg.model_type == "t5"
    if any(hpc.checkpoint_flags):
        state.log(f"per-layer remat ({cfg.remat_policy}) on "
                  f"{sum(hpc.checkpoint_flags)} of "
                  f"{len(hpc.checkpoint_flags)} layers")
    engine = None
    if pipe and args.pipeline.schedule_impl == "compiled":
        # JAX's engine choice per plan: the compiled schedule where it can
        # express the plan, else the host engine with the reason logged
        reason = CompiledPipelineEngine.unsupported_reason(
            cfg, hpc, data=args.data, device=state.devices[0])
        if reason is not None:
            state.log("pipeline.schedule_impl=compiled cannot express this "
                      f"plan ({reason}); falling back to the host engine")
        else:
            engine = CompiledPipelineEngine(cfg, hpc, args.train,
                                            state.devices,
                                            compute_dtype=compute_dtype)
            state.log(
                "pipeline schedule: compiled single-program 1F1B "
                f"(bubble_frac {engine.bubble_frac():.3f}; {hpc.pp_deg} "
                f"stage lanes on {engine.device}, "
                + ("one CUDA graph a microbatch count" if engine.graphs
                   else "run eagerly off the card")
                + "; attention through "
                + ("the flash kernels (CUDA K1-K3)" if engine.flash
                   else "the plain core")
                + "; every lane's head runs the plain cross-entropy)")
    if pipe and engine is None:
        engine = PipelineEngine(cfg, hpc, args.train, state.devices,
                                compute_dtype=compute_dtype)
        state.log(
            f"pipeline: {len(engine.stages)} chunks on {hpc.pp_deg} stages "
            f"({hpc.pipeline_type}), every stage's attention "
            + ("through the flash kernels (CUDA K1-K3)"
               if engine.stages[0].attn else "through the plain core")
            + "; the head stage runs the plain cross-entropy")
    if spmd:
        from hetu_galvatron_tpu_torch.parallel import comm
        from hetu_galvatron_tpu_torch.parallel.spmd import SpmdEngine

        engine = SpmdEngine(cfg, hpc, args.train, state.rank, device,
                            compute_dtype=compute_dtype)
        # every rank built the whole model from the seed; it keeps its
        # slices
        params = engine.shard_params(params)
        opt_state = engine.init_opt(params)
        tx = engine.tx
        state.log(
            f"SPMD step over {hpc.world_size} ranks, "
            f"{comm.transport(device.type)}: attention through "
            + ("the flash kernels (CUDA K1-K3) on each rank's heads"
               if engine.flash else "the plain core")
            + ("; vocab-parallel cross-entropy over vtp "
               f"{engine.vtp}" if engine.vtp > 1 else "")
            + (" (CUDA K4/K5 per shard)" if cfg.use_fused_ce
               and device.type == "cuda" else ""))

        def forward_backward_for(chunks):
            return lambda p, b: engine.forward_backward(p, b, chunks)

        def apply_update(grads, metrics):
            engine.apply_update(params, opt_state, grads, metrics)

        def eval_loss(batch):
            return engine.eval_loss(params, batch)
    elif pipe:
        # the stage trees (or the stacked tree) take over the model's
        # leaves; from here the run's state is the engine's layout
        params = engine.split_params(params)
        opt_state = engine.init_opt(params)

        def forward_backward_for(chunks):
            return lambda p, b: engine.forward_backward(
                p, b, num_microbatches=chunks)

        def apply_update(grads, metrics):
            engine.apply_update(params, opt_state, grads, metrics)

        def eval_loss(batch):
            return engine.eval_step(params, batch)["loss"]
    else:
        overrides = attention_overrides(cfg, device, cross=t5)
        if overrides:
            state.log("attention: flash kernels (CUDA K1-K3) on every "
                      "layer" + (" (encoder, decoder and cross-attention)"
                                 if t5 else ""))
        if cfg.use_fused_ce:
            state.log("fused cross-entropy: " + (
                "CUDA K4/K5" if device.type == "cuda"
                else "plain versions of K4/K5 (CPU)"))
        moe = bool(cfg.num_experts)
        loss_kw = dict(compute_dtype=compute_dtype,
                       remat_flags=hpc.dec_flags, layer_overrides=overrides)
        if t5:
            # the plan's combined stack, split: its first layers are the
            # encoder's
            loss_kw.update(enc_remat_flags=hpc.enc_flags,
                           enc_layer_overrides=attention_overrides(
                               cfg, device, n_layers=hpc.num_encoder_layers))
        loss_fn = make_loss_fn(cfg, **loss_kw)
        step_loss_fn = make_loss_fn(cfg, with_moe_stats=moe, **loss_kw)
        # one step per microbatch count (the ramp's), built on first use
        steps_by_chunks = {hpc.chunks: make_forward_backward(
            step_loss_fn, chunks=hpc.chunks, aux_stats=moe)}

        def forward_backward_for(chunks):
            if chunks not in steps_by_chunks:
                steps_by_chunks[chunks] = make_forward_backward(
                    step_loss_fn, chunks=chunks, aux_stats=moe)
            return steps_by_chunks[chunks]

        names, leaves = zip(*named_leaves(params))
        leaves = list(leaves)
        opt_state = tx.init(leaves, names)

        def apply_update(grads, metrics):
            tx.update(leaves, grads, opt_state, metrics["grad_norm"])

        def eval_loss(batch):
            with torch.no_grad():
                return float(loss_fn(params, batch))
    profiler = RuntimeProfiler(args, device=device, rank=state.rank)
    use_dropout = cfg.hidden_dropout > 0.0 or cfg.attention_dropout > 0.0
    rerun = RerunStateMachine(args.rerun)
    # SIGTERM/SIGINT become a checkpoint-and-exit at the next step boundary
    guard = PreemptionGuard(enabled=args.supervisor.graceful_signals,
                            recorder=recorder)
    drill = FaultDrill(args.rerun)
    chaos = make_chaos(args, log=state.log)
    if chaos is not None:
        chaos.install()
        state.log(f"chaos: armed faults {chaos.pending()}")
    ck = args.ckpt
    cadence = CheckpointCadence(
        ck, hpc=hpc, goodput=goodput, log=state.log,
        hooks=chaos.save_hooks() if chaos is not None else None)
    reg = get_registry()
    ckpt_log: Dict[str, Any] = {"saves": [], "load": None}
    consumed = 0  # samples, under a ramp

    def device_batch(raw, it):
        batch = to_device(raw, device)
        if use_dropout:
            # per-iteration stream, reproducible from (seed, it): a re-run
            # of the step draws the same masks from a fresh generator
            batch["dropout_rng"] = torch.Generator(device=device).manual_seed(
                args.train.seed * 1_000_003 + it)
        return batch

    def train_state_at(step, batches, samples):
        """The full-state-resume payload of meta.json: the data position
        (committed batches, or consumed samples under a ramp), the seed
        the dropout streams derive from, the goodput totals as of this
        commit, the rerun machine's fault history."""
        ts = {"step": step, "seed": args.train.seed, "telemetry_step": step,
              "batches_consumed": batches if calc is None else None,
              "consumed_samples": samples if calc is not None else None,
              "goodput": goodput.state_dict()}
        if rerun.enabled:
            ts["rerun"] = rerun.state_dict()
        return ts

    def save_now(step, batches, samples):
        """A synchronous save outside the cadence (preemption, fault)."""
        with goodput.measure("checkpoint_save"):
            cadence.drain()  # never race an in-flight save
            save_checkpoint(ck.save, step, params, opt_state, hpc=hpc,
                            train_state=train_state_at(step, batches,
                                                       samples),
                            keep_last=ck.keep_last, hooks=cadence.hooks)
        record_save(step, sync=True)

    def record_save(step, sync):
        rec = {"step": step}
        if sync:
            rec.update(ms=reg.gauge("checkpoint/save_ms").value,
                       bytes=int(reg.gauge("checkpoint/save_bytes").value))
        ckpt_log["saves"].append(rec)
        state.log(f"saved checkpoint at iter {step}" + (
            f" ({rec['bytes'] / 1e9:.2f} GB in {rec['ms']:.0f} ms)"
            if sync else ""))

    def maybe_resume():
        """Restore params, AdamW state, goodput, rerun history and data
        position; returns (first iteration to run, consumed samples)."""
        if not ck.load or latest_checkpoint(ck.load) is None:
            return 0, 0
        # a checkpoint of another world size raises WorldSizeMismatchError
        # (the elastic path is not ported); corruption falls back to the
        # previous committed step
        with goodput.measure("resume_replay"):
            res = load_latest_resilient(
                ck.load, params, opt_state, hpc=hpc,
                strict_plan=ck.distributed_checkpoint,
                expected_world=hpc.world_size, log=state.log)
        if res is None:
            state.log(f"warning: {ck.load}: committed checkpoint vanished "
                      "before resume; starting fresh")
            return 0, 0
        _, _, start, ckdir = res
        ckpt_log["load"] = {
            "step": start, "dir": ckdir,
            "ms": reg.gauge("checkpoint/load_ms").value,
            "bytes": int(reg.gauge("checkpoint/load_bytes").value)}
        state.log(f"resumed from {ckdir} at iter {start}")
        # the supervisor's cross-process GC lease protected this restore;
        # now that the read landed, retention may proceed
        clear_resume_pin(ck.load)
        meta, meta_err = try_read_checkpoint_meta(ckdir)
        if meta_err is not None:
            state.log(f"warning: {ckdir}/meta.json unreadable ({meta_err}); "
                      "resuming without the train_state payload (position "
                      "reconstructed from the step number)")
        stored = meta.get("hybrid_parallel_config") or {}
        ts = meta.get("train_state") or {}
        if ts.get("goodput"):
            # committed totals; the wall gap since the commit lands in
            # restart_lost
            goodput.load_state_dict(ts["goodput"])
        if recorder is not None:
            recorder.note("resume", ckdir=ckdir, step=start)
        if ts.get("seed") not in (None, args.train.seed):
            state.log(f"warning: checkpoint seed {ts['seed']} != current "
                      f"{args.train.seed}: the replayed data stream and "
                      "dropout streams will differ from the original run")
        if ts.get("rerun") and rerun.enabled:
            rerun.load_state_dict(ts["rerun"])
        sbsz = stored.get("global_bsz")
        if calc is not None:
            # replay the ramp: skip exactly the microbatches the original
            # run consumed over its first `start` iterations
            if (sbsz not in (None, hpc.global_bsz)
                    or stored.get("chunks") not in (None, hpc.chunks)):
                state.log(
                    "warning: resuming a RAMPED run with a different batch "
                    f"geometry (stored global_bsz/chunks {sbsz}/"
                    f"{stored.get('chunks')} vs current {hpc.global_bsz}/"
                    f"{hpc.chunks}): the replayed data schedule will not "
                    "match the original run")
            samples = 0
            for _ in range(start):
                calc.update(samples)
                samples += calc.current_running_global_batch_size
            if ts.get("consumed_samples") not in (None, samples):
                state.log(
                    f"warning: replayed ramp consumed {samples} samples but "
                    f"the checkpoint recorded {ts['consumed_samples']}: the "
                    "ramp schedule changed since the original run")
            if telemetry is not None:
                telemetry.resume_from(ts.get("telemetry_step", start),
                                      samples=samples)
            with goodput.measure("resume_replay"):
                skip_batches(data_iter, samples // micro)
            return start, samples
        skip = ts.get("batches_consumed")
        if skip is None:
            skip = start  # no train_state: position := step
        resumed_samples = None
        if sbsz and sbsz != hpc.global_bsz:
            # skip the SAMPLES the original run consumed
            resumed_samples = skip * sbsz
            skip = int(math.ceil(skip * sbsz / hpc.global_bsz))
            state.log(f"warning: resuming a run trained at global_bsz "
                      f"{sbsz} with global_bsz {hpc.global_bsz}; "
                      f"fast-forwarding {skip} batches to preserve data "
                      "order")
        elif stored.get("chunks") not in (None, hpc.chunks):
            state.log(f"warning: checkpoint chunks {stored.get('chunks')} "
                      f"!= current {hpc.chunks}; gradient accumulation "
                      "boundaries will differ from the original run")
        if telemetry is not None:
            telemetry.resume_from(ts.get("telemetry_step", start),
                                  samples=resumed_samples)
        with goodput.measure("resume_replay"):
            skip_batches(data_iter, skip)
        return start, 0

    def run_eval(iterator) -> float:
        vs = [eval_loss(to_device(next(iterator), device))
              for _ in range(max(args.train.eval_iters, 1))]
        return float(np.mean(vs))

    try:
        start_iter, consumed = maybe_resume()
    except BaseException:
        if chaos is not None:
            chaos.uninstall()  # its I/O faults also reach the resume reads
        if telemetry is not None:
            telemetry.close()
            telemetry.registry.close()  # the stream's file descriptor
            set_registry(prev_registry)
        raise
    losses, val_losses, batch_sizes = [], [], []
    exit_code = None
    drill.arm(start_iter)
    guard.__enter__()
    try:
        for it in range(start_iter, args.train.train_iters):
            profiler.time_start(it)
            it_t0 = time.perf_counter()
            batches_prev, consumed_prev = data_iter.batches_consumed, consumed
            if chaos is not None:
                # before the update: 'crash at step k' loses exactly the
                # steps since the last commit
                chaos.on_step(it)
            with span("train/fetch"):
                if calc is not None:
                    if calc.update(consumed):
                        state.log(
                            "ramping global batch size to "
                            f"{calc.current_running_global_batch_size} "
                            f"({calc.num_micro_batches} microbatches)")
                    chunks = calc.num_micro_batches
                    raw = _concat([next(data_iter) for _ in range(chunks)])
                    consumed += calc.current_running_global_batch_size
                else:
                    chunks = hpc.chunks
                    raw = next(data_iter)
                batch = device_batch(raw, it)
            forward_backward = forward_backward_for(chunks)
            with span("train/step"):
                grads, metrics = forward_backward(params, batch)
                if not rerun.enabled:
                    # nothing judges the loss: enqueue the update before
                    # the host waits for the loss
                    apply_update(grads, metrics)
            loss_host = float(metrics["loss"])  # waits for the step
            # the drill may corrupt the loss (nan / spike), raise
            # InjectedCrash or deliver a real SIGTERM to this process
            lossf = drill.apply(loss_host, it)
            # the rerun machine judges the loss before the in-place update
            # and may re-run forward and backward on the same leaves and
            # the same (rebatched) batch
            rerun.validate_result(
                lossf, it,
                rerun_fn=((lambda: float(forward_backward(
                    params, device_batch(raw, it))[1]["loss"]))
                    if rerun.enabled else None),
                data_iterator=data_iter)
            exit_code = rerun.exit_code_requested()
            if rerun.enabled and exit_code is None:
                apply_update(grads, metrics)
            del grads
            profiler.time_end(it)
            # the step's wall; each attempt's first iteration pays kernel
            # loads and allocator warm-up, booked as recompile
            goodput.add("recompile" if it == start_iter
                        else "productive_step", time.perf_counter() - it_t0)
            log_metrics = metrics
            if telemetry is not None or profiler.printing(it):
                # the one host read of the norm, shared by log and stream
                log_metrics = dict(metrics,
                                   grad_norm=float(metrics["grad_norm"]))
            if telemetry is not None:
                if calc is not None:
                    # tokens a step follow the RUNNING batch size
                    telemetry.global_batch_size = \
                        calc.current_running_global_batch_size
                telemetry(it, {"loss": loss_host,
                               "grad_norm": log_metrics["grad_norm"]})
            profiler.iteration_log(it, log_metrics, lr=tx.schedule(it))
            data_iter.advance()
            losses.append(lossf)
            batch_sizes.append(len(next(iter(raw.values()))))
            if on_step is not None:
                on_step(it, metrics)
            if exit_code is not None:
                # a fault: the update was not applied, so the leaves hold
                # the state before iteration `it`; save it there, with the
                # position before its batch, and let the relaunch re-run it
                state.log(f"rerun machine requested exit (code "
                          f"{exit_code}); checkpointing pre-fault state")
                if recorder is not None:
                    recorder.dump(f"rerun_exit_{exit_code}")
                if ck.save:
                    save_now(it, batches_prev, consumed_prev)
                break
            if (valid_iter is not None and args.train.eval_interval
                    and (it + 1) % args.train.eval_interval == 0):
                v = run_eval(valid_iter)
                val_losses.append({"iter": it + 1, "loss": v})
                state.log(f"iter {it + 1}: validation loss {v:.4f}")
            if cadence.due(it):
                cadence.save(it + 1, params, opt_state,
                             train_state=train_state_at(
                                 it + 1, data_iter.batches_consumed,
                                 consumed))
                record_save(it + 1, sync=not (ck.async_save
                                              or ck.snapshot_async))
            if guard.requested():
                # preemption / interrupt at a step boundary: checkpoint the
                # post-update state at it + 1 (unless the cadence just did)
                exit_code = guard.exit_code()
                state.log("stop signal received; checkpointing at iter "
                          f"{it + 1} and exiting (code {exit_code})")
                if ck.save and not (ck.save_interval and
                                    (it + 1) % ck.save_interval == 0):
                    save_now(it + 1, data_iter.batches_consumed, consumed)
                break
    except BaseException as e:
        # crash forensics BEFORE re-raising: the dump is atomic and
        # dump() never raises, so the original fault surfaces untouched
        if recorder is not None:
            recorder.dump("crash", exc=e)
        raise
    finally:
        guard.__exit__()
        pipe_record = pipeline_record(engine)
        if hasattr(engine, "release"):
            # the captured graphs' pool holds a step's peak between replays
            engine.release()
        if chaos is not None:
            chaos.uninstall()
        try:
            # drain async saves even on the crash path: an in-process
            # restart must never inherit live background writes; the
            # blocking drain is checkpoint time
            with goodput.measure("checkpoint_save"):
                cadence.drain()
        except Exception as e:  # noqa: BLE001 — never mask the crash
            state.log(f"warning: async checkpoint drain failed: {e}")
        # crash-safe: flush an open trace window and the metrics stream
        profiler.stop_trace()
        if telemetry is not None:
            # the goodput partition before the final flush, so the last
            # records in the stream carry it
            goodput.flush(telemetry.registry)
            telemetry.close()
            telemetry.registry.close()  # the stream's file descriptor
            set_registry(prev_registry)
    test_loss = None
    if test_iter is not None and losses and exit_code is None:
        test_loss = run_eval(test_iter)
        state.log(f"test loss {test_loss:.4f}")
    if args.profile.profile:
        state.log(f"mean iter time: {profiler.filtered_time_ms():.2f} ms")
    predicted = hpc.predicted_time_cost_ms
    if predicted is not None:
        measured = profiler.filtered_time_ms()
        state.log(f"searched plan: predicted step {predicted:.3f} ms" + (
            f", measured {measured:.3f} ms (measured / predicted "
            f"{measured / predicted:.3f})" if measured else
            " (profile.profile=1 measures the step)"))
    if rerun.enabled and rerun.records:
        state.log(f"rerun report: {rerun.report()}")
    return {"losses": losses, "val_losses": val_losses,
            "test_loss": test_loss, "iter_ms": profiler.filtered_time_ms(),
            "params": params, "opt_state": opt_state,
            "start_iter": start_iter, "checkpoint": ckpt_log,
            "rerun": rerun.report() if rerun.enabled else None,
            "batch_sizes": batch_sizes, "consumed_samples": consumed,
            "goodput": {"totals": dict(goodput.totals),
                        "frac": goodput.goodput(),
                        "restarts_survived": goodput.restarts_survived},
            "flight_dumps": list(recorder.dumped) if recorder else [],
            "trace_path": profiler.trace_path,
            "trace_window_ms": profiler.trace_window_ms,
            "predicted_time_cost_ms": predicted,
            "pipeline": pipe_record,
            "rank": state.rank, "world_size": state.world_size,
            "engine": engine if spmd else None,
            "exit_code": exit_code}


def pipeline_record(engine) -> Optional[Dict[str, Any]]:
    """Which pipeline engine ran, with the compiled engine's captures,
    ``bubble_frac`` and recorded program costs (None at pp=1)."""
    if engine is None or not hasattr(engine, "split_params"):
        return None
    if not hasattr(engine, "compile_count"):
        return {"schedule": "host"}
    return {"schedule": "compiled", "compile_count": engine.compile_count(),
            "bubble_frac": engine.bubble_frac(),
            "program_costs": engine.program_costs()}


def _exit_code(out: Dict[str, Any]) -> int:
    if out.get("exit_code") is not None:
        return out["exit_code"]  # the 16/17/18/130 contract
    if not out["losses"]:
        return 0
    return 0 if np.isfinite(out["losses"][-1]) else 1


def _finish(out: Dict[str, Any]) -> int:
    if out.get("exit_code") is None and not out.get("rank"):
        if not out["losses"]:
            print("training done: 0 iters (nothing left to train)")
        else:
            print(f"training done: {len(out['losses'])} iters, final loss "
                  f"{out['losses'][-1]:.4f}")
    return _exit_code(out)


def run_summary(out: Dict[str, Any], code: int) -> Dict[str, Any]:
    """The JSON record ``extra.summary_path`` appends for one run."""
    import torch

    from hetu_galvatron_tpu_torch.models.builder import named_leaves
    from hetu_galvatron_tpu_torch.ops import _build

    digests = {}
    for name, t in named_leaves(out["params"]):
        digests[name] = hashlib.sha256(
            t.detach().cpu().contiguous().numpy()).hexdigest()
    leaf = next(iter(named_leaves(out["params"])))[1]
    cuda = leaf.is_cuda
    return {
        "exit_code": code, "start_iter": out["start_iter"],
        "losses": out["losses"], "val_losses": out["val_losses"],
        "test_loss": out["test_loss"], "iter_ms": out["iter_ms"],
        "batch_sizes": out["batch_sizes"],
        "consumed_samples": out["consumed_samples"],
        "checkpoint": out["checkpoint"], "rerun": out["rerun"],
        "goodput": out["goodput"], "flight_dumps": out["flight_dumps"],
        "launches": dict(_build.launch_counts),
        "device": torch.cuda.get_device_name(leaf.device) if cuda else "cpu",
        "peak_mem_bytes": (torch.cuda.max_memory_allocated(leaf.device)
                           if cuda else None),
        "param_sha256": digests,
    }


def _run_once(args) -> Dict[str, Any]:
    """One attempt; appends its summary line when asked to."""
    out = train(args)
    path = args.extra.get("summary_path")
    if path and not out.get("rank"):
        with open(path, "a") as f:
            f.write(json.dumps(run_summary(out, _exit_code(out))) + "\n")
    return out


def main(argv=None) -> int:
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli

    base_argv = list(argv if argv is not None else sys.argv[1:])
    args = args_from_cli(base_argv, mode="train_dist")
    check_flags(args)
    sup = args.supervisor
    if sup.auto_restart and sup.mode == "process":
        # the production restart loop: cli/supervise.py relaunches this
        # module as a child per attempt; nothing here has touched torch
        from hetu_galvatron_tpu_torch.cli.supervise import run_supervised

        return run_supervised(args, base_argv)
    if not sup.auto_restart:
        return _finish(_run_once(args))

    # in-process restarts: 16 / 18 and crashes resume from the last
    # committed checkpoint, 17 and 130 surface
    from hetu_galvatron_tpu_torch.runtime.checkpoint import latest_checkpoint
    from hetu_galvatron_tpu_torch.runtime.supervisor import run_with_restarts

    last: Dict[str, Any] = {}

    def attempt() -> int:
        if args.ckpt.save and (not args.ckpt.load
                               or latest_checkpoint(args.ckpt.save)):
            # resume from this run's own progress as soon as it has a
            # committed checkpoint
            args.ckpt.load = args.ckpt.save
        out = _run_once(args)
        last["out"] = out
        return out.get("exit_code") or 0

    rc = run_with_restarts(
        attempt, max_restarts=sup.max_restarts,
        base_delay=sup.backoff_base_s, max_delay=sup.backoff_max_s,
        restart_on_error=sup.restart_on_error,
        # the budget bounds crash LOOPS: an attempt that committed a new
        # checkpoint resets the restart counter
        progress_fn=((lambda: latest_checkpoint(args.ckpt.save))
                     if args.ckpt.save else None))
    if rc != 0:
        return rc
    return _finish(last["out"])


if __name__ == "__main__":
    sys.exit(main())
