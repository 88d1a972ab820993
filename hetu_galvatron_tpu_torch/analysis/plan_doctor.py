"""The plan doctor: static per-layer engine/kernel diagnosis of a plan.

Port of ``hetu_galvatron_tpu/analysis/plan_doctor.py``: ``LayerDiagnosis``
:34, ``PlanDoctorReport`` :46 with ``render``, ``_attention_kernel`` :88
and ``diagnose_plan`` :103, with the duck-typed hpc view JAX builds for
the shared predicates of ``analysis/eligibility.py``.

Given a plan JSON and a model config (no device, no training step) it
reports what JAX's runtime does with the plan: the pipeline engine
(compiled 1F1B, host-sequenced, or the pp = 1 SPMD path) and why, each
layer's attention kernel and projection path, and every structural
problem, with malformed JSONs reported by the offending key
(``utils.strategy.PlanFormatError``), never by a traceback. Plans wider
than one device are diagnosed exactly as JAX diagnoses them: the doctor
reads the plan, not the runtime.

The one difference from JAX's report: where the port's runtime refuses
the plan today (``runtime/hybrid_config.py::check_plan_width``: cp,
Ulysses or ep layers, a pipeline stage wider than one rank or a world
other than ``pp_deg`` under pp, ``hier_dp``), the report adds one warning
that quotes the refusal and its ROADMAP item, so the doctor never tells a
user that the port runs a plan it refuses. pp=1 plans of tp, dp and ZeRO
over any world get none: ``parallel/spmd.py`` runs them.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

from hetu_galvatron_tpu_torch.analysis import eligibility
from hetu_galvatron_tpu_torch.utils.strategy import (
    PlanFormatError,
    config2strategy,
    default_pp_division,
    form_strategy,
    load_strategy_config,
)


@dataclass
class LayerDiagnosis:
    """What one decoder layer will get at runtime."""

    index: int
    stage: int
    strategy: str       # form_strategy text
    attention: str      # ring / ring(zigzag) / ulysses_a2a / flash / xla
    projections: str    # ring_overlap / gspmd
    overlap_reason: Optional[str] = None  # why projections stay on gspmd


@dataclass
class PlanDoctorReport:
    """The doctor's full verdict; ``ok`` is False only for plans the
    runtime would REJECT (fallbacks to another engine are warnings)."""

    plan: str
    world_size: Optional[int] = None
    ok: bool = True
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    engine: Optional[str] = None         # compiled | host | spmd
    engine_reason: Optional[str] = None  # why not the compiled engine
    summary: Optional[str] = None        # hpc.describe()-style line
    layers: List[LayerDiagnosis] = field(default_factory=list)

    def render(self, out=None) -> None:
        out = out or sys.stdout
        w = lambda s="": print(s, file=out)
        w(f"== plan doctor: {self.plan} (world {self.world_size}) ==")
        for e in self.errors:
            w(f"ERROR: {e}")
        for x in self.warnings:
            w(f"warning: {x}")
        if self.summary:
            w(f"plan: {self.summary}")
        if self.engine:
            line = f"pipeline engine: {self.engine}"
            if self.engine_reason:
                line += f" ({self.engine_reason})"
            w(line)
        if self.layers:
            w(f"{'layer':<7}{'stage':<7}{'attention':<16}"
              f"{'projections':<14}strategy")
            for d in self.layers:
                w(f"{d.index:<7}{d.stage:<7}{d.attention:<16}"
                  f"{d.projections:<14}{d.strategy}")
            for d in self.layers:
                if d.overlap_reason:
                    w(f"  layer {d.index}: gspmd projections — "
                      f"{d.overlap_reason}")
        w("plan doctor: " + ("OK" if self.ok else "FAILED"))


def _attention_kernel(s: Any, cfg: Any, cp_zigzag: bool) -> str:
    """Mirror ``parallel.spmd.attention_overrides`` /
    ``CompiledPipelineEngine._build_attention_core`` dispatch, statically:
    cp layers get ring attention, Ulysses layers the head-scatter a2a
    sandwich, flash-enabled models the flash kernel, else the plain core.
    The labels are JAX's report text ("flash(tpu)" names JAX's Pallas
    kernel, whose counterpart here is K1, ``csrc/flash_fwd.cu``)."""
    if s.cp_size > 1:
        return "ring(zigzag)" if cp_zigzag else "ring"
    if s.sp and s.tp_size > 1:
        return "ulysses_a2a"
    if cfg.use_flash_attn:
        return "flash(tpu)"
    return "xla"


def port_refusal(name: str, layers: List[Any], vocab: Any,
                 extras: Dict[str, Any], world_size: int) -> Optional[str]:
    """The refusal the port's runtime raises for this plan today (its
    ``check_plan_width`` over the world-less parse at this world, as
    ``get_hybrid_parallel_config`` runs it), or None when the port runs
    it."""
    from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
        check_plan_width,
    )

    try:
        check_plan_width(name, layers, vocab, extras, world_size=world_size)
    except NotImplementedError as e:
        return str(e)
    return None


def diagnose_plan(
    plan: Union[str, Dict[str, Any]],
    model_cfg: Any,
    world_size: Optional[int] = None,
    *,
    schedule_impl: str = "compiled",
    tp_overlap: bool = True,
    cp_zigzag: bool = False,
    data: Any = None,
) -> PlanDoctorReport:
    """Diagnose one plan against one model config.

    ``plan`` is a path to a plan JSON or an already-loaded dict.
    ``world_size`` defaults to the plan's own axis product (layer 0's
    pp*tp*cp*dp cannot be derived without it, so when omitted the smallest
    world the plan can run on is assumed and reported).
    ``schedule_impl``/``tp_overlap``/``cp_zigzag`` mirror the launcher
    knobs so the doctor predicts the engine the launcher would pick.
    Never raises on a malformed plan — problems land in ``report.errors``.
    """
    name = plan if isinstance(plan, str) else "<dict>"
    report = PlanDoctorReport(plan=name, world_size=world_size)

    try:
        cfg = load_strategy_config(plan) if isinstance(plan, str) else plan
    except PlanFormatError as e:
        report.ok = False
        report.errors.append(str(e))
        return report

    # -- parse (typed errors; never a KeyError traceback) -----------------
    try:
        # parse WITHOUT world first: a format-valid plan that merely
        # mismatches the world below still gets its per-layer table
        # (dp sizes unresolved), and the smallest-world default needs the
        # degrees before any world exists
        layers, vocab, extras = config2strategy(cfg)
    except (PlanFormatError, ValueError) as e:
        report.ok = False
        report.errors.append(str(e))
        return report
    bare = (layers, vocab, extras)

    pp_deg = layers[0].pp_deg
    if world_size is None:
        # smallest world the plan can express: pp * max(tp*cp) per layer
        world_size = pp_deg * max(
            s.tp_size * s.cp_size for s in layers)
        report.world_size = world_size
        report.warnings.append(
            f"no --world given; assuming the smallest world the plan fits "
            f"({world_size} devices)")
    try:
        layers, vocab, extras = config2strategy(cfg, world_size=world_size)
    except (PlanFormatError, ValueError) as e:
        # keep the world-less parse for the table; the dp degrees it
        # shows are the all-ones defaults, not resolved against the world
        report.ok = False
        report.errors.append(str(e))
        report.warnings.append(
            "plan does not fit the world size; the per-layer table below "
            "shows UNRESOLVED dp degrees (dp1)")

    n_layers = len(layers)
    model_layers = model_cfg.num_hidden_layers
    n_enc = 0
    if model_cfg.model_type == "t5":
        n_enc = (model_cfg.num_encoder_layers
                 if model_cfg.num_encoder_layers is not None
                 else model_cfg.num_hidden_layers)
        model_layers += n_enc
    if n_layers != model_layers:
        report.ok = False
        report.errors.append(
            f"plan has {n_layers} layers, model has {model_layers} "
            f"(encoder {n_enc} + decoder {model_cfg.num_hidden_layers})")
    if extras["num_encoder_layers"] not in (None, n_enc):
        report.ok = False
        report.errors.append(
            f"plan was searched for {extras['num_encoder_layers']} encoder "
            f"layers, model has {n_enc}")

    global_bsz = extras["global_bsz"]
    chunks = max(extras["chunks"], 1)
    vpp = max(extras.get("vpp_deg", 1), 1)
    pp_division = (extras["pp_division"]
                   or default_pp_division(n_layers, pp_deg * vpp))

    # -- structural checks (ALL of them, not just the first) --------------
    structural = eligibility.plan_structure_reasons(
        layers=layers, vocab=vocab, pp_deg=pp_deg, vpp_deg=vpp,
        pp_division=pp_division, n_layers=n_layers, world_size=world_size,
        global_bsz=global_bsz)
    if structural:
        report.ok = False
        report.errors.extend(structural)
    if global_bsz and global_bsz % chunks:
        report.ok = False
        report.errors.append(
            f"global_bsz {global_bsz} not divisible by chunks {chunks} "
            "(microbatches must be equal-shaped)")
    if pp_deg > 1 and chunks < pp_deg:
        report.warnings.append(
            f"chunks {chunks} < pp_deg {pp_deg}: the 1F1B schedule cannot "
            "fill the pipeline (the memory cost model rejects this shape)")

    # -- engine choice (the launcher's exact decision) --------------------
    class _Hpc:  # duck-typed view for the shared predicates
        pass

    hpc = _Hpc()
    hpc.layers, hpc.vocab, hpc.pp_deg = layers, vocab, pp_deg
    hpc.pp_division = pp_division
    hpc.pipeline_type = extras["pipeline_type"]
    hpc.vpp_deg = vpp
    hpc.chunks, hpc.global_bsz = chunks, global_bsz

    if pp_deg <= 1:
        report.engine = "spmd"
    elif schedule_impl == "compiled":
        reason = eligibility.compiled_unsupported_reason(
            model_cfg, hpc, data)
        if reason is None:
            report.engine = "compiled"
        else:
            report.engine = "host"
            report.engine_reason = reason
            report.warnings.append(
                "pipeline.schedule_impl=compiled cannot express this plan "
                f"({reason}); the launcher will fall back to the host "
                "engine")
    else:
        report.engine = "host"

    # -- per-layer kernel dispatch ----------------------------------------
    overlap = dict(eligibility.plan_overlap_reasons(model_cfg, hpc)) \
        if tp_overlap else {}
    stage_of: List[int] = []
    for stage, n in enumerate(pp_division):
        stage_of.extend([stage % max(pp_deg, 1)] * n)
    for i, s in enumerate(layers):
        reason = overlap.get(i) if tp_overlap else \
            "tp_overlap.enable is off"
        report.layers.append(LayerDiagnosis(
            index=i,
            stage=stage_of[i] if i < len(stage_of) else -1,
            strategy=form_strategy(s),
            attention=_attention_kernel(s, model_cfg, cp_zigzag),
            projections=("ring_overlap" if tp_overlap and reason is None
                         else "gspmd"),
            overlap_reason=reason,
        ))

    refusal = port_refusal(name, *bare, world_size)
    if refusal is not None:
        report.warnings.append(f"the port's runtime refuses this plan "
                               f"today: {refusal}")

    from hetu_galvatron_tpu_torch.utils.strategy import print_strategies

    report.summary = (
        f"pp{pp_deg} chunks{chunks} bsz{global_bsz} "
        f"[{print_strategies(layers)}] vocab(vtp{vocab.vtp}"
        f"{' vsp' if vocab.vsp else ''})")
    return report
