"""The memory doctor: static per-device peak-memory accounting of a plan.

Port of ``hetu_galvatron_tpu/analysis/memory_doctor.py``, all of it: the
per-sample helpers (:84-140), ``StageMemory`` :160, ``plan_stage_memory``
:171, ``peak_mb`` :304, ``search_result_hbm_reason`` :308,
``hbm_budget_reason`` :341, ``_cost_context`` :358,
``cross_check_cost_model`` :417, ``MemoryDoctorReport`` :522 with
``render``, and ``diagnose_memory`` :574. The arithmetic is JAX's, in
JAX's order and in Python floats, so the same plan and model give the
same megabytes and the same report text.

Given a plan JSON and a model config (no device, no training step) it
accounts every resident byte per device and per pipeline stage:

* **model states** — params + grads + two Adam moments (the cost model's
  ``4 x`` fp32 convention) under each layer's weight sharding (ZeRO-2/3
  by the cost model's own ``_zero_ratios``);
* **activations** — the saved-for-backward working set per layer
  (:func:`activation_per_sample_mb`) times the in-flight microbatches,
  sequence-sharded over tp_sp and cp; remat layers keep their input;
* **stage-input buffer** and **vocab replication** — the compiled 1F1B
  engine's (``schedule_impl="compiled"``, the default, as in JAX: the
  conservative convention the search's HBM gate also uses). The port has
  no pipeline engine yet (ROADMAP item 12); at pp = 1 both are zero;
* **KV pool (serving mode)** — through the port's
  ``serving/kv_cache.py::kv_pool_mb`` and ``resolve_num_blocks``, the
  helpers the serving engine sizes its pool with.

Each training component is cross-checked against the cost model's
``layer_memory_components`` / ``embed_memory_components`` on a
``CostContext`` built from the same analytic quantities. The
``--hbm-gb`` gate of ``cli/check.py`` and the search engine's
``_hbm_gate`` evaluate one predicate (:func:`search_result_hbm_reason`
over :func:`hbm_budget_reason`). :func:`diagnose_memory` never raises on
a malformed plan: every problem lands in ``report.errors``.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from hetu_galvatron_tpu_torch.utils.strategy import (
    EmbeddingLMHeadStrategy,
    LayerStrategy,
    PlanFormatError,
    config2strategy,
    default_pp_division,
    load_strategy_config,
)

MB = 1024 * 1024

# the component keys one stage row carries, in render order
STAGE_COMPONENTS = (
    "model_states_mb", "activation_mb", "stage_buffer_mb",
    "vocab_states_mb", "vocab_activation_mb", "kv_pool_mb",
)


# ---------------------------------------------------------------------------
# analytic per-layer quantities (pure model arithmetic, no profile needed)
# ---------------------------------------------------------------------------


def activation_per_sample_mb(model: Any, elem_bytes: int = 2) -> float:
    """Saved-for-backward activation megabytes per sample for ONE decoder
    layer at tp_sp = 1: the inputs of every projection matmul plus the two
    norm inputs, with flash-style attention (scores/probabilities never
    materialized — q/k/v and the context output are what survive).

    Terms (seq s, hidden h, q-heads*head_dim nd, kv-heads*head_dim kd,
    ffn f, gated doubles the fc1 output):
    norm1_in + qkv_in + q/k/v + context_out + proj_out
    + norm2_in + fc1_in + fc1_out(s) + act_out + fc2_out.
    """
    s, h = model.seq_length, model.hidden_size
    nd = model.num_attention_heads * model.head_dim
    kd = model.kv_heads * model.head_dim
    f = model.ffn_dim
    gated = model.hidden_act in ("swiglu", "geglu")
    attn = s * h + s * h + s * (nd + 2 * kd) + s * nd + s * h
    mlp = s * h + s * h + s * f * (2 if gated else 1) + s * f + s * h
    return (attn + mlp) * elem_bytes / MB


def checkpoint_per_sample_mb(model: Any, elem_bytes: int = 2) -> float:
    """Per-sample megabytes a remat layer keeps: just its [S, H] stage
    input (the backward recomputes everything else)."""
    return model.seq_length * model.hidden_size * elem_bytes / MB


def vocab_param_mb(model: Any) -> Dict[str, float]:
    """fp32 megabytes of the vocab-row parameter groups at vtp = 1:
    ``embed`` (token table + learned positions), ``prenorm`` (final norm),
    ``head`` (LM projection; tied heads read the embedding table, so the
    last pipeline stage still RESIDES a table-sized copy — the host
    engine materializes it for the head matmul and exchanges the grad)."""
    h = model.hidden_size
    v = model.padded_vocab_size
    embed = v * h
    if model.position_embedding_type == "learned":
        embed += model.max_position_embeddings * h
    prenorm = h * (1 if model.normalization == "rmsnorm" else 2)
    head = v * h  # tied or not, the last stage resides the table
    return {"embed": embed * 4 / MB, "prenorm": prenorm * 4 / MB,
            "head": head * 4 / MB}


def vocab_act_per_sample_mb(model: Any, tp_sp: int,
                            elem_bytes: int = 2) -> Dict[str, float]:
    """Per-sample activation megabytes of the vocab rows at a given
    activation sharding degree: the embedding output on the first stage,
    the pre-norm hidden + the [S, V] logits (vocab-sharded over tp_sp) on
    the last."""
    s, h, v = model.seq_length, model.hidden_size, model.padded_vocab_size
    first = s * h / tp_sp * elem_bytes / MB
    last = (s * h / tp_sp + s * v / tp_sp) * elem_bytes / MB
    return {"first": first, "last": last}


def _zero_scale(dp_type_short: str, sdp: int, chunks: int,
                mixed_precision: bool) -> float:
    """The ZeRO model-states multiplier for one layer — the cost model's
    ``_zero_ratios`` closures (imported, not re-derived: one arithmetic)."""
    from hetu_galvatron_tpu_torch.core.cost_model.cost import _zero_ratios

    z2, z3 = _zero_ratios(chunks, mixed_precision, async_grad_reduce=True)
    if dp_type_short == "zero3":
        return z3(sdp)
    if dp_type_short == "zero2":
        return z2(sdp)
    return 1.0


# ---------------------------------------------------------------------------
# the per-stage accounting
# ---------------------------------------------------------------------------


@dataclass
class StageMemory:
    """One pipeline stage's per-device resident megabytes, by component."""

    stage: int
    components: Dict[str, float] = field(default_factory=dict)

    @property
    def total_mb(self) -> float:
        return sum(self.components.values())


def plan_stage_memory(
    layers: Sequence[LayerStrategy],
    vocab: EmbeddingLMHeadStrategy,
    model: Any,
    *,
    global_bsz: int,
    chunks: int,
    pp_division: Sequence[int],
    pipeline_type: str = "pipedream_flush",
    schedule_impl: str = "compiled",
    mixed_precision: bool = True,
    serving: Any = None,
    kv_elem_bytes: int = 2,
) -> List[StageMemory]:
    """Per-device resident megabytes for every pipeline stage of a
    resolved plan — THE accounting both ``cli/check.py --memory`` and the
    search engine's HBM gate evaluate. Pure arithmetic over plain values;
    callers must pre-validate (or use :func:`diagnose_memory`, which
    wraps this with the never-raise plan-doctor contract)."""
    pp = max(layers[0].pp_deg, 1)
    chunks = max(chunks, 1)
    elem = 2 if mixed_precision else 4
    param_mb = _layer_param_mb(model)
    act1 = activation_per_sample_mb(model, elem)
    ckpt1 = checkpoint_per_sample_mb(model, elem)
    vparams = vocab_param_mb(model)

    stage_of: List[int] = []
    for st, n in enumerate(pp_division):
        stage_of.extend([st % pp] * n)

    out = [StageMemory(stage=st, components={k: 0.0
                                             for k in STAGE_COMPONENTS})
           for st in range(pp)]

    for i, s in enumerate(layers):
        st = stage_of[i] if i < len(stage_of) else pp - 1
        row = out[st].components
        tp_w = 1 if s.sp else s.tp_size        # Ulysses weights replicate
        tp_sp = s.tp_size                      # activation shard degree
        sdp = s.dp_size * s.cp_size * (s.tp_size if s.sp else 1)
        # integer division, UNCLAMPED — the cost model's lbsz arithmetic
        # exactly (a plan whose grain starves a rank shows 0 here and is
        # rejected structurally elsewhere)
        lbsz = global_bsz // chunks // max(s.dp_size, 1)
        if pp == 1:
            cumulative = 1
        else:
            cumulative = (pp - st if pipeline_type == "pipedream_flush"
                          else chunks)
        states = 4 * param_mb / tp_w * _zero_scale(
            s.dp_type.short, max(sdp, 1), chunks, mixed_precision)
        if s.checkpoint:
            act = ckpt1 / max(tp_sp, 1) * cumulative * lbsz
        else:
            act = act1 / max(tp_sp, 1) * cumulative * lbsz
        act /= max(s.cp_size, 1)
        row["model_states_mb"] += states
        row["activation_mb"] += act

    # vocab rows: first/last stage under the host engine and the cost
    # model; the compiled engine replicates embed+prenorm+head on EVERY
    # stage (split_params), so its middle stages pay the premium too
    s0 = layers[0]
    vtp = max(vocab.vtp, 1)
    vcp = max(vocab.vcp, 1)
    stage_world = s0.tp_size * s0.cp_size * s0.dp_size
    vdp = max(stage_world // vtp // vcp, 1)
    v_sdp = max(stage_world // vtp, 1)  # vdp * vcp: the ZeRO shard group
    vscale = _zero_scale("zero3" if vocab.embed_sdp else "ddp",
                         v_sdp, chunks, mixed_precision)
    v_first = 4 * vparams["embed"] / vtp * vscale
    v_last = 4 * (vparams["prenorm"] + vparams["head"]) / vtp * vscale
    v_lbsz = global_bsz // chunks // vdp
    vact = vocab_act_per_sample_mb(model, vtp, elem)
    compiled_replicates = (schedule_impl == "compiled" and pp > 1)
    for st in range(pp):
        row = out[st].components
        if pp == 1:
            row["vocab_states_mb"] += v_first + v_last
            row["vocab_activation_mb"] += (vact["first"] + vact["last"]) \
                * v_lbsz / vcp
            continue
        cum_first = pp if pipeline_type == "pipedream_flush" else chunks
        cum_last = 1 if pipeline_type == "pipedream_flush" else chunks
        if compiled_replicates:
            row["vocab_states_mb"] += v_first + v_last
        else:
            if st == 0:
                row["vocab_states_mb"] += v_first
            if st == pp - 1:
                row["vocab_states_mb"] += v_last
        if st == 0:
            row["vocab_activation_mb"] += vact["first"] * cum_first \
                * v_lbsz / vcp
        if st == pp - 1:
            row["vocab_activation_mb"] += vact["last"] * cum_last \
                * v_lbsz / vcp

    # compiled engine stage-input buffer: depth 2pp-1 circular buffer + 2
    # rotation carries, one [lbsz, S/shard, H] compute-dtype slice each
    if compiled_replicates:
        seq_shard = s0.cp_size if s0.cp_size > 1 else max(s0.tp_size, 1)
        lbsz = max(global_bsz // chunks // max(s0.dp_size, 1), 1)
        slice_mb = (lbsz * model.seq_length / seq_shard
                    * model.hidden_size * elem / MB)
        depth = 2 * pp - 1 + 2
        for st in range(pp):
            out[st].components["stage_buffer_mb"] += depth * slice_mb

    # serving mode: the paged KV pool rides every stage's device (serving
    # is the pp=1 decode path, but the accounting stays general). The
    # pool's element size follows the ENGINE's kv/compute dtype (bf16 by
    # default, kv_elem_bytes to model an override) — NOT the training
    # mixed_precision flag, which governs activations/grads only: an
    # fp32 training diagnosis must not double the predicted pool.
    if serving is not None:
        from hetu_galvatron_tpu_torch.serving.kv_cache import kv_pool_mb

        tp_kv = 1 if s0.sp else s0.tp_size
        pool = kv_pool_mb(serving, model, kv_elem_bytes=kv_elem_bytes,
                          tp=tp_kv)
        for st in range(pp):
            out[st].components["kv_pool_mb"] += pool
    return out


def _layer_param_mb(model: Any) -> float:
    from hetu_galvatron_tpu_torch.observability.telemetry import layer_param_mb

    return layer_param_mb(model)


def peak_mb(stages: Sequence[StageMemory]) -> float:
    return max((st.total_mb for st in stages), default=0.0)


def search_result_hbm_reason(
    strategy_list: Sequence[Any],
    pp_stage_list: Sequence[int],
    model: Any,
    *,
    global_bsz: int,
    chunks: int,
    pipeline_type: str,
    schedule_impl: str,
    hbm_gb: float,
    vocab_tp_sp: int = 1,
    vocab_sp: bool = False,
    vocab_sdp: bool = False,
    mixed_precision: bool = True,
) -> Optional[str]:
    """The search engine's HBM gate: evaluate a candidate plan (a
    ``SearchStrategy`` list + stage partition, the shape ``TaskResult``
    carries) through the SAME per-stage accounting and budget predicate
    ``cli/check.py --memory --hbm-gb`` applies to the written plan JSON —
    search == check parity, the ``analysis/eligibility.py`` discipline.
    None when the plan fits; otherwise :func:`hbm_budget_reason`'s
    string, which the engine logs for the pruned candidate."""
    layers = [s.to_runtime() for s in strategy_list]
    vocab = EmbeddingLMHeadStrategy(
        vtp=max(vocab_tp_sp, 1), vsp=bool(vocab_sp),
        embed_sdp=bool(vocab_sdp))
    stages = plan_stage_memory(
        layers, vocab, model, global_bsz=global_bsz, chunks=chunks,
        pp_division=pp_stage_list, pipeline_type=pipeline_type,
        schedule_impl=schedule_impl, mixed_precision=mixed_precision)
    return hbm_budget_reason(peak_mb(stages), hbm_gb)


def hbm_budget_reason(peak: float, hbm_gb: float) -> Optional[str]:
    """None when the peak fits the budget; otherwise the reason string —
    THE predicate both ``cli/check.py --memory --hbm-gb`` and the search
    engine's pruning hook evaluate (search == check parity)."""
    budget_mb = hbm_gb * 1024.0
    if peak <= budget_mb:
        return None
    return (f"predicted per-device peak {peak:.1f} MB exceeds the "
            f"--hbm-gb budget {hbm_gb:g} GB ({budget_mb:.0f} MB) — the "
            f"plan would OOM at launch")


# ---------------------------------------------------------------------------
# cost-model cross-check
# ---------------------------------------------------------------------------


def _cost_context(model: Any, chunks: int, world_size: int,
                  pipeline_type: str, mixed_precision: bool):
    """A CostContext carrying the SAME analytic quantities this module
    accounts with, so the cross-check isolates ARITHMETIC drift between
    the doctor and the cost model (a profiled context would conflate
    measurement noise with formula divergence)."""
    from hetu_galvatron_tpu_torch.core.cost_model.cost import CostContext

    elem = 2 if mixed_precision else 4
    act1 = activation_per_sample_mb(model, elem)
    vparams = vocab_param_mb(model)
    degrees = []
    d = 1
    while d <= max(world_size, 1):
        degrees.append(d)
        d *= 2
    act_dict: Dict[Any, float] = {t: act1 / t for t in degrees}
    act_dict["checkpoint"] = checkpoint_per_sample_mb(model, elem)
    first_states = {t: 4 * vparams["embed"] / t for t in degrees}
    last_states = {t: 4 * (vparams["prenorm"] + vparams["head"]) / t
                   for t in degrees}
    off_states = {t: first_states[t] + last_states[t] for t in degrees}
    vact = {t: vocab_act_per_sample_mb(model, t, elem) for t in degrees}
    return CostContext(
        parameter_size=_layer_param_mb(model),
        seq_length=model.seq_length,
        hidden_size=model.hidden_size,
        layer_num=1,
        mixed_precision=mixed_precision,
        async_grad_reduce=True,
        pytorch_context_mem=0.0,
        sequence_parallel=True,
        pipeline_type=pipeline_type,
        tp_activation_per_bsz_dict=act_dict,
        other_memory_pp_off={
            "model_states": off_states,
            "activation": {t: vact[t]["first"] + vact[t]["last"]
                           for t in degrees}},
        other_memory_pp_on={
            "first_stage": {"model_states": first_states,
                            "activation": {t: vact[t]["first"]
                                           for t in degrees}},
            "last_stage": {"model_states": last_states,
                           "activation": {t: vact[t]["last"]
                                          for t in degrees}}},
    )


def _search_strategy(s: LayerStrategy):
    from hetu_galvatron_tpu_torch.core.search_engine.strategies import (
        SearchStrategy,
    )

    return SearchStrategy(
        pp=s.pp_deg, tp=1 if s.sp else s.tp_size,
        sp=s.tp_size if s.sp else 1, cp=s.cp_size, dp=s.dp_size,
        dp_type=s.dp_type, checkpoint=s.checkpoint)


def cross_check_cost_model(
    layers: Sequence[LayerStrategy],
    vocab: EmbeddingLMHeadStrategy,
    model: Any,
    *,
    global_bsz: int,
    chunks: int,
    pp_division: Sequence[int],
    pipeline_type: str,
    world_size: int,
    mixed_precision: bool = True,
    tolerance: float = 1e-6,
) -> Tuple[Dict[str, float], List[str]]:
    """Evaluate ``cost.layer_memory_components`` / ``embed_memory_components``
    on the doctor's analytic context and compare per component against the
    doctor's own accounting (re-run under the HOST-engine convention —
    the convention the cost model defines, so the compiled engine's vocab
    replication premium and stage buffer never pollute the ratio).
    Returns ({component: ratio}, problems); a ratio off ~1.0 names the
    drifted component. The stage buffer, the replication premium and the
    KV pool are the doctor's OWN dimensions (that is the point of the
    pass) and are excluded from the ratio by construction."""
    from hetu_galvatron_tpu_torch.core.cost_model.cost import (
        embed_memory_components,
        layer_memory_components,
    )

    ctx = _cost_context(model, chunks, world_size, pipeline_type,
                        mixed_precision)
    # the doctor's arithmetic under the cost model's own conventions
    stages = plan_stage_memory(
        layers, vocab, model, global_bsz=global_bsz, chunks=chunks,
        pp_division=pp_division, pipeline_type=pipeline_type,
        schedule_impl="host", mixed_precision=mixed_precision)
    pp = max(layers[0].pp_deg, 1)
    stage_of: List[int] = []
    for st, n in enumerate(pp_division):
        stage_of.extend([st % pp] * n)

    cm_states = [0.0] * pp
    cm_act = [0.0] * pp
    for i, s in enumerate(layers):
        st = stage_of[i] if i < len(stage_of) else pp - 1
        comp = layer_memory_components(
            _search_strategy(s), ctx, global_bsz, max(chunks, 1),
            stage_idx=st, pipeline_type=pipeline_type)
        cm_states[st] += comp["model_states_mb"]
        cm_act[st] += comp["activation_mb"]

    vs = _search_strategy(layers[0])
    from dataclasses import replace as _replace

    from hetu_galvatron_tpu_torch.utils.strategy import DPType

    stage_world = layers[0].tp_size * layers[0].cp_size * layers[0].dp_size
    vtp, vcp = max(vocab.vtp, 1), max(vocab.vcp, 1)
    vdp = max(stage_world // vtp // vcp, 1)
    vs = _replace(vs, tp=vtp, sp=1, cp=vcp, dp=vdp,
                  dp_type=DPType.ZERO3 if vocab.embed_sdp else DPType.DDP,
                  checkpoint=False, is_vocab=True)
    vcomp = embed_memory_components(vs, ctx, global_bsz, max(chunks, 1),
                                    pipeline_type=pipeline_type)

    problems: List[str] = []
    ratios: Dict[str, float] = {}

    def check(name: str, doctor: float, cost: float) -> None:
        if doctor < 1e-12 and cost < 1e-12:
            return
        ratio = doctor / cost if cost > 1e-12 else float("inf")
        ratios[name] = ratio
        if abs(ratio - 1.0) > tolerance:
            problems.append(
                f"memory cross-check: component '{name}' diverged — "
                f"doctor {doctor:.3f} MB vs cost model {cost:.3f} MB "
                f"(ratio {ratio:.4f}; the two accountings must agree)")

    doc_states = sum(st.components["model_states_mb"] for st in stages)
    doc_act = sum(st.components["activation_mb"] for st in stages)
    check("layer_model_states", doc_states, sum(cm_states))
    check("layer_activation", doc_act, sum(cm_act))
    # vocab: the cost model bills the first/last stages only; compare the
    # doctor's first/last rows (the compiled replication premium on middle
    # stages is deliberately outside the ratio)
    doc_v_states = (stages[0].components["vocab_states_mb"]
                    + (stages[-1].components["vocab_states_mb"]
                       if pp > 1 else 0.0))
    doc_v_act = (stages[0].components["vocab_activation_mb"]
                 + (stages[-1].components["vocab_activation_mb"]
                    if pp > 1 else 0.0))
    cm_v_states = vcomp["model_states_mb"][0] + (
        vcomp["model_states_mb"][-1] if pp > 1 else 0.0)
    cm_v_act = vcomp["activation_mb"][0] + (
        vcomp["activation_mb"][-1] if pp > 1 else 0.0)
    check("vocab_model_states", doc_v_states, cm_v_states)
    check("vocab_activation", doc_v_act, cm_v_act)
    return ratios, problems


# ---------------------------------------------------------------------------
# the doctor report
# ---------------------------------------------------------------------------


@dataclass
class MemoryDoctorReport:
    """Full verdict: per-stage component table, peak, cross-check ratios,
    and the budget-gate outcome. ``ok`` is False for malformed plans, a
    busted --hbm-gb budget, or a cross-check divergence."""

    plan: str
    world_size: Optional[int] = None
    ok: bool = True
    errors: List[str] = field(default_factory=list)
    warnings: List[str] = field(default_factory=list)
    notes: List[str] = field(default_factory=list)
    stages: List[StageMemory] = field(default_factory=list)
    ratios: Dict[str, float] = field(default_factory=dict)
    hbm_gb: Optional[float] = None

    @property
    def peak_mb(self) -> float:
        return peak_mb(self.stages)

    def render(self, out=None) -> None:
        out = out or sys.stdout
        w = lambda s="": print(s, file=out)
        w(f"== memory doctor: {self.plan} (world {self.world_size}) ==")
        for e in self.errors:
            w(f"ERROR: {e}")
        for x in self.warnings:
            w(f"warning: {x}")
        if self.stages:
            short = {"model_states_mb": "states", "activation_mb": "act",
                     "stage_buffer_mb": "buffer",
                     "vocab_states_mb": "vocab_st",
                     "vocab_activation_mb": "vocab_act",
                     "kv_pool_mb": "kv_pool"}
            w("stage  " + "".join(f"{short[c]:>11}"
                                  for c in STAGE_COMPONENTS)
              + f"{'total':>11}  (MB)")
            for st in self.stages:
                cells = "".join(f"{st.components[c]:>11.2f}"
                                for c in STAGE_COMPONENTS)
                w(f"{st.stage:<7}{cells}{st.total_mb:>11.2f}")
            w(f"per-device peak: {self.peak_mb:.2f} MB"
              + (f" (budget {self.hbm_gb:g} GB)"
                 if self.hbm_gb is not None else ""))
        if self.ratios:
            pretty = ", ".join(f"{k}={v:.4f}"
                               for k, v in sorted(self.ratios.items()))
            w(f"cost-model cross-check ratios: {pretty}")
        for n in self.notes:
            w(f"note: {n}")
        w("memory doctor: " + ("OK" if self.ok else "FAILED"))


def diagnose_memory(
    plan: Union[str, Dict[str, Any]],
    model_cfg: Any,
    world_size: Optional[int] = None,
    *,
    hbm_gb: Optional[float] = None,
    serving: Any = None,
    schedule_impl: str = "compiled",
    mixed_precision: bool = True,
) -> MemoryDoctorReport:
    """Diagnose one plan's memory against one model config (and, in
    serving mode, one ServingArgs). Never raises on malformed input —
    every problem lands in ``report.errors`` (the plan-doctor contract)."""
    name = plan if isinstance(plan, str) else "<dict>"
    report = MemoryDoctorReport(plan=name, world_size=world_size,
                                hbm_gb=hbm_gb)
    if hbm_gb is not None and hbm_gb <= 0:
        report.ok = False
        report.errors.append(
            f"--hbm-gb must be a positive HBM budget in gigabytes, got "
            f"{hbm_gb!r}")
        return report

    try:
        cfg = load_strategy_config(plan) if isinstance(plan, str) else plan
        layers, vocab, extras = config2strategy(cfg)
    except (PlanFormatError, ValueError, TypeError) as e:
        report.ok = False
        report.errors.append(str(e))
        return report

    pp_deg = layers[0].pp_deg
    if world_size is None:
        world_size = pp_deg * max(s.tp_size * s.cp_size for s in layers)
        report.world_size = world_size
        report.warnings.append(
            f"no --world given; assuming the smallest world the plan fits "
            f"({world_size} devices)")
    try:
        layers, vocab, extras = config2strategy(cfg, world_size=world_size)
    except (PlanFormatError, ValueError) as e:
        report.ok = False
        report.errors.append(str(e))
        return report

    if max(vocab.vtp, 0) < 1:
        report.ok = False
        report.errors.append(
            f"vocab config: vtp must be >= 1 (got {vocab.vtp}) — the "
            "embedding/LM-head rows cannot be sharded over a zero-size "
            "group")
    n_layers = len(layers)
    if n_layers != model_cfg.num_hidden_layers and \
            model_cfg.model_type != "t5":
        report.ok = False
        report.errors.append(
            f"plan has {n_layers} layers, model has "
            f"{model_cfg.num_hidden_layers}")
    global_bsz = extras["global_bsz"]
    chunks = max(extras["chunks"], 1)
    vpp = max(extras.get("vpp_deg", 1), 1)
    pp_division = (extras["pp_division"]
                   or default_pp_division(n_layers, pp_deg * vpp))
    for st, n in enumerate(pp_division):
        if n <= 0:
            report.ok = False
            report.errors.append(
                f"pp_division stage {st} has {n} layers — a zero-layer "
                "stage holds no weights and starves the schedule")
    if sum(pp_division) != n_layers:
        report.ok = False
        report.errors.append(
            f"pp_division {list(pp_division)} != layer count {n_layers}")
    if report.errors:
        return report

    pipeline_type = extras["pipeline_type"]
    stages = plan_stage_memory(
        layers, vocab, model_cfg, global_bsz=global_bsz, chunks=chunks,
        pp_division=pp_division, pipeline_type=pipeline_type,
        schedule_impl=schedule_impl, mixed_precision=mixed_precision,
        serving=serving)
    report.stages = stages

    try:
        ratios, problems = cross_check_cost_model(
            layers, vocab, model_cfg, global_bsz=global_bsz,
            chunks=chunks, pp_division=pp_division,
            pipeline_type=pipeline_type, world_size=world_size,
            mixed_precision=mixed_precision)
    except ValueError as e:
        # the memory cost model REJECTS this shape outright (e.g.
        # chunks < pp cannot fill the 1F1B pipeline) — that is itself the
        # diagnosis, not a traceback
        report.ok = False
        report.errors.append(f"memory cost model rejects this plan shape: "
                             f"{e}")
        return report
    report.ratios = ratios
    if problems:
        report.ok = False
        report.errors.extend(problems)

    if schedule_impl == "compiled" and pp_deg > 1:
        report.notes.append(
            "vocab rows replicate across every stage under the compiled "
            "engine (split_params) — middle stages pay the premium the "
            "cost model bills to first/last only")
    if serving is not None:
        from hetu_galvatron_tpu_torch.serving.kv_cache import resolve_num_blocks

        nb = resolve_num_blocks(serving, model_cfg)
        cap = serving.prefix_cache_max_blocks or 0
        budget = (f"{cap} blocks" if cap else
                  "bounded only by the pool")
        report.notes.append(
            f"serving: KV pool {nb} blocks of {serving.kv_block_size} "
            f"tokens; prefix-cache block budget {budget}"
            if serving.prefix_cache else
            f"serving: KV pool {nb} blocks of {serving.kv_block_size} "
            "tokens (prefix cache off)")

    if hbm_gb is not None:
        reason = hbm_budget_reason(report.peak_mb, hbm_gb)
        if reason is not None:
            report.ok = False
            report.errors.append(reason)
    return report
