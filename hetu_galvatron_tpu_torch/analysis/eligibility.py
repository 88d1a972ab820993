"""Plan-eligibility predicates of the cost model, the search and the plan.

Port of the part of ``hetu_galvatron_tpu/analysis/eligibility.py`` that the
cost model, the search engine and the JSON-plan path call: the search-side
adapters ``search_compiled_expressible`` (:93),
``search_tp_overlap_expressible`` (:196) and ``search_hier_dp_expressible``
(:302), with the compiled-schedule predicate the first evaluates, and the
plan-structure reasons (:363-437). The runtime predicates of multi-rank
plans (overlap, hierarchical dp and dp-schedule reasons over a lowered
plan) come with the SPMD plans on NCCL (ROADMAP item 10). Everything here
is pure Python over plain values, and the reason strings are JAX's.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence


def compiled_schedule_unsupported_reason(
    *,
    pp_deg: int,
    pipeline_type: str,
    vpp_deg: int = 1,
    model_type: str = "gpt",
    num_experts: int = 0,
    pp_division: Sequence[int] = (),
    uniform_strategies: bool = True,
    packed_docs: bool = False,
) -> Optional[str]:
    """None when the compiled 1F1B schedule can express a plan with these
    properties; otherwise the reason."""
    if pp_deg < 2:
        return "pp_deg < 2 routes through the SPMD path"
    if pipeline_type != "pipedream_flush":
        return "compiled schedule implements 1F1B (pipedream_flush) only"
    if vpp_deg > 1:
        return "interleaved virtual stages (vpp > 1)"
    if model_type == "t5":
        return "encoder-decoder (a, b) pair carry"
    if num_experts:
        return "MoE layers alternate tree structures across the stack"
    if len(set(pp_division)) > 1:
        return (f"heterogeneous per-stage layer counts "
                f"{list(pp_division)} (stage stacking needs uniformity)")
    if not uniform_strategies:
        return "heterogeneous per-layer strategies"
    if packed_docs:
        return "packed-document position/segment fields"
    return None


def search_compiled_expressible(
    schedule_impl: str,
    pipeline_type: str,
    partition: Sequence[int],
    strategy_list: Sequence[Any],
) -> bool:
    """Can the pipeline dispatch-overhead waiver apply to this candidate
    (``cost_model.cost.pipeline_time_cost``)?"""
    if schedule_impl != "compiled":
        return False
    return compiled_schedule_unsupported_reason(
        pp_deg=max(len(partition), 2),  # pp>1 is the caller's precondition
        pipeline_type=pipeline_type,
        pp_division=partition,
        uniform_strategies=all(s == strategy_list[0] for s in strategy_list),
    ) is None


def search_tp_overlap_expressible(tp: int, cp: int, enabled: bool) -> bool:
    """Can this candidate layer earn the ring-overlap discount? Megatron TP
    only (Ulysses has tp == 1 here) and no cp."""
    return enabled and tp > 1 and cp == 1


def search_hier_dp_expressible(s: Any, enabled: bool) -> bool:
    """Can this candidate layer earn the hierarchical dp pricing? dp > 1;
    cp/Ulysses layers only without a pipeline."""
    if not (bool(enabled) and s.dp > 1):
        return False
    if s.cp == 1 and s.sp == 1:
        return True
    return s.pp == 1


# ---------------------------------------------------------------------------
# plan structure (divisibility / stage sums / axis products)
# ---------------------------------------------------------------------------


def pp_world_reason(world_size: int, pp_deg: int) -> Optional[str]:
    if pp_deg >= 1 and world_size % pp_deg:
        return f"world {world_size} % pp {pp_deg} != 0"
    return None


def stage_degree_reason(world_size: int, pp_deg: int, tp: int,
                        cp: int) -> Optional[str]:
    stage = world_size // max(pp_deg, 1)
    if stage % (tp * cp):
        return f"stage world {stage} not divisible by tp{tp}*cp{cp}"
    return None


def vpp_layers_reason(pp_deg: int, vpp_deg: int,
                      n_layers: int) -> Optional[str]:
    if pp_deg * vpp_deg > n_layers:
        return (f"pp_deg {pp_deg} * virtual_pp_deg {vpp_deg} exceeds the "
                f"layer count {n_layers}")
    return None


def pp_division_sum_reason(pp_division: Sequence[int],
                           n_layers: int) -> Optional[str]:
    if sum(pp_division) != n_layers:
        return f"pp_division {list(pp_division)} != layer count {n_layers}"
    return None


def pp_division_len_reason(pp_division: Sequence[int], pp_deg: int,
                           vpp_deg: int) -> Optional[str]:
    if len(pp_division) != pp_deg * vpp_deg:
        return (f"pp_division has {len(pp_division)} entries, expected "
                f"pp_deg {pp_deg} * vpp_deg {vpp_deg} = {pp_deg * vpp_deg}")
    return None


def batch_grain_reason(global_bsz: int, world_size: int, pp_deg: int,
                       layers: Sequence[Any], vocab: Any) -> Optional[str]:
    """The batch must divide by the largest dp group any layer carves out
    (world // pp // min_tp // min_cp)."""
    min_tp = min(min(s.tp_size for s in layers), vocab.vtp)
    min_cp = min(min(s.cp_size for s in layers), vocab.vcp)
    grain = world_size // max(pp_deg, 1) // min_tp // min_cp
    if global_bsz % max(grain, 1):
        return (f"global_bsz {global_bsz} must be a multiple of "
                f"world//pp//min_tp//min_cp = {grain}")
    return None


def plan_structure_reasons(
    *,
    layers: Sequence[Any],
    vocab: Any,
    pp_deg: int,
    vpp_deg: int,
    pp_division: Sequence[int],
    n_layers: int,
    world_size: int,
    global_bsz: int,
) -> List[str]:
    """Every structural problem with a resolved plan, in the order
    ``runtime/hybrid_config.py`` raises them (it raises on the first)."""
    out: List[str] = []
    for r in (
        pp_world_reason(world_size, pp_deg),
        vpp_layers_reason(pp_deg, vpp_deg, n_layers),
        pp_division_sum_reason(pp_division, n_layers),
        pp_division_len_reason(pp_division, pp_deg, vpp_deg),
        batch_grain_reason(global_bsz, world_size, pp_deg, layers, vocab),
    ):
        if r is not None:
            out.append(r)
    return out
