"""Analytical time/memory cost models for the strategy search.

Port of ``hetu_galvatron_tpu/core/cost_model/cost.py``: ``CostContext``,
the decoder-layer, embedding/LM-head and pipeline time and memory costs,
``layer_time_components``, ``reprice_stored_plan_ms`` and
``model_flops_per_token`` (:894), operation for operation, so the same
profiles give the same floats, bit for bit (the golden searches of
``tests/search_engine/test_search_golden.py`` pin them).

With ``search.hier_dp=1`` the hierarchical dp gradient reduction is priced
as JAX prices it: ``_hier_dp_split`` :242, ``hier_dp_buckets`` :269,
``hier_dp_reduce_ms`` :282 (monolithic and bucketed), the synthesized
dp-schedule families of ``collectives/`` ranked by
``dp_schedule_rankings`` :346 and ``dp_schedule_choice`` :380, the bucket
sweep ``hier_dp_best_bucket`` :549 and ``hier_dp_wins`` :568. The
overlapped-TP diagnostic ``tp_overlap_hidden_frac`` (:584) comes with the
TP overlap (ROADMAP item 11).

Units: memory in MB, profiled times in ms, returned times in seconds.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (
    TYPE_CHECKING,
    Any,
    Dict,
    List,
    Optional,
    Sequence,
    Tuple,
    Union,
)

import numpy as np

from hetu_galvatron_tpu_torch.analysis.eligibility import (
    search_compiled_expressible,
    search_hier_dp_expressible,
    search_tp_overlap_expressible,
)
from hetu_galvatron_tpu_torch.utils.strategy import DPType

if TYPE_CHECKING:  # typing only — a runtime import would be circular
    # (search_engine/__init__ imports engine, engine imports this module)
    from hetu_galvatron_tpu_torch.core.search_engine.strategies import (
        SearchStrategy,
    )

Fit = Union[float, np.ndarray, Tuple[float, float]]


def _linear(x, popt):
    return popt[0] * x + popt[1]


def _lookup_latency(select: Dict[Any, float], message_mb: float) -> float:
    """Measured table hit, else the fitted linear extrapolation (reference
    layer_cost.py:143-148)."""
    if message_mb in select:
        return select[message_mb]
    return _linear(message_mb, select["popt"])


@dataclass
class CostContext:
    """Everything one layertype's cost evaluation needs: model shape,
    profiled model costs, and hardware latency tables (reference ModelArgs /
    TrainArgs / ParallelArgs / ProfileModelArgs / ProfileHardwareArgs,
    cost_model_args.py)."""

    # model
    parameter_size: float = 48.0  # MB per layer
    seq_length: int = 1024
    hidden_size: int = 4096
    layer_num: int = 16
    # train
    mixed_precision: bool = True
    async_grad_reduce: bool = True
    pytorch_context_mem: float = 1024.0
    # parallel
    sequence_parallel: bool = True
    pipeline_type: str = "gpipe"
    # profiled model costs
    forward_computation_time: Fit = 1.0  # ms/sample (or linear fit popt)
    other_time_profiled: Fit = 0.0
    tp_activation_per_bsz_dict: Dict[Any, float] = field(default_factory=dict)
    other_memory_pp_off: Dict[str, Dict[int, float]] = field(default_factory=dict)
    other_memory_pp_on: Dict[str, Dict[str, Dict[int, float]]] = field(
        default_factory=dict)
    # profiled hardware
    bct_fct_coe: float = 2.0
    extra_overhead: float = 0.0
    comm_coe_dict: Dict[str, float] = field(default_factory=dict)  # ms/MB
    dp_overlap_coe: float = 1.3
    bct_overlap_coe: float = 1.3
    p2p_comm_coe_dict: Optional[Dict[int, float]] = None
    costmodel_coe: float = 1.0
    allgather_latency: Dict[int, Dict[Any, float]] = field(default_factory=dict)
    all2all_latency: Dict[int, Dict[Any, float]] = field(default_factory=dict)
    allreduce_latency: Dict[int, Dict[Any, float]] = field(default_factory=dict)
    # host-sequenced pipeline dispatch overhead (beyond the reference):
    # the host engine pays ~dispatch_us of wall time per already-compiled
    # stage-jit call — 2 (fwd + bwd) * pp * chunks calls per step — while
    # the compiled single-program schedule (pipeline.schedule_impl=
    # compiled) pays none. Measured by tools/pipeline_dispatch_bench.py;
    # 0.0 (the default) keeps the reference-equivalent arithmetic exact.
    dispatch_us: float = 0.0
    schedule_impl: str = "host"
    # latency-aware (α-β) TP collective model + overlapped-TP discount
    # (beyond the reference, which prices TP purely from the measured
    # latency tables): tp_alpha_beta maps "{size}_{consec}" -> (alpha_ms,
    # beta_mb_per_ms) fitted by hardware_profiler.profile_alpha_beta on
    # the ALLREDUCE curve; a Megatron-SP ag/rs-equivalent message costs
    # 0.5 * (α + size/β). Empty dict (legacy profiles) falls back to the
    # measured latency-table lookup, leaving golden costs byte-identical.
    # tp_overlap=True applies the max(comm, compute)-style discount of the
    # decomposed ring matmuls (ops/overlap.py) to overlap-expressible
    # layers only (tp > 1, no cp, not under the compiled pipeline engine).
    tp_alpha_beta: Dict[str, Tuple[float, float]] = field(default_factory=dict)
    tp_overlap: bool = False
    # per-algorithm, per-LEVEL collective curves (beyond the single fitted
    # curve): "{size}_{consec}" -> {"{ring|tree}_{ici|dcn}": (α ms,
    # β MB/ms)}, fitted by hardware_profiler.profile_alpha_beta_algos over
    # algorithm-SHAPED schedules (ring reduce-scatter/all-gather vs
    # recursive halving-doubling) on intra-host/ICI vs cross-slice/DCN
    # groups. A collective is priced as the MIN over the curves available
    # at its size and level — "Revisiting the Time Cost Model of
    # AllReduce": ring and tree have materially different (α, β) regimes,
    # and the win comes from CHOOSING per collective ("The Big Send-off").
    # Empty dict (legacy profiles) keeps every golden cost byte-identical.
    alpha_beta_algos: Dict[str, Dict[str, Tuple[float, float]]] = field(
        default_factory=dict)
    # hierarchical dp gradient reduction pricing (search.hier_dp +
    # ops/hier_reduce.py): when the per-level curves are available, an
    # eligible layer's dp term may be priced as reduce-scatter intra-host
    # at full grad volume + all-reduce across slices on the 1/intra shard
    # + all-gather back (un-overlapped — the runtime reduces once at step
    # end), and the layer cost takes min(flat, hierarchical). dcn_slices
    # (the search maps num_nodes onto it) fixes the slice/host split with
    # the same pp-first absorption as mesh.dcn_factor_shape.
    hier_dp: bool = False
    dcn_slices: int = 1
    # bucketed software pipelining of the hierarchical reduction
    # (ops/hier_reduce.py wavefront emission): > 0 splits the grad payload
    # into <=hier_bucket_mb-MB buckets and prices the pipelined schedule —
    # first bucket pays the full rs+ar+ag chain, every further bucket pays
    # only the bottleneck stage max(T_ici, T_dcn) (fill-drain), so the α
    # overhead grows per bucket while the slow link hides behind the fast
    # ones. 0 keeps the monolithic rs+ar+ag sum — byte-identical goldens.
    hier_bucket_mb: float = 0.0


def _zero_ratios(chunks: int, mixed_precision: bool, async_grad_reduce: bool):
    """(zero2_ratio, zero3_ratio) closures over the shard degree d
    (reference layer_cost.py:289-300; the +0.003 is the reference's
    flat all-gather bookkeeping overhead)."""
    if chunks == 1:
        z2 = (lambda d: 7 / 8 * (1 / d + 0.003) + 1 / 8) if mixed_precision \
            else (lambda d: 3 / 4 * (1 / d + 0.003) + 1 / 4)
        z3 = lambda d: 1 / d + 0.003
    elif async_grad_reduce:
        z2 = (lambda d: 6 / 8 * (1 / d + 0.003) + 2 / 8) if mixed_precision \
            else (lambda d: 2 / 4 * (1 / d + 0.003) + 2 / 4)
        z3 = (lambda d: 7 / 8 * (1 / d + 0.003) + 1 / 8) if mixed_precision \
            else (lambda d: 3 / 4 * (1 / d + 0.003) + 1 / 4)
    else:
        # sync grad reduce with microbatching keeps an fp32 grad copy (x5/4)
        z2 = (lambda d: (7 / 8 * (1 / d + 0.003) + 1 / 8) * 5 / 4) \
            if mixed_precision else (lambda d: 3 / 4 * (1 / d + 0.003) + 1 / 4)
        z3 = lambda d: (1 / d + 0.003) * 5 / 4
    return z2, z3


# ---------------------------------------------------------------------------
# decoder-layer time
# ---------------------------------------------------------------------------


def tp_overlap_expressible(s: "SearchStrategy", ctx: CostContext) -> bool:
    """Can this layer run the decomposed ring-overlap matmuls
    (eligibility.overlap_unsupported_reason, the shape checks aside — the
    search works in degrees, not concrete widths)? Megatron TP only
    (Ulysses has s.tp == 1 here) and no cp. Since the compiled 1F1B engine
    de-vmapped its stage axis (round 12), the rings run INSIDE the fused
    program too — pp > 1 under ``schedule_impl="compiled"`` keeps the
    discount, so the overlap hiding and the dispatch waiver COMPOSE on
    deep-pp plans. The predicate is shared with the runtime dispatch via
    ``analysis/eligibility.py`` (the parity test pins it)."""
    return search_tp_overlap_expressible(s.tp, s.cp, ctx.tp_overlap)


def _overlap_window(comm: float, comp: float, coe: float) -> float:
    """Wall time of (collective ∥ dependent compute), mirroring the dp
    ``overlap()`` split (layer_cost.py:161-178): both sides run slowed by
    the profiled overlap coefficient until the shorter one drains, the
    remainder finishes at full speed."""
    comm_ov, comp_ov = comm * coe, comp * coe
    if comm_ov > comp_ov:
        return comp_ov + (comm - comp_ov / coe)
    if comm_ov < comp_ov:
        return comm_ov + (comp - comm_ov / coe)
    return comm_ov


def _algo_min_ms(ctx: CostContext, size: int, consec: int, level: str,
                 message_mb: float) -> Optional[float]:
    """Cheapest ALLREDUCE time at ``message_mb`` over the per-algorithm
    curves fitted for group ``(size, consec)`` at the given topology
    ``level`` (``ici`` | ``dcn``); None when no curve covers it. This is
    where the algorithm CHOICE happens: small messages ride the
    latency-optimal halving-doubling curve, large ones the
    bandwidth-optimal ring, per collective and per size."""
    table = ctx.alpha_beta_algos.get(f"{size}_{consec}")
    if not table:
        return None
    best = None
    suffix = f"_{level}"
    for key, (alpha, beta) in table.items():
        if not key.endswith(suffix):
            continue
        t = alpha + message_mb / beta
        if best is None or t < best:
            best = t
    return best


def _tp_message_ms(s: "SearchStrategy", ctx: CostContext,
                   message_mb: float) -> float:
    """One Megatron-SP ag/rs-equivalent collective of ``message_mb`` MB:
    the cheapest of the fitted curves when the profile carries them — the
    flat α-β pair AND the per-algorithm ICI curves, each at half the
    allreduce time (matching profiles.remap_collective_latency's allgather
    derivation) — else the legacy measured-table lookup. Only called with
    s.tp > 1; tp groups are consecutive (the same assumption the legacy
    dc_key encodes), so the "{n}_1" pair applies and the level is ici."""
    candidates = []
    ab = ctx.tp_alpha_beta.get(f"{s.tp}_1")
    if ab is not None:
        alpha, beta = ab
        candidates.append(alpha + message_mb / beta)
    algo = _algo_min_ms(ctx, s.tp, 1, "ici", message_mb)
    if algo is not None:
        candidates.append(algo)
    if candidates:
        return 0.5 * min(candidates)
    return _lookup_latency(ctx.allgather_latency[s.tp], message_mb)


def _hier_dp_split(s: "SearchStrategy", ctx: CostContext
                   ) -> Optional[Tuple[int, int]]:
    """(cross, intra) split of the layer's DP group — the group the
    runtime's lane reduction actually covers (``mesh.hier_cross_degree``
    splits dp, not sdp; the leftover cp/sp partial sums stay in-lane) —
    mirroring the pp-first slice absorption; None when the leftover
    slices cannot divide dp (the runtime would reject too)."""
    import math as _math

    dcn = max(ctx.dcn_slices, 1)
    left = dcn // _math.gcd(dcn, max(s.pp, 1))
    if s.dp % left:
        return None
    return left, s.dp // left


def hier_grad_payload_mb(s: "SearchStrategy", ctx: CostContext) -> float:
    """Per-device megabytes of the hierarchical reduction's grad payload:
    the whole model's layer params on this tp shard, in the training
    dtype. THE one formula — `layer_time_cost`'s pricing, the audit's
    dp decomposition, and the search engine's plan-bucket recording all
    call it, so the bucket size written into the plan JSON can never
    desynchronize from the payload the price assumed."""
    return (ctx.parameter_size / s.tp * ctx.layer_num
            * (0.5 if ctx.mixed_precision else 1.0))


def hier_dp_buckets(grad_mb: float, bucket_mb: float) -> int:
    """Bucket count of the pipelined hierarchical schedule for a
    ``grad_mb`` payload at ``bucket_mb`` granularity (1 = monolithic) —
    the cost model's degree-level mirror of the runtime's exact
    ``ops.hier_reduce.hier_bucket_layout`` (which works in padded
    elements; the search prices in MB)."""
    if bucket_mb <= 0 or grad_mb <= 0:
        return 1
    import math as _math

    return max(int(_math.ceil(grad_mb / bucket_mb)), 1)


def hier_dp_reduce_ms(s: "SearchStrategy", ctx: CostContext,
                      grad_mb: float) -> Optional[float]:
    """Hierarchical dp gradient-reduction time for ``grad_mb`` (the
    per-device grad volume): rs-intra at full volume + ar-cross on the
    1/intra shard + ag-intra back, each priced off the per-level algorithm
    curves (rs/ag at half the allreduce curve, the repo-wide convention).
    None when ineligible or any needed curve is missing — the caller then
    keeps the flat pricing, so legacy profiles stay byte-identical.

    ``ctx.hier_bucket_mb > 0`` prices the bucketed SOFTWARE-PIPELINED
    schedule (ops/hier_reduce.py wavefront emission): with B buckets of
    ``grad_mb / B`` each, the first bucket pays its full three-stage
    chain and every further bucket pays only the bottleneck stage —
    ``T = t_ici + t_dcn + (B-1) * max(t_ici, t_dcn)`` where ``t_ici`` is
    the per-bucket rs+ag (one ICI allreduce-curve hit) and ``t_dcn`` the
    per-bucket cross-slice allreduce on the 1/intra shard. Each stage
    re-pays its α per bucket, so the model prices the real trade: more
    buckets hide more of the slow link but spend more latency. B = 1
    reproduces the monolithic sum exactly.

    cp/Ulysses-bearing layers (sdp > dp) add the IN-LANE residual: the
    per-lane grads stay partial over the cp/sp group, which the
    partitioner reduces over the ICI-local ``sdp/dp``-sized group —
    priced as one allreduce-curve hit at full grad volume (the same
    once-per-step granularity the flat model uses)."""
    if not search_hier_dp_expressible(s, ctx.hier_dp):
        return None
    if ctx.hier_bucket_mb < 0:
        # auto mode (search.hier_bucket_mb < 0): the price IS the best
        # bucket size's price — the search picks the granularity, and
        # hier_dp_best_bucket reports which one for the plan record
        return hier_dp_best_bucket(s, ctx, grad_mb)[0]
    split = _hier_dp_split(s, ctx)
    if split is None:
        return None
    cross, intra = split
    B = hier_dp_buckets(grad_mb, ctx.hier_bucket_mb)
    msg = grad_mb / B
    t_ici = 0.0
    if intra > 1:
        rs = _algo_min_ms(ctx, intra, 1, "ici", msg)
        if rs is None:
            return None
        t_ici = rs  # 0.5 rs + 0.5 ag of the same curve
    t_dcn = 0.0
    if cross > 1:
        ar = _algo_min_ms(ctx, cross, 0, "dcn", msg / intra)
        if ar is None:
            ar = _algo_min_ms(ctx, cross, 1, "dcn", msg / intra)
        if ar is None:
            return None
        t_dcn = ar
    if intra == 1 and cross == 1:
        return None
    total = t_ici + t_dcn + (B - 1) * max(t_ici, t_dcn)
    csp = s.sdp // max(s.dp, 1)
    if csp > 1:
        resid = _algo_min_ms(ctx, csp, 1, "ici", grad_mb)
        if resid is None:
            return None
        total += resid
    return total


def dp_schedule_rankings(s: "SearchStrategy", ctx: CostContext,
                         grad_mb: float) -> Dict[str, float]:
    """α-β prices (ms) of every synthesizable dp-schedule family for this
    layer's dp group at ``grad_mb`` payload — the collective compiler's
    search hook. The families come from
    ``collectives.synthesize.synthesize_space`` (ring, halving-doubling,
    latency-optimal tree broadcast, 2D torus, hierarchical rings — what
    the shape admits), priced by ``collectives.pricing`` over per-LINK
    curves inverted out of the profiled per-algorithm ring fits
    (``ctx.alpha_beta_algos``); min-over-curves, so a family a missing
    curve cannot price is simply absent. Empty when the plan is not
    hierarchically expressible or the profile carries no algorithm
    curves — the caller then records no schedule and the legacy pricing
    is untouched (the golden-search pins rely on that)."""
    if not search_hier_dp_expressible(s, ctx.hier_dp):
        return {}
    split = _hier_dp_split(s, ctx)
    if split is None or s.dp < 2:
        return {}
    cross, intra = split
    from hetu_galvatron_tpu_torch.collectives.pricing import (
        link_curves_from_algos,
        price_space,
    )
    from hetu_galvatron_tpu_torch.collectives.synthesize import (
        synthesize_space,
    )

    curves = link_curves_from_algos(
        ctx.alpha_beta_algos, intra if cross > 1 else s.dp, cross)
    if not curves:
        return {}
    return price_space(synthesize_space(s.dp, cross=cross), grad_mb,
                       curves)


def dp_schedule_choice(s: "SearchStrategy", ctx: CostContext,
                       grad_mb: float
                       ) -> Optional[Tuple[str, Dict[str, float]]]:
    """(winning family name, full rankings) for the plan record, or None
    when nothing priced. The winner is informational — it names the
    emitted program the runtime should execute (plan JSON
    ``dp_schedule``) — and deliberately does NOT perturb the plan's
    predicted time, so legacy profiles price byte-identically."""
    ranks = dp_schedule_rankings(s, ctx, grad_mb)
    if not ranks:
        return None
    return min(ranks, key=ranks.get), ranks


def _tp_terms(s: "SearchStrategy", ctx: CostContext, gbsz: int, chunks: int
              ) -> Tuple[float, float, float]:
    """Shared per-layer (fct, bct, tp_time) arithmetic — consumed by both
    :func:`layer_time_cost` (the price the search optimizes) and
    :func:`layer_time_components` (its decomposition), so the two can
    never drift apart.

    computation (layer_cost.py:88-103): cp shards the sequence, so the
    per-device compute divides by cp too (zigzag ring keeps the causal
    work balanced across the ring — ops/ring_attention.py).
    tp/sp collectives (layer_cost.py:119-150): the Megatron-TP path
    prices one message via the α-β fit when present (_tp_message_ms)."""
    lbsz = gbsz // chunks // s.dp
    n = ctx.layer_num
    fct_in = ctx.forward_computation_time
    if isinstance(fct_in, (np.ndarray, tuple, list)):
        fct = _linear(lbsz / s.tp_sp / s.cp, fct_in) * n
    else:
        fct = fct_in * lbsz / s.tp_sp / s.cp * n
    bct = fct * ctx.bct_fct_coe
    if s.checkpoint:
        bct += fct

    if s.tp_sp == 1:
        tp_time = 0.0
    else:
        message_mb = (lbsz * ctx.seq_length * ctx.hidden_size *
                      (2 if ctx.mixed_precision else 4) / 1024 / 1024)
        if s.tp == 1:  # Ulysses: 2 a2a fwd + 2 bwd per layer
            comm_num = 4 * n
            per_msg = _lookup_latency(ctx.all2all_latency[s.sp], message_mb)
        else:  # Megatron TP+SP: 3 ag-equivalents fwd + 3 bwd per layer
            comm_num = 6 * n
            per_msg = _tp_message_ms(s, ctx, message_mb)
        if s.checkpoint:
            comm_num *= 1.5
        tp_time = per_msg * comm_num
    return fct, bct, tp_time


def layer_time_cost(
    s: "SearchStrategy", ctx: CostContext, gbsz: int, chunks: int
) -> Tuple[float, float]:
    """Per-layer time in seconds: (with grad sync, without). Mirrors
    TimeCostModelBase end-to-end (layer_cost.py:88-213)."""
    lbsz = gbsz // chunks // s.dp
    param_mb = ctx.parameter_size / s.tp
    n = ctx.layer_num

    fct, bct, tp_time = _tp_terms(s, ctx, gbsz, chunks)

    # dp gradient sync (layer_cost.py:105-116)
    dp_message = 2 * (s.sdp - 1) * (param_mb / s.sdp) * n
    if ctx.mixed_precision:
        dp_message /= 2
    fsdp_allgather = dp_message * 0.5
    dc_key = f"{s.sdp}_0" if s.tp != 1 else f"{s.sdp}_1"
    dc = ctx.comm_coe_dict[dc_key]
    dc_overlap = dc * ctx.dp_overlap_coe

    # cp ring-attention communication (beyond the reference, which ships
    # cp disabled — search_engine/args_schema.py:29): each ring step
    # exchanges this rank's K and V blocks with a neighbour; the backward
    # rings K/V again plus the dK/dV accumulators (ops/ring_attention.py).
    cp_time = 0.0
    if s.cp > 1:
        block_mb = (lbsz * ctx.seq_length * ctx.hidden_size / s.cp *
                    (2 if ctx.mixed_precision else 4) / 1024 / 1024)
        hops = 2 * (s.cp - 1)          # K + V per ring pass
        ring_mb = block_mb * hops * 3  # fwd + bwd(K/V + dK/dV)
        cp_key = f"{s.cp}_0" if s.tp != 1 else f"{s.cp}_1"
        cp_coe = ctx.comm_coe_dict.get(
            cp_key, ctx.comm_coe_dict.get(f"{s.cp}"))
        cp_time = ring_mb * cp_coe * n

    # pp p2p (layer_cost.py:152-159)
    p2p_coe = None
    p2p_message = 0.0
    if s.pp > 1 and ctx.p2p_comm_coe_dict is not None:
        p2p_coe = ctx.p2p_comm_coe_dict[s.pp]
        p2p_message = (s.pp * 2 * lbsz * ctx.seq_length * ctx.hidden_size *
                       4 / 1024 / 1024)
        if ctx.mixed_precision:
            p2p_message /= 2

    def overlap(dp_msg: float) -> Tuple[float, float]:
        """Backward-compute/dp-comm overlap split (layer_cost.py:161-178)."""
        dp_t = dp_msg * dc_overlap
        bct_t = bct * ctx.bct_overlap_coe
        if dp_t > bct_t:
            return bct_t, (dp_msg - bct_t / dc_overlap) * dc
        if dp_t < bct_t:
            return dp_t, bct - dp_t / ctx.bct_overlap_coe
        return bct_t, 0.0

    # overlapped-TP discount: the decomposed ring matmuls hide the TP
    # collectives under the dependent chunk compute. dp=1 layers overlap
    # against the full fwd+bwd matmul window; layers that also overlap dp
    # comm against the backward keep only the forward window free.
    overlap_tp = tp_overlap_expressible(s, ctx) and tp_time > 0

    # hierarchical dp alternative (hier_dp_reduce_ms): the full per-device
    # grad volume reduced ONCE at step end (un-overlapped — the runtime's
    # lane accumulation defers the reduction out of the backward), priced
    # per level off the algorithm curves; None keeps flat-only pricing
    hier_ms = hier_dp_reduce_ms(s, ctx, hier_grad_payload_mb(s, ctx))

    def tp_term(window: float) -> float:
        """Exposed TP comm time beyond the compute window it hides under."""
        if not overlap_tp:
            return tp_time
        return _overlap_window(tp_time, window, ctx.bct_overlap_coe) - window

    def result(no_sync: bool) -> float:
        factor = 0 if no_sync else 1
        if s.tp_sp == 1 and s.dp > 1:
            ov, rest = overlap(dp_message * factor)
            r = fct + ov + rest + ctx.extra_overhead
        elif s.dp == 1 and s.tp_sp > 1:
            r = fct + bct + tp_term(fct + bct)
        elif s.dp == 1 and s.tp_sp == 1:
            r = fct + bct
        else:
            ov, rest = overlap(dp_message * factor)
            r = fct + ov + rest + tp_term(fct) + ctx.extra_overhead
        if factor and hier_ms is not None:
            # hierarchical dp candidate: backward runs un-overlapped (the
            # reduction happens once after accumulation), dp comm is the
            # three-level schedule; the layer takes whichever is cheaper
            if s.tp_sp == 1 and s.dp > 1:
                r_h = fct + bct + hier_ms + ctx.extra_overhead
            elif s.dp > 1 and s.tp_sp > 1:
                r_h = (fct + bct + tp_term(fct) + hier_ms
                       + ctx.extra_overhead)
            else:
                r_h = None
            if r_h is not None:
                r = min(r, r_h)
        if s.dp_type == DPType.ZERO3:
            r += fsdp_allgather * dc
        if s.pp > 1 and p2p_coe is not None:
            r += p2p_message * p2p_coe
        r += cp_time
        return r * 0.001 * ctx.costmodel_coe / n

    return result(False), result(True)


# candidate bucket sizes for auto mode (hier_bucket_mb < 0): monolithic
# plus power-of-two granularities covering the sub-MB-α to tens-of-MB-β
# regimes the fitted curves span
_BUCKET_SWEEP_MB: Tuple[float, ...] = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0,
                                       32.0, 64.0)


def hier_dp_best_bucket(s: "SearchStrategy", ctx: CostContext,
                        grad_mb: float
                        ) -> Tuple[Optional[float], float]:
    """(best hierarchical ms, chosen bucket_mb) over the candidate bucket
    sweep — the "search picks the bucket size" entry: the engine records
    the winning granularity in the plan JSON (``"hier_bucket_mb"``) so the
    runtime pipelines at exactly the size the price assumed. (None, 0.0)
    when the hierarchical term is unavailable at every size."""
    from dataclasses import replace as _replace

    best: Tuple[Optional[float], float] = (None, 0.0)
    for cand in _BUCKET_SWEEP_MB:
        ms = hier_dp_reduce_ms(
            s, _replace(ctx, hier_bucket_mb=cand), grad_mb)
        if ms is not None and (best[0] is None or ms < best[0]):
            best = (ms, cand)
    return best


def hier_dp_wins(s: "SearchStrategy", ctx: CostContext, gbsz: int,
                 chunks: int) -> bool:
    """Did the hierarchical dp term price this layer's chosen cost (i.e.
    enabling ``ctx.hier_dp`` strictly lowered the with-sync layer cost)?
    The search engine records ``"hier_dp": 1`` in the winning plan when
    every layer says yes, so the runtime enables the matching execution
    path."""
    if not search_hier_dp_expressible(s, ctx.hier_dp):
        return False
    from dataclasses import replace as _replace

    off = _replace(ctx, hier_dp=False)
    return (layer_time_cost(s, ctx, gbsz, chunks)[0]
            < layer_time_cost(s, off, gbsz, chunks)[0])


def layer_time_components(s: "SearchStrategy", ctx: CostContext,
                          gbsz: int, chunks: int) -> Dict[str, float]:
    """Decomposed per-layer predicted times in ms: the same arithmetic
    :func:`layer_time_cost` folds into one scalar, kept separated so the
    plan audit (``observability/trace_analysis.py``) can compare each
    component against the measured device-time attribution. Components are
    the UN-overlapped magnitudes — the audit's measured side (per-HLO-op
    category time) also counts collectives at face value, so the two sides
    are comparable; the overlap splits are a property of the folded total,
    not of the per-component prediction."""
    n = ctx.layer_num
    lbsz = gbsz // chunks // s.dp
    fct, bct, tp_time = _tp_terms(s, ctx, gbsz, chunks)

    param_mb = ctx.parameter_size / s.tp
    dp_message = 2 * (s.sdp - 1) * (param_mb / s.sdp) * n
    if ctx.mixed_precision:
        dp_message /= 2
    dc_key = f"{s.sdp}_0" if s.tp != 1 else f"{s.sdp}_1"
    # the folded model only charges the gradient ring when dp > 1 (both
    # result() overlap branches gate on s.dp); a dp==1 plan whose sdp > 1
    # via cp/ulysses replicas pays only the ZeRO-3 all-gather premium —
    # charging dp_message here would invent a component the search never
    # priced, and total_ms must reconcile with layer_time_cost
    dp_time = dp_message * ctx.comm_coe_dict[dc_key] if s.dp > 1 else 0.0
    if s.dp > 1 and hier_dp_wins(s, ctx, gbsz, chunks):
        # the chosen price was the hierarchical schedule: the audit must
        # compare measured dp time against THAT decomposition
        dp_time = hier_dp_reduce_ms(s, ctx, hier_grad_payload_mb(s, ctx))
    if s.dp_type == DPType.ZERO3 and s.sdp > 1:
        dp_time += dp_message * 0.5 * ctx.comm_coe_dict[dc_key]

    cp_time = 0.0
    if s.cp > 1:
        block_mb = (lbsz * ctx.seq_length * ctx.hidden_size / s.cp *
                    (2 if ctx.mixed_precision else 4) / 1024 / 1024)
        cp_key = f"{s.cp}_0" if s.tp != 1 else f"{s.cp}_1"
        cp_coe = ctx.comm_coe_dict.get(
            cp_key, ctx.comm_coe_dict.get(f"{s.cp}"))
        cp_time = block_mb * 2 * (s.cp - 1) * 3 * cp_coe * n

    pp_time = 0.0
    if s.pp > 1 and ctx.p2p_comm_coe_dict is not None:
        p2p_message = (s.pp * 2 * lbsz * ctx.seq_length * ctx.hidden_size *
                       4 / 1024 / 1024)
        if ctx.mixed_precision:
            p2p_message /= 2
        pp_time = p2p_message * ctx.p2p_comm_coe_dict[s.pp]

    scale = ctx.costmodel_coe / n
    out = {"fct_ms": fct * scale, "bct_ms": bct * scale,
           "tp_ms": tp_time * scale, "dp_ms": dp_time * scale,
           "cp_ms": cp_time * scale, "pp_ms": pp_time * scale}
    out["total_ms"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# decoder-layer memory
# ---------------------------------------------------------------------------


def layer_memory_components(
    s: "SearchStrategy",
    ctx: CostContext,
    gbsz: int,
    chunks: int,
    stage_idx: int = 0,
    pipeline_type: Optional[str] = None,
) -> Dict[str, float]:
    """Per-layer memory in MB, decomposed into the model-states and
    activation terms (MemoryCostModelBase, layer_cost.py:261-328). The
    memory doctor (``analysis/memory_doctor.py``) cross-checks its own
    first-principles accounting against each component separately, so the
    split is part of the contract; :func:`layer_memory_cost` folds the
    same dict into the scalar the search optimizes — one arithmetic, two
    views (the ``layer_time_components`` pattern)."""
    pipeline_type = pipeline_type or ctx.pipeline_type
    lbsz = gbsz // chunks // s.dp
    if s.pp == 1:
        cumulative = 1
    else:
        if chunks < s.pp:
            raise ValueError(f"chunks {chunks} < pp {s.pp}")
        cumulative = (s.pp - stage_idx if pipeline_type == "pipedream_flush"
                      else chunks)
    cum_lbsz = cumulative * lbsz

    z2, z3 = _zero_ratios(chunks, ctx.mixed_precision, ctx.async_grad_reduce)
    param_mem = ctx.parameter_size / s.tp
    model_states = 4 * param_mem
    if s.dp_type == DPType.ZERO3:
        model_states *= z3(s.sdp)
    elif s.dp_type == DPType.ZERO2:
        model_states *= z2(s.sdp)

    act = ctx.tp_activation_per_bsz_dict
    if s.checkpoint:
        activation = act["checkpoint"] * cum_lbsz
        if s.sp > 1 or (s.tp > 1 and ctx.sequence_parallel):
            activation /= s.tp_sp
    else:
        activation = act[s.tp_sp] * cum_lbsz
    # cp shards the sequence (ring attention): activations divide by cp;
    # model states do not (weights replicate over cp, but ZeRO already
    # shards states over sdp = dp*sp*cp above)
    activation /= s.cp
    return {"model_states_mb": model_states, "activation_mb": activation,
            "total_mb": model_states + activation}


def layer_memory_cost(
    s: "SearchStrategy",
    ctx: CostContext,
    gbsz: int,
    chunks: int,
    stage_idx: int = 0,
    pipeline_type: Optional[str] = None,
) -> float:
    """Per-layer memory in MB: model states + activations
    (MemoryCostModelBase, layer_cost.py:261-328)."""
    return layer_memory_components(
        s, ctx, gbsz, chunks, stage_idx, pipeline_type)["total_mb"]


# ---------------------------------------------------------------------------
# embedding / LM-head time
# ---------------------------------------------------------------------------


def embed_time_cost(
    s: "SearchStrategy",
    ctx: CostContext,
    gbsz: int,
    chunks: int,
    seq_len_list: Sequence[int],
) -> Tuple[List[float], List[float]]:
    """Per-pipeline-stage vocab-layer times in seconds (with, without grad
    sync); only first/last stages are nonzero (EmbeddingLMHeadTimeCostModel,
    embedding_lmhead_cost.py:59-184)."""
    lbsz = gbsz // chunks // s.dp
    pp = s.pp

    fct = [0.0] * pp
    ot = ctx.other_time_profiled
    if isinstance(ot, (np.ndarray, tuple, list)):
        fct_time = _linear(lbsz / s.tp_sp / s.cp, ot)
    else:
        fct_time = ot * lbsz / s.tp_sp / s.cp
    if pp == 1:
        fct[0] = fct_time
    else:
        fct[0] = fct_time / 2
        fct[-1] = fct_time / 2

    key = f"{s.sdp}_0" if s.tp != 1 else f"{s.sdp}_1"
    dp_coe = ctx.comm_coe_dict[key] * (s.sdp - 1) / s.sdp
    factor = 0.5 if ctx.mixed_precision else 1.0
    dp_message = [0.0] * pp
    if pp == 1:
        dp_message[0] = ctx.other_memory_pp_off["model_states"][s.tp] / 4 * factor
    else:
        dp_message[0] = (ctx.other_memory_pp_on["first_stage"]["model_states"]
                         [s.tp] / 4 * factor)
        dp_message[-1] = (ctx.other_memory_pp_on["last_stage"]["model_states"]
                          [s.tp] / 4 * factor)
    if s.dp_type == DPType.ZERO3:
        fwd_factor, bwd_factor = 0.5, 1.0
    else:
        fwd_factor, bwd_factor = 0.0, 0.5

    tp_sp_time = [0.0] * pp
    per_seq = []
    for seq in seq_len_list:
        if s.tp_sp == 1 or s.tp == 1:
            per_seq.append(0.0)
        else:
            message_mb = (lbsz * seq * ctx.hidden_size *
                          (2 if ctx.mixed_precision else 4) / 1024 / 1024)
            if not ctx.sequence_parallel:
                raise ValueError("sequence_parallel required when tp > 1")
            per_seq.append(
                _lookup_latency(ctx.allgather_latency[s.tp], message_mb))
    if pp == 1:
        tp_sp_time[0] = per_seq[0] + per_seq[-1]
    else:
        tp_sp_time[0] = per_seq[0]
        tp_sp_time[-1] = per_seq[-1]

    def overlap_time(f_comm, f_comp, b_comm, b_comp, tp_t):
        """Compute/comm overlap (embedding_lmhead_cost.py:155-166)."""
        f_comp = f_comp * ctx.dp_overlap_coe
        b_comp = b_comp * ctx.dp_overlap_coe
        fwd = (f_comm + (f_comp - f_comm) / ctx.dp_overlap_coe
               if f_comp > f_comm else f_comm)
        bwd = (b_comm + (b_comp - b_comm) / ctx.dp_overlap_coe
               if b_comp > b_comm else b_comm)
        return fwd + bwd + tp_t

    ms = 0.001
    cost = [0.0] * pp
    cost_no_sync = [0.0] * pp
    for idx in ([0] if pp == 1 else [0, pp - 1]):
        cost[idx] = ms * overlap_time(
            dp_message[idx] * dp_coe * fwd_factor, fct[idx],
            dp_message[idx] * dp_coe * bwd_factor,
            fct[idx] * ctx.bct_fct_coe, tp_sp_time[idx])
        cost_no_sync[idx] = ms * overlap_time(
            dp_message[idx] * dp_coe * fwd_factor, fct[idx],
            dp_message[idx] * dp_coe * (bwd_factor - 0.5),
            fct[idx] * ctx.bct_fct_coe, tp_sp_time[idx])
    return cost, cost_no_sync


# ---------------------------------------------------------------------------
# embedding / LM-head memory
# ---------------------------------------------------------------------------


def embed_memory_components(
    s: "SearchStrategy",
    ctx: CostContext,
    gbsz: int,
    chunks: int,
    pipeline_type: Optional[str] = None,
) -> Dict[str, List[float]]:
    """Per-stage vocab-layer memory in MB, decomposed
    (EmbeddingLMHeadMemoryCostModel, embedding_lmhead_cost.py:187-313) —
    the cross-checkable view of :func:`embed_memory_cost`, which sums the
    same three per-stage vectors (model states, activation, the flat
    allocator-context reserve)."""
    pipeline_type = pipeline_type or ctx.pipeline_type
    lbsz = gbsz // chunks // s.dp
    pp = s.pp
    z2, z3 = _zero_ratios(chunks, ctx.mixed_precision, ctx.async_grad_reduce)
    if s.dp_type == DPType.ZERO3:
        scale = z3(s.sdp)
    elif s.dp_type == DPType.ZERO2:
        scale = z2(s.sdp)
    else:
        scale = 1.0

    model_states = [0.0] * pp
    if pp == 1:
        model_states[0] = ctx.other_memory_pp_off["model_states"][s.tp] * scale
    else:
        model_states[0] = (ctx.other_memory_pp_on["first_stage"]
                           ["model_states"][s.tp] * scale)
        model_states[-1] = (ctx.other_memory_pp_on["last_stage"]
                            ["model_states"][s.tp] * scale)

    activation = [0.0] * pp
    if pp == 1:
        activation[0] = (ctx.other_memory_pp_off["activation"][s.tp_sp] * lbsz
                         / s.cp)
    else:
        if chunks < pp:
            raise ValueError(f"chunks {chunks} < pp {pp}")
        if pipeline_type == "pipedream_flush":
            cum_first, cum_last = pp, 1
        else:
            cum_first, cum_last = chunks, chunks
        activation[0] = (ctx.other_memory_pp_on["first_stage"]["activation"]
                         [s.tp_sp] * cum_first * lbsz / s.cp)
        activation[-1] = (ctx.other_memory_pp_on["last_stage"]["activation"]
                          [s.tp_sp] * cum_last * lbsz / s.cp)

    return {"model_states_mb": model_states, "activation_mb": activation,
            "context_mb": [ctx.pytorch_context_mem] * pp}


def embed_memory_cost(
    s: "SearchStrategy",
    ctx: CostContext,
    gbsz: int,
    chunks: int,
    pipeline_type: Optional[str] = None,
) -> List[float]:
    """Per-stage vocab-layer memory in MB (EmbeddingLMHeadMemoryCostModel,
    embedding_lmhead_cost.py:187-313)."""
    comp = embed_memory_components(s, ctx, gbsz, chunks, pipeline_type)
    return [m + a + c for m, a, c in zip(
        comp["model_states_mb"], comp["activation_mb"], comp["context_mb"])]


# ---------------------------------------------------------------------------
# model FLOPs accounting (telemetry: MFU denominator numerator)
# ---------------------------------------------------------------------------


def model_flops_per_token(model: Any, seq_length: Optional[int] = None
                          ) -> float:
    """Matmul FLOPs per token for one training step (forward + backward,
    backward counted as 2x forward). ``model`` is a
    ``core.args_schema.ModelArgs``-shaped object (duck-typed so this module
    stays import-light).

    Conventions (the standard MFU accounting, PaLM appendix B style):
    the [S, S] attention score/value matmuls are counted dense — no causal
    discount — and non-matmul work (norms, softmax, embedding lookup) is
    ignored. MoE layers count only the ACTIVE experts (top-k + shared);
    with ``moe_layer_freq = k`` every k-th layer is MoE and the rest are
    dense (models/builder.py layer alternation).
    """
    h = model.hidden_size
    s = seq_length or model.seq_length
    nd = model.num_attention_heads * model.head_dim
    kd = model.kv_heads * model.head_dim
    # q/k/v/out projections + the two [S, S] batched matmuls (QK^T, PV)
    attn = 2 * h * nd + 2 * 2 * h * kd + 2 * nd * h + 2 * 2 * s * nd
    gated = model.hidden_act in ("swiglu", "geglu")

    def mlp_flops(ffn: int) -> float:
        return (3 if gated else 2) * 2 * h * ffn

    dense_layer = attn + mlp_flops(model.ffn_dim)
    layers = model.num_hidden_layers + (model.num_encoder_layers or 0
                                        if model.model_type == "t5" else 0)
    if model.num_experts:
        moe_ffn = model.moe_ffn_hidden_size or model.ffn_dim
        active = model.moe_topk + model.num_shared_experts
        moe_layer = (attn + 2 * h * model.num_experts  # router
                     + active * mlp_flops(moe_ffn))
        freq = max(model.moe_layer_freq, 1)
        n_moe = layers // freq
        fwd = n_moe * moe_layer + (layers - n_moe) * dense_layer
    else:
        fwd = layers * dense_layer
    fwd += 2 * h * model.padded_vocab_size  # LM head
    return 3.0 * fwd


# ---------------------------------------------------------------------------
# pipeline schedule cost
# ---------------------------------------------------------------------------


def pipeline_time_cost(
    layer_num_list: Sequence[int],
    contexts: Sequence[CostContext],
    strategy_list: Sequence["SearchStrategy"],
    partition: Sequence[int],
    chunks: int,
    gbsz: int,
    pp_size: int,
    other_time_cost: Sequence[float],
) -> float:
    """End-to-end pipeline time for a concrete per-layer plan (reference
    pipeline_costmodel, cost_model_handler.py:16-99): per-stage sums of
    per-layer costs, a warmup/cooldown bubble estimate, and the straggling
    gradient-reduce tail."""
    total = sum(layer_num_list)
    assert len(strategy_list) == total
    layertype_of = []
    for t, n in enumerate(layer_num_list):
        layertype_of.extend([t] * n)

    uniq = list(set(strategy_list))
    sync_cost: Dict[Tuple[int, "SearchStrategy"], float] = {}
    nosync_cost: Dict[Tuple[int, "SearchStrategy"], float] = {}
    for t in range(len(layer_num_list)):
        for s in uniq:
            w, wo = layer_time_cost(s, contexts[t], gbsz, chunks)
            sync_cost[(t, s)] = w
            nosync_cost[(t, s)] = wo

    per_layer_sync = [sync_cost[(layertype_of[i], strategy_list[i])]
                      for i in range(total)]
    per_layer_nosync = [nosync_cost[(layertype_of[i], strategy_list[i])]
                        for i in range(total)]

    def stage_sums(vals):
        out, start = [], 0
        for n in partition:
            out.append(float(np.sum(vals[start:start + n])))
            start += n
        return out

    stage_sync = stage_sums(per_layer_sync)
    stage_compute = stage_sums(per_layer_nosync)
    assert len(other_time_cost) == len(stage_compute)
    stage_compute = [c + o for c, o in zip(stage_compute, other_time_cost)]

    result = float(np.sum(stage_compute)) + stage_compute[-1] * (chunks - 1)
    # warmup/cooldown bubbles partially overlap (handler.py:82-85)
    result = max(
        result,
        max(min(pp_size - 1, chunks - 1) * stage_compute[0] * 1 / 3,
            float(np.sum(stage_compute[1:])) * 1 / 3)
        + max(min(pp_size - 1, chunks - 1) * stage_compute[0] * 2 / 3,
              float(np.sum(stage_compute[1:])) * 2 / 3)
        + stage_compute[0] * max(0, chunks + 1 - pp_size))

    stage_reduce = list(stage_sync)
    for i in range(pp_size):
        stage_reduce[i] -= float(np.sum(stage_compute[:i + 1]))
    reduce_tail = max(stage_reduce)
    result += reduce_tail if reduce_tail > 0 else 0.0

    # host-sequenced dispatch overhead (tools/pipeline_dispatch_bench.py):
    # every (stage, microbatch) leg costs one fwd + one bwd jitted-call
    # dispatch on the host, which the single-program compiled schedule
    # eliminates. This is what lets the search's pp choice price the two
    # pipeline.schedule_impl flavours differently: deep pp under the host
    # impl pays dispatch linearly in pp * chunks. The waiver only applies
    # to plans the compiled engine can EXPRESS (it falls back to the host
    # engine otherwise — CompiledPipelineEngine.unsupported_reason): 1F1B
    # only, uniform stage partition, uniform per-layer strategy. cp plans
    # qualify since the engine de-vmapped its stage axis (the ring kernel
    # runs inside the fused program), so on an overlap-expressible tp plan
    # the dispatch waiver and the tp_overlap discount now COMPOSE — the
    # product neither effect produces alone (tests/search_engine/
    # test_dispatch_cost.py pins a plan flip that needs both).
    ctx0 = contexts[0]
    if pp_size > 1 and ctx0.dispatch_us:
        if not search_compiled_expressible(
                ctx0.schedule_impl, ctx0.pipeline_type, partition,
                strategy_list):
            result += ctx0.dispatch_us * 1e-6 * 2 * pp_size * chunks
    return result


# ---------------------------------------------------------------------------
# stored-plan re-pricing (calibration / plan-regret sentinel)
# ---------------------------------------------------------------------------


def reprice_stored_plan_ms(
    plan: Dict[str, Any],
    *,
    seq_len: int,
    hidden_size: int,
    param_mb: float,
    mixed_precision: bool = True,
    alpha_beta: Optional[Dict[str, Tuple[float, float]]] = None,
    alpha_beta_algos: Optional[
        Dict[str, Dict[str, Tuple[float, float]]]] = None,
) -> Optional[float]:
    """Per-device per-step collective ms of a stored strategy spec under a
    given α-β curve set — the pricing half of the plan-regret sentinel
    (``observability.calibration``).

    ``plan`` is the shape ``SearchEngine.save_results`` embeds per
    runner-up: ``{"layers": [{"tp", "dp", "cp", "sp", "ckpt",
    "consec"}, ...], "pp", "bsz", "chunks"}``. The arithmetic mirrors
    ``trace_analysis.predicted_comm_per_step``'s flat tp/dp pricing (same
    message sizes, counts and per-pp scaling), so re-pricing a plan under
    the curves the calibrator fit from audit residuals compares
    like-for-like with the audit's own predictions. Returns None when no
    curve prices any component (then the caller must not fabricate a
    regret from a half-priced plan)."""
    mb_unit = 1024 * 1024
    ab = alpha_beta or {}
    ab_algos = alpha_beta_algos or {}
    pp = max(int(plan.get("pp", 1) or 1), 1)
    chunks = max(int(plan.get("chunks", 1) or 1), 1)
    bsz = max(int(plan.get("bsz", 1) or 1), 1)
    elem = 2 if mixed_precision else 4
    total = 0.0
    priced = False
    for layer in plan.get("layers") or []:
        if not isinstance(layer, dict):
            continue
        tp_full = max(int(layer.get("tp", 1) or 1), 1)
        sp = bool(layer.get("sp", 0))
        tp = 1 if sp else tp_full
        dp = max(int(layer.get("dp", 1) or 1), 1)
        cp = max(int(layer.get("cp", 1) or 1), 1)
        ckpt = bool(layer.get("ckpt", 0))
        if tp > 1:
            lbsz = max(bsz // chunks // dp, 1)
            act_mb = lbsz * seq_len * hidden_size * elem / mb_unit
            n_msgs = 6 * chunks * (1.5 if ckpt else 1.0)
            scale = n_msgs * 0.5 / pp
            cands = []
            pair = ab.get(f"{tp}_1")
            if pair:
                cands.append((pair[0] + act_mb / pair[1]) * scale)
            for alg_lvl, (alpha, beta) in (
                    ab_algos.get(f"{tp}_1") or {}).items():
                if alg_lvl.endswith("_ici") and beta:
                    cands.append((alpha + act_mb / beta) * scale)
            if cands:
                total += min(cands)
                priced = True
        sdp = max(dp * cp * (tp_full if sp else 1), 1)
        if sdp > 1:
            consec = 1 if tp == 1 else 0
            pair = (ab.get(f"{sdp}_{consec}") or ab.get(f"{sdp}_1")
                    or ab.get(f"{sdp}_0"))
            if pair:
                grad_mb = param_mb / max(tp, 1) * \
                    (0.5 if mixed_precision else 1.0)
                total += (pair[0] + grad_mb / pair[1]) / pp
                priced = True
    return total if priced else None
