"""Galvatron-style hybrid-parallel strategy search engine.

Port of ``hetu_galvatron_tpu/core/search_engine/engine.py``:
``SearchEngine`` with ``initialize``, ``optimize`` (the thread pool of
``search.parallel_search`` too), ``solve_task``, ``_solve_coarse``,
``pp_division_balanced``, ``check_cost_model``, the static HBM gate
``_hbm_gate`` (:367), ``save_results`` with its hierarchical dp record
(:761-826), ``_runner_ups`` and ``_write_search_trace`` (over the port's
``observability/sinks.JsonlSink``). It enumerates candidate per-layer
strategies, prices them with the cost model against the profiled model
and hardware files, solves a per-stage knapsack DP over (layer, memory,
strategy) with inter-layer transition costs, and writes the winning plan
as a ``galvatron_config_*.json`` that ``runtime/hybrid_config.py`` reads.

The outer loop sweeps (global bsz, chunks, pp degree, tp-vs-ulysses mode,
max tp degree); each task runs the DP per stage per vocab strategy and
scores the plan with the pipeline cost model. Every operation is JAX's, in
JAX's order, so the same profiles give the same throughput and the same
plan JSON, bit for bit. With ``search.hbm_budget_gb > 0`` each task's
winner passes the memory doctor's predicate
(``analysis/memory_doctor.py::search_result_hbm_reason``, the one
``cli/check.py --memory --hbm-gb`` applies); with ``search.hier_dp=1`` the
plan records ``hier_dp``, ``hier_bucket_mb``, ``dp_schedule`` and
``dp_schedule_rankings`` as JAX's does. The port's runtime still refuses
``hier_dp=1`` plans (ROADMAP items 12d and 14b).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from hetu_galvatron_tpu_torch.core.args_schema import SearchArgs
from hetu_galvatron_tpu_torch.core.cost_model.cost import (
    CostContext,
    embed_memory_cost,
    embed_time_cost,
    layer_memory_cost,
    layer_time_components,
    layer_time_cost,
    pipeline_time_cost,
)
from hetu_galvatron_tpu_torch.core.search_engine.dp import dp_solve
from hetu_galvatron_tpu_torch.core.search_engine.profiles import (
    HardwareProfile,
    ModelProfile,
    load_hardware_profile,
    load_model_profile,
    write_json,
)
from hetu_galvatron_tpu_torch.core.search_engine.strategies import (
    SearchSpaceLimits,
    SearchStrategy,
    enumerate_strategies,
    is_power_of_two,
    pp_division_even,
)
from hetu_galvatron_tpu_torch.utils.strategy import (
    DPType,
    EmbeddingLMHeadStrategy,
    strategy_list2config,
)


@dataclass
class TaskResult:
    throughput: float = -1.0
    time_cost: float = float("inf")
    strategy_list: Optional[List[SearchStrategy]] = None
    pp_size: int = 1
    pp_stage_list: Optional[List[int]] = None
    memory_remain: Optional[List[int]] = None
    memory_cost: Optional[List[float]] = None
    vocab_tp_sp: int = -1
    vocab_sp: int = 0
    vocab_sdp: int = 0
    bsz: int = 0
    chunks: int = 1


def _match_except(former: SearchStrategy, latter: SearchStrategy,
                  diff: Sequence[str]) -> bool:
    """True when the two strategies agree on everything except (exactly) the
    ``diff`` dimensions (reference match_strategy,
    dynamic_programming.py:161-210). Used for the DP's tiny tie-break biases
    that order fsdp/checkpoint/sp transitions."""
    diff = sorted(diff)
    same = {
        "pp": former.pp == latter.pp,
        "tp": former.tp == latter.tp,
        "sp": former.sp == latter.sp,
        "tp_sp": former.tp_sp == latter.tp_sp,
        "dp": former.dp == latter.dp,
        "dp_type": former.dp_type == latter.dp_type,
        "checkpoint": former.checkpoint == latter.checkpoint,
    }
    if diff == ["sp"]:
        return (same["pp"] and same["tp_sp"] and same["dp"]
                and same["checkpoint"] and same["dp_type"] and not same["sp"])
    if diff == ["fsdp"]:
        return (same["pp"] and same["tp"] and same["sp"] and same["dp"]
                and same["checkpoint"] and not same["dp_type"])
    if diff == ["cpt"]:
        return (same["pp"] and same["tp"] and same["sp"] and same["dp"]
                and same["dp_type"] and not same["checkpoint"])
    if diff == sorted(["fsdp", "cpt"]):
        return (same["pp"] and same["tp"] and same["sp"] and same["dp"]
                and not (same["dp_type"] and same["checkpoint"]))
    return True


class SearchEngine:
    """Offline planner: profiled JSONs in, galvatron_config JSON out."""

    def __init__(self, args: SearchArgs, *, mixed_precision: str = "bf16",
                 default_dp_type: Optional[str] = None,
                 pipeline_type: Optional[str] = None,
                 model_cfg: Any = None):
        self.args = args
        self.world_size = args.num_nodes * args.num_devices_per_node
        self.memory_constraint = int(args.memory_constraint * 1024)  # MB
        self.mixed_precision = mixed_precision
        self.default_dp_type = default_dp_type or args.default_dp_type
        self.pipeline_type = pipeline_type or args.pipeline_type
        self.model_name: Optional[str] = None
        self.hardware: Optional[HardwareProfile] = None
        self.profile: Optional[ModelProfile] = None
        # ModelArgs for the static HBM gate (args.hbm_budget_gb): the
        # profiled memory the DP enforces and the doctor's analytic
        # accounting are independent models, and the gate makes the
        # search reject exactly what `check --memory --hbm-gb` would
        self.model_cfg = model_cfg

    # ---------------- setup ----------------

    def set_model_info(self, model_layer_configs: List[Dict[str, Any]],
                       model_name: str, model_type: str = "gpt") -> None:
        """model_layer_configs rows: hidden_size / seq_len / layer_num
        (reference set_model_layer_configs, search_engine.py:84-91).
        Encoder-decoder models (t5) search the combined enc+dec stack:
        layertype 0 is the encoder, the plan JSON records the split point
        (num_encoder_layers) and the runtime pipelines either stack."""
        self.num_encoder_layers: Optional[int] = None
        if model_type == "t5":
            # adapter convention: layertype 0 is the encoder, omitted when
            # the model has zero encoder layers
            self.num_encoder_layers = (
                model_layer_configs[0]["layer_num"]
                if len(model_layer_configs) > 1 else 0)
        self.hiddensize_list = [c["hidden_size"] for c in model_layer_configs]
        self.layernum_list = [c["layer_num"] for c in model_layer_configs]
        self.seqlen_list = [c["seq_len"] for c in model_layer_configs]
        self.num_layertype = len(self.layernum_list)
        self.total_layernum = sum(self.layernum_list)
        self.model_name = model_name

    def _limits(self) -> SearchSpaceLimits:
        a = self.args
        return SearchSpaceLimits(
            max_pp_deg=a.max_pp_deg, max_tp_deg=a.max_tp_deg,
            max_sp_deg=a.max_sp_deg, max_cp_deg=a.max_cp_deg,
            disable_pp=a.disable_pp, disable_tp=a.disable_tp,
            disable_sp=a.disable_ulysses, disable_cp=a.disable_cp,
            disable_dp=a.disable_dp, disable_ckpt=a.disable_ckpt,
            disable_fsdp=a.disable_sdp, disable_vocab_tp=a.disable_vtp,
            disable_vocab_sp=a.disable_vsp)

    def initialize(self) -> None:
        """Strategy enumeration + profile loading + cost-context construction
        (reference initialize_search_engine, search_engine.py:97-108)."""
        a = self.args
        self.layer_strategies, self.vocab_strategies = enumerate_strategies(
            self.world_size, self.total_layernum, self._limits(),
            self.default_dp_type)
        self.profile = load_model_profile(
            time_path=a.time_profiling_path,
            memory_path=a.memory_profiling_path,
            time_mode=a.time_profile_mode,
            memory_mode=a.memory_profile_mode,
            num_layertype=self.num_layertype,
            seqlen_list=self.seqlen_list,
            sequence_parallel=a.sequence_parallel)
        self.hardware = load_hardware_profile(
            allreduce_path=a.allreduce_bandwidth_config_path,
            p2p_path=a.p2p_bandwidth_config_path,
            overlap_path=a.overlap_coe_path,
            sp_time_path=a.sp_time_path,
            world_size=self.world_size)
        self.contexts = [self._make_context(i)
                         for i in range(self.num_layertype)]

    def _make_context(self, i: int) -> CostContext:
        hw, mp = self.hardware, self.profile
        return CostContext(
            parameter_size=mp.param_sizes[i],
            seq_length=self.seqlen_list[i],
            hidden_size=self.hiddensize_list[i],
            layer_num=self.layernum_list[i],
            mixed_precision=self.mixed_precision != "fp32",
            async_grad_reduce=self.args.async_grad_reduce,
            sequence_parallel=self.args.sequence_parallel,
            pipeline_type=self.pipeline_type,
            forward_computation_time=mp.time_profiled_list[i],
            other_time_profiled=mp.other_time_profiled_list[
                min(i, len(mp.other_time_profiled_list) - 1)],
            tp_activation_per_bsz_dict=mp.act_sizes[i],
            other_memory_pp_off=mp.other_memory_pp_off,
            other_memory_pp_on=mp.other_memory_pp_on,
            comm_coe_dict=hw.allreduce_coe,
            dp_overlap_coe=hw.overlap_coe,
            bct_overlap_coe=hw.overlap_coe,
            p2p_comm_coe_dict=hw.p2p_coe,
            costmodel_coe=self.args.costmodel_coe,
            allgather_latency=hw.allgather_latency,
            all2all_latency=hw.all2all_latency,
            allreduce_latency=hw.allreduce_latency,
            dispatch_us=self.args.dispatch_us,
            schedule_impl=self.args.pipeline_schedule_impl,
            tp_alpha_beta=hw.alpha_beta,
            tp_overlap=bool(self.args.tp_overlap),
            alpha_beta_algos=hw.alpha_beta_algos,
            hier_dp=bool(self.args.hier_dp),
            hier_bucket_mb=float(getattr(self.args, "hier_bucket_mb", 0.0)),
            # the search's topology model: nodes are the cross-DCN level
            # (mesh.dcn_factor_shape's slice granularity)
            dcn_slices=max(self.args.num_nodes, 1),
        )

    # ---------------- outer loop ----------------

    def _bsz_candidates(self) -> List[int]:
        a = self.args
        if a.settle_bsz and a.settle_bsz > 0:
            return [a.settle_bsz]
        lo = max(a.min_bsz, a.bsz_scale)
        return list(range(lo, a.max_bsz + 1, a.bsz_scale))

    def optimize(self) -> float:
        """Full sweep; returns max throughput in samples/s and writes the
        winning plan (reference parallelism_optimization,
        search_engine.py:520-644)."""
        a = self.args
        pp_range = sorted({s.pp for s in self.vocab_strategies})
        tasks = []
        for gbsz in self._bsz_candidates():
            chunk_list = ([a.settle_chunks] if a.settle_chunks != -1
                          else range(1, gbsz + 1))
            for chunks in chunk_list:
                if gbsz % chunks:
                    continue
                for pp in pp_range:
                    if pp > chunks or pp > self.total_layernum:
                        continue
                    max_tp = self.world_size // pp
                    if a.max_tp_deg != -1:
                        max_tp = min(max_tp, a.max_tp_deg)
                    max_dp = max(min(gbsz // chunks, self.world_size // pp), 1)
                    min_tp = max(self.world_size // pp // max_dp, 1)
                    for mode in ("tp_only", "sp_only", "tp_with_sp"):
                        if mode == "sp_only":
                            tp_caps = [max_tp]
                        else:
                            tp_caps = [t for t in range(min_tp, max_tp + 1)
                                       if is_power_of_two(t)
                                       and t * pp <= self.world_size]
                        for cap in tp_caps:
                            tasks.append((gbsz, chunks, pp, mode, cap))

        solve = lambda t: self.solve_task(t[0], t[1], t[2], t[4], t[3])
        if a.parallel_search and len(tasks) > 1:
            # thread pool (reference search_engine.py:579-610): the C++ DP
            # core runs outside the GIL, so threads overlap the hot loop
            import concurrent.futures as cf

            with cf.ThreadPoolExecutor(max_workers=min(8, len(tasks))) as ex:
                results = list(ex.map(solve, tasks))
        else:
            results = list(map(solve, tasks))
        results = [self._hbm_gate(r) for r in results]
        best = TaskResult()
        for r in results:
            if r.throughput > best.throughput:
                best = r
        self._write_search_trace(tasks, results, best)
        if best.throughput > 0:
            self.save_results(best, runner_ups=self._runner_ups(results,
                                                                best))
        return best.throughput

    def _runner_ups(self, results: List[TaskResult], best: TaskResult
                    ) -> List[Dict[str, Any]]:
        """The top-``args.runner_up_k`` feasible non-winning candidates
        (deduped by plan signature, throughput-ordered) in the stored
        shape ``cost_model.reprice_stored_plan_ms`` prices — embedded in
        the plan JSON so the runtime's plan-regret sentinel
        (``observability.calibration``) can re-price "the plans the search
        almost picked" under calibrated curves long after the search
        ran."""
        from hetu_galvatron_tpu_torch.utils.strategy import form_strategy

        k = max(int(getattr(self.args, "runner_up_k", 0) or 0), 0)
        if k == 0:
            return []

        def sig(r: TaskResult) -> Tuple:
            return (r.bsz, r.chunks, r.pp_size,
                    tuple(s.to_runtime().key() for s in r.strategy_list),
                    tuple(r.pp_stage_list or ()))

        seen = {sig(best)} if best.strategy_list is not None else set()
        out: List[Dict[str, Any]] = []
        for r in sorted((r for r in results
                         if r.strategy_list is not None
                         and r.throughput > 0),
                        key=lambda r: -r.throughput):
            s = sig(r)
            if s in seen:
                continue
            seen.add(s)
            layers = []
            for st in r.strategy_list:
                rt = st.to_runtime()
                layers.append({
                    "tp": rt.tp_size, "dp": rt.dp_size, "cp": rt.cp_size,
                    "sp": int(rt.sp), "ckpt": int(rt.checkpoint),
                    "consec": int(rt.tp_consecutive)})
            out.append({
                "throughput": round(r.throughput, 6),
                "time_cost_ms": round(r.time_cost * 1e3, 6),
                "bsz": r.bsz, "chunks": r.chunks, "pp": r.pp_size,
                "strategies": [form_strategy(st.to_runtime())
                               for st in r.strategy_list],
                "layers": layers})
            if len(out) >= k:
                break
        return out

    def _write_search_trace(self, tasks, results, best: TaskResult) -> None:
        """Audit trail: one JSONL event per explored task + the winner
        (args.search_trace_path; observability/sinks.py record schema), so
        "why did the search pick this plan" is answerable after the fact."""
        if not self.args.search_trace_path:
            return
        import time as _time

        from hetu_galvatron_tpu_torch.observability.sinks import JsonlSink
        from hetu_galvatron_tpu_torch.utils.strategy import form_strategy

        sink = JsonlSink(self.args.search_trace_path)
        for (gbsz, chunks, pp, mode, cap), r in zip(tasks, results):
            data = {"bsz": gbsz, "chunks": chunks, "pp": pp, "mode": mode,
                    "max_tp": cap, "throughput": r.throughput,
                    "time_cost": (None if r.time_cost == float("inf")
                                  else r.time_cost),
                    "feasible": r.strategy_list is not None}
            if r.strategy_list is not None:
                data["pp_division"] = r.pp_stage_list
                data["memory_cost_mb"] = r.memory_cost
                data["vocab"] = {"vtp": r.vocab_tp_sp, "vsp": r.vocab_sp,
                                 "embed_sdp": r.vocab_sdp}
            sink.write({"t": _time.time(), "kind": "event",
                        "name": "search_task", "data": data})
        win = {"throughput": best.throughput, "bsz": best.bsz,
               "chunks": best.chunks, "pp": best.pp_size,
               "feasible": best.strategy_list is not None}
        if best.strategy_list is not None:
            win["strategies"] = [form_strategy(s.to_runtime())
                                 for s in best.strategy_list]
        sink.write({"t": _time.time(), "kind": "event",
                    "name": "search_best", "data": win})
        sink.close()

    def _hbm_gate(self, r: TaskResult) -> TaskResult:
        """Static HBM gate (``args.hbm_budget_gb`` > 0, model config
        known): prune a feasible candidate whose memory-doctor peak
        busts the budget — the SAME predicate ``cli/check.py --memory
        --hbm-gb`` applies to the written plan
        (``analysis/memory_doctor.py::search_result_hbm_reason``).
        Always accounted under the COMPILED-engine convention (the
        checker's default, and the strict upper bound: it adds the
        stage-input buffer and the vocab replication premium the host
        engine doesn't pay), so a plan the search emits can never be one
        ``check --memory --hbm-gb`` rejects — regardless of which
        schedule impl the search was pricing time for.

        Known altitude limitation: the gate runs POST-DP, on each
        (bsz, chunks, pp) task's time-optimal winner — a pruned task may
        still have a slower within-budget runner-up the DP never
        surfaced (the DP's own memory constraint is the PROFILED
        ``memory_constraint``, not this analytic one). Folding the
        analytic predicate into candidate filtering is future work; the
        gate's contract today is a backstop, not an optimizer."""
        a = self.args
        if (a.hbm_budget_gb <= 0 or self.model_cfg is None
                or r.strategy_list is None):
            return r
        from hetu_galvatron_tpu_torch.analysis.memory_doctor import (
            search_result_hbm_reason,
        )

        reason = search_result_hbm_reason(
            r.strategy_list, r.pp_stage_list, self.model_cfg,
            global_bsz=r.bsz, chunks=r.chunks,
            pipeline_type=self.pipeline_type,
            schedule_impl="compiled",
            hbm_gb=a.hbm_budget_gb,
            vocab_tp_sp=r.vocab_tp_sp, vocab_sp=bool(r.vocab_sp),
            vocab_sdp=bool(r.vocab_sdp),
            mixed_precision=self.mixed_precision != "fp32")
        if reason is None:
            return r
        print(f"hbm gate: pruned candidate (bsz {r.bsz} chunks {r.chunks} "
              f"pp {r.pp_size}): {reason}")
        return TaskResult(bsz=r.bsz, chunks=r.chunks)

    # ---------------- per-task DP ----------------

    def _filter_for_task(self, strategies, pp, max_tp, max_dp, mode):
        out = [s for s in strategies if s.pp == pp and s.tp_sp <= max_tp
               and s.dp <= max_dp]
        if mode == "tp_only":
            out = [s for s in out if s.sp == 1]
        elif mode == "sp_only":
            out = [s for s in out if s.tp == 1]
        return out

    def _global_buffer_mb(self, gbsz, chunks, pp, cap, mode) -> float:
        """Megatron global memory buffer reserve (dynamic_programming.py:
        232-239). NOTE: the reference halves this whenever mixed_precision is
        a non-empty string — i.e. always, even for fp32; replicated for
        golden parity."""
        a = self.args
        if not (a.sequence_parallel and a.global_memory_buffer
                and mode != "sp_only"):
            return 0.0
        cur_dp = self.world_size // pp // cap
        cur_lbsz = gbsz / chunks / cur_dp
        mb = (cur_lbsz * self.hiddensize_list[0] * max(self.seqlen_list)
              * 4 / 1024 / 1024)
        return mb / 2

    def _inter_layer_cost(self, layer_strategies, gbsz, chunks, pp
                          ) -> np.ndarray:
        """Transition costs between adjacent layers with different strategies:
        a real resharding cost when tp_sp changes, else epsilon tie-breaks
        (dynamic_programming.py:467-517)."""
        n = len(layer_strategies)
        total = self.total_layernum
        out = np.zeros((total, n, n))
        for t in range(self.num_layertype):
            res = np.zeros((n, n))
            for fi, former in enumerate(layer_strategies):
                for li, latter in enumerate(layer_strategies):
                    if fi == li:
                        continue
                    if (self.args.sequence_parallel
                            and former.tp_sp != latter.tp_sp):
                        big = max(former.tp_sp, latter.tp_sp)
                        cur_dp = self.world_size // pp // big
                        cur_lbsz = gbsz / chunks / cur_dp
                        sample = (self.seqlen_list[t] * self.hiddensize_list[0]
                                  * (4 if self.mixed_precision == "fp32"
                                     else 2))
                        cost = (big - 1) / big * cur_lbsz * sample
                        coe_dict = self.hardware.allreduce_coe
                        if big == 1 or cur_dp == 1:
                            coe = coe_dict.get(f"{big}",
                                               coe_dict.get(f"{big}_1"))
                        else:
                            coe = coe_dict[f"{big}_1"]
                        res[fi, li] = cost * coe * 1e-7
                    else:
                        if _match_except(former, latter, ["sp"]) \
                                and latter.sp > 1:
                            res[fi, li] = 1e-10
                        if _match_except(former, latter, ["fsdp"]) \
                                and latter.dp_type == DPType.ZERO3:
                            res[fi, li] = 1e-9
                        if _match_except(former, latter, ["cpt"]) \
                                and latter.checkpoint:
                            res[fi, li] = 2e-9
                        if _match_except(former, latter, ["fsdp", "cpt"]) \
                                and latter.dp_type == DPType.ZERO3 \
                                and latter.checkpoint:
                            res[fi, li] = 3e-9
                        if (_match_except(former, latter, ["fsdp", "cpt"])
                                and not _match_except(former, latter, ["fsdp"])
                                and not _match_except(former, latter, ["cpt"])
                                and former.dp_type == DPType.ZERO3
                                and latter.checkpoint):
                            res[fi, li] = 1e-9
            lo = sum(self.layernum_list[:t])
            out[lo:lo + self.layernum_list[t]] = res
        out[0, :, :] = 0  # first layer has no predecessor
        return out

    def pp_division_balanced(self, gbsz: int, chunks: int, pp: int
                             ) -> List[int]:
        """Memory-balanced stage division (reference
        pp_division_memory_balanced, search_engine.py:954-1058): greedily
        fill stages to the average memory of a ZeRO-2 dp baseline (gpipe
        accounting), then rebalance overweight/empty stages. Used for
        multi-layertype models, where even layer counts put uneven memory
        on stages (reference get_pp_stage_for_bsz single_layer_even)."""
        if pp == 1:
            return [self.total_layernum]
        base = SearchStrategy(pp=pp, tp=1, sp=1, cp=1,
                              dp=self.world_size // pp,
                              dp_type=DPType.ZERO2)
        per_type = [layer_memory_cost(base, self.contexts[t], gbsz, chunks,
                                      stage_idx=0, pipeline_type="gpipe")
                    for t in range(self.num_layertype)]
        layer_costs: List[float] = []
        for t, n in enumerate(self.layernum_list):
            layer_costs += [per_type[t]] * n
        other = list(embed_memory_cost(base.vocab_variant(),
                                       self.contexts[0], gbsz, chunks,
                                       pipeline_type="gpipe"))
        avg = (sum(layer_costs) + sum(other)) / pp

        divide = [0] * pp
        stage_mem = list(other)
        idx = 0
        for i in range(pp):
            while idx < len(layer_costs):
                if i < pp - 1 and avg - stage_mem[i] < 0.5 * layer_costs[idx]:
                    break
                stage_mem[i] += layer_costs[idx]
                idx += 1
                divide[i] += 1
        # drain overweight early stages forward
        for i in range(pp - 1):
            left = sum(divide[:i])
            right = left + divide[i]
            cur = sum(layer_costs[left:right]) + other[i]
            while cur > avg * 1.3 and divide[i] > 0:
                divide[i] -= 1
                divide[i + 1] += 1
                right -= 1
                cur -= layer_costs[right]
        # no empty stages
        for i in range(pp - 1):
            while divide[i] <= 0:
                divide[i] += 1
                divide[i + 1] -= 1
        for i in range(pp - 1, 0, -1):
            while divide[i] <= 0:
                divide[i] += 1
                divide[i - 1] -= 1
        return divide

    def check_cost_model(self, gbsz: int, chunks: int,
                         strategies: Optional[List[SearchStrategy]] = None
                         ) -> List[Dict[str, Any]]:
        """Developer introspection (reference check_cost_model,
        search_engine.py:788): evaluate every candidate strategy's per-layer
        time and per-stage memory at (gbsz, chunks), print a table, and
        return the rows for programmatic use."""
        rows: List[Dict[str, Any]] = []
        for s in (strategies if strategies is not None
                  else self.layer_strategies):
            if s.pp > chunks or gbsz // chunks < s.dp:
                continue
            time_sync, time_nosync = layer_time_cost(
                s, self.contexts[0], gbsz, chunks)
            mem = [layer_memory_cost(s, self.contexts[0], gbsz, chunks,
                                     stage_idx=st,
                                     pipeline_type=self.pipeline_type)
                   for st in range(s.pp)]
            vs = s.vocab_variant()
            vmem = embed_memory_cost(vs, self.contexts[0], gbsz, chunks,
                                     pipeline_type=self.pipeline_type)
            row = {"strategy": s.simple_string(), "time": time_sync,
                   "time_no_sync": time_nosync, "layer_memory": mem,
                   "vocab_memory": list(vmem)}
            rows.append(row)
            print(f"check_cost_model[{s.simple_string()}]: "
                  f"time {time_sync * 1e3:.3f} ms "
                  f"(no-sync {time_nosync * 1e3:.3f}) "
                  f"mem/layer {mem[0]:.1f} MB vocab {vmem[0]:.1f} MB")
        return rows

    def solve_task(self, gbsz: int, chunks: int, pp: int, cap: int,
                   mode: str) -> TaskResult:
        """One (bsz, chunks, pp, mode, max-tp) cell (reference
        search_for_single_task + _build_dp_and_run_multi_layer_type)."""
        max_dp = max(min(gbsz // chunks, self.world_size // pp), 1)
        layer_list = self._filter_for_task(
            self.layer_strategies, pp, cap, max_dp, mode)
        vocab_list = self._filter_for_task(
            self.vocab_strategies, pp, cap, max_dp, mode)
        if not layer_list or not vocab_list:
            return TaskResult(bsz=gbsz, chunks=chunks)
        vocab_list = sorted(vocab_list, key=SearchStrategy.sort_key)
        # single-layertype models keep the reference's even split (golden
        # parity); multi-layertype (t5/moe) stacks balance stage memory
        partition = (pp_division_even(self.layernum_list, pp)
                     if self.num_layertype == 1
                     else self.pp_division_balanced(gbsz, chunks, pp))

        # memory budget with the reserved allocator cache
        # (dynamic_programming.py:154-159)
        max_mem = self.memory_constraint
        mem_cache = 0
        if max_mem // 1024 > 20:
            mem_cache = int(max_mem * 0.2)
            max_mem -= mem_cache
        global_mb = self._global_buffer_mb(gbsz, chunks, pp, cap, mode)

        if not self.args.fine_grained_mode:
            return self._solve_coarse(gbsz, chunks, pp, partition, layer_list,
                                      max_mem, mem_cache, global_mb)

        n = len(layer_list)
        total = self.total_layernum
        intra = np.zeros((total, n))
        for t in range(self.num_layertype):
            row = [layer_time_cost(s, self.contexts[t], gbsz, chunks)[0]
                   for s in layer_list]
            lo = sum(self.layernum_list[:t])
            intra[lo:lo + self.layernum_list[t]] = np.asarray(row)

        mem = [np.zeros((total, n), np.int64) for _ in range(pp)]
        for stage in range(pp):
            for t in range(self.num_layertype):
                row = np.ceil([layer_memory_cost(
                    s, self.contexts[t], gbsz, chunks, stage_idx=stage,
                    pipeline_type=self.pipeline_type) for s in layer_list]
                ).astype(np.int64)
                lo = sum(self.layernum_list[:t])
                mem[stage][lo:lo + self.layernum_list[t]] = row
        inter = self._inter_layer_cost(layer_list, gbsz, chunks, pp)

        best = TaskResult(bsz=gbsz, chunks=chunks, pp_size=pp,
                          pp_stage_list=partition)
        for vs in vocab_list:
            vtime, vtime_nosync = embed_time_cost(
                vs, self.contexts[0], gbsz, chunks, self.seqlen_list)
            vmem = np.ceil(embed_memory_cost(
                vs, self.contexts[0], gbsz, chunks,
                pipeline_type=self.pipeline_type)).astype(int)

            plan: List[SearchStrategy] = []
            remain, used = [], []
            feasible = True
            start = 0
            for stage in range(pp):
                cnt = partition[stage]
                cost, idxs, rem = dp_solve(
                    mem[stage][start:start + cnt],
                    intra[start:start + cnt],
                    inter[start:start + cnt],
                    max_mem,
                    int(vmem[stage] + int(global_mb)),
                    float(vtime[stage]),
                    use_cpp_core=self.args.use_cpp_core)
                if idxs is None:
                    feasible = False
                    break
                plan.extend(layer_list[i] for i in idxs)
                remain.append(rem)
                used.append(max_mem - rem + mem_cache)
                start += cnt
            if not feasible:
                continue
            cost = pipeline_time_cost(
                self.layernum_list, self.contexts, plan, partition, chunks,
                gbsz, pp, vtime_nosync)
            if cost < best.time_cost:
                best = TaskResult(
                    throughput=gbsz / cost, time_cost=cost,
                    strategy_list=plan, pp_size=pp, pp_stage_list=partition,
                    memory_remain=remain, memory_cost=used,
                    vocab_tp_sp=vs.tp_sp, vocab_sp=int(vs.sp > 1),
                    vocab_sdp=int(vs.dp_type == DPType.ZERO3),
                    bsz=gbsz, chunks=chunks)
        return best

    def _solve_coarse(self, gbsz, chunks, pp, partition, layer_list,
                      max_mem, mem_cache, global_mb) -> TaskResult:
        """Uniform-strategy mode: every layer shares one strategy
        (dynamic_programming.py:243-360)."""
        best = TaskResult(bsz=gbsz, chunks=chunks, pp_size=pp,
                          pp_stage_list=partition)
        for ls in layer_list:
            vs = ls.vocab_variant()
            _, vtime_nosync = embed_time_cost(
                vs, self.contexts[0], gbsz, chunks, self.seqlen_list)
            vmem = embed_memory_cost(vs, self.contexts[0], gbsz, chunks,
                                     pipeline_type=self.pipeline_type)
            oom = False
            used, remain = [], []
            start = 0
            for stage in range(pp):
                u = math.ceil(global_mb) + math.ceil(vmem[stage])
                for li in range(start, start + partition[stage]):
                    u += math.ceil(self._stage_layer_mem(
                        ls, gbsz, chunks, stage, li))
                start += partition[stage]
                used.append(u)
                if u > max_mem:
                    oom = True
                    break
            if oom:
                continue
            remain = [max_mem - u for u in used]
            used = [u + mem_cache for u in used]
            plan = [ls] * self.total_layernum
            cost = pipeline_time_cost(
                self.layernum_list, self.contexts, plan, partition, chunks,
                gbsz, pp, vtime_nosync)
            if cost < best.time_cost:
                best = TaskResult(
                    throughput=gbsz / cost, time_cost=cost, strategy_list=plan,
                    pp_size=pp, pp_stage_list=partition, memory_remain=remain,
                    memory_cost=used, vocab_tp_sp=vs.tp_sp,
                    vocab_sp=int(vs.sp > 1),
                    vocab_sdp=int(vs.dp_type == DPType.ZERO3),
                    bsz=gbsz, chunks=chunks)
        return best

    def _stage_layer_mem(self, s, gbsz, chunks, stage, layer_idx) -> float:
        """Layer layer_idx's memory at a given stage (layertype-resolved)."""
        t = 0
        acc = 0
        for ti, cnt in enumerate(self.layernum_list):
            if layer_idx < acc + cnt:
                t = ti
                break
            acc += cnt
        return layer_memory_cost(s, self.contexts[t], gbsz, chunks,
                                 stage_idx=stage,
                                 pipeline_type=self.pipeline_type)

    # ---------------- output ----------------

    def save_results(self, best: TaskResult,
                     runner_ups: Optional[List[Dict[str, Any]]] = None
                     ) -> str:
        """Write the interchange JSON (reference save_results,
        search_engine.py:749-785). ``runner_ups`` (see
        :meth:`_runner_ups`) and the winner's own priced total ride along
        as extra keys — ``config2strategy`` ignores them, so old readers
        are unaffected — giving the runtime's plan-regret sentinel its
        re-pricing baseline."""
        default_dp = DPType.from_name(self.default_dp_type)
        runtime = []
        for s in best.strategy_list:
            r = s.to_runtime()
            if r.dp_size == 1:
                # dp=1 carries no dp flavour; encode as the default type
                from dataclasses import replace as _replace
                r = _replace(r, dp_type=default_dp)
            runtime.append(r)
        # embed the winner's per-layer compute prediction (fct+bct, ms) so
        # the runtime's plan audit diffs the EXACT model that picked the
        # plan — without this the audit's compute row is measured-only
        pred_ms: List[float] = []
        li = 0
        for lt, n in enumerate(self.layernum_list):
            ctx = self.contexts[lt]
            for _ in range(n):
                comp = layer_time_components(
                    best.strategy_list[li], ctx, best.bsz, best.chunks)
                pred_ms.append(round(comp["fct_ms"] + comp["bct_ms"], 6))
                li += 1
        # record the hierarchical dp choice when the hierarchical term
        # priced EVERY layer's dp reduction (cost.hier_dp_wins) — the
        # runtime then enables the matching ops/hier_reduce.py path
        hier_chosen = False
        hier_bucket = 0.0
        dp_sched_name = None
        dp_sched_ranks = None
        if self.args.hier_dp:
            from hetu_galvatron_tpu_torch.core.cost_model.cost import (
                dp_schedule_choice,
                hier_dp_best_bucket,
                hier_dp_wins,
                hier_grad_payload_mb,
            )

            li = 0
            flags = []
            for lt, n in enumerate(self.layernum_list):
                for _ in range(n):
                    flags.append(hier_dp_wins(
                        best.strategy_list[li], self.contexts[lt],
                        best.bsz, best.chunks))
                    li += 1
            hier_chosen = bool(flags) and all(flags)
            if hier_chosen:
                # record the bucket granularity the price assumed: the
                # configured size, or — auto mode (hier_bucket_mb < 0) —
                # the sweep's argmin over the first layertype's whole
                # grad payload, so the runtime pipelines at exactly the
                # granularity the search paid for
                ctx0 = self.contexts[0]
                s0 = best.strategy_list[0]
                if ctx0.hier_bucket_mb < 0:
                    _, hier_bucket = hier_dp_best_bucket(
                        s0, ctx0, hier_grad_payload_mb(s0, ctx0))
                else:
                    hier_bucket = max(ctx0.hier_bucket_mb, 0.0)
                # collective-compiler record: price the synthesized
                # schedule space for the winning plan's dp group and name
                # the cheapest family (cost.dp_schedule_choice). The
                # emitted programs are monolithic, so a bucketed plan
                # keeps the hand-implemented pipelined path instead.
                if hier_bucket == 0.0:
                    choice = dp_schedule_choice(
                        s0, ctx0, hier_grad_payload_mb(s0, ctx0))
                    if choice is not None:
                        dp_sched_name, ranks = choice
                        dp_sched_ranks = {
                            k: round(v, 6) for k, v in sorted(
                                ranks.items(), key=lambda kv: kv[1])}
        cfg = strategy_list2config(
            runtime, global_bsz=best.bsz, chunks=best.chunks,
            pipeline_type=self.pipeline_type,
            default_dp_type=self.default_dp_type,
            vocab=EmbeddingLMHeadStrategy(
                vtp=best.vocab_tp_sp, vsp=bool(best.vocab_sp),
                embed_sdp=bool(best.vocab_sdp)),
            pp_division=best.pp_stage_list,
            num_encoder_layers=getattr(self, "num_encoder_layers", None),
            predicted_layer_compute_ms=pred_ms,
            hier_dp=hier_chosen, hier_bucket_mb=hier_bucket,
            dp_schedule=dp_sched_name)
        if dp_sched_ranks:
            # the full priced space rides along (cheapest first) so plan
            # readers can see HOW the family won, not just that it did
            cfg["dp_schedule_rankings"] = dp_sched_ranks
        if best.time_cost != float("inf"):
            cfg["predicted_time_cost_ms"] = round(best.time_cost * 1e3, 6)
        if runner_ups:
            cfg["runner_ups"] = runner_ups
        a = self.args
        off = [name for flag, name in (
            (a.disable_dp, "dp"), (a.disable_tp, "tp"), (a.disable_pp, "pp"),
            (a.disable_sdp, "fsdp"), (a.disable_ckpt, "ckpt")) if flag]
        name = ("galvatron_config_%s_%dnodes_%dgpus_per_node_%dGB"
                % (self.model_name, a.num_nodes, a.num_devices_per_node,
                   self.memory_constraint // 1024))
        name += "_%s" % self.mixed_precision
        if a.settle_bsz > 0:
            name += "_bsz%d" % a.settle_bsz
        if off:
            name += "_[%s_off]" % "_".join(off)
        path = os.path.join(a.output_config_path or "configs",
                            name + ".json")
        # validating writer (utils/strategy.py): the plan must round-trip
        # through config2strategy + per-layer LayerStrategy.validate at the
        # searcher's world size BEFORE it lands on disk — a serialization
        # bug surfaces here, not at load time on the machines that train
        from hetu_galvatron_tpu_torch.utils.strategy import (
            save_strategy_config,
        )

        save_strategy_config(path, cfg, world_size=self.world_size)
        return path
