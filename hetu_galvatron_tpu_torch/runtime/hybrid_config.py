"""Hybrid-parallel plan: GLOBAL mode and searched JSON plans.

Counterpart of ``hetu_galvatron_tpu/runtime/hybrid_config.py``
(``get_hybrid_parallel_config`` :119-230) for the plans the port runs:
pp=1 plans over any power-of-two world of ranks, one process a rank
(``parallel/spmd.py``: DP, ZeRO-2, ZeRO-3, Megatron TP with sequence
parallelism, vocab TP, mixed per layer as the search emits them), and
pipelines of ``pp_deg`` stages (``pp_deg x vpp_deg`` chunks under
interleaving) at a world of ``pp_deg``, one rank a stage
(``runtime/pipeline.py``). GLOBAL mode lowers ``parallel.global_tp_deg``,
``global_tp_consec``, ``sdp``, ``default_dp_type``,
``global_checkpoint`` and the vocab knobs (``vocab_tp``, ``embed_sdp``)
onto every layer as JAX does (:176-196): dp is what the stage's world
leaves. JSON mode (``parallel.config_mode=json`` or
``parallel.galvatron_config_path``) reads a searched
``galvatron_config_*.json`` through ``utils/strategy.config2strategy``:
``global_bsz``, ``chunks``, ``pp_deg``, ``pp_division``, ``vpp_deg`` and
``pipeline_type`` come from the plan (JAX :131-160),
``checkpoint_flags`` is its per-layer ``checkpoint`` vector, and its
``predicted_time_cost_ms`` rides along for the launcher's log. For t5 the
flags span the combined stack, encoder layers first
(``num_encoder_layers``, ``enc_flags`` / ``dec_flags``), as the JAX
plan's ``layers`` do; the pipeline slices that stack the same way.

What the port does not run yet raises ``NotImplementedError`` naming the
setting and the ROADMAP item that lifts it: context parallelism, Ulysses
and the vocab layer's sp / cp (item 11); expert parallelism, and MoE, T5
and BERT models over several ranks (item 10b); a pipeline stage wider
than one rank, or a world other than ``pp_deg`` under pp (item 12c); the
hierarchical dp reduction (item 12d).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from hetu_galvatron_tpu_torch.analysis import eligibility
from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs
from hetu_galvatron_tpu_torch.utils.strategy import (
    DPType,
    EmbeddingLMHeadStrategy,
    LayerStrategy,
    PlanFormatError,
    config2strategy,
    default_pp_division,
    load_strategy_config,
    print_strategies,
)

ITEM10B = "(ROADMAP item 10b)"
ITEM11 = "(ROADMAP item 11)"
ITEM12C = "(ROADMAP item 12c)"
ITEM12D = "(ROADMAP item 12d)"
WIDE_STAGE = "a pipeline stage wider than one rank is not ported yet"


@dataclass
class HybridParallelConfig:
    pp_deg: int
    chunks: int
    global_bsz: int
    world_size: int
    # the per-layer strategies (one rank each); t5: encoder + decoder
    # layers, and the split point
    layers: List[LayerStrategy]
    num_encoder_layers: int = 0
    pipeline_type: str = "gpipe"
    # layers per chunk, pp_deg * vpp_deg entries (chunk c on stage c % pp)
    pp_division: List[int] = field(default_factory=list)
    vpp_deg: int = 1
    default_dp_type: str = "ddp"
    vocab: EmbeddingLMHeadStrategy = field(
        default_factory=EmbeddingLMHeadStrategy)
    # a searched plan: its file and the search's predicted step time
    plan_path: Optional[str] = None
    predicted_time_cost_ms: Optional[float] = None

    @property
    def checkpoint_flags(self) -> List[bool]:
        """Per layer: remat it."""
        return [s.checkpoint for s in self.layers]

    @property
    def enc_flags(self) -> List[bool]:
        return self.checkpoint_flags[:self.num_encoder_layers]

    @property
    def dec_flags(self) -> List[bool]:
        return self.checkpoint_flags[self.num_encoder_layers:]

    def describe(self) -> str:
        text = (f"pp{self.pp_deg} chunks{self.chunks} bsz{self.global_bsz} "
                f"world{self.world_size} remat {sum(self.checkpoint_flags)}/"
                f"{len(self.checkpoint_flags)} layers ")
        if self.pp_deg > 1:
            text += (f"({self.pipeline_type}, division {self.pp_division}"
                     + (f", vpp{self.vpp_deg}" if self.vpp_deg > 1 else "")
                     + ", one rank a stage)")
        elif self.world_size > 1:
            text += f"({self.world_size} ranks, one process a rank)"
        else:
            text += "(single device)"
        if self.plan_path:
            text += (f" [{print_strategies(self.layers)}] searched plan "
                     f"{self.plan_path}")
        return text


def resolve_chunks(chunks: int, pp_deg: int, global_bsz: int,
                   world_size: int) -> int:
    """Only -1 auto-computes (microbatches of ~4 samples per max-dp rank
    under pp); 0 clamps to 1."""
    if chunks != -1:
        return max(chunks, 1)
    if pp_deg <= 1:
        return 1
    max_dp = world_size // pp_deg
    local_bsz = global_bsz / max(max_dp, 1)
    return max(int(math.ceil(local_bsz / 4)), 1)


def get_chunks(args: CoreArgs, world_size: int) -> int:
    return resolve_chunks(args.parallel.chunks, args.parallel.pp_deg,
                          args.parallel.global_train_batch_size, world_size)


def uses_json_plan(args: CoreArgs) -> bool:
    par = args.parallel
    return par.config_mode == "json" or par.galvatron_config_path not in (
        None, "", "None")


def plan_pp_deg(args: CoreArgs) -> int:
    """The plan's ``pp_deg``: GLOBAL mode's ``parallel.pp_deg`` or the
    JSON plan's (1 for a JSON plan without a path, which
    :func:`get_hybrid_parallel_config` refuses)."""
    par = args.parallel
    if not uses_json_plan(args):
        return par.pp_deg
    if par.galvatron_config_path in (None, "", "None"):
        return 1
    return int(load_strategy_config(par.galvatron_config_path).get(
        "pp_deg", 1))


def check_world(world_size: int, pp_deg: int, where: str = "",
                pp_name: str = "pp_deg") -> None:
    """Under pp, raise unless the world equals ``pp_deg`` (named
    ``pp_name``): every pipeline stage here runs on one rank."""
    if pp_deg > 1 and world_size != pp_deg:
        raise NotImplementedError(
            f"{where}world size {world_size} with {pp_name}={pp_deg}: the "
            "port runs each pipeline stage on one rank, so the world "
            "(parallel.num_devices, else the visible devices under pp) "
            f"must equal pp_deg; {WIDE_STAGE} {ITEM12C}")


def check_model_world(args: CoreArgs, world_size: int) -> None:
    """Model families the SPMD step does not run over several ranks."""
    m = args.model
    if world_size <= 1 or plan_pp_deg(args) > 1:
        return
    if m.model_type in ("t5", "bert"):
        raise NotImplementedError(
            f"model_type={m.model_type} over {world_size} ranks: the SPMD "
            f"step runs decoder-only models {ITEM10B}")
    if m.num_experts:
        raise NotImplementedError(
            f"model.num_experts={m.num_experts} over {world_size} ranks: MoE "
            f"layers under a plan wider than one rank {ITEM10B}")


def plan_width(args: CoreArgs):
    """(the setting, the ranks it needs) of a pp=1 plan: the GLOBAL tp or
    vocab tp degree, or a searched plan's widest layer; (None, 1) when
    one rank runs it."""
    par = args.parallel
    if uses_json_plan(args):
        path = par.galvatron_config_path
        if path in (None, "", "None"):
            return None, 1
        layers, vocab, _ = config2strategy(load_strategy_config(path))
        width = max([s.tp_size * s.cp_size for s in layers] + [vocab.vtp])
        return f"plan {path}", width
    for name, deg in (("global_tp_deg", par.global_tp_deg),
                      ("vocab_tp", par.vocab_tp)):
        if deg > 1:
            return f"parallel.{name}={deg}", deg
    return None, 1


def check_single_device(args: CoreArgs, world_size: int,
                        distributed: bool = False) -> None:
    """Raise, naming the setting and its ROADMAP item, for a GLOBAL-mode
    plan the port does not run at this world (JSON plans:
    :func:`check_plan_width`); ``distributed`` is a launch of one process
    a rank."""
    par = args.parallel
    check_model_world(args, world_size)
    if uses_json_plan(args):
        if distributed and plan_pp_deg(args) > 1:
            raise NotImplementedError(
                f"a pp plan under a launch of {world_size} processes: "
                f"{WIDE_STAGE} {ITEM12C}")
        return  # JSON mode ignores the GLOBAL degrees, as JAX's does
    refused = {"global_cp_deg": (par.global_cp_deg > 1, ITEM11),
               "use_ulysses": (par.use_ulysses, ITEM11),
               "vocab_sp": (par.vocab_sp, ITEM11),
               "vocab_cp": (par.vocab_cp > 1, ITEM11),
               "global_ep_deg": (par.global_ep_deg > 1, ITEM10B),
               "global_etp_deg": (par.global_etp_deg > 1, ITEM10B)}
    for name, (bad, item) in refused.items():
        if bad:
            raise NotImplementedError(
                f"parallel.{name}={getattr(par, name)} is not ported yet "
                f"{item}")
    if par.pp_deg > 1:
        for name in ("global_tp_deg", "vocab_tp"):
            deg = getattr(par, name)
            if deg > 1:
                raise NotImplementedError(
                    f"parallel.{name}={deg} under parallel.pp_deg="
                    f"{par.pp_deg}: {WIDE_STAGE} {ITEM12C}")
        if distributed:
            raise NotImplementedError(
                f"parallel.pp_deg={par.pp_deg} under a launch of "
                f"{world_size} processes: the pipeline engine runs every "
                f"stage in one process; {WIDE_STAGE} {ITEM12C}")
    check_world(world_size, par.pp_deg, pp_name="parallel.pp_deg")


def check_plan_width(path: str, layers: List[LayerStrategy], vocab,
                     extras, world_size: Optional[int] = None) -> None:
    """Raise for the first field of a searched plan the port does not run,
    naming it (and the layer) and its ROADMAP item; with ``world_size``,
    also for a pp plan at a world other than its ``pp_deg``."""
    def refuse(what: str, item: str):
        raise NotImplementedError(f"plan {path}: {what} is not ported yet "
                                  f"{item}")

    pp = layers[0].pp_deg
    for i, s in enumerate(layers):
        for key, value, item in (
                ("cp_sizes_enc", s.cp_size, ITEM11),
                ("use_sp", int(s.sp), ITEM11),
                ("ep_sizes_enc", s.ep_size, ITEM10B),
                ("tp_of_ep_sizes_enc", s.etp_size, ITEM10B)):
            if value > (0 if key == "use_sp" else 1):
                refuse(f"{key}: layer {i} has {value}", item)
    for key, value in (("vsp", int(vocab.vsp)), ("vcp", vocab.vcp)):
        if value > (0 if key == "vsp" else 1):
            refuse(f"{key}={value}", ITEM11)
    if extras["hier_dp"]:
        raise NotImplementedError(
            f"plan {path}: hier_dp=1 (the hierarchical dp reduction) is not "
            f"ported yet {ITEM12D}")
    if pp > 1:
        for i, s in enumerate(layers):
            if s.tp_size > 1:
                raise NotImplementedError(
                    f"plan {path}: tp_sizes_enc: layer {i} has {s.tp_size} "
                    f"under pp_deg={pp}: {WIDE_STAGE} {ITEM12C}")
        if vocab.vtp > 1:
            raise NotImplementedError(
                f"plan {path}: vtp={vocab.vtp} under pp_deg={pp}: "
                f"{WIDE_STAGE} {ITEM12C}")
    if world_size is not None:
        check_world(world_size, pp, where=f"plan {path}: ")
        wide = [(f"tp_sizes_enc: layer {i} has {s.tp_size}", s.tp_size)
                for i, s in enumerate(layers) if s.tp_size > world_size]
        if vocab.vtp > world_size:
            wide.append((f"vtp={vocab.vtp}", vocab.vtp))
        if pp == 1 and wide:
            raise NotImplementedError(
                f"plan {path}: {wide[0][0]}: the plan needs {wide[0][1]} "
                f"ranks and the world has {world_size}; a process runs one "
                "rank: launch it with python -m torch.distributed.run "
                f"--nproc_per_node {wide[0][1]}")


def _json_plan(args: CoreArgs, world_size: int, n_enc: int,
               n_layers: int) -> HybridParallelConfig:
    par = args.parallel
    path = par.galvatron_config_path
    if path in (None, "", "None"):
        raise PlanFormatError("parallel.config_mode=json needs "
                              "parallel.galvatron_config_path")
    cfg = load_strategy_config(path)
    # the plan's widths and world first, then the plan at this world size
    check_plan_width(path, *config2strategy(cfg), world_size=world_size)
    layers, vocab, extras = config2strategy(cfg, world_size=world_size)
    if len(layers) != n_layers:
        raise ValueError(
            f"plan has {len(layers)} layers, model has {n_layers} "
            f"(encoder {n_enc} + decoder {args.model.num_hidden_layers})")
    if extras["num_encoder_layers"] not in (None, n_enc):
        raise ValueError(
            f"plan was searched for {extras['num_encoder_layers']} encoder "
            f"layers, model has {n_enc}")
    pp_deg = layers[0].pp_deg
    vpp = max(extras["vpp_deg"], 1)
    global_bsz = extras["global_bsz"] or par.global_train_batch_size
    chunks = resolve_chunks(extras["chunks"], pp_deg, global_bsz, world_size)
    pp_division = extras["pp_division"] or default_pp_division(
        n_layers, pp_deg * vpp)
    for reason in eligibility.plan_structure_reasons(
            layers=layers, vocab=vocab, pp_deg=pp_deg, vpp_deg=vpp,
            pp_division=pp_division, n_layers=n_layers,
            world_size=world_size, global_bsz=global_bsz):
        raise ValueError(reason)
    predicted = cfg.get("predicted_time_cost_ms")
    return HybridParallelConfig(
        pp_deg=pp_deg, chunks=chunks, global_bsz=global_bsz,
        world_size=world_size, layers=list(layers),
        num_encoder_layers=n_enc, pipeline_type=extras["pipeline_type"],
        pp_division=list(pp_division), vpp_deg=vpp,
        default_dp_type=extras["default_dp_type"], vocab=vocab,
        plan_path=path,
        predicted_time_cost_ms=None if predicted is None else float(
            predicted))


def get_hybrid_parallel_config(args: CoreArgs,
                               world_size: int) -> HybridParallelConfig:
    check_single_device(args, world_size)
    par = args.parallel
    n_enc = 0
    if args.model.model_type == "t5":
        n_enc = (args.model.num_encoder_layers
                 if args.model.num_encoder_layers is not None
                 else args.model.num_hidden_layers)
    n_layers = n_enc + args.model.num_hidden_layers
    if uses_json_plan(args):
        hpc = _json_plan(args, world_size, n_enc, n_layers)
    else:
        pp_deg, vpp = par.pp_deg, max(par.virtual_pp_deg, 1)
        tp = max(par.global_tp_deg, 1)
        for reason in (eligibility.pp_world_reason(world_size, pp_deg),
                       eligibility.stage_degree_reason(
                           world_size, pp_deg, tp, 1)):
            if reason:
                raise ValueError(reason)
        default_dp = DPType.from_name(par.default_dp_type)
        layers = [LayerStrategy(
            pp_deg=pp_deg, tp_size=tp, dp_size=world_size // pp_deg // tp,
            tp_consecutive=bool(par.global_tp_consec),
            dp_type=DPType.ZERO3 if par.sdp else default_dp,
            checkpoint=bool(par.global_checkpoint))] * n_layers
        vocab = EmbeddingLMHeadStrategy(vtp=par.vocab_tp,
                                        embed_sdp=bool(par.embed_sdp))
        pp_division = default_pp_division(n_layers, pp_deg * vpp)
        for reason in eligibility.plan_structure_reasons(
                layers=layers, vocab=vocab,
                pp_deg=pp_deg, vpp_deg=vpp, pp_division=pp_division,
                n_layers=n_layers, world_size=world_size,
                global_bsz=par.global_train_batch_size):
            raise ValueError(reason)
        hpc = HybridParallelConfig(
            pp_deg=pp_deg, chunks=get_chunks(args, world_size),
            global_bsz=par.global_train_batch_size, world_size=world_size,
            layers=layers, num_encoder_layers=n_enc,
            pipeline_type=par.pipeline_type, pp_division=pp_division,
            vpp_deg=vpp, default_dp_type=par.default_dp_type, vocab=vocab)
    if hpc.global_bsz % hpc.chunks:
        raise ValueError(
            f"global batch {hpc.global_bsz} is not divisible by "
            f"chunks={hpc.chunks}")
    return hpc
