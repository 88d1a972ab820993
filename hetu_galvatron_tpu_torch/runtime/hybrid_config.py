"""Hybrid-parallel plan: GLOBAL mode and searched JSON plans whose stages
each run one rank.

Counterpart of ``hetu_galvatron_tpu/runtime/hybrid_config.py``
(``get_hybrid_parallel_config`` :119-230) for the plans the port runs:
pp=1 on one device, and pipelines of ``pp_deg`` stages (``pp_deg x
vpp_deg`` chunks under interleaving) at a world of ``pp_deg``, one rank a
stage (``runtime/pipeline.py``). GLOBAL mode takes ``parallel.pp_deg``,
``pipeline_type``, ``virtual_pp_deg``, ``chunks`` and
``parallel.global_checkpoint`` on every layer; the division is
``utils/strategy.default_pp_division`` over the chunks. JSON mode
(``parallel.config_mode=json`` or ``parallel.galvatron_config_path``)
reads a searched ``galvatron_config_*.json`` through
``utils/strategy.config2strategy``: ``global_bsz``, ``chunks``,
``pp_deg``, ``pp_division``, ``vpp_deg`` and ``pipeline_type`` come from
the plan (JAX :131-160), ``checkpoint_flags`` is its per-layer
``checkpoint`` vector, and its ``predicted_time_cost_ms`` rides along for
the launcher's log. ``dp_type`` zero2 or zero3 at dp 1 is plain data
parallelism and runs. For t5 the flags span the combined stack, encoder
layers first (``num_encoder_layers``, ``enc_flags`` / ``dec_flags``), as
the JAX plan's ``layers`` do; the pipeline slices that stack the same way.

What a stage of one rank cannot run raises ``NotImplementedError`` naming
the setting and its ROADMAP item: tp, cp, sp, ep or etp above 1 on a
layer (GLOBAL-mode tp / cp / ep degrees, ulysses, sdp), vocab tp / sp /
cp, the hierarchical dp reduction, and any world other than ``pp_deg``
(the SPMD plans on NCCL, item 10; ``hier_dp``, items 12 and 14).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from hetu_galvatron_tpu_torch.analysis import eligibility
from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs
from hetu_galvatron_tpu_torch.utils.strategy import (
    EmbeddingLMHeadStrategy,
    LayerStrategy,
    PlanFormatError,
    config2strategy,
    default_pp_division,
    load_strategy_config,
    print_strategies,
)

ITEM10 = ("needs several devices: the SPMD plans on NCCL are not ported "
          "yet (ROADMAP item 10)")


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
    """Raise unless the world equals ``pp_deg`` (named ``pp_name``): every
    pipeline stage here runs on one rank, and pp=1 on one device."""
    if world_size != pp_deg:
        raise NotImplementedError(
            f"{where}world size {world_size} with {pp_name}={pp_deg}: the "
            "port runs each pipeline stage on one rank, so the world "
            "(parallel.num_devices, else the visible devices under pp) "
            "must equal "
            f"pp_deg; a stage of more than one rank {ITEM10}")


def check_single_device(args: CoreArgs, world_size: int) -> None:
    """Raise, naming the setting, for a GLOBAL-mode plan whose stages would
    be wider than one rank (JSON plans: :func:`check_plan_width`)."""
    par = args.parallel
    if uses_json_plan(args):
        return  # JSON mode ignores the GLOBAL degrees, as JAX's does
    wide = {"global_tp_deg": par.global_tp_deg,
            "global_cp_deg": par.global_cp_deg,
            "global_ep_deg": par.global_ep_deg}
    for name, deg in wide.items():
        if deg > 1:
            raise NotImplementedError(f"parallel.{name}={deg} {ITEM10}")
    if par.use_ulysses or par.sdp:
        raise NotImplementedError(f"ulysses / sdp (ZeRO-3) {ITEM10}")
    check_world(world_size, par.pp_deg, pp_name="parallel.pp_deg")


def check_plan_width(path: str, layers: List[LayerStrategy], vocab,
                     extras, world_size: Optional[int] = None) -> None:
    """Raise for the first field of a searched plan that a stage of one
    rank cannot run, naming it (and the layer); with ``world_size``, also
    for a world other than the plan's ``pp_deg``."""
    def refuse(what: str):
        raise NotImplementedError(f"plan {path}: {what} {ITEM10}")

    for i, s in enumerate(layers):
        for key, value in (("tp_sizes_enc", s.tp_size),
                           ("cp_sizes_enc", s.cp_size),
                           ("use_sp", int(s.sp)),
                           ("ep_sizes_enc", s.ep_size),
                           ("tp_of_ep_sizes_enc", s.etp_size)):
            if value > (0 if key == "use_sp" else 1):
                refuse(f"{key}: layer {i} has {value}")
    for key, value in (("vtp", vocab.vtp), ("vsp", int(vocab.vsp)),
                       ("vcp", vocab.vcp)):
        if value > (0 if key == "vsp" else 1):
            refuse(f"{key}={value}")
    if extras["hier_dp"]:
        raise NotImplementedError(
            f"plan {path}: hier_dp=1 (the hierarchical dp reduction) is not "
            "ported yet (ROADMAP items 12 and 14)")
    if world_size is not None:
        check_world(world_size, layers[0].pp_deg, where=f"plan {path}: ")


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
        layers = [LayerStrategy(pp_deg=pp_deg,
                                checkpoint=bool(par.global_checkpoint))
                  ] * n_layers
        pp_division = default_pp_division(n_layers, pp_deg * vpp)
        for reason in eligibility.plan_structure_reasons(
                layers=layers, vocab=EmbeddingLMHeadStrategy(),
                pp_deg=pp_deg, vpp_deg=vpp, pp_division=pp_division,
                n_layers=n_layers, world_size=world_size,
                global_bsz=par.global_train_batch_size):
            raise ValueError(reason)
        hpc = HybridParallelConfig(
            pp_deg=pp_deg, chunks=get_chunks(args, world_size),
            global_bsz=par.global_train_batch_size, world_size=world_size,
            layers=layers, num_encoder_layers=n_enc,
            pipeline_type=par.pipeline_type, pp_division=pp_division,
            vpp_deg=vpp)
    if hpc.global_bsz % hpc.chunks:
        raise ValueError(
            f"global batch {hpc.global_bsz} is not divisible by "
            f"chunks={hpc.chunks}")
    return hpc
