"""Hybrid-parallel plan: the single-device GLOBAL-mode case.

Counterpart of ``hetu_galvatron_tpu/runtime/hybrid_config.py``, for the one
plan this slice of the port runs: one device, no pipeline, no tensor or
context parallelism, with per-layer activation checkpointing
(``parallel.global_checkpoint`` sets it on every layer, as the JAX plan's
``LayerStrategy.checkpoint``). For t5 the flags span the combined stack,
encoder layers first (``num_encoder_layers``, ``enc_flags`` /
``dec_flags``), as the JAX plan's ``layers`` do. Anything wider (world > 1, pp > 1,
tp/cp/ulysses/ep, ZeRO-3, a searched JSON plan) raises and names the later
slice (the SPMD plans on NCCL and the pipeline engines of ROADMAP.md
queue 1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs

LATER = "is not ported yet (a later slice: SPMD plans on NCCL / pipeline)"


@dataclass
class HybridParallelConfig:
    pp_deg: int
    chunks: int
    global_bsz: int
    world_size: int
    checkpoint_flags: List[bool]  # per layer: remat it
    # t5: the flags span encoder + decoder layers; the split point
    num_encoder_layers: int = 0

    @property
    def enc_flags(self) -> List[bool]:
        return self.checkpoint_flags[:self.num_encoder_layers]

    @property
    def dec_flags(self) -> List[bool]:
        return self.checkpoint_flags[self.num_encoder_layers:]

    def describe(self) -> str:
        return (f"pp{self.pp_deg} chunks{self.chunks} bsz{self.global_bsz} "
                f"world{self.world_size} remat {sum(self.checkpoint_flags)}/"
                f"{len(self.checkpoint_flags)} layers (single device)")


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


def check_single_device(args: CoreArgs, world_size: int) -> None:
    """Raise, naming the setting, for any plan wider than one device."""
    par = args.parallel
    if par.config_mode == "json" or par.galvatron_config_path not in (
            None, "", "None"):
        raise NotImplementedError(f"a searched JSON plan {LATER}")
    if world_size > 1:
        raise NotImplementedError(f"world size {world_size} > 1 {LATER}")
    wide = {"pp_deg": par.pp_deg, "global_tp_deg": par.global_tp_deg,
            "global_cp_deg": par.global_cp_deg,
            "global_ep_deg": par.global_ep_deg,
            "virtual_pp_deg": par.virtual_pp_deg}
    for name, deg in wide.items():
        if deg > 1:
            raise NotImplementedError(f"parallel.{name}={deg} {LATER}")
    if par.use_ulysses or par.sdp:
        raise NotImplementedError(f"ulysses / sdp (ZeRO-3) {LATER}")


def get_hybrid_parallel_config(args: CoreArgs,
                               world_size: int) -> HybridParallelConfig:
    check_single_device(args, world_size)
    par = args.parallel
    n_enc = 0
    if args.model.model_type == "t5":
        n_enc = (args.model.num_encoder_layers
                 if args.model.num_encoder_layers is not None
                 else args.model.num_hidden_layers)
    chunks = get_chunks(args, world_size)
    if par.global_train_batch_size % chunks:
        raise ValueError(
            f"global batch {par.global_train_batch_size} is not divisible by "
            f"chunks={chunks}")
    return HybridParallelConfig(pp_deg=1, chunks=chunks,
                                global_bsz=par.global_train_batch_size,
                                world_size=world_size,
                                checkpoint_flags=[bool(par.global_checkpoint)]
                                * (n_enc + args.model.num_hidden_layers),
                                num_encoder_layers=n_enc)
