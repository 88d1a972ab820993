"""Run initialization: argument checks, seeding, devices, logger.

Counterpart of ``hetu_galvatron_tpu/runtime/initialize.py`` (``RunState``
and ``initialize`` :169-182) for one process. ``args.device`` picks the
kind: "cuda" (the default) needs a GPU and raises without one; "cpu" runs
the plain versions of the kernels and is what the tests ask for.

The world is ``parallel.num_devices`` when above 0; else, for a plan
with ``pp_deg > 1``, the number of visible devices (the CPU counts as
one), and 1 for a pp=1 plan, which runs on one device however many are
visible. ``RunState.devices`` lists a device per rank: rank r runs on
``visible[r % len(visible)]``, so a world larger than the visible
devices puts several ranks on one device, and the run logs one line
saying so. JAX clamps the world to the devices it sees instead; PyTorch
has no virtual devices, and a pipeline stage of one rank computes the
same arithmetic wherever it runs. Only a world equal to the plan's
``pp_deg`` runs (``hybrid_config.check_world``): pp=1 on one
device, or one rank a pipeline stage.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs
from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
    check_single_device,
    plan_pp_deg,
)


@dataclass
class RunState:
    args: CoreArgs
    device: torch.device  # rank 0's
    world_size: int = 1
    logger: Optional[logging.Logger] = None
    devices: List[torch.device] = field(default_factory=list)  # per rank

    def log(self, msg: str) -> None:
        (self.logger.info if self.logger else print)(msg)


def validate_args(args: CoreArgs, world_size: int) -> None:
    m, p = args.model, args.parallel
    if m.hidden_size % m.num_attention_heads:
        raise ValueError("hidden_size must divide by num_attention_heads")
    if m.num_key_value_heads and m.num_attention_heads % m.num_key_value_heads:
        raise ValueError("heads must divide by kv heads")
    if p.config_mode == "global":
        need = p.pp_deg * max(p.global_tp_deg, 1) * max(p.global_cp_deg, 1)
        if world_size % max(need, 1):
            raise ValueError(
                f"world {world_size} not divisible by pp*tp*cp = {need}")
    if m.seq_length > m.max_position_embeddings:
        raise ValueError("seq_length exceeds max_position_embeddings")


def set_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def resolve_device(args: CoreArgs) -> torch.device:
    """The run's device; never falls back from CUDA to the CPU."""
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible: hetu_galvatron_tpu_torch runs on the "
            "GPU by default; pass device=cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def visible_devices(args: CoreArgs) -> List[torch.device]:
    """The devices a run may use, the current CUDA device first; the CPU
    alone with ``device=cpu``."""
    first = resolve_device(args)
    if first.type == "cpu":
        return [first]
    n = torch.cuda.device_count()
    return [torch.device("cuda", (first.index + i) % n) for i in range(n)]


def make_logger(args: CoreArgs) -> logging.Logger:
    logger = logging.getLogger("hetu_galvatron_tpu_torch")
    logger.propagate = False
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter("[%(levelname)s] %(message)s"))
        logger.addHandler(h)
    logger.setLevel(getattr(logging, args.logging.log_level.upper(),
                            logging.INFO))
    return logger


def initialize(args: CoreArgs) -> RunState:
    """Validate, seed and lay the ranks out on the visible devices (single
    process)."""
    if args.parallel.num_processes > 1:
        raise NotImplementedError(
            "multi-process runs (parallel.num_processes > 1) are not ported "
            "yet")
    visible = visible_devices(args)
    world = args.parallel.num_devices
    if world <= 0:
        world = len(visible) if plan_pp_deg(args) > 1 else 1
    # the plan's refusals name the setting; run them before the generic
    # divisibility checks
    check_single_device(args, world)
    validate_args(args, world)
    set_seed(args.train.seed)
    logger = make_logger(args)
    devices = [visible[r % len(visible)] for r in range(world)]
    first = devices[0]
    name = (torch.cuda.get_device_name(first) if first.type == "cuda"
            else "cpu")
    logger.info("initialized: %d rank(s) on %d device(s) (%s), model %s",
                world, len(set(devices)), name, args.model.model_name)
    if world > len(visible):
        logger.info("%d ranks share %d device(s) (%s): the pipeline stages "
                    "on one device run one after another", world,
                    len(visible), ", ".join(str(d) for d in visible))
    return RunState(args=args, device=first, world_size=world,
                    logger=logger, devices=devices)
