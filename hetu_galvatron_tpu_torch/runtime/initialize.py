"""Run initialization: argument checks, seeding, device choice, logger.

Counterpart of ``hetu_galvatron_tpu/runtime/initialize.py`` for one process
on one device. The device is ``args.device``: "cuda" (the default) needs a
GPU and raises without one; "cpu" runs the plain versions of the kernels
and is what the tests ask for.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs
from hetu_galvatron_tpu_torch.runtime.hybrid_config import check_single_device


@dataclass
class RunState:
    args: CoreArgs
    device: torch.device
    world_size: int = 1
    logger: Optional[logging.Logger] = None

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
    """Validate, seed and pick the device (single process)."""
    if args.parallel.num_processes > 1:
        raise NotImplementedError(
            "multi-process runs (parallel.num_processes > 1) are not ported "
            "yet")
    device = resolve_device(args)
    world = 1
    if args.parallel.num_devices > 1:
        raise NotImplementedError(
            f"parallel.num_devices={args.parallel.num_devices}: runs on more "
            "than one device are not ported yet")
    # the plan's refusals name the setting; run them before the generic
    # divisibility checks
    check_single_device(args, world)
    validate_args(args, world)
    set_seed(args.train.seed)
    logger = make_logger(args)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    logger.info("initialized: 1 device (%s), model %s", name,
                args.model.model_name)
    return RunState(args=args, device=device, world_size=world,
                    logger=logger)
