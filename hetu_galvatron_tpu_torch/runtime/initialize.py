"""Run initialization: argument checks, seeding, devices, process group,
logger.

Counterpart of ``hetu_galvatron_tpu/runtime/initialize.py`` (``RunState``,
``initialize_distributed`` :108 and ``initialize`` :169-182).
``args.device`` picks the kind: "cuda" (the default) needs a GPU and
raises without one; "cpu" runs the plain versions of the kernels and is
what the tests ask for.

One process runs one rank. Under ``python -m torch.distributed.run``
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``; ``core/args_schema.launch_env``)
the process joins the process group and the world is ``WORLD_SIZE``, as
JAX's ``initialize_distributed`` gives ``jax.devices()``; rank r runs on
``visible[local_rank % len(visible)]``. The backend follows the layout,
never a failure (:func:`pick_backend`): ``nccl`` where every rank of the
host has a card of its own, ``gloo`` where ranks share a card or on the
CPU, and the run logs the choice with the rank and device counts. A rank
whose ``nccl`` init fails raises; nothing retries on gloo. A process
group made before :func:`initialize` (``parallel/launch.spawn_world``) is
taken as it is. Under such a launch a plan runs at ``pp_deg`` 1
(``parallel/spmd.py``); its stages wider than one rank wait for ROADMAP
item 12c.

In a single process the world is ``parallel.num_devices`` when above 0;
else, for a plan with ``pp_deg > 1``, the number of visible devices (the
CPU counts as one), and 1 for a pp=1 plan. ``RunState.devices`` lists a
device per rank: rank r runs on ``visible[r % len(visible)]``, so a world
larger than the visible devices puts several ranks on one device, and the
run logs one line saying so. JAX clamps the world to the devices it sees
instead; PyTorch has no virtual devices, and a pipeline stage of one rank
computes the same arithmetic wherever it runs. A single process runs a
world equal to the plan's ``pp_deg`` (``hybrid_config.check_world``): pp=1
on one device, or one rank a pipeline stage; a pp=1 plan over several
ranks needs one process a rank and raises, naming the launcher.
"""

from __future__ import annotations

import logging
import random
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs, launch_env
from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
    check_single_device,
    plan_pp_deg,
    plan_width,
)


@dataclass
class RunState:
    args: CoreArgs
    device: torch.device  # rank 0's
    world_size: int = 1
    logger: Optional[logging.Logger] = None
    devices: List[torch.device] = field(default_factory=list)  # per rank
    # one process a rank (a torchrun or spawned launch): this process's
    # rank and the process group's backend; None in a single process
    rank: int = 0
    backend: Optional[str] = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    def log(self, msg: str) -> None:
        if self.rank:
            return  # rank 0 speaks for the run
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


def pick_backend(device_type: str, local_world: int, cards: int) -> str:
    """``nccl`` where every rank of the host has a card of its own; ``gloo``
    where ranks share a card (NCCL puts no two ranks of one communicator
    on one card), or on the CPU."""
    if device_type == "cuda" and cards >= local_world:
        return "nccl"
    return "gloo"


def join_process_group(args: CoreArgs, env) -> RunState:
    """One rank of a launch of ``env["world_size"]`` processes: join (or
    take) the process group and place the rank on its device."""
    import torch.distributed as dist

    visible = visible_devices(args)
    rank, world = env["rank"], env["world_size"]
    local = env["local_rank"]
    device = visible[local % len(visible)]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        backend = dist.get_backend()
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise ValueError(
                f"the process group has rank {dist.get_rank()} of "
                f"{dist.get_world_size()}, the launch says {rank} of {world}")
    else:
        backend = pick_backend(device.type, env["local_world_size"],
                               len(visible) if device.type == "cuda" else 0)
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=world)
    logger = make_logger(args)
    if rank:
        logger.setLevel(logging.WARNING)
    devices = [visible[r % len(visible)] for r in range(world)]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    logger.info("initialized: rank %d of %d on %s (%s), backend %s (%d "
                "rank(s) a host on %d device(s)), model %s", rank, world,
                device, name, backend, env["local_world_size"],
                len(visible), args.model.model_name)
    return RunState(args=args, device=device, world_size=world,
                    logger=logger, devices=devices, rank=rank,
                    backend=backend)


def initialize(args: CoreArgs) -> RunState:
    """Validate, seed and lay the ranks out: one rank of a multi-process
    launch, or every rank in this process."""
    env = launch_env()
    procs = args.parallel.num_processes
    if env is not None and env["world_size"] > 1:
        if procs > 1 and procs != env["world_size"]:
            raise ValueError(f"parallel.num_processes={procs} but the launch "
                             f"has {env['world_size']} processes")
        world = env["world_size"]
        if args.parallel.num_devices not in (0, world):
            raise ValueError(
                f"parallel.num_devices={args.parallel.num_devices} but the "
                f"launch has {world} processes (one rank each)")
        check_single_device(args, world, distributed=True)
        validate_args(args, world)
        set_seed(args.train.seed)
        return join_process_group(args, env)
    if procs > 1:
        raise NotImplementedError(
            f"parallel.num_processes={procs}: launch one process a rank with "
            f"python -m torch.distributed.run --nproc_per_node {procs}")
    visible = visible_devices(args)
    world = args.parallel.num_devices
    if world <= 0:
        world = len(visible) if plan_pp_deg(args) > 1 else 1
    what, width = plan_width(args)
    if plan_pp_deg(args) == 1 and max(world, width) > 1:
        what = what or f"parallel.num_devices={world}"
        raise NotImplementedError(
            f"{what}: a pp=1 plan over {max(world, width)} ranks runs one "
            "process a rank; launch it with python -m "
            f"torch.distributed.run --nproc_per_node {max(world, width)} "
            "-m hetu_galvatron_tpu_torch.cli.train_dist ...")
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
