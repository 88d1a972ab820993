"""Spawn a world of ranks on one host, one process a rank.

``spawn_world(fn, world, *args)`` starts ``world`` processes, joins them in
one process group over a ``file://`` rendezvous in a fresh temporary
directory (so concurrent worlds, such as pytest-xdist workers, never clash
on a port), runs ``fn(rank, world, *args)`` in each and returns the ranks'
results in rank order. The backend is ``runtime/initialize.pick_backend``'s
for the device kind: gloo on the CPU and for ranks that share a card. Each
child also gets the ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` /
``LOCAL_WORLD_SIZE`` a ``torch.distributed.run`` launch would export, so
``cli/train_dist.train`` runs in it unchanged. The tests and
``chip_smoke.py`` share it.

The call has a deadline: a world that has not answered by ``timeout``
seconds is killed and the call raises, and every child is joined or
killed on the way out, whatever happened.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional


def _child(fn, rank, world, backend, init, threads, out, args):
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world)})
    try:
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
        out.put((rank, "ok", fn(rank, world, *args)))
    except BaseException:  # noqa: BLE001 — reported to the parent
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn: Callable[..., Any], world: int, *args,
                device: str = "cpu", timeout: float = 300.0,
                threads: Optional[int] = 1) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]`` from
    ``world`` spawned processes; ``fn`` and its results must pickle.
    ``threads`` sets each child's torch threads (None keeps torch's
    default)."""
    import torch.multiprocessing as mp

    from hetu_galvatron_tpu_torch.runtime.initialize import pick_backend

    cards = 0
    if device == "cuda":
        import torch

        cards = torch.cuda.device_count()
    backend = pick_backend(device, world, cards)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    results: dict = {}
    procs = []
    with tempfile.TemporaryDirectory(prefix="galvatron_world_") as tmp:
        init = f"file://{os.path.join(tmp, 'rendezvous')}"
        try:
            for rank in range(world):
                p = ctx.Process(target=_child, daemon=True, args=(
                    fn, rank, world, backend, init, threads, out, args))
                p.start()
                procs.append(p)
            deadline = time.monotonic() + timeout
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"world of {world} did not finish within {timeout} "
                        f"s (ranks done: {sorted(results)})")
                try:
                    rank, status, value = out.get(timeout=min(left, 5.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead and len(results) < world:
                        raise RuntimeError(f"a rank of the world exited with "
                                           f"{dead[0]} before answering")
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{value}")
                results[rank] = value
        finally:
            for p in procs:
                p.join(timeout=10.0)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10.0)
    return [results[r] for r in range(world)]
