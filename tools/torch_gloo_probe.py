#!/usr/bin/env python
"""Which collectives gloo takes on this machine, and how fast on the host.

::

    python3 tools/torch_gloo_probe.py [WORLD ...]

For each world size (2 and 4 by default) it spawns that many ranks
(``parallel/launch.spawn_world``, gloo) and tries, on CPU tensors and on
CUDA tensors of the first card, each collective the SPMD step uses
(``parallel/comm.py``): all-reduce (sum and max), broadcast, all-gather into
a list and into a tensor, reduce-scatter and all-to-all; then it times an
all-reduce and an all-gather of 25, 100 and 500 MB of CPU tensors. It
prints the torch and CUDA versions, the card, and one JSON object a
world: "ok" or the error of each collective, and the seconds of each
timed call (the mean of 3 all-reduces, one all-gather). Run it from the
root of the repository on a machine with a card.
"""

from __future__ import annotations

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def probe(rank, world):
    import torch
    import torch.distributed as dist

    res = {}
    devices = ["cpu"] + (["cuda"] if torch.cuda.is_available() else [])
    for where in devices:
        dev = torch.device(where, 0) if where == "cuda" else torch.device(
            "cpu")

        def t(n=8):
            return torch.arange(n, dtype=torch.float32, device=dev) + rank

        cases = {
            "all_reduce": lambda: dist.all_reduce(t()),
            "all_reduce_max": lambda: dist.all_reduce(
                t(), op=dist.ReduceOp.MAX),
            "broadcast": lambda: dist.broadcast(t(), 0),
            "all_gather": lambda: dist.all_gather(
                [torch.empty(8, device=dev) for _ in range(world)], t()),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(8 * world, device=dev), t()),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(8, device=dev), t(8 * world)),
            "all_to_all_single": lambda: dist.all_to_all_single(
                torch.empty(8 * world, device=dev), t(8 * world)),
        }
        for name, fn in cases.items():
            try:
                fn()
                if where == "cuda":
                    torch.cuda.synchronize()
                res[f"{where}:{name}"] = "ok"
            except (RuntimeError, ValueError) as e:
                res[f"{where}:{name}"] = f"{type(e).__name__}: {str(e)[:80]}"
            dist.barrier()
    for mb in (25, 100, 500):
        x = torch.ones(mb * 2 ** 20 // 4)
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            dist.all_reduce(x)
        res[f"all_reduce_{mb}MB_s"] = (time.perf_counter() - t0) / 3
        out = [torch.empty_like(x) for _ in range(world)]
        dist.barrier()
        t0 = time.perf_counter()
        dist.all_gather(out, x)
        res[f"all_gather_{mb}MB_s"] = time.perf_counter() - t0
    return res


def main(argv) -> int:
    sys.path.insert(0, ROOT)
    import torch

    from hetu_galvatron_tpu_torch.parallel.launch import spawn_world

    card = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "no card")
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          card, flush=True)
    for world in [int(a) for a in argv] or [2, 4]:
        t0 = time.perf_counter()
        res = spawn_world(probe, world, device="cpu", timeout=300,
                          threads=None)[0]
        print(json.dumps({"world": world,
                          "wall_s": time.perf_counter() - t0, **res}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
