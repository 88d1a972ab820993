"""Hardware profiler: the collective benchmarks, at world size 1.

Port of ``hetu_galvatron_tpu/core/profiler/hardware_profiler.py``:
``HardwareProfiler.run_all`` and its suites, which write the four files
the search reads under JAX's names (``allreduce_bandwidth_<tag>.json``,
``p2p_bandwidth_<tag>.json``, ``sp_time_<tag>.json`` and
``overlap_coefficient.json``, ``<tag>`` = ``<n>nodes_<m>gpus_per_node``).
The world is the smaller of ``num_nodes * num_devices_per_node`` and the
visible devices, as in JAX. At world 1 every suite's loop over group sizes
is empty: JAX writes ``{}`` for the all-reduce, p2p and sp-time files and
``{"overlap_coe": 1.0}`` (:428-429). The port's suites return those
world-1 results, on the card or on the CPU.

A world above 1 times collectives over process groups: the NCCL
benchmarks come with the SPMD plans (ROADMAP item 10b), so
:class:`HardwareProfiler` refuses such a world, and ``_collective_ms``,
which would time one collective over a group, raises by name.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from hetu_galvatron_tpu_torch.core.args_schema import HardwareProfileArgs
from hetu_galvatron_tpu_torch.core.search_engine.profiles import write_json

NCCL_ITEM = ("the NCCL collective benchmarks of the hardware profiler "
             "(world size above 1) are not ported yet (ROADMAP item 10b)")


class HardwareProfiler:
    def __init__(self, args: HardwareProfileArgs, devices: int = 1):
        self.args = args
        self.world = min(devices, args.num_nodes * args.num_devices_per_node)
        if self.world > 1:
            raise NotImplementedError(
                f"hardware profile at world size {self.world}: "
                f"{NCCL_ITEM}")

    def _collective_ms(self, op: str, group: List[int],
                       message_mb: float) -> float:
        raise NotImplementedError(f"{op} over {len(group)} devices: "
                                  f"{NCCL_ITEM}")

    # -- benchmark suites: their world-1 results ----------------------------

    def profile_allreduce_bandwidth(self, message_mb: int = 64
                                    ) -> Dict[str, float]:
        """MB/ms per (group size >= 2, consecutiveness): none at world 1."""
        return {}

    def profile_p2p_bandwidth(self, message_mb: int = 64) -> Dict[str, float]:
        """MB/ms per pipeline degree >= 2: none at world 1."""
        return {}

    def profile_sp_time(self) -> Dict[str, float]:
        """All-reduce and all-to-all latency per group size >= 2 and message
        size: none at world 1."""
        return {}

    def profile_alpha_beta(self, sp_times: Optional[Dict[str, float]] = None
                           ) -> Dict[str, float]:
        """The fitted α-β pairs per group size >= 2: none at world 1."""
        return {}

    def profile_alpha_beta_algos(self) -> Dict[str, float]:
        """The per-algorithm, per-level α-β pairs: none at world 1."""
        return {}

    def profile_overlap_coefficient(self, message_mb: int = 64) -> Dict:
        """The compute slowdown under a concurrent collective: 1.0 with no
        collective to overlap."""
        return {"overlap_coe": 1.0}

    # -- output -------------------------------------------------------------

    def run_all(self, output_dir: Optional[str] = None) -> Dict[str, str]:
        """Run every suite and write the four files."""
        a = self.args
        out_dir = output_dir or a.output_dir
        tag = f"{a.num_nodes}nodes_{a.num_devices_per_node}gpus_per_node"
        sp_times = self.profile_sp_time()
        bandwidth = self.profile_allreduce_bandwidth()
        bandwidth.update(self.profile_alpha_beta(sp_times))
        if a.profile_algos:
            bandwidth.update(self.profile_alpha_beta_algos())
        paths = {}
        for name, cfg in [
            (f"allreduce_bandwidth_{tag}.json", bandwidth),
            (f"p2p_bandwidth_{tag}.json", self.profile_p2p_bandwidth()),
            (f"sp_time_{tag}.json", sp_times),
            ("overlap_coefficient.json", self.profile_overlap_coefficient()),
        ]:
            path = os.path.join(out_dir, name)
            write_json(cfg, path)
            paths[name] = path
        return paths
