"""Runtime profiler: per-iteration timing and the iteration log line.

Counterpart of ``hetu_galvatron_tpu/core/profiler/runtime_profiler.py``
(``time_start``, ``time_end``, ``filtered_time_ms``, ``iteration_log``). On
the GPU an iteration is timed with CUDA events recorded on the current
stream around the step; on the CPU with the host clock. Trace capture,
memory probes and the profile JSON writers are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs


class RuntimeProfiler:
    def __init__(self, args: CoreArgs, device: torch.device,
                 rank: int = 0):
        if args.profile.trace_dir:
            raise NotImplementedError(
                "profile.trace_dir (trace capture) is not ported yet")
        self.args = args
        self.device = torch.device(device)
        self.rank = rank
        self.enabled = bool(args.profile.profile)
        self.time_samples: List[float] = []
        self._start: Any = None

    def time_start(self, it: int) -> None:
        if not self.enabled or it < self.args.profile.profile_warmup:
            return
        if self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def time_end(self, it: int) -> None:
        """Close the iteration opened by :meth:`time_start`, waiting for
        the work enqueued since."""
        if self._start is None:
            return
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            ms = self._start.elapsed_time(end)
        else:
            ms = (time.perf_counter() - self._start) * 1000.0
        self.time_samples.append(ms)
        self._start = None

    def filtered_time_ms(self) -> float:
        """Mean after dropping > 3-sigma outliers."""
        if not self.time_samples:
            return 0.0
        arr = np.asarray(self.time_samples)
        mean, std = arr.mean(), arr.std()
        keep = arr[np.abs(arr - mean) <= 3 * std] if std > 0 else arr
        return float(keep.mean())

    def iteration_log(self, it: int, metrics: Dict[str, Any],
                      lr: Optional[float] = None) -> str:
        """Print and return one line per logged iteration ("" otherwise)."""
        printing = (self.rank == 0 and self.args.logging.log_interval
                    and it % self.args.logging.log_interval == 0)
        if not printing:
            return ""
        bits = [f"iter {it}"]
        if "loss" in metrics:
            bits.append(f"loss {float(metrics['loss']):.4f}")
        if "grad_norm" in metrics:
            bits.append(f"grad-norm {float(metrics['grad_norm']):.3f}")
        if lr is not None:
            bits.append(f"lr {lr:.3e}")
        if self.time_samples:
            bits.append(f"iter-time {self.time_samples[-1]:.1f}ms")
        line = " | ".join(bits)
        print(line, flush=True)
        return line
