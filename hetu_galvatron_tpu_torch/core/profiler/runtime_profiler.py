"""Runtime profiler: per-iteration timing and the iteration log line.

Counterpart of ``hetu_galvatron_tpu/core/profiler/runtime_profiler.py``
(``time_start``, ``time_end``, ``filtered_time_ms``, ``iteration_log``). On
the GPU an iteration is timed with CUDA events recorded on the current
stream around the step; on the CPU with the host clock. Iteration times
also land in the registry's ``profiler/iter_time_ms`` histogram. The
iteration log carries the per-layer MoE balance tracker (``moe[layerN]
aux .. z .. imb ..``) as the JAX log does, and sets its ``moe/aux_loss``,
``moe/z_loss`` and ``moe/imbalance`` gauges.

``profile.trace_dir`` captures a ``torch.profiler`` trace of iterations
[``profile_warmup``, ``profile_warmup + trace_iters``)
(``observability.tracing.TraceCapture``, JAX :95-139); traced iterations
stay out of the timing samples, and :meth:`analyze_trace` attributes the
capture (``observability.trace_analysis``). Memory probes and the profile
JSON writers of the model profiler are not ported.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from hetu_galvatron_tpu_torch.core.args_schema import CoreArgs
from hetu_galvatron_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
)
from hetu_galvatron_tpu_torch.observability.tracing import TraceCapture


class RuntimeProfiler:
    def __init__(self, args: CoreArgs, device: torch.device,
                 rank: int = 0, registry: Optional[MetricsRegistry] = None):
        self.args = args
        self.device = torch.device(device)
        self.rank = rank
        # None = the process default at USE time, so a profiler built
        # before the launcher configures sinks still lands in the stream
        self._registry = registry
        self.enabled = bool(args.profile.profile)
        self.time_samples: List[float] = []
        self._start: Any = None
        p = args.profile
        self._trace = TraceCapture(
            p.trace_dir, start_iter=p.profile_warmup,
            num_iters=p.trace_iters, enabled=bool(p.trace_dir and rank == 0))
        self._tracing_now = False

    @property
    def registry(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_registry()

    def time_start(self, it: int) -> None:
        self._tracing_now = self._trace.step(it)
        if not self.enabled or it < self.args.profile.profile_warmup:
            return
        if self._tracing_now:
            # the profiler inflates step time: traced iterations stay out
            # of time_samples and the iteration-time histogram
            return
        if self.device.type == "cuda":
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def time_end(self, it: int) -> None:
        """Close the iteration opened by :meth:`time_start`, waiting for
        the work enqueued since; after the trace window's last iteration,
        stop and export the capture."""
        if self._start is not None:
            if self.device.type == "cuda":
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
                ms = self._start.elapsed_time(end)
            else:
                ms = (time.perf_counter() - self._start) * 1000.0
            self.time_samples.append(ms)
            self.registry.histogram("profiler/iter_time_ms").observe(ms)
            self._start = None
        self._trace.step_end(it)

    def stop_trace(self) -> None:
        """Idempotent; also called at loop exit so short runs still
        flush."""
        self._trace.stop()

    @property
    def trace_path(self) -> Optional[str]:
        """The exported Chrome trace, once the window closed."""
        return self._trace.path

    @property
    def trace_window_ms(self) -> Optional[float]:
        """CUDA-event ms of the traced iterations (None on the CPU)."""
        return self._trace.window_ms

    def analyze_trace(self):
        """Device-time attribution of the flushed capture window
        (``observability/trace_analysis.attribute``), or None when no
        window was configured or ever flushed."""
        if not self._trace.enabled:
            return None
        from hetu_galvatron_tpu_torch.observability.trace_analysis import (
            attribute,
            load_trace,
        )

        try:
            return attribute(load_trace(self._trace.trace_dir))
        except FileNotFoundError:
            return None

    def filtered_time_ms(self) -> float:
        """Mean after dropping > 3-sigma outliers."""
        if not self.time_samples:
            return 0.0
        arr = np.asarray(self.time_samples)
        mean, std = arr.mean(), arr.std()
        keep = arr[np.abs(arr - mean) <= 3 * std] if std > 0 else arr
        return float(keep.mean())

    def printing(self, it: int) -> bool:
        """Whether :meth:`iteration_log` prints iteration ``it``."""
        return bool(self.rank == 0 and self.args.logging.log_interval
                    and it % self.args.logging.log_interval == 0)

    def iteration_log(self, it: int, metrics: Dict[str, Any],
                      lr: Optional[float] = None) -> str:
        """Print and return one line per logged iteration ("" otherwise).
        ``metrics`` values may be tensors or host floats the caller has
        already read."""
        if not self.printing(it):
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
        for name in sorted(metrics.get("moe", {})):
            # per-layer balance: aux and z loss, tokens-per-expert max/mean
            st = metrics["moe"][name]
            tpe = st["tokens_per_expert"].detach().cpu().double().numpy()
            imb = float(tpe.max() / max(tpe.mean(), 1e-9))
            aux, z = float(st["load_balance_loss"]), float(st["z_loss"])
            bits.append(f"moe[{name}] aux {aux:.3e} z {z:.3e} imb {imb:.2f}")
            self.registry.gauge("moe/aux_loss", layer=name).set(aux)
            self.registry.gauge("moe/z_loss", layer=name).set(z)
            self.registry.gauge("moe/imbalance", layer=name).set(imb)
        line = " | ".join(bits)
        print(line, flush=True)
        return line
