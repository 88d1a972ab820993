"""Lightweight in-process metrics registry.

Port of ``hetu_galvatron_tpu/observability/registry.py`` (``Counter`` :33,
``Gauge`` :50, ``Histogram`` :67, ``MetricsRegistry`` :118,
``get_registry`` :201, ``set_registry`` :207, ``configure`` :213) and
the stream's path rule (:func:`metrics_path_of`): the
checkpoint, supervisor, rerun and chaos modules, the profiler and the
telemetry count into it, and its snapshots and events go to the sinks of
``sinks.py``. ``configure`` installs a registry with the JSONL sink; the
TensorBoard sink is not ported (the card's machine has no writer
package) and raises by name. Design constraints, in order:

1. **Hot-path cost is a dict lookup + a float op.** Metric handles are
   cached per (name, labels) so instrumented code can call
   ``registry.counter("x").inc()`` every iteration; nothing touches a sink
   until ``flush()``.
2. **Safe as a process-wide default.** Instrumentation inside library code
   (rerun machine, profiler, pipeline) goes through :func:`get_registry`,
   which always returns a live registry — with no sinks attached it is a
   pure in-memory accumulator, so un-configured runs pay only the float op.
3. **Bounded memory.** Histograms keep a capped sample buffer (random-ish
   decimation beyond the cap) so million-step runs cannot OOM the host.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonically increasing value."""

    kind = "counter"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self.value}


class Gauge:
    """Last-write-wins value."""

    kind = "gauge"

    def __init__(self, name: str, labels: Dict[str, str]):
        self.name = name
        self.labels = labels
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> Dict[str, Any]:
        return {"value": self.value}


class Histogram:
    """Sample distribution with percentile snapshots.

    Keeps at most ``cap`` samples: past the cap, every other retained
    sample is dropped and the keep-stride doubles, preserving an unbiased
    spread over the whole run at O(cap) memory. count/sum stay exact.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: Dict[str, str], cap: int = 4096):
        self.name = name
        self.labels = labels
        self.cap = cap
        self.count = 0
        self.total = 0.0
        self._samples: List[float] = []
        self._stride = 1

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if self.count % self._stride == 0:
            self._samples.append(v)
            if len(self._samples) >= self.cap:
                self._samples = self._samples[::2]
                self._stride *= 2

    def percentile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        return float(np.percentile(np.asarray(self._samples), q))

    def snapshot(self) -> Dict[str, Any]:
        if not self.count:
            return {"count": 0, "mean": 0.0, "min": 0.0, "max": 0.0,
                    "p50": 0.0, "p90": 0.0, "p99": 0.0}
        arr = np.asarray(self._samples)
        p50, p90, p99 = np.percentile(arr, [50, 90, 99])
        return {
            "count": self.count,
            "mean": self.total / self.count,
            "min": float(arr.min()),
            "max": float(arr.max()),
            "p50": float(p50),
            "p90": float(p90),
            "p99": float(p99),
        }


class MetricsRegistry:
    """Holds metric instances and routes snapshots/events to sinks."""

    def __init__(self, sinks: Iterable[Any] = ()):
        self._sinks: List[Any] = list(sinks)
        self._metrics: Dict[Tuple[str, str, LabelKey], Any] = {}
        self._lock = threading.Lock()

    # -- sinks --------------------------------------------------------------

    def add_sink(self, sink: Any) -> None:
        self._sinks.append(sink)

    @property
    def sinks(self) -> List[Any]:
        return list(self._sinks)

    # -- metric handles -----------------------------------------------------

    def _get(self, cls, name: str, labels: Dict[str, Any]):
        key = (cls.kind, name, _label_key(labels))
        m = self._metrics.get(key)
        if m is None:
            with self._lock:
                m = self._metrics.get(key)
                if m is None:
                    m = cls(name, {str(k): str(v)
                                   for k, v in labels.items()})
                    self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def metrics(self) -> List[Any]:
        return list(self._metrics.values())

    # -- output -------------------------------------------------------------

    def event(self, name: str, data: Optional[Dict[str, Any]] = None,
              step: Optional[int] = None) -> None:
        """One-off structured record, written through immediately (sinks
        buffer internally) — used for span records and supervisor events."""
        rec = {"t": time.time(), "kind": "event", "name": name,
               "data": data or {}}
        if step is not None:
            rec["step"] = step
        for s in self._sinks:
            s.write(rec)

    def flush(self, step: Optional[int] = None) -> None:
        """Snapshot every metric into each sink, then flush the sinks."""
        now = time.time()
        for m in self.metrics():
            rec = {"t": now, "kind": m.kind, "name": m.name, "step": step}
            if m.labels:
                rec["labels"] = m.labels
            rec.update(m.snapshot())
            for s in self._sinks:
                s.write(rec)
        for s in self._sinks:
            s.flush()

    def close(self, step: Optional[int] = None) -> None:
        self.flush(step)
        for s in self._sinks:
            s.close()


# ---------------------------------------------------------------------------
# process-wide default
# ---------------------------------------------------------------------------

_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide registry library instrumentation uses. Always live;
    with no sinks configured it is a free-standing accumulator."""
    return _DEFAULT


def set_registry(reg: MetricsRegistry) -> MetricsRegistry:
    global _DEFAULT
    _DEFAULT = reg
    return reg


def configure(jsonl_path: Optional[str] = None,
              tensorboard_dir: Optional[str] = None) -> MetricsRegistry:
    """Install a fresh default registry with the JSONL sink attached. A
    TensorBoard directory raises: its writer packages (tensorboardX,
    ``torch.utils.tensorboard``'s) are absent from the card's machine."""
    from hetu_galvatron_tpu_torch.observability.sinks import JsonlSink

    if tensorboard_dir:
        raise NotImplementedError(
            "the TensorBoard sink (observability.tensorboard) is not ported "
            "to hetu_galvatron_tpu_torch: use the JSONL metrics stream")
    sinks: List[Any] = []
    if jsonl_path:
        sinks.append(JsonlSink(jsonl_path))
    return set_registry(MetricsRegistry(sinks))


def metrics_path_of(args) -> str:
    """The metrics stream of a run's ``CoreArgs``:
    ``observability.metrics_path``, else
    ``<logging.tensorboard_dir or .>/metrics.jsonl`` (the one derivation
    the telemetry, the supervisor and the flight recorder share)."""
    import os

    return args.observability.metrics_path or os.path.join(
        args.logging.tensorboard_dir or ".", "metrics.jsonl")
