"""Lightweight in-process metrics registry.

Port of ``hetu_galvatron_tpu/observability/registry.py`` (``Counter`` :33,
``Gauge`` :50, ``Histogram`` :67, ``MetricsRegistry`` :118,
``get_registry`` :201, ``set_registry`` :207), in memory only: the
checkpoint, supervisor, rerun and chaos modules count into it, and a
caller reads the counts back. Sinks (the JSONL and TensorBoard writers,
``configure`` :213) belong to the observability slice and raise by name.
Design constraints, in order:

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
    """Holds metric instances. ``event``, ``flush`` and ``close`` are the
    JAX registry's sink calls: with no sinks (the port has none yet) they
    write nothing."""

    def __init__(self, sinks: Iterable[Any] = ()):
        if list(sinks):
            _no_sinks()
        self._metrics: Dict[Tuple[str, str, LabelKey], Any] = {}
        self._lock = threading.Lock()

    def add_sink(self, sink: Any) -> None:
        _no_sinks()

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

    def event(self, name: str, data: Optional[Dict[str, Any]] = None,
              step: Optional[int] = None) -> None:
        """A one-off record for the sinks; none exist yet."""

    def flush(self, step: Optional[int] = None) -> None:
        """Snapshot every metric into the sinks; none exist yet."""

    def close(self, step: Optional[int] = None) -> None:
        self.flush(step)


def _no_sinks() -> None:
    raise NotImplementedError(
        "metrics sinks (JSONL, TensorBoard) are not ported to "
        "hetu_galvatron_tpu_torch yet; the registry counts in memory only")


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
    """The JAX package installs a registry with JSONL / TensorBoard sinks
    here; the sinks are not ported yet."""
    _no_sinks()
