"""Metric sinks: where registry snapshots and span/event records land.

Port of ``hetu_galvatron_tpu/observability/sinks.py`` (``NullSink`` :24,
``JsonlSink`` :38) with the same record schema, key for key (one JSON
object per line in the JSONL sink):

  {"t": <unix seconds>, "kind": "counter"|"gauge",
   "name": ..., "value": ..., "labels": {...}, "step": <int|null>}
  {"t": ..., "kind": "histogram", "name": ..., "labels": {...},
   "count": n, "mean": ..., "min": ..., "max": ...,
   "p50": ..., "p90": ..., "p99": ..., "step": ...}
  {"t": ..., "kind": "event", "name": ..., "data": {...}}

Counters/gauges carry their CURRENT value at flush time (not deltas), so
the last record per name in a file is the end-of-run value and any record
stream is trivially resumable. ``cli/summarize.py`` (of either package)
consumes this schema. The TensorBoard sink is not ported: the card's
machine has no writer package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional


class NullSink:
    """Swallows everything."""

    def write(self, record: Dict[str, Any]) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


class JsonlSink:
    """Append-only JSONL file sink (always available — no deps).

    Records are buffered in memory and written on ``flush()`` so the hot
    loop never blocks on file I/O; ``close()`` flushes. The file is opened
    lazily on first flush so constructing a sink for a run that emits
    nothing leaves no artifact behind.

    Each flush lands as ONE ``os.write`` on an ``O_APPEND`` descriptor:
    when several processes (supervisor + restarted attempt, or a
    calibration sidecar) append to the same stream, their batches
    interleave at whole-flush granularity instead of mid-line — the
    reader-side contract (``cli/summarize.py`` skips unparseable lines
    with a warning) then only ever faces a torn FINAL line from a crash
    mid-write, not interior corruption.
    """

    def __init__(self, path: str):
        self.path = path
        self._buf: List[str] = []
        self._fd: Optional[int] = None

    def write(self, record: Dict[str, Any]) -> None:
        self._buf.append(json.dumps(record, separators=(",", ":"),
                                    default=_jsonable))

    def flush(self) -> None:
        if not self._buf:
            return
        if self._fd is None:
            d = os.path.dirname(os.path.abspath(self.path))
            os.makedirs(d, exist_ok=True)
            self._fd = os.open(self.path,
                               os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                               0o644)
        os.write(self._fd, ("\n".join(self._buf) + "\n").encode("utf-8"))
        self._buf.clear()

    def close(self) -> None:
        self.flush()
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None


def _jsonable(x):
    """Last-resort encoder: numpy scalars and one-element tensors ->
    python numbers."""
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)
