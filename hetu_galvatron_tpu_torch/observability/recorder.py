"""Crash-forensics flight recorder: a bounded ring of recent events +
metric snapshots, dumped atomically on fault.

Port of ``hetu_galvatron_tpu/observability/recorder.py``
(``FlightRecorder`` :60) with the same dump schema and the same
tmp+rename atomicity.

A dead run should leave a self-contained postmortem artifact. The
recorder keeps the last N structured events (recorded via :meth:`note`)
in a ``collections.deque`` ring; on a
fault, signal, or NaN-halt, :meth:`dump` snapshots every registry metric
and writes one ``flight_<ts>.json`` with the same tmp+rename atomicity
discipline as checkpoints (``runtime/checkpoint.py::_commit``) — a
torn dump is a ``.tmp`` file readers never select, not a half-valid JSON.

The dump contract: **dumping must never mask the real traceback**.
Every failure inside :meth:`dump` is swallowed into ``last_error`` and
the method returns ``None`` — the caller's crash path (the train loop's
except, PreemptionGuard) re-raises the *original* fault untouched.

Registration points:

* ``runtime/supervisor.py::PreemptionGuard`` — dumps on the first
  trapped signal (from the main thread, at the step-boundary check, not
  inside the async handler).
* ``cli/train_dist.py`` — dumps on crash (the loop's except path) and
  on rerun-machine halt codes (NaN / validation faults).
* ``runtime/supervisor.py::ProcessSupervisor`` — dumps on every abnormal
  child exit (``child_exit_<code>``).

``cli/summarize.py`` renders a dump (and warns-and-skips a torn one).
"""

from __future__ import annotations

import collections
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional

from hetu_galvatron_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
    metrics_path_of,
)

# schema marker cli/summarize.py dispatches on
FLIGHT_KIND = "flight_recorder"


def flight_dir_of(args) -> str:
    """The flight-dump directory of a run's ``CoreArgs``:
    ``observability.flight_dir``, else the metrics stream's directory
    (JAX ``cli/train_dist.py:20``)."""
    fdir = args.observability.flight_dir
    if fdir is None:
        fdir = os.path.dirname(os.path.abspath(metrics_path_of(args)))
    return fdir


def _jsonable(x: Any) -> Any:
    """Last-resort encoder (numpy scalars, tensors -> numbers, else str) —
    the dump must serialize whatever the ring happened to capture."""
    try:
        return float(x)
    except (TypeError, ValueError):
        return str(x)


class FlightRecorder:
    """Bounded in-memory black box with an atomic crash dump.

    ``capacity`` bounds the ring (oldest events fall off); ``out_dir``
    is where dumps land — ``None`` keeps the ring alive but makes
    :meth:`dump` a no-op, so a run that did not opt into an artifact
    directory never litters the filesystem. The dump's ``retained``
    section (JAX's pinned calibration records) stays empty: the port runs
    no calibration. The serving engine taps its request events into the
    ring (:meth:`attach`).
    """

    def __init__(self, *, capacity: int = 256,
                 registry: Optional[MetricsRegistry] = None,
                 out_dir: Optional[str] = None,
                 prefix: str = "flight"):
        self.capacity = max(int(capacity), 1)
        self._registry = registry
        self.out_dir = out_dir
        self.prefix = prefix
        self._ring: "collections.deque[Dict[str, Any]]" = collections.deque(
            maxlen=self.capacity)
        self.dumped: List[str] = []  # paths of successful dumps
        self.last_error: Optional[BaseException] = None

    @property
    def registry(self) -> MetricsRegistry:
        return (self._registry if self._registry is not None
                else get_registry())

    # -- recording ----------------------------------------------------------

    def record(self, name: str, data: Dict[str, Any]) -> None:
        """Tap-shaped entry point (``EventStream.add_tap(recorder.record)``)."""
        self._ring.append({"name": name, "data": data})

    def attach(self, events: Any) -> "FlightRecorder":
        """Subscribe to an ``observability.events.EventStream``; returns
        self for chaining."""
        events.add_tap(self.record)
        return self

    def note(self, name: str, **data: Any) -> None:
        """Record one entry, stamped in monotonic ms as JAX's events."""
        self.record(name, {"ev": name, "tm": time.monotonic() * 1000.0,
                           **data})

    def events(self) -> List[Dict[str, Any]]:
        return list(self._ring)

    # -- dumping ------------------------------------------------------------

    def snapshot(self, reason: str,
                 exc: Optional[BaseException] = None) -> Dict[str, Any]:
        """The dump payload: reason, optional exception (type + message +
        traceback), the event ring, and a snapshot of every registry
        metric — self-contained, no other file needed to read it."""
        metrics = []
        for m in self.registry.metrics():
            rec: Dict[str, Any] = {"kind": m.kind, "name": m.name}
            if m.labels:
                rec["labels"] = m.labels
            rec.update(m.snapshot())
            metrics.append(rec)
        payload: Dict[str, Any] = {
            "kind": FLIGHT_KIND,
            "reason": reason,
            "t": time.time(),
            "pid": os.getpid(),
            "exception": None,
            "events": list(self._ring),
            "retained": {},
            "metrics": metrics,
        }
        if exc is not None:
            payload["exception"] = {
                "type": type(exc).__name__,
                "message": str(exc),
                "traceback": "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__)),
            }
        return payload

    def dump(self, reason: str, exc: Optional[BaseException] = None,
             out_dir: Optional[str] = None) -> Optional[str]:
        """Write ``flight_<ts>.json`` atomically (tmp + rename); returns
        the path, or ``None`` when no directory is configured or anything
        failed. NEVER raises — the crash path that calls this must
        surface its own fault, not the recorder's."""
        d = out_dir if out_dir is not None else self.out_dir
        if not d:
            return None
        try:
            payload = self.snapshot(reason, exc)
            os.makedirs(d, exist_ok=True)
            ts = int(payload["t"] * 1000.0)
            path = os.path.join(d, f"{self.prefix}_{ts}_{os.getpid()}.json")
            tmp = path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(payload, f, default=_jsonable)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            self.dumped.append(path)
            return path
        except Exception as e:  # noqa: BLE001 — dumping must never mask
            # the real fault; the failure is kept for postmortem asserts
            self.last_error = e
            return None
