"""Per-request lifecycle event stream (the serving half of observability).

Port of ``hetu_galvatron_tpu/observability/events.py`` (``EventStream``),
with the same records: a structured event per lifecycle transition,
written as registry events (``kind: "event"``, ``name: "request"``)
through the JSONL sink, so one metrics stream carries the aggregates and
each request's story, and ``cli/summarize.py`` of either package reads
it.

Event vocabulary (the ``ev`` field; every timeline starts with
``submit`` and ends with ``retire``):

=============  ==========================================================
``submit``     request entered the system (prompt_len, max_new)
``admit``      scheduler granted a slot (slot, queue_ms, cached_len,
               hit_blocks, suffix, bucket, cold_retry)
``prefill``    prefill dispatch for the uncached suffix (bucket, suffix,
               cached, ms)
``first_token`` TTFT with its additive split: queue_ms + prefill_ms +
               decode_ms == ttft_ms
``decode``     one plain decode step emitted one token (pos)
``verify``     one speculative window (drafted, accepted)
``retire``     terminal transition (status, reason, generated);
               ``queued=True`` marks a request resolved before admission
=============  ==========================================================

Records carry a global sequence number (``seq``) and a monotonic-clock
millisecond stamp (``tm``), so a timeline's order can be verified after
the fact (``cli/summarize.py::request_timelines``).

Cost: host-side dict assembly and a buffered sink write, no device value
and no sync. With ``enabled=False`` and no taps, ``emit`` is one
attribute check; taps (the flight recorder's ring) still receive events
when the sink stream is off.
"""

from __future__ import annotations

import itertools
import time
from typing import Any, Callable, Dict, List, Optional

from hetu_galvatron_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
)

# the registry-event name every lifecycle record is filed under
REQUEST_EVENT = "request"

# terminal event: a timeline missing it is incomplete (crashed run)
TERMINAL_EV = "retire"


class EventStream:
    """Structured request-lifecycle event emitter.

    ``enabled`` gates the sink write (the JSONL stream); taps — e.g.
    :class:`~hetu_galvatron_tpu_torch.observability.recorder.FlightRecorder`
    — always receive events, so crash forensics works even when the
    full stream is off. A tap that raises is counted
    (``tap_errors``) and skipped; event emission must never take down
    the serving loop it instruments.
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None, *,
                 enabled: bool = True, name: str = REQUEST_EVENT):
        self.registry = registry if registry is not None else get_registry()
        self.enabled = bool(enabled)
        self.name = name
        self.tap_errors = 0
        self._taps: List[Callable[[str, Dict[str, Any]], None]] = []
        self._seq = itertools.count()

    def add_tap(self, fn: Callable[[str, Dict[str, Any]], None]) -> None:
        """Subscribe ``fn(name, data)`` to every emitted event (called
        synchronously, exceptions swallowed-and-counted)."""
        self._taps.append(fn)

    def emit(self, ev: str, rid: Optional[int] = None,
             **fields: Any) -> Optional[Dict[str, Any]]:
        """Record one lifecycle event; returns the data dict (or None on
        the disabled fast path). ``seq`` totally orders events within a
        stream; ``tm`` is monotonic milliseconds (duration arithmetic,
        never wall-clock)."""
        if not self.enabled and not self._taps:
            return None
        data: Dict[str, Any] = {"ev": ev, "seq": next(self._seq),
                                "tm": time.monotonic() * 1000.0}
        if rid is not None:
            data["rid"] = int(rid)
        data.update(fields)
        for tap in self._taps:
            try:
                tap(self.name, data)
            except Exception:  # noqa: BLE001 — a broken tap must not
                # break serving; the count surfaces it
                self.tap_errors += 1
        if self.enabled:
            self.registry.event(self.name, data)
        return data
