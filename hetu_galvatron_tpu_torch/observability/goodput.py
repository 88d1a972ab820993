"""Goodput accounting: wall-clock partitioned by what it bought.

Port of ``hetu_galvatron_tpu/observability/goodput.py``
(``GoodputTracker`` :46) with the same ``CATEGORIES`` and the same
``state_dict`` keys, so either package reads the other's totals from a
checkpoint's ``meta.json`` ``train_state["goodput"]``.

A preemptible fleet's real throughput is not step time — it is the
fraction of wall-clock that produced committed training progress. The
tracker partitions elapsed time into:

* ``productive_step`` — steps whose updates survived (the numerator),
* ``recompile``       — each attempt's first step (kernel loads, allocator
  warm-up),
* ``checkpoint_save`` — blocking save time at commit points,
* ``resume_replay``   — checkpoint restore + data-stream fast-forward,
* ``reshard``         — elastic topology changes (booked by the elastic
  path, which this port does not run yet),
* ``restart_lost``    — everything a restart threw away: post-commit
  steps of the dead attempt, downtime, supervisor backoff.

``goodput() = productive_step / sum(everything tracked)``.

Restart accounting needs no cross-process channel: :meth:`state_dict`
(stored in the checkpoint's ``train_state`` payload at every save)
carries the totals *as of the commit* plus a wall-clock stamp.
:meth:`load_state_dict` on resume restores those totals and books
``now - stamp`` as ``restart_lost`` — which by construction includes the
dead attempt's discarded post-commit work, the gap to the restart, and
the supervisor's backoff sleep, without double counting (the dead
attempt's post-commit productive time was never committed to any
snapshot). ``goodput/*`` gauges therefore survive preemption exactly as
far as the checkpoint does — the same durability contract as the model
state itself.

Everything here is host-side ``time`` arithmetic: no device values, no
syncs.
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Optional

CATEGORIES = ("productive_step", "recompile", "checkpoint_save",
              "resume_replay", "reshard", "restart_lost")


class GoodputTracker:
    """Accumulates per-category seconds; snapshot/restore via the
    checkpoint ``train_state`` payload. ``clock`` (monotonic, durations)
    and ``wall`` (epoch, cross-process gaps) are injectable for tests."""

    def __init__(self, *, clock: Callable[[], float] = time.perf_counter,
                 wall: Callable[[], float] = time.time):
        self._clock = clock
        self._wall = wall
        self.totals: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
        self.restarts_survived = 0

    # -- accumulation -------------------------------------------------------

    def add(self, category: str, seconds: float) -> None:
        if seconds > 0:
            self.totals[category] = self.totals.get(category, 0.0) + seconds

    @contextmanager
    def measure(self, category: str):
        t0 = self._clock()
        try:
            yield
        finally:
            self.add(category, self._clock() - t0)

    # -- derived ------------------------------------------------------------

    def total(self) -> float:
        return sum(self.totals.values())

    def goodput(self) -> float:
        """Productive share of all tracked wall-clock (1.0 when nothing
        was tracked yet — an unstarted run has lost nothing)."""
        total = self.total()
        if total <= 0:
            return 1.0
        return self.totals.get("productive_step", 0.0) / total

    # -- persistence (checkpoint train_state payload) -----------------------

    def state_dict(self) -> Dict[str, Any]:
        """Snapshot for the checkpoint: totals as of this commit plus a
        wall-clock stamp the resuming process diffs against."""
        return {"totals": dict(self.totals), "wall_time": self._wall(),
                "restarts_survived": self.restarts_survived}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        """Merge a committed snapshot into this (fresh) tracker: prior
        totals accumulate, and the wall-clock gap since the commit is
        booked as ``restart_lost`` — the dead attempt's discarded
        post-commit work plus all downtime and backoff."""
        for k, v in (state.get("totals") or {}).items():
            self.totals[k] = self.totals.get(k, 0.0) + float(v)
        self.restarts_survived = int(state.get("restarts_survived", 0)) + 1
        stamp = state.get("wall_time")
        if stamp is not None:
            self.add("restart_lost", max(0.0, self._wall() - float(stamp)))

    # -- export -------------------------------------------------------------

    def flush(self, registry: Any) -> None:
        """Set the ``goodput/*`` gauges (cumulative seconds per category,
        the goodput fraction, and restarts survived) into ``registry``."""
        for c in CATEGORIES:
            registry.gauge(f"goodput/{c}_s").set(self.totals.get(c, 0.0))
        registry.gauge("goodput/goodput_frac").set(self.goodput())
        registry.gauge("goodput/restarts_survived").set(
            self.restarts_survived)
