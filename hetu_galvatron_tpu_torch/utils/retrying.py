"""Exponential backoff with jitter, shared by every I/O retry path.

Port of ``hetu_galvatron_tpu/utils/retrying.py`` (``set_fault_injector``
:43, ``backoff_delay`` :59, ``backoff_delays`` :77, ``retry_call`` :91),
the same policy and the same random draws for the same seeded ``rng``.

One retry policy for the whole runtime (checkpoint reads and writes, the
restart supervisor): capped exponential backoff with full
jitter (the AWS architecture-blog scheme — ``sleep = uniform(0, min(cap,
base * 2**attempt))`` — which decorrelates a fleet of preempted workers
all restarting at once), a caller-supplied retryability predicate so
permanent failures (404s, validation faults) surface immediately, and
observability counters (``retry/attempts`` / ``retry/giveups`` labelled
by operation) so flaky dependencies show up on dashboards instead of in
tail latencies.

Two robustness extensions ride the same seam:

* ``deadline_s`` — a TOTAL-elapsed cap on the whole retry loop, distinct
  from the attempt cap: a hung object-store fetch that keeps "almost"
  succeeding must not stall a resume indefinitely. Sleeps are clamped to
  the remaining budget and an expired deadline surfaces the last error
  (counted as ``retry/deadline_exceeded``).
* :func:`set_fault_injector` — a process-global chaos hook consulted
  before every attempt of every ``op``-labelled call, so the fault
  harness (``runtime/chaos.py``) can inject transient I/O errors through
  the REAL retry path instead of monkeypatching call sites.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Iterator, Optional, TypeVar

T = TypeVar("T")

# chaos seam: fn(op) -> Optional[Exception]. Returning an exception makes
# the current attempt fail with it (subject to the caller's retryable
# predicate and backoff — the injected fault takes the same path a real
# flaky mount would). None = no fault. Process-global by design: the
# injector must reach retry sites deep inside checkpoint
# code without threading a parameter through every layer.
_FAULT_INJECTOR: Optional[Callable[[str], Optional[Exception]]] = None


def set_fault_injector(
    fn: Optional[Callable[[str], Optional[Exception]]],
) -> Optional[Callable[[str], Optional[Exception]]]:
    """Install (or clear, with None) the process-global fault injector;
    returns the previous one so harnesses can restore it."""
    global _FAULT_INJECTOR
    prev = _FAULT_INJECTOR
    _FAULT_INJECTOR = fn
    return prev


def _default_sleep(seconds: float) -> None:
    if seconds > 0:
        time.sleep(seconds)


def backoff_delay(
    attempt: int,
    *,
    base: float = 0.5,
    cap: float = 30.0,
    jitter: bool = True,
    rng: Optional[random.Random] = None,
) -> float:
    """Delay before retry number ``attempt`` (0-based): full-jitter capped
    exponential. With ``jitter=False`` returns the deterministic envelope
    ``min(cap, base * 2**attempt)`` (useful for tests and for callers that
    jitter elsewhere)."""
    envelope = min(float(cap), float(base) * (2.0 ** attempt))
    if not jitter:
        return envelope
    return (rng or random).uniform(0.0, envelope)


def backoff_delays(
    attempts: int,
    *,
    base: float = 0.5,
    cap: float = 30.0,
    jitter: bool = True,
    rng: Optional[random.Random] = None,
) -> Iterator[float]:
    """The ``attempts - 1`` inter-attempt delays of an ``attempts``-try
    schedule (no sleep after the final failure)."""
    for a in range(max(attempts - 1, 0)):
        yield backoff_delay(a, base=base, cap=cap, jitter=jitter, rng=rng)


def retry_call(
    fn: Callable[[], T],
    *,
    attempts: int = 3,
    base: float = 0.5,
    cap: float = 30.0,
    retryable: Callable[[Exception], bool] = lambda e: True,
    op: str = "",
    sleep: Optional[Callable[[float], None]] = None,
    rng: Optional[random.Random] = None,
    on_retry: Optional[Callable[[Exception, int, float], None]] = None,
    deadline_s: Optional[float] = None,
    clock: Callable[[], float] = time.monotonic,
) -> T:
    """Call ``fn`` up to ``attempts`` times with jittered exponential
    backoff between tries.

    A failure where ``retryable(exc)`` is false re-raises immediately (a
    404 must never burn the throttling budget); after the final attempt
    the last exception propagates unchanged. ``op`` labels the
    ``retry/attempts`` / ``retry/giveups`` observability counters;
    ``on_retry(exc, attempt, delay)`` runs before each backoff sleep
    (logging hook). ``sleep`` and ``clock`` are injectable for tests.

    ``deadline_s`` caps TOTAL elapsed wall across all attempts and
    sleeps: once exceeded, the last error surfaces even with attempts
    remaining (``retry/deadline_exceeded``), and each backoff sleep is
    clamped to the remaining budget — an attempt cap alone lets a slow
    failing ``fn`` stall a resume for attempts x its own hang time."""
    if attempts < 1:
        raise ValueError(f"attempts must be >= 1, got {attempts}")
    if sleep is None:
        sleep = _default_sleep
    start = clock()
    last: Optional[Exception] = None
    for attempt in range(attempts):
        try:
            injector = _FAULT_INJECTOR
            if injector is not None:
                injected = injector(op)
                if injected is not None:
                    raise injected
            return fn()
        except Exception as e:  # noqa: BLE001 — policy is caller-supplied
            last = e
            if not retryable(e) or attempt == attempts - 1:
                if op and attempt == attempts - 1 and retryable(e):
                    _count("retry/giveups", op)
                raise
            if deadline_s is not None and clock() - start >= deadline_s:
                if op:
                    _count("retry/deadline_exceeded", op)
                raise
            delay = backoff_delay(attempt, base=base, cap=cap, rng=rng)
            if deadline_s is not None:
                delay = min(delay,
                            max(deadline_s - (clock() - start), 0.0))
            if op:
                _count("retry/attempts", op)
            if on_retry is not None:
                on_retry(e, attempt, delay)
            sleep(delay)
    raise last  # unreachable; keeps type-checkers honest


def _count(name: str, op: str) -> None:
    """Best-effort observability: retries are diagnostics, never a reason
    for the retried operation itself to fail."""
    try:
        from hetu_galvatron_tpu_torch.observability.registry import (
            get_registry,
        )

        get_registry().counter(name, op=op).inc()
    except Exception:  # noqa: BLE001
        pass
