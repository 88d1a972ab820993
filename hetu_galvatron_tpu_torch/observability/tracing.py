"""Host-side trace spans + windowed ``torch.profiler`` trace capture.

Port of ``hetu_galvatron_tpu/observability/tracing.py`` (``span`` :39,
``TraceCapture`` :61). ``span("train/step")`` measures host wall-clock for
a code region AND enters a ``torch.profiler.record_function`` range, so
the same name shows up in a captured trace: on the host thread as a
``user_annotation`` event and, over the kernels the range launched, on the
device's stream as a ``gpu_user_annotation`` event. Eager PyTorch launches
kernels asynchronously, so a host span measures LAUNCH time, not device
time; device time lives in the captured trace under the same names.

Span durations aggregate into the registry as ``span_ms`` histograms
labelled by the nesting path (``train/step``, ...), so per-iteration spans
cost one histogram observe — no per-span records, no unbounded JSONL
growth. With no profiler running, ``record_function`` is a near-free
check.
"""

from __future__ import annotations

import os
import socket
import threading
import time
from contextlib import contextmanager
from typing import Optional

from hetu_galvatron_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
)

_tls = threading.local()

# seconds the host waits, with the card idle, after a traced window's start
# and before its stop (``TraceCapture``)
WINDOW_MARGIN_S = 0.1


@contextmanager
def span(name: str, registry: Optional[MetricsRegistry] = None):
    """Measure a region; nests (spans are named hierarchically at the call
    site). Re-entrant and thread-safe (per-thread stacks)."""
    from torch.profiler import record_function

    reg = registry or get_registry()
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    stack.append(name)
    path = "/".join(stack)
    t0 = time.perf_counter()
    try:
        with record_function(name):
            yield
    finally:
        dur_ms = (time.perf_counter() - t0) * 1000.0
        stack.pop()
        reg.histogram("span_ms", path=path).observe(dur_ms)


class TraceCapture:
    """Opt-in windowed ``torch.profiler`` capture (host and, with a card,
    CUDA activity) over iterations [start_iter, start_iter + num_iters).

    ``step(it)`` at the start of an iteration starts the profiler when
    ``it`` ENTERS the window (">= start", so a checkpoint-resumed run whose
    first iteration is already past ``start_iter`` still captures a full
    window); ``step_end(it)`` at the end of an iteration stops it after the
    window's last iteration, so the stop and the export land inside a
    traced iteration and never stretch an untraced one. The JAX class
    stops at the next ``step``; otherwise the window is the same. The trace
    is written as Chrome-trace JSON to
    ``<trace_dir>/plugins/profile/<run>/<host>.pt.trace.json``, the layout
    ``trace_analysis.load_trace`` reads. With CUDA initialized, two CUDA
    events bracket the window inside the profiler's start and stop, and
    ``window_ms`` is their elapsed time: the traced iterations' own
    CUDA-event time, which a trace's device wall can be held against. One
    capture per process lifetime; rank-gating is the caller's job.

    The profiler keeps only the device activity whose timestamp, moved
    onto the host's clock, falls between its start and its stop. Where the
    card's clock, so moved, runs ahead of the host's, the first kernels of
    the window would land before the start and be dropped, so that the
    trace would count fewer launches than ran: on an H100, a window that
    began a CUDA-graph replay lost its first kernels now and then, the
    first one it kept stamped before the host had launched it. With CUDA
    traced the card is therefore drained before the start, and the host
    waits ``WINDOW_MARGIN_S`` after the start and before the stop, with
    the card idle, outside the two CUDA events.
    ``tools/torch_trace_window_check.py`` counts what a window keeps with
    the margin off and on.
    """

    def __init__(self, trace_dir: str, start_iter: int = 0,
                 num_iters: int = 3, enabled: bool = True):
        self.trace_dir = trace_dir
        self.start_iter = start_iter
        self.num_iters = max(int(num_iters), 1)
        self.enabled = bool(enabled and trace_dir)
        self.active = False
        self.path: Optional[str] = None  # the exported trace
        self.window_ms: Optional[float] = None
        self._captured = 0
        self._prof = None
        self._ev0 = None

    def step(self, it: int) -> bool:
        """Advance the window at the start of iteration ``it``; returns
        True while this iteration is being traced (callers keep traced
        iterations out of timing stats — the instrumentation inflates
        step time)."""
        if not self.enabled:
            return False
        if self.active:
            return True
        if self._captured == 0 and it >= self.start_iter:
            import torch
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(ProfilerActivity.CUDA)
            cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
            if cuda:
                torch.cuda.synchronize()
            self._prof = profile(activities=acts)
            self._prof.start()
            if torch.cuda.is_available():
                time.sleep(WINDOW_MARGIN_S)
            if cuda:
                self._ev0 = torch.cuda.Event(enable_timing=True)
                self._ev0.record()
            self.active = True
            return True
        return False

    def step_end(self, it: int) -> None:  # noqa: ARG002 — loop symmetry
        """Close iteration ``it``: stop after the window's last one."""
        if self.active:
            self._captured += 1
            if self._captured >= self.num_iters:
                self.stop()

    def stop(self) -> None:
        """Idempotent; call at loop exit so short/crashing runs still flush
        the capture."""
        if not self.active:
            return
        import torch

        self.active = False
        self._captured = max(self._captured, 1)
        prof, self._prof = self._prof, None
        if self._ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
            ev1.synchronize()
            self.window_ms = self._ev0.elapsed_time(ev1)
            self._ev0 = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        if torch.cuda.is_available():
            time.sleep(WINDOW_MARGIN_S)
        prof.stop()
        run = os.path.join(self.trace_dir, "plugins", "profile",
                           time.strftime("%Y_%m_%d_%H_%M_%S"))
        os.makedirs(run, exist_ok=True)
        path = os.path.join(run, f"{socket.gethostname()}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.path = path
