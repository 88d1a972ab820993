"""Device-time attribution of a captured ``torch.profiler`` trace.

Port of the attribution half of
``hetu_galvatron_tpu/observability/trace_analysis.py``: ``load_trace``
:87, ``op_category`` :180, ``Attribution`` :210, ``STEP_SPANS`` and
``attribute`` :251. It reads the Chrome-trace JSON that
``tracing.TraceCapture`` exports (stdlib json, gzip accepted):

* **Device ops** are the CUDA activity events: ``"cat": "kernel"``, plus
  ``gpu_memcpy`` and ``gpu_memset``. The port's ctypes-launched kernels
  K1-K5 appear under their CUDA names (``flash_fwd_kernel_tc<...>``,
  ``ce_bwd_kernel``, ...). Each (pid, tid) is one device track (a
  stream).
* **Spans** are the ``user_annotation`` (host thread) and
  ``gpu_user_annotation`` (the device stream, over the kernels a range
  launched) events that ``tracing.span`` leaves through
  ``record_function``; ``STEP_SPANS`` marks the steps, counted per track
  with the maximum taken, as in JAX.
* **Categories** are those of ``tools/torch_step_breakdown.py``, keyed
  short (``flash_fwd`` for K1 ... ``ce_bwd`` for K5, ``matmul``,
  ``optimizer``, ``norm_reduce``, ``elementwise``, ``copy``, ``other``),
  with NCCL's collectives ahead of them under JAX's collective names.

``jit_cost_summary`` :430 and ``maybe_record_jit_cost`` :461 count one
program's FLOPs, the captured step of the compiled pipeline
(``runtime/compiled_pipeline.py``): eager PyTorch has no compiled
program whose cost analysis could be read, so the program runs once (its
warm-up run, which the step needs anyway) under a dispatch mode that
applies ``torch.utils.flop_counter``'s formulas to the operators that
have one and runs every operator as it is (``FlopCounterMode`` itself
decomposes the others, which changes the run's bits), and the caller
adds what no mode can see, the kernels launched through ctypes (K1-K5),
as ``extra_flops``. ``bytes_accessed`` is left out: eager PyTorch has no
count of the bytes a program moves, as JAX leaves out a key XLA cannot
answer.

Out of this port, with the reason: the plan audit
(``predicted_comm_per_step``, ``audit_plan``, ``analyze_and_audit``) needs
the cost model and the collectives of multi-rank plans.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

# ---------------------------------------------------------------------------
# trace loading (Chrome trace event format, torch.profiler output)
# ---------------------------------------------------------------------------


def latest_profile_dir(trace_dir: str) -> Optional[str]:
    """Newest ``plugins/profile/<run>`` directory under a TraceCapture
    trace_dir (run names are timestamps, so lexicographic max = newest);
    None when no capture ever flushed."""
    runs = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*")))
    runs = [r for r in runs if os.path.isdir(r)]
    return runs[-1] if runs else None


@dataclass
class TraceData:
    """Merged events + track names from one profile run directory."""

    events: List[dict]
    process_names: Dict[int, str] = field(default_factory=dict)
    thread_names: Dict[Tuple[int, int], str] = field(default_factory=dict)
    path: str = ""


def load_trace(trace_dir: str) -> TraceData:
    """Parse the newest capture under ``trace_dir``. Accepts either the
    TraceCapture root (``<dir>/plugins/profile/<run>/...``) or a run
    directory itself. Unreadable/torn files are skipped — a crashed run's
    half-written capture must not kill the post-mortem."""
    run = trace_dir
    if not glob.glob(os.path.join(run, "*.trace.json*")):
        found = latest_profile_dir(trace_dir)
        if found is None:
            raise FileNotFoundError(
                f"no trace capture under {trace_dir!r} (expected "
                "plugins/profile/<run>/*.trace.json)")
        run = found
    events: List[dict] = []
    procs: Dict[int, str] = {}
    threads: Dict[Tuple[int, int], str] = {}
    for path in sorted(glob.glob(os.path.join(run, "*.trace.json.gz"))
                       + glob.glob(os.path.join(run, "*.trace.json"))):
        try:
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rt") as f:
                obj = json.load(f)
        except (OSError, EOFError, json.JSONDecodeError, UnicodeDecodeError):
            continue
        for e in obj.get("traceEvents", []) if isinstance(obj, dict) else []:
            if not isinstance(e, dict):
                continue
            ph = e.get("ph")
            if ph == "M":
                args = e.get("args") or {}
                if e.get("name") == "process_name":
                    procs[e.get("pid")] = str(args.get("name", ""))
                elif e.get("name") == "thread_name":
                    threads[(e.get("pid"), e.get("tid"))] = str(
                        args.get("name", ""))
            elif ph == "X" and isinstance(e.get("dur"), (int, float)):
                events.append(e)
    return TraceData(events, procs, threads, run)


# ---------------------------------------------------------------------------
# event classification
# ---------------------------------------------------------------------------

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CATS = ("user_annotation", "gpu_user_annotation")

# NCCL kernel names (ncclDevKernel_AllReduce_Sum_f32_RING_LL, ...) ->
# JAX's collective categories
_COLLECTIVE_STEMS: Tuple[Tuple[str, str], ...] = (
    ("allreduce", "allreduce"),
    ("reducescatter", "reducescatter"),
    ("allgather", "allgather"),
    ("alltoall", "alltoall"),
    ("sendrecv", "p2p"),
    ("send", "p2p"),
    ("recv", "p2p"),
    ("broadcast", "broadcast"),
)
COLLECTIVES = frozenset(c for _, c in _COLLECTIVE_STEMS)
# the compute categories, first match wins on the lower-cased kernel name
# (tools/torch_step_breakdown.py reads this table too)
_COMPUTE: Tuple[Tuple[str, Tuple[str, ...]], ...] = (
    ("flash_fwd", ("flash_fwd_kernel",)),
    ("flash_bwd_dkdv", ("flash_bwd_dkdv_kernel",)),
    ("flash_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("ce_fwd", ("ce_fwd_kernel",)),
    ("ce_bwd", ("ce_bwd_kernel",)),
    ("matmul", ("gemm", "nvjet", "xmma", "cutlass", "sm90_", "sm80_")),
    ("optimizer", ("multi_tensor_apply", "foreach")),
    ("norm_reduce", ("softmax", "norm", "reduce", "logsumexp")),
    ("elementwise", ("elementwise", "vectorized", "gelu")),
    ("copy", ("copy", "memcpy", "memset", "fill", "cat")),
)


def op_category(name: str) -> str:
    """A device op's category: an NCCL collective by kind, else its
    compute category (the one table ``tools/torch_step_breakdown.py``
    also reads), else ``other``."""
    low = name.lower()
    if "nccl" in low:
        for stem, cat in _COLLECTIVE_STEMS:
            if stem in low:
                return cat
    for cat, keys in _COMPUTE:
        if any(k in low for k in keys):
            return cat
    return "other"


def _merged_busy_ms(intervals: List[Tuple[float, float]]) -> float:
    """Total covered µs->ms of possibly-overlapping (start, end) pairs."""
    if not intervals:
        return 0.0
    intervals.sort()
    busy = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy / 1000.0


@dataclass
class Attribution:
    """Measured device-time breakdown of one captured trace window.

    Per-device quantities divide the summed device-track time by the
    number of tracks; divide by ``steps`` for per-step numbers.
    ``category_launches`` counts the device ops of each category over the
    window (port-only: it holds the launch counters to the trace)."""

    steps: int = 0
    tracks: int = 0
    wall_ms: float = 0.0              # first-to-last device op
    device_busy_ms: float = 0.0       # summed over tracks
    per_device_busy_ms: float = 0.0
    bubble_ms: float = 0.0            # per-device idle inside the wall window
    bubble_frac: float = 0.0
    categories_ms: Dict[str, float] = field(default_factory=dict)  # per-device
    category_launches: Dict[str, int] = field(default_factory=dict)
    host_span_ms: Dict[str, float] = field(default_factory=dict)   # host wall
    device_annotation_ms: Dict[str, float] = field(default_factory=dict)

    @property
    def collective_ms(self) -> float:
        return sum(v for k, v in self.categories_ms.items()
                   if k in COLLECTIVES)

    @property
    def compute_ms(self) -> float:
        return sum(v for k, v in self.categories_ms.items()
                   if k not in COLLECTIVES)


# span names that mark one optimizer step, tried in order
STEP_SPANS = ("train/step",)


def attribute(trace: TraceData,
              step_spans: Sequence[str] = STEP_SPANS) -> Attribution:
    """Attribute the captured window: device ops by category, busy and
    idle time per device track, host span paths by interval containment
    per thread, device time under each ``gpu_user_annotation``, and the
    number of steps."""
    dev_events: List[Tuple[int, int, float, float, str]] = []
    ann_events: List[Tuple[int, int, float, float, str, bool]] = []
    for e in trace.events:
        cat = e.get("cat")
        pid, tid = e.get("pid"), e.get("tid")
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        name = str(e.get("name", ""))
        if cat in DEVICE_CATS:
            dev_events.append((pid, tid, ts, dur, name))
        elif cat in SPAN_CATS:
            ann_events.append((pid, tid, ts, dur, name,
                               cat == "gpu_user_annotation"))

    attr = Attribution()
    if not dev_events and not ann_events:
        return attr

    # -- device tracks: busy/idle + categories --
    by_track: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    cats: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for pid, tid, ts, dur, name in dev_events:
        by_track.setdefault((pid, tid), []).append((ts, dur))
        cat = op_category(name)
        cats[cat] = cats.get(cat, 0.0) + dur / 1000.0
        counts[cat] = counts.get(cat, 0) + 1
    all_ops = [(ts, ts + d) for evs in by_track.values() for ts, d in evs]
    if by_track:
        w0 = min(s for s, _ in all_ops)
        w1 = max(e for _, e in all_ops)
        attr.wall_ms = (w1 - w0) / 1000.0
        for evs in by_track.values():
            busy = _merged_busy_ms([(ts, ts + d) for ts, d in evs])
            attr.device_busy_ms += busy
            attr.bubble_ms += max(attr.wall_ms - busy, 0.0)
        attr.tracks = len(by_track)
        attr.per_device_busy_ms = attr.device_busy_ms / attr.tracks
        attr.bubble_ms /= attr.tracks
        denom = attr.per_device_busy_ms + attr.bubble_ms
        attr.bubble_frac = attr.bubble_ms / denom if denom > 0 else 0.0
        attr.categories_ms = {k: v / attr.tracks for k, v in cats.items()}
        attr.category_launches = counts

    # -- spans: nesting paths per track + device time under device spans --
    ann_by_track: Dict[Tuple[int, int],
                       List[Tuple[float, float, str, bool]]] = {}
    for pid, tid, ts, dur, name, on_dev in ann_events:
        ann_by_track.setdefault((pid, tid), []).append(
            (ts, dur, name, on_dev))
    # steps are counted PER TRACK and the max taken: a step span shows on
    # the host thread and again on the device stream
    step_counts: Dict[str, Dict[Tuple[int, int], int]] = {}
    for key, evs in ann_by_track.items():
        evs.sort(key=lambda t: (t[0], -t[1]))
        stack: List[Tuple[float, str]] = []  # (end, path)
        for ts, dur, name, on_dev in evs:
            while stack and ts >= stack[-1][0] - 1e-9:
                stack.pop()
            path = (stack[-1][1] + "/" + name) if stack else name
            stack.append((ts + dur, path))
            if name in step_spans:
                per_track = step_counts.setdefault(name, {})
                per_track[key] = per_track.get(key, 0) + 1
            if on_dev:
                # the device ops the range covers, on any stream
                covered = [(max(ts, s), min(ts + dur, e)) for s, e in all_ops
                           if s < ts + dur and e > ts]
                attr.device_annotation_ms[name] = \
                    attr.device_annotation_ms.get(name, 0.0) + \
                    _merged_busy_ms([c for c in covered if c[1] > c[0]])
            else:
                attr.host_span_ms[path] = attr.host_span_ms.get(
                    path, 0.0) + dur / 1000.0
    for name in step_spans:  # first marker that fired wins
        if step_counts.get(name):
            attr.steps = max(step_counts[name].values())
            break
    return attr


# ---------------------------------------------------------------------------
# program cost (FLOPs of one run of a program)
# ---------------------------------------------------------------------------

Flops = Union[float, Callable[[], float], None]


def _flop_mode():
    """A dispatch mode that runs every operator as it is and adds the
    ``torch.utils.flop_counter`` formula of each one that has one to its
    ``flops``."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class FlopCount(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.flops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            return out

    return FlopCount()


def jit_cost_summary(fn: Callable[..., Any], args: Sequence[Any] = (),
                     kwargs: Optional[Dict[str, Any]] = None,
                     extra_flops: Flops = None
                     ) -> Tuple[Any, Dict[str, float]]:
    """Run ``fn(*args, **kwargs)`` once, counting the FLOPs of its
    operators (:func:`_flop_mode`; the run's bits are those of a run
    without it): ``(its result, {"flops": counted + extra_flops})``.
    ``extra_flops`` (a number, or a callable read after the run) is the
    work of kernels no dispatch mode sees. ``fn``'s own errors propagate;
    the cost is {} when nothing was counted."""
    mode = _flop_mode()
    with mode:
        out = fn(*args, **(kwargs or {}))
    extra = extra_flops() if callable(extra_flops) else (extra_flops or 0.0)
    flops = float(mode.flops) + float(extra)
    return out, ({"flops": flops} if flops > 0 else {})


# one record per (registry, program): keyed on the live registry object so
# a reused id() after GC can never suppress a fresh registry's recording
_RECORDED: "weakref.WeakKeyDictionary[Any, set]" = weakref.WeakKeyDictionary()


def maybe_record_jit_cost(program: str, fn: Callable[..., Any],
                          args: Sequence[Any] = (),
                          kwargs: Optional[Dict[str, Any]] = None,
                          registry: Any = None, extra_flops: Flops = None
                          ) -> Tuple[Any, Optional[Dict[str, float]]]:
    """Run ``fn`` and return ``(its result, the cost recorded or None)``.
    Once per (registry, program) the run is counted (:func:
    `jit_cost_summary`) and recorded as the ``cost/flops`` gauge labelled
    ``program=`` plus a ``program_cost`` event; with no explicit registry
    and no sinks configured ``fn`` simply runs, as JAX's is a no-op
    there."""
    from hetu_galvatron_tpu_torch.observability.registry import get_registry

    reg = registry if registry is not None else get_registry()
    seen = _RECORDED.setdefault(reg, set())
    if (registry is None and not reg.sinks) or program in seen:
        return fn(*args, **(kwargs or {})), None
    seen.add(program)
    out, cost = jit_cost_summary(fn, args, kwargs, extra_flops)
    if not cost:
        return out, None
    for k, v in cost.items():
        reg.gauge(f"cost/{k}", program=program).set(v)
    reg.event("program_cost", {"program": program, **cost})
    return out, cost
