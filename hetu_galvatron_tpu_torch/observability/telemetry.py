"""Derived training telemetry: throughput, MFU, memory, the plan event.

Port of ``hetu_galvatron_tpu/observability/telemetry.py``
(``peak_device_tflops`` :58, ``TrainingTelemetry`` :68,
``emit_plan_telemetry`` :641). The FLOPs count it reads is the cost
model's, ``core/cost_model/cost.py::model_flops_per_token`` (JAX :894),
imported from the port's copy of the cost model.
:class:`TrainingTelemetry` is a train-loop hook (``hook(it, metrics)``)
with JAX's gauge names:

* ``train/step_time_ms`` histogram — host wall-clock between hook calls.
  The launcher calls the hook after its once-a-step read of the loss,
  which waits for the step, so the cadence is the step time.
* ``train/tokens_per_sec`` gauge — windowed tokens/s: the tokens of the
  steps in the window (each at the running batch size it ran at) over
  their span. JAX multiplies every step in the window by the CURRENT
  batch size, which overstates the rate under a batch-size ramp until
  the window has passed the last change; the port counts each step's own.
* ``train/model_tflops`` and ``train/mfu`` gauges — tokens/s x
  :func:`model_flops_per_token` over the card's peak
  (:func:`peak_device_tflops`, by ``torch.cuda.get_device_name()``;
  ``observability.peak_tflops`` overrides it).
* ``train/loss`` / ``train/grad_norm`` gauges — converted one flush LATE
  (the lagged drain). The launcher hands the hook host floats it already
  read; a CUDA tensor (``runtime/trainer.train_loop``'s in-flight
  metrics) is read at the next flush behind a CUDA event, on a side
  stream, so neither the hook nor the flush waits for the step in
  flight.
* ``device/mem_mb`` gauges — ``torch.cuda.memory_allocated`` and
  ``max_memory_allocated`` at flush time (host-side allocator counters,
  no device sync; absent while CUDA is not initialized).

``layer_param_mb`` (JAX :243) is a decoder layer's fp32 parameter
megabytes, which the memory doctor (``analysis/memory_doctor.py``) reads.
``emit_plan_telemetry`` emits the one-shot ``plan`` event of a
single-device plan, which predicts no communication. The predicted
collective counts and bytes of wider plans (``plan_comm_volume``,
``plan_collective_counts/bytes``) wait for the SPMD plans.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

from hetu_galvatron_tpu_torch.core.cost_model.cost import (  # noqa: F401
    model_flops_per_token,
)
from hetu_galvatron_tpu_torch.observability.registry import (
    MetricsRegistry,
    get_registry,
)

MB = 1024 * 1024

# dense bf16 peak TFLOP/s per card, by substrings of
# torch.cuda.get_device_name() (every substring of an entry must match,
# case-insensitively): the H100 SXM reports "NVIDIA H100 80GB HBM3".
# Unknown cards resolve to None: MFU is then emitted only when the caller
# supplies peak_tflops_per_device.
_PEAK_TFLOPS = (
    (("h100", "sxm"), 989.0), (("h100", "hbm3"), 989.0),
    (("h100", "pcie"), 756.0),
)


def peak_device_tflops(device_kind: str) -> Optional[float]:
    """Per-card dense bf16 peak for a ``torch.cuda.get_device_name()``
    string, or None when unknown (CPU, other cards)."""
    kind = (device_kind or "").lower()
    for subs, tf in _PEAK_TFLOPS:
        if all(sub in kind for sub in subs):
            return tf
    return None


class _Lagged:
    """A CUDA scalar on its way to the host: an event recorded behind the
    step that made it. Reading it waits for that event alone, then copies
    on the telemetry's side stream, so the read never waits for work
    queued since (a copy on the step's stream would, and so would
    allocating pinned host memory for a non-blocking copy)."""

    __slots__ = ("value", "event", "stream")

    def __init__(self, t, stream):
        import torch

        self.value = t.detach()
        self.stream = stream
        self.event = torch.cuda.Event()
        self.event.record()

    def __float__(self) -> float:
        import torch

        self.event.synchronize()
        with torch.cuda.stream(self.stream):
            return float(self.value)


class TrainingTelemetry:
    """Train-loop hook producing throughput/MFU/memory metrics.

    Call it as ``hook(it, metrics)`` once per step; call :meth:`close`
    (or use as a context manager) at loop exit so the tail of the run is
    flushed. ``metrics`` entries named in ``scalar_keys`` are buffered and
    converted only at the NEXT flush boundary.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        *,
        model=None,
        global_batch_size: int = 0,
        seq_length: int = 0,
        world_size: int = 1,
        peak_tflops_per_device: float = 0.0,
        flush_interval: int = 16,
        window: int = 32,
        scalar_keys: Sequence[str] = ("loss", "grad_norm"),
    ):
        self.registry = registry if registry is not None else get_registry()
        self.global_batch_size = int(global_batch_size)
        self.seq_length = int(seq_length)
        self.world_size = max(int(world_size), 1)
        self.flush_interval = max(int(flush_interval), 1)
        self.window = max(int(window), 2)
        self.scalar_keys = tuple(scalar_keys)
        self.flops_per_token = 0.0
        if model is not None:
            self.flops_per_token = model_flops_per_token(model)
        self.peak_flops = 0.0
        if peak_tflops_per_device > 0:
            self.peak_flops = peak_tflops_per_device * 1e12 * self.world_size
        else:
            kind = _device_kind()
            tf = peak_device_tflops(kind) if kind else None
            if tf:
                self.peak_flops = tf * 1e12 * self.world_size
        self._last_t: Optional[float] = None
        # (hook time, tokens of the step it ends): the throughput window
        self._window: List[tuple] = []
        self._steps_seen = 0
        self._pending: List[tuple] = []  # (it, {key: value})
        self._closed = False
        # the side stream of the lagged reads, made while the card is idle:
        # creating a stream waits for the work in flight
        self._side = None
        if _cuda_ready():
            import torch

            self._side = torch.cuda.Stream()

    # -- hook ---------------------------------------------------------------

    def __call__(self, it: int, metrics: Dict[str, Any]) -> None:
        now = time.perf_counter()
        self._closed = False  # re-armed: one instance may span many loops
        reg = self.registry
        if self._last_t is not None:
            reg.histogram("train/step_time_ms").observe(
                (now - self._last_t) * 1000.0)
        self._last_t = now
        tokens = self.global_batch_size * self.seq_length
        self._window.append((now, tokens))
        if len(self._window) > self.window:
            self._window = self._window[-self.window:]
        self._steps_seen += 1
        reg.counter("train/steps").inc()
        if tokens:
            reg.counter("train/tokens").inc(tokens)
        pend = {k: self._defer(metrics[k]) for k in self.scalar_keys
                if k in metrics}
        if pend:
            self._pending.append((it, pend))
        if self._steps_seen % self.flush_interval == 0:
            self.flush(step=it)

    def _defer(self, v: Any) -> Any:
        """Host values pass; a CUDA tensor becomes a :class:`_Lagged`
        read."""
        if not getattr(v, "is_cuda", False):
            return v
        if self._side is None:
            import torch

            self._side = torch.cuda.Stream(device=v.device)
        return _Lagged(v, self._side)

    def resume_from(self, step: int, *, samples: Optional[int] = None
                    ) -> None:
        """Carry the telemetry step across a checkpoint resume: the
        cumulative ``train/steps`` / ``train/tokens`` counters restart at
        the checkpointed totals instead of zero. ``samples`` overrides the
        consumed-sample count for runs whose batch size varied (a ramp)."""
        if step <= 0:
            return
        self._steps_seen = int(step)
        self.registry.counter("train/steps").inc(step)
        tokens = (samples * self.seq_length if samples is not None
                  else step * self.global_batch_size * self.seq_length)
        if tokens:
            self.registry.counter("train/tokens").inc(tokens)

    # -- flushing -----------------------------------------------------------

    def _drain_pending(self, final: bool) -> None:
        """Convert buffered scalars to floats. All but the newest entry
        are at least one step old; the newest is held back until the next
        flush (or converted at close)."""
        keep = 0 if final else 1
        while len(self._pending) > keep:
            it, vals = self._pending.pop(0)
            for k, v in vals.items():
                self.registry.gauge(f"train/{k}").set(float(v))

    def tokens_per_sec(self) -> float:
        """Tokens of the window's steps over the window's span. The first
        entry only opens the span: its step ran before it."""
        if len(self._window) < 2:
            return 0.0
        span_s = self._window[-1][0] - self._window[0][0]
        if span_s <= 0:
            return 0.0
        return sum(tok for _, tok in self._window[1:]) / span_s

    def flush(self, step: Optional[int] = None, final: bool = False) -> None:
        reg = self.registry
        self._drain_pending(final)
        tps = self.tokens_per_sec()
        reg.gauge("train/tokens_per_sec").set(tps)
        if self.flops_per_token:
            mflops = tps * self.flops_per_token
            reg.gauge("train/model_tflops").set(mflops / 1e12)
            if self.peak_flops:
                reg.gauge("train/mfu").set(mflops / self.peak_flops)
        self._memory_gauges()
        reg.flush(step)

    def _memory_gauges(self) -> None:
        stats = device_memory_mb()
        if stats:
            self.registry.gauge("device/mem_mb", stat="current").set(
                stats["current"])
            self.registry.gauge("device/mem_mb", stat="peak").set(
                stats["peak"])

    def close(self, step: Optional[int] = None) -> None:
        """Final flush (drains ALL buffered scalars). Idempotent until the
        next ``__call__``, which re-arms the instance."""
        if self._closed:
            return
        self._closed = True
        self.flush(step, final=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _cuda_ready() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_initialized()


def device_memory_mb() -> Optional[Dict[str, float]]:
    """The caching allocator's current and peak bytes on the current card
    in MB, or None while CUDA is not initialized (CPU runs)."""
    import torch

    if not _cuda_ready():
        return None
    return {"current": torch.cuda.memory_allocated() / MB,
            "peak": torch.cuda.max_memory_allocated() / MB}


def _device_kind() -> str:
    import torch

    try:
        if torch.cuda.is_available():
            return torch.cuda.get_device_name()
    except Exception:  # noqa: BLE001 — no usable CUDA runtime
        pass
    return ""


def layer_param_mb(model) -> float:
    """Per-decoder-layer parameter megabytes at fp32 (the unit
    ``CostContext.parameter_size`` uses)."""
    h = model.hidden_size
    nd = model.num_attention_heads * model.head_dim
    kd = model.kv_heads * model.head_dim
    attn = h * nd + 2 * h * kd + nd * h
    gated = model.hidden_act in ("swiglu", "geglu")
    ffn = (3 if gated else 2) * h * model.ffn_dim
    norms = 2 * h
    return (attn + ffn + norms) * 4 / MB


def emit_plan_telemetry(registry: MetricsRegistry, hpc, model,
                        mixed_precision: bool = True) -> None:
    """The one-shot ``plan`` event of a plan the port runs, as the JAX
    function emits it (``plan_comm_volume`` :256): at one rank a stage no
    layer moves dp, tp or cp bytes, and under pp each layer's entry holds
    JAX's pipeline term, the activation and its cotangent of every
    microbatch (``pp_p2p_mb``). Plans with stages wider than one rank are
    not ported."""
    if hpc.world_size != hpc.pp_deg or any(
            max(s.tp_size, s.cp_size, s.dp_size) > 1 or s.sp
            for s in hpc.layers):
        raise NotImplementedError(
            "the plan's predicted collective volume (plan_comm_volume) of a "
            "plan whose stages are wider than one rank is not ported yet")
    chunks = max(hpc.chunks, 1)
    pp_mb = 0.0
    if hpc.pp_deg > 1:
        elem = 2 if mixed_precision else 4
        lbsz = max(hpc.global_bsz // chunks, 1)
        pp_mb = (2 * lbsz * model.seq_length * model.hidden_size * elem / MB
                 * chunks)
    per_layer = {"pp_p2p_mb": pp_mb, "total_mb": pp_mb} if pp_mb else {}
    registry.event("plan", {
        "global_bsz": hpc.global_bsz, "chunks": hpc.chunks,
        "pp_deg": hpc.pp_deg,
        "predicted_comm_mb_per_step": pp_mb * len(hpc.layers),
        "layers": [{"layer": i, **per_layer}
                   for i in range(len(hpc.layers))],
    })
