"""Fault-detection rerun state machine.

Port of ``hetu_galvatron_tpu/runtime/rerun_machine.py``: the exit codes 16
and 17, ``RerunDataIterator`` :55 (with ``batches_consumed``),
``InjectedCrash`` :95, ``FaultDrill`` :101, ``RerunErrorInjector`` :156,
``DeterminismStats`` :184 and ``RerunStateMachine`` :220 with its
``state_dict`` / ``load_state_dict``; the same diagnostics, records, exit
codes and ``state_dict()`` JSON for the same sequence of values.

It validates each step's result (NaN / loss spike), re-runs the same
microbatch in place to classify a suspect result as a transient fault
(the re-run differs) or a persistent one (it matches), replays batches
through a caching iterator, injects synthetic errors for drills, and
signals checkpoint-and-exit with the dedicated exit codes.

On the card the re-run is a fair test: the port's kernels use no atomics
and its losses reproduce bit for bit across runs, so "the re-run matches
exactly" is a deterministic fault and any difference is a transient one.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from enum import Enum
from typing import Any, Callable, Dict, Iterator, List, Optional

from hetu_galvatron_tpu_torch.core.args_schema import RerunArgs
from hetu_galvatron_tpu_torch.observability.registry import get_registry

# reference exit codes (rerun_state_machine.py:33-37)
EXIT_CODE_RESUME_TO_DISAMBIGUATE = 16
EXIT_CODE_FAILED_ON_RESULT_VALIDATION = 17


class RerunDiagnostic(str, Enum):
    CORRECT = "correct"
    TRANSIENT_ERROR = "transient_error"  # re-run produced a different result
    PERSISTENT_ERROR = "persistent_error"  # re-run reproduced the bad result


class RerunState(str, Enum):
    NOT_RUNNING_YET = "not_running_yet"
    RUNNING = "running"
    RERUNNING_IN_PLACE = "rerunning_in_place"


@dataclass
class RerunRecord:
    iteration: int
    value: float
    rerun_value: Optional[float]
    diagnostic: RerunDiagnostic
    reason: str


class RerunDataIterator:
    """Replayable wrapper: keeps the current step's batches so a rerun
    replays identical data (reference RerunDataIterator,
    rerun_state_machine.py:989)."""

    def __init__(self, it: Iterator):
        self._it = it
        self._cache: List[Any] = []
        self._replaying = False
        self._replay_idx = 0
        # committed (advance()d) batches — the data-iterator position the
        # checkpoint carries for full-state resume
        self.batches_consumed = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._replaying:
            if self._replay_idx >= len(self._cache):
                raise StopIteration
            item = self._cache[self._replay_idx]
            self._replay_idx += 1
            return item
        item = next(self._it)
        self._cache.append(item)
        return item

    def rewind(self) -> None:
        self._replaying = True
        self._replay_idx = 0

    def advance(self) -> None:
        """Commit the step: drop cached batches, resume the live stream."""
        self.batches_consumed += len(self._cache)
        self._cache.clear()
        self._replaying = False
        self._replay_idx = 0


class InjectedCrash(RuntimeError):
    """Raised by a crash drill (FaultDrill kind="crash"): simulates a
    hard host failure so the supervisor's restart path can be exercised
    end to end."""


class FaultDrill:
    """Deterministic at-step-k fault injection (the configurable half of
    the drill harness; the rate-based :class:`RerunErrorInjector` covers
    stochastic soak tests).

    Driven from ``RerunArgs`` (``inject_kind`` / ``inject_at_iter``):
    ``nan`` and ``spike`` corrupt the step's loss so the rerun machine's
    detection path fires; ``crash`` raises :class:`InjectedCrash`;
    ``preempt`` delivers a real SIGTERM to the process (the supervisor's
    PreemptionGuard must catch it). Each drill fires once, on fresh runs
    only — a resumed run trains clean, which is exactly the
    transient-fault scenario the restart supervisor exists to absorb.
    Every injection is counted (``faults/injected{kind=...}``)."""

    def __init__(self, args: RerunArgs, registry=None):
        self.kind = args.inject_kind
        self.at_iter = args.inject_at_iter
        self.spike_scale = args.inject_spike_scale
        self._registry = registry
        self._armed = self.kind != "none" and self.at_iter >= 0

    def arm(self, start_iter: int) -> None:
        """Disarm on resumed runs (``start_iter > 0``): the drill models a
        one-shot transient fault, not one that reproduces every restart."""
        if start_iter > 0:
            self._armed = False

    @property
    def registry(self):
        return self._registry if self._registry is not None else get_registry()

    def apply(self, value: float, iteration: int) -> float:
        """Corrupt (or crash/preempt on) iteration ``at_iter``; identity
        everywhere else."""
        if not self._armed or iteration != self.at_iter:
            return value
        self._armed = False
        self.registry.counter("faults/injected", kind=self.kind).inc()
        if self.kind == "nan":
            return float("nan")
        if self.kind == "spike":
            return abs(value) * self.spike_scale + 1.0
        if self.kind == "crash":
            raise InjectedCrash(
                f"fault drill: injected crash at iteration {iteration}")
        if self.kind == "preempt":
            import signal

            # a REAL SIGTERM, not a flag poke: the drill exercises the
            # whole preemption path (handler -> boundary stop ->
            # checkpoint -> exit code)
            signal.raise_signal(signal.SIGTERM)
        return value


class RerunErrorInjector:
    """Synthetic fault injection for drills (reference RerunErrorInjector,
    rerun_state_machine.py:1143)."""

    def __init__(self, rate: float = 0.0,
                 kind: str = "transient_error", seed: int = 0):
        self.rate = rate
        self.kind = kind
        self._rng = random.Random(seed)
        self._injected_iters: Dict[int, int] = {}

    def maybe_corrupt(self, value: float, iteration: int,
                      attempt: int) -> float:
        if self.rate <= 0:
            return value
        if attempt == 0:
            if self._rng.random() < self.rate:
                self._injected_iters[iteration] = 1
                return float("nan")
            return value
        # rerun attempt: persistent faults reproduce, transient ones vanish
        if iteration in self._injected_iters and \
                self.kind == "persistent_error":
            return float("nan")
        return value


@dataclass
class DeterminismStats:
    """Relative-difference stats between a step and its in-place re-run
    (reference QuickStats, rerun_state_machine.py:235/520-539)."""

    checked: int = 0
    mismatches: int = 0
    nonfinite: int = 0  # one-sided NaN/inf re-runs (counted, not averaged)
    max_rel_diff: float = 0.0
    sum_rel_diff: float = 0.0

    def record(self, a: float, b: float) -> None:
        self.checked += 1
        denom = max(abs(b), 1e-12)
        rel = abs(a - b) / denom
        if not math.isfinite(rel):
            # one side non-finite: a mismatch by definition, but keep the
            # running mean finite
            self.mismatches += 1
            self.nonfinite += 1
            return
        if rel > 0:
            self.mismatches += 1
        self.max_rel_diff = max(self.max_rel_diff, rel)
        self.sum_rel_diff += rel

    def summary(self) -> Dict[str, Any]:
        finite = self.checked - self.nonfinite
        return {
            "checked": self.checked,
            "mismatches": self.mismatches,
            "nonfinite": self.nonfinite,
            "max_rel_diff": self.max_rel_diff,
            "mean_rel_diff": (self.sum_rel_diff / finite if finite else 0.0),
        }


class RerunStateMachine:
    """Wraps the host train loop's step result (reference
    should_run_forward_backward :251 / validate_result :434)."""

    def __init__(self, args: RerunArgs, registry=None):
        self.args = args
        self.state = RerunState.NOT_RUNNING_YET
        self.records: List[RerunRecord] = []
        self.injector = RerunErrorInjector(
            args.error_injection_rate, args.error_injection_type)
        self._ema: Optional[float] = None
        self._last_exit_code: Optional[int] = None
        self.determinism_stats = DeterminismStats()
        # state transitions double as observability counters (rerun/*), so
        # a fleet dashboard sees fault attribution without parsing logs.
        # None late-binds the process default at increment time (the train
        # launcher may configure sinks after constructing this machine)
        self._registry = registry

    @property
    def registry(self):
        return self._registry if self._registry is not None else get_registry()

    def _count(self, name: str, **labels) -> None:
        self.registry.counter(f"rerun/{name}", **labels).inc()

    @property
    def enabled(self) -> bool:
        return self.args.enable and self.args.mode != "disabled"

    # -- validation ---------------------------------------------------------

    def _suspicious(self, value: float) -> Optional[str]:
        if self.args.check_for_nan and (math.isnan(value)
                                        or math.isinf(value)):
            return "non-finite loss"
        if self.args.check_for_spike and self._ema is not None and \
                value > self.args.spike_factor * self._ema:
            return (f"loss spike: {value:.4f} > {self.args.spike_factor} x "
                    f"EMA {self._ema:.4f}")
        return None

    def _update_ema(self, value: float) -> None:
        if math.isfinite(value):
            self._ema = (value if self._ema is None
                         else 0.9 * self._ema + 0.1 * value)

    def validate_result(
        self,
        value: float,
        iteration: int,
        rerun_fn: Optional[Callable[[], float]] = None,
        data_iterator: Optional[RerunDataIterator] = None,
    ) -> RerunDiagnostic:
        """Check one step's loss; on suspicion re-run the identical step to
        attribute the fault. Returns the diagnostic; exit-code requests are
        exposed via :meth:`exit_code_requested`."""
        if not self.enabled:
            self._update_ema(value)
            return RerunDiagnostic.CORRECT
        value = self.injector.maybe_corrupt(value, iteration, attempt=0)
        self.state = RerunState.RUNNING
        self._count("validated")

        if self.args.mode == "report_stats":
            # determinism-stats mode (reference REPORT_DETERMINISM_STATS,
            # rerun_state_machine.py:77/327/520-539): EVERY step re-runs once
            # and the relative difference is recorded; execution always
            # continues and no exit codes are raised. The port's kernels
            # are deterministic, so any nonzero entry is a finding.
            if rerun_fn is not None:
                self.state = RerunState.RERUNNING_IN_PLACE
                self._count("rerun_in_place")
                if data_iterator is not None:
                    data_iterator.rewind()
                # injector applies to the re-run too (attempt=1), matching
                # the validate_results path — a persistent-fault drill must
                # reproduce on the re-run, not read as nondeterminism
                rerun_value = self.injector.maybe_corrupt(
                    float(rerun_fn()), iteration, attempt=1)
                # NaN == NaN for determinism purposes (same guard as the
                # validate_results path): a deterministic NaN step is not a
                # mismatch and must not poison the stats with nan rel-diffs
                same = (rerun_value == value) or (
                    math.isnan(rerun_value) and math.isnan(value))
                if not (math.isnan(rerun_value) and math.isnan(value)):
                    self.determinism_stats.record(rerun_value, value)
                if not same:
                    self._count("determinism_mismatch")
                    self.records.append(RerunRecord(
                        iteration=iteration, value=value,
                        rerun_value=rerun_value,
                        diagnostic=RerunDiagnostic.TRANSIENT_ERROR,
                        reason="nondeterministic re-run"))
                self.state = RerunState.RUNNING
            self._update_ema(value)
            return RerunDiagnostic.CORRECT

        reason = self._suspicious(value)
        if reason is None:
            self._update_ema(value)
            return RerunDiagnostic.CORRECT

        self._count("suspect")
        self.registry.counter(
            "faults/detected",
            kind="nan" if "non-finite" in reason else "spike").inc()
        diagnostic = RerunDiagnostic.PERSISTENT_ERROR
        rerun_value: Optional[float] = None
        if rerun_fn is not None:
            self.state = RerunState.RERUNNING_IN_PLACE
            self._count("rerun_in_place")
            if data_iterator is not None:
                data_iterator.rewind()
            rerun_value = self.injector.maybe_corrupt(
                float(rerun_fn()), iteration, attempt=1)
            same = (rerun_value == value) or (
                math.isnan(rerun_value) and math.isnan(value))
            diagnostic = (RerunDiagnostic.PERSISTENT_ERROR if same
                          else RerunDiagnostic.TRANSIENT_ERROR)
        self.records.append(RerunRecord(
            iteration=iteration, value=value, rerun_value=rerun_value,
            diagnostic=diagnostic, reason=reason))
        self._count(diagnostic.value)  # transient_error / persistent_error
        self.state = RerunState.RUNNING
        if self.args.mode == "validate_results":
            self._last_exit_code = (
                EXIT_CODE_FAILED_ON_RESULT_VALIDATION
                if diagnostic == RerunDiagnostic.PERSISTENT_ERROR
                else EXIT_CODE_RESUME_TO_DISAMBIGUATE)
            self._count("exit_requested", code=self._last_exit_code)
        return diagnostic

    def exit_code_requested(self) -> Optional[int]:
        """Non-None when the run should checkpoint and exit with the given
        code (reference exit codes 16/17)."""
        return self._last_exit_code

    # -- full-state resume --------------------------------------------------

    @staticmethod
    def _enc(v: Optional[float]) -> Any:
        """Strict-JSON-safe float: NaN/inf become strings (json.dump's
        default emits bare ``NaN`` tokens no spec-compliant parser — jq,
        other languages — accepts, and fault records contain NaN by
        construction)."""
        if v is not None and not math.isfinite(v):
            return str(v)  # "nan" / "inf" / "-inf"
        return v

    @staticmethod
    def _dec(v: Any) -> Optional[float]:
        return float(v) if isinstance(v, str) else v

    def state_dict(self) -> Dict[str, Any]:
        """Strict-JSON-serializable snapshot carried in the checkpoint's
        train_state: a resumed run keeps the fault history (and the spike
        EMA, so detection thresholds do not reset to cold)."""
        return {
            "records": [
                {"iteration": r.iteration, "value": self._enc(r.value),
                 "rerun_value": self._enc(r.rerun_value),
                 "diagnostic": r.diagnostic.value, "reason": r.reason}
                for r in self.records
            ],
            "ema": self._enc(self._ema),
            "injected_iters": dict(self.injector._injected_iters),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.records = [
            RerunRecord(
                iteration=r["iteration"], value=self._dec(r["value"]),
                rerun_value=self._dec(r.get("rerun_value")),
                diagnostic=RerunDiagnostic(r["diagnostic"]),
                reason=r.get("reason", ""))
            for r in state.get("records", [])
        ]
        self._ema = self._dec(state.get("ema"))
        self.injector._injected_iters = {
            int(k): v for k, v in state.get("injected_iters", {}).items()}

    def report(self) -> Dict[str, Any]:
        out = {
            "checked_iterations": len(self.records),
            "transient": sum(r.diagnostic == RerunDiagnostic.TRANSIENT_ERROR
                             for r in self.records),
            "persistent": sum(r.diagnostic == RerunDiagnostic.PERSISTENT_ERROR
                              for r in self.records),
            "records": [r.__dict__ for r in self.records],
        }
        if self.args.mode == "report_stats":
            out["determinism"] = self.determinism_stats.summary()
        return out
