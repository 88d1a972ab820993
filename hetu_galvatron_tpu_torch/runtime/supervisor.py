"""Preemption-aware training supervisor.

Port of ``hetu_galvatron_tpu/runtime/supervisor.py``: the exit codes 18
and 130, ``RESTARTABLE_EXIT_CODES``, ``PreemptionGuard`` :83,
``run_with_restarts`` :184, ``SupervisorState`` :304 and
``ProcessSupervisor`` :337 (signal forwarding with the ``term_grace_s``
escalation, the atomic state file, the restart budget that progress
resets, the ``RESUME_PIN`` written before each relaunch, ``health()``,
and the flight-recorder dumps: ``signal:<name>`` at the guard's
step-boundary check, ``child_exit_<code>`` per child death).

* :class:`PreemptionGuard` — a SIGTERM/SIGINT handler that converts the
  kill signal into a *checkpoint-and-exit request* the train loop reads
  at the next step boundary (a preempting scheduler sends SIGTERM and
  waits a grace window before SIGKILL; an uncheckpointed step is a lost
  step). The guard never acts mid-step: the loop finishes the in-flight
  update, commits an atomic checkpoint, and exits with
  :data:`EXIT_CODE_CHECKPOINT_AND_EXIT`.
* :func:`run_with_restarts` — bounded auto-restart with jittered
  exponential backoff around a training attempt, honoring the rerun
  state machine's exit-code contract (``rerun_machine.py``): code 16
  (resume-to-disambiguate) and preemption exits restart; code 17
  (failed result validation — a persistent fault that will reproduce)
  does not. Crashes (exceptions) restart too when ``restart_on_error``
  is set. This is the IN-PROCESS loop (``supervisor.mode=inprocess``):
  right for drills, but a SIGKILL takes the supervisor down with the
  attempt.
* :class:`ProcessSupervisor` — the CROSS-PROCESS loop
  (``supervisor.mode=process``, ``cli/supervise.py``): relaunches
  ``train_dist`` as a child process per attempt, interprets the same
  exit-code contract plus signal deaths (negative waitpid codes),
  forwards SIGTERM with a kill-after-grace escalation, persists its
  state in a tmp+rename-atomic JSON file, and writes the ``RESUME_PIN``
  lease before each relaunch so retention GC in the child can never
  prune the step dir the relaunch is restoring from. It imports no
  torch (``runtime/ckpt_paths.py``): the card belongs to the child.

Every signal, restart, and give-up is counted in the observability
registry (``supervisor/*``).
"""

from __future__ import annotations

import os
import random
import signal
import subprocess
import threading
import time
from dataclasses import asdict, dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional

from hetu_galvatron_tpu_torch.runtime import ckpt_paths
from hetu_galvatron_tpu_torch.runtime.rerun_machine import (
    EXIT_CODE_FAILED_ON_RESULT_VALIDATION,
    EXIT_CODE_RESUME_TO_DISAMBIGUATE,
)
from hetu_galvatron_tpu_torch.utils.retrying import (
    _default_sleep,
    backoff_delay,
)

# checkpoint-and-exit after a preemption signal: resumable by contract,
# distinct from the rerun machine's 16/17 so the supervisor can tell
# "the fleet preempted me" from "my step result was suspect"
EXIT_CODE_CHECKPOINT_AND_EXIT = 18
# operator interrupt (SIGINT/Ctrl-C): checkpoints like a preemption but
# is NOT restartable — auto_restart must not resurrect a run the user
# deliberately stopped (128+SIGINT shell convention)
EXIT_CODE_INTERRUPTED = 130

# exit codes run_with_restarts treats as "resume from the last committed
# checkpoint"; 17 is deliberately absent — a persistent validation fault
# reproduces on every restart, so restarting only burns the budget
RESTARTABLE_EXIT_CODES = (
    EXIT_CODE_RESUME_TO_DISAMBIGUATE,
    EXIT_CODE_CHECKPOINT_AND_EXIT,
)


def _registry(registry=None):
    if registry is not None:
        return registry
    from hetu_galvatron_tpu_torch.observability.registry import get_registry

    return get_registry()


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a step-boundary stop request.

    Use as a context manager around the train loop; ``requested()`` turns
    true once a signal arrives (a second signal of the same kind is
    idempotent). Handlers are installed only on the main thread — on a
    worker thread (some test harnesses) the guard degrades to an inert
    flag that :meth:`request` can still set programmatically (simulated
    preemption drills)."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM,
                                                 signal.SIGINT),
                 *, enabled: bool = True, registry=None, recorder=None):
        self.signals = tuple(signals)
        self.enabled = enabled
        self._requested = threading.Event()
        self._previous = {}
        self._registry = registry
        # optional observability.recorder.FlightRecorder: the first
        # trapped signal dumps a postmortem (from the main thread, at the
        # boundary check — never inside the async handler); dump() never
        # raises, so the checkpoint-and-exit path is unaffected
        self.recorder = recorder
        self.installed = False
        self.signum: Optional[int] = None  # first signal that fired
        self._counted = False

    # -- signal plumbing ----------------------------------------------------

    def _handler(self, signum, frame):  # noqa: ARG002 — signal signature
        if self._requested.is_set():
            # second signal of the same escalation: the run is presumably
            # hung (stuck step, dead object-store mount) and will never
            # reach the boundary check — restore the previous handler and
            # re-deliver so the operator can still interrupt without
            # SIGKILL
            signal.signal(signum, self._previous.get(signum, signal.SIG_DFL))
            signal.raise_signal(signum)
            return
        self.request(signum=signum)

    def request(self, signum: Optional[int] = None) -> None:
        """Mark preemption as requested (signal handler or drill).
        Async-signal-safe: only sets a flag — no locks, no allocation
        (a registry counter here could deadlock on the non-reentrant
        registry lock the interrupted main thread may hold); the signal
        is counted later, from the main thread, in :meth:`requested`."""
        self._requested.set()
        if self.signum is None:
            self.signum = signum if signum is not None else -1

    def requested(self) -> bool:
        """Polled by the train loop at step boundaries (main thread) —
        also the safe place to count the signal for observability."""
        if self._requested.is_set() and not self._counted:
            self._counted = True
            try:
                name = (signal.Signals(self.signum).name
                        if self.signum not in (None, -1) else "drill")
            except ValueError:
                name = str(self.signum)
            _registry(self._registry).counter(
                "supervisor/preemption_signals", sig=name).inc()
            if self.recorder is not None:
                self.recorder.dump(f"signal:{name}")
        return self._requested.is_set()

    def exit_code(self) -> int:
        """Which checkpoint-and-exit code the triggering signal maps to:
        SIGINT = an operator's deliberate stop (non-restartable 130),
        everything else = fleet preemption (restartable 18)."""
        if self.signum == signal.SIGINT:
            return EXIT_CODE_INTERRUPTED
        return EXIT_CODE_CHECKPOINT_AND_EXIT

    def __enter__(self) -> "PreemptionGuard":
        self._requested.clear()
        self.signum = None
        self._counted = False
        if not self.enabled:
            return self
        for s in self.signals:
            try:
                self._previous[s] = signal.signal(s, self._handler)
                self.installed = True
            except ValueError:
                # not the main thread: signals cannot be trapped here;
                # stay an inert flag rather than failing the run
                self._previous.pop(s, None)
        return self

    def __exit__(self, *exc) -> None:
        for s, prev in self._previous.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._previous.clear()
        self.installed = False


def run_with_restarts(
    attempt_fn: Callable[[], Optional[int]],
    *,
    max_restarts: int = 3,
    base_delay: float = 1.0,
    max_delay: float = 60.0,
    restart_codes: Iterable[int] = RESTARTABLE_EXIT_CODES,
    restart_on_error: bool = True,
    progress_fn: Optional[Callable[[], Any]] = None,
    world_fn: Optional[Callable[[], Any]] = None,
    sleep: Optional[Callable[[float], None]] = None,
    rng: Optional[random.Random] = None,
    registry=None,
    log: Callable[[str], None] = lambda m: print(m, flush=True),
) -> int:
    """Run ``attempt_fn`` (returns an exit code; None/0 = success) with
    bounded auto-restart.

    Restartable exits (preemption, resume-to-disambiguate) and — when
    ``restart_on_error`` — crashes re-invoke ``attempt_fn`` after a
    jittered exponential backoff; the attempt is expected to resume from
    the last committed checkpoint. Non-restartable codes (0, 17, anything
    not listed) return immediately. When the restart budget is exhausted
    the last code is returned (or the last exception re-raised), so the
    process-level exit status still carries the fault classification.

    ``progress_fn`` (e.g. ``lambda: latest_checkpoint(save_dir)``) makes
    the budget bound crash LOOPS, not total faults: whenever its value
    changes between attempts (the attempt checkpointed new progress) the
    restart counter resets, so a healthy multi-day run on a preemptible
    fleet survives arbitrarily many preemptions while a run that loops
    without advancing still stops after ``max_restarts``.

    ``world_fn`` (e.g. ``lambda: torch.cuda.device_count()``) makes a TOPOLOGY
    change progress too: when the visible world differs between attempts
    (half the fleet preempted away, or capacity returned) the next attempt
    re-searches and reshards rather than repeating the fault, so the
    restart counter resets exactly as a committed checkpoint would reset
    it — the budget bounds same-world crash loops, never elasticity.
    World changes are counted (``supervisor/world_changes``) so dashboards
    see fleet churn distinctly from crash churn."""
    if sleep is None:
        sleep = _default_sleep
    restart_codes = tuple(restart_codes)
    reg = _registry(registry)
    restarts = 0
    last_progress = progress_fn() if progress_fn is not None else None
    last_world = world_fn() if world_fn is not None else None

    def note_progress() -> None:
        nonlocal restarts, last_progress, last_world
        advanced = False
        if world_fn is not None:
            world = world_fn()
            if world != last_world:
                reg.counter("supervisor/world_changes").inc()
                log(f"supervisor: world changed {last_world} -> {world}; "
                    "topology change is progress (restart budget reset)")
                last_world = world
                advanced = True
        if progress_fn is not None:
            cur = progress_fn()
            if cur != last_progress:
                advanced = True
                last_progress = cur
        if advanced:
            restarts = 0  # forward progress: this is not a crash loop

    while True:
        try:
            code = attempt_fn()
        except Exception as e:  # noqa: BLE001 — supervisor catches crashes
            note_progress()
            if not restart_on_error or restarts >= max_restarts:
                reg.counter("supervisor/giveups", reason="crash").inc()
                raise
            delay = backoff_delay(restarts, base=base_delay, cap=max_delay,
                                  rng=rng)
            reg.counter("supervisor/restarts", reason="crash").inc()
            # goodput accounting: backoff wall-clock is lost time (the
            # checkpoint-persisted goodput tracker books the full
            # commit-to-resume gap; this counter is the supervisor's own
            # receipt of the deliberately-slept share)
            reg.counter("supervisor/backoff_wait_s").inc(delay)
            log(f"supervisor: attempt crashed ({type(e).__name__}: {e}); "
                f"restart {restarts + 1}/{max_restarts} in {delay:.1f}s")
            restarts += 1
            sleep(delay)
            continue
        code = code or 0
        if code == 0:
            return 0
        if code not in restart_codes:
            if code == EXIT_CODE_FAILED_ON_RESULT_VALIDATION:
                log("supervisor: exit 17 (persistent validation fault) is "
                    "not restartable; surfacing it")
            reg.counter("supervisor/terminal_exits", code=code).inc()
            return code
        note_progress()
        if restarts >= max_restarts:
            reg.counter("supervisor/giveups", reason="budget").inc()
            log(f"supervisor: restart budget ({max_restarts}) exhausted; "
                f"surfacing exit code {code}")
            return code
        delay = backoff_delay(restarts, base=base_delay, cap=max_delay,
                              rng=rng)
        reg.counter("supervisor/restarts", code=code).inc()
        reg.counter("supervisor/backoff_wait_s").inc(delay)
        log(f"supervisor: exit code {code}; restart "
            f"{restarts + 1}/{max_restarts} in {delay:.1f}s")
        restarts += 1
        sleep(delay)


# ---------------------------------------------------------------------------
# Cross-process supervision
# ---------------------------------------------------------------------------


@dataclass
class SupervisorState:
    """Everything the restart loop must remember ACROSS its own deaths:
    persisted tmp+rename-atomically after every transition, reloaded at
    startup, so a supervisor that is itself preempted resumes with the
    budgets and receipts it had — not a fresh allowance."""

    attempt: int = 0                 # lifetime child launches
    restarts: int = 0                # consecutive no-progress restarts
    world_changes: int = 0           # budget spent on topology resets
    last_exit_code: Optional[int] = None
    last_commit_step: Optional[int] = None
    last_commit_wall: Optional[float] = None
    last_world: Optional[int] = None
    backoff_s: float = 0.0           # the delay currently being slept

    @classmethod
    def load(cls, path: Optional[str]) -> "SupervisorState":
        if not path:
            return cls()
        payload, _ = ckpt_paths.try_read_json(path)
        if not payload:
            return cls()
        st = cls()
        for k, v in payload.items():
            if hasattr(st, k):
                setattr(st, k, v)
        return st

    def save(self, path: Optional[str]) -> None:
        if path:
            ckpt_paths.atomic_write_json(path, asdict(self))


class ProcessSupervisor:
    """Relaunching outer wrapper around a ``train_dist`` child process.

    Exit-code contract (see ``cli/supervise.py`` for the operator view):

    * ``0`` — training complete; stop.
    * ``16`` (resume-to-disambiguate) / ``18`` (preempted) — restart
      from the last committed checkpoint, within the budget.
    * ``17`` (persistent validation fault / elastic OOM) and ``130``
      (operator SIGINT) — terminal: never restarted.
    * negative codes (child killed by a signal: SIGKILL'd mid-save,
      OOM-killed) and ``1`` (unhandled exception) — crashes; restart
      when ``restart_on_error``. Other positive codes (usage errors,
      ``2`` from argparse) are terminal — restarting a misconfiguration
      only burns the budget.

    Progress accounting mirrors :func:`run_with_restarts` but reads
    CROSS-PROCESS receipts: a new COMMITTED step dir under ``save_dir``
    resets the restart budget (commit receipts survive the child), and
    a changed world (recorded by the newest commit's plan fingerprint,
    or an injected ``world_fn``) is progress too — bounded by
    ``max_world_changes`` so a flapping fleet cannot reset forever.

    Before every relaunch the supervisor stamps the ``RESUME_PIN`` lease
    on the newest committed step dir, so the child's retention GC (a
    separate process!) cannot prune the dir its resume is reading —
    the cross-process half of the GC-vs-resume race fix.

    SIGTERM/SIGINT to the supervisor forward to the child (SIGTERM
    first), escalate to SIGKILL after ``term_grace_s``, and make the
    loop terminal: a preempted supervisor must hand back quickly, not
    start another attempt. Signal death of the child under OUR
    escalation surfaces as the preemption code 18.
    """

    def __init__(
        self,
        argv_fn: Callable[[SupervisorState], List[str]],
        *,
        save_dir: Optional[str] = None,
        state_file: Optional[str] = None,
        max_restarts: int = 3,
        max_world_changes: int = 8,
        base_delay: float = 1.0,
        max_delay: float = 60.0,
        restart_codes: Iterable[int] = RESTARTABLE_EXIT_CODES,
        restart_on_error: bool = True,
        term_grace_s: float = 15.0,
        poll_interval: float = 0.5,
        world_fn: Optional[Callable[[], Any]] = None,
        sleep: Optional[Callable[[float], None]] = None,
        rng: Optional[random.Random] = None,
        registry=None,
        recorder=None,
        popen: Callable[..., Any] = subprocess.Popen,
        log: Callable[[str], None] = lambda m: print(m, flush=True),
    ):
        self.argv_fn = argv_fn
        self.save_dir = save_dir
        self.state_file = state_file or (
            os.path.join(save_dir, "SUPERVISOR_STATE.json")
            if save_dir else None)
        self.max_restarts = max_restarts
        self.max_world_changes = max_world_changes
        self.base_delay = base_delay
        self.max_delay = max_delay
        self.restart_codes = tuple(restart_codes)
        self.restart_on_error = restart_on_error
        self.term_grace_s = term_grace_s
        self.poll_interval = poll_interval
        self.world_fn = world_fn
        self.rng = rng
        self._popen = popen
        self._log = log
        self._reg = _registry(registry)
        # optional FlightRecorder: one postmortem per abnormal child exit
        self.recorder = recorder
        self._sleep = sleep if sleep is not None else _default_sleep
        self.state = SupervisorState.load(self.state_file)
        self._child = None
        self._stop_signum: Optional[int] = None
        self._commit_at_spawn: Optional[int] = None
        self._kill_timer: Optional[threading.Timer] = None
        self.escalated = False
        self._previous_handlers: Dict[int, Any] = {}
        self._t_start = time.monotonic()

    # -- receipts -----------------------------------------------------------

    def _refresh_commit(self) -> bool:
        """Read the newest commit receipt from disk; True if it advanced
        past the persisted one (cross-process progress)."""
        if not self.save_dir:
            return False
        latest = ckpt_paths.latest_committed_step(self.save_dir)
        if latest is None:
            return False
        step, ckdir = latest
        advanced = (self.state.last_commit_step is None
                    or step > self.state.last_commit_step)
        if advanced:
            self.state.last_commit_step = step
            self.state.last_commit_wall = (
                ckpt_paths.commit_wall_time(ckdir) or time.time())
            self._reg.gauge("supervisor/last_commit_step").set(step)
        return advanced

    def _world(self) -> Optional[int]:
        if self.world_fn is not None:
            try:
                return self.world_fn()
            except Exception:  # noqa: BLE001 — a probe must not kill us
                return None
        if self.save_dir:
            return ckpt_paths.stored_world_of(self.save_dir)
        return None

    def _note_progress(self) -> bool:
        st = self.state
        self._refresh_commit()
        # compare against the receipt AT SPAWN, not the previous refresh:
        # _wait() polls receipts live for /healthz, which would absorb the
        # advancement before this comparison ever saw it
        progressed = (st.last_commit_step is not None
                      and (self._commit_at_spawn is None
                           or st.last_commit_step > self._commit_at_spawn))
        world = self._world()
        if (world is not None and st.last_world is not None
                and world != st.last_world):
            if st.world_changes < self.max_world_changes:
                st.world_changes += 1
                self._reg.counter("supervisor/world_changes").inc()
                self._log(f"supervisor: world changed {st.last_world} -> "
                          f"{world}; topology change is progress "
                          f"({st.world_changes}/{self.max_world_changes} "
                          "of the world-change budget)")
                progressed = True
            else:
                self._reg.counter(
                    "supervisor/world_change_budget_exhausted").inc()
                self._log("supervisor: world changed again but the "
                          f"world-change budget ({self.max_world_changes})"
                          " is spent; NOT resetting the restart budget")
        if world is not None:
            st.last_world = world
        if progressed:
            st.restarts = 0
        return progressed

    # -- signal forwarding --------------------------------------------------

    def _on_signal(self, signum, frame):  # noqa: ARG002 — signal signature
        if self._stop_signum is not None:
            # second signal: operator escalation — kill the child now
            child = self._child
            if child is not None and child.poll() is None:
                try:
                    child.kill()
                except OSError:
                    pass
            return
        self._stop_signum = signum
        child = self._child
        if child is not None and child.poll() is None:
            fwd = signal.SIGINT if signum == signal.SIGINT else \
                signal.SIGTERM
            try:
                child.send_signal(fwd)
            except OSError:
                pass
            t = threading.Timer(self.term_grace_s, self._escalate,
                                args=(child,))
            t.daemon = True
            t.start()
            self._kill_timer = t

    def _escalate(self, child) -> None:
        if child.poll() is None:
            self.escalated = True
            self._reg.counter("supervisor/grace_kills").inc()
            try:
                child.kill()
            except OSError:
                pass

    def _install_signals(self) -> None:
        for s in (signal.SIGTERM, signal.SIGINT):
            try:
                self._previous_handlers[s] = signal.signal(
                    s, self._on_signal)
            except ValueError:
                # not the main thread (tests drive _on_signal directly)
                self._previous_handlers.pop(s, None)

    def _restore_signals(self) -> None:
        for s, prev in self._previous_handlers.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._previous_handlers.clear()
        if self._kill_timer is not None:
            self._kill_timer.cancel()
            self._kill_timer = None

    # -- observability ------------------------------------------------------

    def _emit(self, event: str, **data) -> None:
        payload = {"event": event, "attempt": self.state.attempt,
                   "restarts": self.state.restarts,
                   "commit_step": self.state.last_commit_step, **data}
        try:
            self._reg.event("supervisor", payload)
            self._reg.flush()
        except Exception as e:  # noqa: BLE001 — telemetry is best-effort
            self._log(f"supervisor: warning: timeline event {event!r} not "
                      f"recorded ({type(e).__name__}: {e})")

    def _rpo_s(self) -> Optional[float]:
        if self.state.last_commit_wall is None:
            return None
        return max(time.time() - self.state.last_commit_wall, 0.0)

    def health(self) -> Dict[str, Any]:
        """Merged into ``/healthz`` by ``cli/supervise.py``: liveness a
        fleet prober can alert on without parsing the metrics stream."""
        st = self.state
        return {
            "supervisor_attempt": st.attempt,
            "supervisor_restarts": st.restarts,
            "supervisor_world_changes": st.world_changes,
            "last_child_exit_code": st.last_exit_code,
            "backoff_s": st.backoff_s,
            "child_alive": (self._child is not None
                            and self._child.poll() is None),
            "last_commit_step": st.last_commit_step,
            "last_commit_age_s": self._rpo_s(),
        }

    # -- the loop -----------------------------------------------------------

    def _persist(self) -> None:
        try:
            self.state.save(self.state_file)
        except OSError as e:
            self._log(f"supervisor: warning: could not persist state to "
                      f"{self.state_file}: {e}")

    def _wait(self, child) -> int:
        self._child = child
        try:
            while True:
                rc = child.poll()
                if rc is not None:
                    return rc
                # live commit receipts while the child runs: /healthz
                # last_commit_age_s is the fleet's RPO probe
                self._refresh_commit()
                time.sleep(self.poll_interval)
        finally:
            self._child = None
            if self._kill_timer is not None:
                self._kill_timer.cancel()
                self._kill_timer = None

    def _surface(self, code: int) -> int:
        # shell convention for signal deaths we surface terminally
        return 128 + (-code) if code < 0 else code

    def _pin(self) -> None:
        if not self.save_dir:
            return
        latest = ckpt_paths.latest_committed_step(self.save_dir)
        if latest is not None:
            ckpt_paths.write_resume_pin(self.save_dir, latest[1],
                                        owner=f"supervisor:{os.getpid()}")

    def run(self) -> int:
        st = self.state
        self._install_signals()
        self._refresh_commit()
        if self.state.last_world is None:
            st.last_world = self._world()
        try:
            while True:
                st.attempt += 1
                st.backoff_s = 0.0
                # pin the step the child will resume from BEFORE it can
                # run any retention GC (the child's keep_last prune must
                # not race its own resume read)
                self._pin()
                self._commit_at_spawn = st.last_commit_step
                self._persist()
                cmd = self.argv_fn(st)
                self._emit("spawn", cmd=" ".join(map(str, cmd[:6]))
                           + (" ..." if len(cmd) > 6 else ""))
                self._reg.counter("supervisor/spawns").inc()
                self._log(f"supervisor: attempt {st.attempt} "
                          f"(restarts {st.restarts}/{self.max_restarts})")
                try:
                    child = self._popen(cmd)
                except Exception as e:  # noqa: BLE001 — spawn is terminal
                    self._log(f"supervisor: cannot spawn child: {e}")
                    self._emit("spawn_failed", error=str(e))
                    self._persist()
                    return 1
                code = self._wait(child)
                st.last_exit_code = code
                progressed = self._note_progress()
                self._emit("child_exit", code=code, progressed=progressed,
                           rpo_s=self._rpo_s(),
                           escalated=self.escalated)
                if self.recorder is not None and code != 0:
                    self.recorder.note("child_exit", code=code,
                                       attempt=st.attempt,
                                       commit_step=st.last_commit_step,
                                       rpo_s=self._rpo_s())
                    self.recorder.dump(f"child_exit_{code}")
                if self._stop_signum is not None:
                    # the supervisor itself was told to stop: never
                    # relaunch; keep the pin (a later supervise resumes)
                    self._persist()
                    if self._stop_signum == signal.SIGINT:
                        rc = EXIT_CODE_INTERRUPTED
                    elif code > 0:
                        rc = code
                    else:
                        rc = EXIT_CODE_CHECKPOINT_AND_EXIT
                    self._log("supervisor: stopping on "
                              f"{signal.Signals(self._stop_signum).name} "
                              f"(exit {rc})")
                    self._emit("stopped", code=rc)
                    return rc
                if code == 0:
                    if self.save_dir:
                        ckpt_paths.clear_resume_pin(self.save_dir)
                    self._persist()
                    self._emit("done")
                    return 0
                restartable = (
                    code in self.restart_codes
                    or (self.restart_on_error and (code < 0 or code == 1)))
                if not restartable:
                    if code == EXIT_CODE_FAILED_ON_RESULT_VALIDATION:
                        self._log("supervisor: exit 17 (persistent "
                                  "validation fault) is not restartable; "
                                  "surfacing it")
                    self._reg.counter("supervisor/terminal_exits",
                                      code=code).inc()
                    if self.save_dir:
                        ckpt_paths.clear_resume_pin(self.save_dir)
                    self._persist()
                    self._emit("terminal", code=code)
                    return self._surface(code)
                if st.restarts >= self.max_restarts:
                    self._reg.counter("supervisor/giveups",
                                      reason="budget").inc()
                    self._log("supervisor: restart budget "
                              f"({self.max_restarts}) exhausted; "
                              f"surfacing exit code {self._surface(code)}")
                    self._persist()
                    self._emit("giveup", code=self._surface(code))
                    return self._surface(code)
                delay = backoff_delay(st.restarts, base=self.base_delay,
                                      cap=self.max_delay, rng=self.rng)
                st.backoff_s = delay
                st.restarts += 1
                self._reg.counter("supervisor/restarts", code=code).inc()
                self._reg.counter("supervisor/backoff_wait_s").inc(delay)
                self._log(f"supervisor: child exit {code}; restart "
                          f"{st.restarts}/{self.max_restarts} in "
                          f"{delay:.1f}s")
                self._persist()
                self._sleep(delay)
        finally:
            self._restore_signals()
