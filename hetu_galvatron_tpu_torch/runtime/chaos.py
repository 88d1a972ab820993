"""Seeded chaos fault injection for resilience drills.

Port of ``hetu_galvatron_tpu/runtime/chaos.py``: ``FAULT_KINDS``,
``parse_plan`` :83, ``ChaosMonkey`` :112 and ``make_chaos`` :289, all
eight kinds, each one-shot across processes through its
``CHAOS_FIRED_<i>_<kind>`` marker.

Generalizes the one-shot ``rerun.inject_kind`` drill into a FAULT PLAN:
a sequence of step-targeted faults — process crashes, preemption
signals, SIGKILL mid-async-save (torn staging dir), committed-meta
corruption/truncation, transient I/O errors through the real
``utils/retrying.py`` seam, and hung saves — driven through the real
training loop and (for process-killing faults) the real cross-process
supervisor, so what a drill certifies is the production recovery path,
not a mock of it.

Fault kinds (``chaos.kind`` or entries of ``chaos.plan``):

* ``crash`` — raise from the step callback: the unhandled-exception
  path (exit 1, supervised restart).
* ``sigterm`` — ``kill(self, SIGTERM)`` mid-step: the preemption path
  (PreemptionGuard -> boundary checkpoint -> exit 18).
* ``sigkill`` — abrupt death mid-step, no cleanup: the OOM-killer path
  (negative waitpid code at the supervisor).
* ``kill_mid_save`` — SIGKILL from the checkpoint ``before_commit``
  hook: the payload is fully staged but the COMMITTED marker never
  lands, leaving a torn ``step_<n>.tmp`` the resume must ignore and GC
  must sweep.
* ``hung_save`` — the ``before_commit`` hook sleeps ``chaos.hang_s``:
  exercises the async-checkpoint watchdog (``ckpt.save_timeout_s``).
* ``corrupt_meta`` / ``truncate_meta`` — scribble on / truncate the
  NEWEST committed checkpoint's meta.json: resume must fall back to
  the previous committed step with a warning
  (``load_latest_resilient``), never traceback.
* ``io_error`` — the process-global retry-seam injector
  (``retrying.set_fault_injector``) fails the next
  ``chaos.io_error_count`` attempts of ops matching
  ``chaos.io_error_op``: transient flakiness must be absorbed by
  backoff, not surfaced.

Every fault is ONE-SHOT ACROSS PROCESSES: before firing, a
``CHAOS_FIRED_<i>`` marker lands in ``chaos.state_dir`` (default:
``ckpt.save``), so the relaunched attempt does not re-die at the same
step — exactly how a real transient fault behaves. Unfired faults are
re-armed by the relaunch, so a multi-fault plan unfolds across
attempts. ``chaos.seed`` keys nothing today (faults are step-targeted,
not sampled) but is plumbed so sampled plans stay reproducible.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from hetu_galvatron_tpu_torch.runtime import ckpt_paths
from hetu_galvatron_tpu_torch.utils.retrying import set_fault_injector

FAULT_KINDS = ("crash", "sigterm", "sigkill", "kill_mid_save",
               "hung_save", "corrupt_meta", "truncate_meta", "io_error")

# fault kinds that end the process (the supervisor, not the in-process
# loop, owns recovery): drills asserting on these need mode=process
PROCESS_KILLING = ("sigkill", "kill_mid_save")


class ChaosCrash(RuntimeError):
    """The injected 'unhandled host exception' — a distinct type so
    drill asserts can tell an injected crash from a real bug."""


@dataclass
class Fault:
    kind: str
    at_iter: int = -1           # step the fault arms at (-1 = immediately)
    count: int = 2              # io_error: attempts to fail
    hang_s: float = 5.0         # hung_save: stall length
    op: str = "checkpoint"      # io_error: substring match on the retry op
    index: int = 0              # position in the plan (marker identity)
    fired: bool = False

    def marker(self) -> str:
        return f"CHAOS_FIRED_{self.index}_{self.kind}"


def parse_plan(chaos) -> List[Fault]:
    """Faults from ChaosArgs: ``chaos.plan`` is a comma-separated list of
    ``kind@iter`` entries (``"corrupt_meta@4,crash@5"``); with no plan,
    the single ``chaos.kind``/``chaos.at_iter`` pair (the
    ``rerun.inject_kind`` idiom) is the whole plan."""
    faults: List[Fault] = []
    specs: List[str] = []
    if chaos.plan:
        specs = [s.strip() for s in str(chaos.plan).split(",") if s.strip()]
    elif chaos.kind and chaos.kind != "none":
        specs = [f"{chaos.kind}@{chaos.at_iter}"]
    for i, spec in enumerate(specs):
        kind, _, at = spec.partition("@")
        kind = kind.strip()
        if kind not in FAULT_KINDS:
            raise ValueError(
                f"chaos plan entry {spec!r}: unknown kind {kind!r} "
                f"(one of {', '.join(FAULT_KINDS)})")
        faults.append(Fault(
            kind=kind,
            at_iter=int(at) if at.strip() else -1,
            count=int(chaos.io_error_count),
            hang_s=float(chaos.hang_s),
            op=str(chaos.io_error_op),
            index=i,
        ))
    return faults


class ChaosMonkey:
    """Executes a fault plan against the live training loop.

    Wire-up (``cli/train_dist.py``): construct when ``chaos.enable``;
    ``install()`` before the loop (arms the retry-seam injector),
    ``on_step(it)`` at the top of every step (step-targeted faults),
    ``save_hooks()`` merged into the checkpoint hooks (mid-save
    faults), ``uninstall()`` in the loop's finally.
    """

    def __init__(self, chaos, *, state_dir: Optional[str] = None,
                 registry=None,
                 log: Callable[[str], None] = lambda m: print(m,
                                                              flush=True)):
        self.faults = parse_plan(chaos)
        self.state_dir = state_dir or chaos.state_dir
        self._log = log
        self._registry = registry
        self._iter = -1
        self._prev_injector: Optional[Callable] = None
        self._installed = False
        if self.state_dir:
            os.makedirs(self.state_dir, exist_ok=True)
            for f in self.faults:
                if os.path.exists(os.path.join(self.state_dir, f.marker())):
                    f.fired = True  # already fired in a previous attempt

    # -- bookkeeping --------------------------------------------------------

    def _count(self, kind: str) -> None:
        try:
            reg = self._registry
            if reg is None:
                from hetu_galvatron_tpu_torch.observability.registry import (
                    get_registry,
                )

                reg = get_registry()
            reg.counter("chaos/injected", kind=kind).inc()
        except Exception:  # noqa: BLE001 — chaos telemetry is best-effort
            pass

    def _mark(self, f: Fault) -> None:
        """Persist one-shot-ness BEFORE the fault fires: a SIGKILL'd
        process cannot mark afterwards, and an unmarked fault would
        re-kill every relaunch forever."""
        f.fired = True
        if self.state_dir:
            ckpt_paths.atomic_write_json(
                os.path.join(self.state_dir, f.marker()),
                {"kind": f.kind, "at_iter": f.at_iter, "pid": os.getpid(),
                 "t_wall": time.time()})
        self._count(f.kind)
        self._log(f"chaos: firing {f.kind} (fault #{f.index}, "
                  f"step {self._iter})")

    def pending(self) -> List[str]:
        return [f.kind for f in self.faults if not f.fired]

    # -- the injector seam --------------------------------------------------

    def install(self) -> None:
        if self._installed:
            return
        self._installed = True
        if any(f.kind == "io_error" for f in self.faults):
            self._prev_injector = set_fault_injector(self._io_fault)

    def uninstall(self) -> None:
        if not self._installed:
            return
        self._installed = False
        if any(f.kind == "io_error" for f in self.faults):
            set_fault_injector(self._prev_injector)
            self._prev_injector = None

    def _io_fault(self, op: str) -> Optional[Exception]:
        for f in self.faults:
            if f.fired or f.kind != "io_error":
                continue
            if f.at_iter >= 0 and self._iter < f.at_iter:
                continue
            if f.op and f.op not in op:
                continue
            f.count -= 1
            if f.count <= 0:
                # transient by construction: after `count` failures the
                # op succeeds, so backoff absorbs the fault
                self._mark(f)
            else:
                self._count(f.kind)
                self._log(f"chaos: injecting transient I/O error on "
                          f"{op!r} ({f.count} more)")
            return OSError(f"chaos: injected transient I/O error ({op})")
        return None

    # -- step-targeted faults -----------------------------------------------

    def on_step(self, it: int) -> None:
        """Fire any armed step fault whose ``at_iter`` has arrived.
        Called at the top of the step (before the update), so 'crash at
        step k' loses exactly the steps since the last commit — the RPO
        a drill asserts on."""
        self._iter = it
        for f in self.faults:
            if f.fired or f.at_iter < 0 or it < f.at_iter:
                continue
            if f.kind == "crash":
                self._mark(f)
                raise ChaosCrash(f"chaos: injected crash at step {it}")
            if f.kind == "sigterm":
                self._mark(f)
                os.kill(os.getpid(), signal.SIGTERM)
            elif f.kind == "sigkill":
                self._mark(f)
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind in ("corrupt_meta", "truncate_meta"):
                self._corrupt_latest_meta(f)
            # kill_mid_save / hung_save / io_error fire via their seams

    def _corrupt_latest_meta(self, f: Fault) -> None:
        """Scribble on the NEWEST committed checkpoint's meta.json —
        stays armed (unmarked) until a commit exists to corrupt."""
        root = self.state_dir
        latest = ckpt_paths.latest_committed_step(root) if root else None
        if latest is None:
            return
        self._mark(f)
        meta = os.path.join(latest[1], "meta.json")
        if f.kind == "truncate_meta":
            # torn write: half a JSON document
            try:
                with open(meta) as fh:
                    txt = fh.read()
                with open(meta, "w") as fh:
                    fh.write(txt[:max(len(txt) // 2, 1)])
            except OSError:
                pass
        else:
            with open(meta, "w") as fh:
                fh.write("{this is not json")
        self._log(f"chaos: {f.kind} on {meta}")

    # -- mid-save faults ----------------------------------------------------

    def save_hooks(self) -> Dict[str, Callable[..., Any]]:
        """Hooks for the checkpoint seam (``save_checkpoint(hooks=...)``
        / ``AsyncCheckpointer(hooks=...)``): ``before_commit`` runs with
        the payload staged but the COMMITTED marker not yet written —
        the exact window where a death must leave a torn, ignorable
        staging dir."""
        return {"before_commit": self._before_commit}

    def _before_commit(self, tmp_dir: str) -> None:
        step = _step_of_tmp(tmp_dir)
        for f in self.faults:
            if f.fired:
                continue
            if f.at_iter >= 0 and step is not None and step < f.at_iter:
                continue
            if f.kind == "kill_mid_save":
                self._mark(f)
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "hung_save":
                self._mark(f)
                self._log(f"chaos: hanging save of {tmp_dir} for "
                          f"{f.hang_s:.1f}s")
                time.sleep(f.hang_s)


def _step_of_tmp(tmp_dir: str) -> Optional[int]:
    name = os.path.basename(tmp_dir.rstrip("/"))
    if name.endswith(ckpt_paths.TMP_SUFFIX):
        name = name[: -len(ckpt_paths.TMP_SUFFIX)]
    return ckpt_paths.step_of(name)


def make_chaos(args, *, registry=None,
               log: Callable[[str], None] = lambda m: print(m, flush=True)
               ) -> Optional[ChaosMonkey]:
    """The train_dist construction seam: None unless ``chaos.enable``."""
    chaos = getattr(args, "chaos", None)
    if chaos is None or not chaos.enable:
        return None
    state_dir = chaos.state_dir or args.ckpt.save or None
    monkey = ChaosMonkey(chaos, state_dir=state_dir, registry=registry,
                         log=log)
    if not monkey.faults:
        return None
    return monkey
