"""Cross-process training supervisor, the production restart loop around
``train_dist``.

::

    python -m hetu_galvatron_tpu_torch.cli.supervise <config.yaml> [k=v ...]

Port of ``hetu_galvatron_tpu/cli/supervise.py`` (``child_argv`` :105,
``run_supervised`` :122, ``main`` :183). It spawns ``python -m
hetu_galvatron_tpu_torch.cli.train_dist`` with the same config and
overrides (plus ``supervisor.mode=inprocess supervisor.auto_restart=false``
so the child never recurses, and a per-attempt ``ckpt.load=<ckpt.save>``
once a committed checkpoint exists) and relaunches it per the exit-code
contract. Unlike the in-process loop (``run_with_restarts``), a SIGKILL'd
child costs one attempt, not the run. This process imports no torch: the
card belongs to the child.

Exit-code contract (child -> supervisor action):

====  =====================================  =========================
code  meaning                                supervisor action
====  =====================================  =========================
0     training complete                      stop (success)
16    rerun machine: resume-to-disambiguate  restart from last commit
17    persistent validation fault            TERMINAL — restarting
                                             reproduces the fault
18    preempted (SIGTERM trapped, ckpt       restart from last commit
      committed at the step boundary)
130   operator SIGINT (deliberate stop)      TERMINAL — never
                                             resurrect a ^C'd run
< 0   child killed by a signal (OOM killer,  crash: restart while the
      SIGKILL mid-save, segfault)            budget lasts; surfaced
                                             terminally as 128+signum
1     unhandled exception in the child       crash: restart while the
                                             budget lasts
other (2 = usage error, ...)                 TERMINAL — restarting a
                                             misconfiguration only
                                             burns the budget
====  =====================================  =========================

The restart budget (``supervisor.max_restarts``) counts CONSECUTIVE
no-progress restarts: a new committed checkpoint resets it. Backoff
between relaunches is full-jitter exponential
(``supervisor.backoff_base_s``/``backoff_max_s``). The supervisor's state
persists tmp+rename-atomically in ``supervisor.state_file`` (default
``<ckpt.save>/SUPERVISOR_STATE.json``), and before every relaunch the
``RESUME_PIN`` lease is stamped so the child's retention GC cannot prune
the step dir the relaunch resumes from.

A SIGTERM to this process is forwarded to the child, which checkpoints at
its step boundary; ``supervisor.term_grace_s`` later the child is
SIGKILLed. Set it above the time one save takes, or a preemption turns
into a torn save (which resume then skips, losing the steps since the
previous commit).

Observability (JAX :157-179): the supervisor appends ``supervisor``
events to the SAME metrics JSONL the child writes (``JsonlSink`` appends
are O_APPEND + single-``write`` atomic, so interleaving is safe), dumps a
flight record per abnormal child exit when a flight dir is configured
(``flight_supervisor_*.json``), and with ``supervisor.metrics_port >= 0``
serves ``/healthz`` (attempt count, last child exit code, backoff state,
last-commit age) and ``/metrics`` on the loopback address; port 0 binds
an ephemeral port, printed as ``supervisor: /healthz and /metrics on
http://127.0.0.1:<port>``. Port-only: ``/metrics`` also re-exports the
last flushed value of every series the children wrote to the shared
stream (``train/*``, ``goodput/*``, ...), which the supervisor's own
registry cannot hold across the process boundary.
"""

from __future__ import annotations

import json
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence

from hetu_galvatron_tpu_torch.runtime import ckpt_paths
from hetu_galvatron_tpu_torch.runtime.supervisor import (
    ProcessSupervisor,
    SupervisorState,
)

TRAIN_MODULE = "hetu_galvatron_tpu_torch.cli.train_dist"

# overrides forced onto every child, AFTER the operator's own (later
# dotted overrides win): the child must run exactly one attempt
_CHILD_FORCED = ("supervisor.mode=inprocess",
                 "supervisor.auto_restart=false")


class _Series:
    """One series read back from the metrics stream, shaped like a
    registry metric for ``prometheus_text``."""

    def __init__(self, rec: Dict[str, Any]):
        self.kind = rec["kind"]
        self.name = str(rec.get("name", ""))
        self.labels = dict(rec.get("labels") or {})
        self.value = rec.get("value", 0.0)
        self.count = rec.get("count", 0)
        self.total = rec.get("mean", 0.0) * self.count
        self._rec = rec

    def snapshot(self) -> Dict[str, Any]:
        return {k: self._rec.get(k, 0.0)
                for k in ("count", "mean", "min", "max", "p50", "p90",
                          "p99")}


class StreamMirror:
    """What ``/metrics`` exposes: the supervisor's own registry, plus the
    last record of every series in the shared metrics stream that the
    registry does not hold itself (the children's). The stream is read
    incrementally at each scrape; a torn last line waits for the next."""

    def __init__(self, registry, path: str):
        self._registry = registry
        self._path = path
        self._pos = 0
        self._tail = b""
        self._latest: Dict[tuple, Dict[str, Any]] = {}
        self._lock = threading.Lock()

    def _read(self) -> None:
        try:
            with open(self._path, "rb") as f:
                f.seek(self._pos)
                chunk = f.read()
        except OSError:
            return
        self._pos += len(chunk)
        lines = (self._tail + chunk).split(b"\n")
        self._tail = lines.pop()
        for line in lines:
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if isinstance(rec, dict) and rec.get("kind") in (
                    "counter", "gauge", "histogram"):
                key = (rec["kind"], rec.get("name"),
                       json.dumps(rec.get("labels") or {}, sort_keys=True))
                self._latest[key] = rec

    def metrics(self) -> List[Any]:
        with self._lock:
            self._read()
            own = self._registry.metrics()
            held = {(m.kind, m.name, json.dumps(m.labels, sort_keys=True))
                    for m in own}
            return own + [_Series(r) for k, r in self._latest.items()
                          if k not in held]


def child_argv(base_argv: Sequence[str], args,
               state: SupervisorState) -> List[str]:
    """The child command line for one attempt: the operator's argv,
    then the forced single-attempt overrides, then (once a commit
    exists) the resume override — appended LAST so they win."""
    cmd = [sys.executable, "-m", TRAIN_MODULE]
    cmd.extend(base_argv)
    cmd.extend(_CHILD_FORCED)
    if args.ckpt.save and \
            ckpt_paths.latest_committed_step(args.ckpt.save) is not None:
        # resume from this run's own progress as soon as it exists — a
        # warm-start ckpt.load pointing elsewhere must not make every
        # restart retrain from the warm-start step
        cmd.append(f"ckpt.load={args.ckpt.save}")
    return cmd


def run_supervised(args, base_argv: Sequence[str]) -> int:
    """Supervise ``train_dist`` children built from ``base_argv`` until
    the run completes, turns terminal, or the budget is spent. Torch-free:
    this process must not touch the card its children need."""
    from hetu_galvatron_tpu_torch.observability.recorder import flight_dir_of
    from hetu_galvatron_tpu_torch.observability.registry import (
        get_registry,
        metrics_path_of,
    )

    sup = args.supervisor
    obs = args.observability
    # supervisor events land in the children's stream, dumps beside theirs
    metrics_path = (metrics_path_of(args)
                    if obs.enabled or obs.metrics_path else None)
    flight_dir = (flight_dir_of(args)
                  if obs.enabled or obs.flight_dir is not None else None)
    registry = None
    if metrics_path:
        from hetu_galvatron_tpu_torch.observability.registry import configure

        registry = configure(jsonl_path=metrics_path)
    recorder = None
    if flight_dir:
        from hetu_galvatron_tpu_torch.observability.recorder import (
            FlightRecorder,
        )

        recorder = FlightRecorder(registry=registry, out_dir=flight_dir,
                                  prefix="flight_supervisor",
                                  capacity=args.observability.flight_events)
    supervisor = ProcessSupervisor(
        lambda state: child_argv(base_argv, args, state),
        save_dir=args.ckpt.save or None,
        state_file=sup.state_file,
        max_restarts=sup.max_restarts,
        max_world_changes=sup.max_world_changes,
        base_delay=sup.backoff_base_s,
        max_delay=sup.backoff_max_s,
        restart_on_error=sup.restart_on_error,
        term_grace_s=sup.term_grace_s,
        poll_interval=sup.poll_interval_s,
        registry=registry,
        recorder=recorder,
    )

    server = None
    if sup.metrics_port >= 0:
        from hetu_galvatron_tpu_torch.observability.prometheus import (
            MetricsHTTPServer,
        )

        own = registry if registry is not None else get_registry()
        exposed = StreamMirror(own, metrics_path) if metrics_path else own
        server = MetricsHTTPServer(registry=exposed, port=sup.metrics_port,
                                   health_fn=supervisor.health)
        port = server.start()
        print(f"supervisor: /healthz and /metrics on "
              f"http://127.0.0.1:{port}", flush=True)
    try:
        rc = supervisor.run()
    finally:
        if server is not None:
            server.stop()
        if registry is not None:
            try:
                registry.close()
            except Exception as e:  # noqa: BLE001 — exit code is decided
                print(f"supervisor: warning: metrics close failed "
                      f"({type(e).__name__}: {e})", flush=True)
    return rc


def main(argv: Optional[Sequence[str]] = None) -> int:
    from hetu_galvatron_tpu_torch.cli.train_dist import check_flags
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli

    base_argv = list(argv if argv is not None else sys.argv[1:])
    args = args_from_cli(base_argv, mode="train_dist")
    check_flags(args)
    return run_supervised(args, base_argv)


if __name__ == "__main__":
    sys.exit(main())
