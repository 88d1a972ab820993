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

Not ported yet, and refused by name by the flag check of
``cli/train_dist.py``: the ``/healthz`` endpoint (``supervisor.metrics_port
>= 0``; ``ProcessSupervisor.health()`` gives its payload) and the metrics
and flight-recorder streams of the observability slice.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

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
    the run completes, turns terminal, or the budget is spent."""
    sup = args.supervisor
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
    )
    return supervisor.run()


def main(argv: Optional[Sequence[str]] = None) -> int:
    from hetu_galvatron_tpu_torch.cli.train_dist import check_flags
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli

    base_argv = list(argv if argv is not None else sys.argv[1:])
    args = args_from_cli(base_argv, mode="train_dist")
    check_flags(args)
    return run_supervised(args, base_argv)


if __name__ == "__main__":
    sys.exit(main())
