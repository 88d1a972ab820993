"""The port's cross-process supervisor (``runtime/supervisor.
ProcessSupervisor``, ``cli/supervise.py``) against real child processes:
cheap ``python -c`` children, as the JAX package's
``tests/core/test_supervise_process.py`` runs them. The exit-code contract,
the atomic state file, commit receipts resetting the restart budget, the
``RESUME_PIN`` lease, signal forwarding with the grace escalation and the
health payload; each case runs the JAX supervisor over the same children
too, and their states must agree."""

import dataclasses
import json
import os
import signal
import sys
import time

import pytest

from hetu_galvatron_tpu.runtime import supervisor as JV
from hetu_galvatron_tpu_torch.cli import supervise as TCLI
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.runtime import checkpoint as TK
from hetu_galvatron_tpu_torch.runtime import ckpt_paths as TP
from hetu_galvatron_tpu_torch.runtime import supervisor as TV

GPT2 = os.path.join(os.path.dirname(__file__), "..", "hetu_galvatron_tpu",
                    "models", "configs", "gpt2-small.yaml")


def _sup(V, argv_fn, **kw):
    kw.setdefault("base_delay", 0.0)
    kw.setdefault("max_delay", 0.0)
    kw.setdefault("poll_interval", 0.02)
    kw.setdefault("sleep", lambda s: None)
    kw.setdefault("log", lambda m: None)
    return V.ProcessSupervisor(argv_fn, **kw)


def _exit_child(code):
    return lambda st: [sys.executable, "-c", f"import sys; sys.exit({code})"]


def _commit(root, step, world=1):
    d = os.path.join(root, f"step_{step}")
    os.makedirs(d, exist_ok=True)
    TP.atomic_write_json(
        os.path.join(d, "meta.json"),
        {"step": step, "hybrid_parallel_config": {"world_size": world}})
    with open(os.path.join(d, TP.COMMIT_MARKER), "w") as f:
        f.write("ok")
    return d


def _state(sup):
    return {k: v for k, v in dataclasses.asdict(sup.state).items()
            if k not in ("last_commit_wall",)}


@pytest.mark.parametrize("code,kw,rc,attempts", [
    (0, {}, 0, 1),
    (17, {}, 17, 1),  # persistent fault: terminal
    (130, {}, 130, 1),  # operator SIGINT: terminal
    (2, {}, 2, 1),  # usage error: terminal
    (18, dict(max_restarts=2), 18, 3),  # restartable until the budget
    (16, dict(max_restarts=1), 16, 2),
    (1, dict(max_restarts=1), 1, 2),  # a crash restarts
    (1, dict(restart_on_error=False), 1, 1),
])
def test_torch_supervisor_exit_code_contract_matches_jax(tmp_path, code, kw,
                                                         rc, attempts):
    states = []
    for V in (JV, TV):
        sup = _sup(V, _exit_child(code),
                   state_file=str(tmp_path / f"{V.__name__}.json"), **kw)
        assert sup.run() == rc
        assert sup.state.attempt == attempts
        states.append(_state(sup))
    assert states[0] == states[1]


def test_torch_supervisor_signal_death_surfaces_128_plus_signum(tmp_path):
    kill = lambda st: [sys.executable, "-c",  # noqa: E731
                       "import os; os.kill(os.getpid(), 9)"]
    sup = _sup(TV, kill, state_file=str(tmp_path / "s.json"),
               max_restarts=1)
    assert sup.run() == 137
    assert sup.state.attempt == 2  # a signal death is restartable
    assert sup.state.last_exit_code == -9


def test_torch_commit_receipt_resets_restart_budget(tmp_path):
    """A child that commits a new checkpoint before dying never exhausts
    the budget; both supervisors count the same attempts."""
    script = (
        "import os, sys\n"
        "root = sys.argv[1]\n"
        "steps = sorted(int(d[5:]) for d in os.listdir(root)\n"
        "               if d.startswith('step_') and d[5:].isdigit())\n"
        "n = (steps[-1] if steps else 0) + 1\n"
        "if n > 3:\n"
        "    sys.exit(0)\n"
        "d = os.path.join(root, f'step_{n}')\n"
        "os.makedirs(d)\n"
        "import json\n"
        "json.dump({'step': n, 'hybrid_parallel_config': "
        "{'world_size': 1}}, open(os.path.join(d, 'meta.json'), 'w'))\n"
        "open(os.path.join(d, 'COMMITTED'), 'w').write('ok')\n"
        "sys.exit(18)\n")
    states = []
    for V in (JV, TV):
        root = str(tmp_path / V.__name__)
        os.makedirs(root)
        sup = _sup(V, lambda st, r=root: [sys.executable, "-c", script, r],
                   save_dir=root, max_restarts=1)
        assert sup.run() == 0
        assert sup.state.attempt == 4 and sup.state.last_commit_step == 3
        # cleared on success
        assert TP.read_resume_pin(root) is None
        states.append(_state(sup))
    assert states[0] == states[1]


def test_torch_world_change_progress_and_budget(tmp_path):
    for V in (JV, TV):
        root = str(tmp_path / V.__name__)
        os.makedirs(root)
        _commit(root, 1, world=4)
        worlds = iter([4, 4, 2])
        sup = _sup(V, _exit_child(18), save_dir=root, max_restarts=2,
                   max_world_changes=8, world_fn=lambda: next(worlds, 2))
        assert sup.run() == 18
        assert (sup.state.attempt, sup.state.world_changes) == (4, 1)
        w = [0]

        def world():
            w[0] += 1
            return w[0]

        flap = _sup(V, _exit_child(18), save_dir=root, max_restarts=1,
                    max_world_changes=2, world_fn=world,
                    state_file=str(tmp_path / f"{V.__name__}_flap.json"))
        assert flap.run() == 18
        assert flap.state.world_changes == 2  # pinned at the cap


def test_torch_supervisor_state_file(tmp_path):
    p = str(tmp_path / "s.json")
    st = TV.SupervisorState(attempt=5, restarts=2, world_changes=1,
                            last_exit_code=18, last_commit_step=40,
                            last_commit_wall=123.0, last_world=8,
                            backoff_s=1.5)
    st.save(p)
    assert not os.path.exists(p + ".tmp")
    assert TV.SupervisorState.load(p) == st
    # the JAX supervisor resumes from the port's state file, field by field
    assert dataclasses.asdict(JV.SupervisorState.load(p)) == \
        dataclasses.asdict(st)
    with open(p, "w") as f:
        f.write("{torn")
    assert TV.SupervisorState.load(p) == TV.SupervisorState()
    # a preempted supervisor resumes with the budget it had
    p2 = str(tmp_path / "s2.json")
    sup = _sup(TV, _exit_child(18), state_file=p2, max_restarts=2)
    assert sup.run() == 18
    sup2 = _sup(TV, _exit_child(18), state_file=p2, max_restarts=2)
    assert sup2.run() == 18
    assert sup2.state.attempt == sup.state.attempt + 1


def test_torch_pin_written_before_relaunch_and_respected_by_gc(tmp_path):
    root = str(tmp_path / "ck")
    os.makedirs(root)
    _commit(root, 7)
    seen = []

    def argv(st):
        seen.append(TP.read_resume_pin(root))
        return _exit_child(0)(st)

    assert _sup(TV, argv, save_dir=root).run() == 0
    assert seen == [os.path.join(root, "step_7")]  # pinned at spawn time
    assert TP.read_resume_pin(root) is None  # cleared on success
    for s in (1, 2, 3):
        _commit(root, s)
    TP.write_resume_pin(root, os.path.join(root, "step_1"))
    removed = TK.gc_checkpoints(root, keep_last=1)
    assert os.path.isdir(os.path.join(root, "step_1"))  # pinned
    assert os.path.isdir(os.path.join(root, "step_7"))  # newest
    assert os.path.join(root, "step_2") in removed
    assert os.path.join(root, "step_3") in removed


def _await_file(path, timeout_s=20.0):
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"child never signalled ready at {path}")
        time.sleep(0.01)


@pytest.mark.parametrize("handler,grace,escalated", [
    ("lambda *a: sys.exit(18)", 10.0, False),  # honours the window
    ("signal.SIG_IGN", 0.3, True),  # wedged: SIGKILL after the grace
])
def test_torch_sigterm_forwarded_with_grace_escalation(tmp_path, handler,
                                                       grace, escalated):
    """A SIGTERM to the supervisor reaches the child and ends the loop (the
    fleet preempted the supervisor: never relaunch); a child that ignores
    it is SIGKILLed after term_grace_s and surfaces as 18."""
    ready = str(tmp_path / "ready")
    script = ("import signal, sys, time\n"
              f"signal.signal(signal.SIGTERM, {handler})\n"
              f"open({ready!r}, 'w').write('up')\n"
              "time.sleep(60)\n")
    sup = _sup(TV, lambda st: [sys.executable, "-c", script],
               state_file=str(tmp_path / "s.json"), term_grace_s=grace)
    fired = []
    orig_wait = sup._wait

    def wait_and_signal(child):
        if not fired:
            fired.append(1)
            _await_file(ready)
            sup._child = child
            sup._on_signal(signal.SIGTERM, None)
        return orig_wait(child)

    sup._wait = wait_and_signal
    assert sup.run() == 18
    assert sup.state.attempt == 1
    assert sup.escalated is escalated


def test_torch_health_payload(tmp_path):
    root = str(tmp_path / "ck")
    os.makedirs(root)
    _commit(root, 9)
    sup = _sup(TV, _exit_child(18), save_dir=root, max_restarts=1)
    assert sup.run() == 18
    h = sup.health()
    assert h["supervisor_attempt"] == 2
    assert h["last_child_exit_code"] == 18
    assert h["last_commit_step"] == 9
    assert h["last_commit_age_s"] >= 0.0
    assert h["child_alive"] is False
    json.dumps(h)
    jsup = _sup(JV, _exit_child(18), save_dir=root, max_restarts=1)
    assert jsup.run() == 18
    assert sorted(jsup.health()) == sorted(h)


def test_torch_supervise_child_argv_and_refusals(tmp_path):
    """The child command line: the operator's argv, the forced
    single-attempt overrides, then the resume override once a commit
    exists; a flag outside the port raises by name before any child
    starts."""
    ck = str(tmp_path / "ck")
    base = [GPT2, "device=cpu", f"ckpt.save={ck}"]
    args = load_config(GPT2, base[1:])
    cmd = TCLI.child_argv(base, args, TV.SupervisorState())
    assert cmd[:3] == [sys.executable, "-m",
                       "hetu_galvatron_tpu_torch.cli.train_dist"]
    assert cmd[3:] == base + ["supervisor.mode=inprocess",
                              "supervisor.auto_restart=false"]
    _commit(ck, 2)
    assert TCLI.child_argv(base, args, TV.SupervisorState())[-1] == \
        f"ckpt.load={ck}"
    with pytest.raises(NotImplementedError,
                       match="observability.tensorboard"):
        TCLI.main(base + ["supervisor.metrics_port=0",
                          "observability.tensorboard=true"])
