"""The port's fault lifecycle against the JAX package, module by module:
the retry policy (``utils/retrying.py``), the in-memory metrics registry,
the checkpoint path protocol (``runtime/ckpt_paths.py``), the rerun state
machine, the in-process supervisor (``PreemptionGuard``,
``run_with_restarts``, ``FaultDrill``) and the chaos plan. The same inputs
go through the JAX function and the port's; their outputs must be equal
(these modules are pure Python, so equal means equal), and the JAX tests'
own assertions are repeated on the port."""

import json
import math
import os
import random
import signal
import time

import pytest

from hetu_galvatron_tpu.core import args_schema as JS
from hetu_galvatron_tpu.observability import registry as JG
from hetu_galvatron_tpu.runtime import chaos as JC
from hetu_galvatron_tpu.runtime import ckpt_paths as JP
from hetu_galvatron_tpu.runtime import rerun_machine as JR
from hetu_galvatron_tpu.runtime import supervisor as JV
from hetu_galvatron_tpu.utils import retrying as JY
from hetu_galvatron_tpu_torch.core import args_schema as TS
from hetu_galvatron_tpu_torch.observability import registry as TG
from hetu_galvatron_tpu_torch.runtime import chaos as TC
from hetu_galvatron_tpu_torch.runtime import ckpt_paths as TP
from hetu_galvatron_tpu_torch.runtime import rerun_machine as TR
from hetu_galvatron_tpu_torch.runtime import supervisor as TV
from hetu_galvatron_tpu_torch.utils import retrying as TY

NAN = float("nan")


def _same(a, b):
    """Equality with NaN equal to NaN, through lists, tuples and dicts."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    return a == b


def _counts(reg):
    return {(m.kind, m.name, tuple(sorted(m.labels.items()))):
            m.snapshot() for m in reg.metrics()}


# -- utils/retrying.py --------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(), dict(base=0.2, cap=5.0), dict(base=1.0, cap=3.0),
    dict(jitter=False), dict(base=0.5, cap=30.0, jitter=False)])
def test_torch_backoff_delays_match_jax(kw):
    for attempt in range(8):
        a = JY.backoff_delay(attempt, rng=random.Random(attempt), **kw)
        b = TY.backoff_delay(attempt, rng=random.Random(attempt), **kw)
        assert a == b
    ja = list(JY.backoff_delays(6, rng=random.Random(3), **kw))
    tb = list(TY.backoff_delays(6, rng=random.Random(3), **kw))
    assert ja == tb and len(tb) == 5
    assert list(TY.backoff_delays(1, **kw)) == []


def _retry_case(Y, G, script, **kw):
    """retry_call over a scripted fn: each entry an exception to raise or a
    value to return; returns (result or exception type, calls, sleeps,
    registry counts)."""
    reg = G.MetricsRegistry()
    prev = G.set_registry(reg)
    seq, sleeps, calls = list(script), [], []

    def fn():
        calls.append(1)
        item = seq.pop(0)
        if isinstance(item, Exception):
            raise item
        return item

    try:
        out = Y.retry_call(fn, sleep=sleeps.append, rng=random.Random(11),
                           **kw)
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        out = type(e).__name__
    finally:
        G.set_registry(prev)
    return out, len(calls), sleeps, _counts(reg)


@pytest.mark.parametrize("script,kw", [
    (["ok"], dict(op="checkpoint.read_meta")),
    ([OSError("a"), OSError("b"), "ok"], dict(op="checkpoint.restore")),
    ([OSError("a")] * 3, dict(op="checkpoint.restore")),
    ([ValueError("404")], dict(op="x", retryable=lambda e: isinstance(
        e, OSError))),
    ([OSError("a"), OSError("b"), "ok"], dict(attempts=2, op="y")),
    ([OSError("a")] * 5 + ["ok"], dict(attempts=6, base=1.0, cap=2.0)),
])
def test_torch_retry_call_matches_jax(script, kw):
    a = _retry_case(JY, JG, script, **kw)
    b = _retry_case(TY, TG, script, **kw)
    assert a == b
    with pytest.raises(ValueError, match="attempts"):
        TY.retry_call(lambda: 1, attempts=0)


def test_torch_retry_deadline_matches_jax():
    """A total-elapsed deadline stops the loop with attempts left, and the
    sleeps are clamped to the budget left."""
    def run(Y, G):
        now = [0.0]

        def sleep(s):
            now[0] += s
        seq = [OSError("hang")] * 9

        def fn():
            now[0] += 4.0
            raise seq.pop(0)

        reg = G.MetricsRegistry()
        prev = G.set_registry(reg)
        try:
            with pytest.raises(OSError):
                Y.retry_call(fn, attempts=9, base=1.0, cap=8.0, op="slow",
                             sleep=sleep, clock=lambda: now[0],
                             deadline_s=10.0, rng=random.Random(2))
        finally:
            G.set_registry(prev)
        return now[0], len(seq), _counts(reg)

    a, b = run(JY, JG), run(TY, TG)
    assert a == b
    assert b[1] > 0  # stopped with attempts left


def test_torch_fault_injector_seam_matches_jax():
    """The process-global chaos seam: installed, it fails attempts of every
    op through the real retry path; set_fault_injector returns the
    previous injector."""
    for Y in (JY, TY):
        fired = []

        def inject(op):
            if op.startswith("checkpoint") and len(fired) < 2:
                fired.append(op)
                return OSError("injected")
            return None

        prev = Y.set_fault_injector(inject)
        try:
            assert Y.retry_call(lambda: "ok", attempts=3,
                                op="checkpoint.read_meta",
                                sleep=lambda s: None) == "ok"
            assert Y.retry_call(lambda: "ok", attempts=1, op="data",
                                sleep=lambda s: None) == "ok"
        finally:
            assert Y.set_fault_injector(prev) is inject
        assert fired == ["checkpoint.read_meta"] * 2


# -- observability/registry.py ------------------------------------------------


def test_torch_registry_matches_jax():
    """Counters, gauges and histograms (past the sample cap) give the JAX
    registry's snapshots; the process default can be swapped."""
    snaps = []
    for G in (JG, TG):
        reg = G.MetricsRegistry()
        reg.counter("retry/attempts", op="a").inc()
        reg.counter("retry/attempts", op="a").inc(2.5)
        reg.counter("retry/attempts", op="b").inc()
        reg.gauge("checkpoint/save_ms").set(12)
        h = reg.histogram("step_ms")
        h.cap = 8
        for v in range(37):
            h.observe(v * 0.5)
        snaps.append(_counts(reg))
        assert reg.counter("retry/attempts", op="a").value == 3.5
        assert h.percentile(50) >= 0.0
        prev = G.get_registry()
        assert G.set_registry(reg) is reg and G.get_registry() is reg
        G.set_registry(prev)
    assert snaps[0] == snaps[1]


def test_torch_registry_sinks_raise_by_name():
    with pytest.raises(NotImplementedError, match="sinks"):
        TG.configure(jsonl_path="/tmp/m.jsonl")
    with pytest.raises(NotImplementedError, match="sinks"):
        TG.MetricsRegistry([object()])
    with pytest.raises(NotImplementedError, match="sinks"):
        TG.MetricsRegistry().add_sink(object())
    reg = TG.MetricsRegistry()
    reg.event("supervisor", {"event": "spawn"})  # no sink: nothing written
    reg.flush()
    reg.close()


# -- runtime/ckpt_paths.py ----------------------------------------------------


def _tree(root):
    """A checkpoint root with every kind of entry the selection meets."""
    def commit(name, meta=None, marker=True):
        d = os.path.join(root, name)
        os.makedirs(d)
        if meta is not None:
            with open(os.path.join(d, "meta.json"), "w") as f:
                f.write(meta if isinstance(meta, str) else json.dumps(meta))
        if marker:
            with open(os.path.join(d, "COMMITTED"), "w") as f:
                f.write("committed\n")

    commit("step_3", {"step": 3, "hybrid_parallel_config": {
        "world_size": 1}})
    commit("step_10", {"step": 10, "hybrid_parallel_config": {
        "world_size": 4}})
    commit("step_7", meta={"step": 7}, marker=False)  # pre-marker commit
    commit("step_12", marker=False)  # torn: no marker, no meta
    commit("step_11.tmp")
    commit("step_5.partial")
    commit("step_x")
    commit("step_9", meta="{torn")
    with open(os.path.join(root, "step_4"), "w") as f:
        f.write("a file, not a dir")


@pytest.mark.parametrize("name", [
    "step_3", "step_10", "step_", "step_5.partial", "step_5.tmp", "step_x",
    "stp_3", "step_-1", "step_007", "STEP_3", "step_3.old"])
def test_torch_step_of_matches_jax(name):
    assert TP.step_of(name) == JP.step_of(name)


def test_torch_ckpt_paths_selection_matches_jax(tmp_path):
    root = str(tmp_path)
    _tree(root)
    assert TP.committed_steps(root) == JP.committed_steps(root)
    assert [s for s, _ in TP.committed_steps(root)] == [3, 7, 9, 10]
    assert TP.latest_committed_step(root) == JP.latest_committed_step(root)
    assert TP.latest_committed_step(root)[0] == 10
    assert TP.stored_world_of(root) == JP.stored_world_of(root) == 4
    for entry in sorted(os.listdir(root)):
        d = os.path.join(root, entry)
        assert TP.is_committed(d) == JP.is_committed(d), entry
        tm, terr = TP.try_read_meta(d)
        jm, jerr = JP.try_read_meta(d)
        assert tm == jm and (terr is None) == (jerr is None), entry
        assert TP.commit_wall_time(d) == JP.commit_wall_time(d)
    assert TP.committed_steps(str(tmp_path / "absent")) == []
    assert TP.latest_committed_step(str(tmp_path / "absent")) is None
    assert TP.stored_world_of(str(tmp_path / "absent")) is None


def test_torch_json_helpers_match_jax(tmp_path):
    p = str(tmp_path / "sub" / "state.json")
    TP.atomic_write_json(p, {"a": 1, "b": [1, 2]})
    assert not os.path.exists(p + ".tmp")
    assert JP.try_read_json(p) == TP.try_read_json(p)
    assert TP.try_read_json(p)[0] == {"a": 1, "b": [1, 2]}
    with open(p, "w") as f:
        f.write("[1, 2]")  # valid JSON, not an object
    assert TP.try_read_json(p)[0] is None and TP.try_read_json(p)[1]
    assert TP.try_read_json(str(tmp_path / "none"))[0] is None


def test_torch_resume_pin_crosses_packages(tmp_path):
    """The RESUME_PIN lease one package writes, the other reads; an expired
    or torn pin reads as absent; clearing twice is harmless."""
    root = str(tmp_path)
    d = os.path.join(root, "step_1")
    os.makedirs(d)
    pin = TP.write_resume_pin(root, d, owner="test")
    assert pin == os.path.join(root, TP.RESUME_PIN)
    assert JP.read_resume_pin(root) == TP.read_resume_pin(root) == \
        os.path.abspath(d)
    assert TP.read_resume_pin(root, ttl_s=0.0) is None
    JP.write_resume_pin(root, d)
    assert TP.read_resume_pin(root) == os.path.abspath(d)
    TP.clear_resume_pin(root)
    TP.clear_resume_pin(root)
    assert TP.read_resume_pin(root) is None
    with open(os.path.join(root, TP.RESUME_PIN), "w") as f:
        f.write("{torn")
    assert TP.read_resume_pin(root) is None
    assert (TP.COMMIT_MARKER, TP.TMP_SUFFIX, TP.OLD_SUFFIX,
            TP.RESUME_PIN_TTL_S) == (JP.COMMIT_MARKER, JP.TMP_SUFFIX,
                                     JP.OLD_SUFFIX, JP.RESUME_PIN_TTL_S)


# -- runtime/rerun_machine.py -------------------------------------------------


def _rerun_args(S, **kw):
    return S.RerunArgs(**kw)


def _drive(R, S, args_kw, seq):
    """Feed ``seq`` of (value, rerun value or None) to a machine; return
    every observable: diagnostics, exit codes, records, report, counters
    and the state_dict as strict JSON."""
    G = JG if R is JR else TG
    reg = G.MetricsRegistry()
    m = R.RerunStateMachine(_rerun_args(S, **args_kw), registry=reg)
    diags, codes = [], []
    for it, (value, rerun) in enumerate(seq):
        fn = None if rerun is None else (lambda r=rerun: r)
        diags.append(m.validate_result(value, it, rerun_fn=fn).value)
        codes.append(m.exit_code_requested())
    report = m.report()
    report["records"] = [dict(r, diagnostic=r["diagnostic"].value)
                         for r in report["records"]]
    return dict(diags=diags, codes=codes, report=report,
                counts=_counts(reg),
                state=json.dumps(m.state_dict(), allow_nan=False,
                                 sort_keys=True),
                ema=m._ema, state_now=m.state.value)


VALIDATE = dict(enable=True, mode="validate_results")
RERUN_CASES = {
    "disabled": (dict(enable=False), [(NAN, None), (1.0, None)]),
    "mode_disabled": (dict(enable=True), [(NAN, 1.0)]),
    "clean": (VALIDATE, [(3.0 - 0.1 * i, 1.0) for i in range(10)]),
    "nan_transient": (VALIDATE, [(2.0, None), (NAN, 2.0)]),
    "nan_persistent": (VALIDATE, [(2.0, None), (NAN, NAN)]),
    "nan_no_rerun": (VALIDATE, [(NAN, None)]),
    "inf": (VALIDATE, [(float("inf"), 1.0)]),
    "spike": (dict(VALIDATE, spike_factor=5.0),
              [(2.0, None)] * 5 + [(50.0, 50.0)]),
    "spike_transient": (dict(VALIDATE, spike_factor=5.0),
                        [(2.0, None)] * 3 + [(50.0, 2.0), (2.1, None)]),
    "no_checks": (dict(VALIDATE, check_for_nan=False,
                       check_for_spike=False), [(NAN, 1.0), (1e9, 1.0)]),
    "inject_transient": (dict(VALIDATE, error_injection_rate=1.0),
                         [(1.0, 1.0), (1.0, 1.0)]),
    "inject_persistent": (dict(VALIDATE, error_injection_rate=1.0,
                               error_injection_type="persistent_error"),
                          [(1.0, 1.0)]),
    "inject_half": (dict(VALIDATE, error_injection_rate=0.5),
                    [(1.0, 1.0)] * 12),
    "stats_deterministic": (dict(enable=True, mode="report_stats"),
                            [(1.0 + i, 1.0 + i) for i in range(3)]),
    "stats_mismatch": (dict(enable=True, mode="report_stats"),
                       [(1.0, 1.001), (2.0, 2.0), (3.0, 3.5)]),
    "stats_nan": (dict(enable=True, mode="report_stats"),
                  [(NAN, NAN), (1.0, NAN), (2.0, 2.0)]),
    "stats_inject_persistent": (
        dict(enable=True, mode="report_stats", error_injection_rate=1.0,
             error_injection_type="persistent_error"), [(1.0, 1.0)]),
}


@pytest.mark.parametrize("case", sorted(RERUN_CASES))
def test_torch_rerun_machine_matches_jax(case):
    kw, seq = RERUN_CASES[case]
    want = _drive(JR, JS, kw, seq)
    got = _drive(TR, TS, kw, seq)
    assert _same(got, want)


def test_torch_rerun_exit_codes_and_state_roundtrip():
    assert (TR.EXIT_CODE_RESUME_TO_DISAMBIGUATE,
            TR.EXIT_CODE_FAILED_ON_RESULT_VALIDATION) == (16, 17)
    m = TR.RerunStateMachine(TS.RerunArgs(enable=True,
                                          mode="validate_results",
                                          spike_factor=5.0))
    for it in range(4):
        m.validate_result(2.0, it)
    m.validate_result(NAN, 4, rerun_fn=lambda: 2.0)
    sd = json.loads(json.dumps(m.state_dict(), allow_nan=False))
    # the port's state dict loads into the JAX machine and back
    j = JR.RerunStateMachine(JS.RerunArgs(enable=True,
                                          mode="validate_results",
                                          spike_factor=5.0))
    j.load_state_dict(sd)
    m2 = TR.RerunStateMachine(TS.RerunArgs(enable=True,
                                           mode="validate_results",
                                           spike_factor=5.0))
    m2.load_state_dict(j.state_dict())
    assert m2._ema == pytest.approx(m._ema)
    r = m2.records[0]
    assert r.diagnostic == TR.RerunDiagnostic.TRANSIENT_ERROR
    assert r.iteration == 4 and math.isnan(r.value)
    assert m2.validate_result(50.0, 5, rerun_fn=lambda: 50.0) == \
        TR.RerunDiagnostic.PERSISTENT_ERROR


def test_torch_rerun_data_iterator_replays_and_counts():
    it = TR.RerunDataIterator(iter(range(100)))
    assert next(it) == 0 and next(it) == 1
    it.rewind()
    assert next(it) == 0 and next(it) == 1
    with pytest.raises(StopIteration):
        next(it)  # the replay holds only this step's batches
    it.advance()
    assert next(it) == 2 and it.batches_consumed == 2
    it.rewind()
    next(it)
    it.advance()
    assert it.batches_consumed == 3  # a replay is not counted twice

    data = TR.RerunDataIterator(iter(range(100)))
    m = TR.RerunStateMachine(TS.RerunArgs(enable=True,
                                          mode="validate_results"))
    batch = next(data)
    seen = []

    def rerun():
        seen.append(next(data))  # the rewound iterator replays the batch
        return 1.0

    assert m.validate_result(NAN, 0, rerun_fn=rerun, data_iterator=data) \
        == TR.RerunDiagnostic.TRANSIENT_ERROR
    assert seen == [batch]


# -- runtime/supervisor.py: the in-process half -------------------------------


def test_torch_guard_traps_real_signals_and_restores_handlers():
    before = signal.getsignal(signal.SIGTERM)
    reg = TG.MetricsRegistry()
    with TV.PreemptionGuard(registry=reg) as g:
        assert not g.requested()
        signal.raise_signal(signal.SIGTERM)
        assert reg.counter("supervisor/preemption_signals",
                           sig="SIGTERM").value == 0  # not in the handler
        assert g.requested() and g.requested()
        assert g.exit_code() == TV.EXIT_CODE_CHECKPOINT_AND_EXIT == 18
    assert signal.getsignal(signal.SIGTERM) is before
    assert reg.counter("supervisor/preemption_signals",
                       sig="SIGTERM").value == 1
    with TV.PreemptionGuard() as g:
        signal.raise_signal(signal.SIGINT)
        assert g.exit_code() == TV.EXIT_CODE_INTERRUPTED == 130
    assert TV.RESTARTABLE_EXIT_CODES == JV.RESTARTABLE_EXIT_CODES == (16, 18)


def test_torch_guard_second_signal_escalates():
    hits = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: hits.append(s))
    try:
        with TV.PreemptionGuard() as g:
            signal.raise_signal(signal.SIGTERM)
            assert g.requested() and not hits
            signal.raise_signal(signal.SIGTERM)
            assert hits == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_torch_guard_disabled_and_rearmed():
    before = signal.getsignal(signal.SIGTERM)
    g = TV.PreemptionGuard(enabled=False)
    with g:
        assert signal.getsignal(signal.SIGTERM) is before
        g.request()  # a drill sets the flag programmatically
        assert g.requested()
        assert g.exit_code() == TV.EXIT_CODE_CHECKPOINT_AND_EXIT
    with g:
        assert not g.requested()  # a fresh loop starts clean


def _restarts(V, G, Y, seq, **kw):
    """run_with_restarts over a scripted sequence of attempt outcomes (an
    exit code, or an exception raised); returns the outcome, the attempts
    made, the sleeps and the registry counts."""
    reg = G.MetricsRegistry()
    seq = list(seq)
    sleeps, made = [], []

    def attempt():
        made.append(1)
        c = seq.pop(0)
        if isinstance(c, Exception):
            raise c
        return c

    progress = kw.pop("progress", None)
    world = kw.pop("world", None)
    try:
        rc = V.run_with_restarts(
            attempt, sleep=sleeps.append, log=lambda m: None, registry=reg,
            rng=random.Random(5),
            progress_fn=(None if progress is None else iter(progress)
                         .__next__),
            world_fn=None if world is None else iter(world).__next__, **kw)
    except Exception as e:  # noqa: BLE001 — compared by type and text
        rc = f"{type(e).__name__}: {e}"
    return rc, len(made), sleeps, _counts(reg)


def _crash(V, msg):
    return (JR if V is JV else TR).InjectedCrash(msg)


RESTART_CASES = {
    "disambiguate_then_ok": ([16, 16, 0], dict(max_restarts=3,
                                               base_delay=1.0)),
    "preempt_then_ok": ([18, 0], dict(max_restarts=2)),
    "failed_validation_terminal": ([17, 0], dict(max_restarts=3)),
    "interrupt_terminal": ([130, 0], dict(max_restarts=3)),
    "unknown_code_terminal": ([5, 0], dict(max_restarts=3)),
    "none_is_success": ([None], dict()),
    "budget_bounded": ([18] * 5, dict(max_restarts=2)),
    "progress_resets_budget": ([18] * 6 + [0], dict(
        max_restarts=2, progress=range(100))),
    "no_progress_exhausts": ([18] * 6 + [0], dict(
        max_restarts=2, progress=["s"] * 100)),
    "world_change_resets": ([18] * 6 + [0], dict(
        max_restarts=2, world=[8, 4, 4, 2, 2, 1, 1, 1, 1, 1])),
    "static_world_exhausts": ([18] * 6 + [0], dict(
        max_restarts=2, world=[8] * 10)),
    "code_17_after_world_change": ([17], dict(max_restarts=5,
                                              world=[8, 4, 4, 4])),
    "crash_restarts": (["crash:boom", 0], dict(max_restarts=2)),
    "crash_reraises_when_disabled": (["crash:boom", 0], dict(
        max_restarts=2, restart_on_error=False)),
    "crash_budget_reraises": (["crash:a", "crash:b", "crash:third"],
                              dict(max_restarts=2)),
    "backoff_capped": ([16] * 6 + [0], dict(max_restarts=9, base_delay=2.0,
                                            max_delay=3.0)),
}


@pytest.mark.parametrize("case", sorted(RESTART_CASES))
def test_torch_run_with_restarts_matches_jax(case):
    script, kw = RESTART_CASES[case]
    outs = []
    for V, G, Y in ((JV, JG, JY), (TV, TG, TY)):
        seq = [(_crash(V, c[6:]) if isinstance(c, str) else c)
               for c in script]
        outs.append(_restarts(V, G, Y, seq, **dict(kw)))
    assert outs[0] == outs[1]


DRILL_CASES = [
    (dict(inject_kind="nan", inject_at_iter=2), [(1.0, 0), (1.0, 1),
                                                 (1.0, 2), (1.0, 2)]),
    (dict(inject_kind="spike", inject_at_iter=0, inject_spike_scale=50.0),
     [(2.0, 0), (2.0, 0)]),
    (dict(inject_kind="spike", inject_at_iter=1), [(-3.0, 0), (-3.0, 1)]),
    (dict(inject_kind="none", inject_at_iter=0), [(float("inf"), 0)]),
    (dict(inject_kind="nan", inject_at_iter=-1), [(1.0, 0), (1.0, 1)]),
]


@pytest.mark.parametrize("kw,calls", DRILL_CASES)
@pytest.mark.parametrize("start", [0, 3])
def test_torch_fault_drill_matches_jax(kw, calls, start):
    outs = []
    for R, S, G in ((JR, JS, JG), (TR, TS, TG)):
        reg = G.MetricsRegistry()
        d = R.FaultDrill(S.RerunArgs(**kw), registry=reg)
        d.arm(start_iter=start)
        outs.append(([d.apply(v, it) for v, it in calls], _counts(reg)))
    assert _same(outs[0], outs[1])


def test_torch_fault_drill_crash_and_preempt():
    reg = TG.MetricsRegistry()
    d = TR.FaultDrill(TS.RerunArgs(inject_kind="crash", inject_at_iter=1),
                      registry=reg)
    assert d.apply(1.0, 0) == 1.0
    with pytest.raises(TR.InjectedCrash, match="iteration 1"):
        d.apply(1.0, 1)
    assert reg.counter("faults/injected", kind="crash").value == 1
    d = TR.FaultDrill(TS.RerunArgs(inject_kind="preempt", inject_at_iter=0),
                      registry=TG.MetricsRegistry())
    with TV.PreemptionGuard() as g:
        assert d.apply(1.0, 0) == 1.0  # the loss is untouched
        assert g.requested()  # a real SIGTERM reached the guard


# -- runtime/chaos.py ---------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(plan="corrupt_meta@4, crash@5, io_error"),
    dict(kind="sigterm", at_iter=3), dict(), dict(kind="kill_mid_save"),
    dict(plan="crash@1,crash@4"), dict(plan=" , hung_save@2 ,"),
    dict(kind="io_error", io_error_count=5, io_error_op="dataset",
         hang_s=9.0),
])
def test_torch_parse_plan_matches_jax(kw):
    want = JC.parse_plan(JS.ChaosArgs(enable=True, **kw))
    got = TC.parse_plan(TS.ChaosArgs(enable=True, **kw))
    assert [vars(f) for f in got] == [vars(f) for f in want]
    assert TC.FAULT_KINDS == JC.FAULT_KINDS and len(TC.FAULT_KINDS) == 8


def test_torch_parse_plan_rejects_unknown_kind_and_gates():
    with pytest.raises(ValueError, match="unknown kind"):
        TC.parse_plan(TS.ChaosArgs(enable=True, plan="crash@2,meltdown@3"))

    class A:
        chaos = TS.ChaosArgs()
        ckpt = TS.CheckpointArgs()

    assert TC.make_chaos(A()) is None  # not enabled
    A.chaos = TS.ChaosArgs(enable=True)
    assert TC.make_chaos(A()) is None  # enabled, empty plan


def _quiet(m):
    return None


def test_torch_chaos_markers_are_one_shot_across_attempts(tmp_path):
    cfg = TS.ChaosArgs(enable=True, kind="crash", at_iter=2)
    m1 = TC.ChaosMonkey(cfg, state_dir=str(tmp_path), log=_quiet)
    m1.on_step(0)
    m1.on_step(1)
    with pytest.raises(TC.ChaosCrash):
        m1.on_step(2)
    assert os.path.exists(tmp_path / "CHAOS_FIRED_0_crash")
    # the JAX harness reads the port's marker (one protocol) and the
    # relaunched port attempt trains through
    jm = JC.ChaosMonkey(JS.ChaosArgs(enable=True, kind="crash", at_iter=2),
                        state_dir=str(tmp_path), log=_quiet)
    assert jm.pending() == []
    m2 = TC.ChaosMonkey(cfg, state_dir=str(tmp_path), log=_quiet)
    assert m2.pending() == []
    for it in range(6):
        m2.on_step(it)
    # a multi-fault plan unfolds across attempts
    plan = TS.ChaosArgs(enable=True, plan="crash@1,crash@4")
    d = tmp_path / "plan"
    with pytest.raises(TC.ChaosCrash):
        TC.ChaosMonkey(plan, state_dir=str(d), log=_quiet).on_step(1)
    m3 = TC.ChaosMonkey(plan, state_dir=str(d), log=_quiet)
    assert m3.pending() == ["crash"]
    m3.on_step(3)
    with pytest.raises(TC.ChaosCrash):
        m3.on_step(4)


@pytest.mark.parametrize("kind", ["corrupt_meta", "truncate_meta"])
def test_torch_chaos_meta_faults_wait_for_a_commit(tmp_path, kind):
    cfg = TS.ChaosArgs(enable=True, kind=kind, at_iter=1)
    m = TC.ChaosMonkey(cfg, state_dir=str(tmp_path), log=_quiet)
    m.on_step(1)
    m.on_step(2)
    assert m.pending() == [kind]  # nothing to corrupt yet
    d = tmp_path / "step_3"
    os.makedirs(d)
    TP.atomic_write_json(str(d / "meta.json"), {"step": 3, "pad": "x" * 40})
    with open(d / TP.COMMIT_MARKER, "w") as f:
        f.write("ok")
    m.on_step(3)
    assert m.pending() == []
    meta, err = TP.try_read_meta(str(d))
    assert meta == {} and err is not None


def test_torch_chaos_io_faults_through_the_retry_seam(tmp_path):
    cfg = TS.ChaosArgs(enable=True, kind="io_error", io_error_count=2,
                       io_error_op="checkpoint")
    m = TC.ChaosMonkey(cfg, state_dir=str(tmp_path), log=_quiet)
    m.install()
    calls = []
    try:
        assert TY.retry_call(lambda: calls.append(1) or "ok", attempts=4,
                             op="checkpoint.read_meta",
                             sleep=lambda s: None) == "ok"
        assert len(calls) == 1  # two attempts eaten by the injection
        assert TY.retry_call(lambda: "ok", attempts=1, op="dataset.fetch",
                             sleep=lambda s: None) == "ok"
    finally:
        m.uninstall()
    assert m.pending() == []
    assert TY.retry_call(lambda: "ok", attempts=1,
                         op="checkpoint.read_meta",
                         sleep=lambda s: None) == "ok"
    gated = TC.ChaosMonkey(TS.ChaosArgs(enable=True, plan="io_error@3"),
                           state_dir=str(tmp_path / "g"), log=_quiet)
    gated.on_step(1)
    assert gated._io_fault("checkpoint.restore") is None
    gated.on_step(3)
    assert isinstance(gated._io_fault("checkpoint.restore"), OSError)


def test_torch_chaos_hung_save_hook_gated_by_step(tmp_path):
    cfg = TS.ChaosArgs(enable=True, kind="hung_save", at_iter=4, hang_s=0.2)
    m = TC.ChaosMonkey(cfg, state_dir=str(tmp_path), log=_quiet)
    hook = m.save_hooks()["before_commit"]
    t0 = time.monotonic()
    hook(str(tmp_path / "step_2.tmp"))
    assert time.monotonic() - t0 < 0.15
    assert m.pending() == ["hung_save"]
    hook(str(tmp_path / "step_4.tmp"))
    assert time.monotonic() - t0 >= 0.2
    assert m.pending() == []
