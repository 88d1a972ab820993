"""The port's observability layer against the JAX package's, module by
module: the JSONL sink and the registry's records, ``TrainingTelemetry``
(fed the same metric stream at the same clock), the FLOPs count of every
shipped config, the plan event, goodput, the flight recorder, the
Prometheus text and the HTTP endpoint, the trace attribution, and
``cli/summarize.py`` of either package over the port's stream. These
modules are host arithmetic, so equal means equal (records compare
without their wall-clock ``t``)."""

import glob
import json
import os
import sys
import urllib.request

import pytest

from hetu_galvatron_tpu.core import arguments as JA
from hetu_galvatron_tpu.observability import goodput as JGP
from hetu_galvatron_tpu.observability import prometheus as JPR
from hetu_galvatron_tpu.observability import recorder as JRC
from hetu_galvatron_tpu.observability import registry as JG
from hetu_galvatron_tpu.observability import sinks as JSK
from hetu_galvatron_tpu.observability import telemetry as JT
from hetu_galvatron_tpu_torch.cli import summarize as TSUM
from hetu_galvatron_tpu_torch.cli import supervise as TCLI
from hetu_galvatron_tpu_torch.cli import train_dist
from hetu_galvatron_tpu_torch.core.arguments import load_config
from hetu_galvatron_tpu_torch.observability import goodput as TGP
from hetu_galvatron_tpu_torch.observability import prometheus as TPR
from hetu_galvatron_tpu_torch.observability import recorder as TRC
from hetu_galvatron_tpu_torch.observability import registry as TG
from hetu_galvatron_tpu_torch.observability import sinks as TSK
from hetu_galvatron_tpu_torch.observability import telemetry as TT
from hetu_galvatron_tpu_torch.observability import trace_analysis as TA
from hetu_galvatron_tpu_torch.runtime import supervisor as TV

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs")
GPT2 = os.path.join(CONFIGS, "gpt2-small.yaml")
TINY = ["device=cpu", "model.hidden_size=64", "model.num_hidden_layers=2",
        "model.num_attention_heads=4", "model.vocab_size=128",
        "model.seq_length=16", "model.max_position_embeddings=32",
        "model.make_vocab_size_divisible_by=1", "train.train_iters=4",
        "parallel.mixed_precision=fp32", "parallel.global_train_batch_size=4",
        "train.lr=1e-3"]


def _records(path):
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "t"}
                for line in f if line.strip()]


def _drive(G, SK, path):
    """The same registry operations through one package's sink."""
    reg = G.MetricsRegistry([SK.JsonlSink(path), SK.NullSink()])
    reg.counter("train/steps").inc()
    reg.counter("retry/attempts", op="save").inc(2)
    reg.gauge("train/loss").set(3.5)
    h = reg.histogram("span_ms", path="train/step")
    for v in (1.0, 4.0, 2.5, 8.0):
        h.observe(v)
    reg.event("plan", {"chunks": 2, "layers": [{"layer": 0}]}, step=3)
    reg.flush(step=3)
    reg.gauge("train/loss").set(3.25)
    reg.close(step=4)
    return reg


# -- sinks.py and the registry's records ------------------------------------


def test_torch_jsonl_sink_writes_the_jax_records(tmp_path):
    _drive(JG, JSK, str(tmp_path / "j.jsonl"))
    _drive(TG, TSK, str(tmp_path / "t.jsonl"))
    want, got = _records(tmp_path / "j.jsonl"), _records(tmp_path / "t.jsonl")
    assert got == want and len(got) == 9
    assert {r["kind"] for r in got} == {"counter", "gauge", "histogram",
                                        "event"}
    # a sink with nothing to write leaves no file behind
    TSK.JsonlSink(str(tmp_path / "none.jsonl")).close()
    assert not (tmp_path / "none.jsonl").exists()


# -- telemetry.py ------------------------------------------------------------


def _telemetry_stream(T, G, SK, path, monkeypatch, metrics):
    ticks = iter([0.0, 0.11, 0.23, 0.30, 0.52, 0.61, 0.75, 0.91, 1.2])
    monkeypatch.setattr(T.time, "perf_counter", lambda: next(ticks))
    cfg = load_config(GPT2, TINY).model if T is TT else JA.load_config(
        GPT2, [a for a in TINY if a != "device=cpu"]).model
    reg = G.MetricsRegistry([SK.JsonlSink(path)])
    tel = T.TrainingTelemetry(reg, model=cfg, global_batch_size=4,
                              seq_length=16, peak_tflops_per_device=100.0,
                              flush_interval=3, window=4)
    for it, m in enumerate(metrics):
        if it == 5:
            tel.global_batch_size = 8  # a ramp's running batch size
        tel(it, m)
    tel.close()
    monkeypatch.undo()
    return tel


THROUGHPUT = ("train/tokens_per_sec", "train/model_tflops", "train/mfu")


def test_torch_training_telemetry_matches_jax(tmp_path, monkeypatch):
    """The same metric stream at the same host clock: the same record
    names, labels and values, flush for flush (the port's loop hands host
    floats; the lagged drain converts one flush late as in JAX). The
    throughput gauges differ from JAX's only while the window spans the
    ramp's batch change: the port counts each step at its own batch size,
    where JAX counts every step at the current one."""
    metrics = [{"loss": 5.0 - 0.1 * i, "grad_norm": 1.0 + 0.01 * i,
                "ignored": 7} for i in range(8)]
    tj = _telemetry_stream(JT, JG, JSK, str(tmp_path / "j.jsonl"),
                           monkeypatch, metrics)
    tt = _telemetry_stream(TT, TG, TSK, str(tmp_path / "t.jsonl"),
                           monkeypatch, metrics)
    want = [r for r in _records(tmp_path / "j.jsonl")
            if r["name"] != "device/mem_mb"]
    got = _records(tmp_path / "t.jsonl")
    assert [dict(r, value=None) for r in got] == \
        [dict(r, value=None) for r in want]
    assert [r for r in got if r["name"] not in THROUGHPUT] == \
        [r for r in want if r["name"] not in THROUGHPUT]
    # flushes after steps 2, 5 and 7 (close), window 4, batch 4 then 8 from
    # step 5, seq 16, the hook clock ticking 0, .11, .23, .30, .52, .61,
    # .75, .91
    tps = [2 * 4 * 16 / 0.23, (4 + 4 + 8) * 16 / (0.61 - 0.23),
           3 * 8 * 16 / (0.91 - 0.52)]
    jax_tps = [tps[0], 3 * 8 * 16 / (0.61 - 0.23), tps[2]]
    got_tps = [r["value"] for r in got if r["name"] == THROUGHPUT[0]]
    assert got_tps == pytest.approx(tps, rel=1e-12)
    assert [r["value"] for r in want if r["name"] == THROUGHPUT[0]] == \
        pytest.approx(jax_tps, rel=1e-12)
    fpt = tt.flops_per_token
    assert [r["value"] for r in got if r["name"] == "train/model_tflops"] \
        == pytest.approx([t * fpt / 1e12 for t in tps], rel=1e-12)
    assert [r["value"] for r in got if r["name"] == "train/mfu"] == \
        pytest.approx([t * fpt / 100e12 for t in tps], rel=1e-12)
    names = {r["name"] for r in got}
    assert {"train/step_time_ms", "train/tokens_per_sec",
            "train/model_tflops", "train/mfu", "train/loss",
            "train/grad_norm", "train/steps", "train/tokens"} <= names
    assert tt.flops_per_token == tj.flops_per_token
    assert tt.peak_flops == tj.peak_flops == 100e12


def test_torch_telemetry_resume_counts_match_jax():
    for T, G in ((JT, JG), (TT, TG)):
        reg = G.MetricsRegistry()
        tel = T.TrainingTelemetry(reg, global_batch_size=4, seq_length=16)
        tel.resume_from(5, samples=12)
        tel.resume_from(0)
        assert reg.counter("train/steps").value == 5
        assert reg.counter("train/tokens").value == 12 * 16


@pytest.mark.parametrize("yaml", sorted(
    os.path.basename(p) for p in glob.glob(os.path.join(CONFIGS, "*.yaml"))))
def test_torch_flops_per_token_matches_the_jax_cost_model(yaml):
    """``telemetry.model_flops_per_token`` equals JAX
    ``core/cost_model/cost.py::model_flops_per_token`` for every shipped
    config, at the config's and at another sequence length."""
    from hetu_galvatron_tpu.core.cost_model.cost import (
        model_flops_per_token as jflops,
    )

    path = os.path.join(CONFIGS, yaml)
    jcfg, tcfg = JA.load_config(path, []).model, load_config(path, []).model
    assert TT.model_flops_per_token(tcfg) == jflops(jcfg)
    assert TT.model_flops_per_token(tcfg, 4096) == jflops(jcfg, 4096)


def test_torch_builder_flops_is_the_bench_formula_not_the_cost_model():
    """``models/builder.model_flops_per_token`` is the JAX builder's (the
    bench's numerator), which counts one dense MLP a MoE layer and the
    decoder stack of a t5 model alone: below the cost model's count for
    Mixtral and T5, equal to it for the dense decoders."""
    from hetu_galvatron_tpu.models import builder as JB
    from hetu_galvatron_tpu_torch.models import builder as TB

    for yaml, below in (("mixtral-8x7b.yaml", True), ("t5-3b.yaml", True),
                        ("qwen2.5-7b.yaml", False)):
        path = os.path.join(CONFIGS, yaml)
        jcfg, tcfg = JA.load_config(path, []).model, load_config(
            path, []).model
        assert TB.model_flops_per_token(tcfg) == JB.model_flops_per_token(
            jcfg)
        cost = TT.model_flops_per_token(tcfg)
        assert (TB.model_flops_per_token(tcfg) < cost) is below
        assert TB.model_flops_per_token(tcfg) <= cost


def test_torch_peak_tflops_by_device_name(monkeypatch):
    assert TT.peak_device_tflops("NVIDIA H100 80GB HBM3") == 989.0
    assert TT.peak_device_tflops("NVIDIA H100 SXM5 80GB") == 989.0
    assert TT.peak_device_tflops("NVIDIA H100 PCIe") == 756.0
    for unknown in ("NVIDIA A100-SXM4-80GB", "cpu", "", None):
        assert TT.peak_device_tflops(unknown) is None
    # an unknown card and no override: MFU is skipped
    monkeypatch.setattr(TT, "_device_kind", lambda: "NVIDIA A100-SXM4-80GB")
    reg = TG.MetricsRegistry()
    tel = TT.TrainingTelemetry(reg, model=load_config(GPT2, TINY).model,
                               global_batch_size=4, seq_length=16)
    assert tel.peak_flops == 0.0
    tel(0, {"loss": 1.0})
    tel(1, {"loss": 1.0})
    tel.close()
    assert not [m for m in reg.metrics() if m.name == "train/mfu"]
    assert TT.device_memory_mb() is None  # no CUDA context on the CPU


def test_torch_plan_event_matches_jax_at_world_one():
    from hetu_galvatron_tpu.runtime import hybrid_config as JH
    from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH

    over = [a for a in TINY if a != "device=cpu"] + [
        "parallel.chunks=2", "parallel.global_checkpoint=1",
        "parallel.num_devices=1"]
    events = []
    for T, G, H, args in (
            (JT, JG, JH, JA.load_config(GPT2, over)),
            (TT, TG, TH, load_config(GPT2, ["device=cpu", *over]))):
        seen = []

        class Sink:
            write, flush, close = seen.append, (lambda: 0), (lambda: 0)

        hpc = H.get_hybrid_parallel_config(args, 1)
        T.emit_plan_telemetry(G.MetricsRegistry([Sink()]), hpc, args.model)
        events.append([{k: v for k, v in r.items() if k != "t"}
                       for r in seen])
    assert events[1] == events[0]
    assert events[1][0]["data"]["predicted_comm_mb_per_step"] == 0.0


# -- goodput.py --------------------------------------------------------------


def _tracker(G, walls):
    it = iter(walls)
    clock = iter([0.0, 2.5, 3.0, 3.25])
    return G.GoodputTracker(clock=lambda: next(clock),
                            wall=lambda: next(it))


@pytest.mark.parametrize("src,dst", [(TGP, JGP), (JGP, TGP)])
def test_torch_goodput_state_round_trips_between_packages(src, dst):
    a = _tracker(src, [1000.0])
    a.add("productive_step", 4.0)
    a.add("recompile", 1.5)
    a.add("checkpoint_save", -1.0)  # non-positive: ignored
    with a.measure("checkpoint_save"):
        pass
    with a.measure("resume_replay"):
        pass
    state = json.loads(json.dumps(a.state_dict()))
    b = _tracker(dst, [1010.0])
    b.load_state_dict(state)
    assert b.restarts_survived == 1
    assert b.totals == dict(a.totals, restart_lost=10.0)
    assert dst.CATEGORIES == src.CATEGORIES
    reg_a, reg_b = TG.MetricsRegistry(), JG.MetricsRegistry()
    b.flush(reg_a)
    b.flush(reg_b)
    snap = [{(m.name, m.value) for m in r.metrics()} for r in (reg_a, reg_b)]
    assert snap[0] == snap[1]
    assert b.goodput() == pytest.approx(4.0 / b.total())


def test_torch_checkpoint_goodput_loads_into_the_jax_tracker(tmp_path):
    """A port run's ``meta.json`` ``train_state["goodput"]`` restores into
    JAX's tracker: the port's totals as of the commit, plus the gap."""
    out = train_dist.train(load_config(GPT2, TINY + [
        f"ckpt.save={tmp_path}", "ckpt.save_interval=4"]))
    with open(tmp_path / "step_4" / "meta.json") as f:
        ts = json.load(f)["train_state"]
    gp = ts["goodput"]
    assert set(gp) == {"totals", "wall_time", "restarts_survived"}
    assert gp["totals"]["recompile"] > 0
    assert gp["totals"]["productive_step"] > 0
    j = JGP.GoodputTracker(wall=lambda: gp["wall_time"] + 2.0)
    j.load_state_dict(gp)
    assert j.restarts_survived == 1
    assert j.totals["restart_lost"] == pytest.approx(
        gp["totals"]["restart_lost"] + 2.0)
    assert j.totals["productive_step"] == gp["totals"]["productive_step"]
    # the run's own totals also hold the saves booked after the commit's
    # snapshot and the final drain
    assert out["goodput"]["totals"]["checkpoint_save"] > 0


# -- recorder.py -------------------------------------------------------------


def _dump(R, G, d):
    reg = G.MetricsRegistry()
    reg.counter("train/steps").inc(3)
    reg.histogram("span_ms", path="train/step").observe(2.0)
    rec = R.FlightRecorder(registry=reg, out_dir=str(d), capacity=2)
    for i in range(3):
        rec.note("step", it=i)
    try:
        raise ValueError("boom")
    except ValueError as e:
        path = rec.dump("crash", exc=e)
    with open(path) as f:
        return rec, json.load(f)


def test_torch_flight_dump_schema_matches_jax(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    _, want = _dump(JRC, JG, tmp_path / "j")
    rec, got = _dump(TRC, TG, tmp_path / "t")
    assert got.keys() == want.keys()
    assert got["exception"].keys() == want["exception"].keys()
    for key in ("kind", "reason", "metrics", "retained"):
        assert got[key] == want[key]
    assert [e["data"]["it"] for e in got["events"]] == [1, 2]  # the ring
    assert [e["name"] for e in got["events"]] == [
        e["name"] for e in want["events"]]
    assert rec.dumped and not glob.glob(str(tmp_path / "t" / "*.tmp"))


def test_torch_flight_dump_is_atomic_and_never_raises(tmp_path,
                                                      monkeypatch):
    rec = TRC.FlightRecorder(out_dir=str(tmp_path))

    def torn(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(TRC.json, "dump", torn)
    assert rec.dump("crash") is None
    assert isinstance(rec.last_error, OSError)
    assert os.listdir(tmp_path) == [] or all(
        p.endswith(".tmp") for p in os.listdir(tmp_path))
    monkeypatch.undo()
    assert TRC.FlightRecorder().dump("crash") is None  # no directory


def test_torch_crash_dump_keeps_the_original_exception(tmp_path):
    """A crash drill inside ``train_dist.train``: the InjectedCrash
    surfaces untouched and the flight dump records it, reason
    ``crash``; JAX's and the port's summarize read the dump alike."""
    from hetu_galvatron_tpu.cli import summarize as JSUM
    from hetu_galvatron_tpu_torch.runtime.rerun_machine import InjectedCrash

    args = load_config(GPT2, TINY + [f"observability.flight_dir={tmp_path}",
                                     "rerun.inject_kind=crash",
                                     "rerun.inject_at_iter=1"])
    with pytest.raises(InjectedCrash):
        train_dist.train(args)
    dumps = glob.glob(str(tmp_path / "flight_*.json"))
    assert len(dumps) == 1
    with open(dumps[0]) as f:
        dump = json.load(f)
    assert dump["reason"] == "crash"
    assert dump["exception"]["type"] == "InjectedCrash"
    assert [e["name"] for e in dump["events"]] == ["run_start"]
    with open(os.devnull, "w") as null:
        assert TSUM.summarize(dumps[0], out=null) == JSUM.summarize(
            dumps[0], out=null)


def test_torch_signal_dump_happens_at_the_step_boundary(tmp_path):
    rec = TRC.FlightRecorder(out_dir=str(tmp_path))
    guard = TV.PreemptionGuard(recorder=rec, registry=TG.MetricsRegistry())
    with guard:
        guard.request(signum=15)  # what the handler does: a flag only
        assert not rec.dumped
        assert guard.requested() and guard.requested()
    assert len(rec.dumped) == 1
    with open(rec.dumped[0]) as f:
        assert json.load(f)["reason"] == "signal:SIGTERM"


# -- prometheus.py and the supervisor's endpoint -----------------------------


def test_torch_prometheus_text_matches_jax():
    texts = []
    for G, P in ((JG, JPR), (TG, TPR)):
        reg = G.MetricsRegistry()
        reg.counter("supervisor/restarts", code=18).inc()
        reg.gauge("train/tokens_per_sec").set(1234.5)
        reg.gauge("weird name/x", label='a"b').set(1)
        h = reg.histogram("span_ms", path="train/step")
        for v in range(10):
            h.observe(v)
        texts.append(P.prometheus_text(reg))
    assert texts[1] == texts[0]
    assert "supervisor_restarts_total{code=\"18\"} 1.0" in texts[1]
    assert TPR.sanitize_name("1a/b") == JPR.sanitize_name("1a/b")


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.status, r.read().decode()


def test_torch_healthz_and_metrics_answer_on_an_ephemeral_port(tmp_path):
    """The supervisor's endpoint: ``/healthz`` merges the supervisor's
    health, ``/metrics`` carries its own series and the last value of each
    series the children flushed to the shared stream, once each."""
    stream = tmp_path / "m.jsonl"
    child = TG.MetricsRegistry([TSK.JsonlSink(str(stream))])
    child.gauge("train/tokens_per_sec").set(99.0)
    child.histogram("train/step_time_ms").observe(5.0)
    child.flush(step=1)
    child.gauge("train/tokens_per_sec").set(101.0)
    child.flush(step=2)
    with open(stream, "a") as f:
        f.write('{"kind": "gauge", "name": "torn"')  # a torn last line
    own = TG.MetricsRegistry([TSK.JsonlSink(str(stream))])
    sup = TV.ProcessSupervisor(lambda st: [sys.executable, "-c", "0"],
                               registry=own, log=lambda m: None)
    own.counter("supervisor/spawns").inc()
    own.flush()  # the supervisor's own series also reach the stream
    server = TPR.MetricsHTTPServer(
        registry=TCLI.StreamMirror(own, str(stream)), port=0,
        health_fn=sup.health)
    port = server.start()
    try:
        assert port > 0
        code, body = _get(f"http://127.0.0.1:{port}/healthz")
        health = json.loads(body)
        assert code == 200 and health["status"] == "ok"
        assert health["supervisor_attempt"] == 0
        assert health["last_child_exit_code"] is None
        code, text = _get(f"http://127.0.0.1:{port}/metrics")
        assert code == 200
        lines = [l for l in text.splitlines() if not l.startswith("#")]
        assert "train_tokens_per_sec 101.0" in lines
        assert sum(l.startswith("supervisor_spawns_total") for l in lines) \
            == 1
        assert any(l.startswith("train_step_time_ms_count") for l in lines)
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://127.0.0.1:{port}/nope")
    finally:
        server.stop()
        server.stop()  # idempotent


def test_torch_process_supervisor_dumps_each_abnormal_child_exit(tmp_path):
    codes = iter([18, 0])
    rec = TRC.FlightRecorder(out_dir=str(tmp_path),
                             prefix="flight_supervisor")
    sup = TV.ProcessSupervisor(
        lambda st: [sys.executable, "-c",
                    f"import sys; sys.exit({next(codes)})"],
        base_delay=0.0, max_delay=0.0, poll_interval=0.02,
        sleep=lambda s: None, log=lambda m: None,
        registry=TG.MetricsRegistry(), recorder=rec)
    assert sup.run() == 0
    assert sup.state.attempt == 2
    assert len(rec.dumped) == 1
    with open(rec.dumped[0]) as f:
        dump = json.load(f)
    assert dump["reason"] == "child_exit_18"
    assert dump["events"][-1]["data"]["code"] == 18


# -- trace_analysis.py -------------------------------------------------------


def _ev(name, cat, ts, dur, pid=1, tid=7):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


def test_torch_attribute_a_hand_built_trace(tmp_path):
    """Two steps on one stream: exact steps, wall, busy, bubble,
    categories and launches; spans by host path and on the device."""
    dev = dict(pid=0, tid=7)
    host = dict(pid=100, tid=100)
    events = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        _ev("train/step", "user_annotation", 0, 400, **host),
        _ev("train/fetch", "user_annotation", 0, 50, **host),
        _ev("train/step", "user_annotation", 500, 400, **host),
        _ev("train/step", "gpu_user_annotation", 100, 300, **dev),
        _ev("train/step", "gpu_user_annotation", 600, 350, **dev),
        _ev("void flash_fwd_kernel_tc<128, __nv_bfloat16>(Params)",
            "kernel", 100, 100, **dev),
        _ev("ampere_sgemm_128x64_nn", "kernel", 200, 50, **dev),
        _ev("ce_bwd_kernel", "kernel", 300, 100, **dev),
        _ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 600, 50,
            **dev),
        _ev("multi_tensor_apply_kernel", "kernel", 650, 200, **dev),
        _ev("ncclDevKernel_AllReduce_Sum_f32_RING_LL", "kernel", 850, 100,
            **dev),
        _ev("aten::mm", "cpu_op", 0, 10, **host),  # host ops: neither
        {"ph": "X", "name": "no dur", "cat": "kernel", "ts": 0, **dev},
    ]
    run = tmp_path / "plugins" / "profile" / "2026_01_01_00_00_00"
    run.mkdir(parents=True)
    with open(run / "host.pt.trace.json", "w") as f:
        json.dump({"traceEvents": events}, f)
    with open(run / "torn.trace.json", "w") as f:
        f.write('{"traceEvents": [')
    tr = TA.load_trace(str(tmp_path))
    assert tr.process_names == {0: "GPU 0"}
    a = TA.attribute(tr)
    assert a.steps == 2 and a.tracks == 1
    assert a.wall_ms == pytest.approx(0.85)
    assert a.per_device_busy_ms == pytest.approx(0.6)
    assert a.bubble_ms == pytest.approx(0.25)
    assert a.bubble_frac == pytest.approx(0.25 / 0.85)
    assert a.categories_ms == pytest.approx({
        "flash_fwd": 0.1, "matmul": 0.05, "ce_bwd": 0.1, "copy": 0.05,
        "optimizer": 0.2, "allreduce": 0.1})
    assert a.category_launches == {"flash_fwd": 1, "matmul": 1, "ce_bwd": 1,
                                   "copy": 1, "optimizer": 1, "allreduce": 1}
    assert a.collective_ms == pytest.approx(0.1)
    assert a.compute_ms == pytest.approx(0.5)
    assert a.host_span_ms == pytest.approx({"train/step": 0.8,
                                            "train/step/train/fetch": 0.05})
    # device time under the device-side step ranges: 250 + 350 µs
    assert a.device_annotation_ms == pytest.approx({"train/step": 0.6})
    with pytest.raises(FileNotFoundError):
        TA.load_trace(str(tmp_path / "empty"))
    assert TA.attribute(TA.TraceData([])).steps == 0


def test_torch_op_category_names():
    cases = {"flash_bwd_dkdv_kernel_tc<64>": "flash_bwd_dkdv",
             "flash_bwd_dq_kernel": "flash_bwd_dq",
             "ce_fwd_kernel": "ce_fwd",
             "sm90_xmma_gemm_bf16bf16": "matmul",
             "void at::native::vectorized_elementwise_kernel": "elementwise",
             "void at::native::reduce_kernel<512>": "norm_reduce",
             "ncclDevKernel_ReduceScatter_Sum_bf16_RING_LL": "reducescatter",
             "ncclKernel_AllGather_RING_LL": "allgather",
             "ncclDevKernel_SendRecv": "p2p",
             "some_custom_kernel": "other"}
    for name, cat in cases.items():
        assert TA.op_category(name) == cat, name


def test_torch_real_cpu_trace_of_a_tiny_run_attributes_two_steps(tmp_path):
    """``profile.trace_dir`` over iterations 1-2 of a 4-step CPU run: the
    torch.profiler export loads and its ``train/step`` spans count 2
    steps; the traced iterations stay out of the timing samples."""
    out = train_dist.train(load_config(GPT2, TINY + [
        f"profile.trace_dir={tmp_path}", "observability.audit=false",
        "profile.profile=1", "profile.profile_warmup=1",
        "profile.trace_iters=2"]))
    assert out["trace_path"].startswith(str(tmp_path))
    a = TA.attribute(TA.load_trace(str(tmp_path)))
    assert a.steps == 2
    assert a.host_span_ms["train/step"] > 0
    assert "train/fetch" in a.host_span_ms


# -- cli/summarize.py --------------------------------------------------------


def test_torch_jax_summarize_reads_the_port_stream(tmp_path, capsys):
    """A telemetry-enabled port run (ramp, a cadence save, the spans): JAX's
    ``cli/summarize.py`` reads its stream and prints the same headline
    numbers as the port's."""
    from hetu_galvatron_tpu.cli import summarize as JSUM

    stream = tmp_path / "m.jsonl"
    out = train_dist.train(load_config(GPT2, TINY + [
        "train.train_iters=5", "parallel.chunks=2",
        "train.rampup_batch_size=[2,2,4]", "observability.enabled=true",
        f"observability.metrics_path={stream}",
        "observability.flush_interval=2", f"ckpt.save={tmp_path / 'ck'}",
        "ckpt.save_interval=2", "profile.profile=1"]))
    assert out["batch_sizes"] == [2, 2, 4, 4, 4]
    assert TG.get_registry().sinks == []  # the default registry is back
    with open(os.devnull, "w") as null:
        want = JSUM.summarize(str(stream), out=null)
    capsys.readouterr()
    got = TSUM.summarize(str(stream))
    text = capsys.readouterr().out
    assert got == want
    assert got["steps"] == 5 and got["tokens"] == 16 * 16
    assert {"step_time_p50_ms", "tokens_per_sec", "goodput_frac",
            "goodput/productive_step_s", "goodput/checkpoint_save_s"} <= \
        set(got)
    for line in ("-- goodput --", "-- spans (host ms) --", "train/fetch",
                 "train/step", "checkpoint/saved"):
        assert line in text
    assert TSUM.main([]) == 2 and TSUM.main(["--timeline"]) == 2


@pytest.mark.parametrize("over", [
    ["parallel.pp_deg=2", "parallel.num_devices=2", "parallel.chunks=2"],
    ["parallel.pp_deg=2", "parallel.num_devices=2", "parallel.chunks=4",
     "parallel.virtual_pp_deg=2", "parallel.mixed_precision=fp32"]])
def test_torch_plan_event_matches_jax_for_pp_plans(over):
    """Under pp at one rank a stage, each layer carries JAX's pipeline
    term (the activation and its cotangent of every microbatch)."""
    from hetu_galvatron_tpu.runtime import hybrid_config as JH
    from hetu_galvatron_tpu_torch.runtime import hybrid_config as TH

    over = [a for a in TINY if a != "device=cpu"] + [
        "model.num_hidden_layers=4"] + over
    events = []
    for T, G, H, args in (
            (JT, JG, JH, JA.load_config(GPT2, over)),
            (TT, TG, TH, load_config(GPT2, ["device=cpu", *over]))):
        seen = []

        class Sink:
            write, flush, close = seen.append, (lambda: 0), (lambda: 0)

        hpc = H.get_hybrid_parallel_config(args, 2)
        T.emit_plan_telemetry(G.MetricsRegistry([Sink()]), hpc, args.model,
                              mixed_precision=(
                                  args.parallel.mixed_precision != "fp32"))
        events.append([{k: v for k, v in r.items() if k != "t"}
                       for r in seen])
    assert events[1] == events[0]
    assert events[1][0]["data"]["predicted_comm_mb_per_step"] > 0
