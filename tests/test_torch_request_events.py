"""Request-lifecycle events through the port's serving engine
(``observability/events.py``, ``serving/engine.py``) and the port's
``cli/summarize.py`` serving half, against the JAX package on the CPU.

The port engine's metrics stream carries complete timelines (submit ...
retire, stamps in order) and the additive TTFT split; JAX's
``request_timelines`` / ``timeline_complete`` / ``ttft_components`` read
the port's stream to the same result as the port's, and ``summarize
--timeline`` prints the same text from both packages over the same
records. The event stream itself emits JAX's records for the same calls.
"""

import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from hetu_galvatron_tpu.cli import summarize as JSUM
from hetu_galvatron_tpu.observability import events as JEV
from hetu_galvatron_tpu.observability.registry import (
    MetricsRegistry as JMetricsRegistry,
)
from hetu_galvatron_tpu_torch.cli import summarize as TSUM
from hetu_galvatron_tpu_torch.core.args_schema import ModelArgs, ServingArgs
from hetu_galvatron_tpu_torch.models import builder as TB
from hetu_galvatron_tpu_torch.observability import events as TEV
from hetu_galvatron_tpu_torch.observability.registry import MetricsRegistry
from hetu_galvatron_tpu_torch.observability.sinks import JsonlSink
from hetu_galvatron_tpu_torch.serving.engine import ServingEngine

CFG = ModelArgs(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                vocab_size=128, max_position_embeddings=128, seq_length=32,
                hidden_act="swiglu", normalization="rmsnorm",
                position_embedding_type="rope", tie_word_embeddings=False,
                add_bias_linear=False, make_vocab_size_divisible_by=1,
                ffn_hidden_size=128)


@pytest.fixture(scope="module")
def params():
    return TB.init_causal_lm(CFG, seed=0)


def _traced_engine(tmp_path, params, **sv_kw):
    metrics_path = str(tmp_path / "serve_metrics.jsonl")
    reg = MetricsRegistry([JsonlSink(metrics_path)])
    sv = ServingArgs(**dict(dict(max_batch_size=4, kv_block_size=8,
                                 max_seq_len=48, max_new_tokens=8,
                                 trace_requests=True, slo_ttft_ms=60_000.0,
                                 slo_itl_ms=60_000.0, flush_interval=4),
                            **sv_kw))
    eng = ServingEngine(params, CFG, sv, registry=reg,
                        compute_dtype=torch.float32)
    return eng, reg, metrics_path


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_torch_complete_timelines_and_additive_ttft_split(tmp_path,
                                                          params):
    eng, reg, path = _traced_engine(tmp_path, params, prefix_cache=True,
                                    spec_decode=True, spec_k=2)
    eng.warmup(buckets=[8, 16])
    rng = np.random.default_rng(0)
    shared = rng.integers(0, 128, 16).tolist()
    reqs = [(rng.integers(0, 128, n).tolist(), m)
            for n, m in [(3, 4), (9, 6), (13, 5), (1, 8), (7, 3)]]
    reqs += [(shared + [1, 2], 5), (shared + [3], 5), (list(shared), 4)]
    handles = []
    for p, m in reqs:
        handles.append(eng.submit(p, max_new_tokens=m))
        eng.step()
    eng.run_until_idle()
    eng.close()
    reg.close()
    assert all(h.status == "done" for h in handles)
    assert handles[-1].cached_tokens == 16  # the fully cached prompt

    records = _records(path)
    timelines, bad = TSUM.request_timelines(records)
    assert bad == 0
    assert set(timelines) == {h.request.rid for h in handles}
    for rid, evs in timelines.items():
        assert TSUM.timeline_complete(evs), (rid, [e["ev"] for e in evs])
        names = [e["ev"] for e in evs]
        assert names[:2] == ["submit", "admit"] and "first_token" in names
        assert evs[-1]["status"] == "done"
    comp = TSUM.ttft_components(timelines)
    assert len(comp["ttft"]) == len(handles)
    for q, p, d, t in zip(comp["queue"], comp["prefill"],
                          comp["first_decode"], comp["ttft"]):
        assert q + p + d == pytest.approx(t, abs=1e-6)
    by_rid = {h.request.rid: h for h in handles}
    for rid, evs in timelines.items():
        ft = next(e for e in evs if e["ev"] == "first_token")
        assert ft["ttft_ms"] == pytest.approx(
            by_rid[rid].ttft_s() * 1000.0, rel=0.05, abs=0.5)
    # JAX's readers find the same timelines in the port's stream
    jtl, jbad = JSUM.request_timelines(records)
    assert (jtl, jbad) == (timelines, bad)
    assert all(JSUM.timeline_complete(e) for e in jtl.values())
    assert JSUM.ttft_components(jtl) == comp
    qw = [r for r in records if r.get("name") == "serve/queue_wait_ms"]
    assert qw[-1]["count"] == len(handles)

    # summarize --timeline: the same text from both packages
    texts = []
    for mod in (TSUM, JSUM):
        buf = io.StringIO()
        head = mod.summarize(path, out=buf, timeline="all")
        texts.append((buf.getvalue(), head))
    assert texts[0] == texts[1]
    text, head = texts[0]
    assert head["requests_traced"] == head["timelines_complete"] == 8
    for line in ("-- serving --", "TTFT breakdown", "first_decode",
                 "-- request timelines --", "prefix hit rate",
                 "spec accept rate", "SLO"):
        assert line in text
    one = io.StringIO()
    TSUM.summarize(path, out=one, timeline=str(handles[0].request.rid))
    assert f"request {handles[0].request.rid} (" in one.getvalue()
    assert TSUM.main([path, "--timeline", "all"]) == 0


def test_torch_event_stream_emits_jax_records():
    """The same calls give JAX's records (apart from the clock), taps
    included, and a raising tap is counted, never raised."""
    outs = []
    for EV, Reg in ((TEV, MetricsRegistry), (JEV, JMetricsRegistry)):
        class Sink:
            def __init__(self):
                self.recs = []

            def write(self, rec):
                self.recs.append(rec)

            def flush(self):
                pass

            def close(self):
                pass

        sink = Sink()
        es = EV.EventStream(Reg([sink]), enabled=True)
        seen = []
        es.add_tap(lambda name, d: seen.append((name, dict(d))))
        es.add_tap(lambda name, d: 1 / 0)
        es.emit("submit", 3, prompt_len=4, max_new=2)
        es.emit("weight_swap", stall_ms=1.5)
        off = EV.EventStream(Reg([sink]), enabled=False)
        assert off.emit("submit", 1) is None
        strip = [{k: v for k, v in r["data"].items() if k != "tm"}
                 for r in sink.recs]
        outs.append((strip, [(n, {k: v for k, v in d.items() if k != "tm"})
                             for n, d in seen], es.tap_errors,
                     [r["name"] for r in sink.recs]))
    assert outs[0] == outs[1]
    assert outs[0][2] == 2 and outs[0][3] == ["request", "request"]


def test_torch_rejected_request_has_complete_timeline(tmp_path, params):
    eng, reg, path = _traced_engine(tmp_path, params)
    h = eng.submit([5] * 100, max_new_tokens=8)
    assert h.status == "rejected"
    eng.close()
    reg.close()
    evs = TSUM.request_timelines(_records(path))[0][h.request.rid]
    assert [e["ev"] for e in evs] == ["submit", "retire"]
    assert evs[-1]["status"] == "rejected" and TSUM.timeline_complete(evs)


def test_torch_tight_slo_reports_partial_attainment(tmp_path, params):
    eng, reg, _ = _traced_engine(tmp_path, params)
    eng.serving = dataclasses.replace(eng.serving, slo_ttft_ms=1e-6)
    h = eng.submit([1, 2, 3], max_new_tokens=3)
    eng.run_until_idle()
    eng.close()
    reg.close()
    assert h.status == "done"
    assert reg.gauge("serve/slo_ttft_attainment").value == 0.0
    assert reg.gauge("serve/slo_ttft_ms").value == pytest.approx(1e-6)


def test_torch_engine_error_counter_and_flight_dump(tmp_path, params):
    eng, reg, path = _traced_engine(tmp_path, params,
                                    flight_dir=str(tmp_path / "flight"))

    def boom(slot, bucket):
        raise RuntimeError("injected step failure")

    eng._prefill_slot = boom
    eng.start()
    h = eng.submit([1, 2, 3])
    assert h.result(timeout=30) == [] and h.status == "error"
    eng.close()
    reg.close()
    assert reg.counter("serve/errors", error="RuntimeError").value == 1
    assert reg.counter("serve/engine_errors").value == 1
    dumps = os.listdir(tmp_path / "flight")
    assert len(dumps) == 1 and dumps[0].startswith("flight_")
    with open(tmp_path / "flight" / dumps[0]) as f:
        flight = json.load(f)
    assert flight["reason"] == "engine_error"
    assert flight["exception"]["type"] == "RuntimeError"
    assert "injected step failure" in flight["exception"]["traceback"]
    assert any(e["data"].get("ev") == "submit" for e in flight["events"])
    records = _records(path)
    evs = TSUM.request_timelines(records)[0][h.request.rid]
    assert evs[-1]["ev"] == "retire" and evs[-1]["status"] == "error"
    buf = io.StringIO()
    head = TSUM.summarize(path, out=buf)
    assert head["engine_error_events"] == 1
    assert "ENGINE ERROR: RuntimeError" in buf.getvalue()
    # the port's flight dump renders in both packages' summarize
    fpath = str(tmp_path / "flight" / dumps[0])
    with open(os.devnull, "w") as null:
        assert TSUM.summarize(fpath, out=null) == \
            JSUM.summarize(fpath, out=null)


def test_torch_tracing_off_emits_no_request_events(tmp_path, params):
    path = str(tmp_path / "m.jsonl")
    reg = MetricsRegistry([JsonlSink(path)])
    sv = ServingArgs(max_batch_size=2, kv_block_size=8, max_seq_len=32,
                     max_new_tokens=4)
    eng = ServingEngine(params, CFG, sv, registry=reg,
                        compute_dtype=torch.float32)
    h = eng.submit([1, 2, 3])
    eng.run_until_idle()
    eng.close()
    reg.close()
    assert h.status == "done"
    assert TSUM.request_timelines(_records(path))[0] == {}
    assert eng.recorder.events() == []  # no tap without trace / flight_dir
    # flight_dir alone: no stream, but the ring keeps the lifecycle
    sv = dataclasses.replace(sv, flight_dir=str(tmp_path / "fl"))
    eng = ServingEngine(params, CFG, sv, registry=MetricsRegistry(),
                        compute_dtype=torch.float32)
    eng.submit([1, 2, 3])
    eng.run_until_idle()
    eng.close()
    assert any(e["data"].get("ev") == "retire"
               for e in eng.recorder.events())
