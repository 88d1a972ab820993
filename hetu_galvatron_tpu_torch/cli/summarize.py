"""Run-summary CLI: ``python -m hetu_galvatron_tpu_torch.cli.summarize
<metrics.jsonl | flight_*.json> [--timeline [rid|all]]``.

Port of ``hetu_galvatron_tpu/cli/summarize.py`` (``load_records``,
``last_by_name``, ``summarize_flight``, ``request_timelines`` :179,
``timeline_complete`` :208, ``ttft_components`` :218,
``render_timeline`` :240, ``summarize``): it reads the JSONL metrics
stream a telemetry-enabled run or a serving engine writes
(``observability/sinks.py`` record schema, the JAX package's) and prints
the throughput / MFU / memory / supervisor timeline / serving / goodput /
span summary, or renders a flight-recorder dump (``flight_<ts>.json``:
reason, exception, the last-N-events ring, the metric snapshot; a torn
dump degrades to a warning). Counters and gauges carry their current
value at each flush, so the LAST record per (name, labels) is the
end-of-run state. It prints the same text as the JAX tool on the same
file.

Request tracing (``serving.trace_requests``, ``observability/events.py``):
a stream with per-request lifecycle events adds the TTFT component
breakdown (queue, prefill and first decode, additive per request), and
with ``--timeline`` each request's events. Torn event records are
skipped with a warning.

Out of this port: the plan-audit and calibration tables (with the plan
audit), XLA program costs (eager PyTorch has no compiled-program cost)
and the hardware-profile view.
"""

from __future__ import annotations

import json
import sys
from typing import Any, Dict, List, Optional, Tuple


def load_records(path: str) -> List[Dict[str, Any]]:
    """Parse the JSONL stream, tolerating a truncated tail: a run killed
    mid-write (OOM/SIGKILL during a sink flush) leaves a partial final
    line, and the post-mortem tool must still summarize everything before
    it. Unparseable lines are counted and warned about, not fatal."""
    out = []
    bad = 0
    with open(path, errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                bad += 1
                continue
            # a torn write can also yield VALID JSON that is not a record
            # (e.g. a bare number from a half-flushed line) — a summary
            # must skip it, not crash on rec.get()
            if isinstance(rec, dict):
                out.append(rec)
            else:
                bad += 1
    if bad:
        print(f"warning: skipped {bad} unparseable line(s) in {path} "
              "(truncated by a crashed run?)", file=sys.stderr)
    return out


def last_by_name(records: List[Dict[str, Any]]
                 ) -> Dict[Tuple[str, str, str], Dict[str, Any]]:
    """Last record per (kind, name, labels); later lines win."""
    latest: Dict[Tuple[str, str, str], Dict[str, Any]] = {}
    for r in records:
        if r.get("kind") == "event":
            continue
        key = (r.get("kind", ""), r.get("name", ""),
               json.dumps(r.get("labels") or {}, sort_keys=True))
        latest[key] = r
    return latest


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        if v == 0:
            return "0"
        if abs(v) >= 1000:
            return f"{v:,.0f}"
        if abs(v) >= 1:
            return f"{v:.2f}"
        return f"{v:.4g}"
    return str(v)


def _label_str(labels: str) -> str:
    d = json.loads(labels)
    if not d:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(d.items())) + "}"


def _load_flight_json(path: str) -> Optional[Dict[str, Any]]:
    """A flight-recorder dump (observability/recorder.py) rather than a
    JSONL metrics stream. Sniffs the head of the file for the schema
    marker BEFORE attempting a full parse, so a multi-GB per-token
    metrics stream is not slurped just to decide it isn't a dump. A
    torn/truncated dump fails json parsing and returns None — the caller
    falls through to the line-tolerant JSONL loader, whose
    skip-and-warn path covers it."""
    try:
        with open(path, errors="replace") as f:
            head = f.read(4096)
            if '"flight_recorder"' not in head:
                return None
            obj = json.loads(head + f.read())
    except (json.JSONDecodeError, OSError):
        return None
    if isinstance(obj, dict) and obj.get("kind") == "flight_recorder":
        return obj
    return None


# ---------------------------------------------------------------------------
# request-lifecycle timelines (observability/events.py records)
# ---------------------------------------------------------------------------


def request_timelines(records: List[Dict[str, Any]]
                      ) -> Tuple[Dict[int, List[Dict[str, Any]]], int]:
    """Group ``request`` events by rid, ordered by the stream sequence
    number. Corrupt records (torn writes, missing or mistyped fields) are
    counted and skipped; well-formed events without a rid (stream-level
    records such as ``engine_error`` or ``weight_swap``) belong to no
    timeline. Returns ``(timelines, n_corrupt)``."""
    tl: Dict[int, List[Dict[str, Any]]] = {}
    bad = 0
    for r in records:
        if r.get("kind") != "event" or r.get("name") != "request":
            continue
        d = r.get("data")
        if (not isinstance(d, dict) or "ev" not in d
                or not isinstance(d.get("seq"), (int, float))):
            bad += 1
            continue
        if "rid" not in d:
            continue  # stream-level event, not corrupt
        try:
            tl.setdefault(int(d["rid"]), []).append(d)
        except (TypeError, ValueError):
            bad += 1
    for evs in tl.values():
        evs.sort(key=lambda d: d["seq"])
    return tl, bad


def timeline_complete(evs: List[Dict[str, Any]]) -> bool:
    """A complete, well-ordered lifecycle: starts at ``submit``, ends at
    ``retire``, and the monotonic stamps never run backwards."""
    if not evs or evs[0]["ev"] != "submit" or evs[-1]["ev"] != "retire":
        return False
    tms = [e.get("tm") for e in evs if isinstance(e.get("tm"), (int, float))]
    return all(a <= b for a, b in zip(tms, tms[1:]))


def ttft_components(timelines: Dict[int, List[Dict[str, Any]]]
                    ) -> Dict[str, List[float]]:
    """Per-request TTFT component samples from the ``first_token`` events
    (queue + prefill + decode == ttft by construction)."""
    comp: Dict[str, List[float]] = {"queue": [], "prefill": [],
                                    "first_decode": [], "ttft": []}
    for evs in timelines.values():
        ft = next((e for e in evs if e["ev"] == "first_token"), None)
        if ft is None:
            continue
        try:
            vals = (float(ft["queue_ms"]), float(ft["prefill_ms"]),
                    float(ft["decode_ms"]), float(ft["ttft_ms"]))
        except (KeyError, TypeError, ValueError):
            continue  # corrupt first_token event: skip the whole row
        for key, v in zip(("queue", "prefill", "first_decode", "ttft"),
                          vals):
            comp[key].append(v)
    return comp


def render_timeline(rid: int, evs: List[Dict[str, Any]], w) -> None:
    """One request's event listing, stamps relative to its submit."""
    t0 = evs[0].get("tm") if evs else None
    status = next((e.get("status") for e in reversed(evs)
                   if e["ev"] == "retire"), "?")
    w(f"request {rid} ({len(evs)} events, {status}"
      + ("" if timeline_complete(evs) else ", INCOMPLETE") + "):")
    for e in evs:
        dt = (e["tm"] - t0 if isinstance(e.get("tm"), (int, float))
              and isinstance(t0, (int, float)) else None)
        extra = " ".join(
            f"{k}={_fmt(v)}" for k, v in sorted(e.items())
            if k not in ("ev", "seq", "tm", "rid"))
        w(f"  {('+' + _fmt(dt) + 'ms').rjust(12) if dt is not None else '?'}"
          f"  {e['ev']:<12} {extra}")


def summarize_flight(obj: Dict[str, Any], path: str, out=None
                     ) -> Dict[str, Any]:
    """Render one flight-recorder dump: the crash reason, the exception
    (if any), the tail of the event ring, and the metric snapshot — a
    self-contained postmortem for a run that is no longer around to ask."""
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    headline: Dict[str, Any] = {"flight_reason": obj.get("reason")}
    events = [e for e in obj.get("events", []) if isinstance(e, dict)]
    metrics = [m for m in obj.get("metrics", []) if isinstance(m, dict)]
    w(f"== flight recorder dump: {path} ==")
    w(f"reason           {obj.get('reason', '?')}")
    if obj.get("t"):
        w(f"wall time        {obj['t']:.3f} (pid {obj.get('pid', '?')})")
    exc = obj.get("exception")
    if exc:
        headline["flight_exception"] = exc.get("type")
        w(f"exception        {exc.get('type', '?')}: "
          f"{exc.get('message', '')}")
        tb = (exc.get("traceback") or "").strip().splitlines()
        for line in tb[-8:]:
            w(f"  {line}")
    headline["flight_events"] = len(events)
    w(f"events in ring   {len(events)}")
    for e in events[-16:]:
        d = e.get("data") if isinstance(e.get("data"), dict) else {}
        extra = " ".join(f"{k}={_fmt(v)}" for k, v in sorted(d.items())
                         if k not in ("ev", "seq", "tm"))
        tm = d.get("tm")
        w(f"  {(_fmt(tm) + 'ms').rjust(12) if tm is not None else '?'.rjust(12)}"
          f"  {d.get('ev', e.get('name', '?')):<14} {extra}")
    if metrics:
        w(f"metrics snapshot {len(metrics)} series (last values)")
        for m in metrics[:20]:
            lbl = ("{" + ",".join(f"{k}={v}" for k, v in
                                  sorted((m.get('labels') or {}).items()))
                   + "}" if m.get("labels") else "")
            val = m.get("value", m.get("count"))
            w(f"  {m.get('name', '?') + lbl:<44} {_fmt(val)}")
        if len(metrics) > 20:
            w(f"  ... and {len(metrics) - 20} more")
    return headline


def summarize(path: str, out=None,
              timeline: Optional[str] = None) -> Dict[str, Any]:
    """Print the summary; returns the headline numbers (for tests).
    ``timeline`` renders per-request event listings: ``"all"`` or one
    rid (a string)."""
    out = out or sys.stdout
    w = lambda s="": print(s, file=out)
    fl = _load_flight_json(path)
    if fl is not None:
        return summarize_flight(fl, path, out)
    records = load_records(path)
    latest = last_by_name(records)

    def get(kind: str, name: str, labels: str = "{}"
            ) -> Optional[Dict[str, Any]]:
        return latest.get((kind, name, labels))

    headline: Dict[str, Any] = {}
    w(f"== run summary: {path} ({len(records)} records) ==")
    steps = get("counter", "train/steps")
    tokens = get("counter", "train/tokens")
    if steps:
        headline["steps"] = steps["value"]
        w(f"steps            {steps['value']:,.0f}")
    if tokens:
        headline["tokens"] = tokens["value"]
        w(f"tokens           {tokens['value']:,.0f}")
    st = get("histogram", "train/step_time_ms") or \
        get("histogram", "profiler/iter_time_ms")
    if st and st.get("count"):
        headline["step_time_p50_ms"] = st["p50"]
        w(f"step time ms     p50 {_fmt(st['p50'])} | p90 {_fmt(st['p90'])}"
          f" | p99 {_fmt(st['p99'])} | mean {_fmt(st['mean'])}"
          f" (n={st['count']})")
    tps = get("gauge", "train/tokens_per_sec")
    if tps:
        headline["tokens_per_sec"] = tps["value"]
        w(f"tokens/sec       {_fmt(tps['value'])}")
    tfl = get("gauge", "train/model_tflops")
    if tfl:
        w(f"model TFLOP/s    {_fmt(tfl['value'])}")
    mfu = get("gauge", "train/mfu")
    if mfu:
        headline["mfu"] = mfu["value"]
        w(f"MFU              {mfu['value'] * 100:.1f}%")
    for key in ("loss", "grad_norm"):
        g = get("gauge", f"train/{key}")
        if g:
            w(f"final {key:<10} {_fmt(g['value'])}")
    mems = [(lb, r) for (k, n, lb), r in latest.items()
            if k == "gauge" and n == "device/mem_mb"]
    if mems:
        parts = " | ".join(
            f"{json.loads(lb).get('stat', '?')} {_fmt(r['value'])}"
            for lb, r in sorted(mems))
        w(f"device mem MB    {parts}")
    # the plan's predicted comm volume is a one-shot event
    plan_ev = [r for r in records if r.get("kind") == "event"
               and r.get("name") == "plan"]
    if plan_ev and "predicted_comm_mb_per_step" in plan_ev[-1].get(
            "data", {}):
        w(f"plan comm MB/step (predicted)  "
          f"{_fmt(float(plan_ev[-1]['data']['predicted_comm_mb_per_step']))}")

    # -- supervisor timeline (cli/supervise.py events) + RPO table --
    sup_ev = [r for r in records if r.get("kind") == "event"
              and r.get("name") == "supervisor"]
    if sup_ev:
        headline["supervisor_events"] = len(sup_ev)
        t0 = sup_ev[0].get("t")
        w()
        w("-- supervisor timeline (cross-process restarts) --")
        w(f"{'t+s':>8}  {'event':<14}{'attempt':>8}{'code':>6}"
          f"{'commit':>8}{'RPO s':>8}")
        exits = []
        for r in sup_ev:
            d = r.get("data", {})
            if not isinstance(d, dict):
                continue
            rel = (r.get("t") - t0) if isinstance(r.get("t"), (int, float)) \
                and isinstance(t0, (int, float)) else None
            code = d.get("code")
            rpo = d.get("rpo_s")
            w(f"{(_fmt(rel) if rel is not None else '-'):>8}  "
              f"{str(d.get('event', '?')):<14}"
              f"{str(d.get('attempt', '-')):>8}"
              f"{(str(code) if code is not None else '-'):>6}"
              f"{(str(d.get('commit_step')) if d.get('commit_step') is not None else '-'):>8}"
              f"{(_fmt(rpo) if rpo is not None else '-'):>8}")
            if d.get("event") == "child_exit":
                exits.append(d)
        final = sup_ev[-1].get("data", {})
        headline["supervisor_final_event"] = final.get("event")
        headline["supervisor_attempts"] = max(
            (d.get("attempt", 0) for d in exits), default=None)
        if exits:
            # RPO table: wall-clock of un-checkpointed work lost at each
            # child death — the bound ckpt.interval_s buys
            rpos = [d["rpo_s"] for d in exits
                    if isinstance(d.get("rpo_s"), (int, float))]
            nonzero = [d for d in exits if d.get("code")]
            headline["supervisor_child_exits"] = len(exits)
            if rpos:
                headline["supervisor_rpo_max_s"] = max(rpos)
                w(f"child exits      {len(exits)} "
                  f"({len(nonzero)} abnormal) | RPO max "
                  f"{_fmt(max(rpos))}s mean "
                  f"{_fmt(sum(rpos) / len(rpos))}s")
            progressed = sum(1 for d in exits if d.get("progressed"))
            w(f"progress         {progressed}/{len(exits)} exits had "
              "committed new work (restart budget resets)")

    _serving_sections(records, get, headline, w, path, timeline)

    # -- goodput accounting (observability/goodput.py) --
    gp = {n.split("/", 1)[1]: r for (k, n, lb), r in latest.items()
          if k == "gauge" and n.startswith("goodput/")}
    if gp:
        w()
        w("-- goodput --")
        order = ("productive_step_s", "recompile_s", "checkpoint_save_s",
                 "resume_replay_s", "restart_lost_s")
        for key in order + tuple(
                k for k in sorted(gp)
                if k not in order + ("goodput_frac",)):
            r = gp.get(key)
            if r is None:
                continue
            if key.endswith("_s"):
                headline[f"goodput/{key}"] = r["value"]
                w(f"{key:<22} {_fmt(r['value'])} s")
            else:
                w(f"{key:<22} {_fmt(r['value'])}")
        if "goodput_frac" in gp:
            headline["goodput_frac"] = gp["goodput_frac"]["value"]
            w(f"{'goodput':<22} {gp['goodput_frac']['value'] * 100:.1f}%")

    spans = [(json.loads(lb).get("path", "?"), r)
             for (k, n, lb), r in latest.items()
             if k == "histogram" and n == "span_ms" and r.get("count")]
    if spans:
        w()
        w("-- spans (host ms) --")
        w(f"{'path':<24}{'count':>8}{'mean':>10}{'p50':>10}{'p99':>10}")
        for p, r in sorted(spans):
            w(f"{p:<24}{r['count']:>8}{_fmt(r['mean']):>10}"
              f"{_fmt(r['p50']):>10}{_fmt(r['p99']):>10}")

    rest = [((k, n, lb), r) for (k, n, lb), r in sorted(latest.items())
            if k in ("counter", "gauge")
            and not n.startswith(("train/", "device/", "plan/", "serve/",
                                  "tp/", "audit/", "cost/", "goodput/",
                                  "calibration/"))]
    if rest:
        w()
        w("-- other counters/gauges --")
        for (k, n, lb), r in rest:
            w(f"{n + _label_str(lb):<40} {_fmt(r['value'])}")

    events = [r for r in records if r.get("kind") == "event"]
    if events:
        w()
        w(f"-- events ({len(events)}) --")
        by_name: Dict[str, int] = {}
        for e in events:
            by_name[e.get("name", "?")] = by_name.get(e.get("name", "?"), 0) + 1
        for n, c in sorted(by_name.items()):
            w(f"{n:<40} {c}")
    return headline


def _serving_sections(records, get, headline, w, path, timeline) -> None:
    """The serving engine's telemetry and the request traces."""
    srv_tps = get("gauge", "serve/tokens_per_sec")
    ttft = get("histogram", "serve/ttft_ms")
    if srv_tps or (ttft and ttft.get("count")):
        w()
        w("-- serving --")
        for key, label in (("serve/requests_submitted", "submitted"),
                           ("serve/requests_completed", "completed"),
                           ("serve/requests_rejected", "rejected"),
                           ("serve/requests_cancelled", "cancelled"),
                           ("serve/requests_timeout", "timed out")):
            c = get("counter", key)
            if c and c["value"]:
                headline[key] = c["value"]
                w(f"requests {label:<12} {c['value']:,.0f}")
        for key, label in (("serve/prefill_tokens", "prefill tokens"),
                           ("serve/decode_tokens", "decode tokens"),
                           ("serve/steps", "engine steps"),
                           ("serve/engine_errors", "engine errors")):
            c = get("counter", key)
            if c and (c["value"] or not key.endswith("errors")):
                w(f"{label:<21} {c['value']:,.0f}")
        ph = get("gauge", "serve/prefix_hit_rate")
        if ph is not None:
            headline["prefix_hit_rate"] = ph["value"]
            cached = get("counter", "serve/prefix_cached_tokens")
            extra = (f" ({cached['value']:,.0f} prompt tokens reused)"
                     if cached and cached["value"] else "")
            w(f"prefix hit rate   {ph['value'] * 100:.1f}%{extra}")
        pb = get("gauge", "serve/prefix_cache_blocks")
        if pb is not None:
            w(f"prefix cache blocks   {_fmt(pb['value'])}")
        # speculative decoding: drafted vs emitted (decode_tokens counts
        # what reached the clients)
        sa = get("gauge", "serve/spec_accept_rate")
        if sa is not None:
            headline["spec_accept_rate"] = sa["value"]
            drafted = get("counter", "serve/drafted_tokens")
            accepted = get("counter", "serve/spec_accepted_tokens")
            emitted = get("counter", "serve/decode_tokens")
            parts = [f"spec accept rate  {sa['value'] * 100:.1f}%"]
            if drafted:
                parts.append(f"({drafted['value']:,.0f} drafted, "
                             f"{(accepted or {}).get('value', 0):,.0f} "
                             "accepted"
                             + (f", {emitted['value']:,.0f} emitted)"
                                if emitted else ")"))
            w(" ".join(parts))
        qw = get("histogram", "serve/queue_wait_ms")
        if qw and qw.get("count"):
            headline["queue_wait_p50_ms"] = qw["p50"]
            w(f"queue wait ms    p50 {_fmt(qw['p50'])} | p90 "
              f"{_fmt(qw['p90'])} | p99 {_fmt(qw['p99'])} "
              f"(n={qw['count']})")
        if ttft and ttft.get("count"):
            headline["ttft_p50_ms"] = ttft["p50"]
            w(f"TTFT ms          p50 {_fmt(ttft['p50'])} | p90 "
              f"{_fmt(ttft['p90'])} | p99 {_fmt(ttft['p99'])} "
              f"(n={ttft['count']})")
        itl = get("histogram", "serve/itl_ms")
        if itl and itl.get("count"):
            headline["itl_p50_ms"] = itl["p50"]
            w(f"inter-token ms   p50 {_fmt(itl['p50'])} | p90 "
              f"{_fmt(itl['p90'])} | p99 {_fmt(itl['p99'])} "
              f"(n={itl['count']})")
        slo_parts = []
        for kind, gname, tname in (
                ("TTFT", "serve/slo_ttft_attainment", "serve/slo_ttft_ms"),
                ("ITL", "serve/slo_itl_attainment", "serve/slo_itl_ms")):
            att = get("gauge", gname)
            if att is not None:
                tgt = get("gauge", tname)
                headline[gname] = att["value"]
                slo_parts.append(
                    f"{kind}<={_fmt(tgt['value']) if tgt else '?'}ms "
                    f"attainment {att['value'] * 100:.1f}%")
        if slo_parts:
            w("SLO              " + " | ".join(slo_parts))
        if srv_tps:
            headline["serve_tokens_per_sec"] = srv_tps["value"]
            w(f"serve tokens/sec {_fmt(srv_tps['value'])}")
        for key, label in (("serve/queue_depth", "queue depth (end)"),
                           ("serve/active_requests", "active (end)"),
                           ("serve/kv_occupancy", "KV occupancy (end)"),
                           ("serve/kv_blocks_used", "KV blocks (end)"),
                           ("serve/jit_programs", "jit programs")):
            g = get("gauge", key)
            if g is not None:
                w(f"{label:<21} {_fmt(g['value'])}")

    # -- request-lifecycle tracing (observability/events.py) --
    timelines, bad_ev = request_timelines(records)
    if bad_ev:
        print(f"warning: skipped {bad_ev} corrupt request event(s) in "
              f"{path}", file=sys.stderr)
    # stream-level fatal-engine events carry no rid: they explain why
    # every request retired
    eng_errs = [r["data"] for r in records
                if r.get("kind") == "event" and r.get("name") == "request"
                and isinstance(r.get("data"), dict)
                and r["data"].get("ev") == "engine_error"]
    if eng_errs:
        headline["engine_error_events"] = len(eng_errs)
        w()
        for e in eng_errs:
            w(f"ENGINE ERROR: {e.get('error', '?')}: "
              f"{e.get('message', '')}")
    if not timelines:
        return
    complete = sum(1 for evs in timelines.values() if timeline_complete(evs))
    headline["requests_traced"] = len(timelines)
    headline["timelines_complete"] = complete
    w()
    w(f"-- request traces: {len(timelines)} requests "
      f"({complete} complete timelines) --")
    if complete < len(timelines):
        w(f"   {len(timelines) - complete} INCOMPLETE timeline(s) "
          "(crashed mid-request, or out-of-order events)")
    comp = ttft_components(timelines)
    if comp["ttft"]:
        import numpy as np

        w(f"TTFT breakdown (n={len(comp['ttft'])}, additive components)")
        w(f"{'component':<14}{'p50 ms':>10}{'p90 ms':>10}"
          f"{'p99 ms':>10}{'mean ms':>10}")
        for key in ("queue", "prefill", "first_decode", "ttft"):
            arr = np.asarray(comp[key])
            p50, p90, p99 = np.percentile(arr, [50, 90, 99])
            headline[f"ttft_{key}_p50_ms"] = float(p50)
            w(f"{key:<14}{_fmt(float(p50)):>10}{_fmt(float(p90)):>10}"
              f"{_fmt(float(p99)):>10}{_fmt(float(arr.mean())):>10}")
    cold = sum(1 for evs in timelines.values()
               for e in evs if e["ev"] == "admit" and e.get("cold_retry"))
    if cold:
        w(f"cold retries (prefix-pin livelock fallback)  {cold}")
    if timeline:
        w()
        w("-- request timelines --")
        if timeline == "all":
            for rid in sorted(timelines):
                render_timeline(rid, timelines[rid], w)
        else:
            try:
                rid = int(timeline)
            except ValueError:
                rid = -1
            if rid in timelines:
                render_timeline(rid, timelines[rid], w)
            else:
                w(f"(no traced request with rid {timeline})")


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    usage = ("usage: python -m hetu_galvatron_tpu_torch.cli.summarize "
             "<metrics.jsonl | flight_*.json> [--timeline [rid|all]]")
    if not argv or argv[0] in ("-h", "--help"):
        print(usage)
        return 0 if argv else 2
    timeline = None
    if "--timeline" in argv:
        i = argv.index("--timeline")
        argv.pop(i)
        # optional value: "all" or a numeric rid; anything else (the path
        # when the flag comes first) is not consumed
        timeline = "all"
        if i < len(argv) and (argv[i] == "all" or argv[i].isdigit()):
            timeline = argv.pop(i)
    if not argv:
        print(usage)
        return 2
    summarize(argv[0], timeline=timeline)
    return 0


if __name__ == "__main__":
    sys.exit(main())
