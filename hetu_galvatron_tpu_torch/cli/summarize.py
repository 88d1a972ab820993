"""Run-summary CLI: ``python -m hetu_galvatron_tpu_torch.cli.summarize
<metrics.jsonl | flight_*.json>``.

Port of the training half of ``hetu_galvatron_tpu/cli/summarize.py``
(``load_records``, ``last_by_name``, ``summarize_flight``, ``summarize``):
it reads the JSONL metrics stream a telemetry-enabled run writes
(``observability/sinks.py`` record schema, the JAX package's) and prints
the throughput / MFU / memory / supervisor timeline / goodput / span
summary, or renders a flight-recorder dump (``flight_<ts>.json``: reason,
exception, the last-N-events ring, the metric snapshot; a torn dump
degrades to a warning). Counters and gauges carry their current value at
each flush, so the LAST record per (name, labels) is the end-of-run
state. It prints the same numbers as the JAX tool on the same file.

Not ported: the serving sections and ``--timeline`` (request events, with
the serving slice), the plan-audit and calibration tables (with the plan
audit), XLA program costs and the hardware-profile view.
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


def summarize(path: str, out=None) -> Dict[str, Any]:
    """Print the summary; returns the headline numbers (for tests)."""
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


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    usage = ("usage: python -m hetu_galvatron_tpu_torch.cli.summarize "
             "<metrics.jsonl | flight_*.json>")
    if not argv or argv[0] in ("-h", "--help"):
        print(usage)
        return 0 if argv else 2
    if "--timeline" in argv:
        print("summarize: --timeline reads serving request events, which "
              "hetu_galvatron_tpu_torch does not write yet", file=sys.stderr)
        return 2
    summarize(argv[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
