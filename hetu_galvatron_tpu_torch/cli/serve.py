"""Serving launcher: request stream -> continuous-batching engine -> token
streams.

Port of ``hetu_galvatron_tpu/cli/serve.py``, on one device::

    python -m hetu_galvatron_tpu_torch.cli.serve <model.yaml> \
        requests=<requests.jsonl> [tokenizer=byte] \
        [ckpt=<checkpoint root or step dir>] [metrics=<metrics.jsonl>] \
        [stream=1] [watch=<poll seconds>] [seed=0] [device=cpu] \
        [serving.* / model.* overrides]

    # one request:
    python -m hetu_galvatron_tpu_torch.cli.serve <model.yaml> \
        prompt="..." max_new_tokens=64

Each line of ``requests.jsonl`` is one request::

    {"prompt": "...", "max_new_tokens": 32, "temperature": 0.8,
     "seed": 7, "arrival_offset_s": 0.5}

``arrival_offset_s`` staggers submission relative to the start of
traffic (after the engine's warm-up). With ``stream=1`` every token is
printed as a JSONL event as its request's stream drains, requests in
submission order; ``stream=0`` prints one completion record per request.
A completion record carries the generated ids (``tokens``, up to an eod)
beside the decoded text. The serving metrics (TTFT and inter-token
latency, queue depth, KV occupancy, tokens/s, and with
``serving.trace_requests=1`` each request's events) land in ``metrics``
and render with ``cli/summarize.py``.

``serving.prefix_cache=1`` turns on the radix prefix cache and
``serving.spec_decode=1`` speculative decoding (``serving.spec_k`` drafts
a step; greedy output is unchanged). ``serving.spec_draft=model`` drafts
with a small model: ``draft_model=<model.yaml>`` and
``draft_ckpt=<checkpoint>`` (random weights without it).

Weight rolls: ``watch=<seconds>`` with ``ckpt=<root>`` polls the root
(``runtime/ckpt_paths.latest_committed_step``), loads each newly
committed step (``runtime/checkpoint.load_checkpoint``) and hot-swaps it
into the live engine (``ServingEngine.swap_weights``): no request is
dropped; ``serve/weight_swaps`` counts the rolls and
``serve/swap_stall_ms`` the stall.

It runs on the CUDA device unless ``device=cpu`` is given, and raises
without a card. Refused by name, as in ``cli/generate.py``: ``hf_path=``,
a tokenizer other than ``byte`` and degree overrides that ask for
several devices (mesh serving).
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
import time

from hetu_galvatron_tpu_torch.cli.generate import (
    check_single_device,
    load_weights,
    split_argv,
)


def _read_requests(kv):
    if kv.get("requests"):
        out = []
        with open(kv["requests"]) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.append(json.loads(line))
        return out
    req = {"prompt": kv["prompt"]}
    for key in ("max_new_tokens", "temperature", "seed"):
        if key in kv:
            req[key] = float(kv[key]) if key == "temperature" else int(kv[key])
    return [req]


def _load_draft(kv, serving, device):
    """(draft_params, draft_cfg) for ``serving.spec_draft=model``:
    ``draft_model=<yaml>`` names the architecture, ``draft_ckpt`` its
    weights (random from seed + 1 without); (None, None) otherwise."""
    if not (serving.spec_decode and serving.spec_draft == "model"):
        return None, None
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli

    if not kv.get("draft_model"):
        raise ValueError(
            "serving.spec_draft=model needs draft_model=<model.yaml> "
            "(the draft architecture); pass draft_ckpt=<ckpt root> for "
            "its weights")
    draft_cfg = args_from_cli([kv["draft_model"]], mode="train_dist").model
    seed = int(kv.get("seed", 0)) + 1
    draft_params, _ = load_weights({"ckpt": kv.get("draft_ckpt")},
                                   draft_cfg, device, seed)
    return draft_params, draft_cfg


class _Watcher:
    """Polls a checkpoint root every ``period`` seconds and hot-swaps each
    newly committed step into the engine. A step that keeps failing backs
    off to one retry every 30 polls (a newer commit swaps at once), as in
    JAX."""

    def __init__(self, root: str, period: float, engine, cfg, device,
                 served_step: int):
        self.root, self.period = root, period
        self.engine, self.cfg, self.device = engine, cfg, device
        self.step = served_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ckpt-watch")

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30.0)

    def _run(self) -> None:
        from hetu_galvatron_tpu_torch.models.builder import init_causal_lm
        from hetu_galvatron_tpu_torch.runtime.checkpoint import (
            load_checkpoint,
        )
        from hetu_galvatron_tpu_torch.runtime.ckpt_paths import (
            latest_committed_step,
        )

        fails: dict = {}
        skip = 0
        bad_step = None
        while not self._stop.wait(self.period):
            step_n = None
            try:
                found = latest_committed_step(self.root)
                if found is None:
                    continue
                step_n, ckdir = found
                if step_n <= self.step:
                    continue
                if step_n == bad_step and skip > 0:
                    skip -= 1
                    continue
                target = init_causal_lm(self.cfg, device=self.device)
                new_params, _, _ = load_checkpoint(ckdir, target)
                stall = self.engine.swap_weights(new_params)
                print(f"weight swap: step {self.step} -> {step_n} "
                      f"({ckdir}, stall {stall:.3f} ms)", file=sys.stderr,
                      flush=True)
                self.step = step_n
                fails.pop(step_n, None)
                bad_step = None
            except Exception as e:  # noqa: BLE001 — keep serving
                print(f"warning: weight-swap watch failed: {e}",
                      file=sys.stderr, flush=True)
                if step_n is not None:
                    fails[step_n] = fails.get(step_n, 0) + 1
                    if fails[step_n] >= 3:
                        bad_step, skip = step_n, 30
                        print(f"warning: step {step_n} failed "
                              f"{fails[step_n]} swap attempts; backing off "
                              "(a newer checkpoint swaps at once)",
                              file=sys.stderr, flush=True)


def main(argv=None) -> int:
    argv = list(argv if argv is not None else sys.argv[1:])
    kv, passthrough = split_argv(
        argv, ("prompt", "requests", "max_new_tokens", "temperature",
               "seed", "tokenizer", "ckpt", "hf_path", "metrics", "stream",
               "draft_model", "draft_ckpt", "watch"))
    if "prompt" not in kv and "requests" not in kv:
        print("usage: serve <model.yaml> requests=<jsonl> | prompt=\"...\" "
              "[key=value ...]", file=sys.stderr)
        return 2
    check_single_device(kv, passthrough)

    from hetu_galvatron_tpu_torch.cli.preprocess_data import make_tokenizer
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
    from hetu_galvatron_tpu_torch.observability.registry import (
        MetricsRegistry,
    )
    from hetu_galvatron_tpu_torch.observability.sinks import JsonlSink
    from hetu_galvatron_tpu_torch.runtime.initialize import resolve_device
    from hetu_galvatron_tpu_torch.serving.engine import ServingEngine

    args = args_from_cli(passthrough, mode="train_dist")
    cfg = args.model
    device = resolve_device(args)
    tok = make_tokenizer(kv.get("tokenizer"))
    if tok.vocab_size > cfg.vocab_size:
        raise ValueError(
            f"tokenizer vocab {tok.vocab_size} exceeds model vocab "
            f"{cfg.vocab_size}; pass a matching model config")
    watch_s = float(kv.get("watch", 0) or 0)
    if watch_s > 0 and not kv.get("ckpt"):
        print("watch=<seconds> needs ckpt=<checkpoint root> to poll",
              file=sys.stderr)
        return 2

    params, served_step = load_weights(kv, cfg, device,
                                       int(kv.get("seed", 0)))
    metrics_path = kv.get("metrics") or args.serving.metrics_path or \
        "serve_metrics.jsonl"
    registry = MetricsRegistry([JsonlSink(metrics_path)])
    serving = args.serving
    if serving.eos_id is None:
        serving = dataclasses.replace(serving,
                                      eos_id=getattr(tok, "eod_id", None))
    stream = kv.get("stream", "1") not in ("0", "false", "False")
    draft_params, draft_cfg = _load_draft(kv, serving, device)
    engine = ServingEngine(params, cfg, serving, registry=registry,
                           draft_params=draft_params, draft_cfg=draft_cfg)
    del params  # the engine holds its compute-dtype copy
    if engine.metrics_port is not None:
        print(f"metrics: http://{serving.metrics_host}:"
              f"{engine.metrics_port}/metrics", file=sys.stderr)
    if serving.prefix_cache or serving.spec_decode:
        print(f"serving features: prefix_cache={serving.prefix_cache} "
              f"spec_decode={serving.spec_decode}"
              + (f" (k={serving.spec_k}, draft={serving.spec_draft})"
                 if serving.spec_decode else ""), file=sys.stderr)
    if serving.trace_requests:
        print("request tracing: ON (per-request lifecycle events in the "
              "metrics stream)", file=sys.stderr)
    slo_parts = []
    if serving.slo_ttft_ms > 0:
        slo_parts.append(f"ttft<={serving.slo_ttft_ms}ms")
    if serving.slo_itl_ms > 0:
        slo_parts.append(f"itl<={serving.slo_itl_ms}ms")
    if slo_parts:
        print(f"SLO targets: {' '.join(slo_parts)} (attainment gauges "
              "in serve/slo_*)", file=sys.stderr)
    if serving.flight_dir:
        print(f"flight recorder: dumps to {serving.flight_dir} on engine "
              "fault", file=sys.stderr)
    reqs = _read_requests(kv)
    print("warmup: running decode + prefill buckets ...", file=sys.stderr,
          flush=True)
    engine.warmup()
    engine.start()

    watcher = None
    if watch_s > 0:
        watcher = _Watcher(kv["ckpt"], watch_s, engine, cfg, device,
                           served_step)
        watcher.start()
        print(f"watching {kv['ckpt']} every {watch_s:g}s for new "
              "committed checkpoints (hot swap)", file=sys.stderr,
              flush=True)
    t0 = time.monotonic()
    handles = []
    eod = getattr(tok, "eod_id", None)
    try:
        for i, r in enumerate(reqs):
            wait = t0 + float(r.get("arrival_offset_s", 0.0)) \
                - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            ids = tok.encode(r["prompt"])
            if not ids:
                print(json.dumps({"rid": i, "event": "rejected",
                                  "reason": "empty prompt"}))
                continue
            h = engine.submit(
                ids,
                max_new_tokens=r.get("max_new_tokens"),
                temperature=r.get("temperature"),
                seed=int(r.get("seed", 0)))
            handles.append((i, h))
            if h.status == "rejected":
                print(json.dumps({"rid": i, "event": "rejected",
                                  "reason": "capacity"}))

        for i, h in handles:
            if h.status == "rejected":
                continue
            if stream:
                for t in h.tokens():
                    print(json.dumps({"rid": i, "event": "token",
                                      "text": tok.decode([t])}), flush=True)
            out = h.result()
            if eod is not None and eod in out:
                out = out[: out.index(eod)]
            print(json.dumps({
                "rid": i, "event": "done", "status": h.status,
                "reason": h.finish_reason, "n_tokens": len(h.output),
                "ttft_ms": (None if h.ttft_s() is None
                            else round(h.ttft_s() * 1000.0, 3)),
                "tokens": out, "text": tok.decode(out)}), flush=True)
    finally:
        if watcher is not None:
            watcher.stop()
        engine.close()
        registry.close()
    print(f"metrics written to {metrics_path} "
          f"(render: python -m hetu_galvatron_tpu_torch.cli.summarize "
          f"{metrics_path})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
