#!/usr/bin/env python
"""How many launches a traced window keeps, with the window's margin off and on.

::

    python3 tools/torch_trace_window_check.py [TRIES] [MARGINS]

Runs ``chip_smoke.py`` phase 17 (a)'s traced run ``TRIES`` times (default
20) in one process on one GPU: GPT-2 small, pp 4 1F1B on the compiled
engine, 6 steps, steps 2-3 traced by ``observability.tracing.
TraceCapture``. ``MARGINS`` is a comma-separated list of seconds (default
``0,0.1``) that ``tracing.WINDOW_MARGIN_S`` takes in turns. Each try
prints, from its own trace: whether K1-K3 by kernel name equal the
launch counters over the same steps (phase 17's trace gate), the number
of device ops the trace kept, the earliest and the median time from a
launch on the host to its device op's start (matched by correlation id:
a negative time is the card's clock, moved onto the host's, running
ahead of it), and how far the first and the last device op lie inside
the window. The last line is one JSON object with the card (``nvidia-smi``
name and power limit) and, per margin, the tries, the tries whose trace
lost a launch, and the earliest launch-to-op time seen. It exits 1 if a
try at the module's own margin lost a launch.
"""

from __future__ import annotations

import glob
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    tries = int(argv[0]) if argv else 20
    margins = [float(m) for m in (argv[1] if len(argv) > 1
                                  else "0,0.1").split(",")]
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from hetu_galvatron_tpu_torch.observability import tracing
    from hetu_galvatron_tpu_torch.ops import _build

    smi = cs.nvidia_smi_line()
    default = tracing.WINDOW_MARGIN_S
    _build.load_library()
    over = ["parallel.global_train_batch_size=8",
            f"parallel.chunks={cs.PIPE_CHUNKS}",
            f"train.lr_decay_iters={cs.COMP_STEPS}",
            "parallel.pp_deg=4", "parallel.num_devices=4",
            "parallel.pipeline_type=pipedream_flush",
            "pipeline.schedule_impl=compiled",
            f"train.train_iters={cs.COMP_GPT2_STEPS}"]
    summary = {m: dict(tries=0, lost=0, min_launch_to_op_ms=None)
               for m in margins}
    with tempfile.TemporaryDirectory() as tmp:
        for i in range(tries):
            margin = margins[i % len(margins)]
            tracing.WINDOW_MARGIN_S = margin
            os.makedirs(os.path.join(tmp, str(i)))
            run = cs.comp_train(f"(w{i})", cs.GPT2_YAML, over,
                                os.path.join(tmp, str(i)), trace=True)
            found = {k: run["trace"]["category_launches"].get(k, 0)
                     for k in cs.FLASH}
            want = {k: run["traced_launches"][k] for k in cs.FLASH}
            path, = glob.glob(os.path.join(tmp, str(i), f"trace_w{i}",
                                           "plugins", "profile", "*",
                                           "*.json"))
            with open(path) as f:
                evs = json.load(f)["traceEvents"]
            dev = [e for e in evs if e.get("ph") == "X" and e.get("cat")
                   in ("kernel", "gpu_memcpy", "gpu_memset")]
            launch = {(e.get("args") or {}).get("correlation"): e["ts"]
                      for e in evs if e.get("ph") == "X"
                      and e.get("cat") in ("cuda_runtime", "cuda_driver")}
            lag = sorted(e["ts"] - launch[c] for e in dev
                         if (c := (e.get("args") or {}).get("correlation"))
                         in launch)
            marks = {e.get("name"): e.get("ts") for e in evs
                     if e.get("ph") == "i"}
            w0 = marks["Iteration Start: PyTorch Profiler"]
            w1 = marks["Record Window End"]
            first = min(e["ts"] for e in dev)
            last = max(e["ts"] + e["dur"] for e in dev)
            s = summary[margin]
            s["tries"] += 1
            s["lost"] += found != want
            lo = lag[0] / 1e3
            if s["min_launch_to_op_ms"] is None or lo < \
                    s["min_launch_to_op_ms"]:
                s["min_launch_to_op_ms"] = lo
            print(f"try {i} margin {margin} s: K1-K3 by name {found}, "
                  f"counters {want}, equal {found == want}; {len(dev)} "
                  f"device ops; launch to op earliest {lo:.3f} ms, median "
                  f"{lag[len(lag) // 2] / 1e3:.3f} ms; first op "
                  f"{(first - w0) / 1e3:.3f} ms after the start, last op "
                  f"ends {(w1 - last) / 1e3:.3f} ms before the stop",
                  flush=True)
    print(smi)
    print(json.dumps({"card": smi, "margins": {
        str(m): v for m, v in summary.items()}}))
    tracing.WINDOW_MARGIN_S = default
    return 1 if summary.get(default, {}).get("lost") else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
