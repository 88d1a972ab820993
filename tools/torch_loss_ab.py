#!/usr/bin/env python
"""Same-call A/B of the port's training paths between two trees on one GPU.

::

    python3 tools/torch_loss_ab.py TREE [OUT.json]

Imports ``chip_smoke.py`` and the port from ``TREE`` (a checkout, such as
``git archive`` of another commit unpacked into a gitignored directory)
and runs its phase 5-7 paths: GPT-2 small (8 steps), the Qwen2.5-7B-width
path (4 layers, packed corpus, fused CE, remat, 8 steps and two evals)
and the Mixtral-8x7B-width path (2 layers, 8 steps and two evals). Each
path checks its own launches and loss sanity as in ``chip_smoke.py``. The
last line of the output, also written to ``OUT.json`` when given, is one
JSON object with the tree, the card (``nvidia-smi`` name and power
limit), and per path the losses, evaluation losses, step time and peak
memory. Run it for the parent and the change in turns (parent, change,
change, parent) in one call and compare the losses: equal losses mean
equal bits on this card.

    python3 tools/torch_loss_ab.py --compare FIRST.json OTHER.json ...

reads such lines and prints, per path, each other run against the first:
the largest relative difference of the losses over the steps, that of
step 0 (forward only at the same weights), of the evaluation losses, and
both runs' step ms; its last line is the same as JSON.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile


def _rel(a, b) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def compare(paths) -> int:
    runs = []
    for path in paths:
        with open(path) as f:
            runs.append(json.loads(f.read().strip().splitlines()[-1]))
    first, out = runs[0], []
    for path, run in zip(paths[1:], runs[1:]):
        for name in ("gpt2", "qwen", "mixtral"):
            a, b = run[name], first[name]
            rel = [_rel(x, y) for x, y in zip(a["losses"], b["losses"])]
            def ev(r):
                return ([v["loss"] for v in r.get("val_losses") or []]
                        + ([] if r.get("test_loss") is None
                           else [r["test_loss"]]))

            evals = [_rel(x, y) for x, y in zip(ev(a), ev(b))] or [0.0]
            rec = dict(run=path, against=paths[0], path=name,
                       steps=len(rel), max_rel_loss_diff=max(rel),
                       step0_rel_diff=rel[0], max_rel_eval_diff=max(evals),
                       bit_identical=a["losses"] == b["losses"],
                       step_ms=a["step_ms"], step_ms_first=b["step_ms"])
            out.append(rec)
            print(f"{name:<8} {path} against {paths[0]}: losses max rel "
                  f"{rec['max_rel_loss_diff']:.3e} over {len(rel)} steps, "
                  f"step 0 {rel[0]:.3e}, evals {rec['max_rel_eval_diff']:.3e}"
                  f"{' (bit-identical)' if rec['bit_identical'] else ''}; "
                  f"step {a['step_ms']:.2f} ms against {b['step_ms']:.2f}")
    print(json.dumps({"compare": out}))
    return 0


def main(argv) -> int:
    if argv[:1] == ["--compare"] and len(argv) >= 3:
        return compare(argv[1:])
    if len(argv) not in (1, 2):
        print(__doc__, file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[0])
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        print("torch_loss_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    if os.path.dirname(os.path.abspath(cs.__file__)) != tree:
        print(f"torch_loss_ab: imported {cs.__file__}, not {tree}",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    peak_flops = cs.card_peaks(smi)[0]
    keys = ("losses", "val_losses", "test_loss", "step_ms", "peak_mem_gb",
            "launches")
    out = {"tree": tree, "card": smi}
    with tempfile.TemporaryDirectory(prefix="torch_loss_ab_") as tmp:
        gpt2 = cs.main_path(peak_flops)
        torch.cuda.empty_cache()
        qwen = cs.qwen_path(peak_flops, tmp)
        torch.cuda.empty_cache()
        prefix, stats, _, _ = cs.mixtral_corpus(tmp)
        mixtral = cs.mixtral_path(peak_flops, prefix, stats)
    for name, run in (("gpt2", gpt2), ("qwen", qwen), ("mixtral", mixtral)):
        out[name] = {k: run.get(k) for k in keys}
    line = json.dumps(out)
    if len(argv) == 2:
        with open(argv[1], "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
