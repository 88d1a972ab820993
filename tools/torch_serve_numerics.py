"""How far the serving engine's bf16 logits sit from a teacher-forced
forward, on one GPU.

    python3 tools/torch_serve_numerics.py [config.yaml] [layers=N]
        [requests=2] [prompt=600] [new=32]

Builds the config (``qwen2.5-7b.yaml`` by default) with random weights
from seed 1234, serves ``requests`` random prompts together through
``serving.engine.ServingEngine`` with its logits hook on, and compares
the logits each emitted token was picked from with:

* a teacher-forced ``models/builder.forward_causal_lm`` of prompt + stream
  in bf16 (the comparison of ``chip_smoke.py`` phase 14 (c));
* the same forward in fp32 over the same bf16-valued weights (the
  arithmetic both bf16 runs approximate).

For each pair it prints the error's RMS and largest element against the
want's RMS, and the worst element's share of the bf16 limit 2e-2 *
(rms(want) + |want|), first with cuBLAS's default bf16 GEMM reductions and
then with ``allow_bf16_reduced_precision_reduction`` off. The last line is
the result as JSON.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

QWEN_YAML = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs",
                         "qwen2.5-7b.yaml")


def stats(got, want, tol=2e-2):
    import torch

    got, want = got.double(), want.double()
    err = (got - want).abs()
    rms = want.square().mean().sqrt()
    ratio = err / (tol * (rms + want.abs()))
    return dict(err_rms_over_rms=float(err.square().mean().sqrt() / rms),
                max_err=float(err.max()), rms=float(rms),
                worst_over_limit=float(ratio.max()),
                rows_over_limit=int((ratio.amax(-1) > 1).sum()),
                rows=int(ratio.shape[0]))


def main(argv) -> int:
    import numpy as np
    import torch

    from hetu_galvatron_tpu_torch.core.args_schema import ServingArgs
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
    from hetu_galvatron_tpu_torch.models.builder import (
        forward_causal_lm,
        init_causal_lm,
    )
    from hetu_galvatron_tpu_torch.models.generate import cast_for_compute
    from hetu_galvatron_tpu_torch.observability.registry import (
        MetricsRegistry,
    )
    from hetu_galvatron_tpu_torch.serving.engine import ServingEngine

    yaml = next((a for a in argv if a.endswith(".yaml")), QWEN_YAML)
    kv = dict(a.split("=", 1) for a in argv if "=" in a)
    over = [f"model.num_hidden_layers={kv['layers']}"] if "layers" in kv \
        else []
    cfg = args_from_cli([yaml] + over, mode="train_dist").model
    n_req, plen, new = (int(kv.get("requests", 2)), int(kv.get("prompt", 600)),
                        int(kv.get("new", 32)))
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_causal_lm(cfg, seed=1234, device="cuda")
    cp = cast_for_compute(params, torch.bfloat16)
    del params
    torch.cuda.empty_cache()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, plen + 37 * i).tolist()
               for i in range(n_req)]
    out = {}
    for reduced in (True, False):
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            reduced
        sv = ServingArgs(max_batch_size=8, kv_block_size=16,
                         num_kv_blocks=1024, max_seq_len=2048,
                         max_new_tokens=new)
        eng = ServingEngine(cp, cfg, sv, registry=MetricsRegistry())
        rows = {}
        eng.logits_hook = lambda rid, i, lg: rows.__setitem__(
            (rid, i), lg.float())
        hs = [eng.submit(p) for p in prompts]
        eng.run_until_idle()
        eng.close()
        res = []
        for p, h in zip(prompts, hs):
            s = h.result(0)
            got = torch.stack([rows[(h.request.rid, i)]
                               for i in range(len(s))])
            toks = torch.tensor([p + s[:-1]], device="cuda")
            with torch.no_grad():
                tf16 = forward_causal_lm(cp, toks, cfg,
                                         compute_dtype=torch.bfloat16)[
                    0, len(p) - 1:].float()
                tf32 = forward_causal_lm(cp, toks, cfg,
                                         compute_dtype=torch.float32)[
                    0, len(p) - 1:].float()
            res.append(dict(engine_vs_tf_bf16=stats(got, tf16),
                            engine_vs_tf_fp32=stats(got, tf32),
                            tf_bf16_vs_tf_fp32=stats(tf16, tf32),
                            first_row_engine_vs_tf_bf16=stats(got[:1],
                                                              tf16[:1])))
        key = "reduced_precision_reduction_" + ("on" if reduced else "off")
        out[key] = res
        for i, r in enumerate(res):
            for name, st in r.items():
                print(f"{key} request {i} {name:<28} err rms/rms "
                      f"{st['err_rms_over_rms']:.4e} max {st['max_err']:.4e}"
                      f" worst/limit {st['worst_over_limit']:.3f} rows over "
                      f"{st['rows_over_limit']}/{st['rows']}", flush=True)
    print(json.dumps(dict(config=yaml, layers=cfg.num_hidden_layers,
                          results=out,
                          device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
