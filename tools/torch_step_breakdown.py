"""Where one training step of the PyTorch/CUDA port spends its GPU time.

    python3 tools/torch_step_breakdown.py [config.yaml] [--packed-corpus DIR]
        [--doc-len N] [key=value ...]

Runs a config (``gpt2-small.yaml`` by default, at bsz 8 and bf16, the flash
kernels on every layer) through the port's entry point
``cli.train_dist.train``, hooked after each step: a few warm-up steps, a
few steps timed with CUDA events, then the same number traced with
``torch.profiler``. It sums the device time of every kernel by category
(the flash kernels K1-K3, the cross-entropy kernels K4/K5, cuBLAS matrix
products, the optimizer's foreach kernels, elementwise and reduction
kernels, copies), by ``observability/trace_analysis.op_category``: the one
table the trace attribution reads too. The device's idle share is one minus the union of kernel
intervals over the traced wall time, and also over the untraced step,
which the profiler's host work does not stretch. Extra ``key=value``
arguments override the config as in ``train_dist``
(``model.use_flash_attn=false`` times the plain attention core instead).
``--packed-corpus DIR`` writes the seeded packed corpus of ``chip_smoke.py``
phases 6, 7 and 9 (600 documents of about ``--doc-len`` tokens, 1500 by
default, in the vocabulary and with the eod id of the config's tokenizer,
``data.synthetic.corpus_tokenizer``: Qwen's 151643, Mistral's 2, Llama
3's 128001) into DIR with ``data.synthetic.write_random_corpus`` and
trains on it with packed documents and end-of-document loss masking.
Prints a table and, as its last line, the result as JSON. Needs one CUDA
card.

The Qwen2.5-7B-width path of ``chip_smoke.py`` phase 6 (4 layers, bsz 2,
seq 4096, fused cross-entropy, remat on every layer):

    python3 tools/torch_step_breakdown.py \
        hetu_galvatron_tpu/models/configs/qwen2.5-7b.yaml \
        --packed-corpus qwen_corpus model.num_hidden_layers=4 \
        model.use_fused_ce=true parallel.global_checkpoint=1 \
        parallel.global_train_batch_size=2

The Mixtral-8x7B-width path of phase 7 takes ``mixtral-8x7b.yaml`` and
``model.num_hidden_layers=2`` in their place. The zoo paths of phases
9-11:

    python3 tools/torch_step_breakdown.py \
        hetu_galvatron_tpu/models/configs/llama3.1-70b.yaml \
        --packed-corpus llama_corpus --doc-len 3000 \
        model.num_hidden_layers=2 model.use_fused_ce=true \
        parallel.global_checkpoint=1 parallel.global_train_batch_size=1
    python3 tools/torch_step_breakdown.py \
        hetu_galvatron_tpu/models/configs/bert-large.yaml \
        model.use_fused_ce=true parallel.global_train_batch_size=32
    python3 tools/torch_step_breakdown.py \
        hetu_galvatron_tpu/models/configs/t5-3b.yaml model.use_fused_ce=true \
        parallel.global_checkpoint=1 parallel.global_train_batch_size=16
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GPT2_YAML = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs",
                         "gpt2-small.yaml")
WARMUP, STEPS = 3, 4

def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main(argv) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_step_breakdown: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import (
        corpus_tokenizer,
        packed_corpus_overrides,
        write_random_corpus,
    )
    from hetu_galvatron_tpu_torch.observability.trace_analysis import (
        op_category,
    )
    from hetu_galvatron_tpu_torch.ops import _build

    config = GPT2_YAML
    if argv and argv[0].endswith((".yaml", ".yml")):
        config, argv = argv[0], argv[1:]
    argv = list(argv)
    doc_len = 1500
    if "--doc-len" in argv:
        i = argv.index("--doc-len")
        doc_len = int(argv[i + 1])
        del argv[i:i + 2]
    if "--packed-corpus" in argv:
        i = argv.index("--packed-corpus")
        corpus_dir = argv[i + 1]
        del argv[i:i + 2]
        os.makedirs(corpus_dir, exist_ok=True)
        prefix = os.path.join(os.path.abspath(corpus_dir), "corpus")
        name = load_config(config, argv).model.model_name
        write_random_corpus(prefix, docs=600, mean_len=doc_len,
                            **corpus_tokenizer(name))
        argv = packed_corpus_overrides(prefix) + argv
    args = load_config(config, ["parallel.global_train_batch_size=8",
                                "parallel.mixed_precision=bf16",
                                *argv,
                                f"train.train_iters={WARMUP + 2 * STEPS}"])
    cfg = args.model
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    # device activity only: recording every host op would slow the host
    # enough to idle the card between steps
    prof = profile(activities=[ProfilerActivity.CUDA])
    wall = {}

    def on_step(it, metrics):
        # steps [WARMUP, WARMUP + STEPS) timed, the next STEPS traced
        if it == WARMUP - 1:
            torch.cuda.synchronize()
            start.record()
        elif it == WARMUP + STEPS - 1:
            end.record()
            end.synchronize()
            _build.reset_launch_counts()
            prof.start()
            wall["t0"] = time.perf_counter()
        elif it == WARMUP + 2 * STEPS - 1:
            torch.cuda.synchronize()
            wall["us"] = (time.perf_counter() - wall["t0"]) * 1e6
            prof.stop()

    train(args, on_step=on_step)
    launches = dict(_build.launch_counts)
    step_ms = start.elapsed_time(end) / STEPS
    traced_wall_us = wall["us"]
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        print("torch_step_breakdown: the profiler recorded no device time",
              file=sys.stderr)
        return 3
    by_cat, by_name = {}, {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        cat = op_category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        by_name[e.name] = by_name.get(e.name, 0.0) + us
    busy_us = union_us((e.time_range.start, e.time_range.end)
                       for e in kernels)
    kernel_us = sum(by_cat.values())
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        config=dict(model=cfg.model_name, layers=cfg.num_hidden_layers,
                    global_batch=args.parallel.global_train_batch_size,
                    seq=cfg.seq_length,
                    dtype=args.parallel.mixed_precision,
                    flash=launches["flash_fwd"] > 0,
                    fused_ce=launches["ce_fwd"] > 0,
                    remat=args.parallel.global_checkpoint > 0,
                    packed=args.data.reset_attention_mask),
        step_ms_cuda_events=step_ms, traced_steps=STEPS,
        traced_step_ms_host=traced_wall_us / STEPS / 1e3,
        kernel_ms_per_step=kernel_us / STEPS / 1e3,
        busy_ms_per_step=busy_us / STEPS / 1e3,
        idle_share_of_kernel_span=1.0 - busy_us / span_us,
        idle_share_of_traced_wall=1.0 - busy_us / traced_wall_us,
        # the traced busy time over the untraced step: the idle share with
        # no profiler on the host
        idle_share_of_untraced_step=1.0 - busy_us / STEPS / 1e3 / step_ms,
        launches_per_step={k: v / STEPS for k, v in launches.items()},
        kernels_per_step=len(kernels) / STEPS,
        categories_ms_per_step={
            k: v / STEPS / 1e3 for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
        category_share_of_kernel_time={
            k: v / kernel_us for k, v in sorted(
                by_cat.items(), key=lambda kv: -kv[1])},
        top_kernels_ms_per_step={
            k[:120]: v / STEPS / 1e3 for k, v in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:15]},
    )
    print(f"{smi}\nstep {step_ms:.2f} ms (CUDA events, {STEPS} steps after "
          f"{WARMUP} warm-up); traced {out['traced_step_ms_host']:.2f} ms "
          f"a step, kernels {out['kernel_ms_per_step']:.2f} ms, device idle "
          f"{100 * out['idle_share_of_traced_wall']:.1f}% of the traced wall, "
          f"{100 * out['idle_share_of_untraced_step']:.1f}% of the untraced "
          "step")
    for k, ms in out["categories_ms_per_step"].items():
        print(f"  {k:<26} {ms:9.3f} ms  "
              f"{100 * out['category_share_of_kernel_time'][k]:5.1f}%")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
