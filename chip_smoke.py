"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository. It needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and imports nothing of JAX or of the JAX package. Phases,
each of which ends the run with a non-zero exit when it fails:

1. device: the card's name and power limit (``nvidia-smi``) and CUDA version;
2. build: compile the kernels K1-K5 (flash attention, fused cross-entropy)
   from ``hetu_galvatron_tpu_torch/csrc`` with ``nvcc`` for ``sm_90a``, and
   print the build seconds and each kernel's registers and spills
   (``-Xptxas -v``; a spill fails the run);
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, every element held within its tolerance, timed beside the plain
   version, one PyTorch library call and the card's bound for the same
   work. K1-K3 at GPT-2 small's training shape (B=8, N=K=12, S=1024, D=64,
   bf16 and fp32, causal, q/k/v as strided views of the fused qkv
   projection), at the Qwen2.5-7B path's (B=2, N=28, K=4, S=4096, D=128,
   bf16 and fp16, causal with packed segments) and on small cases covering
   GQA, segment ids (also repeating out of order), dropout, non-causal
   Sk != S, a ragged S, D=32 and D=40, rows whose stride is not a multiple
   of 8 elements, and fp16 (bf16 and fp16 at D = 64 or 128 on operands
   TMA can describe run K1 and K2 on their wgmma + TMA kernels, other
   16-bit cases and K3 on the mma.sync kernels, fp32 the FMA kernels:
   ``ops/flash_attention.kernel_route``). At every path's shape (GPT-2,
   Qwen packed and, as phase 17 runs it, unpacked, Mixtral, Llama, BERT,
   T5's three; phase 16's Qwen B=1 and phase 18's tp2 in those phases'
   kernel checks) it prints the route
   each kernel took and times K1 and K2 on the wgmma route against the
   mma.sync route in turns (mma, wgmma, wgmma, mma), with both routes'
   share of the bound and the goal (half the bound; bf16's hi + lo caps
   it at 2/3). For K1-K3 at both main shapes it also reports
   TFLOP/s over the kept pairs, the share of the bound, K1 against the
   library forward and K2 + K3 against the library backward, and in its log
   the tiles the tile rule (``computed_tiles``) computes against the tiles
   of the causal triangle; at the Qwen shape it times them in fp16 too
   (fp16 rounds P, and K2/K3's dS, once where bf16 carries them as hi +
   lo). K4/K5 at
   the Qwen path's logits (T=8192, V=152064, fp32 and bf16) and on small
   cases: ragged T, V not a multiple of 128, labels at -1 and V, a row of
   equal logits, a row stride larger than V, fp16, and the z-loss through
   the autograd composition;
   At the Mixtral path's shapes: K1-K3 at B=2, N=32, K=8, S=4096, D=128
   (bf16, causal, the segments of the path's first batch that packs
   several documents in every row) and K4/K5 at T=8192, V=32000 (fp32).
   At the zoo paths' shapes (phases 9-11), all bf16 for K1-K3 and fp32
   logits for K4/K5: BERT's B=32, N=K=16, S=512, D=64 non-causal; T5's
   B=16, N=K=32, S=256, D=64 three ways (the encoder's non-causal
   self-attention, the decoder's causal self-attention and the
   non-causal cross-attention, q from its own projection and k/v from the
   fused kv projection of the encoder memory); Llama's B=1, N=64, K=8,
   S=8192, D=128 over the documents of the path's first batch (the plain
   versions run over 8 slices of the kv heads: the dense scores of all 64
   heads would take 17 GB a tensor); K4/K5 at T=8192, V=128256, T=16384,
   V=30592 and T=4096, V=32128;
4. reference: small models trained a few steps on the card, the flash
   kernels against the plain attention core, and fused cross-entropy with
   per-layer remat and packed documents against the plain loss without
   remat; a small Mixtral-shaped MoE model through the flash kernels, fused
   CE and remat against the plain core and loss, and its dropless dispatch
   against capacity dispatch with a capacity that drops nothing;
5. main path of slice 1: ``hetu_galvatron_tpu_torch.cli.train_dist.train``
   on ``gpt2-small.yaml`` at full width and depth (bsz 8, seq 1024, bf16);
6. main path of slice 2: ``train`` on ``qwen2.5-7b.yaml`` at full width cut
   to 4 layers (bsz 2, seq 4096, bf16, fused cross-entropy, remat on every
   layer) over a packed indexed corpus written from a seed, with
   end-of-document loss masking, 8 steps and an eval of the valid and test
   splits;
7. main path of slice 5: ``train`` on ``mixtral-8x7b.yaml`` at full width
   cut to 2 layers (8 experts of SwiGLU 14336, top-2, capacity dispatch;
   bsz 2, seq 4096, bf16, fused cross-entropy, remat on every layer) over a
   seeded packed corpus in Mistral's vocabulary (eod 2), 8 steps and the
   two evals. It checks every step's tokens per expert, prints the share of
   slots each layer drops at capacity, and prints the MFU twice: by the
   JAX formula (one expert's MLP a token) and by the FLOPs the step
   executes (top-2 experts at capacity, dispatch and combine, remat);
8. main path of slice 6, the checkpoint and fault lifecycle, each drill
   through ``python -m hetu_galvatron_tpu_torch.cli.supervise`` (children
   ``cli.train_dist``, each writing its summary line, ``extra.summary_
   path``): phase 6's config cut to 1 layer (1,323,056,128 parameters,
   15.88 GB of params, mu and nu a checkpoint) runs
   6 steps uninterrupted,
   then again with a real SIGTERM at step 2 (``rerun.inject_kind=
   preempt``): the child checkpoints step_3 at the boundary and exits 18,
   the relaunch resumes at step 3 and exits 0; the stitched losses, the
   evaluation losses and a SHA-256 of every final parameter must equal the
   uninterrupted run's, each child's launches must be its steps' and
   evals', and the save and load times, bytes, peak memory and
   ``supervisor.term_grace_s`` against the save time are printed. Then
   GPT-2 small at full size saves every 2 steps and is SIGKILLed in the
   commit window of step_4 (``chaos.kind=kill_mid_save``): the relaunch
   must resume from step_2, never the torn ``step_4.tmp``, and end
   bit-identical to an uninterrupted run. The checkpoints live in a
   temporary directory that must hold 2.5 checkpoints of free space and is
   removed at exit, with the children's logs (a failing drill prints the
   end of its log).
   ``python3 chip_smoke.py --lifecycle-only`` runs phases 1, 2 and 8 alone.
9. main path of slice 7: ``train`` on ``llama3.1-70b.yaml`` at full width
   (llama3 rope scaling, GQA 64:8, SwiGLU 28672, vocab 128256, untied
   head) cut to 2 layers, bsz 1 at seq 8192, bf16, fused cross-entropy,
   remat on every layer, over a seeded packed corpus in Llama 3's
   vocabulary (eod 128001, documents of about 3000 tokens);
10. ``bert-large.yaml`` at full depth (24 post-norm layers, bidirectional
    flash, tied MLM head, vocab 30592), bsz 32 at seq 512, random tokens
    through the masked-LM batches, fused cross-entropy over the masked
    loss, no remat;
11. ``t5-3b.yaml`` at full depth (24 encoder + 24 decoder layers), bsz 16
    at seq 512 split into 256 + 256, fused cross-entropy, remat on every
    layer of both stacks; flash runs the encoder's self-attention, the
    decoder's causal self-attention and the cross-attention.
   Each of 9-11 runs 5 steps (3 timed after 2 warm-up) and the valid and
   test evals, and prints step ms, tokens/s, the MFU by the JAX formula
   (phase 11 also by executed FLOPs), peak memory (under 79 GiB), exact
   launches and the step-0 loss against ln V + sigma^2 / 2.
   ``python3 chip_smoke.py --zoo-only`` runs phases 1-3 and 9-11.
12. main path of slice 8, the batch-size ramp and observability:
    phase 6's config (4 layers, seq 4096, fused cross-entropy, remat, the
    packed corpus) at a global batch of 8 in 4 microbatches of 2 under
    ``train.rampup_batch_size=[2,2,24]`` for 14 steps (batches 2, 2, 2,
    2, 4, 4, 6, 6, 8, ..., 8: 38 microbatches), run twice through
    ``train``: (a) observability off; (b) the JSONL metrics stream (a
    record set per step, tokens/s over the default window, which spans
    the whole run), the flight recorder and a ``torch.profiler`` trace of
    iterations 10-11. Exact launches of the 38 microbatches in each run;
    losses and a SHA-256 of every parameter bit-identical between (a) and
    (b); the stream's gauges; the telemetry's tokens/s over steps 1-13
    and, from the per-step gauges, over the untraced batch-8 steps 8, 9,
    12, 13, each within 3% of the same steps' tokens over their CUDA-event
    time (events at each step's end, after the loss read has drained the
    stream: the host's step interval on a second clock);
    ``trace_analysis.attribute`` over the trace: 2 steps, K1-K5 by kernel
    name as often as the launch counters over the window, the device wall
    a step within 10% of the window's CUDA events, its categories (by
    ``op_category``, the table ``tools/torch_step_breakdown.py`` reads);
    (b)'s median untraced step within 2% of (a)'s or inside (a)'s
    spread; peak memory under 79 GiB.
13. GPT-2 small at full size under ``cli.supervise`` with
    ``supervisor.metrics_port=0``, the metrics stream and the flight
    recorder: a checkpoint every 2 steps, a real SIGTERM at step 3 (exit
    18), a relaunch that resumes and finishes 6 steps. It reads the
    printed port, polls ``/healthz`` (attempt 2, last child exit 18) and
    scrapes ``/metrics`` (Prometheus text with ``supervisor_*`` and
    ``train_*`` series); the final child's goodput survived 1 restart with
    productive, first-step, checkpoint and resume time above 0 and a sum
    within the supervisor's wall; the flight dumps carry JAX's reasons
    (``signal:SIGTERM``, ``child_exit_18``) and ``cli/summarize.py`` reads
    each; the stitched losses and parameters equal an uninterrupted run's.
    ``python3 chip_smoke.py --obs-only`` runs phases 1-3, 12 and 13.
14. main path of slice 9, KV-cache decode and the serving engine, with
    the launch counters reset before each run and K1-K5 required to
    launch 0 times (the serving path runs the plain attention core):
    (a) ``qwen2.5-7b.yaml`` uncut (28 layers, 7.62 B parameters, random
    from seed 1234, matrices cast to bf16 once) behind
    ``serving.engine.ServingEngine`` (8 lanes, blocks of 16, a pool of
    4096 blocks, ``max_seq_len`` 2048): 32 greedy requests from seed 0
    (prompts of 64-1024 random ids, 16 of them opening with one
    512-token prefix, the last the prefix alone; 128 new tokens;
    arrivals over the first second), run plain, again plain with
    ``serving.trace_requests=1``, with ``serving.prefix_cache=1`` and
    with ``serving.spec_decode=1`` (n-gram, k 4); each prints TTFT and
    inter-token p50 / p99, tokens/s, the peak KV occupancy, peak memory,
    the prefix hit rate with TTFT cold against hit, the spec accept
    rate; a traced window of 16 steps of each gives the device's idle
    share over decode steps. (b) exact gates: the repeat run equals the
    first bit for bit, four requests served alone equal their streams
    among the 32, the decode (verify) step keeps one input shape, at
    idle the allocator holds only the prefix cache's blocks, every
    request's event timeline is complete, peak memory under 79 GiB.
    (c) numerical gates, in fp32 (the bf16 forward of this model sits
    11-14x the bf16 limit from its own fp32 twin, so no bf16 run can
    meet that rule): the engine's logits at every emitted position of
    five requests (a cold run, prefix hits with the fully cached path,
    spec decode) against a teacher-forced fp32 forward under the fp32
    rule, and the streams of the engine against the offline ``generate``,
    of prefix hits and of spec decode against cold runs, any parting
    held to the same rule at its position; the bf16 pairs (the engine
    against the offline ``generate`` at batch 4, prefix hits and spec
    decode against plain) are printed: equal streams, each parting's
    position and both runs' top-2 gaps, from replays that must repeat
    the runs bit for bit. (d) ``generate_encdec`` on ``t5-3b.yaml`` at
    full depth (batch 4, encoder 256, 32 tokens) against a
    teacher-forced ``forward_encdec``: fp32 under the fp32 rule, bf16
    timed. (e) ``cli.serve`` on GPT-2 small as a child on the card with
    ``requests.jsonl``, ``metrics=``, request tracing and ``watch=`` on
    a checkpoint root where a second checkpoint is committed once it
    serves: one swap or more, no request dropped, the requests sent
    after the swap equal a fresh engine's on the new weights bit for
    bit, ``serve/swap_stall_ms`` printed, ``cli/summarize.py --timeline
    all`` finds every timeline complete. The memory doctor's KV-pool
    component for (a)'s serving args must equal the bytes of the pool
    tensors the plain run's engine allocated, exactly.
    ``python3 chip_smoke.py --serve-only`` runs phases 1, 2 and 14.
15. main path of slice 10, Galvatron's profile -> search -> train loop
    at world 1, on phase 6's cell (``qwen2.5-7b.yaml`` at full width cut
    to 4 layers, fused cross-entropy, bf16, the seeded packed corpus):
    (a) ``cli.profiler mode=profile_hardware`` writes the four world-1
    files, held to the literal text JAX writes; (b) ``cli.profiler
    mode=model_profiler`` times the forward (batch mode, bsz 1-8 at seq
    4096, 2 and 4 layers; exactly 22 x 6 K1 launches a batch size) and
    prints the per-layer and "other" ms, and what batch mode's fit would
    read at a microbatch of 1; (c) the memory profile (seq 4096, bsz 1,
    remat off and on; exact K1-K5 launches; ``parameter_size`` equal to a
    layer's parameters x 4 / 2^20), and the step's peak a layer beside
    it; (d) ``cli.search_dist`` at world 1
    (bsz 1-16, ddp, the profile read in static mode) at 64 GB and at a
    tighter budget it derives from (c), at which the plan checkpoints
    some layers and not others, and the uncut 28 layers at 80 GB, which
    must find no plan; (e) ``cli.train_dist`` with
    ``parallel.config_mode=json`` trains each plan 6 steps: finite losses
    within the step-0 rule, exact launches per microbatch, peak under 79
    GiB; measured step against the plan's ``predicted_time_cost_ms`` and
    peak against the budget, reported; (f) a plan whose flags are all
    equal trains bit for bit as GLOBAL mode with the same batch, chunks
    and ``parallel.global_checkpoint`` (losses and every parameter's
    SHA-256); (g) the memory doctor's world-1 accounting of both plans
    beside their measured peaks (reported; its cost-model cross-check
    must be clean), and an all-off plan of the uncut 28 layers rejected
    at 80 GB with ``hbm_budget_reason``'s text; (h) the search again
    under ``search.hbm_budget_gb`` 1 GB below the 64 GB plan's doctor
    peak, at 64 GB (the gate must prune that plan) and at the tight
    budget; the first search's winner, else the second's, must differ
    from the 64 GB plan and fit the budget, and trains under (e)'s gates;
    (i) ``cli.check --plan`` and ``--plan --memory --hbm-gb 80`` on the
    64 GB plan, each in a child process, exit 0. ``python3 chip_smoke.py
    --plan-only`` runs phases 1, 2 and 15.
16. main path of slice 12, the pipeline engine (``runtime/pipeline.py``)
    through ``train``, one rank a stage, every stage on this card (the
    run logs that the ranks share it): (a) GPT-2 small uncut, pp 4 GPipe,
    batch 8 in 4 microbatches at seq 1024, 6 steps: the step-0 loss
    against a pp=1 run of the same weights, batch and chunks within 1e-4
    relative, phase 5's loss gate, ``wte`` against the last stage's
    ``whead.T`` within 1e-6 relative (bit equality printed), exact
    launches; the same run saved at step 3 and resumed in a fresh
    ``train`` to step 6 must equal it bit for bit (losses, a SHA-256 of
    every stage parameter); (b) Qwen2.5-7B widths at 4 layers, seq 4096,
    batch 4 in 4 microbatches on phase 6's packed corpus: pp 2 1F1B from
    a JSON plan (division [2, 2]) and pp 2 x vpp 2 ([1, 1, 1, 1]), no
    per-layer checkpoint, 4 steps each, against a pp=1 run with the plain
    cross-entropy and the same chunks: step-0 losses within 1e-4
    relative, exact launches, peak under 79 GiB; step ms, peak and the
    memory doctor's stage peaks summed printed beside pp=1's; (c) T5-3B
    uncut, pp 2 [24, 24] GPipe, batch 16 in 2 microbatches, 3 steps:
    phase 11's loss gate, exact launches, peak. Launches a step: K1 (2 L
    - L_head + C) and K2, K3 L a microbatch (a T5 decoder layer counts
    twice), K4/K5 none: the head stage runs the plain cross-entropy, as
    JAX's does. Each run also prints the stage spans' host ms a
    microbatch. ``python3 chip_smoke.py --pipe-only`` runs phases 1, 2
    and 16.
17. main path of slice 13, the compiled 1F1B pipeline
    (``runtime/compiled_pipeline.py``) through ``train`` with
    ``pipeline.schedule_impl=compiled``, every stage lane on this card,
    each step one replay of a captured CUDA graph; first K1-K3 against
    their plain versions at its folded shapes (GPT-2 B=8, Qwen B=2
    unpacked). (a) GPT-2 small uncut, pp 4 1F1B [3, 3, 3, 3], batch 8 in 4
    microbatches, 6 steps, observability on and the replays of steps 2-3
    traced, against 4 steps of the host engine 1F1B and a pp=1 run of the same
    weights, batches and chunks: step-0 loss and grad norm and the losses
    of steps 1-3 within 1e-4 relative of each, one capture, exact
    launches, the traced replays' kernels by name equal to the launch
    counters over the same steps (each replay adds the census its capture
    recorded), the tied ``wte`` against the host engine's ``wte`` and
    ``whead.T`` within 1e-4 relative in norm; (b) Qwen2.5-7B widths at 4
    layers, seq 4096, batch 4 in 4 microbatches on phase 6's corpus
    unpacked (packed documents are ineligible), the pp 2 [2, 2] JSON plan,
    the same gates, peak under 79 GiB; (c) the reshard drill on (a)'s
    plan: the host engine's checkpoint at step 2 into the compiled engine
    and the compiled run's into the host engine
    (``runtime/reshard.resume_elastic``), leaves and moments bit-equal
    and each destination's next step finite; the compiled run resumed at
    step 2 equals (a)'s bit for bit (losses, a SHA-256 of every leaf).
    Launches a step: K1 T (2 + C) lps, K2 = K3 = T lps with T = m + 2 (pp
    - 1), no K4/K5. Printed: step ms of the compiled run, the host
    engine's and pp=1's; host ms a step outside the replay; bubble_frac;
    peak beside the memory doctor's compiled stage peaks summed; the
    recorded ``cost/flops``. ``python3 chip_smoke.py --compiled-only``
    runs phases 1, 2 and 17.
18. main path of slice 14, layer-wise hybrid plans across ranks: first
    K1-K3 at the ranks' local shapes (GPT-2 B=4 N=6, B=8 N=3 bf16 and with
    B=2 N=12 fp32; Qwen tp2 N=14 K=2 on packed rows) and K4/K5 on the Qwen
    cell's vocab shard (T=8192, V/2 = 76032, labels of the whole
    vocabulary offset by the shard) against their plain versions, timed beside the library and
    the bound; then ``cli/train_dist.train`` in each rank of worlds spawned
    by ``parallel/launch.spawn_world``, the ranks sharing the card over
    gloo (NCCL puts no two ranks of one communicator on one card): (a)
    GPT-2 small uncut, W=4, batch 8, seq 1024, 4 steps under dp4 DDP,
    ZeRO-3 (``sdp`` + ``embed_sdp``), tp4 + vtp4 and a searched-style JSON
    plan (layers 0-5 tp2 x dp2 ZeRO-2, 6-11 tp4, the vocab layer dp4
    ZeRO-2), each in fp32, the mixed plan also in bf16; (b)
    Qwen2.5-7B widths W=2, tp2 + vtp2, fused CE (K4/K5 per vocab shard), full remat,
    phase 6's packed corpus, seq 4096, batch 2: bf16 at 4 layers and fp32
    at 1. Gates: exact launches on every rank (GPT-2 12 / 12 / 12 of K1-K3
    a step; Qwen 2 K1 + 1 K2 + 1 K3 a layer and one K4 and K5 a step); the
    fp32 runs' losses within 1e-5 relative of a W=1 run of the same weights
    and batches and their gathered parameters within rtol 5e-4, atol 3e-4
    of it; DDP replicas bit-identical after every step (an exact
    fingerprint of the bits); ZeRO-3 ranks holding 1/dp of every 2-D+ leaf;
    the bf16 runs' step-0 loss gate of phases 5 and 6 and their losses
    printed beside W=1's; the Qwen ranks' summed peak and what
    ``nvidia-smi`` sees held under 79 GiB. Printed: the backend and
    transport, every run's collectives by kind with their bytes, step ms
    beside the W=1 step, each rank's peak. ``python3 chip_smoke.py
    --spmd-only`` runs phases 1, 2 and 18.

Each path runs with the launch counters reset just before it and read
just after, and must launch each of its kernels exactly as often as its
layers, steps and evals say. Every line the script prints also goes to
``chip_smoke.log`` beside it (the whole run, where a remote runner shows
only the output's end).

The last lines are the serving JSON line (phase 14's numbers and gates),
the plan JSON line (phase 15's), the pipeline JSON line (phase 16's), the
compiled JSON line (phase 17's), the SPMD JSON line (phase 18's), the
kernels JSON line, the ``nvidia-smi`` line and ``{"ok": true,
"device": {...}}``. Each kernel's row carries, under
``paths``, one block per path that runs it: its launches in that run, per
training step and in the no-grad evals, beside the kernel, plain, library
and bound times measured at that path's shape. The row's own ``launches``
and times are those of slice 7's Llama path (phase 9), the one that runs
every kernel at the largest shapes; under ``--obs-only``, those of phase
12's ramp path. K1-K3's blocks also carry the
measured part of the report above; T5's block carries its three shapes
under ``by_shape``.
"""

from __future__ import annotations

import gc
import glob
import inspect
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIGS = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs")
GPT2_YAML = os.path.join(CONFIGS, "gpt2-small.yaml")
QWEN_YAML = os.path.join(CONFIGS, "qwen2.5-7b.yaml")
# the slice-1 training shape (GPT-2 small at bsz 8)
B, N, S, D = 8, 12, 1024, 64
# the slice-2 path: Qwen2.5-7B widths, 4 of 28 layers, bsz 2 at seq 4096
QB, QN, QK, QS, QD = 2, 28, 4, 4096, 128
QWEN_LAYERS = 4
QT, QV = QB * QS, 152064  # rows and padded vocab of the path's logits
QWEN_EOD = 151643  # Qwen's <|endoftext|>
QWEN_TOKENIZER_VOCAB = 151665  # len() of the Qwen2.5 tokenizer
# the slice-5 path: Mixtral-8x7B widths, 2 of 32 layers, bsz 2 at seq 4096
MIXTRAL_YAML = os.path.join(CONFIGS, "mixtral-8x7b.yaml")
MB, MN, MK, MS, MD = 2, 32, 8, 4096, 128
MIXTRAL_LAYERS = 2
MT, MV = MB * MS, 32000  # rows and vocab of the path's logits
# the slice-7 paths, the rest of the model zoo: Llama-3.1-70B widths, 2 of
# 80 layers, bsz 1 at seq 8192; BERT-large and T5-3B at full depth
LLAMA_YAML = os.path.join(CONFIGS, "llama3.1-70b.yaml")
BERT_YAML = os.path.join(CONFIGS, "bert-large.yaml")
T5_YAML = os.path.join(CONFIGS, "t5-3b.yaml")
LB, LN, LK, LS, LD = 1, 64, 8, 8192, 128
LLAMA_LAYERS = 2
LT, LV = LB * LS, 128256  # rows and vocab of the path's logits
BB, BN, BS, BD = 32, 16, 512, 64
BT, BV = BB * BS, 30592
T5B, T5N, T5S, T5D = 16, 32, 256, 64  # each stack's length is seq / 2
T5T, T5V = T5B * T5S, 32128  # the decoder's rows of logits
ZOO_ITERS = 5  # 2 warm-up steps, 3 timed
MEM_LIMIT_GIB = 79.0  # the card's 80 GB less what CUDA itself holds
TRAIN_ITERS = 8
BIG_REPS = 5  # timing repetitions at the Qwen path's shapes
PROFILE_WARMUP = 2
REPS = 20
SPIN_CYCLES = 200_000_000  # about 0.1 s at the H100's clock
# elementwise tolerances: an output passes when every element satisfies
# |got - want| <= tol * (rms(want) + |want|). 16-bit outputs round to 8
# (bf16) or 11 (fp16) mantissa bits, at most 2^-7 of the value, and the
# plain version sums in another order; fp32 kernels agree to summation
# order. Scaling by the RMS rather than the largest magnitude keeps the
# limit well under a typical element at S=1024, where the first causal rows
# set the largest magnitude.
TOL_16 = 2e-2
TOL_FP32 = 1e-4
TOL_LSE = 1e-3  # absolute, on the flash kernels' fp32 logsumexp
TOL_CE_LSE = 1e-4  # absolute, on K4's fp32 logsumexp (one row, no tiles)

KERNELS = {
    "flash_fwd": dict(
        route="cuda",
        source="hetu_galvatron_tpu_torch/csrc/flash_fwd_sm90.cu",
        mma_source="hetu_galvatron_tpu_torch/csrc/flash_fwd.cu",
        replaces="hetu_galvatron_tpu/ops/pallas/flash_attention.py:86",
        library_call="torch.nn.functional.scaled_dot_product_attention "
                     "(forward)"),
    "flash_bwd_dkdv": dict(
        route="cuda",
        source="hetu_galvatron_tpu_torch/csrc/flash_bwd_sm90.cu",
        mma_source="hetu_galvatron_tpu_torch/csrc/flash_bwd.cu",
        replaces="hetu_galvatron_tpu/ops/pallas/flash_attention.py:248",
        library_call="scaled_dot_product_attention backward (dq, dk and dv "
                     "in one call: the yardstick of K2 + K3 together)"),
    "flash_bwd_dq": dict(
        route="cuda", source="hetu_galvatron_tpu_torch/csrc/flash_bwd_dq.cu",
        replaces="hetu_galvatron_tpu/ops/pallas/flash_attention.py:324",
        library_call="scaled_dot_product_attention backward (dq, dk and dv "
                     "in one call: the yardstick of K2 + K3 together)"),
    "ce_fwd": dict(
        route="cuda", source="hetu_galvatron_tpu_torch/csrc/ce_fwd.cu",
        replaces="hetu_galvatron_tpu/ops/pallas/cross_entropy.py:47",
        library_call="torch.nn.functional.cross_entropy(reduction='none')"),
    "ce_bwd": dict(
        route="cuda", source="hetu_galvatron_tpu_torch/csrc/ce_bwd.cu",
        replaces="hetu_galvatron_tpu/ops/pallas/cross_entropy.py:77",
        library_call="the backward of torch.nn.functional.cross_entropy("
                     "reduction='none')"),
}
FLASH = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
BWD = ("flash_bwd_dkdv", "flash_bwd_dq")
QWEN_FP16 = f"qwen B={QB} N={QN} K={QK} S={QS} D={QD} fp16 seg"
# the same unpacked: where SDPA runs its own flash kernel (a packed row
# needs a boolean mask, which takes SDPA's slower path)
QWEN_FP16_UNPACKED = f"qwen B={QB} N={QN} K={QK} S={QS} D={QD} fp16 causal"


class SmokeFailure(RuntimeError):
    pass


# every line ``log`` prints also goes here (the output's end is what a
# remote runner shows; the file keeps the whole run)
LOG_PATH = os.path.join(ROOT, "chip_smoke.log")
_log_file = None


def log(msg: str = "") -> None:
    print(msg, flush=True)
    if _log_file is not None:
        _log_file.write(msg + "\n")
        _log_file.flush()


def phase(title: str) -> None:
    log(f"\n== {title}")


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        raise SmokeFailure(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def kernel_label(mangled: str) -> str:
    """A kernel's name, dtype and instantiation from its mangled symbol
    (``galv::<name><T, DP, AL>``)."""
    m = re.match(r"_ZN4galv(\d+)", mangled)
    if m is None:
        return mangled
    n = int(m.group(1))
    name, rest = mangled[m.end():m.end() + n], mangled[m.end() + n:]
    dtype = ("bf16" if rest.startswith("I13__nv_bfloat16") else
             "fp16" if rest.startswith("I6__half") else "fp32")
    label = f"{name} {dtype}"
    dp, al = re.search(r"Li(\d+)E", rest), re.search(r"Lb([01])E", rest)
    if dp and name.endswith("_wg"):
        label += f" D={dp.group(1)} wgmma + TMA"
    elif dp:
        label += f" D<={dp.group(1)}"
    if al:
        label += " 16-byte copies" if al.group(1) == "1" else " element loads"
    return label


def ptxas_report(log_path: str):
    """[(kernel, registers, spill store bytes, spill load bytes)] from the
    ``-Xptxas -v`` output of the build."""
    rows, name, spill = [], None, (0, 0)
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = kernel_label(m.group(1))
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name is not None:
                rows.append((name, int(m.group(1)), *spill))
                name = None
    return rows


def card_peaks(name: str):
    """(dense bf16 FLOP/s, memory bytes/s) from NVIDIA's data sheets."""
    if "PCIe" in name:
        return 756e12, 2.0e12, "H100 PCIe: 756 TFLOP/s bf16, 2.0 TB/s"
    return 989e12, 3.35e12, "H100 SXM: 989 TFLOP/s bf16, 3.35 TB/s"


def time_ms(fn, reps: int = REPS) -> float:
    """Mean device time of one call, by CUDA events over ``reps`` calls
    after two warm-up calls. A spin kernel (about 0.1 s) holds the card
    while the host enqueues the calls, so the events measure the device
    and not the host: a call whose launch costs the host more than its
    kernels cost the card (the library backward's autograd traversal)
    would otherwise be timed at the host's pace."""
    import torch

    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want, tol: float, absolute: bool = False):
    """Holds ``got`` against ``want`` elementwise: every element within
    ``tol * (rms(want) + |want|)`` (or within ``tol`` when ``absolute``).
    Returns the max abs error, its share of ``want``'s RMS and largest
    magnitude, and the worst element's share of its limit; raises past it."""
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape:
        raise SmokeFailure(f"{name}: shape {tuple(got.shape)} != "
                           f"{tuple(want.shape)}")
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise SmokeFailure(f"{name}: non-finite kernel output")
    diff = (g - w).abs()
    err = float(diff.max())
    scale = float(w.abs().max())
    rms = float(w.square().mean().sqrt())
    if absolute:
        ratio = err / tol
    else:
        ratio = float((diff / (tol * (rms + w.abs()))).max())
    ok = ratio <= 1.0
    log(f"  {name:<34} max_abs_err {err:.3e}  rms {rms:.3e}  max "
        f"{scale:.3e}  err/rms {err / max(rms, 1e-30):.3e}  worst/limit "
        f"{ratio:.3f}  tol {tol:.0e}{' abs' if absolute else ''}  "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SmokeFailure(f"{name}: an element is {ratio:.3f}x its limit "
                           f"(tol {tol})")
    return {"output": name, "max_abs_err": err, "scale": scale, "rms": rms,
            "err_over_rms": None if absolute else err / max(rms, 1e-30),
            "rel_err": None if absolute else err / max(scale, 1e-30),
            "worst_over_limit": ratio, "tol": tol,
            "tol_kind": "abs" if absolute else "elementwise"}


def segments_for(batch: int, s: int, dev, kind="packed"):
    """Segment ids [batch, s]: three packed documents (thirds, halves,
    sixths of the row), or with ``kind="unsorted"`` runs of 1-80 positions
    whose ids (0-3) repeat out of order, as 0, 1, 0, 2 would."""
    import torch

    if kind == "unsorted":
        gen = torch.Generator().manual_seed(s)
        rows = []
        for _ in range(batch):
            runs = []
            while sum(map(len, runs)) < s:
                ln = int(torch.randint(1, 81, (1,), generator=gen))
                runs.append(torch.full((ln,), int(torch.randint(
                    0, 4, (1,), generator=gen)), dtype=torch.int32))
            rows.append(torch.cat(runs)[:s])
        return torch.stack(rows).to(dev)
    seg = torch.zeros((batch, s), dtype=torch.int32)
    seg[:, s // 3:s // 3 + s // 2] = 1
    seg[:, s // 3 + s // 2:] = 2
    return seg.to(dev)


def plain_flash(groups: int = 1):
    """The plain versions of K1, K2 and K3, run over ``groups`` slices of
    the kv heads (each with its q heads) and joined along the heads: the
    same function, with the dense [S, Sk] scores of one slice at a time in
    memory (at the Llama path's S=8192 all 64 heads would take 17 GB a
    score tensor). Slices would renumber the heads of the dropout mask, so
    they take no dropout."""
    import torch

    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    if groups == 1:
        return (TF.flash_fwd_plain, TF.flash_bwd_dkdv_plain,
                TF.flash_bwd_dq_plain)

    def slices(q, k):
        n, kv = q.shape[1], k.shape[1]
        g = n // kv
        step = kv // groups
        return [(slice(i * g, (i + step) * g), slice(i, i + step))
                for i in range(0, kv, step)]

    def fwd(q, k, v, segs=None, dseed=None, *, causal=True,
            dropout_rate=0.0):
        assert dropout_rate == 0.0
        outs = [TF.flash_fwd_plain(q[:, qs], k[:, ks], v[:, ks], segs,
                                   causal=causal)
                for qs, ks in slices(q, k)]
        return tuple(torch.cat(x, dim=1) for x in zip(*outs))

    def dkdv(q, k, v, do, lse, delta, segs=None, dseed=None, *,
             causal=True, dropout_rate=0.0):
        assert dropout_rate == 0.0
        outs = [TF.flash_bwd_dkdv_plain(q[:, qs], k[:, ks], v[:, ks],
                                        do[:, qs], lse[:, qs], delta[:, qs],
                                        segs, causal=causal)
                for qs, ks in slices(q, k)]
        return tuple(torch.cat(x, dim=1) for x in zip(*outs))

    def dq(q, k, v, do, lse, delta, segs=None, dseed=None, *, causal=True,
           dropout_rate=0.0):
        assert dropout_rate == 0.0
        return torch.cat([TF.flash_bwd_dq_plain(
            q[:, qs], k[:, ks], v[:, ks], do[:, qs], lse[:, qs],
            delta[:, qs], segs, causal=causal)
            for qs, ks in slices(q, k)], dim=1)

    return fwd, dkdv, dq


def check_case(tag, *, b, n, kv, s, sk, d, dtype, causal, seg, rate,
               seed=7, layout="hmajor", plain_groups=1):
    """K1-K3 against their plain versions on one input set; returns the
    per-kernel check records and the inputs for timing. ``layout="fused"``
    takes q/k/v as views of one fused qkv projection, ``"cross"`` q as
    its own projection and k/v as views of a fused kv projection of
    another length (cross-attention); ``plain_groups`` runs the plain
    versions over that many slices of the kv heads (:func:`plain_flash`)."""
    import torch

    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1000 + s + n)
    tol = TOL_FP32 if dtype == torch.float32 else TOL_16

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=gen).to(dtype)

    if layout == "fused":
        # the main path's layout: q/k/v are views of the fused qkv
        # projection [B, S, (N + 2K) D], heads-major by transposition
        qkv = rnd(b, s, (n + 2 * kv) * d)
        q, k, v = torch.split(qkv, [n * d, kv * d, kv * d], dim=-1)
        qh = q.view(b, s, n, d).transpose(1, 2)
        kh = k.view(b, s, kv, d).transpose(1, 2)
        vh = v.view(b, s, kv, d).transpose(1, 2)
        doh = rnd(b, s, n, d).transpose(1, 2)
    elif layout == "cross":
        # the decoder's q projection [B, S, N D] and the encoder memory's
        # fused kv projection [B, Sk, 2 K D]
        qh = rnd(b, s, n * d).view(b, s, n, d).transpose(1, 2)
        k, v = torch.chunk(rnd(b, sk, 2 * kv * d), 2, dim=-1)
        kh = k.view(b, sk, kv, d).transpose(1, 2)
        vh = v.view(b, sk, kv, d).transpose(1, 2)
        doh = rnd(b, s, n, d).transpose(1, 2)
    elif layout == "unaligned":
        # rows d + 3 elements apart: no 16-byte copies (the kernels'
        # element-wise instantiation)
        def rows(h, length):
            return rnd(b, h, length, d + 3)[..., :d]

        qh, kh, vh, doh = rows(n, s), rows(kv, sk), rows(kv, sk), rows(n, s)
    else:
        qh, kh, vh = rnd(b, n, s, d), rnd(b, kv, sk, d), rnd(b, kv, sk, d)
        doh = rnd(b, n, s, d)
    if isinstance(seg, torch.Tensor):  # a path's own segment ids
        segs = seg.to(dev, torch.int32)
    else:
        segs = (segments_for(b, s, dev, seg if isinstance(seg, str) else
                             "packed") if seg else None)
    dseed = seed if rate > 0 else None
    kw = dict(causal=causal, dropout_rate=rate)
    args = (qh, kh, vh)
    out = {}

    fwd_p, dkdv_p, dq_p_fn = plain_flash(plain_groups)
    o, lse = TF.flash_attention_hmajor(*args, segs, dseed, **kw)
    o_p, lse_p = fwd_p(*args, segs, dseed, **kw)
    out["flash_fwd"] = [compare(f"{tag} K1 o", o, o_p, tol),
                        compare(f"{tag} K1 lse", lse, lse_p, TOL_LSE,
                                absolute=True)]
    # K2/K3 get identical inputs: the kernel's o/lse and delta
    delta = (doh.float() * o.float()).sum(dim=-1).contiguous()
    bwd = (qh, kh, vh, doh, lse, delta, segs, dseed)
    dk, dv = TF.flash_bwd_dkdv(*bwd, **kw)
    dk_p, dv_p = dkdv_p(*bwd, **kw)
    out["flash_bwd_dkdv"] = [compare(f"{tag} K2 dk", dk, dk_p, tol),
                             compare(f"{tag} K2 dv", dv, dv_p, tol)]
    dq = TF.flash_bwd_dq(*bwd, **kw)
    dq_p = dq_p_fn(*bwd, **kw)
    out["flash_bwd_dq"] = [compare(f"{tag} K3 dq", dq, dq_p, tol)]
    torch.cuda.synchronize()
    return out, (args, bwd, segs, dseed, kw)


def check_autograd(tag, *, b, n, s, d, dtype):
    """flash_sdpa's gradients (K1 forward, K2 + K3 backward through the
    autograd Function, q/k/v as views of one fused leaf) against a reference
    on the card. In fp32 the reference is autograd through the plain
    forward. In 16-bit it is the plain versions of K1-K3 composed as the
    Function composes the kernels: flash backward takes delta = rowsum(dO *
    O) from the rounded 16-bit O, as the JAX backward does, while autograd
    through an fp32 softmax never rounds O, and at S=1024 that moves single
    dq elements by more than the 16-bit limit."""
    import torch

    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    tol = TOL_FP32 if dtype == torch.float32 else TOL_16
    qkv = torch.randn(b, s, 3 * n * d, device=dev, generator=gen).to(dtype)
    do = torch.randn(b, s, n, d, device=dev, generator=gen).to(dtype)

    def heads(x):
        return [t.view(b, s, n, d) for t in x.split(n * d, dim=-1)]

    leaf = qkv.clone().requires_grad_(True)
    g_k = torch.autograd.grad(TF.flash_sdpa(*heads(leaf), causal=True),
                              leaf, do)[0]
    torch.cuda.synchronize()
    if dtype == torch.float32:
        leaf = qkv.clone().requires_grad_(True)
        qh, kh, vh = (t.transpose(1, 2) for t in heads(leaf))
        o = TF.flash_fwd_plain(qh, kh, vh)[0].transpose(1, 2)
        g_p = torch.autograd.grad(o, leaf, do)[0]
    else:
        qh, kh, vh = (t.transpose(1, 2) for t in heads(qkv))
        doh = do.transpose(1, 2)
        o, lse = TF.flash_fwd_plain(qh, kh, vh)
        delta = (doh.float() * o.float()).sum(dim=-1)
        dk, dv = TF.flash_bwd_dkdv_plain(qh, kh, vh, doh, lse, delta)
        dq = TF.flash_bwd_dq_plain(qh, kh, vh, doh, lse, delta)
        g_p = torch.cat([t.transpose(1, 2).reshape(b, s, n * d)
                         for t in (dq, dk, dv)], dim=-1)
    torch.cuda.synchronize()
    g_k, g_p = (g.view(b, s, 3, n, d) for g in (g_k, g_p))
    return [compare(f"{tag} autograd d{x}", g_k[:, :, i], g_p[:, :, i], tol)
            for i, x in enumerate("qkv")]


def kept_pairs(b, n, s, segs=None, causal=True, sk=None) -> float:
    """(q, k) pairs a kernel must compute: every q's earlier keys when
    causal, all ``sk`` keys when not, within its own document when
    ``segs`` [b, s] packs several."""
    if segs is None:
        if not causal:
            return float(b * n * s * (sk or s))
        return b * n * s * (s + 1) / 2
    import torch

    total = 0
    for row in segs.cpu():
        _, counts = torch.unique_consecutive(row, return_counts=True)
        total += int((counts * (counts + 1) // 2 if causal
                      else counts * counts).sum())
    return float(n * total)


def bounds(b, n, kv, s, d, elem, peak_flops, peak_bytes, segs=None,
           causal=True, sk=None):
    """Least time (ms) for each kernel's work at this shape: bytes moved
    (each input read once, each output written once) over the memory
    rate, and the tile products over the kept (q, k) pairs (causal or all
    ``sk`` keys, within each packed document when ``segs`` is given) over
    the bf16 tensor-core rate; the larger of the two and which one it
    is."""
    pairs = kept_pairs(b, n, s, segs, causal=causal, sk=sk)
    q_bytes = b * n * s * d * elem
    kv_bytes = b * kv * (sk or s) * d * elem
    row_bytes = b * n * s * 4  # lse / delta, fp32
    work = {
        # K1: q.k and p.v; reads q, k, v; writes o, lse
        "flash_fwd": (2 * 2 * pairs * d,
                      q_bytes + 2 * kv_bytes + q_bytes + row_bytes),
        # K2: s, dp, dv += p^T do, dk += ds^T q; reads q, k, v, do, lse,
        # delta; writes dk, dv
        "flash_bwd_dkdv": (4 * 2 * pairs * d,
                           2 * q_bytes + 2 * kv_bytes + 2 * row_bytes
                           + 2 * kv_bytes),
        # K3: s, dp, dq += ds k; reads q, k, v, do, lse, delta; writes dq
        "flash_bwd_dq": (3 * 2 * pairs * d,
                         2 * q_bytes + 2 * kv_bytes + 2 * row_bytes
                         + q_bytes),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / peak_bytes * 1e3
        out[name] = dict(flops=flops, bytes=nbytes,
                         bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes")
    return out


def route_ab(tag, case_inputs, reps: int = REPS):
    """The route K1 and K2 (and K3) take on one case's inputs, and for K1
    and K2 on the wgmma route their times against the mma.sync route's on
    the same inputs, in turns (mma, wgmma, wgmma, mma): ``{kernel:
    dict(kernel_route, ms, mma_ms, ms_runs, mma_ms_runs)}``; the times of
    a kernel on the mma route alone are its kernel times."""
    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    args, bwd, segs, dseed, kw = case_inputs
    calls = {
        "flash_fwd": lambda r: TF.flash_attention_hmajor(
            *args, segs, dseed, _route=r, **kw),
        "flash_bwd_dkdv": lambda r: TF.flash_bwd_dkdv(*bwd, _route=r, **kw),
    }
    out = {}
    for k, call in calls.items():
        ops = args if k == "flash_fwd" else bwd[:4]
        route = TF.kernel_route(k, *ops)
        if route != "wgmma":
            out[k] = dict(kernel_route=route)
            continue
        runs = [time_ms(lambda r=r: call(r), reps)
                for r in ("mma", "wgmma", "wgmma", "mma")]
        out[k] = dict(kernel_route=route, ms=(runs[1] + runs[2]) / 2,
                      mma_ms=(runs[0] + runs[3]) / 2,
                      ms_runs=runs[1:3], mma_ms_runs=[runs[0], runs[3]])
    out["flash_bwd_dq"] = dict(
        kernel_route=TF.kernel_route("flash_bwd_dq", *bwd[:4]))
    log(f"  {tag}: routes " + ", ".join(
        f"{k} {v['kernel_route']}" for k, v in out.items()))
    for k, v in out.items():
        if "mma_ms" in v:
            log(f"  {tag}: {k:<16} wgmma {v['ms_runs'][0]:.3f} / "
                f"{v['ms_runs'][1]:.3f} ms against mma.sync "
                f"{v['mma_ms_runs'][0]:.3f} / {v['mma_ms_runs'][1]:.3f} ms "
                f"(mma, wgmma, wgmma, mma): {v['mma_ms'] / v['ms']:.2f}x")
    return out


def time_kernels(case_inputs, reps: int = REPS, plain_groups: int = 1,
                 tag: str = ""):
    """Kernel, plain and library times (ms) of K1-K3 on one case's
    inputs (the plain versions over ``plain_groups`` slices of the kv
    heads, as :func:`check_case` ran them), and :func:`route_ab`'s routes
    and mma.sync times; K1's and K2's kernel times are those of the
    route-by-route runs."""
    import torch
    import torch.nn.functional as F

    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    args, bwd, segs, dseed, kw = case_inputs
    fwd_p, dkdv_p, dq_p = plain_flash(plain_groups)
    alt = route_ab(tag, case_inputs, reps)
    times = {
        "flash_fwd": (
            alt["flash_fwd"].get("ms") or time_ms(
                lambda: TF.flash_attention_hmajor(*args, segs, dseed, **kw),
                reps),
            time_ms(lambda: fwd_p(*args, segs, dseed, **kw), reps)),
        "flash_bwd_dkdv": (
            alt["flash_bwd_dkdv"].get("ms") or time_ms(
                lambda: TF.flash_bwd_dkdv(*bwd, **kw), reps),
            time_ms(lambda: dkdv_p(*bwd, **kw), reps)),
        "flash_bwd_dq": (
            time_ms(lambda: TF.flash_bwd_dq(*bwd, **kw), reps),
            time_ms(lambda: dq_p(*bwd, **kw), reps)),
    }
    # the yardstick: PyTorch's own fused attention on the same inputs
    # (timed here only; the port never calls it). GQA k/v are expanded to
    # the q heads and packed documents become a boolean mask before the
    # timed call, so the call computes the kernels' function.
    n = args[0].shape[1]
    qh, kh, vh = (t.detach() for t in args)
    kh, vh = (t.repeat_interleave(n // t.shape[1], dim=1) for t in (kh, vh))
    sdpa = dict(is_causal=kw["causal"])
    if segs is not None:
        s = qh.shape[2]
        mask = segs[:, None, :, None] == segs[:, None, None, :]
        if kw["causal"]:
            mask = mask & torch.ones(s, s, dtype=torch.bool,
                                     device=qh.device).tril()
        sdpa = dict(attn_mask=mask)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, **sdpa), reps)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (qh, kh, vh))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, **sdpa)
    do = bwd[3]
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True), reps)
    return times, {"flash_fwd": lib_fwd, "flash_bwd_dkdv": lib_bwd,
                   "flash_bwd_dq": lib_bwd}, alt


# ---------------------------------------------------------------------------
# K4/K5: fused cross-entropy
# ---------------------------------------------------------------------------


def compare_exact(name: str, got, want):
    """Bit-equality (the gathered gold logit is a copy of one input)."""
    import torch

    torch.cuda.synchronize()
    ok = got.shape == want.shape and torch.equal(got, want)
    log(f"  {name:<34} bit-equal {'ok' if ok else 'FAIL'}")
    if not ok:
        err = float((got.float() - want.float()).abs().max())
        raise SmokeFailure(f"{name}: not bit-equal (max abs err {err:.3e})")
    return {"output": name, "max_abs_err": 0.0, "worst_over_limit": 0.0,
            "tol": 0.0, "tol_kind": "exact"}


def ce_inputs(t, v, dtype, *, ld=None, seed=0, scale=2.0, shards=1,
              shard=0):
    """Logits [t, v] (a view of a [t, ld] buffer when ``ld`` > v), labels
    with the first two at -1 and v (out of range: gold 0, no one-hot), the
    third row all equal, and the backward's per-row a, b. With ``shards``
    the logits are vocab shard ``shard`` of ``shards`` and the labels are
    drawn over the whole vocabulary and offset by the shard, as the
    vocab-parallel loss feeds them: most fall outside the shard."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = scale * torch.randn(t, ld or v, device=dev, generator=gen)
    x = wide.to(dtype)[:, :v]
    labels = torch.randint(0, v * shards, (t,), device=dev,
                           generator=gen) - v * shard
    labels[:2] = torch.tensor([-1, v], device=dev)
    x[2] = 1.5
    a = torch.randn(t, device=dev, generator=gen)
    b = torch.randn(t, device=dev, generator=gen)
    return x, labels, a, b


def check_ce_case(tag, t, v, dtype, *, ld=None, seed=0, shards=1,
                  shard=0):
    """K4 and K5 against their plain versions on one input set: gold
    bit-equal, lse within 1e-4 absolute, dlogits elementwise."""
    import math

    from hetu_galvatron_tpu_torch.ops import cross_entropy as TC

    x, labels, a, b = ce_inputs(t, v, dtype, ld=ld, seed=seed,
                                shards=shards, shard=shard)
    tol = TOL_FP32 if dtype.itemsize == 4 else TOL_16
    lse, gold = TC.ce_fwd(x, labels)
    lse_p, gold_p = TC.ce_fwd_plain(x, labels)
    fwd = [compare(f"{tag} K4 lse", lse, lse_p, TOL_CE_LSE, absolute=True),
           compare_exact(f"{tag} K4 gold", gold, gold_p)]
    want_equal = 1.5 + math.log(v)
    if (abs(float(lse[2]) - want_equal) > TOL_CE_LSE
            or float(gold[0]) != 0.0 or float(gold[1]) != 0.0):
        raise SmokeFailure(f"{tag}: equal row lse {float(lse[2])} (want "
                           f"{want_equal}) or out-of-range gold "
                           f"{gold[:2].tolist()} (want 0)")
    dx = TC.ce_bwd(x, labels, lse, a, b)
    if dx.dtype != x.dtype:
        raise SmokeFailure(f"{tag}: dlogits dtype {dx.dtype} != {x.dtype}")
    bwd = [compare(f"{tag} K5 dlogits", dx,
                   TC.ce_bwd_plain(x, labels, lse, a, b), tol)]
    return {"ce_fwd": fwd, "ce_bwd": bwd}, (x, labels, lse, a, b)


def check_ce_zloss(t=77, v=1000):
    """fused_ce_nll with a z-loss, differentiated through K4/K5 (autograd
    folds 2 z lse into d_lse), against autograd through the plain fp32
    formula on the same logits."""
    import torch

    from hetu_galvatron_tpu_torch.ops import cross_entropy as TC

    x, labels, _, _ = ce_inputs(t, v, torch.float32, seed=3)
    labels = labels.clamp(0, v - 1)
    g = torch.randn(t, device=x.device)
    z = 1e-4
    xk = x.clone().requires_grad_(True)
    nll = TC.fused_ce_nll(xk, labels, z_loss=z)
    (gk,) = torch.autograd.grad((nll * g).sum(), xk)
    xp = x.clone().requires_grad_(True)
    lse = torch.logsumexp(xp, dim=-1)
    nll_p = lse - xp.gather(-1, labels[:, None])[:, 0] + z * lse.square()
    (gp,) = torch.autograd.grad((nll_p * g).sum(), xp)
    return [compare("z-loss fp32 nll", nll.detach(), nll_p.detach(),
                    TOL_FP32),
            compare("z-loss fp32 d logits", gk, gp, TOL_FP32)]


def ce_bounds(t, v, elem, peak_bytes, peak_fp32):
    """Least time (ms) of K4 and K5 at [t, v]: bytes (logits read once,
    int64 labels and fp32 row vectors read or written once, K5's dlogits
    written once) against fp32 operations outside the tensor cores (K4:
    max, subtract, exp, add per logit; K5: subtract, exp, multiply,
    compare, subtract per logit)."""
    work = {"ce_fwd": (4 * t * v, t * v * elem + t * 8 + 2 * t * 4),
            "ce_bwd": (5 * t * v, 2 * t * v * elem + t * 8 + 3 * t * 4)}
    out = {}
    for name, (ops, nbytes) in work.items():
        t_ops, t_bytes = ops / peak_fp32 * 1e3, nbytes / peak_bytes * 1e3
        out[name] = dict(flops=ops, bytes=nbytes,
                         bound_ms=max(t_ops, t_bytes),
                         bound_by="operations" if t_ops >= t_bytes
                         else "bytes")
    return out


def time_ce(inputs, reps: int = BIG_REPS):
    """Kernel, plain and library times (ms) of K4 and K5 on one input set
    (all labels in range for the library call)."""
    import torch
    import torch.nn.functional as F

    from hetu_galvatron_tpu_torch.ops import cross_entropy as TC

    x, labels, lse, a, b = inputs
    times = {
        "ce_fwd": (time_ms(lambda: TC.ce_fwd(x, labels), reps),
                   time_ms(lambda: TC.ce_fwd_plain(x, labels), reps)),
        "ce_bwd": (time_ms(lambda: TC.ce_bwd(x, labels, lse, a, b), reps),
                   time_ms(lambda: TC.ce_bwd_plain(x, labels, lse, a, b),
                           reps)),
    }
    lab = labels.clamp(0, x.shape[1] - 1)
    lib_fwd = time_ms(lambda: F.cross_entropy(x, lab, reduction="none"),
                      reps)
    xl = x.detach().clone().requires_grad_(True)
    out = F.cross_entropy(xl, lab, reduction="none")
    lib_bwd = time_ms(lambda: torch.autograd.grad(out, xl, a,
                                                  retain_graph=True), reps)
    return times, {"ce_fwd": lib_fwd, "ce_bwd": lib_bwd}


def reference_run():
    """A small model, 3 steps in fp32: flash kernels against the plain
    attention core, both on the card (same weights, same batches). GQA
    (4 query heads on 2 kv heads) and rope put the grouped kernels and the
    rotated strided q/k on the training path."""
    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config

    over = ["model.hidden_size=256", "model.num_hidden_layers=2",
            "model.num_attention_heads=4", "model.num_key_value_heads=2",
            "model.position_embedding_type=rope", "model.seq_length=320",
            "parallel.global_train_batch_size=4", "train.train_iters=3",
            "parallel.mixed_precision=fp32", "train.lr=1e-3"]
    runs = {}
    for flash in (True, False):
        args = load_config(GPT2_YAML, over + [f"model.use_flash_attn={flash}"])
        runs[flash] = train(args)["losses"]
    log(f"  flash losses {runs[True]}")
    log(f"  plain losses {runs[False]}")
    for a, b in zip(runs[True], runs[False]):
        if not (math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise SmokeFailure(f"flash run {runs[True]} departs from the "
                               f"plain run {runs[False]}")
    return runs


def split_samples(prefix: str, split: str, seq: int):
    """Samples of seq + 1 tokens in the train, valid and test splits."""
    from hetu_galvatron_tpu_torch.data import indexed_dataset as TI

    idx = TI.IndexedDataset(prefix)
    return [len(TI.GPTDataset(idx, seq, doc_range=r))
            for r in TI.split_doc_ranges(len(idx), split)]


def reference_run_ce(tmp: str):
    """A small Qwen-shaped model (GQA 4:2, qkv bias, untied head), 3 steps
    in fp32 on a packed corpus, both runs through the flash kernels: fused
    cross-entropy (K4/K5) with remat on every layer against the plain loss
    without remat (same weights, same batches)."""
    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import (
        packed_corpus_overrides,
        write_random_corpus,
    )

    prefix = os.path.join(tmp, "small_corpus")
    write_random_corpus(prefix, docs=300, mean_len=200, vocab=4096, eod=4000,
                        tokenizer_vocab=4001, seed=1)
    over = ["model.hidden_size=256", "model.num_hidden_layers=2",
            "model.num_attention_heads=4", "model.num_key_value_heads=2",
            "model.ffn_hidden_size=512", "model.vocab_size=4096",
            "model.seq_length=320", "parallel.global_train_batch_size=4",
            "train.train_iters=3", "parallel.mixed_precision=fp32",
            "train.lr=1e-3", *packed_corpus_overrides(prefix)]
    runs = {}
    for fused in (True, False):
        args = load_config(QWEN_YAML, over + [
            f"model.use_fused_ce={fused}",
            f"parallel.global_checkpoint={int(fused)}"])
        runs[fused] = train(args)["losses"]
    log(f"  fused CE + remat losses {runs[True]}")
    log(f"  plain CE, no remat      {runs[False]}")
    for a, b in zip(runs[True], runs[False]):
        if not (math.isfinite(a) and abs(a - b) <= 1e-4 * abs(b)):
            raise SmokeFailure(f"fused CE + remat run {runs[True]} departs "
                               f"from the plain run {runs[False]}")
    return runs


def write_qwen_corpus(tmp: str):
    """Phase 6's seeded packed corpus in Qwen's vocabulary (eod 151643);
    returns its prefix, its stats and the samples of each split."""
    from hetu_galvatron_tpu_torch.data.synthetic import write_random_corpus

    prefix = os.path.join(tmp, "qwen_corpus")
    corpus = write_random_corpus(prefix, docs=600, mean_len=1500, vocab=QV,
                                 eod=QWEN_EOD,
                                 tokenizer_vocab=QWEN_TOKENIZER_VOCAB)
    samples = split_samples(prefix, "98,1,1", QS)
    log(f"  corpus: {corpus['documents']} documents, {corpus['tokens']} "
        f"tokens; samples of {QS + 1} tokens per split (train, valid, "
        f"test): {samples}")
    if min(samples[1:]) < 1:
        raise SmokeFailure(f"an eval split holds no {QS + 1}-token sample: "
                           f"{samples}")
    return prefix, corpus, samples


def qwen_path(peak_flops: float, tmp: str):
    """Slice 2's main path: Qwen2.5-7B widths cut to 4 layers, bsz 2 at seq
    4096, bf16, fused cross-entropy, remat on every layer, over a packed
    indexed corpus with eod masking; 8 steps, then one batch each of the
    valid and test splits under no_grad. Launch counts reset just before
    and read just after."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import packed_corpus_overrides
    from hetu_galvatron_tpu_torch.models.builder import model_flops_per_token
    from hetu_galvatron_tpu_torch.ops import _build

    prefix, corpus, samples = write_qwen_corpus(tmp)
    args = load_config(QWEN_YAML, [
        f"model.num_hidden_layers={QWEN_LAYERS}", "model.use_fused_ce=true",
        "parallel.global_checkpoint=1", "parallel.mixed_precision=bf16",
        f"parallel.global_train_batch_size={QB}",
        f"train.train_iters={TRAIN_ITERS}",
        f"train.eval_interval={TRAIN_ITERS}", "train.eval_iters=1",
        "profile.profile=1", f"profile.profile_warmup={PROFILE_WARMUP}",
        *packed_corpus_overrides(prefix)])
    cfg = args.model
    L, evals = cfg.num_hidden_layers, 2  # valid after the last step, test
    # per training step (remat runs K1 twice a layer) and per no-grad eval
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L,
                "ce_fwd": 1, "ce_bwd": 1}
    per_eval = {"flash_fwd": L, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
                "ce_fwd": 1, "ce_bwd": 0}
    want = {k: per_step[k] * TRAIN_ITERS + per_eval[k] * evals
            for k in per_step}
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    losses = out["losses"]
    log(f"  losses {losses}; validation {out['val_losses']}; test "
        f"{out['test_loss']}")
    evals_seen = [v["loss"] for v in out["val_losses"]] + [out["test_loss"]]
    if (len(losses) != TRAIN_ITERS or len(evals_seen) != evals
            or not all(map(math.isfinite, losses + evals_seen))):
        raise SmokeFailure(f"losses {losses} / evals {evals_seen} not all "
                           "finite")
    # random logits of std 0.02 * sqrt(hidden) (untied head over unit-rms
    # states) put the expected step-0 loss at ln V + sigma^2 / 2
    ln_v = math.log(cfg.padded_vocab_size)
    expect0 = ln_v + 0.5 * 0.02 ** 2 * cfg.hidden_size
    if abs(losses[0] - expect0) > 0.5:
        raise SmokeFailure(f"step-0 loss {losses[0]:.4f} is not within 0.5 "
                           f"of ln V + sigma^2/2 = {expect0:.4f}")
    log(f"  launches {launches} (want {want}: {L} layers, {TRAIN_ITERS} "
        f"steps with remat, {evals} no-grad evals)")
    if launches != want:
        raise SmokeFailure(f"launches {launches}, want {want}")
    # exact, so the training-step share is the count less the evals'
    step_launches = {k: (launches[k] - per_eval[k] * evals) / TRAIN_ITERS
                     for k in launches}
    eval_launches = {k: per_eval[k] * evals for k in launches}
    step_ms = out["iter_ms"]
    tok_s = QB * cfg.seq_length / (step_ms / 1e3)
    fpt = model_flops_per_token(cfg)
    mfu = tok_s * fpt / peak_flops
    summary = dict(
        model=cfg.model_name, layers=cfg.num_hidden_layers,
        hidden=cfg.hidden_size, ffn=cfg.ffn_dim,
        heads=f"{cfg.num_attention_heads}:{cfg.kv_heads}",
        vocab=cfg.padded_vocab_size, global_batch=QB, seq=cfg.seq_length,
        dtype=args.parallel.mixed_precision, fused_ce=True,
        remat=cfg.remat_policy, steps=TRAIN_ITERS,
        timed_steps=TRAIN_ITERS - PROFILE_WARMUP, step_ms=step_ms,
        tokens_per_s=tok_s, model_flops_per_token=fpt, mfu=mfu,
        peak_tflops=peak_flops / 1e12, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        losses=losses, expected_step0_loss=expect0, val_losses=out[
            "val_losses"], test_loss=out["test_loss"], launches=launches,
        launches_per_step=step_launches, eval_launches=eval_launches,
        corpus=dict(corpus, samples_per_split=samples))
    log(f"  step {step_ms:.2f} ms (mean of steps {PROFILE_WARMUP}.."
        f"{TRAIN_ITERS - 1}, CUDA events), {tok_s:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of {peak_flops / 1e12:.0f} TFLOP/s "
        f"({fpt / 1e9:.3f} GFLOP/token), peak memory "
        f"{summary['peak_mem_gb']:.1f} GiB")
    log("qwen path: " + json.dumps(summary))
    return summary


def reference_run_moe(tmp: str):
    """A small Mixtral-shaped model (8 experts, top-2, capacity dispatch,
    GQA 4:2), 3 steps in fp32 on a packed corpus in Mistral's id layout:
    the flash kernels, fused cross-entropy and remat on every layer against
    the plain attention core and loss without remat, within 1e-4 relative;
    then, both through the kernels, dropless dispatch against capacity
    dispatch at a capacity factor of E / K (every expert has a slot for
    every token, so nothing drops), within 1e-5."""
    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import (
        packed_corpus_overrides,
        write_random_corpus,
    )

    prefix = os.path.join(tmp, "small_moe_corpus")
    write_random_corpus(prefix, docs=300, mean_len=200, vocab=4096, eod=2,
                        tokenizer_vocab=4096, ids=(3, 4096), seed=2)
    over = ["model.hidden_size=256", "model.num_hidden_layers=2",
            "model.num_attention_heads=4", "model.num_key_value_heads=2",
            "model.ffn_hidden_size=512", "model.vocab_size=4096",
            "model.seq_length=320", "parallel.global_train_batch_size=4",
            "train.train_iters=3", "parallel.mixed_precision=fp32",
            "train.lr=1e-3", *packed_corpus_overrides(prefix)]
    kernels = ["model.use_flash_attn=true", "model.use_fused_ce=true",
               "parallel.global_checkpoint=1"]
    runs = {}
    for tag, extra in (
            ("kernels", kernels),
            ("plain", ["model.use_flash_attn=false",
                       "model.use_fused_ce=false"]),
            ("dropless", kernels + ["model.moe_dispatcher=dropless"]),
            ("uncapped", kernels + ["model.moe_capacity_factor=4.0"])):
        runs[tag] = train(load_config(MIXTRAL_YAML, over + extra))["losses"]
        log(f"  MoE {tag:<9} losses {runs[tag]}")
    for a_tag, b_tag, tol in (("kernels", "plain", 1e-4),
                              ("dropless", "uncapped", 1e-5)):
        for a, b in zip(runs[a_tag], runs[b_tag]):
            if not (math.isfinite(a) and abs(a - b) <= tol * abs(b)):
                raise SmokeFailure(f"MoE {a_tag} run {runs[a_tag]} departs "
                                   f"from the {b_tag} run {runs[b_tag]}")
    return runs


def mixtral_config(prefix: str):
    """Slice 5's path: mixtral-8x7b.yaml at its widths, 2 layers, bsz 2 at
    seq 4096, bf16, fused CE, remat on every layer, over the corpus at
    ``prefix``; 8 steps, an eval of the valid split after the last and one
    of the test split."""
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import packed_corpus_overrides

    return load_config(MIXTRAL_YAML, [
        f"model.num_hidden_layers={MIXTRAL_LAYERS}", "model.use_fused_ce=true",
        "parallel.global_checkpoint=1", "parallel.mixed_precision=bf16",
        f"parallel.global_train_batch_size={MB}",
        f"train.train_iters={TRAIN_ITERS}",
        f"train.eval_interval={TRAIN_ITERS}", "train.eval_iters=1",
        "profile.profile=1", f"profile.profile_warmup={PROFILE_WARMUP}",
        *packed_corpus_overrides(prefix)])


def mixtral_corpus(tmp: str):
    """The seeded packed corpus of slice 5's path, in Mistral's vocabulary
    (ordinary ids 3..31999, eod 2), and the segment ids [MB, MS] of the
    path's first training batch whose every row packs several documents
    (the very first holds one long document a row)."""
    import torch

    from hetu_galvatron_tpu_torch.data.synthetic import (
        corpus_tokenizer,
        write_random_corpus,
    )
    from hetu_galvatron_tpu_torch.runtime.dataloader import get_data_iterator

    prefix = os.path.join(tmp, "mixtral_corpus")
    corpus = write_random_corpus(prefix, docs=600, mean_len=1500,
                                 **corpus_tokenizer("mixtral-8x7b"))
    batches = get_data_iterator(mixtral_config(prefix), split="train")
    for step in range(TRAIN_ITERS):
        segs = torch.from_numpy(next(batches)["segment_ids"])
        docs = [int(r.max()) + 1 for r in segs]
        if min(docs) > 1:
            break
    else:
        raise SmokeFailure("no training batch of the Mixtral path packs "
                           "several documents in every row")
    log(f"  Mixtral corpus: {corpus['documents']} documents, "
        f"{corpus['tokens']} tokens; the batch of step {step} packs {docs} "
        "documents a row")
    return prefix, corpus, segs, step


def mixtral_step_flops(cfg, tokens: int, capacity: int) -> float:
    """FLOPs a training step of slice 5's path executes. Per layer
    forward: the qkv and output projections, q.k and p.v over the causal
    triangle (an upper bound: the kernels skip tiles across packed
    documents), the router, every expert's E x C slots through win and
    wout, and the dense dispatch and combine products over [T, E x C].
    Under full remat a layer runs its forward twice (first pass and
    recompute) and a backward of twice the forward, less the dispatch
    product's half: the 0/1 dispatch matrix takes no gradient. Plus the
    head's forward and backward."""
    h, s = cfg.hidden_size, cfg.seq_length
    nq, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    e, f = cfg.num_experts, cfg.moe_ffn_hidden_size or cfg.ffn_dim
    ec = e * capacity
    dispatch = 2 * tokens * ec * h
    fwd = 2 * tokens * h * (nq + 2 * nkv) * hd + 2 * tokens * nq * hd * h
    fwd += 2 * 2 * (tokens // s) * nq * hd * s * (s + 1) / 2
    fwd += 2 * tokens * h * e
    fwd += 2 * ec * h * 2 * f + 2 * ec * f * h
    fwd += dispatch + 2 * tokens * ec * h  # dispatch, combine
    return (cfg.num_hidden_layers * (4 * fwd - dispatch)
            + 3 * 2 * tokens * h * cfg.padded_vocab_size)


def mixtral_path(peak_flops: float, prefix: str, corpus):
    """Slice 5's main path (see :func:`mixtral_config`). Launch counts
    reset just before and read just after; every step's router statistics
    read through ``train``'s ``on_step``."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.models.builder import (
        model_flops_per_token,
        named_leaves,
    )
    from hetu_galvatron_tpu_torch.models.moe import moe_capacity
    from hetu_galvatron_tpu_torch.ops import _build

    samples = split_samples(prefix, "98,1,1", MS)
    log(f"  samples of {MS + 1} tokens per split (train, valid, test): "
        f"{samples}")
    if min(samples[1:]) < 1:
        raise SmokeFailure(f"an eval split holds no {MS + 1}-token sample: "
                           f"{samples}")
    args = mixtral_config(prefix)
    cfg = args.model
    L, E, K, evals = cfg.num_hidden_layers, cfg.num_experts, cfg.moe_topk, 2
    C = moe_capacity(cfg, MT)
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L,
                "ce_fwd": 1, "ce_bwd": 1}
    per_eval = {"flash_fwd": L, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
                "ce_fwd": 1, "ce_bwd": 0}
    want = {k: per_step[k] * TRAIN_ITERS + per_eval[k] * evals
            for k in per_step}
    tpe = []  # per step: {layer: tokens per expert}

    def on_step(it, metrics):
        tpe.append({name: st["tokens_per_expert"].tolist()
                    for name, st in metrics["moe"].items()})

    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(args, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    params = sum(t.numel() for _, t in named_leaves(out.pop("params")))
    losses = out["losses"]
    log(f"  losses {losses}; validation {out['val_losses']}; test "
        f"{out['test_loss']}")
    evals_seen = [v["loss"] for v in out["val_losses"]] + [out["test_loss"]]
    if (len(losses) != TRAIN_ITERS or len(evals_seen) != evals
            or not all(map(math.isfinite, losses + evals_seen))):
        raise SmokeFailure(f"losses {losses} / evals {evals_seen} not all "
                           "finite")
    # ln V + sigma^2 / 2 of an untied random head (as phase 6) plus each
    # layer's balanced aux loss, coeff * E * sum_e (K / E) (1 / E) = coeff K
    ln_v = math.log(cfg.padded_vocab_size)
    expect0 = (ln_v + 0.5 * 0.02 ** 2 * cfg.hidden_size
               + L * cfg.moe_aux_loss_coeff * K)
    if abs(losses[0] - expect0) > 0.5:
        raise SmokeFailure(f"step-0 loss {losses[0]:.4f} is not within 0.5 "
                           f"of ln V + sigma^2/2 + L coeff K = {expect0:.4f}")
    log(f"  launches {launches} (want {want}: {L} layers, {TRAIN_ITERS} "
        f"steps with remat, {evals} no-grad evals)")
    if launches != want:
        raise SmokeFailure(f"launches {launches}, want {want}")
    if len(tpe) != TRAIN_ITERS or any(
            sorted(st) != [f"layer{i}" for i in range(L)] for st in tpe):
        raise SmokeFailure(f"router stats of {len(tpe)} steps: {tpe[:1]}")
    dropped = []
    for it, st in enumerate(tpe):
        for name, counts in st.items():
            if sum(counts) != MT * K:
                raise SmokeFailure(f"step {it} {name}: tokens per expert "
                                   f"{counts} sum to {sum(counts)}, not "
                                   f"T K = {MT * K}")
        dropped.append({name: sum(max(c - C, 0) for c in counts) / (MT * K)
                        for name, counts in st.items()})
    for it, (st, dr) in enumerate(zip(tpe, dropped)):
        log(f"  step {it}: " + "; ".join(
            f"{name} tokens/expert {[int(c) for c in st[name]]} dropped "
            f"{100 * dr[name]:.2f}% of slots at C={C}" for name in sorted(st)))
    if peak_gib >= MEM_LIMIT_GIB:
        raise SmokeFailure(f"peak memory {peak_gib:.1f} GiB is not under "
                           f"{MEM_LIMIT_GIB} GiB")
    step_launches = {k: (launches[k] - per_eval[k] * evals) / TRAIN_ITERS
                     for k in launches}
    eval_launches = {k: per_eval[k] * evals for k in launches}
    step_ms = out["iter_ms"]
    tok_s = MT / (step_ms / 1e3)
    fpt = model_flops_per_token(cfg)
    mfu_jax = tok_s * fpt / peak_flops
    step_flops = mixtral_step_flops(cfg, MT, C)
    mfu_exec = step_flops / (step_ms / 1e3) / peak_flops
    summary = dict(
        model=cfg.model_name, layers=L, hidden=cfg.hidden_size,
        experts=E, topk=K, expert_ffn=cfg.moe_ffn_hidden_size or cfg.ffn_dim,
        dispatcher=cfg.moe_dispatcher, capacity=C,
        heads=f"{cfg.num_attention_heads}:{cfg.kv_heads}",
        vocab=cfg.padded_vocab_size, global_batch=MB, seq=cfg.seq_length,
        dtype=args.parallel.mixed_precision, fused_ce=True,
        remat=cfg.remat_policy, params=params, steps=TRAIN_ITERS,
        timed_steps=TRAIN_ITERS - PROFILE_WARMUP, step_ms=step_ms,
        tokens_per_s=tok_s, model_flops_per_token=fpt, mfu_jax_formula=mfu_jax,
        executed_flops_per_step=step_flops, mfu_executed=mfu_exec,
        peak_tflops=peak_flops / 1e12, wall_s=wall, peak_mem_gb=peak_gib,
        losses=losses, expected_step0_loss=expect0,
        val_losses=out["val_losses"], test_loss=out["test_loss"],
        launches=launches, launches_per_step=step_launches,
        eval_launches=eval_launches, tokens_per_expert=tpe,
        dropped_share=dropped, corpus=dict(corpus, samples_per_split=samples))
    log(f"  step {step_ms:.2f} ms (mean of steps {PROFILE_WARMUP}.."
        f"{TRAIN_ITERS - 1}, CUDA events), {tok_s:.0f} tokens/s, peak memory "
        f"{peak_gib:.1f} GiB, {params} parameters")
    log(f"  MFU (a), JAX formula (model_flops_per_token: one dense MLP of "
        f"ffn a token, not the top-{K} experts; not the card's efficiency): "
        f"{100 * mfu_jax:.2f}% of {peak_flops / 1e12:.0f} TFLOP/s "
        f"({fpt / 1e9:.3f} GFLOP/token)")
    log(f"  MFU (b), executed FLOPs (experts at capacity C={C}, dispatch and "
        f"combine, remat recompute, causal attention): {100 * mfu_exec:.2f}% "
        f"({step_flops / 1e12:.2f} TFLOP a step, "
        f"{step_flops / MT / 1e9:.3f} GFLOP/token)")
    log("mixtral path: " + json.dumps(summary))
    return summary


def main_path(peak_flops: float):
    """GPT-2 small training through the port's train_dist, launch counts
    reset just before and read just after."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.models.builder import model_flops_per_token
    from hetu_galvatron_tpu_torch.ops import _build

    args = load_config(GPT2_YAML, [
        "parallel.global_train_batch_size=8",
        "parallel.mixed_precision=bf16", f"train.train_iters={TRAIN_ITERS}",
        "profile.profile=1", f"profile.profile_warmup={PROFILE_WARMUP}"])
    cfg = args.model
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    losses = out["losses"]
    log(f"  losses {losses}")
    if len(losses) != TRAIN_ITERS or not all(map(math.isfinite, losses)):
        raise SmokeFailure(f"losses not all finite: {losses}")
    ln_v = math.log(cfg.padded_vocab_size)
    if abs(losses[0] - ln_v) > 0.5:
        raise SmokeFailure(f"step-0 loss {losses[0]:.4f} is not within 0.5 "
                           f"of ln({cfg.padded_vocab_size}) = {ln_v:.4f}")
    n = cfg.num_hidden_layers * TRAIN_ITERS
    want = {k: n if k in FLASH else 0 for k in launches}
    log(f"  launches {launches} (want {n} of each flash kernel: "
        f"{cfg.num_hidden_layers} layers x {TRAIN_ITERS} steps; the plain "
        "cross-entropy, no K4/K5)")
    if launches != want:
        raise SmokeFailure(f"launches {launches}, want {want}")
    step_ms = out["iter_ms"]
    tokens = args.parallel.global_train_batch_size * cfg.seq_length
    tok_s = tokens / (step_ms / 1e3)
    fpt = model_flops_per_token(cfg)
    mfu = tok_s * fpt / peak_flops
    summary = dict(
        model=cfg.model_name, layers=cfg.num_hidden_layers,
        hidden=cfg.hidden_size, global_batch=args.parallel.global_train_batch_size,
        seq=cfg.seq_length, dtype=args.parallel.mixed_precision,
        steps=TRAIN_ITERS, timed_steps=TRAIN_ITERS - PROFILE_WARMUP,
        step_ms=step_ms, tokens_per_s=tok_s, model_flops_per_token=fpt,
        mfu=mfu, peak_tflops=peak_flops / 1e12, wall_s=wall,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2 ** 30,
        losses=losses, launches=launches,
        launches_per_step={k: v / TRAIN_ITERS for k, v in launches.items()},
        eval_launches={k: 0 for k in launches})
    log(f"  step {step_ms:.2f} ms (mean of steps {PROFILE_WARMUP}.."
        f"{TRAIN_ITERS - 1}, CUDA events), {tok_s:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of {peak_flops / 1e12:.0f} TFLOP/s "
        f"({fpt / 1e9:.3f} GFLOP/token)")
    log("main path: " + json.dumps(summary))
    return summary



# -- phases 9-11: the rest of the model zoo ----------------------------------


def llama_config(prefix: str):
    """Slice 7's Llama path: llama3.1-70b.yaml at its widths (llama3 rope
    scaling, GQA 64:8, SwiGLU 28672, vocab 128256, untied head), 2 layers,
    bsz 1 at seq 8192, bf16, fused CE, remat on every layer, over the
    packed corpus at ``prefix``; 5 steps, an eval of the valid split after
    the last and one of the test split."""
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import packed_corpus_overrides

    return load_config(LLAMA_YAML, [
        f"model.num_hidden_layers={LLAMA_LAYERS}", "model.use_fused_ce=true",
        "parallel.global_checkpoint=1", "parallel.mixed_precision=bf16",
        f"parallel.global_train_batch_size={LB}",
        f"train.train_iters={ZOO_ITERS}",
        f"train.eval_interval={ZOO_ITERS}", "train.eval_iters=1",
        "profile.profile=1", f"profile.profile_warmup={PROFILE_WARMUP}",
        *packed_corpus_overrides(prefix)])


def llama_corpus(tmp: str):
    """The seeded packed corpus of the Llama path in Llama 3's vocabulary
    (eod 128001): 600 documents of about 3000 tokens, so a row of 8192
    holds 2-4; returns its prefix, its counts with the samples of each
    split, and the segment ids [1, 8192] of the path's first training
    batch that packs several documents."""
    import torch

    from hetu_galvatron_tpu_torch.data.synthetic import (
        corpus_tokenizer,
        write_random_corpus,
    )
    from hetu_galvatron_tpu_torch.runtime.dataloader import get_data_iterator

    prefix = os.path.join(tmp, "llama_corpus")
    corpus = write_random_corpus(prefix, docs=600, mean_len=3000,
                                 **corpus_tokenizer("llama3.1-70b"))
    samples = split_samples(prefix, "98,1,1", LS)
    if min(samples[1:]) < 1:
        raise SmokeFailure(f"an eval split holds no {LS + 1}-token sample: "
                           f"{samples}")
    batches = get_data_iterator(llama_config(prefix), split="train")
    for step in range(ZOO_ITERS):
        segs = torch.from_numpy(next(batches)["segment_ids"])
        docs = [int(r.max()) + 1 for r in segs]
        if min(docs) > 1:
            break
    else:
        raise SmokeFailure("no training batch of the Llama path packs "
                           "several documents")
    log(f"  Llama corpus: {corpus['documents']} documents, "
        f"{corpus['tokens']} tokens; samples of {LS + 1} tokens per split "
        f"{samples}; the batch of step {step} packs {docs} documents")
    return prefix, dict(corpus, samples_per_split=samples,
                        segments_step=step), segs


def zoo_expected_loss(cfg) -> float:
    """Step-0 loss of a random model on random labels: ln V + sigma^2 / 2,
    the mean log-sum-exp of V logits of variance sigma^2 = 0.02^2 hidden.
    Every zoo head has it: the untied head's whead, the tied head's wte
    and BERT's tied decoder after the MLM transform are all std 0.02 over
    a unit-rms state (the final RMSNorm, or the transform's LayerNorm)."""
    return (math.log(cfg.padded_vocab_size)
            + 0.5 * 0.02 ** 2 * cfg.hidden_size)


def zoo_path(label, args, per_step, per_eval, *, tokens, peak_flops,
             step_flops=None, extra=None):
    """One zoo model through ``train``: launch counters reset just before
    and read just after, checked against ``per_step`` x steps +
    ``per_eval`` x 2 evals (valid after the last step, then test); finite
    losses, the step-0 loss within 0.5 of :func:`zoo_expected_loss`, peak
    memory under the limit. Prints step ms (CUDA events over the steps
    after the warm-up), tokens/s and the MFU by the JAX formula
    (``model_flops_per_token``), also by ``step_flops`` executed FLOPs when
    given."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.models.builder import (
        model_flops_per_token,
        named_leaves,
    )
    from hetu_galvatron_tpu_torch.ops import _build

    cfg = args.model
    steps, evals = args.train.train_iters, 2
    want = {k: per_step[k] * steps + per_eval[k] * evals for k in per_step}
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    params = sum(t.numel() for _, t in named_leaves(out.pop("params")))
    out.pop("opt_state")
    losses = out["losses"]
    log(f"  losses {losses}; validation {out['val_losses']}; test "
        f"{out['test_loss']}")
    evals_seen = [v["loss"] for v in out["val_losses"]] + [out["test_loss"]]
    if (len(losses) != steps or len(evals_seen) != evals
            or not all(map(math.isfinite, losses + evals_seen))):
        raise SmokeFailure(f"{label}: losses {losses} / evals {evals_seen} "
                           "not all finite")
    expect0 = zoo_expected_loss(cfg)
    log(f"  step-0 loss {losses[0]:.4f} against ln V + sigma^2/2 = "
        f"{expect0:.4f} (gate 0.5)")
    if abs(losses[0] - expect0) > 0.5:
        raise SmokeFailure(f"{label}: step-0 loss {losses[0]:.4f} is not "
                           f"within 0.5 of {expect0:.4f}")
    log(f"  launches {launches} (want {want}: {steps} steps, {evals} "
        "no-grad evals)")
    if launches != want:
        raise SmokeFailure(f"{label}: launches {launches}, want {want}")
    if peak_gib >= MEM_LIMIT_GIB:
        raise SmokeFailure(f"{label}: peak memory {peak_gib:.1f} GiB is not "
                           f"under {MEM_LIMIT_GIB} GiB")
    step_ms = out["iter_ms"]
    tok_s = tokens / (step_ms / 1e3)
    fpt = model_flops_per_token(cfg)
    mfu = tok_s * fpt / peak_flops
    summary = dict(
        model=cfg.model_name, layers=cfg.num_hidden_layers,
        encoder_layers=cfg.num_encoder_layers, hidden=cfg.hidden_size,
        ffn=cfg.ffn_dim, heads=f"{cfg.num_attention_heads}:{cfg.kv_heads}",
        vocab=cfg.padded_vocab_size,
        global_batch=args.parallel.global_train_batch_size,
        seq=cfg.seq_length, dtype=args.parallel.mixed_precision,
        fused_ce=cfg.use_fused_ce, remat=bool(args.parallel.global_checkpoint),
        params=params, steps=steps, timed_steps=steps - PROFILE_WARMUP,
        step_ms=step_ms, tokens_per_step=tokens, tokens_per_s=tok_s,
        model_flops_per_token=fpt, mfu=mfu, peak_tflops=peak_flops / 1e12,
        wall_s=wall, peak_mem_gb=peak_gib, losses=losses,
        expected_step0_loss=expect0, val_losses=out["val_losses"],
        test_loss=out["test_loss"], launches=launches,
        launches_per_step=dict(per_step),
        eval_launches={k: per_eval[k] * evals for k in per_eval},
        **(extra or {}))
    log(f"  step {step_ms:.2f} ms (mean of steps {PROFILE_WARMUP}.."
        f"{steps - 1}, CUDA events), {tok_s:.0f} tokens/s, MFU (JAX "
        f"formula) {100 * mfu:.2f}% of {peak_flops / 1e12:.0f} TFLOP/s "
        f"({fpt / 1e9:.3f} GFLOP/token), peak memory {peak_gib:.2f} GiB, "
        f"{params} parameters")
    if step_flops is not None:
        mfu_exec = step_flops / (step_ms / 1e3) / peak_flops
        summary.update(executed_flops_per_step=step_flops,
                       mfu_executed=mfu_exec)
        log(f"  MFU by executed FLOPs: {100 * mfu_exec:.2f}% "
            f"({step_flops / 1e12:.2f} TFLOP a step)")
    log(f"{label} path: " + json.dumps(summary))
    return summary


def flash_counts(fwd_per_step, bwd_per_step, fwd_per_eval):
    """Per-step and per-eval launch counts of K1-K5 (one K4 and K5 a
    step, one K4 an eval)."""
    return ({"flash_fwd": fwd_per_step, "flash_bwd_dkdv": bwd_per_step,
             "flash_bwd_dq": bwd_per_step, "ce_fwd": 1, "ce_bwd": 1},
            {"flash_fwd": fwd_per_eval, "flash_bwd_dkdv": 0,
             "flash_bwd_dq": 0, "ce_fwd": 1, "ce_bwd": 0})


def llama_path(peak_flops: float, prefix: str, corpus):
    """Phase 9: remat runs K1 twice a layer."""
    args = llama_config(prefix)
    L = args.model.num_hidden_layers
    per_step, per_eval = flash_counts(2 * L, L, L)
    return zoo_path("llama", args, per_step, per_eval, tokens=LT,
                    peak_flops=peak_flops, extra={"corpus": corpus})


def bert_path(peak_flops: float):
    """Phase 10: bert-large.yaml at full depth (24 post-norm layers,
    bidirectional flash, tied MLM head), bsz 32 at seq 512, bf16, fused
    CE over the masked loss, no remat, random tokens through
    ``mlm_batches``."""
    from hetu_galvatron_tpu_torch.core.arguments import load_config

    args = load_config(BERT_YAML, [
        "model.use_fused_ce=true", "parallel.global_checkpoint=0",
        "parallel.mixed_precision=bf16",
        f"parallel.global_train_batch_size={BB}",
        f"train.train_iters={ZOO_ITERS}", f"train.eval_interval={ZOO_ITERS}",
        "train.eval_iters=1", "profile.profile=1",
        f"profile.profile_warmup={PROFILE_WARMUP}"])
    L = args.model.num_hidden_layers
    per_step, per_eval = flash_counts(L, L, L)
    return zoo_path("bert", args, per_step, per_eval, tokens=BT,
                    peak_flops=peak_flops)


def t5_step_flops(cfg, b: int, s_enc: int, s_dec: int) -> float:
    """FLOPs a T5 training step executes under full remat on both stacks:
    each layer's forward twice (first pass and recompute) and a backward
    of twice the forward, the head's forward and backward. Encoder layer:
    qkv and output projections, MLP, q.k and p.v over all S_enc keys;
    decoder layer: the same with causal self-attention (the triangle),
    plus cross-attention's q and output projections, its kv projection
    of the encoder memory and q.k, p.v over the S_enc keys."""
    h, v = cfg.hidden_size, cfg.padded_vocab_size
    nq, nkv, hd = cfg.num_attention_heads, cfg.kv_heads, cfg.head_dim
    te, td = b * s_enc, b * s_dec
    proj = 2 * h * (nq + 2 * nkv) * hd + 2 * nq * hd * h
    mlp = 2 * h * cfg.ffn_dim * (3 if cfg.hidden_act in ("swiglu", "geglu")
                                 else 2)
    enc = te * (proj + mlp) + 2 * 2 * b * nq * hd * s_enc * s_enc
    dec = (td * (proj + mlp) + 2 * 2 * b * nq * hd * s_dec * (s_dec + 1) / 2
           + td * (2 * h * nq * hd + 2 * nq * hd * h)
           + te * 2 * h * 2 * nkv * hd + 2 * 2 * b * nq * hd * s_dec * s_enc)
    n_enc = (cfg.num_encoder_layers if cfg.num_encoder_layers is not None
             else cfg.num_hidden_layers)
    return (4 * (n_enc * enc + cfg.num_hidden_layers * dec)
            + 3 * 2 * td * h * v)


def t5_path(peak_flops: float):
    """Phase 11: t5-3b.yaml at full depth (24 + 24 layers), bsz 16 at seq
    512 split by ``seq2seq_batches`` into 256 + 256, bf16, fused CE, remat
    on every layer of both stacks through the combined flags. An encoder
    layer runs K1 twice (remat) and K2, K3 once; a decoder layer twice
    that (self and cross); an eval K1 once an attention."""
    from hetu_galvatron_tpu_torch.core.arguments import load_config

    args = load_config(T5_YAML, [
        "model.use_fused_ce=true", "parallel.global_checkpoint=1",
        "parallel.mixed_precision=bf16",
        f"parallel.global_train_batch_size={T5B}",
        f"train.train_iters={ZOO_ITERS}", f"train.eval_interval={ZOO_ITERS}",
        "train.eval_iters=1", "profile.profile=1",
        f"profile.profile_warmup={PROFILE_WARMUP}"])
    cfg = args.model
    le, ld = cfg.num_encoder_layers, cfg.num_hidden_layers
    per_step, per_eval = flash_counts(2 * le + 4 * ld, le + 2 * ld,
                                      le + 2 * ld)
    return zoo_path("t5", args, per_step, per_eval,
                    tokens=T5B * cfg.seq_length, peak_flops=peak_flops,
                    step_flops=t5_step_flops(cfg, T5B, T5S, T5S),
                    extra={"enc_seq": T5S, "dec_seq": T5S})


def check_zoo_kernels(peak_flops, peak_bytes, llama_segs):
    """Phase 3's cases at the zoo paths' shapes: K1-K3 at BERT's (B=32,
    N=K=16, S=512, D=64, non-causal), T5's (B=16, N=K=32, S=256, D=64:
    the encoder's non-causal self-attention, the decoder's causal
    self-attention and the non-causal cross-attention over the encoder's
    256 positions) and Llama's (B=1, N=64, K=8, S=8192, D=128, causal, the
    path's first batch's documents; the plain versions over 8 slices of
    the kv heads), all bf16; K4/K5 at each path's fp32 logits (T=8192,
    V=128256; T=16384, V=30592; T=4096, V=32128)."""
    import torch

    flash = {
        "bert": check_path_flash(
            "BERT shape", f"bert B={BB} N=K={BN} S={BS} D={BD} bf16 "
            "noncausal", (BB, BN, BN, BS, BD), False, peak_flops,
            peak_bytes, causal=False),
        "t5_enc": check_path_flash(
            "T5 encoder shape", f"t5 enc B={T5B} N=K={T5N} S={T5S} D={T5D} "
            "bf16 noncausal", (T5B, T5N, T5N, T5S, T5D), False, peak_flops,
            peak_bytes, causal=False),
        "t5_dec": check_path_flash(
            "T5 decoder shape", f"t5 dec B={T5B} N=K={T5N} S={T5S} D={T5D} "
            "bf16 causal", (T5B, T5N, T5N, T5S, T5D), False, peak_flops,
            peak_bytes, causal=True),
        "t5_cross": check_path_flash(
            "T5 cross shape", f"t5 cross B={T5B} N=K={T5N} S=Sk={T5S} "
            f"D={T5D} bf16 noncausal", (T5B, T5N, T5N, T5S, T5D), False,
            peak_flops, peak_bytes, causal=False, layout="cross", sk=T5S),
        "llama": check_path_flash(
            "Llama shape", f"llama B={LB} N={LN} K={LK} S={LS} D={LD} bf16 "
            "packed", (LB, LN, LK, LS, LD), llama_segs, peak_flops,
            peak_bytes, plain_groups=LK),
    }
    torch.cuda.empty_cache()
    ce_checks = {"ce_fwd": [], "ce_bwd": []}
    ce_timing = {}
    peak_fp32 = 67e12  # H100 SXM fp32 outside the tensor cores
    for name, t, v in (("llama", LT, LV), ("bert", BT, BV),
                       ("t5", T5T, T5V)):
        tag = f"{name} T={t} V={v} fp32"
        res, inputs = check_ce_case(tag, t, v, torch.float32,
                                    seed=len(tag))
        for k, recs in res.items():
            ce_checks[k] += [dict(r, case=tag) for r in recs]
        times, lib = time_ce(inputs)
        del inputs
        torch.cuda.empty_cache()
        bnd = ce_bounds(t, v, 4, peak_bytes, peak_fp32)
        log_times(tag, times, lib, bnd)
        ce_timing[name] = {k: dict(ms=times[k][0], plain_ms=times[k][1],
                                   library_ms=lib[k],
                                   bound_ms=bnd[k]["bound_ms"],
                                   bound_by=bnd[k]["bound_by"],
                                   flops=bnd[k]["flops"],
                                   bytes=bnd[k]["bytes"], shape=tag)
                           for k in times}
    return {"flash": flash, "ce_checks": ce_checks, "ce_timing": ce_timing}


# -- phase 8: checkpoint, resume and the fault lifecycle ---------------------

DRILL_STEPS = 6
# 1 of 28 layers: the drill's checks hold at any depth, and the script's
# time is shared with phase 18
QWEN_DRILL_LAYERS = 1
DRILL_PREEMPT_AT = 2  # the Qwen drill's SIGTERM: step_3 at the boundary
GPT2_KILL_AT = 3  # the GPT-2 drill's SIGKILL in the save of step_4
DISK_FACTOR = 2.5  # a committed checkpoint, a torn .tmp and headroom
TERM_GRACE_S = 300.0  # supervisor.term_grace_s: above one save, printed
DRILL_TIMEOUT_S = 420.0


def dense_param_count(cfg) -> int:
    """Parameters of a dense decoder config, from its shapes alone."""
    from hetu_galvatron_tpu_torch.models.modules import is_gated

    h, hd, f = cfg.hidden_size, cfg.head_dim, cfg.ffn_dim
    qkv = (cfg.num_attention_heads + 2 * cfg.kv_heads) * hd
    norm = h * (2 if cfg.normalization == "layernorm" else 1)
    fin = 2 * f if is_gated(cfg.hidden_act) else f
    layer = (2 * norm + h * qkv + cfg.num_attention_heads * hd * h
             + h * fin + f * h + qkv * cfg.add_qkv_bias
             + (2 * h + fin) * cfg.add_bias_linear)
    embed = cfg.padded_vocab_size * h
    if cfg.position_embedding_type == "learned":
        embed += cfg.max_position_embeddings * h
    head = 0 if cfg.tie_word_embeddings else h * cfg.padded_vocab_size
    return embed + cfg.num_hidden_layers * layer + norm + head


def run_child(module: str, argv, out_dir: str, tag: str):
    """``python -m module argv`` from the repository root; its output goes
    to ``out_dir/<tag>.log`` and its tail is printed when it fails."""
    cmd = [sys.executable, "-m", module, *argv]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=DRILL_TIMEOUT_S)
    wall = time.perf_counter() - t0
    text = proc.stdout + proc.stderr
    with open(os.path.join(out_dir, f"{tag}.log"), "w") as f:
        f.write(text)
    log(f"  {tag}: {module.rsplit('.', 1)[-1]} exit {proc.returncode} in "
        f"{wall:.1f} s")
    return proc.returncode, text, wall


def summaries(path: str):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def child_exits(text: str):
    """The child exit codes a supervisor reported, in order, and its own
    final one (a clean last child is logged as ``done``, not as an exit)."""
    return [int(c) for c in re.findall(r"supervisor: child exit (-?\d+);",
                                       text)]


def want_launches(per_step, per_eval, steps: int, evals: int):
    return {k: per_step[k] * steps + per_eval[k] * evals for k in per_step}


def check_drill_child(tag, rec, want):
    if rec["launches"] != want:
        raise SmokeFailure(f"{tag}: launches {rec['launches']}, want {want}")


def qwen_drill(smi: str, prefix: str, ckroot: str, out_dir: str):
    """The Qwen2.5-7B-width preemption drill: a reference run of
    DRILL_STEPS steps, then the same run under ``cli.supervise`` with a real
    SIGTERM at step DRILL_PREEMPT_AT; the stitched losses and the final
    parameters must equal the reference's bit for bit."""
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import packed_corpus_overrides

    over = [QWEN_YAML, f"model.num_hidden_layers={QWEN_DRILL_LAYERS}",
            "model.use_fused_ce=true", "parallel.global_checkpoint=1",
            "parallel.mixed_precision=bf16",
            f"parallel.global_train_batch_size={QB}",
            f"train.train_iters={DRILL_STEPS}",
            f"train.eval_interval={DRILL_STEPS}", "train.eval_iters=1",
            *packed_corpus_overrides(prefix)]
    cfg = load_config(over[0], over[1:]).model
    n_params = dense_param_count(cfg)
    ckpt_bytes = 12 * n_params  # fp32 params, mu and nu
    free = shutil.disk_usage(ckroot).free
    log(f"  [{smi}] {cfg.model_name} at {QWEN_DRILL_LAYERS} layers: "
        f"{n_params:,} parameters, {ckpt_bytes / 1e9:.2f} GB a checkpoint; "
        f"{free / 1e9:.1f} GB free under {ckroot}")
    if free < DISK_FACTOR * ckpt_bytes:
        raise SmokeFailure(
            f"qwen drill: {free / 1e9:.1f} GB free under {ckroot}, below "
            f"{DISK_FACTOR} x {ckpt_bytes / 1e9:.2f} GB (a committed "
            "checkpoint, a torn staging dir and headroom)")
    L, evals = cfg.num_hidden_layers, 2
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L,
                "ce_fwd": 1, "ce_bwd": 1}
    per_eval = {"flash_fwd": L, "flash_bwd_dkdv": 0, "flash_bwd_dq": 0,
                "ce_fwd": 1, "ce_bwd": 0}
    ref_path = os.path.join(ckroot, "qwen_reference.jsonl")
    rc, text, _ = run_child(
        "hetu_galvatron_tpu_torch.cli.train_dist",
        over + [f"extra.summary_path={ref_path}"], out_dir, "qwen_reference")
    ref = summaries(ref_path)
    if rc != 0 or len(ref) != 1:
        raise SmokeFailure(f"qwen reference run: exit {rc}, {len(ref)} "
                           f"summaries:\n{text[-3000:]}")
    ref = ref[0]
    check_drill_child("qwen reference", ref,
                      want_launches(per_step, per_eval, DRILL_STEPS, evals))
    drill_path = os.path.join(ckroot, "qwen_drill.jsonl")
    ck = os.path.join(ckroot, "qwen")
    rc, text, wall = run_child(
        "hetu_galvatron_tpu_torch.cli.supervise",
        over + [f"ckpt.save={ck}", "rerun.inject_kind=preempt",
                f"rerun.inject_at_iter={DRILL_PREEMPT_AT}",
                "supervisor.auto_restart=true", "supervisor.mode=process",
                f"supervisor.term_grace_s={TERM_GRACE_S}",
                "supervisor.backoff_base_s=0",
                "supervisor.poll_interval_s=0.2",
                f"extra.summary_path={drill_path}"], out_dir, "qwen_drill")
    kids = summaries(drill_path)
    codes = [k["exit_code"] for k in kids]
    if rc != 0 or codes != [18, 0] or child_exits(text) != [18]:
        raise SmokeFailure(f"qwen drill: supervisor exit {rc}, child codes "
                           f"{codes} (supervisor saw {child_exits(text)}), "
                           f"want 0 and [18, 0]:\n{text[-3000:]}")
    first, second = kids
    cut = DRILL_PREEMPT_AT + 1
    if (first["start_iter"], second["start_iter"]) != (0, cut):
        raise SmokeFailure(f"qwen drill: children started at "
                           f"{first['start_iter']} and "
                           f"{second['start_iter']}, want 0 and {cut}")
    stitched = first["losses"] + second["losses"]
    log(f"  [{smi}] reference losses {ref['losses']}")
    log(f"  [{smi}] stitched losses  {stitched}")
    if stitched != ref["losses"]:
        raise SmokeFailure(f"qwen drill: stitched losses {stitched} differ "
                           f"from the uninterrupted run's {ref['losses']}")
    if (second["val_losses"], second["test_loss"]) != (
            ref["val_losses"], ref["test_loss"]):
        raise SmokeFailure("qwen drill: evaluation losses differ from the "
                           "uninterrupted run's")
    bad = [n for n, h in ref["param_sha256"].items()
           if second["param_sha256"].get(n) != h]
    if bad or set(second["param_sha256"]) != set(ref["param_sha256"]):
        raise SmokeFailure(f"qwen drill: final parameters differ from the "
                           f"uninterrupted run's: {bad[:5]}")
    check_drill_child("qwen drill, first child", first,
                      want_launches(per_step, per_eval, cut, 0))
    check_drill_child("qwen drill, second child", second,
                      want_launches(per_step, per_eval, DRILL_STEPS - cut,
                                    evals))
    save = first["checkpoint"]["saves"][-1]
    load = second["checkpoint"]["load"]
    if save["step"] != cut or load["step"] != cut:
        raise SmokeFailure(f"qwen drill: saved step {save['step']}, loaded "
                           f"{load['step']}, want {cut}")
    if TERM_GRACE_S <= save["ms"] / 1e3:
        raise SmokeFailure(f"qwen drill: supervisor.term_grace_s "
                           f"{TERM_GRACE_S} is not above the save's "
                           f"{save['ms'] / 1e3:.1f} s")
    gib = 2 ** 30
    result = dict(
        card=smi, model=cfg.model_name, layers=QWEN_DRILL_LAYERS,
        params=n_params,
        steps=DRILL_STEPS, preempt_at=DRILL_PREEMPT_AT, child_codes=codes,
        supervisor_rc=rc, supervisor_wall_s=wall,
        save_ms=save["ms"], save_bytes=save["bytes"],
        save_gb_per_s=save["bytes"] / 1e6 / save["ms"],
        load_ms=load["ms"], load_bytes=load["bytes"],
        term_grace_s=TERM_GRACE_S,
        peak_mem_gib=dict(reference=ref["peak_mem_bytes"] / gib,
                          first_child=first["peak_mem_bytes"] / gib,
                          second_child=second["peak_mem_bytes"] / gib),
        losses=stitched,
        launches=dict(reference=ref["launches"], first_child=first[
            "launches"], second_child=second["launches"]),
        launches_total={k: first["launches"][k] + second["launches"][k]
                        for k in per_step},
        launches_per_step=per_step, eval_launches={
            k: per_eval[k] * evals for k in per_step})
    log(f"  [{smi}] save of step {cut}: {save['bytes'] / 1e9:.3f} GB in "
        f"{save['ms']:.0f} ms ({result['save_gb_per_s']:.2f} GB/s); load: "
        f"{load['bytes'] / 1e9:.3f} GB in {load['ms']:.0f} ms; "
        f"supervisor.term_grace_s {TERM_GRACE_S:.0f} s against a "
        f"{save['ms'] / 1e3:.1f} s save; peak memory "
        f"{result['peak_mem_gib']['first_child']:.1f} / "
        f"{result['peak_mem_gib']['second_child']:.1f} GiB (children), "
        f"{result['peak_mem_gib']['reference']:.1f} GiB (reference)")
    log("qwen drill: " + json.dumps(result))
    return result


def gpt2_drill(smi: str, ckroot: str, out_dir: str):
    """GPT-2 small at full size: a run that commits step_2 is SIGKILLed in
    the commit window of step_4 (chaos kill_mid_save); the supervisor's
    relaunch must resume from step_2, never the torn step_4.tmp, and end
    bit-identical to an uninterrupted run."""
    from hetu_galvatron_tpu_torch.core.arguments import load_config

    over = [GPT2_YAML, "parallel.global_train_batch_size=8",
            "parallel.mixed_precision=bf16",
            f"train.train_iters={DRILL_STEPS}"]
    n_layers = load_config(over[0], over[1:]).model.num_hidden_layers
    ref_path = os.path.join(ckroot, "gpt2_reference.jsonl")
    rc, text, _ = run_child(
        "hetu_galvatron_tpu_torch.cli.train_dist",
        over + [f"extra.summary_path={ref_path}"], out_dir, "gpt2_reference")
    ref = summaries(ref_path)
    if rc != 0 or len(ref) != 1:
        raise SmokeFailure(f"gpt2 reference run: exit {rc}:\n{text[-3000:]}")
    ref = ref[0]
    per_step = {k: n_layers if k in FLASH else 0 for k in KERNELS}
    check_drill_child("gpt2 reference", ref,
                      want_launches(per_step, per_step, DRILL_STEPS, 0))
    drill_path = os.path.join(ckroot, "gpt2_drill.jsonl")
    ck = os.path.join(ckroot, "gpt2")
    rc, text, wall = run_child(
        "hetu_galvatron_tpu_torch.cli.supervise",
        over + [f"ckpt.save={ck}", "ckpt.save_interval=2",
                "chaos.enable=true", "chaos.kind=kill_mid_save",
                f"chaos.at_iter={GPT2_KILL_AT}",
                "supervisor.auto_restart=true", "supervisor.mode=process",
                "supervisor.backoff_base_s=0",
                "supervisor.poll_interval_s=0.2",
                f"extra.summary_path={drill_path}"], out_dir, "gpt2_drill")
    kids = summaries(drill_path)
    if rc != 0 or child_exits(text) != [-9] or len(kids) != 1:
        raise SmokeFailure(f"gpt2 drill: supervisor exit {rc}, children "
                           f"{child_exits(text)} and {len(kids)} summaries, "
                           f"want 0, [-9] and 1:\n{text[-3000:]}")
    kid = kids[0]
    load = kid["checkpoint"]["load"]
    if load is None or load["step"] != 2 or not load["dir"].endswith(
            os.sep + "step_2"):
        raise SmokeFailure(f"gpt2 drill: resumed from {load}, want the last "
                           "committed step_2")
    torn = [e for e in os.listdir(ck) if e.endswith(".tmp")]
    if kid["exit_code"] != 0 or kid["start_iter"] != 2 or torn:
        raise SmokeFailure(f"gpt2 drill: exit {kid['exit_code']}, start "
                           f"{kid['start_iter']}, staging dirs left {torn}")
    log(f"  [{smi}] reference losses {ref['losses']}")
    log(f"  [{smi}] resumed losses   {kid['losses']}")
    if kid["losses"] != ref["losses"][2:]:
        raise SmokeFailure(f"gpt2 drill: resumed losses {kid['losses']} "
                           f"differ from {ref['losses'][2:]}")
    if kid["param_sha256"] != ref["param_sha256"]:
        raise SmokeFailure("gpt2 drill: final parameters differ from the "
                           "uninterrupted run's")
    check_drill_child("gpt2 drill, relaunch", kid,
                      want_launches(per_step, per_step, DRILL_STEPS - 2, 0))
    saves = kid["checkpoint"]["saves"]
    result = dict(
        card=smi, model="gpt2-small", steps=DRILL_STEPS, kill_at=GPT2_KILL_AT,
        supervisor_rc=rc, child_exits=child_exits(text) + [0],
        supervisor_wall_s=wall, resumed_from=load["step"],
        load_ms=load["ms"], load_bytes=load["bytes"],
        save_ms=[s["ms"] for s in saves],
        save_bytes=[s["bytes"] for s in saves],
        peak_mem_gib=kid["peak_mem_bytes"] / 2 ** 30,
        losses=kid["losses"], launches=kid["launches"],
        launches_per_step=per_step, eval_launches={k: 0 for k in per_step})
    log(f"  [{smi}] saves {[round(s['ms']) for s in saves]} ms of "
        f"{saves[0]['bytes'] / 1e9:.3f} GB; load of step_2 {load['ms']:.0f} "
        f"ms; peak memory {result['peak_mem_gib']:.1f} GiB")
    log("gpt2 drill: " + json.dumps(result))
    return result


def lifecycle_path(smi: str, qwen_prefix: str):
    """Phase 8: both drills, in a checkpoint directory that also holds the
    children's logs and is removed at exit, also when a drill fails."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as ckroot:
        qwen = qwen_drill(smi, qwen_prefix, ckroot, ckroot)
        shutil.rmtree(os.path.join(ckroot, "qwen"), ignore_errors=True)
        gpt2 = gpt2_drill(smi, ckroot, ckroot)
    return qwen, gpt2


# -- phases 12-13: the batch-size ramp, train_loop and observability -------

RAMP_ITERS = 14
RAMP_GBS, RAMP_CHUNKS = 8, 4  # the micro size stays 2
RAMP = [2, 2, 24]
RAMP_BATCHES = [2, 2, 2, 2, 4, 4, 6, 6, 8, 8, 8, 8, 8, 8]
TRACE_FROM, TRACE_ITERS = 10, 2  # two batch-8 iterations
UNTRACED_FULL = (8, 9, 12, 13)  # the untraced batch-8 steps
RAMP_PATH = f"qwen2.5-7b-{QWEN_LAYERS}-layers-ramp"
OBS_GPT2_PATH = "gpt2-small-supervised-observability"
OBS_PREEMPT_AT = 3
TOKENS_TOL = 0.03  # telemetry tokens/s against CUDA events
WALL_TOL = 0.10  # a trace's device wall against the window's CUDA events
OVERHEAD_TOL = 0.02  # median step with observability on against off
PROM_LINE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? \S+$")


def param_digests(params):
    """A SHA-256 of every parameter (as ``run_summary`` hashes them)."""
    import hashlib

    from hetu_galvatron_tpu_torch.models.builder import named_leaves

    return {name: hashlib.sha256(t.detach().cpu().contiguous().numpy())
            .hexdigest() for name, t in named_leaves(params)}


def ramp_run(tag, args, per_mb):
    """One phase-12 run of ``train``: CUDA events at every step's end, the
    launch counters over the traced window, the exact launches of its
    microbatches, peak memory and the parameters' digests."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.ops import _build

    events, snap = [], {}

    def on_step(it, metrics):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        if it in (TRACE_FROM - 1, TRACE_FROM + TRACE_ITERS - 1):
            snap[it] = dict(_build.launch_counts)

    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(args, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = [None] + [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    mbs = sum(RAMP_BATCHES) // (RAMP_GBS // RAMP_CHUNKS)
    want = {k: per_mb[k] * mbs for k in per_mb}
    log(f"  ({tag}) batch sizes {out['batch_sizes']}; launches {launches} "
        f"(want {want}: {mbs} microbatches); losses {out['losses']}")
    if out["batch_sizes"] != RAMP_BATCHES:
        raise SmokeFailure(f"({tag}) batch sizes {out['batch_sizes']}, want "
                           f"{RAMP_BATCHES}")
    if launches != want:
        raise SmokeFailure(f"({tag}) launches {launches}, want {want}")
    if not all(map(math.isfinite, out["losses"])):
        raise SmokeFailure(f"({tag}) losses not finite: {out['losses']}")
    traced = {k: snap[TRACE_FROM + TRACE_ITERS - 1][k]
              - snap[TRACE_FROM - 1][k] for k in per_mb}
    res = dict(losses=out["losses"], step_ms=step_ms, wall_s=wall,
               peak_mem_gib=peak, launches=launches, traced_launches=traced,
               digests=param_digests(out["params"]),
               goodput=out["goodput"], flight_dumps=out["flight_dumps"],
               trace_window_ms=out["trace_window_ms"],
               consumed_samples=out["consumed_samples"])
    del out
    torch.cuda.empty_cache()
    return res


def stream_records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def qwen_ramp_path(smi: str, prefix: str, tmp: str):
    """Phase 12: the Qwen2.5-7B-width path (4 layers, seq 4096, fused CE,
    full remat, phase 6's packed corpus) under the ramp 2, 2, 24 to batch 8
    in 4 microbatches of 2, 14 steps, once with observability off and once
    with the metrics stream, the flight recorder and a trace of two batch-8
    iterations."""
    import torch

    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import packed_corpus_overrides
    from hetu_galvatron_tpu_torch.observability.telemetry import (
        TrainingTelemetry,
        peak_device_tflops,
    )
    from hetu_galvatron_tpu_torch.observability.trace_analysis import (
        attribute,
        load_trace,
    )


    base = [f"model.num_hidden_layers={QWEN_LAYERS}",
            "model.use_fused_ce=true", "parallel.global_checkpoint=1",
            "parallel.mixed_precision=bf16",
            f"parallel.global_train_batch_size={RAMP_GBS}",
            f"parallel.chunks={RAMP_CHUNKS}",
            "train.rampup_batch_size=[" + ",".join(map(str, RAMP)) + "]",
            f"train.train_iters={RAMP_ITERS}",
            *packed_corpus_overrides(prefix)]
    L = QWEN_LAYERS
    # per microbatch of 2 (remat runs K1 twice a layer); no evals
    per_mb = {"flash_fwd": 2 * L, "flash_bwd_dkdv": L, "flash_bwd_dq": L,
              "ce_fwd": 1, "ce_bwd": 1}
    obs = os.path.join(tmp, "obs_qwen")
    stream = os.path.join(obs, "metrics.jsonl")
    trace_dir = os.path.join(obs, "trace")
    args_off = load_config(QWEN_YAML, base)
    args_on = load_config(QWEN_YAML, base + [
        "observability.enabled=true", f"observability.metrics_path={stream}",
        f"observability.flight_dir={os.path.join(obs, 'flight')}",
        "observability.flush_interval=1",
        f"profile.trace_dir={trace_dir}", "observability.audit=false",
        f"profile.profile_warmup={TRACE_FROM}",
        f"profile.trace_iters={TRACE_ITERS}"])
    off = ramp_run("a, observability off", args_off, per_mb)
    on = ramp_run("b, observability on", args_on, per_mb)
    if on["losses"] != off["losses"]:
        raise SmokeFailure(f"losses with observability on {on['losses']} "
                           f"differ from off {off['losses']}")
    if on["digests"] != off["digests"]:
        raise SmokeFailure("final parameters with observability on differ "
                           "from off")
    log(f"  losses and the SHA-256 of all {len(on['digests'])} parameters "
        "bit-identical with observability on and off")
    # the metrics stream
    recs = stream_records(stream)
    names = {r.get("name") for r in recs}
    need = {"train/step_time_ms", "train/tokens_per_sec",
            "train/model_tflops", "train/mfu", "device/mem_mb",
            "goodput/productive_step_s", "goodput/recompile_s",
            "goodput/goodput_frac", "span_ms"}
    if not need <= names:
        raise SmokeFailure(f"metrics stream lacks {sorted(need - names)}")
    mem = {r["labels"]["stat"] for r in recs if r["name"] == "device/mem_mb"}
    if mem != {"current", "peak"}:
        raise SmokeFailure(f"device/mem_mb stats {mem}")
    kind = torch.cuda.get_device_name(0)
    table_peak = peak_device_tflops(kind)
    if not table_peak:
        raise SmokeFailure(f"no peak TFLOP/s in the telemetry's table for "
                           f"{kind!r}: MFU is not reported")
    tps = {r["step"]: r["value"] for r in recs
           if r["name"] == "train/tokens_per_sec" and r["step"] is not None}
    mfu = {r["step"]: r["value"] for r in recs
           if r["name"] == "train/mfu" and r["step"] is not None}
    # the default window spans the run, so the gauge flushed after step k
    # is the tokens of steps 1..k over the host time from the end of step
    # 0 to the end of step k: the time of any run of steps follows
    window = inspect.signature(TrainingTelemetry).parameters["window"]
    if RAMP_ITERS > window.default:
        raise SmokeFailure(f"{RAMP_ITERS} steps outrun the telemetry's "
                           f"window of {window.default}")
    cum = [QS * sum(RAMP_BATCHES[1:k + 1]) for k in range(RAMP_ITERS)]

    def tele_s(a, b):  # the telemetry's seconds for steps a..b
        return cum[b] / tps[b] - (cum[a - 1] / tps[a - 1] if a > 1 else 0.0)

    def cuda_s(a, b):
        return sum(on["step_ms"][a:b + 1]) / 1e3

    last = RAMP_ITERS - 1
    runs = list(zip(UNTRACED_FULL[::2], UNTRACED_FULL[1::2]))
    tele_run = cum[last] / tps[last]
    cuda_run = cuda_s(1, last)
    tele_full = sum(tele_s(a, b) for a, b in runs)
    cuda_full = sum(cuda_s(a, b) for a, b in runs)
    full_tokens = QS * sum(RAMP_BATCHES[k] for k in UNTRACED_FULL)
    tele_tps, cuda_tps = full_tokens / tele_full, full_tokens / cuda_full
    log(f"  telemetry: peak {table_peak:.0f} TFLOP/s from the table for "
        f"{kind!r}; steps 1-{last}: {tps[last]:.1f} tokens/s against "
        f"{cum[last] / cuda_run:.1f} from CUDA events "
        f"({100 * (cuda_run / tele_run - 1):+.2f}%); steps "
        f"{list(UNTRACED_FULL)}: {tele_tps:.1f} against {cuda_tps:.1f} "
        f"({100 * (tele_tps / cuda_tps - 1):+.2f}%), MFU "
        f"{[round(100 * mfu[k], 2) for k in UNTRACED_FULL]}%")
    for what, tele, cuda in ((f"steps 1-{last}", cum[last] / tele_run,
                              cum[last] / cuda_run),
                             (f"steps {list(UNTRACED_FULL)}", tele_tps,
                              cuda_tps)):
        if abs(tele / cuda - 1) > TOKENS_TOL:
            raise SmokeFailure(f"telemetry tokens/s {tele:.1f} over {what} "
                               f"is not within {TOKENS_TOL:.0%} of CUDA "
                               f"events' {cuda:.1f}")
    # the trace
    t0 = time.perf_counter()
    tr = load_trace(trace_dir)
    att = attribute(tr)
    parse_s = time.perf_counter() - t0
    want_traced = {k: v * RAMP_CHUNKS * TRACE_ITERS for k, v in per_mb.items()}
    found = {k: att.category_launches.get(k, 0) for k in per_mb}
    log(f"  trace: {len(tr.events)} events read in {parse_s:.1f} s; steps "
        f"{att.steps}; K1-K5 by kernel name {found}; launch counters over "
        f"the window {on['traced_launches']} (want {want_traced})")
    if att.steps != TRACE_ITERS:
        raise SmokeFailure(f"trace attributes {att.steps} steps, want "
                           f"{TRACE_ITERS}")
    if not (found == on["traced_launches"] == want_traced):
        raise SmokeFailure(f"trace kernel counts {found}, counters "
                           f"{on['traced_launches']}, want {want_traced}")
    wall_step = att.wall_ms / att.steps
    window_step = on["trace_window_ms"] / TRACE_ITERS
    ops_step = sum(att.category_launches.values()) / att.steps
    log(f"  trace: device wall {wall_step:.2f} ms a step against "
        f"{window_step:.2f} ms by CUDA events over the window "
        f"({100 * (wall_step / window_step - 1):+.2f}%); busy "
        f"{att.per_device_busy_ms / att.steps:.2f} ms, idle "
        f"{100 * att.bubble_frac:.2f}% of the wall; {ops_step:.0f} device "
        "ops a step")
    if abs(wall_step / window_step - 1) > WALL_TOL:
        raise SmokeFailure(f"trace wall {wall_step:.2f} ms a step is not "
                           f"within {WALL_TOL:.0%} of {window_step:.2f}")
    ours = {k: v / att.steps for k, v in att.categories_ms.items()}
    log("  categories by trace_analysis.op_category, ms a step: " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(ours.items(),
                                          key=lambda kv: -kv[1])))
    # observability's cost to the untraced batch-8 steps
    a = sorted(off["step_ms"][k] for k in UNTRACED_FULL)
    b = sorted(on["step_ms"][k] for k in UNTRACED_FULL)
    med_a, med_b = (a[1] + a[2]) / 2, (b[1] + b[2]) / 2
    within = abs(med_b / med_a - 1) <= OVERHEAD_TOL or a[0] <= med_b <= a[-1]
    log(f"  step ms of steps {list(UNTRACED_FULL)}: off {a} (median "
        f"{med_a:.2f}), on {b} (median {med_b:.2f}, "
        f"{100 * (med_b / med_a - 1):+.2f}%)")
    if not within:
        raise SmokeFailure(f"median step {med_b:.2f} ms with observability "
                           f"is not within {OVERHEAD_TOL:.0%} of {med_a:.2f} "
                           "nor inside the off run's spread")
    log(f"  peak memory off {off['peak_mem_gib']:.2f} GiB, on "
        f"{on['peak_mem_gib']:.2f} GiB")
    if max(off["peak_mem_gib"], on["peak_mem_gib"]) > MEM_LIMIT_GIB:
        raise SmokeFailure(f"peak memory above {MEM_LIMIT_GIB} GiB")
    summary = dict(
        card=smi, model="qwen2.5-7b", layers=QWEN_LAYERS, seq=QS,
        global_batch=RAMP_GBS, chunks=RAMP_CHUNKS, ramp=RAMP,
        batch_sizes=RAMP_BATCHES, consumed_samples=on["consumed_samples"],
        losses=on["losses"], step_ms_off=off["step_ms"],
        step_ms_on=on["step_ms"], median_ms_off=med_a, median_ms_on=med_b,
        telemetry_tokens_per_s=tele_tps, cuda_event_tokens_per_s=cuda_tps,
        telemetry_tokens_per_s_run=tps[last],
        cuda_event_tokens_per_s_run=cum[last] / cuda_run,
        mfu={k: mfu[k] for k in UNTRACED_FULL}, peak_tflops=table_peak,
        trace=dict(steps=att.steps, wall_ms_per_step=wall_step,
                   window_ms_per_step=window_step,
                   busy_ms_per_step=att.per_device_busy_ms / att.steps,
                   idle_frac=att.bubble_frac, kernels=found,
                   device_ops_per_step=ops_step,
                   events=len(tr.events), parse_s=parse_s,
                   categories_ms_per_step=ours),
        peak_mem_gib_off=off["peak_mem_gib"],
        peak_mem_gib_on=on["peak_mem_gib"], goodput=on["goodput"],
        flight_dumps=on["flight_dumps"], wall_s_off=off["wall_s"],
        wall_s_on=on["wall_s"], launches=on["launches"],
        launches_per_step={k: v * RAMP_CHUNKS for k, v in per_mb.items()},
        launches_per_microbatch=per_mb,
        eval_launches={k: 0 for k in per_mb})
    log("qwen ramp path: " + json.dumps(summary))
    return summary


def poll_healthz(port: int, proc, seen: list, scrapes: list):
    """Poll ``/healthz`` (and ``/metrics`` once a second attempt runs)
    until ``proc`` exits."""
    import urllib.request

    base = f"http://127.0.0.1:{port}"
    while proc.poll() is None:
        try:
            with urllib.request.urlopen(base + "/healthz", timeout=5) as r:
                h = json.loads(r.read())
            seen.append(h)
            if h.get("supervisor_attempt") == 2 and not scrapes:
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=5) as r:
                    text = r.read().decode()
                if "train_" in text:
                    scrapes.append(text)
        except OSError:
            pass
        time.sleep(0.2)


def gpt2_supervised_obs(smi: str, tmp: str):
    """Phase 13: GPT-2 small at full size under ``cli.supervise`` with the
    endpoint and the recorder: a checkpoint every 2 steps, a real SIGTERM at
    step 3, exit 18, a relaunch that resumes and finishes 6 steps."""
    import threading

    from hetu_galvatron_tpu_torch.cli.summarize import summarize
    from hetu_galvatron_tpu_torch.core.arguments import load_config

    over = [GPT2_YAML, "parallel.global_train_batch_size=8",
            "parallel.mixed_precision=bf16",
            f"train.train_iters={DRILL_STEPS}"]
    root = os.path.join(tmp, "obs_gpt2")
    os.makedirs(root)
    ref_path = os.path.join(root, "reference.jsonl")
    rc, text, _ = run_child("hetu_galvatron_tpu_torch.cli.train_dist",
                            over + [f"extra.summary_path={ref_path}"], root,
                            "gpt2_obs_reference")
    ref = summaries(ref_path)
    if rc != 0 or len(ref) != 1:
        raise SmokeFailure(f"gpt2 reference run: exit {rc}:\n{text[-3000:]}")
    ref = ref[0]
    flight = os.path.join(root, "flight")
    kids_path = os.path.join(root, "children.jsonl")
    cmd = [sys.executable, "-m", "hetu_galvatron_tpu_torch.cli.supervise",
           *over, f"ckpt.save={os.path.join(root, 'ck')}",
           "ckpt.save_interval=2", "supervisor.auto_restart=true",
           "supervisor.mode=process", "supervisor.metrics_port=0",
           "supervisor.backoff_base_s=0", "supervisor.poll_interval_s=0.2",
           "observability.enabled=true", "observability.flush_interval=1",
           f"observability.metrics_path={os.path.join(root, 'm.jsonl')}",
           f"observability.flight_dir={flight}",
           "rerun.inject_kind=preempt", f"rerun.inject_at_iter={OBS_PREEMPT_AT}",
           f"extra.summary_path={kids_path}"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    watchdog = threading.Timer(DRILL_TIMEOUT_S, proc.kill)
    watchdog.start()
    lines, seen, scrapes, poller = [], [], [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            m = re.search(r"/healthz and /metrics on http://127\.0\.0\.1:"
                          r"(\d+)", line)
            if m and poller is None:
                port = int(m.group(1))
                poller = threading.Thread(
                    target=poll_healthz, args=(port, proc, seen, scrapes),
                    daemon=True)
                poller.start()
        rc = proc.wait(timeout=DRILL_TIMEOUT_S)
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if poller is not None:
        poller.join(timeout=10)
    text = "".join(lines)
    with open(os.path.join(root, "supervise.log"), "w") as f:
        f.write(text)
    log(f"  supervise: exit {rc} in {wall:.1f} s; {len(seen)} /healthz "
        "answers")
    if rc != 0 or poller is None:
        raise SmokeFailure(f"supervise exit {rc}, endpoint "
                           f"{'seen' if poller else 'never printed'}:\n"
                           f"{text[-3000:]}")
    attempts = [h.get("supervisor_attempt") for h in seen]
    codes = [h.get("last_child_exit_code") for h in seen]
    log(f"  /healthz: attempts {sorted(set(attempts))}, last child exit "
        f"codes {sorted(set(c for c in codes if c is not None))}")
    if 2 not in attempts or 18 not in codes:
        raise SmokeFailure(f"/healthz never showed attempt 2 and exit 18: "
                           f"{seen[-3:]}")
    if not scrapes:
        raise SmokeFailure("no /metrics scrape with train_* series during "
                           "the second attempt")
    prom = [l for l in scrapes[0].splitlines()
            if l and not l.startswith("#")]
    bad = [l for l in prom if not PROM_LINE.match(l)]
    series = {l.split("{")[0].split(" ")[0] for l in prom}
    sup = sorted(n for n in series if n.startswith("supervisor_"))
    train = sorted(n for n in series if n.startswith("train_"))
    log(f"  /metrics: {len(prom)} samples, {len(sup)} supervisor_* and "
        f"{len(train)} train_* series, e.g. {sup[:3]} {train[:3]}")
    if bad or not sup or not train:
        raise SmokeFailure(f"/metrics: unparsed lines {bad[:3]}, supervisor "
                           f"{sup}, train {train}")
    kids = summaries(kids_path)
    if [k["exit_code"] for k in kids] != [18, 0]:
        raise SmokeFailure(f"children exits {[k['exit_code'] for k in kids]}"
                           ", want [18, 0]")
    stitched = kids[0]["losses"] + kids[1]["losses"]
    log(f"  [{smi}] reference losses {ref['losses']}")
    log(f"  [{smi}] stitched losses  {stitched}")
    if stitched != ref["losses"]:
        raise SmokeFailure("stitched losses differ from the uninterrupted "
                           "run's")
    if kids[1]["param_sha256"] != ref["param_sha256"]:
        raise SmokeFailure("final parameters differ from the uninterrupted "
                           "run's")
    n_layers = load_config(over[0], over[1:]).model.num_hidden_layers
    per_step = {k: n_layers if k in FLASH else 0 for k in KERNELS}
    first = OBS_PREEMPT_AT + 1
    for kid, steps in ((kids[0], first), (kids[1], DRILL_STEPS - first)):
        check_drill_child("gpt2 observability drill", kid,
                          want_launches(per_step, per_step, steps, 0))
    gp = kids[1]["goodput"]
    tot = gp["totals"]
    log(f"  goodput: {json.dumps(gp)}; sum {sum(tot.values()):.2f} s of the "
        f"supervisor's {wall:.2f} s")
    cats = ("productive_step", "recompile", "checkpoint_save",
            "resume_replay")
    if gp["restarts_survived"] != 1 or not all(tot[c] > 0 for c in cats) \
            or sum(tot.values()) > wall:
        raise SmokeFailure(f"goodput {gp} (want 1 restart, {cats} above 0, "
                           f"a sum within {wall:.2f} s)")
    dumps = sorted(glob.glob(os.path.join(flight, "flight_*.json")))
    reasons = []
    with open(os.devnull, "w") as null:
        for path in dumps:
            head = summarize(path, out=null)
            reasons.append(head.get("flight_reason"))
    log(f"  flight dumps: {[os.path.basename(p) for p in dumps]}, reasons "
        f"{reasons}")
    if sorted(reasons) != ["child_exit_18", "signal:SIGTERM"]:
        raise SmokeFailure(f"flight dump reasons {reasons}, want "
                           "signal:SIGTERM and child_exit_18")
    result = dict(
        card=smi, model="gpt2-small", steps=DRILL_STEPS,
        preempt_at=OBS_PREEMPT_AT, supervisor_wall_s=wall,
        healthz_answers=len(seen), metrics_series=dict(
            supervisor=sup, train=train), goodput=gp,
        flight_reasons=reasons, losses=stitched,
        launches={k: kids[0]["launches"][k] + kids[1]["launches"][k]
                  for k in KERNELS},
        launches_per_step=per_step, eval_launches={k: 0 for k in KERNELS})
    log("gpt2 supervised observability: " + json.dumps(result))
    return result


def obs_paths(smi: str, qwen_prefix: str, tmp: str):
    """Phases 12-13, each with the launch counters reset before its
    runs."""
    import torch

    phase("phase 12: main path of slice 8 (train_dist, Qwen2.5-7B widths, "
          f"{QWEN_LAYERS} layers, batch-size ramp, observability off and on)")
    ramp = qwen_ramp_path(smi, qwen_prefix, tmp)
    torch.cuda.empty_cache()
    phase("phase 13: main path of slice 8 (cli.supervise, GPT-2 small, "
          "/healthz and /metrics, flight recorder, goodput)")
    sup = gpt2_supervised_obs(smi, tmp)
    return {"ramp": ramp, "gpt2": sup}


def log_times(tag, times, lib, bnd):
    for k, (kms, pms) in times.items():
        log(f"  {tag}: {k:<16} kernel {kms:.3f} ms  plain {pms:.3f} ms  "
            f"library {lib[k]:.3f} ms  bound {bnd[k]['bound_ms']:.4f} ms "
            f"({bnd[k]['bound_by']})")


def flash_report(tag, times, lib, bnd, *, b, s, dtype, segs=None,
                 causal=True, sk=None, alt=None, d=64):
    """K1-K3 at one shape: TFLOP/s over the kept pairs, share of the bound,
    K1 against the library forward and K2 + K3 against the library
    backward timed beside them; with ``alt`` (:func:`route_ab`) each
    kernel's route and, for K1 and K2 on the wgmma route, the mma.sync
    route's time and share beside the new ones, and the goal (half the
    bound; in bf16 P and dS as hi + lo cap the share at 2/3). The log also
    gives the tiles that the rule of ``computed_tiles`` computes at the
    route's tile sizes against the tiles of the causal triangle, derived
    from the rule and not counted in the kernels."""
    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    out = {}
    sk = sk or s
    alt = alt or {}
    for k in FLASH:
        route = alt.get(k, {}).get("kernel_route")
        tq, tk = TF.tile_sizes(dtype, route, d)[k]
        ms = times[k][0]
        done = TF.computed_tiles(s, sk, tq, tk, causal=causal, segments=segs)
        tri = TF.computed_tiles(s, sk, tq, tk, causal=causal)
        out[k] = dict(tflops=bnd[k]["flops"] / (ms * 1e-3) / 1e12,
                      share_of_bound=bnd[k]["bound_ms"] / ms)
        if route is not None:
            out[k]["kernel_route"] = route
        log(f"  {tag}: {k:<16} {out[k]['tflops']:.1f} TFLOP/s over the kept "
            f"pairs, {100 * out[k]['share_of_bound']:.1f}% of the bound; "
            f"the tile rule computes {int(done.sum()) * (b // done.shape[0])}"
            f" of {int(tri.sum()) * b} {'causal' if causal else 'all'} "
            f"{tq}x{tk} tiles")
        if "mma_ms" in alt.get(k, {}):
            mma = alt[k]["mma_ms"]
            share = bnd[k]["bound_ms"] / mma
            out[k].update(mma_ms=mma, mma_share_of_bound=share,
                          speedup_over_mma=mma / ms)
            cap = (" (bf16's hi + lo cap: 66.7%)"
                   if str(dtype) == "torch.bfloat16" else "")
            log(f"  {tag}: {k:<16} wgmma {100 * out[k]['share_of_bound']:.1f}"
                f"% of the bound against mma.sync {100 * share:.1f}%; goal "
                f"50%{cap}: "
                f"{'met' if out[k]['share_of_bound'] >= 0.5 else 'missed'}")
    fwd, fwd_lib = times["flash_fwd"][0], lib["flash_fwd"]
    log(f"  {tag}: K1 {fwd:.3f} ms against the library forward "
        f"{fwd_lib:.3f} ms: {'faster' if fwd < fwd_lib else 'slower'} "
        f"({fwd_lib / fwd:.2f}x)")
    out["flash_fwd"]["beats_library"] = fwd < fwd_lib
    pair = times["flash_bwd_dkdv"][0] + times["flash_bwd_dq"][0]
    library = lib["flash_bwd_dkdv"]
    log(f"  {tag}: K2 + K3 {pair:.3f} ms against the library backward "
        f"{library:.3f} ms: {'faster' if pair < library else 'slower'} "
        f"({library / pair:.2f}x)")
    return dict(out, pair_ms=pair, library_ms=library,
                pair_beats_library=pair < library)


def check_path_flash(label, tag, shape, segs, peak_flops, peak_bytes,
                     fp16_ms=None, *, causal=True, layout="fused", sk=None,
                     plain_groups=1):
    """K1-K3 at a path's attention shape ``(b, n, kv, s, d)`` (bf16,
    causal unless told otherwise, packed ``segs``, True for three
    documents a row, q/k/v as views of the fused qkv projection or, with
    ``layout="cross"``, of the cross-attention's q and fused kv
    projections over ``sk`` keys): checked against the plain versions and
    timed beside the fp16 times ``fp16_ms`` when given; the inputs are
    released on return."""
    import torch

    b, n, kv, s, d = shape
    sk = sk or s
    res, inputs = check_case(tag, b=b, n=n, kv=kv, s=s, sk=sk, d=d,
                             dtype=torch.bfloat16, causal=causal, seg=segs,
                             rate=0.0, layout=layout,
                             plain_groups=plain_groups)
    times, lib, alt = time_kernels(inputs, reps=BIG_REPS,
                                   plain_groups=plain_groups, tag=label)
    bnd = bounds(b, n, kv, s, d, 2, peak_flops, peak_bytes, segs=inputs[2],
                 causal=causal, sk=sk)
    log_times(label, times, lib, bnd)
    report = flash_report(label, times, lib, bnd, b=b, s=s,
                          dtype=torch.bfloat16, segs=inputs[2],
                          causal=causal, sk=sk, alt=alt, d=d)
    if fp16_ms is not None:
        log(f"  {label}: K1 bf16 {times['flash_fwd'][0]:.3f} ms (P as hi + "
            f"lo) against fp16 {fp16_ms['flash_fwd']:.3f} ms (one "
            "rounding)")
        log(f"  {label}: K2 + K3 bf16 {report['pair_ms']:.3f} ms (P and "
            f"dS as hi + lo) against fp16 "
            f"{sum(fp16_ms[k] for k in BWD):.3f} ms (one rounding)")
    timing = {k: dict(ms=times[k][0], plain_ms=times[k][1],
                      library_ms=lib[k], bound_ms=bnd[k]["bound_ms"],
                      bound_by=bnd[k]["bound_by"], flops=bnd[k]["flops"],
                      bytes=bnd[k]["bytes"], shape=tag,
                      **route_keys(report[k])) for k in times}
    return {"checks": {k: [dict(r, case=tag) for r in recs]
                       for k, recs in res.items()}, "timing": timing,
            "report": report}


def route_keys(rep):
    """The route keys of one kernel's :func:`flash_report` entry that a
    path block carries: its route, share of the bound and, on the wgmma
    route, the mma.sync time and share beside them."""
    keys = ("kernel_route", "share_of_bound", "mma_ms", "mma_share_of_bound",
            "speedup_over_mma")
    return {k: rep[k] for k in keys if k in rep}


def check_ce(peak_bytes):
    """K4/K5 against their plain versions at the Qwen path's logits (fp32,
    the path's dtype, and bf16), at the Mixtral path's (fp32) and on the
    small cases; timed at the paths' shapes."""
    import torch

    checks = {"ce_fwd": [], "ce_bwd": []}
    timing = {}
    peak_fp32 = 67e12  # H100 SXM fp32 outside the tensor cores
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        res, inputs = check_ce_case(f"qwen T={QT} V={QV} {tag}", QT, QV,
                                    dtype, seed=11)
        for k, recs in res.items():
            checks[k] += [dict(r, case=f"qwen {tag}") for r in recs]
        times, lib = time_ce(inputs)
        del inputs
        torch.cuda.empty_cache()
        bnd = ce_bounds(QT, QV, dtype.itemsize, peak_bytes, peak_fp32)
        log_times(f"T={QT} V={QV} {tag}", times, lib, bnd)
        timing[tag] = {k: dict(ms=times[k][0], plain_ms=times[k][1],
                               library_ms=lib[k],
                               bound_ms=bnd[k]["bound_ms"],
                               bound_by=bnd[k]["bound_by"],
                               flops=bnd[k]["flops"], bytes=bnd[k]["bytes"])
                       for k in times}
    # the Mixtral path's logits, in its dtype
    tag = f"mixtral T={MT} V={MV} fp32"
    res, inputs = check_ce_case(tag, MT, MV, torch.float32, seed=12)
    for k, recs in res.items():
        checks[k] += [dict(r, case="mixtral fp32") for r in recs]
    times, lib = time_ce(inputs)
    del inputs
    torch.cuda.empty_cache()
    bnd = ce_bounds(MT, MV, 4, peak_bytes, peak_fp32)
    log_times(f"T={MT} V={MV} fp32", times, lib, bnd)
    timing["mixtral fp32"] = {
        k: dict(ms=times[k][0], plain_ms=times[k][1], library_ms=lib[k],
                bound_ms=bnd[k]["bound_ms"], bound_by=bnd[k]["bound_by"],
                flops=bnd[k]["flops"], bytes=bnd[k]["bytes"])
        for k in times}
    small = [("ragged T=77 V=1000 fp32", dict(t=77, v=1000,
                                              dtype=torch.float32)),
             ("ragged T=77 V=1000 bf16", dict(t=77, v=1000,
                                              dtype=torch.bfloat16)),
             ("V=50257 T=64 fp32", dict(t=64, v=50257, dtype=torch.float32)),
             ("V=50257 T=64 bf16", dict(t=64, v=50257, dtype=torch.bfloat16)),
             ("V=50257 T=64 fp16", dict(t=64, v=50257, dtype=torch.float16)),
             ("row stride 1024 > V=1000 fp32",
              dict(t=33, v=1000, ld=1024, dtype=torch.float32)),
             ("row stride 1003 > V=1000 bf16",
              dict(t=33, v=1000, ld=1003, dtype=torch.bfloat16))]
    for tag, kw in small:
        res, _ = check_ce_case(tag, seed=len(tag), **kw)
        for k, recs in res.items():
            checks[k] += [dict(r, case=tag) for r in recs]
    return {"checks": checks, "timing": timing, "zloss": check_ce_zloss()}


# -- phase 14: KV-cache decode and the continuous-batching engine ------------

SERVE_PATH = "qwen2.5-7b-serving"
SERVE_PHASE = ("phase 14: main path of slice 9 (KV-cache decode and the "
               "serving engine: qwen2.5-7b uncut, t5-3b generate_encdec, "
               "cli.serve with a weight swap)")
SERVE_REQUESTS, SERVE_SHARED, SERVE_PREFIX = 32, 16, 512
SERVE_LEN = (64, 1024)  # prompt lengths, uniform
SERVE_VOCAB = 152064  # Qwen2.5's
SERVE_NEW = 128
SERVE_ARRIVALS_S = 1.0  # arrivals uniform over the first second
SERVE_SPEC_K = 4
# max_seq_len 2048 holds the longest request (1024 + 128) and keeps the
# decode step's gathered pages at 2048 positions; 4096 blocks of 16 tokens
# are 3.76 GB of bf16 k/v
SERVE_ARGS = dict(max_batch_size=8, kv_block_size=16, num_kv_blocks=4096,
                  max_seq_len=2048, max_new_tokens=SERVE_NEW,
                  flush_interval=64)
TRACE_STEPS = 16  # decode steps in each traced window
T5_GEN_B, T5_GEN_ENC, T5_GEN_NEW = 4, 256, 32
CLI_NEW, CLI_LATE_S = 32, 6.0  # phase 14 (e): late requests' arrival
CLI_TIMEOUT_S = 300
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SERVE_DEVICE = "cuda"
CLI_EXTRA = []  # overrides the cli.serve child takes on top of the yaml


def serve_requests():
    """The 32 prompts of phase 14 (a) from seed 0: 16 of 64-1024 random
    ids, 16 that open with one 512-token prefix (one of them the prefix
    alone, the fully cached path, sent last), in a seeded order, with
    arrival offsets over the first second."""
    import numpy as np

    rng = np.random.default_rng(0)
    vocab = SERVE_VOCAB
    lo, hi = SERVE_LEN
    prefix = rng.integers(0, vocab, SERVE_PREFIX).tolist()
    plain = [rng.integers(0, vocab, int(rng.integers(lo, hi + 1))).tolist()
             for _ in range(SERVE_REQUESTS - SERVE_SHARED)]
    shared = [prefix + rng.integers(
        0, vocab, int(rng.integers(1, hi - SERVE_PREFIX + 1))).tolist()
        for _ in range(SERVE_SHARED - 1)]
    reqs = [(p, False) for p in plain] + [(p, True) for p in shared]
    order = rng.permutation(len(reqs))
    reqs = [reqs[i] for i in order] + [(list(prefix), True)]
    arrivals = np.sort(rng.uniform(0.0, SERVE_ARRIVALS_S, len(reqs)))
    return ([p for p, _ in reqs], [s for _, s in reqs],
            [float(a) for a in arrivals])


def serve_engine(cp, cfg, registry=None, dtype=None, warm=True, **over):
    """An engine over ``cp`` with phase 14's serving args and ``over``, in
    ``dtype`` (bf16 by default), warmed up unless ``warm`` is off."""
    import torch

    from hetu_galvatron_tpu_torch.core.args_schema import ServingArgs
    from hetu_galvatron_tpu_torch.observability.registry import (
        MetricsRegistry,
    )
    from hetu_galvatron_tpu_torch.serving.engine import ServingEngine

    sv = ServingArgs(**dict(SERVE_ARGS, **over))
    eng = ServingEngine(cp, cfg, sv, compute_dtype=dtype or torch.bfloat16,
                        registry=registry if registry is not None
                        else MetricsRegistry())
    if warm:
        eng.warmup()
    return eng


def drive(eng, reqs, arrivals):
    """Submit each request at its arrival offset and step the engine until
    every one retires; returns the handles and the run's host numbers
    (each step's wall and whether it admitted, the peak KV occupancy)."""
    reg = eng.registry
    handles = [None] * len(reqs)
    steps, occ, nxt = [], 0.0, 0
    t0 = time.perf_counter()
    while nxt < len(reqs) or eng.scheduler.has_work():
        now = time.perf_counter() - t0
        while nxt < len(reqs) and arrivals[nxt] <= now:
            handles[nxt] = eng.submit(reqs[nxt])
            nxt += 1
        if not eng.scheduler.has_work():
            if nxt < len(reqs):
                time.sleep(min(max(arrivals[nxt] - now, 0.0), 0.01))
            continue
        admitted = reg.histogram("serve/queue_wait_ms").count
        ts = time.perf_counter()
        eng.step()
        steps.append(((time.perf_counter() - ts) * 1e3,
                      reg.histogram("serve/queue_wait_ms").count
                      == admitted))
        occ = max(occ, eng.kv.occupancy)
    wall = time.perf_counter() - t0
    eng.flush()
    return handles, dict(wall_s=wall, steps=steps, peak_occupancy=occ)


def serve_run(tag, cp, cfg, reqs, arrivals, smi, registry=None, **over):
    """One engine run over the 32 requests: launch counters and peak
    memory reset before it; the printed numbers and the run's gates."""
    import numpy as np
    import torch

    from hetu_galvatron_tpu_torch.ops import _build

    eng = serve_engine(cp, cfg, registry=registry, **over)
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    handles, drv = drive(eng, reqs, arrivals)
    torch.cuda.synchronize()
    launches = dict(_build.launch_counts)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    reg = eng.registry
    bad = [i for i, h in enumerate(handles)
           if h.status != "done" or len(h.output) != SERVE_NEW]
    if bad:
        raise SmokeFailure(f"({tag}) requests {bad} did not finish their "
                           f"{SERVE_NEW} tokens")
    if any(launches.values()):
        raise SmokeFailure(f"({tag}) the serving path launched {launches}; "
                           "it runs no kernel of ops/")
    if peak >= MEM_LIMIT_GIB:
        raise SmokeFailure(f"({tag}) peak memory {peak:.2f} GiB")
    program = "verify" if eng._draft is not None else "decode"
    shapes = eng.program_shapes()
    if len(shapes[program]) != 1:
        raise SmokeFailure(f"({tag}) the {program} step ran at shapes "
                           f"{shapes[program]}")
    held = eng.prefix.blocks_held if eng.prefix is not None else 0
    if eng.kv.allocator.used != held:
        raise SmokeFailure(f"({tag}) at idle the allocator holds "
                           f"{eng.kv.allocator.used} blocks, the prefix "
                           f"cache {held}")
    ttft = reg.histogram("serve/ttft_ms").snapshot()
    itl = reg.histogram("serve/itl_ms").snapshot()
    tokens = sum(len(h.output) for h in handles)
    decode_ms = [w for w, dec in drv["steps"] if dec]
    out = dict(
        ttft_p50_ms=ttft["p50"], ttft_p99_ms=ttft["p99"],
        itl_p50_ms=itl["p50"], itl_p99_ms=itl["p99"], tokens=tokens,
        wall_s=drv["wall_s"], tokens_per_s=tokens / drv["wall_s"],
        steps=len(drv["steps"]), decode_only_steps=len(decode_ms),
        decode_step_ms_median=float(np.median(decode_ms)),
        peak_kv_occupancy=drv["peak_occupancy"],
        max_memory_allocated_gib=peak, launches=launches,
        program_shapes={k: sorted(map(str, v)) for k, v in shapes.items()
                        if k in ("decode", "verify")},
        streams=[h.result(0) for h in handles],
        cached=[h.cached_tokens for h in handles],
        kv_pool_bytes=sum(t.numel() * t.element_size()
                          for layer in eng.kv.pools for t in layer.values()))
    log(f"  ({tag}) {smi}: TTFT p50 {out['ttft_p50_ms']:.2f} / p99 "
        f"{out['ttft_p99_ms']:.2f} ms, inter-token p50 "
        f"{out['itl_p50_ms']:.2f} / p99 {out['itl_p99_ms']:.2f} ms, "
        f"{out['tokens_per_s']:.1f} tokens/s ({tokens} tokens in "
        f"{drv['wall_s']:.2f} s, {out['steps']} steps, decode-only median "
        f"{out['decode_step_ms_median']:.2f} ms), peak KV occupancy "
        f"{out['peak_kv_occupancy']:.4f}, max_memory_allocated "
        f"{peak:.2f} GiB, K1-K5 launches {launches}")
    if eng.prefix is not None:
        cold = [h.ttft_s() * 1e3 for h in handles if not h.cached_tokens]
        hit = [h.ttft_s() * 1e3 for h in handles if h.cached_tokens]
        out.update(prefix_hit_rate=eng.prefix.hit_rate,
                   ttft_cold_p50_ms=float(np.median(cold)),
                   ttft_hit_p50_ms=float(np.median(hit)) if hit else None,
                   hits=len(hit))
        log(f"  ({tag}) {smi}: prefix hit rate {eng.prefix.hit_rate:.4f} "
            f"({len(hit)} hits), TTFT p50 cold {out['ttft_cold_p50_ms']:.2f}"
            f" ms against hit {out['ttft_hit_p50_ms']:.2f} ms")
        if not hit:
            raise SmokeFailure(f"({tag}) no request hit the prefix cache")
    if eng._draft is not None:
        out.update(spec_accept_rate=eng.spec_accept_rate(),
                   drafted=eng._drafted_total,
                   accepted=eng._accepted_total)
        log(f"  ({tag}) {smi}: spec accept rate "
            f"{out['spec_accept_rate']:.4f} ({eng._accepted_total} of "
            f"{eng._drafted_total} drafted)")
    eng.close()
    del eng
    torch.cuda.empty_cache()
    return out


def traced_idle(tag, cp, cfg, reqs, smi, tmp, untraced_ms, **over):
    """The device's idle share over decode (or verify) steps: 8 requests
    admitted, then ``TRACE_STEPS`` steps under ``torch.profiler``, each in
    a ``serve/decode_step`` range; per step, the union of the kernels
    inside the step's host interval against its wall. Also against the
    untraced run's median decode-only step (``untraced_ms``), since the
    profiler slows the host's launches."""
    import torch

    from hetu_galvatron_tpu_torch.observability.trace_analysis import (
        load_trace,
    )

    eng = serve_engine(cp, cfg, **over)
    for p in reqs[:8]:
        eng.submit(p)
    for _ in range(3):
        eng.step()  # the admissions' prefills, then decode only
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(TRACE_STEPS):
            with torch.profiler.record_function("serve/decode_step"):
                eng.step()
    out_dir = os.path.join(tmp, f"trace_{tag}")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "run.trace.json"))
    eng.close()
    del eng, prof
    torch.cuda.empty_cache()
    trace = load_trace(out_dir)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in trace.events if e.get("cat") == "user_annotation"
             and e.get("name") == "serve/decode_step"]
    ops = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  str(e.get("name", ""))) for e in trace.events
                 if e.get("cat") in DEVICE_CATS)
    if len(spans) != TRACE_STEPS or not ops:
        raise SmokeFailure(f"({tag}) trace: {len(spans)} steps, {len(ops)} "
                           "device ops")
    busy = wall = 0.0
    kernels = 0
    for s0, s1 in spans:
        cur_s = cur_e = None
        for a, b, _ in ops:
            a, b = max(a, s0), min(b, s1)
            if b <= a:
                continue
            kernels += 1
            if cur_e is None or a > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        if cur_e is not None:
            busy += cur_e - cur_s
        wall += s1 - s0
    names = {n for _, _, n in ops}
    ours = [n for n in names if re.search(r"flash_|ce_fwd|ce_bwd", n)]
    if ours:
        raise SmokeFailure(f"({tag}) trace holds kernels of ops/: {ours}")
    busy_ms, wall_ms = busy / 1e3 / TRACE_STEPS, wall / 1e3 / TRACE_STEPS
    res = dict(traced_step_ms=wall_ms, busy_ms_per_step=busy_ms,
               idle_share_traced=1.0 - busy_ms / wall_ms,
               idle_share_untraced=1.0 - busy_ms / untraced_ms,
               untraced_step_ms=untraced_ms,
               device_ops_per_step=kernels / TRACE_STEPS)
    log(f"  ({tag}) {smi}: {TRACE_STEPS} traced steps: "
        f"{res['device_ops_per_step']:.0f} device ops a step, busy "
        f"{busy_ms:.3f} of {wall_ms:.3f} ms (idle "
        f"{res['idle_share_traced'] * 100:.1f}%); against the untraced "
        f"median decode-only step {untraced_ms:.3f} ms: idle "
        f"{res['idle_share_untraced'] * 100:.1f}%")
    return res


def logits_rule(name, got, want, tol=TOL_FP32):
    """Every element within tol * (rms(want) + |want|) (``compare``; the
    repo's fp32 rule by default)."""
    import torch

    return compare(name, got.to(SERVE_DEVICE, torch.float32),
                   want.to(SERVE_DEVICE, torch.float32), tol)


def noise(got, want, tol=TOL_16):
    """Reported, not gated: the error's RMS over the want's RMS and the
    worst element's share of tol * (rms(want) + |want|)."""
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    rms = want.square().mean().sqrt()
    return dict(err_rms_over_rms=float(err.square().mean().sqrt() / rms),
                max_abs_err=float(err.max()),
                worst_over_bf16_limit=float(
                    (err / (tol * (rms + want.abs()))).max()))


def top2_gap(row) -> float:
    import torch

    v = torch.topk(row.float(), 2).values
    return float(v[0] - v[1])


def first_diff(a, b):
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def teacher_forced(cp, cfg, prompt, stream, dtype):
    """fp32 logits of ``prompt + stream[:-1]`` through
    ``models/builder.forward_causal_lm`` in ``dtype`` (the plain attention
    core): row i is the model's view before stream[i]."""
    import torch

    from hetu_galvatron_tpu_torch.models.builder import forward_causal_lm

    toks = torch.tensor([prompt + stream[:-1]], device=SERVE_DEVICE)
    with torch.no_grad():
        logits = forward_causal_lm(cp, toks, cfg, compute_dtype=dtype)
    return logits[0, len(prompt) - 1:].float()


def hooked(eng, want_at=None):
    """Install a logits hook on ``eng``: rows by (rid, index), all of
    them or only the indices ``want_at[rid]``; returns the dict."""
    seen = {}

    def hook(rid, i, row):
        if want_at is None or want_at.get(rid) == i:
            seen[(rid, i)] = row.float().cpu()

    eng.logits_hook = hook
    return seen


def serve_alone(cp, cfg, reqs, idx, dtype, primer=None, max_new=None,
                want_p=None, **over):
    """Serve requests ``idx`` together on a fresh engine (``over``; no
    warm-up), after ``primer`` (one request of one token: it writes the
    prefix cache's blocks); returns their streams, cached lengths and
    logits rows (every emitted position, or only ``want_p[i]``)."""
    import torch

    eng = serve_engine(cp, cfg, dtype=dtype, warm=False, **over)
    if primer is not None:
        eng.submit(reqs[primer], max_new_tokens=1)
        eng.run_until_idle()
    hs = {i: eng.submit(reqs[i], max_new_tokens=None if max_new is None
                        else max_new[i]) for i in idx}
    want_at = (None if want_p is None else
               {hs[i].request.rid: want_p[i] for i in idx})
    seen = hooked(eng, want_at)
    eng.run_until_idle()
    eng.close()
    del eng
    torch.cuda.empty_cache()
    streams = {i: h.result(0) for i, h in hs.items()}
    rows = {i: (seen[(hs[i].request.rid, want_p[i])] if want_p is not None
                else torch.stack([seen[(hs[i].request.rid, j)]
                                  for j in range(len(streams[i]))]))
            for i in idx}
    return streams, {i: h.cached_tokens for i, h in hs.items()}, rows


def parting(tag, name_a, name_b, idx, streams_a, streams_b, rows, smi,
            want=None):
    """Streams of two runs: how many are equal; where one parts, both
    runs' top-2 gaps at the parting position, and with ``want(i, p)``
    both runs' logits there held to the fp32 rule against it (a near
    tie); without, their distance is reported. ``rows(i, p)`` gives the
    two runs' logits at position p of request i."""
    equal, parts = 0, []
    for i in idx:
        p = first_diff(streams_a[i], streams_b[i])
        if p is None:
            equal += 1
            continue
        ra, rb = rows(i, p)
        rec = dict(request=i, position=p, gap_a=top2_gap(ra),
                   gap_b=top2_gap(rb), distance=noise(ra, rb))
        if want is not None:
            w = want(i, p)
            rec["worst_a"] = logits_rule(
                f"{tag} req {i} pos {p} {name_a}", ra, w)["worst_over_limit"]
            rec["worst_b"] = logits_rule(
                f"{tag} req {i} pos {p} {name_b}", rb, w)["worst_over_limit"]
        parts.append(rec)
        log(f"  {tag}: request {i} parts at position {p}: top-2 gap "
            f"{name_a} {rec['gap_a']:.5f}, {name_b} {rec['gap_b']:.5f}; "
            f"the runs' logits there differ by "
            f"{rec['distance']['err_rms_over_rms']:.4f} of their RMS")
    log(f"  {tag} ({smi}): {equal} of {len(idx)} streams equal "
        f"({name_a} against {name_b}), {len(parts)} part")
    return dict(equal=equal, compared=len(idx), parted=parts)


def qwen_fp32_gates(params, cfg, reqs, alone, prefix_idx, smi):
    """Phase 14 (c), in fp32 where the repo's fp32 rule holds: the engine's
    logits at every emitted position against a teacher-forced fp32
    forward, for a cold run, prefix hits (the fully cached prompt
    included) and spec decode; and the streams of the engine against the
    offline ``generate``, of prefix hits and of spec decode against cold
    runs, each parting only where both runs' logits meet the rule."""
    import torch

    from hetu_galvatron_tpu_torch.models.generate import generate

    f32 = torch.float32
    over = dict(num_kv_blocks=1024)  # 1.88 GB of fp32 k/v
    hits = [i for i in alone if len(reqs[i]) > SERVE_PREFIX
            and reqs[i][:SERVE_PREFIX] == reqs[prefix_idx]] + [prefix_idx]
    idx = alone + [prefix_idx]
    cold, _, cold_rows = serve_alone(params, cfg, reqs, idx, f32, **over)
    tf = {i: teacher_forced(params, cfg, reqs[i], cold[i], f32)
          for i in idx}
    out = {"engine_logits_worst_over_limit": {
        i: logits_rule(f"fp32 engine logits, request {i}", cold_rows[i],
                       tf[i])["worst_over_limit"] for i in idx}}
    # the offline generate at batch 4, left-padded
    s0 = max(len(reqs[i]) for i in alone)
    toks = torch.zeros((len(alone), s0), dtype=torch.long,
                       device=SERVE_DEVICE)
    for b, i in enumerate(alone):
        toks[b, s0 - len(reqs[i]):] = torch.tensor(reqs[i])
    off_rows = []
    gen = generate(params, toks, cfg, SERVE_NEW,
                   prompt_lens=torch.tensor([len(reqs[i]) for i in alone],
                                            device=SERVE_DEVICE),
                   compute_dtype=f32,
                   on_logits=lambda j, lg: off_rows.append(lg.float().cpu()))
    offline = {i: gen[b, s0:].tolist() for b, i in enumerate(alone)}
    out["engine_vs_offline"] = parting(
        "(c) fp32 engine against offline generate", "engine", "offline",
        alone, cold, offline,
        lambda i, p: (cold_rows[i][p], off_rows[p][alone.index(i)]), smi,
        want=lambda i, p: tf[i][p])
    for tag, kw, ids in (("prefix", dict(prefix_cache=True,
                                         primer=prefix_idx), hits),
                         ("spec", dict(spec_decode=True,
                                       spec_k=SERVE_SPEC_K), idx)):
        streams, cached, rows = serve_alone(params, cfg, reqs, ids, f32,
                                            **kw, **over)
        if tag == "prefix" and any(cached[i] != SERVE_PREFIX for i in ids):
            raise SmokeFailure(f"(c) fp32 prefix hits cached {cached}")
        worst = {}
        for i in ids:
            # every position up to the parting (or all): the same context
            # as the teacher-forced forward of the cold stream
            p = first_diff(cold[i], streams[i])
            n = len(streams[i]) if p is None else p + 1
            worst[i] = logits_rule(f"fp32 {tag} logits, request {i}",
                                   rows[i][:n], tf[i][:n])["worst_over_limit"]
        out[f"{tag}_logits_worst_over_limit"] = worst
        out[f"{tag}_vs_cold"] = parting(
            f"(c) fp32 {tag} against cold", "cold", tag, ids, cold, streams,
            lambda i, p, r=rows: (cold_rows[i][p], r[i][p]), smi,
            want=lambda i, p: tf[i][p])
    del tf, cold_rows, off_rows
    torch.cuda.empty_cache()
    return out


def qwen_serving(smi, tmp):
    """Phase 14 (a)-(c) on ``qwen2.5-7b.yaml`` uncut."""
    import torch

    from hetu_galvatron_tpu_torch.cli import summarize as TSUM
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
    from hetu_galvatron_tpu_torch.models.builder import (
        init_causal_lm,
        param_count,
    )
    from hetu_galvatron_tpu_torch.models.generate import (
        cast_for_compute,
        generate,
    )
    from hetu_galvatron_tpu_torch.observability.registry import (
        MetricsRegistry,
    )
    from hetu_galvatron_tpu_torch.observability.sinks import JsonlSink

    cfg = args_from_cli([QWEN_YAML], mode="train_dist").model
    t0 = time.perf_counter()
    params = init_causal_lm(cfg, seed=1234, device=SERVE_DEVICE)
    n_params = param_count(params)
    reqs, shared, arrivals = serve_requests()
    lens = [len(p) for p in reqs]
    log(f"  qwen2.5-7b uncut: {cfg.num_hidden_layers} layers, {n_params:,} "
        f"parameters from seed 1234 in {time.perf_counter() - t0:.1f} s; "
        f"{len(reqs)} requests: prompts {min(lens)}-{max(lens)} ids, "
        f"{sum(shared)} open with one {SERVE_PREFIX}-token prefix (the last "
        f"is the prefix alone), {SERVE_NEW} new tokens each, greedy, "
        f"arrivals over {SERVE_ARRIVALS_S:.0f} s")
    alone = [i for i, s in enumerate(shared) if not s][:2] + \
        [i for i, s in enumerate(shared) if s][:2]
    prefix_idx = len(reqs) - 1
    t0 = time.perf_counter()
    fp32 = qwen_fp32_gates(params, cfg, reqs, alone, prefix_idx, smi)
    log(f"  (c) fp32 gates in {time.perf_counter() - t0:.1f} s")
    cp = cast_for_compute(params, torch.bfloat16)
    del params
    torch.cuda.empty_cache()
    gib = sum(t.numel() * t.element_size() for t in _leaves(cp)) / 2 ** 30
    log(f"  bf16 compute copy: {gib:.2f} GiB (bf16 matrices, fp32 "
        "embedding and norms)")

    # (a) the three runs, and (b) a second plain run with request events
    runs = {"plain": serve_run("plain", cp, cfg, reqs, arrivals, smi)}
    kv_pool = kv_pool_check(cfg, runs["plain"], smi)
    events_path = os.path.join(tmp, "serve_events.jsonl")
    reg = MetricsRegistry([JsonlSink(events_path)])
    runs["plain-repeat"] = serve_run("plain-repeat", cp, cfg, reqs,
                                     arrivals, smi, registry=reg,
                                     trace_requests=True)
    reg.close()
    runs["prefix"] = serve_run("prefix", cp, cfg, reqs, arrivals, smi,
                               prefix_cache=True)
    runs["spec"] = serve_run("spec", cp, cfg, reqs, arrivals, smi,
                             spec_decode=True, spec_k=SERVE_SPEC_K)
    plain = runs["plain"]["streams"]
    if runs["plain-repeat"]["streams"] != plain:
        diff = [i for i, (a, b) in enumerate(zip(
            plain, runs["plain-repeat"]["streams"])) if a != b]
        raise SmokeFailure(f"a second plain run differs on requests {diff}")
    log("  (b) the second plain run repeats the first bit for bit")
    records = stream_records(events_path)
    timelines, bad = TSUM.request_timelines(records)
    complete = sum(TSUM.timeline_complete(e) for e in timelines.values())
    if bad or len(timelines) != len(reqs) or complete != len(reqs):
        raise SmokeFailure(f"request events: {len(timelines)} timelines, "
                           f"{complete} complete, {bad} corrupt")
    log(f"  (b) serving.trace_requests=1: {complete} of {len(reqs)} "
        "timelines complete")
    log(f"  (a) {smi}: tokens/s {runs['spec']['tokens_per_s']:.1f} with "
        f"spec decode against {runs['plain']['tokens_per_s']:.1f} without")

    # the device's idle share over decode steps, each configuration
    for tag, over in (("plain", {}), ("prefix", dict(prefix_cache=True)),
                      ("spec", dict(spec_decode=True,
                                    spec_k=SERVE_SPEC_K))):
        runs[tag]["idle"] = traced_idle(
            tag, cp, cfg, reqs, smi, tmp,
            runs[tag]["decode_step_ms_median"], **over)

    # (b) four requests served alone: the same streams as among the 32;
    # their bf16 logits beside the bf16 noise of the model itself
    streams, _, rows = serve_alone(cp, cfg, reqs, alone, torch.bfloat16)
    bf16 = {"noise": {}}
    for i in alone:
        if streams[i] != plain[i]:
            raise SmokeFailure(f"request {i} served alone differs from its "
                               "stream among the 32")
        tf16 = teacher_forced(cp, cfg, reqs[i], plain[i], torch.bfloat16)
        tf32 = teacher_forced(cp, cfg, reqs[i], plain[i], torch.float32)
        bf16["noise"][i] = dict(engine_vs_tf_bf16=noise(rows[i], tf16),
                                engine_vs_tf_fp32=noise(rows[i], tf32),
                                tf_bf16_vs_tf_fp32=noise(tf16, tf32))
        n = bf16["noise"][i]
        log(f"  (c) bf16, request {i} (reported): the engine's logits "
            f"against the bf16 teacher-forced forward "
            f"{n['engine_vs_tf_bf16']['err_rms_over_rms']:.4f} of their "
            f"RMS (worst {n['engine_vs_tf_bf16']['worst_over_bf16_limit']:.2f}"
            f" of the bf16 limit), against fp32 "
            f"{n['engine_vs_tf_fp32']['err_rms_over_rms']:.4f}; the bf16 "
            f"forward against fp32 "
            f"{n['tf_bf16_vs_tf_fp32']['err_rms_over_rms']:.4f} (worst "
            f"{n['tf_bf16_vs_tf_fp32']['worst_over_bf16_limit']:.2f})")
    log(f"  (b) requests {alone} served alone: bit-identical to their "
        "streams among the 32")
    # bf16 stream pairs (reported): the engine against the offline
    # generate at batch 4, prefix hits and spec decode against plain
    s0 = max(len(reqs[i]) for i in alone)
    toks = torch.zeros((len(alone), s0), dtype=torch.long,
                       device=SERVE_DEVICE)
    for b, i in enumerate(alone):
        toks[b, s0 - len(reqs[i]):] = torch.tensor(reqs[i])
    off_rows = []
    out = generate(cp, toks, cfg, SERVE_NEW,
                   prompt_lens=torch.tensor([len(reqs[i]) for i in alone],
                                            device=SERVE_DEVICE),
                   compute_dtype=torch.bfloat16,
                   on_logits=lambda j, lg: off_rows.append(lg.float().cpu()))
    offline = {i: out[b, s0:].tolist() for b, i in enumerate(alone)}
    bf16["engine_vs_offline"] = parting(
        "(c) bf16 engine against offline generate", "engine", "offline",
        alone, {i: plain[i] for i in alone}, offline,
        lambda i, p: (rows[i][p], off_rows[p][alone.index(i)]), smi)
    everyone = list(range(len(reqs)))
    for tag, run, over in (
            ("prefix", runs["prefix"], dict(prefix_cache=True)),
            ("spec", runs["spec"], dict(spec_decode=True,
                                        spec_k=SERVE_SPEC_K))):
        other = run["streams"]
        parted = {i: first_diff(plain[i], other[i]) for i in everyone}
        parted = {i: p for i, p in parted.items() if p is not None}
        rows_a = rows_b = {}
        if parted:
            idx = sorted(parted)
            new_a = {i: parted[i] + 1 for i in idx}
            sa, _, rows_a = serve_alone(cp, cfg, reqs, idx, torch.bfloat16,
                                        max_new=new_a, want_p=parted)
            primer = None
            if tag == "prefix":
                # the first cold request of the shared prefix wrote the
                # cached blocks in the run replayed
                primer = next(i for i in everyone if shared[i]
                              and not run["cached"][i])
                new_b = new_a
            else:
                # the verify windows keep their width through position p
                new_b = {i: min(SERVE_NEW, parted[i] + 1 + SERVE_SPEC_K)
                         for i in idx}
            sb, cached, rows_b = serve_alone(
                cp, cfg, reqs, idx, torch.bfloat16, primer=primer,
                max_new=new_b, want_p=parted, **over)
            for i in idx:
                if sa[i] != plain[i][:len(sa[i])] or \
                        sb[i] != other[i][:len(sb[i])]:
                    raise SmokeFailure(f"({tag}) the replay of request {i} "
                                       "differs from its run")
                if tag == "prefix" and cached[i] != run["cached"][i]:
                    raise SmokeFailure(f"(prefix) replay of request {i} "
                                       f"cached {cached[i]} tokens, the run "
                                       f"{run['cached'][i]}")
        bf16[f"{tag}_vs_plain"] = parting(
            f"(c) bf16 {tag} against plain", "plain", tag, everyone, plain,
            other, lambda i, p, a=rows_a, b=rows_b: (a[i], b[i]), smi)
    for r in runs.values():
        del r["streams"], r["cached"]
    del cp
    torch.cuda.empty_cache()
    return dict(runs=runs, fp32_gates=fp32, bf16_reported=bf16,
                parameters=n_params, requests=len(reqs), alone=alone,
                kv_pool=kv_pool)


def kv_pool_check(cfg, run, smi):
    """The memory doctor's serving component (``kv_pool_mb`` for phase
    14's ``ServingArgs`` on a one-device plan of the uncut model) against
    the bytes of the pool tensors the engine allocated: equal, exactly
    (both go through ``serving/kv_cache.py``'s sizing helpers)."""
    from hetu_galvatron_tpu_torch.analysis.memory_doctor import (
        diagnose_memory,
    )
    from hetu_galvatron_tpu_torch.core.args_schema import ServingArgs

    rep = diagnose_memory(world1_plan(cfg.num_hidden_layers), cfg, 1,
                          serving=ServingArgs(**SERVE_ARGS))
    doctor_mb = rep.stages[0].components["kv_pool_mb"]
    if not rep.ok or doctor_mb * 2 ** 20 != run["kv_pool_bytes"]:
        raise SmokeFailure(f"memory doctor: KV pool {doctor_mb} MB "
                           f"(ok={rep.ok}, {rep.errors}); the engine "
                           f"allocated {run['kv_pool_bytes']} bytes")
    log(f"  (a) memory doctor: KV pool {doctor_mb:.1f} MB = the engine's "
        f"{run['kv_pool_bytes']:,} bytes of pool tensors, exactly; beside "
        f"the plain run's max_memory_allocated "
        f"{run['max_memory_allocated_gib']:.2f} GiB [{smi}]")
    return dict(doctor_kv_pool_mb=doctor_mb,
                engine_pool_bytes=run["kv_pool_bytes"],
                max_memory_allocated_gib=run["max_memory_allocated_gib"])


def _leaves(tree):
    from hetu_galvatron_tpu_torch.models.builder import named_leaves

    return [t for _, t in named_leaves(tree)]


def t5_generate(smi):
    """Phase 14 (d): ``generate_encdec`` on ``t5-3b.yaml`` at full depth
    against a teacher-forced ``forward_encdec``: in fp32 under the repo's
    fp32 rule (gated), then in bf16 (timed; its distance reported)."""
    import torch

    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
    from hetu_galvatron_tpu_torch.models.builder import init_causal_lm
    from hetu_galvatron_tpu_torch.models.encdec import forward_encdec
    from hetu_galvatron_tpu_torch.models.generate import (
        cast_for_compute,
        generate_encdec,
    )
    from hetu_galvatron_tpu_torch.ops import _build

    cfg = args_from_cli([T5_YAML], mode="train_dist").model
    params = init_causal_lm(cfg, seed=1234, device=SERVE_DEVICE)
    gen = torch.Generator(device=SERVE_DEVICE).manual_seed(0)
    enc = torch.randint(0, cfg.vocab_size, (T5_GEN_B, T5_GEN_ENC),
                        generator=gen, device=SERVE_DEVICE)
    res = {}
    for tag, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        cp = cast_for_compute(params, dtype)
        rows = []
        _build.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generate_encdec(cp, enc, cfg, T5_GEN_NEW, compute_dtype=dtype,
                              on_logits=lambda j, lg: rows.append(lg.float()))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = dict(_build.launch_counts)
        if any(launches.values()):
            raise SmokeFailure(f"(d) generate_encdec launched {launches}")
        got = torch.stack(rows, 1)  # [B, new, V]
        with torch.no_grad():
            want = forward_encdec(cp, enc, out[:, :-1], cfg,
                                  compute_dtype=dtype).float()
        if tag == "fp32":
            err = logits_rule("t5-3b generate_encdec fp32 logits", got, want)
            res[tag] = dict(ms=ms, worst_over_limit=err["worst_over_limit"],
                            max_abs_err=err["max_abs_err"])
        else:
            res[tag] = dict(ms=ms, **noise(got, want))
        log(f"  (d) {smi}: t5-3b {tag}, {cfg.num_encoder_layers} + "
            f"{cfg.num_hidden_layers} layers, batch {T5_GEN_B}, encoder "
            f"{T5_GEN_ENC}, {T5_GEN_NEW} new tokens in {ms:.1f} ms "
            f"({ms / T5_GEN_NEW:.2f} ms a token, the encoder included), "
            f"K1-K5 launches {launches}; logits against the teacher-forced "
            f"forward: {res[tag]}")
        del cp, got, want
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return res


def cli_serve_swap(smi, tmp):
    """Phase 14 (e): ``cli.serve`` on GPT-2 small as a child process with
    ``watch=`` on a checkpoint root; a second checkpoint is committed
    once it serves, and the requests sent after the swap must equal a
    fresh engine's on the new weights."""
    import dataclasses

    import torch

    from hetu_galvatron_tpu_torch.cli import summarize as TSUM
    from hetu_galvatron_tpu_torch.core.arguments import args_from_cli
    from hetu_galvatron_tpu_torch.models.builder import init_causal_lm
    from hetu_galvatron_tpu_torch.observability.registry import (
        MetricsRegistry,
    )
    from hetu_galvatron_tpu_torch.runtime.checkpoint import save_checkpoint
    from hetu_galvatron_tpu_torch.serving.engine import ServingEngine

    args = args_from_cli([GPT2_YAML], mode="train_dist")
    cfg = args.model
    root = os.path.join(tmp, "serve_ckpt")
    first = init_causal_lm(cfg, seed=1, device=SERVE_DEVICE)
    save_checkpoint(root, 1, first)
    del first
    prompts = [f"request {i}: the quick brown fox jumps over the lazy dog "
               * (1 + i % 3) for i in range(8)]
    late = list(range(4, 8))
    req_path = os.path.join(tmp, "requests.jsonl")
    with open(req_path, "w") as f:
        for i, p in enumerate(prompts):
            f.write(json.dumps({
                "prompt": p, "max_new_tokens": CLI_NEW,
                "arrival_offset_s": CLI_LATE_S if i in late else 0.05 * i})
                + "\n")
    metrics = os.path.join(tmp, "serve_cli_metrics.jsonl")
    cmd = [sys.executable, "-m", "hetu_galvatron_tpu_torch.cli.serve",
           GPT2_YAML, f"requests={req_path}", f"metrics={metrics}",
           "stream=0", "serving.trace_requests=1", f"ckpt={root}",
           "watch=0.2", *CLI_EXTRA]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    err_lines = []
    try:
        for line in proc.stderr:
            err_lines.append(line)
            if "watching" in line:
                break
        else:
            raise SmokeFailure("cli.serve exited before watching: "
                               + "".join(err_lines[-20:]))
        t_watch = time.perf_counter() - t0
        second = init_causal_lm(cfg, seed=2, device=SERVE_DEVICE)
        save_checkpoint(root, 2, second)
        t_commit = time.perf_counter() - t0
        out, rest = proc.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    err_lines.append(rest)
    err = "".join(err_lines)
    with open(os.path.join(tmp, "serve_cli.log"), "w") as f:
        f.write(out + err)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SmokeFailure(f"cli.serve exit {proc.returncode}: {err[-3000:]}")
    done = [json.loads(x) for x in out.splitlines()
            if x.startswith("{") and '"done"' in x]
    if len(done) != len(prompts) or any(d["status"] != "done" for d in done):
        raise SmokeFailure(f"cli.serve answered {len(done)} of "
                           f"{len(prompts)} requests: {done}")
    records = stream_records(metrics)
    swaps = [r for r in records if r.get("name") == "serve/weight_swaps"]
    stalls = [r for r in records if r.get("name") == "serve/swap_stall_ms"]
    n_swaps = swaps[-1]["value"] if swaps else 0
    if n_swaps < 1 or not stalls:
        raise SmokeFailure(f"no weight swap in the metrics ({n_swaps})")
    ev = [r["data"] for r in records if r.get("kind") == "event"
          and r.get("name") == "request"]
    swap_tm = min(e["tm"] for e in ev if e["ev"] == "weight_swap")
    after = sorted(e["rid"] for e in ev if e["ev"] == "submit"
                   and e["tm"] > swap_tm)
    if after != late:
        raise SmokeFailure(f"requests submitted after the swap: {after}, "
                           f"want {late}")
    sv = dataclasses.replace(args.serving, eos_id=256)
    eng = ServingEngine(second, cfg, sv, registry=MetricsRegistry())
    hs = {i: eng.submit(list(prompts[i].encode()), max_new_tokens=CLI_NEW)
          for i in late}
    eng.run_until_idle()
    eng.close()
    by_rid = {d["rid"]: d for d in done}
    for i in late:
        want = hs[i].result(0)
        want = want[:want.index(256)] if 256 in want else want
        if by_rid[i]["tokens"] != want:
            raise SmokeFailure(f"request {i}, sent after the swap, differs "
                               "from a fresh engine on the new weights")
    buf = io.StringIO()
    head = TSUM.summarize(metrics, out=buf, timeline="all")
    if head.get("timelines_complete") != len(prompts):
        raise SmokeFailure(f"summarize --timeline all: {head}")
    res = dict(wall_s=wall, watching_at_s=t_watch, committed_at_s=t_commit,
               weight_swaps=n_swaps, swap_stall_ms=stalls[-1]["p50"],
               swap_stall_max_ms=stalls[-1]["max"],
               timelines_complete=head["timelines_complete"],
               after_swap=after)
    log(f"  (e) {smi}: cli.serve (GPT-2 small, child on cuda) answered all "
        f"{len(prompts)} requests in {wall:.1f} s; serving from "
        f"{t_watch:.1f} s, step_2 committed at {t_commit:.1f} s; "
        f"serve/weight_swaps {n_swaps:.0f}, serve/swap_stall_ms "
        f"{res['swap_stall_ms']:.3f}; requests {after} sent after the swap "
        "equal a fresh engine on step_2 bit for bit; summarize --timeline "
        f"all: {head['timelines_complete']} of {len(prompts)} complete")
    del second
    torch.cuda.empty_cache()
    return res


def serve_paths(smi: str):
    """Phase 14 (a)-(e), in a temporary directory removed at exit."""
    import torch

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_serve_") as tmp:
        qwen = qwen_serving(smi, tmp)
        torch.cuda.empty_cache()
        t5 = t5_generate(smi)
        cli = cli_serve_swap(smi, tmp)
    wall = time.perf_counter() - t0
    log(f"  phase 14 in {wall:.1f} s")
    return dict(path=SERVE_PATH, device=smi, qwen=qwen, t5=t5, cli=cli,
                wall_s=wall)


PLAN_PATH = f"qwen2.5-7b-{QWEN_LAYERS}-layers-profile-search-train"
PLAN_PHASE = ("phase 15: main path of slice 10 (profile -> search -> train: "
              f"Qwen2.5-7B widths, {QWEN_LAYERS} layers, searched world-1 "
              "plans through train_dist)")
PLAN_BSZ_MAX = 8  # the computation profile's batch sizes 1..8
PLAN_LAYERNUM = (2, 4)  # model_profiler.layernum_min / layernum_max
PLAN_CALLS = 2 + 20  # a profiled forward: 2 warm-up calls, 20 timed
PLAN_STEPS = 6  # each trained plan: 2 warm-up steps, 4 timed
PLAN_BUDGET_GB = 64.0
PLAN_UNCUT_GB = 80.0  # the uncut model searched at the whole card
# (h): the HBM gate's budget sits this far below the doctor's peak for the
# 64 GB plan
HBM_MARGIN_GB = 1.0
# the search reads (b)'s profile in static mode, that is its batch-1 point
# as ms per sample: JAX's profiler (and the port, for parity) writes each
# batch size's whole-batch ms, which batch mode's fit takes for ms per
# sample, so its times at a microbatch of 1 come out negative (printed)
PLAN_SEARCH = ["search.num_devices_per_node=1", "search.min_bsz=1",
               "search.max_bsz=16", "search.bsz_scale=1",
               "search.default_dp_type=ddp", "search.time_profile_mode=static",
               "search.memory_profile_mode=static"]
# overrides every command of phase 15 takes on top of its own, and the
# device of its one direct allocation: a CPU dry run at tiny widths
# monkeypatches them (with the Qwen shape constants and torch.cuda's calls)
PLAN_EXTRA = []
PLAN_DEVICE = "cuda"
# the four files JAX's hardware profiler writes at world 1, as it writes
# them (json.dump, indent 4)
WORLD1_HARDWARE = {
    "allreduce_bandwidth_1nodes_1gpus_per_node.json": "{}",
    "p2p_bandwidth_1nodes_1gpus_per_node.json": "{}",
    "sp_time_1nodes_1gpus_per_node.json": "{}",
    "overlap_coefficient.json": '{\n    "overlap_coe": 1.0\n}',
}


def plan_launches(layers: int, ckpt: int, microbatches: int):
    """K1-K5 launches of ``microbatches`` training microbatches of a plan
    with ``ckpt`` of its ``layers`` layers checkpointed: one K1 a layer and
    one more a checkpointed layer (the recompute), one K2 and one K3 a
    layer, one K4 and one K5."""
    per = {"flash_fwd": layers + ckpt, "flash_bwd_dkdv": layers,
           "flash_bwd_dq": layers, "ce_fwd": 1, "ce_bwd": 1}
    return {k: v * microbatches for k, v in per.items()}


def tight_budget_gb(mem, k: int, hidden: int, micro: int):
    """The smallest budget (GB, whole MB) at which the search's memory
    model fits microbatches of ``micro`` with ``k`` of the layers
    checkpointed and half a layer's remat saving to spare, from phase 15
    (c)'s profile: per layer ceil(model states + activation), the vocab
    layers' states, activation and the 1024 MB context reserve, the global
    buffer, after the 20% the search reserves for the allocator's cache
    above 20 GB."""
    layer = mem["layertype_0_sp"][str(QS)]
    act = layer["tp_activation_per_bsz_dict"]
    off = mem["other_memory_pp_off_sp"][str(QS)]
    states = 4 * layer["parameter_size"]
    none_mb = math.ceil(states + act["1"] * micro)
    ck_mb = math.ceil(states + act["checkpoint"] * micro)
    need = (math.ceil(off["model_states"]["1"] + off["activation"]["1"]
                      * micro + 1024.0)
            + int(micro * hidden * QS * 4 / 2 ** 20 / 2)
            + k * ck_mb + (QWEN_LAYERS - k) * none_mb)
    target = need + (none_mb - ck_mb) // 2

    def usable(max_mb):  # SearchEngine.solve_task's cache reserve
        return max_mb - (int(max_mb * 0.2) if max_mb // 1024 > 20 else 0)

    max_mb = target
    while usable(max_mb) < target:
        max_mb += 1
    return max_mb / 1024, need


def plan_search(tag, argv, budget_gb, tmp, hbm_gb=None):
    """``cli.search_dist`` at one budget, under the static HBM gate at
    ``hbm_gb`` when given; (exit code, plan path, plan, the gate's log
    lines)."""
    import contextlib

    from hetu_galvatron_tpu_torch.cli import search_dist

    out_dir = os.path.join(tmp, f"plans_{tag}")
    gate = [] if hbm_gb is None else [f"search.hbm_budget_gb={hbm_gb}"]
    t0 = time.perf_counter()
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = search_dist.main(argv + gate + [
            f"search.memory_constraint={budget_gb}",
            f"search.output_config_path={out_dir}"])
    secs = time.perf_counter() - t0
    pruned = [line for line in printed.getvalue().splitlines()
              if line.startswith("hbm gate: pruned")]
    if pruned:
        log(f"  search {tag}: the HBM gate pruned {len(pruned)} candidates; "
            f"first: {pruned[0]}")
    found = sorted(glob.glob(os.path.join(out_dir, "galvatron_config_*")))
    if (rc == 0) != bool(found):
        raise SmokeFailure(f"search {tag}: exit {rc} with plans {found}")
    if not found:
        log(f"  search {tag} at {budget_gb} GB: no plan (exit {rc}, "
            f"{secs:.2f} s)")
        return rc, None, None, pruned
    with open(found[0]) as f:
        plan = json.load(f)
    log(f"  search {tag} at {budget_gb} GB ({secs:.2f} s): bsz "
        f"{plan['global_bsz']}, chunks {plan['chunks']}, checkpoint "
        f"[{plan['checkpoint']}], predicted {plan['predicted_time_cost_ms']}"
        f" ms a step ({os.path.basename(found[0])})")
    return rc, found[0], plan, pruned


def plan_train(tag, prefix, over, smi):
    """``train`` on phase 6's cell under ``over`` (a JSON plan or GLOBAL
    mode) for PLAN_STEPS steps: losses, launches, peak memory, step ms
    and the parameters' digests, with the launch counters reset just
    before and read just after."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import packed_corpus_overrides
    from hetu_galvatron_tpu_torch.ops import _build

    args = load_config(QWEN_YAML, [
        f"model.num_hidden_layers={QWEN_LAYERS}", "model.use_fused_ce=true",
        "parallel.mixed_precision=bf16", f"train.train_iters={PLAN_STEPS}",
        "profile.profile=1", f"profile.profile_warmup={PROFILE_WARMUP}",
        *packed_corpus_overrides(prefix), *over, *PLAN_EXTRA])
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    out = train(args)
    torch.cuda.synchronize()
    res = dict(losses=out["losses"], launches=dict(_build.launch_counts),
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               step_ms=out["iter_ms"], batch_sizes=out["batch_sizes"],
               predicted_ms=out["predicted_time_cost_ms"],
               digests=param_digests(out["params"]))
    del out
    torch.cuda.empty_cache()
    log(f"  train {tag}: losses {res['losses']}; step {res['step_ms']:.2f} "
        f"ms (CUDA events, steps {PROFILE_WARMUP}..{PLAN_STEPS - 1}); peak "
        f"{res['peak_gib']:.2f} GiB; launches {res['launches']} [{smi}]")
    return res


def plan_gates(tag, res, plan, budget_gb, cfg):
    """(e)'s gates on one searched plan's run, and its reported ratios."""
    flags = [int(x) for x in plan["checkpoint"].split(",")]
    steps = PLAN_STEPS * plan["chunks"]
    want = plan_launches(QWEN_LAYERS, sum(flags), steps)
    losses = res["losses"]
    expect0 = (math.log(cfg.padded_vocab_size)
               + 0.5 * 0.02 ** 2 * cfg.hidden_size)
    if len(losses) != PLAN_STEPS or not all(map(math.isfinite, losses)):
        raise SmokeFailure(f"{tag}: losses {losses} not all finite")
    if abs(losses[0] - expect0) > 0.5:
        raise SmokeFailure(f"{tag}: step-0 loss {losses[0]:.4f} is not "
                           f"within 0.5 of ln V + sigma^2/2 = {expect0:.4f}")
    if res["batch_sizes"] != [plan["global_bsz"]] * PLAN_STEPS:
        raise SmokeFailure(f"{tag}: batch sizes {res['batch_sizes']}")
    if res["launches"] != want:
        raise SmokeFailure(f"{tag}: launches {res['launches']}, want {want} "
                           f"({steps} microbatches, {sum(flags)} of "
                           f"{QWEN_LAYERS} layers checkpointed)")
    if res["peak_gib"] >= MEM_LIMIT_GIB:
        raise SmokeFailure(f"{tag}: peak {res['peak_gib']:.2f} GiB")
    if res["predicted_ms"] != plan["predicted_time_cost_ms"]:
        raise SmokeFailure(f"{tag}: the run read predicted "
                           f"{res['predicted_ms']} ms, the plan holds "
                           f"{plan['predicted_time_cost_ms']}")
    res.update(budget_gb=budget_gb, checkpoint=flags,
               global_bsz=plan["global_bsz"], chunks=plan["chunks"],
               expected_step0_loss=expect0,
               step_over_predicted=res["step_ms"] / plan[
                   "predicted_time_cost_ms"],
               peak_over_budget=res["peak_gib"] / budget_gb)
    over = res["peak_over_budget"] > 1  # a finding, not a failure
    log(f"  {tag}: measured / predicted step {res['step_over_predicted']:.4f}"
        f" ({res['step_ms']:.2f} / {plan['predicted_time_cost_ms']} ms); "
        f"peak / budget {res['peak_over_budget']:.4f} ({res['peak_gib']:.2f}"
        f" GiB / {budget_gb} GB){'; OVER ITS BUDGET' if over else ''}")
    return res


def world1_plan(layers: int, global_bsz: int = 1):
    """An all-off plan for one device: every layer at pp, tp, cp, dp 1
    without remat, ``global_bsz`` in one microbatch."""
    from hetu_galvatron_tpu_torch.utils.strategy import (
        EmbeddingLMHeadStrategy,
        LayerStrategy,
        strategy_list2config,
    )

    return strategy_list2config([LayerStrategy()] * layers,
                                global_bsz=global_bsz, chunks=1,
                                vocab=EmbeddingLMHeadStrategy(),
                                pp_division=[layers])


def doctor_row(tag, path, cfg, measured_gib, smi):
    """(g): the memory doctor's world-1 accounting of a searched plan
    beside its measured ``max_memory_allocated``; the report must be clean
    (its cost-model cross-check exact), the ratio is reported."""
    from hetu_galvatron_tpu_torch.analysis.memory_doctor import (
        diagnose_memory,
    )

    rep = diagnose_memory(path, cfg, 1)
    if not rep.ok:
        raise SmokeFailure(f"memory doctor on the {tag} plan: {rep.errors}")
    comp = dict(rep.stages[0].components)
    measured_mb = measured_gib * 1024
    row = dict(components_mb=comp, doctor_peak_mb=rep.peak_mb,
               measured_peak_mb=measured_mb,
               measured_over_doctor=measured_mb / rep.peak_mb,
               cross_check_ratios=rep.ratios)
    log(f"  (g) {tag} plan: doctor "
        + ", ".join(f"{k[:-3]} {v:.1f}" for k, v in comp.items())
        + f" MB; peak {rep.peak_mb:.1f} MB against measured "
        f"{measured_mb:.1f} MB ({measured_gib:.2f} GiB): measured / doctor "
        f"{row['measured_over_doctor']:.4f} [{smi}]")
    return row


def check_cli(tag, path, argv):
    """(i): ``python -m hetu_galvatron_tpu_torch.cli.check`` on a searched
    plan in a child process; it must exit 0."""
    cmd = [sys.executable, "-m", "hetu_galvatron_tpu_torch.cli.check",
           "--plan", path, "--model", QWEN_YAML,
           f"model.num_hidden_layers={QWEN_LAYERS}", *PLAN_EXTRA, "--world",
           "1", *argv]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    secs = time.perf_counter() - t0
    verdicts = [line for line in res.stdout.splitlines()
                if line.startswith(("plan doctor:", "memory doctor:",
                                    "per-device peak"))]
    log(f"  (i) cli.check {' '.join(argv) or '--plan'} on the {tag} plan: "
        f"exit {res.returncode} in {secs:.1f} s; {verdicts}")
    if res.returncode != 0:
        raise SmokeFailure(f"cli.check {argv} on the {tag} plan exited "
                           f"{res.returncode}:\n{res.stdout[-2000:]}"
                           f"\n{res.stderr[-2000:]}")
    return dict(exit_code=res.returncode, seconds=secs, verdicts=verdicts)


def plan_paths(smi: str):
    """Phase 15 (a)-(f), in a temporary directory removed at exit."""
    import torch

    from hetu_galvatron_tpu_torch.cli import profiler as cli_profiler
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.core.profiler.model_profiler import (
        ModelProfiler,
    )
    from hetu_galvatron_tpu_torch.core.search_engine.profiles import (
        parse_time_config,
    )
    from hetu_galvatron_tpu_torch.models.builder import (
        init_decoder_layer,
        named_leaves,
    )
    from hetu_galvatron_tpu_torch.ops import _build

    t_all = time.perf_counter()
    cfg = load_config(QWEN_YAML, [
        f"model.num_hidden_layers={QWEN_LAYERS}", *PLAN_EXTRA]).model
    model = [QWEN_YAML, f"model.num_hidden_layers={QWEN_LAYERS}",
             "model.use_fused_ce=true", *PLAN_EXTRA]
    out = {"path": PLAN_PATH, "device": smi}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plan_") as tmp:
        hw, prof = os.path.join(tmp, "hardware"), os.path.join(tmp, "prof")
        log("  (a) hardware profile at world 1")
        if cli_profiler.main(model + [
                "mode=profile_hardware",
                "hardware_profiler.num_devices_per_node=1",
                f"hardware_profiler.output_dir={hw}"]) != 0:
            raise SmokeFailure("the hardware profiler failed")
        for name, want in WORLD1_HARDWARE.items():
            with open(os.path.join(hw, name)) as f:
                got = f.read()
            if got != want:
                raise SmokeFailure(f"{name}: {got!r}, JAX writes {want!r}")
        log(f"  the four world-1 files equal JAX's: {sorted(WORLD1_HARDWARE)}"
            f" [{smi}]")

        lo, hi = PLAN_LAYERNUM
        profile = model + [
            "mode=model_profiler", f"model_profiler.output_dir={prof}",
            f"model_profiler.profile_seq_length_list=[{QS}]",
            f"model_profiler.layernum_min={lo}",
            f"model_profiler.layernum_max={hi}"]
        log(f"  (b) computation profile: batch mode, bsz 1-{PLAN_BSZ_MAX} "
            f"at seq {QS}, {lo} and {hi} layers")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        if cli_profiler.main(profile + [
                "model_profiler.profile_type=computation",
                "model_profiler.profile_mode=batch",
                "model_profiler.profile_min_batch_size=1",
                f"model_profiler.profile_max_batch_size={PLAN_BSZ_MAX}"]):
            raise SmokeFailure("the computation profile failed")
        comp_s = time.perf_counter() - t0
        comp_launches = dict(_build.launch_counts)
        want = dict.fromkeys(comp_launches, 0)
        want["flash_fwd"] = PLAN_CALLS * (lo + hi) * PLAN_BSZ_MAX
        log(f"  launches {comp_launches} (want {want}: {PLAN_CALLS} calls "
            f"of {lo} + {hi} layers at {PLAN_BSZ_MAX} batch sizes)")
        if comp_launches != want:
            raise SmokeFailure(f"computation profile: launches "
                               f"{comp_launches}, want {want}")
        (comp_path,) = glob.glob(os.path.join(prof, "computation_*.json"))
        with open(comp_path) as f:
            comp = json.load(f)
        rows = {}
        for b in range(1, PLAN_BSZ_MAX + 1):
            layer = comp[f"layertype_0_bsz{b}_seq{QS}"]
            other = comp[f"layertype_other_bsz{b}_seq{QS}"]
            rows[b] = dict(layer_ms=layer, other_ms=other)
            log(f"    bsz {b}: {layer:.3f} ms a layer, {other:.3f} ms other "
                f"(forward, bf16, flash K1) [{smi}]")
        # what batch mode would read: the fit of whole-batch ms x bsz
        fit, other_fit = (v[0] for v in parse_time_config(
            comp, mode="batch", num_layertype=1, seqlen_list=[QS]))
        at1 = float(fit[0] + fit[1])
        log(f"    batch-mode fit of ms x bsz: {float(fit[0]):.3f} bsz + "
            f"{float(fit[1]):.3f}, so {at1:.3f} ms a layer at a microbatch "
            f"of 1 (the batch-1 point: {rows[1]['layer_ms']:.3f} ms) [{smi}]")
        out["computation"] = dict(
            rows=rows, seconds=comp_s, launches=comp_launches,
            batch_fit_layer=[float(x) for x in fit],
            batch_fit_other=[float(x) for x in other_fit],
            batch_fit_layer_ms_at_1=at1)

        log(f"  (c) memory profile: seq {QS}, bsz 1, tp 1, checkpoint off "
            "and on")
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        if cli_profiler.main(profile + [
                "model_profiler.profile_type=memory",
                "model_profiler.profile_batch_size=1"]):
            raise SmokeFailure("the memory profile failed")
        mem_s = time.perf_counter() - t0
        mem_launches = dict(_build.launch_counts)
        # a warm-up and a measured step at each of lo and hi layers, with
        # and without remat
        want = {k: 0 for k in mem_launches}
        for layers in (lo, hi):
            for ckpt in (0, layers):
                for k, v in plan_launches(layers, ckpt, 2).items():
                    want[k] += v
        log(f"  launches {mem_launches} (want {want})")
        if mem_launches != want:
            raise SmokeFailure(f"memory profile: launches {mem_launches}, "
                               f"want {want}")
        (mem_path,) = glob.glob(os.path.join(prof, "memory_*.json"))
        with open(mem_path) as f:
            mem = json.load(f)
        layer = mem["layertype_0_sp"][str(QS)]
        gen = torch.Generator(device=PLAN_DEVICE).manual_seed(0)
        n_layer = sum(t.numel() for _, t in named_leaves(
            init_decoder_layer(gen, cfg, torch.device(PLAN_DEVICE))))
        want_mb = n_layer * 4 / 2 ** 20
        if layer["parameter_size"] != want_mb:
            raise SmokeFailure(f"parameter_size {layer['parameter_size']} "
                               f"!= {n_layer} parameters x 4 / 2^20")
        act = layer["tp_activation_per_bsz_dict"]
        off = mem["other_memory_pp_off_sp"][str(QS)]
        log(f"    parameter_size {layer['parameter_size']:.3f} MB a layer "
            f"({n_layer} parameters); activation a sample {act['1']:.1f} MB"
            f" a layer without remat, {act['checkpoint']:.1f} MB with; other"
            f" states {off['model_states']['1']:.1f} MB, activation "
            f"{off['activation']['1']:.1f} MB a sample [{smi}]")
        # the step's peak a layer, the quantity XLA's temps count in JAX:
        # reported beside the profile (it falls in the AdamW update)
        mp = ModelProfiler(load_config(QWEN_YAML, model[1:]))
        peak = {}
        for ck in (False, True):
            m = [mp._step_memory_mb(mp._cfg(n, QS), 1, 1, ck)["peak"]
                 for n in (lo, hi)]
            peak[ck] = (m[1] - m[0]) / (hi - lo)
        log(f"    the step's peak a layer: {peak[False]:.1f} MB without "
            f"remat, {peak[True]:.1f} MB with [{smi}]")
        out["memory"] = dict(parameter_size_mb=layer["parameter_size"],
                             layer_parameters=n_layer,
                             activation_mb=act["1"],
                             activation_remat_mb=act["checkpoint"],
                             other_states_mb=off["model_states"]["1"],
                             other_activation_mb=off["activation"]["1"],
                             step_peak_layer_mb=peak[False],
                             step_peak_layer_remat_mb=peak[True],
                             seconds=mem_s, launches=mem_launches)
        torch.cuda.empty_cache()

        log("  (d) search at world 1")
        tag = "1nodes_1gpus_per_node"
        search = [QWEN_YAML, f"model.num_hidden_layers={QWEN_LAYERS}",
                  *PLAN_SEARCH, f"search.time_profiling_path={comp_path}",
                  f"search.memory_profiling_path={mem_path}",
                  "search.allreduce_bandwidth_config_path="
                  f"{hw}/allreduce_bandwidth_{tag}.json",
                  f"search.p2p_bandwidth_config_path={hw}/p2p_bandwidth_"
                  f"{tag}.json",
                  f"search.overlap_coe_path={hw}/overlap_coefficient.json",
                  f"search.sp_time_path={hw}/sp_time_{tag}.json",
                  *PLAN_EXTRA]
        plans = {}
        rc, path, plan, _ = plan_search("budget", search, PLAN_BUDGET_GB,
                                        tmp)
        if plan is None:
            raise SmokeFailure(f"no plan at {PLAN_BUDGET_GB} GB")
        plans["budget"] = (path, plan, PLAN_BUDGET_GB)
        # the tight budget: half the layers checkpointed at the 64 GB
        # plan's microbatch, by the search's own memory model
        micro = plan["global_bsz"] // plan["chunks"]
        k = QWEN_LAYERS // 2
        gb, need = tight_budget_gb(mem, k, cfg.hidden_size, micro)
        rc, path, plan, _ = plan_search("tight", search, gb, tmp)
        log(f"  the tight budget {gb} GB: the search's memory model needs "
            f"{need} MB for microbatches of {micro} with {k} of "
            f"{QWEN_LAYERS} layers checkpointed")
        if plan is None or set(plan["checkpoint"].split(",")) != {"0", "1"}:
            raise SmokeFailure(f"at {gb} GB the plan does not checkpoint "
                               f"some layers and not others: {plan}")
        plans["tight"] = (path, plan, gb)
        rc, path, plan, _ = plan_search(
            "uncut", [a.replace(f"model.num_hidden_layers={QWEN_LAYERS}",
                                "model.num_hidden_layers=28")
                      for a in search], PLAN_UNCUT_GB, tmp)
        if rc != 1 or path is not None:
            raise SmokeFailure(f"the uncut model found a plan at "
                               f"{PLAN_UNCUT_GB} GB (exit {rc})")
        out["search"] = dict(
            tight_model_mb=need,
            uncut=dict(layers=28, budget_gb=PLAN_UNCUT_GB, exit_code=rc),
            plans={k: dict(budget_gb=v[2], global_bsz=v[1]["global_bsz"],
                           chunks=v[1]["chunks"],
                           checkpoint=v[1]["checkpoint"],
                           predicted_time_cost_ms=v[1][
                               "predicted_time_cost_ms"])
                   for k, v in plans.items()})

        log("  (e) train each searched plan through cli/train_dist "
            "(parallel.config_mode=json)")
        prefix = write_qwen_corpus(tmp)[0]
        runs = {}
        for name, (path, plan, gb) in plans.items():
            res = plan_train(name, prefix, [
                "parallel.config_mode=json",
                f"parallel.galvatron_config_path={path}"], smi)
            runs[name] = plan_gates(name, res, plan, gb, cfg)

        log("  (f) a plan with equal remat flags against GLOBAL mode")
        same = [n for n, (_, plan, _) in plans.items()
                if len(set(plan["checkpoint"].split(","))) == 1]
        if not same:
            raise SmokeFailure("no searched plan has equal flags")
        name = same[0]
        plan = plans[name][1]
        flag = plan["checkpoint"].split(",")[0]
        ref = plan_train("global", prefix, [
            f"parallel.global_train_batch_size={plan['global_bsz']}",
            f"parallel.chunks={plan['chunks']}",
            f"parallel.global_checkpoint={flag}"], smi)
        if ref["losses"] != runs[name]["losses"]:
            raise SmokeFailure(f"GLOBAL losses {ref['losses']} != the "
                               f"{name} plan's {runs[name]['losses']}")
        if ref["digests"] != runs[name]["digests"]:
            raise SmokeFailure(f"GLOBAL parameters differ from the {name} "
                               "plan's")
        log(f"  the {name} plan (checkpoint {flag} everywhere) and GLOBAL "
            "mode: losses and every parameter's SHA-256 equal")
        out["same_as_global"] = dict(plan=name, losses=ref["losses"],
                                     global_step_ms=ref["step_ms"])

        doctor = doctor_static_checks(plans, runs, cfg, smi)
        gated = hbm_gate_path(search, plans, runs, doctor, prefix, cfg,
                              tmp, smi)
        runs["gated"] = gated.pop("run")
        doctor["cli"] = {
            "plan": check_cli("budget", plans["budget"][0], []),
            "memory": check_cli("budget", plans["budget"][0],
                                ["--memory", "--hbm-gb",
                                 f"{PLAN_UNCUT_GB:g}"])}
        out["doctor"] = doctor
        out["hbm_gate"] = gated
        for r in runs.values():
            r.pop("digests")
        out["train"] = runs
        per_step = {k: v // PLAN_STEPS
                    for k, v in runs["budget"]["launches"].items()}
        total = {k: comp_launches[k] + mem_launches[k] + ref["launches"][k]
                 + sum(r["launches"][k] for r in runs.values())
                 for k in comp_launches}
        out["launches"] = total
        out["launches_per_step"] = per_step
        out["eval_launches"] = dict.fromkeys(total, 0)
    out["wall_s"] = time.perf_counter() - t_all
    log(f"  phase 15 in {out['wall_s']:.1f} s [{smi}]")
    return out

def doctor_static_checks(plans, runs, cfg, smi):
    """(g): the doctor beside both searched plans' measured peaks, and the
    uncut 28 layers rejected by ``hbm_budget_reason`` at 80 GB."""
    from hetu_galvatron_tpu_torch.analysis.memory_doctor import (
        diagnose_memory,
        hbm_budget_reason,
    )
    from hetu_galvatron_tpu_torch.core.arguments import load_config

    log("  (g) the memory doctor (world 1, the compiled-engine convention) "
        "beside each trained plan's measured peak; reported, not gated")
    rows = {name: doctor_row(name, path, cfg, runs[name]["peak_gib"], smi)
            for name, (path, _, _) in plans.items()}
    uncut = load_config(QWEN_YAML, ["model.num_hidden_layers=28",
                                    *PLAN_EXTRA]).model
    rep = diagnose_memory(world1_plan(uncut.num_hidden_layers), uncut, 1,
                          hbm_gb=PLAN_UNCUT_GB)
    want = hbm_budget_reason(rep.peak_mb, PLAN_UNCUT_GB)
    if rep.ok or want is None or rep.errors[-1:] != [want]:
        raise SmokeFailure(f"the uncut model at {PLAN_UNCUT_GB} GB: doctor "
                           f"ok={rep.ok}, errors {rep.errors}")
    comp = rep.stages[0].components
    log(f"  (g) uncut {uncut.num_hidden_layers} layers, an all-off world-1 "
        f"plan at bsz 1: model states {comp['model_states_mb']:.1f} MB of "
        f"peak {rep.peak_mb:.1f} MB; rejected: {want}")
    return dict(plans=rows, uncut=dict(
        layers=uncut.num_hidden_layers, hbm_gb=PLAN_UNCUT_GB,
        components_mb=dict(comp), peak_mb=rep.peak_mb, reason=want))


def hbm_gate_path(search, plans, runs, doctor, prefix, cfg, tmp, smi):
    """(h): the search's static HBM gate at a budget 1 GB below the
    doctor's peak for the 64 GB plan. First at 64 GB: the gate must prune
    that plan (its log line); the gate runs after the DP on each task's
    time-optimal winner, as JAX's does, so it may leave no plan. Then at
    the tight budget of (d), where the DP's own memory model checkpoints
    layers: its winner must pass the gate. The gated winner (the first
    search's, else the second's) must differ from the 64 GB plan, its
    doctor peak must be within the budget, and it trains under (e)'s
    gates."""
    from hetu_galvatron_tpu_torch.analysis.memory_doctor import (
        diagnose_memory,
    )

    _, base, _ = plans["budget"]
    hbm_gb = round(doctor["plans"]["budget"]["doctor_peak_mb"] / 1024
                   - HBM_MARGIN_GB, 6)
    log(f"  (h) search.hbm_budget_gb={hbm_gb} (the 64 GB plan's doctor peak "
        f"less {HBM_MARGIN_GB:g} GB)")
    out = dict(hbm_budget_gb=hbm_gb, searches={})
    mark = f"(bsz {base['global_bsz']} chunks {base['chunks']} pp 1)"
    winner = None
    for tag, gb in (("gated-64", PLAN_BUDGET_GB),
                    ("gated-tight", plans["tight"][2])):
        rc, path, plan, pruned = plan_search(tag, search, gb, tmp,
                                             hbm_gb=hbm_gb)
        rec = dict(memory_constraint_gb=gb, exit_code=rc,
                   pruned_candidates=len(pruned),
                   pruned_the_64gb_plan=any(mark in x for x in pruned),
                   first_pruned=pruned[0] if pruned else None)
        if plan is not None:
            peak = diagnose_memory(path, cfg, 1).peak_mb
            rec.update(global_bsz=plan["global_bsz"], chunks=plan["chunks"],
                       checkpoint=plan["checkpoint"], doctor_peak_mb=peak,
                       predicted_time_cost_ms=plan["predicted_time_cost_ms"])
            if peak > hbm_gb * 1024:
                raise SmokeFailure(f"{tag}: the gated winner's doctor peak "
                                   f"{peak:.1f} MB busts {hbm_gb} GB")
            if winner is None:
                winner = (tag, path, plan, gb)
        out["searches"][tag] = rec
    if not out["searches"]["gated-64"]["pruned_the_64gb_plan"]:
        raise SmokeFailure(f"the gate at {hbm_gb} GB did not prune the "
                           f"{PLAN_BUDGET_GB} GB plan {mark}")
    if winner is None:
        raise SmokeFailure(f"no plan passed the HBM gate at {hbm_gb} GB")
    tag, path, plan, gb = winner
    if (plan["global_bsz"], plan["chunks"], plan["checkpoint"]) == (
            base["global_bsz"], base["chunks"], base["checkpoint"]):
        raise SmokeFailure(f"the gated winner ({tag}) is the 64 GB plan")
    log(f"  (h) the gated winner ({tag}): bsz {plan['global_bsz']}, chunks "
        f"{plan['chunks']}, checkpoint [{plan['checkpoint']}]; training it")
    res = plan_train("gated", prefix, ["parallel.config_mode=json",
                                       f"parallel.galvatron_config_path="
                                       f"{path}"], smi)
    res = plan_gates("gated", res, plan, gb, cfg)
    res["peak_over_hbm_budget"] = res["peak_gib"] / hbm_gb
    key = ("global_bsz", "chunks", "checkpoint")
    same = [n for n, (_, p, _) in plans.items()
            if all(p[k] == plan[k] for k in key)]
    if same:
        # the same plan trained again: the same losses, bit for bit
        if res["losses"] != runs[same[0]]["losses"]:
            raise SmokeFailure(f"the gated plan equals the {same[0]} plan "
                               f"but its losses {res['losses']} differ from "
                               f"{runs[same[0]]['losses']}")
        log(f"  (h) the gated plan is the {same[0]} plan of (d): losses "
            "bit-identical to its run in (e)")
    res["same_as"] = same[0] if same else None
    log(f"  (h) gated plan: measured peak / hbm_budget_gb "
        f"{res['peak_over_hbm_budget']:.4f} ({res['peak_gib']:.2f} GiB / "
        f"{hbm_gb} GB) [{smi}]")
    out.update(winner=tag, run=res)
    return out


# -- phase 16: the pipeline engine, one rank a stage on one card -------------

PIPE_PHASE = ("phase 16: main path of slice 12 (the pipeline engine through "
              "train_dist, one rank a stage on one card: GPT-2 small pp4 "
              "GPipe with a resume drill, Qwen2.5-7B widths pp2 1F1B and "
              "pp2 x vpp2, T5-3B pp2 GPipe)")
PIPE_GPT2 = "gpt2-small-pp4-gpipe"
PIPE_QWEN = f"qwen2.5-7b-{QWEN_LAYERS}-layers-pp2-1f1b"
PIPE_QWEN_VPP = f"qwen2.5-7b-{QWEN_LAYERS}-layers-pp2-vpp2-1f1b"
PIPE_T5 = "t5-3b-pp2-gpipe"
PIPE_GPT2_STEPS, PIPE_SAVE_AT = 6, 3
PIPE_QWEN_STEPS, PIPE_QWEN_BSZ = 4, 4
PIPE_T5_STEPS = 3
PIPE_CHUNKS = 4
PIPE_LOSS_RTOL = 1e-4  # step-0 loss against the pp=1 run of the same batch
# steps 1-3's losses and step 0's grad norm against the pp=1 run's: GPT-2
# equals it bit for bit; the Qwen runs read at most 2.5e-5 and 1.3e-5 on
# an H100 (bf16 cotangents scaled by token-count microbatch weights
# before the backward at pp=1, fp32 gradients after it in the pipeline)
PIPE_LATER_RTOL = 1e-4
PIPE_NORM_RTOL = 1e-4
TIED_RTOL = 1e-6  # wte against whead.T (JAX's test_pipeline_tied_embeddings)
# overrides every phase-16 run takes on top of its own: a CPU dry run at
# tiny widths monkeypatches them (with torch.cuda's calls)
PIPE_EXTRA = []


def pipe_launches(hpc, cfg, microbatches: int):
    """K1-K5 a step of the pipeline engine: per microbatch, K1 ``2 L -
    L_head + C`` (every non-head chunk runs its layers without a graph and
    again in the backward's recompute, the head chunk once fused with its
    backward, a checkpointed layer once more) and K2, K3 ``L``, where a t5
    decoder layer counts twice (self- and cross-attention); the head runs
    the plain cross-entropy, so no K4/K5."""
    n_enc, dec = hpc.num_encoder_layers, 2 if cfg.model_type == "t5" else 1
    attn = [1 if i < n_enc else dec for i in range(len(hpc.layers))]
    head = attn[len(attn) - hpc.pp_division[-1]:]
    ckpt = sum(a for a, s in zip(attn, hpc.layers) if s.checkpoint)
    k1 = 2 * sum(attn) - sum(head) + ckpt
    return {"flash_fwd": k1 * microbatches,
            "flash_bwd_dkdv": sum(attn) * microbatches,
            "flash_bwd_dq": sum(attn) * microbatches,
            "ce_fwd": 0, "ce_bwd": 0}


def span_host_ms():
    """The host milliseconds the pipeline's stage spans have taken so far
    (``pp/fwd_s*`` and ``pp/bwd_s*``, the registry's ``span_ms``)."""
    from hetu_galvatron_tpu_torch.observability.registry import get_registry

    return sum(m.total for m in get_registry().metrics()
               if m.name == "span_ms" and any(
                   s in m.labels.get("path", "")
                   for s in ("pp/fwd_s", "pp/bwd_s")))


def pipe_train(tag, yaml, over):
    """One ``train`` run of phase 16 with the launch counters reset just
    before it and read just after: its losses, launches, peak memory, step
    ms (CUDA events after the warm-up), the stage spans' host ms a
    microbatch over the timed steps, the parameters' digests and the
    final state."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.ops import _build
    from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
        get_hybrid_parallel_config,
    )

    args = load_config(yaml, ["parallel.mixed_precision=bf16",
                              "profile.profile=1",
                              f"profile.profile_warmup={PROFILE_WARMUP}",
                              *over, *PIPE_EXTRA])
    hpc = get_hybrid_parallel_config(args, max(args.parallel.num_devices, 1))
    host, norms = {}, []

    def on_step(it, metrics):
        norms.append(metrics["grad_norm"])  # read after the run
        if it == PROFILE_WARMUP - 1:
            host["from"] = span_host_ms()

    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(args, on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = len(out["losses"])
    res = dict(
        losses=out["losses"], launches=dict(_build.launch_counts),
        grad_norms=[float(g) for g in norms],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        step_ms=out["iter_ms"], wall_s=wall, plan=hpc.describe(),
        start_iter=out["start_iter"], params=out["params"],
        digests=param_digests(out["params"]), hpc=hpc, cfg=args.model)
    if hpc.pp_deg > 1 and "from" in host:
        res["host_ms_per_microbatch"] = (
            (span_host_ms() - host["from"])
            / ((steps - PROFILE_WARMUP) * hpc.chunks))
    del out
    log(f"  {tag}: losses {res['losses']}; step {res['step_ms']} ms "
        f"(CUDA events, steps {PROFILE_WARMUP}..{steps - 1}); peak "
        f"{res['peak_gib']:.2f} GiB; launches {res['launches']}; "
        f"{wall:.1f} s")
    return res


def against_pp1(tag, what, got, want, tol):
    """One reading of a pipeline run against its pp=1 run, gated at the
    relative ``tol``; returns the relative difference."""
    rel = abs(got - want) / abs(want)
    log(f"  {tag}: {what} {got!r} against pp=1 {want!r}: relative "
        f"{rel:.3e} (gate {tol})")
    if rel > tol:
        raise SmokeFailure(f"{tag}: {what} {got} departs from the pp=1 "
                           f"run's {want} by {rel:.3e}")
    return rel


def pipe_gates(tag, res, *, steps, want_per_step, ref=None, expect0=None):
    """Phase 16's gates on one pipeline run: finite losses and grad norms;
    against the pp=1 run ``ref`` of the same weights and batches, the
    step-0 loss, the step-0 grad norm (the backward, the microbatch
    weights, the tied sum, the norm less one tied copy) and the losses of
    the later steps both ran (the update and the clip); else the step-0
    loss against the phase's expected value; exact launches, peak
    memory. Returns the relative differences from ``ref``."""
    losses, norms = res["losses"], res["grad_norms"]
    if len(losses) != steps or not all(map(math.isfinite, losses + norms)):
        raise SmokeFailure(f"{tag}: losses {losses}, grad norms {norms} not "
                           f"{steps} finite")
    rel = {}
    if ref is not None:
        rel["loss0"] = against_pp1(tag, "step-0 loss", losses[0],
                                   ref["losses"][0], PIPE_LOSS_RTOL)
        rel["grad_norm0"] = against_pp1(tag, "step-0 grad norm", norms[0],
                                        ref["grad_norms"][0], PIPE_NORM_RTOL)
        both = min(len(ref["losses"]), steps)
        rel["later_losses"] = [
            against_pp1(tag, f"step-{i} loss", losses[i], ref["losses"][i],
                        PIPE_LATER_RTOL) for i in range(1, both)]
        rel["later_grad_norms"] = [  # printed, not gated
            abs(norms[i] - ref["grad_norms"][i]) / abs(ref["grad_norms"][i])
            for i in range(1, both)]
        log(f"  {tag}: steps 1-{both - 1} grad norms against pp=1: relative "
            + ", ".join(f"{r:.3e}" for r in rel["later_grad_norms"])
            + " (printed)")
    if expect0 is not None:
        log(f"  {tag}: step-0 loss {losses[0]:.4f} against ln V + "
            f"sigma^2/2 = {expect0:.4f} (gate 0.5)")
        if abs(losses[0] - expect0) > 0.5:
            raise SmokeFailure(f"{tag}: step-0 loss {losses[0]:.4f} is not "
                               f"within 0.5 of {expect0:.4f}")
    want = {k: v * steps for k, v in want_per_step.items()}
    if res["launches"] != want:
        raise SmokeFailure(f"{tag}: launches {res['launches']}, want {want}")
    if res["peak_gib"] >= MEM_LIMIT_GIB:
        raise SmokeFailure(f"{tag}: peak {res['peak_gib']:.2f} GiB is not "
                           f"under {MEM_LIMIT_GIB} GiB")
    return rel


def pipe_summary(res, steps, want_per_step, **extra):
    """A run's record for the pipeline JSON line and the kernels line."""
    return dict(
        plan=res["plan"], losses=res["losses"],
        grad_norms=res["grad_norms"], step_ms=res["step_ms"],
        peak_gib=res["peak_gib"], wall_s=res["wall_s"],
        host_ms_per_microbatch=res.get("host_ms_per_microbatch"),
        launches=res["launches"], launches_per_step=want_per_step,
        eval_launches={k: 0 for k in want_per_step}, steps=steps, **extra)


def pipe_plan_file(tmp, name, division, vpp=1):
    """A searched-style JSON plan of the Qwen cell: pp 2, ``division``,
    1F1B, no per-layer checkpoint, batch 4 in 4 microbatches."""
    n = QWEN_LAYERS
    plan = {"pp_deg": 2, "tp_sizes_enc": ",".join(["1"] * n),
            "tp_consecutive_flags": ",".join(["1"] * n),
            "dp_types_enc": ",".join(["0"] * n),
            "use_sp": ",".join(["0"] * n),
            "cp_sizes_enc": ",".join(["1"] * n),
            "checkpoint": ",".join(["0"] * n),
            "global_bsz": PIPE_QWEN_BSZ, "chunks": PIPE_CHUNKS,
            "pp_division": ",".join(map(str, division)),
            "pipeline_type": "pipedream_flush", "default_dp_type": "ddp",
            "vtp": 1, "vsp": 0, "embed_sdp": 0}
    if vpp > 1:
        plan["vpp_deg"] = vpp
    path = os.path.join(tmp, name)
    with open(path, "w") as f:
        json.dump(plan, f, indent=4)
    return path


def pipe_gpt2(smi, tmp):
    """(a) GPT-2 small uncut, pp 4 GPipe, 4 microbatches of 2 at seq 1024:
    against a pp=1 run of the same weights and batch, the tied copies,
    exact launches, and the resume drill."""
    common = ["parallel.global_train_batch_size=8",
              f"parallel.chunks={PIPE_CHUNKS}",
              f"train.lr_decay_iters={PIPE_GPT2_STEPS}"]
    pp4 = common + ["parallel.pp_deg=4", "parallel.num_devices=4",
                    "parallel.pipeline_type=gpipe"]
    ref = pipe_train("(a) pp=1, chunks 4", GPT2_YAML,
                     common + ["train.train_iters=4"])
    del ref["params"]
    run = pipe_train("(a) pp=4 GPipe", GPT2_YAML,
                     pp4 + [f"train.train_iters={PIPE_GPT2_STEPS}"])
    want = pipe_launches(run["hpc"], run["cfg"], PIPE_CHUNKS)
    rel = pipe_gates("(a)", run, steps=PIPE_GPT2_STEPS, want_per_step=want,
                     ref=ref, expect0=math.log(run["cfg"].padded_vocab_size))
    wte = run["params"][0]["embed"]["wte"].detach()
    whead = run["params"][-1]["head"]["whead"].detach()
    tied = float((wte - whead.t()).abs().max() / wte.abs().max())
    bits = bool((wte == whead.t()).all())
    log(f"  (a) after step {PIPE_GPT2_STEPS}: max |wte - whead.T| / max "
        f"|wte| = {tied:.3e} (gate {TIED_RTOL}); bit-equal: {bits}")
    if tied > TIED_RTOL:
        raise SmokeFailure(f"(a) the tied copies departed: {tied:.3e}")
    del run["params"], wte, whead
    ck = os.path.join(tmp, "pipe_ckpt")
    first = pipe_train("(a) drill, to the save", GPT2_YAML, pp4 + [
        f"train.train_iters={PIPE_SAVE_AT}", f"ckpt.save={ck}",
        f"ckpt.save_interval={PIPE_SAVE_AT}"])
    rest = pipe_train("(a) drill, resumed", GPT2_YAML, pp4 + [
        f"train.train_iters={PIPE_GPT2_STEPS}", f"ckpt.load={ck}"])
    del first["params"], rest["params"]
    stitched = first["losses"] + rest["losses"]
    same = (rest["start_iter"] == PIPE_SAVE_AT
            and stitched == run["losses"]
            and rest["digests"] == run["digests"])
    log(f"  (a) resume drill: saved at step {PIPE_SAVE_AT}, resumed at "
        f"{rest['start_iter']}; stitched losses equal: "
        f"{stitched == run['losses']}; {len(run['digests'])} stage "
        f"parameters' SHA-256 equal: {rest['digests'] == run['digests']} "
        f"[{smi}]")
    if not same:
        raise SmokeFailure(f"(a) the resumed run departs: {stitched} against "
                           f"{run['losses']}")
    log(f"  (a) step {run['step_ms']:.2f} ms against pp=1 "
        f"{ref['step_ms']:.2f} ms ({run['step_ms'] / ref['step_ms']:.3f}x); "
        f"peak {run['peak_gib']:.2f} GiB against pp=1 {ref['peak_gib']:.2f}; "
        f"host {run['host_ms_per_microbatch']:.3f} ms a microbatch in the "
        f"stage spans [{smi}]")
    return pipe_summary(run, PIPE_GPT2_STEPS, want, pp1_losses=ref["losses"],
                        pp1_grad_norms=ref["grad_norms"],
                        against_pp1=rel, pp1_step_ms=ref["step_ms"],
                        pp1_peak_gib=ref["peak_gib"], tied_rel=tied,
                        tied_bit_equal=bits, resume_bit_identical=same)


def pipe_qwen(smi, tmp, prefix):
    """(b) Qwen2.5-7B widths at 4 layers, seq 4096, batch 4 in 4
    microbatches, phase 6's packed corpus, plain CE: pp 2 1F1B and pp 2 x
    vpp 2 from JSON plans against a pp=1 run with the same chunks."""
    from hetu_galvatron_tpu_torch.analysis.memory_doctor import (
        diagnose_memory,
    )
    from hetu_galvatron_tpu_torch.data.synthetic import packed_corpus_overrides

    common = [f"model.num_hidden_layers={QWEN_LAYERS}",
              "model.use_fused_ce=false",
              f"train.train_iters={PIPE_QWEN_STEPS}",
              *packed_corpus_overrides(prefix)]
    ref = pipe_train("(b) pp=1, chunks 4, plain CE", QWEN_YAML, common + [
        f"parallel.global_train_batch_size={PIPE_QWEN_BSZ}",
        f"parallel.chunks={PIPE_CHUNKS}"])
    del ref["params"]
    out = {"pp1": dict(step_ms=ref["step_ms"], peak_gib=ref["peak_gib"],
                       losses=ref["losses"], grad_norms=ref["grad_norms"],
                       launches=ref["launches"])}
    for key, name, division, vpp in (
            (PIPE_QWEN, "pp2.json", [2, 2], 1),
            (PIPE_QWEN_VPP, "pp2_vpp2.json", [1, 1, 1, 1], 2)):
        plan = pipe_plan_file(tmp, name, division, vpp)
        run = pipe_train(f"(b) {key}", QWEN_YAML, common + [
            "parallel.num_devices=2", "parallel.config_mode=json",
            f"parallel.galvatron_config_path={plan}"])
        del run["params"]
        want = pipe_launches(run["hpc"], run["cfg"], PIPE_CHUNKS)
        rel = pipe_gates(f"(b) {key}", run, steps=PIPE_QWEN_STEPS,
                         want_per_step=want, ref=ref)
        rep = diagnose_memory(plan, run["cfg"], 2, schedule_impl="host")
        if not rep.ok:
            raise SmokeFailure(f"memory doctor on {name}: {rep.errors}")
        doctor_mb = sum(st.total_mb for st in rep.stages)
        log(f"  (b) {key}: step {run['step_ms']:.2f} ms against pp=1 "
            f"{ref['step_ms']:.2f} ms ({run['step_ms'] / ref['step_ms']:.3f}"
            f"x); peak {run['peak_gib']:.2f} GiB against pp=1 "
            f"{ref['peak_gib']:.2f}; the memory doctor's stage peaks summed "
            f"{doctor_mb / 1024:.2f} GiB (reported); host "
            f"{run['host_ms_per_microbatch']:.3f} ms a microbatch in the "
            f"stage spans [{smi}]")
        out[key] = pipe_summary(run, PIPE_QWEN_STEPS, want, against_pp1=rel,
                                doctor_stage_sum_gib=doctor_mb / 1024,
                                step_over_pp1=run["step_ms"] / ref["step_ms"])
    return out


def pipe_t5(smi):
    """(c) T5-3B uncut (24 + 24 layers, tied), pp 2 [24, 24] GPipe, batch
    16 in 2 microbatches at seq 512 split 256 + 256, no per-layer
    checkpoint: phase 11's loss gate, exact launches, peak memory."""
    run = pipe_train("(c) T5-3B pp2 GPipe", T5_YAML, [
        f"parallel.global_train_batch_size={T5B}", "parallel.pp_deg=2",
        "parallel.num_devices=2", "parallel.pipeline_type=gpipe",
        "parallel.chunks=2", "parallel.global_checkpoint=0",
        f"train.train_iters={PIPE_T5_STEPS}"])
    del run["params"]
    want = pipe_launches(run["hpc"], run["cfg"], 2)
    pipe_gates("(c)", run, steps=PIPE_T5_STEPS, want_per_step=want,
               expect0=zoo_expected_loss(run["cfg"]))
    log(f"  (c) step {run['step_ms']:.2f} ms, peak {run['peak_gib']:.2f} "
        f"GiB, host {run.get('host_ms_per_microbatch', float('nan')):.3f} "
        f"ms a microbatch in the stage spans [{smi}]")
    return pipe_summary(run, PIPE_T5_STEPS, want)


def check_pipe_kernels(checks, peak_flops, peak_bytes):
    """K1-K3 at phase 16's microbatch shapes, against their plain versions
    and timed beside the library: GPT-2's (batch 8 in 4: B=2), the Qwen
    cell's (batch 4 in 4: B=1, packed, three documents a row as phase
    3's) and T5's (batch 16 in 2: B=8; the encoder's non-causal
    self-attention, the decoder's causal self-attention and the
    cross-attention); the records join ``checks``."""
    import torch

    gb, qb, tb = 8 // PIPE_CHUNKS, PIPE_QWEN_BSZ // PIPE_CHUNKS, T5B // 2
    flash = {
        PIPE_GPT2: check_path_flash(
            "pipeline GPT-2 shape", f"pipe gpt2 B={gb} N=K={N} S={S} D={D} "
            "bf16 causal", (gb, N, N, S, D), False, peak_flops, peak_bytes),
        PIPE_QWEN: check_path_flash(
            "pipeline Qwen shape", f"pipe qwen B={qb} N={QN} K={QK} S={QS} "
            f"D={QD} bf16 seg", (qb, QN, QK, QS, QD), True, peak_flops,
            peak_bytes),
        "t5_enc": check_path_flash(
            "pipeline T5 encoder shape", f"pipe t5 enc B={tb} N=K={T5N} "
            f"S={T5S} D={T5D} bf16 noncausal", (tb, T5N, T5N, T5S, T5D),
            False, peak_flops, peak_bytes, causal=False),
        "t5_dec": check_path_flash(
            "pipeline T5 decoder shape", f"pipe t5 dec B={tb} N=K={T5N} "
            f"S={T5S} D={T5D} bf16 causal", (tb, T5N, T5N, T5S, T5D), False,
            peak_flops, peak_bytes, causal=True),
        "t5_cross": check_path_flash(
            "pipeline T5 cross shape", f"pipe t5 cross B={tb} N=K={T5N} "
            f"S=Sk={T5S} D={T5D} bf16 noncausal", (tb, T5N, T5N, T5S, T5D),
            False, peak_flops, peak_bytes, causal=False, layout="cross",
            sk=T5S),
    }
    for res in flash.values():
        for k, recs in res["checks"].items():
            checks[k] += recs
    rep = flash[PIPE_QWEN]["report"]["flash_bwd_dkdv"]
    if "mma_share_of_bound" in rep:
        log(f"  pipeline Qwen shape: K2 at one row and {QK} kv heads "
            f"{100 * rep['share_of_bound']:.1f}% of the bound against the "
            f"mma.sync kernel's {100 * rep['mma_share_of_bound']:.1f}% in "
            "this call")
    torch.cuda.empty_cache()
    return flash


def pipe_paths(smi: str, checks, peak_flops, peak_bytes):
    """Phase 16: K1-K3 at its microbatch shapes, then (a)-(c) in a
    temporary directory removed at exit; returns the runs' record and the
    kernels' checks and times."""
    import torch

    t0 = time.perf_counter()
    flash = check_pipe_kernels(checks, peak_flops, peak_bytes)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_pipe_") as tmp:
        out = {PIPE_GPT2: pipe_gpt2(smi, tmp)}
        torch.cuda.empty_cache()
        prefix = write_qwen_corpus(tmp)[0]
        out.update(pipe_qwen(smi, tmp, prefix))
        torch.cuda.empty_cache()
        out[PIPE_T5] = pipe_t5(smi)
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    out["device"] = smi
    log(f"  phase 16 in {out['wall_s']:.1f} s [{smi}]")
    return out, flash


def pipe_blocks(checks, pipe, flash):
    """Phase 16's K1-K3 blocks: each pipeline run's launches beside the
    checks and times at its microbatch shape (``flash``, from
    :func:`check_pipe_kernels`): both Qwen runs at the Qwen cell's, T5 at
    its decoder's causal self-attention with all three of its shapes
    under ``by_shape``."""
    def block(k, run, key):
        timing = flash[key]["timing"][k]
        out = path_block(k, run, timing, max_err(
            checks, k, timing["shape"], ("elementwise",)), timing["shape"])
        out.update(flash[key]["report"][k])
        if k in BWD:
            rep = flash[key]["report"]
            out.update(pair_ms=rep["pair_ms"],
                       pair_beats_library=rep["pair_beats_library"])
        return out

    out = {}
    for k in FLASH:
        out[k] = {PIPE_GPT2: block(k, pipe[PIPE_GPT2], PIPE_GPT2),
                  PIPE_QWEN: block(k, pipe[PIPE_QWEN], PIPE_QWEN),
                  PIPE_QWEN_VPP: block(k, pipe[PIPE_QWEN_VPP], PIPE_QWEN),
                  PIPE_T5: block(k, pipe[PIPE_T5], "t5_dec")}
        out[k][PIPE_T5]["by_shape"] = {
            key: block(k, pipe[PIPE_T5], key)
            for key in ("t5_enc", "t5_dec", "t5_cross")}
    return out


# -- phase 17: the compiled single-program 1F1B pipeline, one CUDA graph -----

COMP_PHASE = ("phase 17: main path of slice 13 (the compiled 1F1B pipeline "
              "through train_dist, one CUDA graph a microbatch count: GPT-2 "
              "small pp4, Qwen2.5-7B widths pp2, the reshard drill)")
COMP_GPT2 = "gpt2-small-pp4-compiled-1f1b"
COMP_QWEN = f"qwen2.5-7b-{QWEN_LAYERS}-layers-pp2-compiled-1f1b"
COMP_STEPS, COMP_SAVE_AT = 4, 2  # steps held to the references; the save
COMP_GPT2_STEPS = 6  # (a)'s compiled run: 2 traced replays, 2 timed after
COMP_TRACE_FROM, COMP_TRACE_ITERS = 2, 2  # the traced replays
# the compiled step against the host engine's and the pp=1 run's: step-0
# loss and grad norm, the losses of steps 1-3, and the tied wte
COMP_RTOL = 1e-4


def comp_launches(hpc, microbatches: int):
    """K1-K5 a step of the compiled engine: T = m + 2 (pp - 1) ticks, each
    one forward unit and one backward unit over every lane (lanes folded
    into the kernels' batch), so K1 T (2 + C) lps, K2 = K3 = T lps with C
    = 1 for a checkpointed layer; the head's CE is plain: no K4/K5."""
    ticks = microbatches + 2 * (hpc.pp_deg - 1)
    lps, ckpt = hpc.pp_division[0], int(hpc.layers[0].checkpoint)
    return {"flash_fwd": ticks * (2 + ckpt) * lps,
            "flash_bwd_dkdv": ticks * lps, "flash_bwd_dq": ticks * lps,
            "ce_fwd": 0, "ce_bwd": 0}


def span_totals(paths):
    """Host ms so far in the live registry's ``span_ms`` histograms, by
    path (the run's telemetry registry while ``train`` runs with
    observability on)."""
    from hetu_galvatron_tpu_torch.observability.registry import get_registry

    out = {p: 0.0 for p in paths}
    for m in get_registry().metrics():
        if m.name == "span_ms" and m.labels.get("path") in paths:
            out[m.labels["path"]] = m.total
    return out


def comp_train(tag, yaml, over, tmp=None, trace=False):
    """One ``train`` run of phase 17 with the launch counters reset just
    before it and read just after. With ``tmp`` the run streams its
    metrics there and returns the stream's ``cost/flops``; with ``trace``
    also it traces its replays of steps ``COMP_TRACE_FROM`` .. +
    ``COMP_TRACE_ITERS`` - 1 and returns the counters' delta over those
    steps and the trace's attribution. Host
    ms a step outside the replay: the ``train/step`` span less its
    ``pp/compiled_step`` one, over the untraced steps after the first."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.observability.registry import (
        MetricsRegistry,
        get_registry,
        set_registry,
    )
    from hetu_galvatron_tpu_torch.ops import _build
    from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
        get_hybrid_parallel_config,
    )

    extra = []
    if tmp is not None:
        name = tag.split()[0].strip("()")
        trace_dir = os.path.join(tmp, "trace_" + name)
        stream = os.path.join(tmp, f"metrics_{name}.jsonl")
        extra = ["observability.enabled=true",
                 f"observability.metrics_path={stream}"]
        if trace:
            extra += ["observability.audit=false",
                      f"profile.trace_dir={trace_dir}",
                      f"profile.profile_warmup={COMP_TRACE_FROM}",
                      f"profile.trace_iters={COMP_TRACE_ITERS}"]
    args = load_config(yaml, ["parallel.mixed_precision=bf16",
                              "profile.profile=1",
                              f"profile.profile_warmup={PROFILE_WARMUP}",
                              *over, *extra, *PIPE_EXTRA])
    hpc = get_hybrid_parallel_config(args, max(args.parallel.num_devices, 1))
    norms, snap = [], {}
    paths = ("train/step", "train/step/pp/compiled_step")

    def on_step(it, metrics):
        norms.append(metrics["grad_norm"])  # read after the run
        if it in (COMP_TRACE_FROM - 1, COMP_TRACE_FROM + COMP_TRACE_ITERS - 1):
            snap[it] = dict(_build.launch_counts)
        snap[("spans", it)] = span_totals(paths)

    prev = set_registry(MetricsRegistry())  # this run's spans alone
    gc.collect()
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        out = train(args, on_step=on_step)
        torch.cuda.synchronize()
    finally:
        set_registry(prev)
    wall = time.perf_counter() - t0
    steps = len(out["losses"])
    res = dict(
        losses=out["losses"], launches=dict(_build.launch_counts),
        grad_norms=[float(g) for g in norms],
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        step_ms=out["iter_ms"], wall_s=wall, plan=hpc.describe(),
        params=out["params"], digests=param_digests(out["params"]),
        pipeline=out["pipeline"], hpc=hpc, cfg=args.model)
    ran = sorted(k[1] for k in snap if isinstance(k, tuple))
    start = COMP_TRACE_FROM + COMP_TRACE_ITERS - 1 if trace else ran[0]
    if (out["pipeline"] or {}).get("schedule") == "compiled" \
            and ran[-1] > start:
        first, last = snap[("spans", start)], snap[("spans", ran[-1])]
        step_ms, replay_ms = ((last[p] - first[p]) / (ran[-1] - start)
                              for p in paths)
        res["host_ms_outside_replay"] = step_ms - replay_ms
        res["replay_call_ms"] = replay_ms
    if trace:
        from hetu_galvatron_tpu_torch.observability.trace_analysis import (
            attribute,
            load_trace,
        )

        res["traced_launches"] = {
            k: snap[COMP_TRACE_FROM + COMP_TRACE_ITERS - 1][k]
            - snap[COMP_TRACE_FROM - 1][k] for k in KERNELS}
        att = attribute(load_trace(trace_dir))
        res["trace"] = dict(steps=att.steps,
                            category_launches=dict(att.category_launches),
                            wall_ms=att.wall_ms,
                            idle_share=att.bubble_frac)
    if tmp is not None:
        recs = stream_records(stream)
        res["cost_flops"] = {
            r["labels"]["program"]: r["value"] for r in recs
            if r.get("name") == "cost/flops"}
        res["stream_names"] = sorted({r.get("name") for r in recs
                                      if r.get("name")})
    del out
    log(f"  {tag}: losses {res['losses']}; step {res['step_ms']} ms "
        f"(CUDA events, steps {PROFILE_WARMUP}..{steps - 1}); peak "
        f"{res['peak_gib']:.2f} GiB; launches {res['launches']}; "
        f"{wall:.1f} s")
    return res


def comp_gates(tag, run, refs, *, want_per_step):
    """Phase 17's gates on a compiled run: finite losses and norms; against
    each reference run (the host engine's, pp=1's) the step-0 loss and
    grad norm and the losses of steps 1-3 within ``COMP_RTOL`` relative;
    one capture; exact launches; peak memory. Returns the relative
    differences by reference."""
    losses, norms = run["losses"], run["grad_norms"]
    steps = len(losses)
    if steps < COMP_STEPS or not all(map(math.isfinite, losses + norms)):
        raise SmokeFailure(f"{tag}: losses {losses}, grad norms {norms} not "
                           f"{COMP_STEPS} or more finite")
    rel = {}
    for name, ref in refs.items():
        def against(what, got, want):
            r = abs(got - want) / abs(want)
            log(f"  {tag}: {what} {got!r} against the {name} run's "
                f"{want!r}: relative {r:.3e} (gate {COMP_RTOL})")
            if r > COMP_RTOL:
                raise SmokeFailure(f"{tag}: {what} {got} departs from the "
                                   f"{name} run's {want} by {r:.3e}")
            return r

        rel[name] = dict(
            loss0=against("step-0 loss", losses[0], ref["losses"][0]),
            grad_norm0=against("step-0 grad norm", norms[0],
                               ref["grad_norms"][0]),
            later_losses=[against(f"step-{i} loss", losses[i],
                                  ref["losses"][i])
                          for i in range(1, COMP_STEPS)],
            later_grad_norms=[  # printed, not gated
                abs(norms[i] - ref["grad_norms"][i]) / ref["grad_norms"][i]
                for i in range(1, COMP_STEPS)])
    captures = run["pipeline"]["compile_count"]
    log(f"  {tag}: {captures} capture(s) over {steps} steps; "
        f"bubble_frac {run['pipeline']['bubble_frac']:.4f}")
    if run["pipeline"]["schedule"] != "compiled" or captures != 1:
        raise SmokeFailure(f"{tag}: {run['pipeline']}, want one capture of "
                           "the compiled schedule")
    want = {k: v * steps for k, v in want_per_step.items()}
    if run["launches"] != want:
        raise SmokeFailure(f"{tag}: launches {run['launches']}, want {want}")
    if run["peak_gib"] >= MEM_LIMIT_GIB:
        raise SmokeFailure(f"{tag}: peak {run['peak_gib']:.2f} GiB is not "
                           f"under {MEM_LIMIT_GIB} GiB")
    return rel


def comp_trace_gate(tag, run):
    """The traced replays' K1-K5 by kernel name against the launch
    counters over the same steps (the census each replay adds)."""
    found = {k: run["trace"]["category_launches"].get(k, 0) for k in KERNELS}
    log(f"  {tag}: trace of steps {COMP_TRACE_FROM}-"
        f"{COMP_TRACE_FROM + COMP_TRACE_ITERS - 1}: {run['trace']['steps']} "
        f"steps, kernels by name {found} against the counters "
        f"{run['traced_launches']}; device idle "
        f"{100 * run['trace']['idle_share']:.2f}% of the traced wall")
    if found != run["traced_launches"] or any(
            run["traced_launches"][k] == 0 for k in FLASH):
        raise SmokeFailure(f"{tag}: the trace's kernels {found} differ from "
                           f"the counters {run['traced_launches']}")


def comp_doctor(plan, cfg, world):
    """The memory doctor's stage peaks summed (GiB) for the compiled
    schedule of ``plan`` (a path or a dict)."""
    from hetu_galvatron_tpu_torch.analysis.memory_doctor import (
        diagnose_memory,
    )

    rep = diagnose_memory(plan, cfg, world, schedule_impl="compiled")
    if not rep.ok:
        raise SmokeFailure(f"memory doctor: {rep.errors}")
    return sum(st.total_mb for st in rep.stages) / 1024


def comp_print(tag, run, refs, doctor_gib, smi):
    host = refs.get("host engine")
    cost = run.get("cost_flops") or {}
    log(f"  {tag}: step {run['step_ms']:.2f} ms against the host engine's "
        f"{host['step_ms']:.2f} ms ({run['step_ms'] / host['step_ms']:.3f}x)"
        f" and pp=1's {refs['pp=1']['step_ms']:.2f} ms; host "
        f"{run['host_ms_outside_replay']:.3f} ms a step outside the replay "
        f"(the replay call {run['replay_call_ms']:.3f} ms); peak "
        f"{run['peak_gib']:.2f} GiB against the memory doctor's compiled "
        f"stage peaks summed {doctor_gib:.2f} GiB (host engine "
        f"{host['peak_gib']:.2f}, pp=1 {refs['pp=1']['peak_gib']:.2f}); "
        f"cost/flops {cost or 'not recorded (no metrics sink)'} [{smi}]")


def comp_record(run, refs, rel, want, doctor_gib, **extra):
    out = dict(
        plan=run["plan"], losses=run["losses"], grad_norms=run["grad_norms"],
        step_ms=run["step_ms"], peak_gib=run["peak_gib"],
        wall_s=run["wall_s"], launches=run["launches"],
        launches_per_step=want, eval_launches={k: 0 for k in want},
        steps=len(run["losses"]), pipeline=run["pipeline"],
        host_ms_outside_replay=run.get("host_ms_outside_replay"),
        replay_call_ms=run.get("replay_call_ms"),
        doctor_stage_sum_gib=doctor_gib, against=rel,
        cost_flops=run.get("cost_flops"), **extra)
    for name, ref in refs.items():
        out[name] = dict(losses=ref["losses"], grad_norms=ref["grad_norms"],
                         step_ms=ref["step_ms"], peak_gib=ref["peak_gib"],
                         launches=ref["launches"])
    return out


def comp_gpt2(smi, tmp):
    """(a) GPT-2 small uncut (tied, 12 layers), pp 4 1F1B [3, 3, 3, 3],
    batch 8 in 4 microbatches at seq 1024: the compiled run (6 steps,
    observability on, its replays of steps 2-3 traced, 4-5 timed)
    against 4 steps of the host engine and of a pp=1 run of the same
    weights and batches; the tied wte after step 3 against the host
    engine's two copies, from a 4-step compiled run."""
    import torch

    common = ["parallel.global_train_batch_size=8",
              f"parallel.chunks={PIPE_CHUNKS}",
              f"train.train_iters={COMP_STEPS}",
              f"train.lr_decay_iters={COMP_STEPS}"]
    pp4 = common + ["parallel.pp_deg=4", "parallel.num_devices=4",
                    "parallel.pipeline_type=pipedream_flush"]
    refs = {"pp=1": comp_train("(a) pp=1, chunks 4", GPT2_YAML, common),
            "host engine": comp_train("(a) host engine pp 4 1F1B", GPT2_YAML,
                                      pp4)}
    del refs["pp=1"]["params"]
    four = comp_train("(a) compiled pp 4 1F1B, 4 steps", GPT2_YAML,
                      pp4 + ["pipeline.schedule_impl=compiled"])
    wte = four.pop("params")["embed"]["wte"].detach().float()
    run = comp_train("(a) compiled pp 4 1F1B", GPT2_YAML,
                     pp4 + ["pipeline.schedule_impl=compiled",
                            f"train.train_iters={COMP_GPT2_STEPS}"], tmp,
                     trace=True)
    if run["losses"][:COMP_STEPS] != four["losses"]:
        raise SmokeFailure(f"(a) the 4-step compiled run {four['losses']} "
                           f"departs from the 6-step one {run['losses']}")
    want = comp_launches(run["hpc"], PIPE_CHUNKS)
    rel = comp_gates("(a)", run, refs, want_per_step=want)
    comp_trace_gate("(a)", run)
    host = refs["host engine"].pop("params")
    tied = {}
    for name, other in (("wte", host[0]["embed"]["wte"]),
                        ("whead.T", host[-1]["head"]["whead"].t())):
        d = (wte - other.detach().float())
        tied[name] = dict(rel_norm=float(d.norm() / wte.norm()),
                          max_abs_over_max=float(d.abs().max()
                                                 / wte.abs().max()))
    log(f"  (a) the compiled wte after step {COMP_STEPS - 1} against the "
        f"host engine's copies: {tied} (gate {COMP_RTOL} on the relative "
        "norm)")
    if not bool(torch.isfinite(wte).all()) or any(
            t["rel_norm"] > COMP_RTOL for t in tied.values()):
        raise SmokeFailure(f"(a) the tied wte departs: {tied}")
    del host, wte
    plan = pipe_plan_dict(12, 8, [3, 3, 3, 3])
    doctor = comp_doctor(plan, run["cfg"], 4)
    comp_print("(a)", run, refs, doctor, smi)
    rec = comp_record(run, refs, rel, want, doctor, tied_wte=tied,
                      traced_launches=run["traced_launches"],
                      trace=run["trace"])
    return rec, run


def pipe_plan_dict(n, gbs, division):
    """A searched-style plan: pp ``len(division)`` 1F1B, no per-layer
    checkpoint, batch ``gbs`` in ``PIPE_CHUNKS`` microbatches."""
    return {"pp_deg": len(division), "tp_sizes_enc": ",".join(["1"] * n),
            "tp_consecutive_flags": ",".join(["1"] * n),
            "dp_types_enc": ",".join(["0"] * n),
            "use_sp": ",".join(["0"] * n),
            "cp_sizes_enc": ",".join(["1"] * n),
            "checkpoint": ",".join(["0"] * n),
            "global_bsz": gbs, "chunks": PIPE_CHUNKS,
            "pp_division": ",".join(map(str, division)),
            "pipeline_type": "pipedream_flush", "default_dp_type": "ddp",
            "vtp": 1, "vsp": 0, "embed_sdp": 0}


def comp_qwen(smi, tmp, prefix):
    """(b) Qwen2.5-7B widths at 4 layers, seq 4096, batch 4 in 4
    microbatches on phase 6's corpus unpacked (packed documents are
    ineligible; end-of-document loss masking kept), plain CE: the compiled
    pp 2 1F1B [2, 2] JSON plan against the host engine on the same plan
    and a pp=1 run with the same chunks."""
    common = [f"model.num_hidden_layers={QWEN_LAYERS}",
              "model.use_fused_ce=false", f"train.train_iters={COMP_STEPS}",
              "data.dataset=indexed", f"data.data_path=['{prefix}']",
              "data.split=98,1,1", "data.eod_mask_loss=true"]
    refs = {"pp=1": comp_train("(b) pp=1, chunks 4, plain CE", QWEN_YAML,
                               common + [
        f"parallel.global_train_batch_size={PIPE_QWEN_BSZ}",
        f"parallel.chunks={PIPE_CHUNKS}"])}
    del refs["pp=1"]["params"]
    plan = pipe_plan_file(tmp, "comp_pp2.json", [2, 2])
    json_plan = ["parallel.num_devices=2", "parallel.config_mode=json",
                 f"parallel.galvatron_config_path={plan}"]
    refs["host engine"] = comp_train("(b) host engine pp 2 1F1B", QWEN_YAML,
                                     common + json_plan)
    del refs["host engine"]["params"]
    run = comp_train("(b) compiled pp 2 1F1B", QWEN_YAML, common + json_plan
                     + ["pipeline.schedule_impl=compiled"], tmp)
    del run["params"]
    want = comp_launches(run["hpc"], PIPE_CHUNKS)
    rel = comp_gates("(b)", run, refs, want_per_step=want)
    doctor = comp_doctor(plan, run["cfg"], 2)
    comp_print("(b)", run, refs, doctor, smi)
    return comp_record(run, refs, rel, want, doctor)


def comp_reshard(smi, tmp, gpt2_run):
    """(c) The reshard drill on (a)'s plan: the host engine's checkpoint at
    step 2 into the compiled engine, and the compiled run's checkpoint at
    step 2 into the host engine (``runtime/reshard.resume_elastic``):
    every leaf and moment bit-equal to the checkpoint's canonical form,
    and each destination's next step finite; then the compiled run resumed
    from its own checkpoint in a fresh ``train`` to step 4 equals (a)'s
    uninterrupted compiled run bit for bit (losses, a SHA-256 of every
    leaf)."""
    import torch

    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.models.builder import (
        init_causal_lm,
        named_leaves,
    )
    from hetu_galvatron_tpu_torch.models.modules import compute_dtype_of
    from hetu_galvatron_tpu_torch.runtime import reshard as R
    from hetu_galvatron_tpu_torch.runtime.compiled_pipeline import (
        CompiledPipelineEngine,
    )
    from hetu_galvatron_tpu_torch.runtime.dataloader import (
        get_train_valid_test_data_iterators,
    )
    from hetu_galvatron_tpu_torch.runtime.hybrid_config import (
        get_hybrid_parallel_config,
    )
    from hetu_galvatron_tpu_torch.runtime.pipeline import PipelineEngine
    from hetu_galvatron_tpu_torch.runtime.trainer import to_device

    common = ["parallel.global_train_batch_size=8",
              f"parallel.chunks={PIPE_CHUNKS}",
              f"train.lr_decay_iters={COMP_STEPS}", "parallel.pp_deg=4",
              "parallel.num_devices=4",
              "parallel.pipeline_type=pipedream_flush"]
    saves = {}
    for name, over in (("host", []),
                       ("compiled", ["pipeline.schedule_impl=compiled"])):
        ck = os.path.join(tmp, f"reshard_{name}")
        saves[name] = (ck, comp_train(
            f"(c) {name} engine to the save", GPT2_YAML, common + over + [
                f"train.train_iters={COMP_SAVE_AT}", f"ckpt.save={ck}",
                f"ckpt.save_interval={COMP_SAVE_AT}"]))
        del saves[name][1]["params"]
    args = load_config(GPT2_YAML, ["parallel.mixed_precision=bf16", *common,
                                   *PIPE_EXTRA])
    hpc = get_hybrid_parallel_config(args, 4)
    dev = torch.device(args.device if args.device == "cpu" else "cuda")
    cd = compute_dtype_of(args.parallel.mixed_precision)
    batch = to_device(next(get_train_valid_test_data_iterators(
        args, global_batch_size=hpc.global_bsz)[0]), dev)
    out = {}
    for src, engine_cls in (("host", CompiledPipelineEngine),
                            ("compiled", PipelineEngine)):
        ck = os.path.join(saves[src][0], f"step_{COMP_SAVE_AT}")
        eng = engine_cls(args.model, hpc, args.train, [dev] * 4,
                         compute_dtype=cd)
        sp = eng.split_params(init_causal_lm(args.model, seed=1, device=dev))
        so = eng.init_opt(sp)
        canon, copt, step, _ = R.load_checkpoint_canonical(
            ck, tie_word_embeddings=args.model.tie_word_embeddings)
        nsp, nso, _ = R.resume_elastic(
            ck, sp, so, tie_word_embeddings=args.model.tie_word_embeddings)
        del sp, so
        got = dict(named_leaves(eng.merge_params(nsp)))
        leaves = all(torch.equal(got[n].cpu(), t) for n, t in
                     named_leaves(canon)) and len(got) == len(
            list(named_leaves(canon)))
        opts = nso if isinstance(nso, list) else [nso]
        moments = ([t.cpu() for o in opts for t in o.mu + o.nu])
        merged = R.load_checkpoint_canonical(
            ck, tie_word_embeddings=args.model.tie_word_embeddings)[1]
        # the destination's moments, canonicalized through a save of its
        # own, against the source's
        dst_ck = os.path.join(tmp, f"reshard_{src}_dst")
        from hetu_galvatron_tpu_torch.runtime.checkpoint import (
            save_checkpoint,
        )

        save_checkpoint(dst_ck, step, nsp, nso, hpc=hpc)
        back = R.load_checkpoint_canonical(
            os.path.join(dst_ck, f"step_{step}"),
            tie_word_embeddings=args.model.tie_word_embeddings)[1]
        mom = all(torch.equal(a, b) for key in ("mu", "nu") for (_, a), (_, b)
                  in zip(named_leaves(merged[key]), named_leaves(back[key])))
        counts = {o.count for o in opts} == {merged["count"]}
        if isinstance(nsp, list):  # the host layout: its tied copy
            leaves = leaves and torch.equal(nsp[-1]["head"]["whead"],
                                            nsp[0]["embed"]["wte"].t())
        _, _, m = eng.train_step(nsp, nso, batch)
        finite = math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
        if hasattr(eng, "release"):
            eng.release()
        out[src] = dict(leaves_bit_equal=leaves, moments_bit_equal=mom,
                        count_equal=counts, moments=len(moments),
                        next_step=m, next_step_finite=finite)
        log(f"  (c) {src} checkpoint at step {step} into the "
            f"{'compiled' if src == 'host' else 'host'} engine: "
            f"{len(got)} leaves bit-equal: {leaves}; {len(moments)} moments "
            f"bit-equal: {mom}; count equal: {counts}; next step {m} "
            f"finite: {finite}")
        if not (leaves and mom and counts and finite):
            raise SmokeFailure(f"(c) the reshard of the {src} checkpoint "
                               f"departs: {out[src]}")
        del nsp, nso, eng, got, canon, copt
        gc.collect()
        torch.cuda.empty_cache()
    rest = comp_train("(c) compiled, resumed", GPT2_YAML, common + [
        "pipeline.schedule_impl=compiled",
        f"train.train_iters={COMP_GPT2_STEPS}",
        f"ckpt.load={saves['compiled'][0]}"])
    del rest["params"]
    stitched = saves["compiled"][1]["losses"] + rest["losses"]
    same = (stitched == gpt2_run["losses"]
            and rest["digests"] == gpt2_run["digests"])
    log(f"  (c) compiled resume: stitched losses equal (a)'s: "
        f"{stitched == gpt2_run['losses']}; {len(rest['digests'])} leaves' "
        f"SHA-256 equal: {rest['digests'] == gpt2_run['digests']} [{smi}]")
    if not same:
        raise SmokeFailure(f"(c) the compiled resume departs: {stitched} "
                           f"against {gpt2_run['losses']}")
    out["resume_bit_identical"] = same
    return out


def check_comp_kernels(checks, peak_flops, peak_bytes):
    """K1-K3 at phase 17's folded shapes (the lanes in the batch), against
    their plain versions and timed beside the library: GPT-2's pp 4 lanes
    of 2 (B=8) and the Qwen cell's pp 2 lanes of 1 (B=2, unpacked); the
    records join ``checks``."""
    import torch

    gb, qb = 4 * (8 // PIPE_CHUNKS), 2 * (PIPE_QWEN_BSZ // PIPE_CHUNKS)
    flash = {
        COMP_GPT2: check_path_flash(
            "compiled GPT-2 shape", f"comp gpt2 B={gb} N=K={N} S={S} D={D} "
            "bf16 causal", (gb, N, N, S, D), False, peak_flops, peak_bytes),
        COMP_QWEN: check_path_flash(
            "compiled Qwen shape", f"comp qwen B={qb} N={QN} K={QK} S={QS} "
            f"D={QD} bf16 causal", (qb, QN, QK, QS, QD), False, peak_flops,
            peak_bytes),
    }
    for res in flash.values():
        for k, recs in res["checks"].items():
            checks[k] += recs
    torch.cuda.empty_cache()
    return flash


def comp_paths(smi: str, checks, peak_flops, peak_bytes):
    """Phase 17: K1-K3 at its folded shapes, then (a)-(c) in a temporary
    directory removed at exit; returns the runs' record and the kernels'
    checks and times."""
    import torch

    t0 = time.perf_counter()
    flash = check_comp_kernels(checks, peak_flops, peak_bytes)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_comp_") as tmp:
        out = {}
        out[COMP_GPT2], gpt2_run = comp_gpt2(smi, tmp)
        out["reshard"] = comp_reshard(smi, tmp, gpt2_run)
        del gpt2_run
        gc.collect()
        torch.cuda.empty_cache()
        prefix = write_qwen_corpus(tmp)[0]
        out[COMP_QWEN] = comp_qwen(smi, tmp, prefix)
        gc.collect()
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    out["device"] = smi
    log(f"  phase 17 in {out['wall_s']:.1f} s [{smi}]")
    return out, flash


def comp_blocks(checks, comp, flash):
    """Phase 17's K1-K3 blocks: each compiled run's launches beside the
    checks and times at its folded shape."""
    out = {}
    for k in FLASH:
        out[k] = {}
        for key in (COMP_GPT2, COMP_QWEN):
            timing = flash[key]["timing"][k]
            block = path_block(k, comp[key], timing, max_err(
                checks, k, timing["shape"], ("elementwise",)),
                timing["shape"])
            block.update(flash[key]["report"][k])
            if k in BWD:
                rep = flash[key]["report"]
                block.update(pair_ms=rep["pair_ms"],
                             pair_beats_library=rep["pair_beats_library"])
            out[k][key] = block
    return out


# -- phase 18: layer-wise hybrid plans across ranks sharing the card --------

SPMD_PHASE = ("phase 18: main path of slice 14 (layer-wise hybrid plans "
              "across ranks through train_dist, the ranks sharing the card "
              "over gloo: GPT-2 small W=4 under dp4 DDP, ZeRO-3, tp4 + vtp4 "
              "and a mixed searched-style plan; Qwen2.5-7B widths W=2 under "
              "tp2 + vtp2 with fused CE and remat)")
SPMD_W, SPMD_QWEN_W = 4, 2
SPMD_STEPS = 4  # steps 0-3 held to the W=1 run
SPMD_WARMUP = 2  # step ms: the mean of steps 2-3 (CUDA events)
SPMD_LOSS_RTOL = 1e-5  # fp32 losses against the W=1 run
SPMD_RTOL, SPMD_ATOL = 5e-4, 3e-4  # gathered parameters (JAX's tolerance)
# each leaf's change over the steps against the W=1 run's change, in L2
# norm relative to that change: a lost update on one of d shards reads
# about sqrt(1/d) (0.5 at d = 4), a leaf never updated 1
SPMD_CHANGE_RTOL = 0.05
SPMD_QWEN_FP32_LAYERS = 1  # the Qwen cell's fp32 agreement run
SPMD_TIMEOUT_S = 600.0
# torch threads a rank: the host's cores shared by the ranks
SPMD_THREADS = max(1, (os.cpu_count() or 1) // SPMD_W)
SPMD_DEVICE = "cuda"
SPMD_EXTRA = []  # overrides every phase-18 run takes (a CPU dry run's)
SPMD_GPT2 = "gpt2-small-w4"
SPMD_QWEN = f"qwen2.5-7b-{QWEN_LAYERS}-layers-w2-tp2-vtp2"
# GPT-2's plans: GLOBAL overrides, or a plan file written by spmd_paths
SPMD_PLANS = {
    "dp4-ddp": [],
    "zero3": ["parallel.sdp=1", "parallel.embed_sdp=1"],
    "tp4-vtp4": ["parallel.global_tp_deg=4", "parallel.vocab_tp=4"],
    "mixed": None,  # layers 0-5 tp2 x dp2 ZeRO-2, 6-11 tp4; vocab dp4 ZeRO-2
}
SPMD_BF16_PLANS = ("mixed",)


def spmd_mixed_plan(tmp: str, layers: int) -> str:
    """The searched-style JSON plan of (a): tp2 x dp2 ZeRO-2 on the first
    half of the layers, tp4 on the rest, the vocab layer over dp4 under
    ZeRO-2 (``default_dp_type``)."""
    from hetu_galvatron_tpu_torch.utils.strategy import (
        DPType,
        EmbeddingLMHeadStrategy,
        LayerStrategy,
        save_strategy_config,
        strategy_list2config,
    )

    half = layers // 2
    # dp 1 makes the tp4 layers' dp type moot; the plan's default is zero2
    strategies = (
        [LayerStrategy(pp_deg=1, tp_size=2, dp_size=2,
                       dp_type=DPType.ZERO2)] * half
        + [LayerStrategy(pp_deg=1, tp_size=4, dp_size=1,
                         dp_type=DPType.ZERO2)] * (layers - half))
    cfg = strategy_list2config(strategies, global_bsz=B, chunks=1,
                               default_dp_type="zero2",
                               vocab=EmbeddingLMHeadStrategy())
    path = os.path.join(tmp, "galvatron_config_gpt2_mixed_w4.json")
    save_strategy_config(path, cfg)
    return path


def _bits_sum(params) -> int:
    """An exact fingerprint of a tree on the device: the sum of its fp32
    bit patterns as integers (two replicas that differ in any bit differ
    here unless the differences cancel)."""
    import torch

    from hetu_galvatron_tpu_torch.models.builder import named_leaves

    total = None
    for _, t in named_leaves(params):
        s = t.detach().contiguous().view(torch.int32).to(torch.int64).sum()
        total = s if total is None else total + s
    return int(total)


def spmd_child(rank, world, jobs):
    """One rank of phase 18's world: each job one ``train`` run with the
    launch and collective counters reset just before it and read just
    after; per step the replicas' fingerprint, taken in ``on_step`` after
    the step's time was taken; after the steps the gathered parameters
    against the W=1 run's (rank 0), each leaf's change against the W=1
    run's change, and each leaf's share of its full size."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.models.builder import named_leaves
    from hetu_galvatron_tpu_torch.ops import _build
    from hetu_galvatron_tpu_torch.parallel import comm
    from hetu_galvatron_tpu_torch.parallel.spmd import SpmdEngine

    fingerprints, held = [], {}
    update = SpmdEngine.apply_update

    def holding(self, params, *a):
        held["params"] = params  # the leaves the update writes in place
        update(self, params, *a)

    def fingerprint(it, metrics):
        fingerprints.append(_bits_sum(held["params"]))

    SpmdEngine.apply_update = holding
    out_jobs = []
    for job in jobs:
        # the job carries every override (a child imports this module
        # afresh, without a dry run's settings)
        args = load_config(job["yaml"], job["over"])
        cuda = args.device == "cuda"
        fingerprints.clear()
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        _build.reset_launch_counts()
        comm.reset_counts()
        t0 = time.perf_counter()
        out = train(args, on_step=fingerprint)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_build.launch_counts)
        collectives = comm.counts_by_kind()
        eng, local = out["engine"], out["params"]
        res = dict(tag=job["tag"], losses=out["losses"],
                   step_ms=out["iter_ms"], wall_s=wall, launches=launches,
                   collectives=collectives, fingerprints=list(fingerprints),
                   backend=comm.transport(eng.device.type),
                   peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                             if cuda else 0.0),
                   plan=eng.hpc.describe())
        if rank == 0 and cuda:
            res["smi_used_mib"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=memory.used",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True, timeout=30).stdout.strip()
        if job.get("ref"):
            # a collective: every rank gathers
            full = eng.gather_params(local)
            res["shares"] = {
                name: (t.numel() * t.element_size(),
                       f.numel() * f.element_size(), f.dim())
                for (name, t), (_, f) in zip(named_leaves(local),
                                             named_leaves(full))}
            if rank == 0:
                saved = torch.load(job["ref"], map_location="cpu",
                                   mmap=True)
                ref, moved = saved["params"], saved["change_norm"]
                worst, err, change = 0.0, 0.0, (0.0, "")
                for name, t in named_leaves(full):
                    b = ref[name].to(t.device).float()
                    diff = (t.detach().float() - b).abs()
                    err = max(err, float(diff.max()))
                    worst = max(worst, float((diff / (
                        SPMD_ATOL + SPMD_RTOL * b.abs())).max()))
                    # both runs start from the same weights, so the changes
                    # differ by the final parameters' difference
                    d = float(diff.double().norm())
                    rel = (d / moved[name] if moved[name] > 0
                           else (0.0 if d == 0 else math.inf))
                    change = max(change, (rel, name))
                res.update(param_max_abs_err=err,
                           param_worst_over_limit=worst,
                           change_worst_rel=change[0],
                           change_worst_leaf=change[1])
            del full
        del out, eng, local
        res["job_s"] = time.perf_counter() - t0
        out_jobs.append(res)
    SpmdEngine.apply_update = update
    return out_jobs


def spmd_reference(tag, yaml, over, ref_path=None):
    """The W=1 run of a cell (same weights, same global batches): its
    losses and step ms; with ``ref_path`` its final parameters saved there
    for the ranks' comparison, with each leaf's change over the steps (L2
    norm of final minus the initial weights ``train`` built)."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.models import builder

    args = load_config(yaml, over + SPMD_EXTRA)
    if SPMD_DEVICE == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    first, init = {}, builder.init_causal_lm

    def recorded(*a, **k):  # a host copy: the W=1 peak stays the run's
        params = init(*a, **k)
        first.update((n, t.detach().cpu().clone())
                     for n, t in builder.named_leaves(params))
        return params

    if ref_path:
        builder.init_causal_lm = recorded
    try:
        out = train(args)
    finally:
        builder.init_causal_lm = init
    res = dict(losses=out["losses"], step_ms=out["iter_ms"],
               peak_gib=(torch.cuda.max_memory_allocated() / 2 ** 30
                         if SPMD_DEVICE == "cuda" else 0.0))
    if ref_path:
        final = {n: t.detach().cpu() for n, t in
                 builder.named_leaves(out["params"])}
        change = {n: float((t.double() - first[n].double()).norm())
                  for n, t in final.items()}
        torch.save(dict(params=final, change_norm=change), ref_path)
    del out
    log(f"  {tag} at W=1: losses {res['losses']}; step {res['step_ms']:.2f} "
        f"ms; peak {res['peak_gib']:.2f} GiB")
    return res


def spmd_gates(tag, runs, ref, *, fp32, want_per_step, want_eval=None,
               expect0=None, plan_kind=""):
    """Phase 18's gates on one job's ranks: exact launches on every rank,
    finite losses equal on every rank, the fp32 agreement with the W=1
    run (losses within 1e-5 relative, gathered parameters within rtol 5e-4,
    atol 3e-4, and each leaf's change within 5% of the W=1 run's change in
    L2 norm), bit-identical DDP replicas after every step, ZeRO-3's 1/dp
    of every 2-D+ leaf; bf16 runs print the comparison and take the W=1
    path's step-0 loss gate."""
    r0 = runs[0]
    losses = r0["losses"]
    if len(losses) != SPMD_STEPS or not all(map(math.isfinite, losses)):
        raise SmokeFailure(f"{tag}: losses {losses} not {SPMD_STEPS} finite")
    for r in runs:
        if r["losses"] != losses:
            raise SmokeFailure(f"{tag}: the ranks report different losses")
    want = {k: v * SPMD_STEPS + (want_eval or {}).get(k, 0)
            for k, v in want_per_step.items()}
    for i, r in enumerate(runs):
        if r["launches"] != want:
            raise SmokeFailure(f"{tag}: rank {i} launches {r['launches']}, "
                               f"want {want}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    log(f"  {tag}: losses {losses} against W=1 {ref['losses'][:SPMD_STEPS]}"
        f": relative " + ", ".join(f"{x:.2e}" for x in rel)
        + (f" (gate {SPMD_LOSS_RTOL})" if fp32 else " (printed)"))
    gates = {"loss_rel": rel}
    if fp32:
        if max(rel) > SPMD_LOSS_RTOL:
            raise SmokeFailure(f"{tag}: fp32 losses depart from the W=1 run "
                               f"by {max(rel):.3e}")
        w = r0["param_worst_over_limit"]
        log(f"  {tag}: gathered parameters against W=1: max abs "
            f"{r0['param_max_abs_err']:.3e}, worst |d| / (atol + rtol |ref|)"
            f" {w:.3f} (gate 1)")
        if w > 1.0:
            raise SmokeFailure(f"{tag}: gathered parameters depart from the "
                               f"W=1 run ({w:.3f} of the tolerance)")
        gates["param_worst_over_limit"] = w
        c, leaf = r0["change_worst_rel"], r0["change_worst_leaf"]
        log(f"  {tag}: each leaf's change against W=1's change: worst "
            f"|d|_2 / |change|_2 {c:.3e} ({leaf}) (gate {SPMD_CHANGE_RTOL})")
        if c > SPMD_CHANGE_RTOL:
            raise SmokeFailure(f"{tag}: leaf {leaf} changed unlike the W=1 "
                               f"run ({c:.3e} of its change)")
        gates["change_worst_rel"] = c
    if expect0 is not None:
        log(f"  {tag}: step-0 loss {losses[0]:.4f} against {expect0:.4f} "
            "(gate 0.5)")
        if abs(losses[0] - expect0) > 0.5:
            raise SmokeFailure(f"{tag}: step-0 loss {losses[0]:.4f} is not "
                               f"within 0.5 of {expect0:.4f}")
    if plan_kind == "ddp":
        fps = [r["fingerprints"] for r in runs]
        same = all(f == fps[0] for f in fps) and len(fps[0]) == SPMD_STEPS
        log(f"  {tag}: replicas' fingerprints after each step "
            f"{fps[0]}: {'bit-identical' if same else 'DIFFER'} on "
            f"{len(runs)} ranks")
        if not same:
            raise SmokeFailure(f"{tag}: DDP replicas differ: {fps}")
        gates["replicas_bit_identical"] = True
    if plan_kind == "zero3" and "shares" in runs[0]:
        dp = len(runs)
        bad = {n: (loc, whole) for n, (loc, whole, nd) in
               runs[0]["shares"].items() if nd >= 2 and loc * dp != whole}
        held = sum(loc for loc, whole, nd in runs[0]["shares"].values()
                   if nd >= 2)
        whole = sum(w for _, w, nd in runs[0]["shares"].values() if nd >= 2)
        log(f"  {tag}: rank 0 holds {held} of {whole} bytes of the 2-D+ "
            f"leaves ({held / whole:.4f}; want 1/{dp} of each)")
        if bad:
            raise SmokeFailure(f"{tag}: ZeRO-3 leaves not split 1/{dp}: "
                               f"{bad}")
        gates["zero3_share"] = held / whole
    peaks = [r["peak_gib"] for r in runs]
    log(f"  {tag}: run {r0['job_s']:.1f} s; step {r0['step_ms']:.2f} ms "
        f"against W=1 "
        f"{ref['step_ms']:.2f} ms (steps {SPMD_WARMUP}-{SPMD_STEPS - 1}); "
        f"peaks {['%.2f' % p for p in peaks]} GiB, sum {sum(peaks):.2f} "
        f"GiB; nvidia-smi used {r0.get('smi_used_mib')} MiB; collectives "
        f"{r0['collectives']}; transport {r0['backend']}")
    return dict(plan=r0["plan"], losses=losses, w1_losses=ref["losses"],
                step_ms=r0["step_ms"], w1_step_ms=ref["step_ms"],
                peaks_gib=peaks, peak_sum_gib=sum(peaks),
                smi_used_mib=r0.get("smi_used_mib"),
                launches=r0["launches"], launches_per_step=want_per_step,
                eval_launches={k: (want_eval or {}).get(k, 0)
                               for k in want_per_step},
                collectives=r0["collectives"], transport=r0["backend"],
                wall_s=r0["wall_s"], gates=gates)


def spmd_release():
    """Give the card back before the ranks start: this process's cached
    blocks would count against theirs (and in nvidia-smi's reading)."""
    import torch

    gc.collect()
    if SPMD_DEVICE == "cuda":
        torch.cuda.empty_cache()


def spmd_common(steps=SPMD_STEPS):
    return [f"train.train_iters={steps}", "profile.profile=1",
            f"profile.profile_warmup={SPMD_WARMUP}", "train.eval_interval=0",
            f"device={SPMD_DEVICE}"]


def spmd_gpt2(smi, tmp):
    """(a): GPT-2 small uncut, W=4, batch 8, seq 1024, four plans in fp32
    (the agreement) and bf16, one world for all eight runs."""
    from hetu_galvatron_tpu_torch.parallel.launch import spawn_world

    from hetu_galvatron_tpu_torch.core.arguments import load_config

    cfg = load_config(GPT2_YAML, SPMD_EXTRA).model
    plans = dict(SPMD_PLANS)
    plans["mixed"] = [
        "parallel.config_mode=json",
        f"parallel.galvatron_config_path="
        f"{spmd_mixed_plan(tmp, cfg.num_hidden_layers)}"]
    base = [f"parallel.global_train_batch_size={B}"] + spmd_common()
    refs = {}
    for dtype in ("fp32", "bf16"):
        path = os.path.join(tmp, "gpt2_w1.pt") if dtype == "fp32" else None
        refs[dtype] = spmd_reference(
            f"gpt2 {dtype}", GPT2_YAML,
            base + [f"parallel.mixed_precision={dtype}"], path)
        refs[dtype]["path"] = path
    # fp32 for the agreement under every plan; bf16 for the loss gate and
    # the kernels' shapes under the mixed plan (its tp2 x dp2 layers' shape
    # and its tp4 layers', tp4-vtp4's)
    jobs = [dict(tag=f"{name} {dtype}", yaml=GPT2_YAML,
                 over=base + over + [f"parallel.mixed_precision={dtype}"]
                 + SPMD_EXTRA, ref=refs[dtype]["path"])
            for dtype in ("fp32", "bf16") for name, over in plans.items()
            if dtype == "fp32" or name in SPMD_BF16_PLANS]
    spmd_release()
    t0 = time.perf_counter()
    ranks = spawn_world(spmd_child, SPMD_W, jobs, device=SPMD_DEVICE,
                        timeout=SPMD_TIMEOUT_S, threads=SPMD_THREADS)
    log(f"  GPT-2 world of {SPMD_W}: {len(jobs)} runs in "
        f"{time.perf_counter() - t0:.1f} s (process start included)")
    L = cfg.num_hidden_layers
    per_step = {"flash_fwd": L, "flash_bwd_dkdv": L, "flash_bwd_dq": L,
                "ce_fwd": 0, "ce_bwd": 0}
    out = {}
    for j, job in enumerate(jobs):
        name, dtype = job["tag"].split()
        runs = [r[j] for r in ranks]
        out[job["tag"]] = spmd_gates(
            f"gpt2 {job['tag']}", runs, refs[dtype], fp32=dtype == "fp32",
            want_per_step=per_step,
            expect0=(math.log(cfg.padded_vocab_size) if dtype == "bf16"
                     else None),
            plan_kind={"dp4-ddp": "ddp", "zero3": "zero3"}.get(name, ""))
    return out


def spmd_qwen(smi, tmp, prefix):
    """(b): Qwen2.5-7B widths, W=2, tp2 + vtp2, fused CE (K4/K5 per vocab
    shard), full remat, phase 6's packed corpus, seq 4096, batch 2: bf16
    at phase 6's depth and an fp32 agreement run at fewer layers."""
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.data.synthetic import packed_corpus_overrides
    from hetu_galvatron_tpu_torch.parallel.launch import spawn_world

    plan = ["parallel.global_tp_deg=2", "parallel.vocab_tp=2"]
    base = ["model.use_fused_ce=true", "parallel.global_checkpoint=1",
            f"parallel.global_train_batch_size={QB}",
            *packed_corpus_overrides(prefix)] + spmd_common()
    runs_over = {
        "bf16": base + [f"model.num_hidden_layers={QWEN_LAYERS}",
                        "parallel.mixed_precision=bf16"],
        "fp32": base + [f"model.num_hidden_layers={SPMD_QWEN_FP32_LAYERS}",
                        "parallel.mixed_precision=fp32"]}
    refs = {}
    for dtype, over in runs_over.items():
        path = os.path.join(tmp, "qwen_w1.pt") if dtype == "fp32" else None
        refs[dtype] = spmd_reference(f"qwen {dtype}", QWEN_YAML, over, path)
        refs[dtype]["path"] = path
    jobs = [dict(tag=dtype, yaml=QWEN_YAML, over=over + plan + SPMD_EXTRA,
                 ref=refs[dtype]["path"]) for dtype, over in runs_over.items()]
    spmd_release()
    t0 = time.perf_counter()
    ranks = spawn_world(spmd_child, SPMD_QWEN_W, jobs, device=SPMD_DEVICE,
                        timeout=SPMD_TIMEOUT_S, threads=SPMD_THREADS)
    log(f"  Qwen world of {SPMD_QWEN_W}: {len(jobs)} runs in "
        f"{time.perf_counter() - t0:.1f} s (process start included)")
    out = {}
    for j, job in enumerate(jobs):
        dtype = job["tag"]
        cfg = load_config(QWEN_YAML, job["over"]).model
        L = cfg.num_hidden_layers
        # remat runs K1 twice a layer; K4 / K5 once a step on each rank
        # (no evaluation: train.eval_interval=0)
        per_step = {"flash_fwd": 2 * L, "flash_bwd_dkdv": L,
                    "flash_bwd_dq": L, "ce_fwd": 1, "ce_bwd": 1}
        runs = [r[j] for r in ranks]
        expect0 = (math.log(cfg.padded_vocab_size)
                   + 0.5 * 0.02 ** 2 * cfg.hidden_size)
        out[dtype] = spmd_gates(
            f"qwen {L}-layer {dtype}", runs, refs[dtype],
            fp32=dtype == "fp32", want_per_step=per_step,
            expect0=expect0 if dtype == "bf16" else None)
        out[dtype]["layers"] = L
        # the ranks' summed peak, and what nvidia-smi sees held after the
        # run (every process's context and cached blocks, this one's too)
        summed = out[dtype]["peak_sum_gib"]
        held = (float(out[dtype]["smi_used_mib"]) / 1024
                if out[dtype]["smi_used_mib"] else 0.0)
        log(f"  qwen {dtype}: summed peak {summed:.2f} GiB, nvidia-smi "
            f"used {held:.2f} GiB after the run (gate {MEM_LIMIT_GIB} each)")
        if max(summed, held) >= MEM_LIMIT_GIB:
            raise SmokeFailure(f"qwen {dtype}: {summed:.2f} GiB summed peak "
                               f"/ {held:.2f} GiB held is not under "
                               f"{MEM_LIMIT_GIB} GiB")
    return out


def check_spmd_kernels(checks, peak_flops, peak_bytes):
    """K1-K3 at the local shapes phase 18's ranks give them: checked and
    timed beside the library in bf16 (the mixed plan's bf16 run: tp2 x
    dp2's B=4 N=6 and tp4's B=8 N=3; Qwen tp2: N=14 K=2 on the packed
    rows), checked in fp32 at the fp32 runs' (dp4 and ZeRO-3's B=2 N=12,
    tp2 x dp2's, tp4's); K4/K5 on the Qwen cell's vocab shard (T=8192,
    V/2 = 76032 columns, labels of the whole vocabulary offset by the
    second shard, so most fall outside it). Each against its plain
    version; the records join ``checks``."""
    import torch

    flash = {}
    for b, n in ((4, N // 2), (8, N // 4)):
        flash[f"gpt2 B={b} N={n}"] = check_path_flash(
            "SPMD GPT-2 local shape", f"spmd gpt2 B={b} N=K={n} S={S} D={D} "
            "bf16 causal", (b, n, n, S, D), False, peak_flops, peak_bytes)
    for b, n in ((2, N), (4, N // 2), (8, N // 4)):
        tag = f"spmd gpt2 B={b} N=K={n} S={S} D={D} fp32 causal"
        res, _ = check_case(tag, b=b, n=n, kv=n, s=S, sk=S, d=D,
                            dtype=torch.float32, causal=True, seg=False,
                            rate=0.0, layout="fused")
        for k, recs in res.items():
            checks[k] += [dict(r, case=tag) for r in recs]
    flash["qwen tp2"] = check_path_flash(
        "SPMD Qwen tp2 local shape", f"spmd qwen B={QB} N={QN // 2} "
        f"K={QK // 2} S={QS} D={QD} bf16 seg", (QB, QN // 2, QK // 2, QS, QD),
        True, peak_flops, peak_bytes)
    for res in flash.values():
        for k, recs in res["checks"].items():
            checks[k] += recs
    vl = QV // 2
    tag = f"spmd qwen shard 1/2 T={QT} V={vl} fp32"
    res, inputs = check_ce_case(tag, QT, vl, torch.float32, seed=13,
                                shards=2, shard=1)
    for k, recs in res.items():
        checks[k] += [dict(r, case=tag) for r in recs]
    times, lib = time_ce(inputs)
    del inputs
    bnd = ce_bounds(QT, vl, 4, peak_bytes, 67e12)
    log_times(f"T={QT} V={vl} vocab shard", times, lib, bnd)
    ce = {k: dict(ms=times[k][0], plain_ms=times[k][1], library_ms=lib[k],
                  bound_ms=bnd[k]["bound_ms"], bound_by=bnd[k]["bound_by"],
                  flops=bnd[k]["flops"], bytes=bnd[k]["bytes"], shape=tag)
          for k in times}
    torch.cuda.empty_cache()
    return flash, ce


def spmd_paths(smi: str, checks, peak_flops, peak_bytes):
    """Phase 18: the kernels at the ranks' local shapes, then (a) and (b)
    in a temporary directory removed at exit; returns the runs' record and
    the kernels' checks and times."""
    import torch

    t0 = time.perf_counter()
    kernels = check_spmd_kernels(checks, peak_flops, peak_bytes)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spmd_") as tmp:
        out = {SPMD_GPT2: spmd_gpt2(smi, tmp)}
        torch.cuda.empty_cache()
        prefix = write_qwen_corpus(tmp)[0]
        out[SPMD_QWEN] = spmd_qwen(smi, tmp, prefix)
        torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    out["device"] = smi
    log(f"  phase 18 in {out['wall_s']:.1f} s [{smi}]")
    return out, kernels


def spmd_blocks(checks, spmd, kernels):
    """Phase 18's blocks per kernel: the launches of each rank of a run
    beside the checks and times at that run's local shape (GPT-2's bf16
    runs: K1-K3 at the plan's first layer's shape; the Qwen cell's: K1-K3
    at tp2's heads, K4/K5 on its vocab shard)."""
    flash, ce = kernels
    # the bf16 run: the mixed plan at its tp2 x dp2 layers' shape, its tp4
    # layers' under by_shape
    shapes = {"mixed": "gpt2 B=4 N=6"}

    def block(k, run, timing, case):
        out = path_block(k, run, timing, max_err(checks, k, case),
                         timing["shape"])
        out["launches_per_rank"] = out["launches"]
        return out

    out = {}
    for k in KERNELS:
        out[k] = {}
        if k in FLASH:
            for name, key in shapes.items():
                timing = flash[key]["timing"][k]
                out[k][f"{SPMD_GPT2}-{name}"] = block(
                    k, spmd[SPMD_GPT2][f"{name} bf16"], timing,
                    timing["shape"])
                out[k][f"{SPMD_GPT2}-{name}"]["by_shape"] = {
                    key: block(k, spmd[SPMD_GPT2][f"{name} bf16"],
                               flash[key]["timing"][k],
                               flash[key]["timing"][k]["shape"])
                    for key in ("gpt2 B=4 N=6", "gpt2 B=8 N=3")}
            timing = flash["qwen tp2"]["timing"][k]
        else:
            timing = ce[k]
        out[k][SPMD_QWEN] = block(k, spmd[SPMD_QWEN]["bf16"], timing,
                                  timing["shape"])
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs the "
              "port on the GPU", file=sys.stderr)
        return 2
    try:
        from hetu_galvatron_tpu_torch.ops import _build
        from hetu_galvatron_tpu_torch.ops import flash_attention as TF
    except ImportError as e:
        print(f"chip_smoke: the port package is missing ({e}); run from the "
              "root of the repository", file=sys.stderr)
        return 3
    global _log_file
    with open(LOG_PATH, "w") as f:
        _log_file = f
        try:
            return run(torch, _build, TF)
        finally:
            _log_file = None


def run(torch, _build, TF) -> int:
    """Phases 1-18 (or the subset a flag names) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    phase("phase 1: device")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    peak_flops, peak_bytes, peak_src = card_peaks(smi)
    log(f"  nvidia-smi: {smi}")
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), device 0 = {name}")
    log(f"  peaks used: {peak_src}")

    phase("phase 2: build")
    t0 = time.perf_counter()
    _build.load_library(rebuild=True)
    log(f"  built {len(_build.sources())} sources with nvcc for sm_90a in "
        f"{_build.build_seconds:.1f} s ({time.perf_counter() - t0:.1f} s "
        "with loading)")
    ptxas = ptxas_report(os.path.join(_build.BUILD_DIR, "build.log"))
    for kname, regs, st, ld in ptxas:
        log(f"  ptxas {kname:<58} {regs:>3} registers, spill {st} / {ld} "
            "bytes")
    if any(st or ld for _, _, st, ld in ptxas):
        raise SmokeFailure("a kernel spills registers (ptxas above)")
    zoo_only = sys.argv[1:] == ["--zoo-only"]
    obs_only = sys.argv[1:] == ["--obs-only"]
    if sys.argv[1:] == ["--serve-only"]:
        phase(SERVE_PHASE)
        serving = serve_paths(smi)
        log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
        log(json.dumps({"serving": serving}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--plan-only"]:
        phase(PLAN_PHASE)
        plan = plan_paths(smi)
        log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
        log(json.dumps({"plan": plan}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--pipe-only"]:
        phase(PIPE_PHASE)
        checks = {k: [] for k in FLASH}
        pipe, pipe_flash = pipe_paths(smi, checks, peak_flops, peak_bytes)
        log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
        log(json.dumps({"pipeline": pipe}))
        log(json.dumps({"pipeline_kernels": pipe_blocks(checks, pipe,
                                                        pipe_flash)}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--compiled-only"]:
        phase(COMP_PHASE)
        checks = {k: [] for k in FLASH}
        comp, comp_flash = comp_paths(smi, checks, peak_flops, peak_bytes)
        log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
        log(json.dumps({"compiled": comp}))
        log(json.dumps({"compiled_kernels": comp_blocks(checks, comp,
                                                        comp_flash)}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--spmd-only"]:
        phase(SPMD_PHASE)
        checks = {k: [] for k in KERNELS}
        spmd, spmd_k = spmd_paths(smi, checks, peak_flops, peak_bytes)
        log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
        log(json.dumps({"spmd": spmd}))
        log(json.dumps({"spmd_kernels": spmd_blocks(checks, spmd, spmd_k)}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--lifecycle-only"]:
        # phase 8 alone, over its own copy of phase 6's corpus
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            prefix = write_qwen_corpus(tmp)[0]
            phase("phase 8: checkpoint, resume and the fault lifecycle")
            lifecycle_path(smi, prefix)
        log(smi)
        return 0

    phase("phase 3: kernels against their plain versions")
    checks = {k: [] for k in KERNELS}
    slice_res, slice_inputs = check_case(
        "slice bf16", b=B, n=N, kv=N, s=S, sk=S, d=D, dtype=torch.bfloat16,
        causal=True, seg=False, rate=0.0, layout="fused")
    # the same shape and layout in fp32, where only summation order
    # separates kernel and plain version, so a structural fault at the
    # main path's shape cannot hide under bf16 rounding
    cases = [
        ("slice fp32", dict(b=B, n=N, kv=N, s=S, sk=S, d=D,
                            dtype=torch.float32, causal=True, seg=False,
                            rate=0.0, layout="fused")),
        ("gqa+seg+drop S=200 fp32", dict(b=2, n=8, kv=2, s=200, sk=200, d=64,
                                         dtype=torch.float32, causal=True,
                                         seg=True, rate=0.1)),
        ("gqa+seg+drop S=200 bf16", dict(b=2, n=8, kv=2, s=200, sk=200, d=64,
                                         dtype=torch.bfloat16, causal=True,
                                         seg=True, rate=0.1)),
        ("noncausal Sk=136 S=200 fp32", dict(b=2, n=8, kv=2, s=200, sk=136,
                                             d=64, dtype=torch.float32,
                                             causal=False, seg=False,
                                             rate=0.1)),
        ("noncausal Sk=136 S=200 bf16", dict(b=2, n=8, kv=2, s=200, sk=136,
                                             d=64, dtype=torch.bfloat16,
                                             causal=False, seg=False,
                                             rate=0.1)),
        ("D=128 S=130 fp32", dict(b=1, n=4, kv=4, s=130, sk=130, d=128,
                                  dtype=torch.float32, causal=True, seg=False,
                                  rate=0.0)),
        ("D=32 S=77 bf16", dict(b=3, n=6, kv=3, s=77, sk=77, d=32,
                                dtype=torch.bfloat16, causal=True, seg=True,
                                rate=0.0)),
        # parallel.mixed_precision=fp16 runs the __half instantiations
        ("gqa+seg+drop S=200 fp16", dict(b=2, n=8, kv=2, s=200, sk=200, d=64,
                                         dtype=torch.float16, causal=True,
                                         seg=True, rate=0.1)),
        ("noncausal Sk=136 S=200 fp16", dict(b=2, n=8, kv=2, s=200, sk=136,
                                             d=64, dtype=torch.float16,
                                             causal=False, seg=False,
                                             rate=0.1)),
        # D=40 runs zero-padded to 64 in the 16-bit K2/K3 tiles
        ("D=40 S=200 bf16", dict(b=2, n=4, kv=2, s=200, sk=200, d=40,
                                 dtype=torch.bfloat16, causal=True, seg=True,
                                 rate=0.0)),
        # ids repeating out of order (0, 1, 0, 2, ...): the tile rule's
        # [min, max] ranges stay conservative
        ("unsorted segments S=300 bf16", dict(b=2, n=8, kv=2, s=300, sk=300,
                                              d=64, dtype=torch.bfloat16,
                                              causal=True, seg="unsorted",
                                              rate=0.1)),
        # rows d + 3 apart: the element-load instantiation of K2/K3
        ("unaligned strides S=200 bf16", dict(b=2, n=8, kv=2, s=200, sk=200,
                                              d=64, dtype=torch.bfloat16,
                                              causal=True, seg=True, rate=0.0,
                                              layout="unaligned")),
        ("unaligned strides D=40 S=77 fp16", dict(b=2, n=4, kv=2, s=77,
                                                  sk=77, d=40,
                                                  dtype=torch.float16,
                                                  causal=False, seg=False,
                                                  rate=0.0,
                                                  layout="unaligned")),
        (QWEN_FP16,
         dict(b=QB, n=QN, kv=QK, s=QS, sk=QS, d=QD, dtype=torch.float16,
              causal=True, seg=True, rate=0.0, layout="fused")),
        (QWEN_FP16_UNPACKED,
         dict(b=QB, n=QN, kv=QK, s=QS, sk=QS, d=QD, dtype=torch.float16,
              causal=True, seg=False, rate=0.0, layout="fused")),
    ]
    for name_k, recs in slice_res.items():
        checks[name_k] += [dict(r, case="slice bf16") for r in recs]
    for tag, kw in cases:
        res, inputs = check_case(tag, **kw)
        for name_k, recs in res.items():
            checks[name_k] += [dict(r, case=tag) for r in recs]
        if tag in (QWEN_FP16, QWEN_FP16_UNPACKED):
            # fp16 rounds P (and K2/K3's dS) once where bf16 carries them
            # as hi + lo: the two dtypes' times show what the split costs,
            # and fp16 is where the goal "no slower than SDPA" is read
            t16, lib16, _ = time_kernels(inputs, BIG_REPS, tag=tag)
            ms16 = {k: t16[k][0] for k in FLASH}
            log(f"  {tag}: K1 {ms16['flash_fwd']:.3f} ms, K2 "
                f"{ms16['flash_bwd_dkdv']:.3f} ms, K3 "
                f"{ms16['flash_bwd_dq']:.3f} ms")
            pair16 = ms16["flash_bwd_dkdv"] + ms16["flash_bwd_dq"]
            k1_met = ms16["flash_fwd"] <= lib16["flash_fwd"]
            pair_met = pair16 <= lib16["flash_bwd_dkdv"]
            log(f"  {tag}: goal no slower than SDPA in fp16: K1 "
                f"{ms16['flash_fwd']:.3f} ms against "
                f"{lib16['flash_fwd']:.3f} ({'met' if k1_met else 'missed'})"
                f"; K2 + K3 {pair16:.3f} ms against the backward "
                f"{lib16['flash_bwd_dkdv']:.3f} "
                f"({'met' if pair_met else 'missed'})")
            if tag == QWEN_FP16:
                fp16_ms = ms16
        del inputs
    auto = [dict(r, case=f"slice {tag}") for dtype, tag in
            ((torch.bfloat16, "bf16"), (torch.float32, "fp32"))
            for r in check_autograd(f"slice {tag}", b=B, n=N, s=S, d=D,
                                    dtype=dtype)]
    times, lib, gpt2_alt = time_kernels(slice_inputs, tag="GPT-2 shape")
    bnd = bounds(B, N, N, S, D, 2, peak_flops, peak_bytes)
    log_times("GPT-2 shape", times, lib, bnd)
    gpt2_rep = flash_report("GPT-2 shape", times, lib, bnd, b=B, s=S,
                            dtype=torch.bfloat16, alt=gpt2_alt, d=D)
    del slice_inputs
    qwen_flash = check_path_flash(
        "Qwen shape", f"qwen B={QB} N={QN} K={QK} S={QS} D={QD} bf16 seg",
        (QB, QN, QK, QS, QD), True, peak_flops, peak_bytes, fp16_ms)
    for name_k, recs in qwen_flash["checks"].items():
        checks[name_k] += recs
    # phase 17's compiled Qwen cell: the same widths on unpacked rows
    qwen_unpacked = check_path_flash(
        "Qwen shape unpacked", f"qwen B={QB} N={QN} K={QK} S={QS} D={QD} "
        "bf16 causal unpacked", (QB, QN, QK, QS, QD), False, peak_flops,
        peak_bytes)
    for name_k, recs in qwen_unpacked["checks"].items():
        checks[name_k] += recs
    # removed at exit, also when a phase fails
    tmpdir = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    tmp = tmpdir.name
    mixtral_prefix, mixtral_stats, mixtral_segs, seg_step = mixtral_corpus(
        tmp)
    mixtral_flash = check_path_flash(
        "Mixtral shape",
        f"mixtral B={MB} N={MN} K={MK} S={MS} D={MD} bf16 step-{seg_step} "
        "segments", (MB, MN, MK, MS, MD), mixtral_segs, peak_flops,
        peak_bytes)
    for name_k, recs in mixtral_flash["checks"].items():
        checks[name_k] += recs
    ce = check_ce(peak_bytes)
    for name_k, recs in ce["checks"].items():
        checks[name_k] += recs
    torch.cuda.empty_cache()
    llama_prefix, llama_stats, llama_segs = llama_corpus(tmp)
    zoo_k = check_zoo_kernels(peak_flops, peak_bytes, llama_segs)
    for res in zoo_k["flash"].values():
        for name_k, recs in res["checks"].items():
            checks[name_k] += recs
    for name_k, recs in zoo_k["ce_checks"].items():
        checks[name_k] += recs
    torch.cuda.empty_cache()
    if obs_only:
        qwen_prefix = write_qwen_corpus(tmp)[0]
        obs = obs_paths(smi, qwen_prefix, tmp)
        tmpdir.cleanup()
        rows = kernel_rows(checks, zoo_k, None,
                           obs_blocks(checks, obs, qwen_flash, ce,
                                      (times, lib, bnd)))
        log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
        log(json.dumps({"kernels": rows}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0
    if zoo_only:
        zoo = zoo_paths(peak_flops, llama_prefix, llama_stats)
        tmpdir.cleanup()
        rows = kernel_rows(checks, zoo_k, zoo)
        log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
        log(json.dumps({"kernels": rows}))
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": name,
            "count": torch.cuda.device_count()}}))
        return 0

    phase("phase 4: reference runs (flash against the plain core; fused CE "
          "+ remat against the plain loss; MoE: both, and dropless against "
          "capacity)")
    reference_run()
    reference_run_ce(tmp)
    reference_run_moe(tmp)

    phase("phase 5: main path of slice 1 (train_dist, GPT-2 small)")
    gpt2 = main_path(peak_flops)
    torch.cuda.empty_cache()

    phase("phase 6: main path of slice 2 (train_dist, Qwen2.5-7B widths, 4 "
          "layers)")
    qwen = qwen_path(peak_flops, tmp)
    torch.cuda.empty_cache()

    phase("phase 7: main path of slice 5 (train_dist, Mixtral-8x7B widths, "
          "2 layers)")
    mixtral = mixtral_path(peak_flops, mixtral_prefix, mixtral_stats)
    torch.cuda.empty_cache()

    phase("phase 8: main path of slice 6 (checkpoint, resume and the fault "
          "lifecycle: Qwen2.5-7B-width preemption drill, GPT-2 kill-mid-save "
          "drill, under cli.supervise)")
    qwen_drill_run, gpt2_drill_run = lifecycle_path(
        smi, os.path.join(tmp, "qwen_corpus"))
    torch.cuda.empty_cache()
    zoo = zoo_paths(peak_flops, llama_prefix, llama_stats)
    obs = obs_paths(smi, os.path.join(tmp, "qwen_corpus"), tmp)
    tmpdir.cleanup()
    torch.cuda.empty_cache()
    phase(SERVE_PHASE)
    serving = serve_paths(smi)
    torch.cuda.empty_cache()
    phase(PLAN_PHASE)
    plan = plan_paths(smi)
    torch.cuda.empty_cache()
    phase(PIPE_PHASE)
    pipe, pipe_flash = pipe_paths(smi, checks, peak_flops, peak_bytes)
    torch.cuda.empty_cache()
    phase(COMP_PHASE)
    comp, comp_flash = comp_paths(smi, checks, peak_flops, peak_bytes)
    torch.cuda.empty_cache()
    phase(SPMD_PHASE)
    spmd, spmd_k = spmd_paths(smi, checks, peak_flops, peak_bytes)

    # one block per path that runs the kernel: its launches beside the
    # times measured at that path's shape
    qwen_name = f"qwen2.5-7b-{QWEN_LAYERS}-layers"
    mixtral_name = f"mixtral-8x7b-{MIXTRAL_LAYERS}-layers"
    drill_name = f"qwen2.5-7b-{QWEN_DRILL_LAYERS}-layers-preemption-drill"
    gpt2_drill_name = "gpt2-small-kill-mid-save-drill"
    qwen_drill_launches = dict(
        launches=qwen_drill_run["launches_total"],
        launches_per_step=qwen_drill_run["launches_per_step"],
        eval_launches=qwen_drill_run["eval_launches"])
    earlier = {}
    for k in KERNELS:
        paths = {}
        if k in FLASH:
            gpt2_timing = dict(ms=times[k][0], plain_ms=times[k][1],
                               library_ms=lib[k], **bnd[k],
                               **route_keys(gpt2_rep[k]))
            paths["gpt2-small"] = path_block(
                k, gpt2, gpt2_timing,
                max_err(checks, k, "slice bf16", ("elementwise",)),
                f"B={B} N=K={N} S={S} D={D} bf16 causal")
            paths[gpt2_drill_name] = path_block(
                k, gpt2_drill_run, gpt2_timing,
                max_err(checks, k, "slice bf16", ("elementwise",)),
                f"B={B} N=K={N} S={S} D={D} bf16 causal")
            for path, run, res in ((qwen_name, qwen, qwen_flash),
                                   (mixtral_name, mixtral, mixtral_flash),
                                   (drill_name, qwen_drill_launches,
                                    qwen_flash)):
                timing = res["timing"][k]
                paths[path] = path_block(
                    k, run, timing,
                    max_err(checks, k, timing["shape"], ("elementwise",)),
                    timing["shape"])
            for path, rep in (("gpt2-small", gpt2_rep),
                              (qwen_name, qwen_flash["report"]),
                              (mixtral_name, mixtral_flash["report"])):
                paths[path].update(rep[k])
                if k in BWD:
                    paths[path].update(
                        pair_ms=rep["pair_ms"],
                        pair_beats_library=rep["pair_beats_library"])
            paths[qwen_name]["fp16_ms"] = fp16_ms[k]
        else:
            paths[qwen_name] = path_block(
                k, qwen, ce["timing"]["fp32"][k],
                max_err(checks, k, "qwen fp32"),
                f"T={QT} V={QV} fp32 logits (the path's dtype)")
            paths[mixtral_name] = path_block(
                k, mixtral, ce["timing"]["mixtral fp32"][k],
                max_err(checks, k, "mixtral fp32"),
                f"T={MT} V={MV} fp32 logits (the path's dtype)")
            paths[drill_name] = path_block(
                k, qwen_drill_launches, ce["timing"]["fp32"][k],
                max_err(checks, k, "qwen fp32"),
                f"T={QT} V={QV} fp32 logits (the path's dtype)")
        earlier[k] = paths
    for k, blocks in obs_blocks(checks, obs, qwen_flash, ce,
                                (times, lib, bnd)).items():
        earlier[k].update(blocks)
        earlier[k][PLAN_PATH] = qwen_block(k, plan, checks, qwen_flash, ce)
    for k, blocks in pipe_blocks(checks, pipe, pipe_flash).items():
        earlier[k].update(blocks)
    # phase 17: K1-K3 at its folded shapes; K4/K5 launch 0 times there
    # (every lane's head runs the plain CE), beside the Qwen path's times
    for k, blocks in comp_blocks(checks, comp, comp_flash).items():
        earlier[k].update(blocks)
    for k in ("ce_fwd", "ce_bwd"):
        earlier[k][COMP_QWEN] = qwen_block(k, comp[COMP_QWEN], checks,
                                           qwen_flash, ce)
    # phase 18: each kernel at its ranks' local shapes
    for k, blocks in spmd_blocks(checks, spmd, spmd_k).items():
        earlier[k].update(blocks)
    rows = kernel_rows(checks, zoo_k, zoo, earlier)
    rows[0]["autograd_checks"] = auto
    rows[3]["autograd_checks"] = ce["zloss"]
    rows[3]["bf16"] = ce["timing"]["bf16"]["ce_fwd"]
    rows[4]["bf16"] = ce["timing"]["bf16"]["ce_bwd"]
    log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"serving": serving}))
    log(json.dumps({"plan": plan}))
    log(json.dumps({"pipeline": pipe}))
    log(json.dumps({"compiled": comp}))
    log(json.dumps({"spmd": spmd}))
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


def max_err(checks, k, case, kinds=("elementwise", "abs", "exact")):
    """The largest error of kernel ``k``'s checks on one case."""
    return max(c["max_abs_err"] for c in checks[k]
               if c["case"] == case and c["tol_kind"] in kinds)


def path_block(k, run, timing, err, shape):
    """Kernel ``k``'s block for one path: the path's launches (in the run,
    per step, in its evals) beside the times measured at its shape."""
    return dict(launches=run["launches"][k],
                launches_per_step=run["launches_per_step"][k],
                eval_launches=run["eval_launches"][k],
                max_abs_err=err, ms=timing["ms"],
                plain_ms=timing["plain_ms"],
                library_ms=timing["library_ms"],
                bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
                flops=timing["flops"], bytes=timing["bytes"], shape=shape,
                **route_keys(timing))


def zoo_paths(peak_flops, llama_prefix, llama_stats):
    """Phases 9-11, each with the launch counters reset before it."""
    import torch

    phase("phase 9: main path of slice 7 (train_dist, Llama-3.1-70B "
          f"widths, {LLAMA_LAYERS} layers, seq {LS}, llama3 rope scaling)")
    llama = llama_path(peak_flops, llama_prefix, llama_stats)
    torch.cuda.empty_cache()
    phase("phase 10: main path of slice 7 (train_dist, BERT-large, 24 "
          "layers, MLM)")
    bert = bert_path(peak_flops)
    torch.cuda.empty_cache()
    phase("phase 11: main path of slice 7 (train_dist, T5-3B, 24 + 24 "
          "layers)")
    t5 = t5_path(peak_flops)
    torch.cuda.empty_cache()
    return {"llama": llama, "bert": bert, "t5": t5}


LLAMA_PATH = f"llama3.1-70b-{LLAMA_LAYERS}-layers"


def qwen_block(k, run, checks, qwen_flash, ce):
    """Kernel ``k``'s block for a run at the Qwen path's shapes: its
    launches beside phase 3's times there (K1-K3 bf16 with packed
    segments, K4/K5 over fp32 logits)."""
    if k in FLASH:
        timing = qwen_flash["timing"][k]
        err = max_err(checks, k, timing["shape"], ("elementwise",))
        shape = timing["shape"]
    else:
        timing = ce["timing"]["fp32"][k]
        err = max_err(checks, k, "qwen fp32")
        shape = f"T={QT} V={QV} fp32 logits (the path's dtype)"
    return path_block(k, run, timing, err, shape)


def obs_blocks(checks, obs, qwen_flash, ce, gpt2_times):
    """Phases 12-13's blocks per kernel: the ramp path's launches (run b,
    observability on) beside the times at the Qwen shape, and the
    supervised GPT-2 drill's beside phase 3's times at GPT-2's shape
    (K1-K3; ``gpt2_times`` is ``(times, lib, bnd)``)."""
    times, lib, bnd = gpt2_times
    out = {}
    for k in KERNELS:
        block = qwen_block(k, obs["ramp"], checks, qwen_flash, ce)
        block["launches_per_microbatch"] = \
            obs["ramp"]["launches_per_microbatch"][k]
        out[k] = {RAMP_PATH: block}
        if k in FLASH:
            out[k][OBS_GPT2_PATH] = path_block(
                k, obs["gpt2"], dict(ms=times[k][0], plain_ms=times[k][1],
                                     library_ms=lib[k], **bnd[k]),
                max_err(checks, k, "slice bf16", ("elementwise",)),
                f"B={B} N=K={N} S={S} D={D} bf16 causal")
    return out


def kernel_rows(checks, zoo_k, zoo, earlier=None):
    """The kernels JSON line's rows: per kernel, one block per path that
    ran it (``earlier``: the blocks of phases 5-8 and 12-13, only 12-13
    under ``--obs-only`` and none under ``--zoo-only``), the zoo paths'
    blocks at their shapes (T5's K1-K3 block at the decoder's causal
    self-attention, with all three of its shapes under ``by_shape``);
    the row's own keys are those of slice 7's Llama path, the only one
    that runs every kernel at the largest shapes, or under
    ``--obs-only`` (``zoo`` None) those of phase 12's ramp path."""
    flash = zoo_k["flash"]
    rows = []
    own = LLAMA_PATH if zoo is not None else RAMP_PATH
    for k, meta in KERNELS.items():
        paths = dict((earlier or {}).get(k, {}))
        if zoo is None:
            tol = TOL_16 if k in FLASH else TOL_FP32
            tol_rule = ("every element: |got - want| <= tol * (rms(want) + "
                        "|want|); 1e-4 in fp32, 1e-3 absolute on lse"
                        if k in FLASH else
                        "gold bit-equal, lse within 1e-4 absolute, dlogits "
                        "every element within tol * (rms(want) + |want|): "
                        "1e-4 in fp32, 2e-2 in bf16/fp16")
        elif k in FLASH:
            def fblock(run, key):
                timing = flash[key]["timing"][k]
                out = path_block(k, run, timing, max_err(
                    checks, k, timing["shape"], ("elementwise",)),
                    timing["shape"])
                out.update(flash[key]["report"][k])
                if k in BWD:
                    rep = flash[key]["report"]
                    out.update(pair_ms=rep["pair_ms"],
                               pair_beats_library=rep["pair_beats_library"])
                return out

            paths[LLAMA_PATH] = fblock(zoo["llama"], "llama")
            paths["bert-large"] = fblock(zoo["bert"], "bert")
            paths["t5-3b"] = fblock(zoo["t5"], "t5_dec")
            paths["t5-3b"]["by_shape"] = {
                key: fblock(zoo["t5"], key)
                for key in ("t5_enc", "t5_dec", "t5_cross")}
            tol_rule = ("every element: |got - want| <= tol * (rms(want) + "
                        "|want|); 1e-4 in fp32, 1e-3 absolute on lse")
            tol = TOL_16
        else:
            for path, key in ((LLAMA_PATH, "llama"), ("bert-large", "bert"),
                              ("t5-3b", "t5")):
                timing = zoo_k["ce_timing"][key][k]
                paths[path] = path_block(k, zoo[key], timing,
                                         max_err(checks, k, timing["shape"]),
                                         timing["shape"])
            tol_rule = ("gold bit-equal, lse within 1e-4 absolute, dlogits "
                        "every element within tol * (rms(want) + |want|): "
                        "1e-4 in fp32, 2e-2 in bf16/fp16")
            tol = TOL_FP32
        row = dict(name=k, route=meta["route"], source=meta["source"],
                   **({"mma_source": meta["mma_source"]}
                      if "mma_source" in meta else {}),
                   replaces=meta["replaces"],
                   library_call=meta["library_call"], **paths[own],
                   tol=tol, tol_rule=tol_rule, paths=paths)
        row["checks"] = checks[k]
        rows.append(row)
    return rows


if __name__ == "__main__":
    sys.exit(main())
