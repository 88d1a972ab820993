"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository. It needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and imports nothing of JAX or of the JAX package. Phases,
each of which ends the run with a non-zero exit when it fails:

1. device: the card's name and power limit (``nvidia-smi``) and CUDA version;
2. build: compile the kernels K1-K5 (flash attention, fused cross-entropy)
   from ``hetu_galvatron_tpu_torch/csrc`` with ``nvcc`` for ``sm_90a``, and
   print each kernel's registers and spills (``-Xptxas -v``; a spill fails
   the run);
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, every element held within its tolerance, timed beside the plain
   version, one PyTorch library call and the card's bound for the same
   work. K1-K3 at GPT-2 small's training shape (B=8, N=K=12, S=1024, D=64,
   bf16 and fp32, causal, q/k/v as strided views of the fused qkv
   projection), at the Qwen2.5-7B path's (B=2, N=28, K=4, S=4096, D=128,
   bf16 and fp16, causal with packed segments) and on small cases covering
   GQA, segment ids (also repeating out of order), dropout, non-causal
   Sk != S, a ragged S, D=32 and D=40, rows whose stride is not a multiple
   of 8 elements, and fp16 (bf16 and fp16 run the tensor-core K1-K3, fp32
   their FMA kernels). For K1-K3 at both main shapes it also reports
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
   several documents in every row) and K4/K5 at T=8192, V=32000 (fp32);
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
   path``): phase 6's config cut to 2 layers (1,556,113,920 parameters,
   18.67 GB of params, mu and nu a checkpoint) runs 6 steps uninterrupted,
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

Each path runs with the launch counters reset just before it and read
just after, and must launch each of its kernels exactly as often as its
layers, steps and evals say.

The last lines are the kernels JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``. Each kernel's row carries, under
``paths``, one block per path that runs it: its launches in that run, per
training step and in the no-grad evals, beside the kernel, plain, library
and bound times measured at that path's shape. The row's own ``launches``
and times are those of slice 6's path, the Qwen2.5-7B-width preemption
drill (both children; its shapes are phase 6's). K1-K3's blocks also carry the
measured part of the report above.
"""

from __future__ import annotations

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
        route="cuda", source="hetu_galvatron_tpu_torch/csrc/flash_fwd.cu",
        replaces="hetu_galvatron_tpu/ops/pallas/flash_attention.py:86",
        library_call="torch.nn.functional.scaled_dot_product_attention "
                     "(forward)"),
    "flash_bwd_dkdv": dict(
        route="cuda", source="hetu_galvatron_tpu_torch/csrc/flash_bwd.cu",
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


class SmokeFailure(RuntimeError):
    pass


def log(msg: str = "") -> None:
    print(msg, flush=True)


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
    if dp:
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


def check_case(tag, *, b, n, kv, s, sk, d, dtype, causal, seg, rate,
               seed=7, layout="hmajor"):
    """K1-K3 against their plain versions on one input set; returns the
    per-kernel check records and the inputs for timing."""
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

    o, lse = TF.flash_attention_hmajor(*args, segs, dseed, **kw)
    o_p, lse_p = TF.flash_fwd_plain(*args, segs, dseed, **kw)
    out["flash_fwd"] = [compare(f"{tag} K1 o", o, o_p, tol),
                        compare(f"{tag} K1 lse", lse, lse_p, TOL_LSE,
                                absolute=True)]
    # K2/K3 get identical inputs: the kernel's o/lse and delta
    delta = (doh.float() * o.float()).sum(dim=-1).contiguous()
    bwd = (qh, kh, vh, doh, lse, delta, segs, dseed)
    dk, dv = TF.flash_bwd_dkdv(*bwd, **kw)
    dk_p, dv_p = TF.flash_bwd_dkdv_plain(*bwd, **kw)
    out["flash_bwd_dkdv"] = [compare(f"{tag} K2 dk", dk, dk_p, tol),
                             compare(f"{tag} K2 dv", dv, dv_p, tol)]
    dq = TF.flash_bwd_dq(*bwd, **kw)
    dq_p = TF.flash_bwd_dq_plain(*bwd, **kw)
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


def kept_pairs(b, n, s, segs=None) -> float:
    """(q, k) pairs a causal kernel must compute: every q's earlier keys,
    within its own document when ``segs`` [b, s] packs several."""
    if segs is None:
        return b * n * s * (s + 1) / 2
    import torch

    total = 0
    for row in segs.cpu():
        _, counts = torch.unique_consecutive(row, return_counts=True)
        total += int((counts * (counts + 1) // 2).sum())
    return float(n * total)


def bounds(b, n, kv, s, d, elem, peak_flops, peak_bytes, segs=None):
    """Least time (ms) for each kernel's work at this causal shape: bytes
    moved (each input read once, each output written once) over the memory
    rate, and the tile products over the kept (q, k) pairs (within each
    packed document when ``segs`` is given) over the bf16 tensor-core
    rate; the larger of the two and which one it is."""
    pairs = kept_pairs(b, n, s, segs)
    q_bytes = b * n * s * d * elem
    kv_bytes = b * kv * s * d * elem
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


def time_kernels(case_inputs, reps: int = REPS):
    """Kernel, plain and library times (ms) of K1-K3 on one case's
    inputs."""
    import torch
    import torch.nn.functional as F

    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    args, bwd, segs, dseed, kw = case_inputs
    times = {
        "flash_fwd": (
            time_ms(lambda: TF.flash_attention_hmajor(*args, segs, dseed,
                                                      **kw), reps),
            time_ms(lambda: TF.flash_fwd_plain(*args, segs, dseed, **kw),
                    reps)),
        "flash_bwd_dkdv": (
            time_ms(lambda: TF.flash_bwd_dkdv(*bwd, **kw), reps),
            time_ms(lambda: TF.flash_bwd_dkdv_plain(*bwd, **kw), reps)),
        "flash_bwd_dq": (
            time_ms(lambda: TF.flash_bwd_dq(*bwd, **kw), reps),
            time_ms(lambda: TF.flash_bwd_dq_plain(*bwd, **kw), reps)),
    }
    # the yardstick: PyTorch's own fused attention on the same inputs
    # (timed here only; the port never calls it). GQA k/v are expanded to
    # the q heads and packed documents become a boolean mask before the
    # timed call, so the call computes the kernels' function.
    n = args[0].shape[1]
    qh, kh, vh = (t.detach() for t in args)
    kh, vh = (t.repeat_interleave(n // t.shape[1], dim=1) for t in (kh, vh))
    sdpa = dict(is_causal=True)
    if segs is not None:
        s = qh.shape[2]
        causal = torch.ones(s, s, dtype=torch.bool, device=qh.device).tril()
        sdpa = dict(attn_mask=causal & (segs[:, None, :, None]
                                        == segs[:, None, None, :]))
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, **sdpa), reps)
    ql, kl, vl = (t.clone().requires_grad_(True) for t in (qh, kh, vh))
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, **sdpa)
    do = bwd[3]
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True), reps)
    return times, {"flash_fwd": lib_fwd, "flash_bwd_dkdv": lib_bwd,
                   "flash_bwd_dq": lib_bwd}


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


def ce_inputs(t, v, dtype, *, ld=None, seed=0, scale=2.0):
    """Logits [t, v] (a view of a [t, ld] buffer when ``ld`` > v), labels
    with the first two at -1 and v (out of range: gold 0, no one-hot), the
    third row all equal, and the backward's per-row a, b."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    wide = scale * torch.randn(t, ld or v, device=dev, generator=gen)
    x = wide.to(dtype)[:, :v]
    labels = torch.randint(0, v, (t,), device=dev, generator=gen)
    labels[:2] = torch.tensor([-1, v], device=dev)
    x[2] = 1.5
    a = torch.randn(t, device=dev, generator=gen)
    b = torch.randn(t, device=dev, generator=gen)
    return x, labels, a, b


def check_ce_case(tag, t, v, dtype, *, ld=None, seed=0):
    """K4 and K5 against their plain versions on one input set: gold
    bit-equal, lse within 1e-4 absolute, dlogits elementwise."""
    import math

    from hetu_galvatron_tpu_torch.ops import cross_entropy as TC

    x, labels, a, b = ce_inputs(t, v, dtype, ld=ld, seed=seed)
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



# -- phase 8: checkpoint, resume and the fault lifecycle ---------------------

DRILL_STEPS = 6
QWEN_DRILL_LAYERS = 2
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


def log_times(tag, times, lib, bnd):
    for k, (kms, pms) in times.items():
        log(f"  {tag}: {k:<16} kernel {kms:.3f} ms  plain {pms:.3f} ms  "
            f"library {lib[k]:.3f} ms  bound {bnd[k]['bound_ms']:.4f} ms "
            f"({bnd[k]['bound_by']})")


def flash_report(tag, times, lib, bnd, *, b, s, dtype, segs=None):
    """K1-K3 at one shape: TFLOP/s over the kept pairs, share of the bound,
    K1 against the library forward and K2 + K3 against the library
    backward timed beside them. The log also gives the tiles that the rule
    of ``computed_tiles`` computes at the kernels' tile sizes against the
    tiles of the causal triangle, derived from the rule and not counted in
    the kernels."""
    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    out = {}
    for k, (tq, tk) in TF.tile_sizes(dtype).items():
        ms = times[k][0]
        done = TF.computed_tiles(s, s, tq, tk, causal=True, segments=segs)
        tri = TF.computed_tiles(s, s, tq, tk, causal=True)
        out[k] = dict(tflops=bnd[k]["flops"] / (ms * 1e-3) / 1e12,
                      share_of_bound=bnd[k]["bound_ms"] / ms)
        log(f"  {tag}: {k:<16} {out[k]['tflops']:.1f} TFLOP/s over the kept "
            f"pairs, {100 * out[k]['share_of_bound']:.1f}% of the bound; "
            f"the tile rule computes {int(done.sum()) * (b // done.shape[0])}"
            f" of {int(tri.sum()) * b} causal {tq}x{tk} tiles")
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
                     fp16_ms=None):
    """K1-K3 at a path's attention shape ``(b, n, kv, s, d)`` (bf16,
    causal, packed ``segs``, True for three documents a row, q/k/v as views
    of the fused qkv projection): checked against the plain versions and
    timed beside the fp16 times ``fp16_ms`` when given; the inputs are
    released on return."""
    import torch

    b, n, kv, s, d = shape
    res, inputs = check_case(tag, b=b, n=n, kv=kv, s=s, sk=s, d=d,
                             dtype=torch.bfloat16, causal=True, seg=segs,
                             rate=0.0, layout="fused")
    times, lib = time_kernels(inputs, reps=BIG_REPS)
    bnd = bounds(b, n, kv, s, d, 2, peak_flops, peak_bytes, segs=inputs[2])
    log_times(label, times, lib, bnd)
    report = flash_report(label, times, lib, bnd, b=b, s=s,
                          dtype=torch.bfloat16, segs=inputs[2])
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
                      bytes=bnd[k]["bytes"], shape=tag) for k in times}
    return {"checks": {k: [dict(r, case=tag) for r in recs]
                       for k, recs in res.items()}, "timing": timing,
            "report": report}


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
    ]
    for name_k, recs in slice_res.items():
        checks[name_k] += [dict(r, case="slice bf16") for r in recs]
    for tag, kw in cases:
        res, inputs = check_case(tag, **kw)
        for name_k, recs in res.items():
            checks[name_k] += [dict(r, case=tag) for r in recs]
        if tag == QWEN_FP16:
            # fp16 rounds P (and K2/K3's dS) once where bf16 carries them
            # as hi + lo: the two dtypes' times show what the split costs
            args_h, bwd, segs_h, dseed_h, kw_h = inputs
            fp16_ms = {k: time_ms(lambda fn=getattr(TF, k): fn(*bwd, **kw_h),
                                  BIG_REPS) for k in BWD}
            fp16_ms["flash_fwd"] = time_ms(
                lambda: TF.flash_attention_hmajor(*args_h, segs_h, dseed_h,
                                                  **kw_h), BIG_REPS)
            log(f"  {tag}: K1 {fp16_ms['flash_fwd']:.3f} ms, K2 "
                f"{fp16_ms['flash_bwd_dkdv']:.3f} ms, K3 "
                f"{fp16_ms['flash_bwd_dq']:.3f} ms")
        del inputs
    auto = [dict(r, case=f"slice {tag}") for dtype, tag in
            ((torch.bfloat16, "bf16"), (torch.float32, "fp32"))
            for r in check_autograd(f"slice {tag}", b=B, n=N, s=S, d=D,
                                    dtype=dtype)]
    times, lib = time_kernels(slice_inputs)
    bnd = bounds(B, N, N, S, D, 2, peak_flops, peak_bytes)
    log_times("GPT-2 shape", times, lib, bnd)
    gpt2_rep = flash_report("GPT-2 shape", times, lib, bnd, b=B, s=S,
                            dtype=torch.bfloat16)
    del slice_inputs
    qwen_flash = check_path_flash(
        "Qwen shape", f"qwen B={QB} N={QN} K={QK} S={QS} D={QD} bf16 seg",
        (QB, QN, QK, QS, QD), True, peak_flops, peak_bytes, fp16_ms)
    for name_k, recs in qwen_flash["checks"].items():
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
    tmpdir.cleanup()

    # one block per path that runs the kernel: its launches beside the
    # times measured at that path's shape; the row's own keys are those of
    # this slice's path (the Qwen2.5-7B-width preemption drill, whose
    # shapes are phase 6's)
    qwen_name = f"qwen2.5-7b-{QWEN_LAYERS}-layers"
    mixtral_name = f"mixtral-8x7b-{MIXTRAL_LAYERS}-layers"
    drill_name = f"qwen2.5-7b-{QWEN_DRILL_LAYERS}-layers-preemption-drill"
    gpt2_drill_name = "gpt2-small-kill-mid-save-drill"
    qwen_drill_launches = dict(
        launches=qwen_drill_run["launches_total"],
        launches_per_step=qwen_drill_run["launches_per_step"],
        eval_launches=qwen_drill_run["eval_launches"])

    def max_err(k, case, kinds=("elementwise", "abs", "exact")):
        return max(c["max_abs_err"] for c in checks[k]
                   if c["case"] == case and c["tol_kind"] in kinds)

    def block(k, run, timing, err, shape):
        return dict(launches=run["launches"][k],
                    launches_per_step=run["launches_per_step"][k],
                    eval_launches=run["eval_launches"][k],
                    max_abs_err=err, ms=timing["ms"],
                    plain_ms=timing["plain_ms"],
                    library_ms=timing["library_ms"],
                    bound_ms=timing["bound_ms"], bound_by=timing["bound_by"],
                    flops=timing["flops"], bytes=timing["bytes"], shape=shape)

    rows = []
    for k, meta in KERNELS.items():
        paths = {}
        if k in FLASH:
            gpt2_timing = dict(ms=times[k][0], plain_ms=times[k][1],
                               library_ms=lib[k], **bnd[k])
            paths["gpt2-small"] = block(
                k, gpt2, gpt2_timing,
                max_err(k, "slice bf16", ("elementwise",)),
                f"B={B} N=K={N} S={S} D={D} bf16 causal")
            paths[gpt2_drill_name] = block(
                k, gpt2_drill_run, gpt2_timing,
                max_err(k, "slice bf16", ("elementwise",)),
                f"B={B} N=K={N} S={S} D={D} bf16 causal")
            for path, run, res in ((qwen_name, qwen, qwen_flash),
                                   (mixtral_name, mixtral, mixtral_flash),
                                   (drill_name, qwen_drill_launches,
                                    qwen_flash)):
                timing = res["timing"][k]
                paths[path] = block(
                    k, run, timing,
                    max_err(k, timing["shape"], ("elementwise",)),
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
            tol_rule = ("every element: |got - want| <= tol * (rms(want) + "
                        "|want|); 1e-4 in fp32, 1e-3 absolute on lse")
            tol, extra = TOL_16, {}
        else:
            paths[qwen_name] = block(
                k, qwen, ce["timing"]["fp32"][k],
                max_err(k, "qwen fp32"),
                f"T={QT} V={QV} fp32 logits (the path's dtype)")
            paths[mixtral_name] = block(
                k, mixtral, ce["timing"]["mixtral fp32"][k],
                max_err(k, "mixtral fp32"),
                f"T={MT} V={MV} fp32 logits (the path's dtype)")
            paths[drill_name] = block(
                k, qwen_drill_launches, ce["timing"]["fp32"][k],
                max_err(k, "qwen fp32"),
                f"T={QT} V={QV} fp32 logits (the path's dtype)")
            tol_rule = ("gold bit-equal, lse within 1e-4 absolute, dlogits "
                        "every element within tol * (rms(want) + |want|): "
                        "1e-4 in fp32, 2e-2 in bf16/fp16")
            tol, extra = TOL_FP32, {"bf16": ce["timing"]["bf16"][k]}
        row = dict(name=k, route=meta["route"], source=meta["source"],
                   replaces=meta["replaces"],
                   library_call=meta["library_call"], **paths[drill_name],
                   tol=tol, tol_rule=tol_rule, paths=paths, **extra)
        row["checks"] = checks[k]
        rows.append(row)
    rows[0]["autograd_checks"] = auto
    rows[3]["autograd_checks"] = ce["zloss"]
    log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
