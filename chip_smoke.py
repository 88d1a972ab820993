"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of the repository. It needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and imports nothing of JAX or of the JAX package. Phases,
each of which ends the run with a non-zero exit when it fails:

1. device: the card's name and power limit (``nvidia-smi``) and CUDA version;
2. build: compile the flash-attention kernels K1-K3 from
   ``hetu_galvatron_tpu_torch/csrc`` with ``nvcc`` for ``sm_90a``;
3. kernels: each kernel against its plain PyTorch version on the same
   inputs, at the training shape (GPT-2 small: B=8, N=K=12, S=1024, D=64,
   bf16 and fp32, causal, q/k/v as strided views of the fused qkv
   projection) and on small cases covering GQA, segment ids, dropout,
   non-causal Sk != S, a ragged S and fp16; every element held within its
   tolerance; timed beside the plain version, one PyTorch library call and
   the card's bound for the same work;
4. reference: a small model trained a few steps through the flash kernels
   agrees with the same run through the plain attention core;
5. main path: ``hetu_galvatron_tpu_torch.cli.train_dist.train`` on
   ``gpt2-small.yaml`` at full width and depth (bsz 8, seq 1024, bf16) with
   the launch counters reset just before it and read just after.

The last lines are the kernels JSON line, the ``nvidia-smi`` line and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GPT2_YAML = os.path.join(ROOT, "hetu_galvatron_tpu", "models", "configs",
                         "gpt2-small.yaml")
# the slice's training shape (GPT-2 small at bsz 8)
B, N, S, D = 8, 12, 1024, 64
TRAIN_ITERS = 8
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
TOL_LSE = 1e-3  # absolute, on the fp32 logsumexp

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
        route="cuda", source="hetu_galvatron_tpu_torch/csrc/flash_bwd.cu",
        replaces="hetu_galvatron_tpu/ops/pallas/flash_attention.py:324",
        library_call="scaled_dot_product_attention backward (dq, dk and dv "
                     "in one call: the yardstick of K2 + K3 together)"),
}


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


def segments_for(batch: int, s: int, dev):
    import torch

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
    else:
        qh, kh, vh = rnd(b, n, s, d), rnd(b, kv, sk, d), rnd(b, kv, sk, d)
        doh = rnd(b, n, s, d)
    segs = segments_for(b, s, dev) if seg else None
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


def bounds(b, n, kv, s, d, elem, peak_flops, peak_bytes):
    """Least time (ms) for each kernel's work at this causal shape: bytes
    moved (each input read once, each output written once) over the memory
    rate, and the tile products over the kept (q, k) pairs over the bf16
    tensor-core rate; the larger of the two and which one it is."""
    pairs = b * n * s * (s + 1) / 2  # causal: kept (q, k) pairs
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


def time_kernels(case_inputs):
    """Kernel, plain and library times (ms) at the training shape."""
    import torch
    import torch.nn.functional as F

    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    args, bwd, segs, dseed, kw = case_inputs
    times = {
        "flash_fwd": (
            time_ms(lambda: TF.flash_attention_hmajor(*args, segs, dseed,
                                                      **kw)),
            time_ms(lambda: TF.flash_fwd_plain(*args, segs, dseed, **kw))),
        "flash_bwd_dkdv": (
            time_ms(lambda: TF.flash_bwd_dkdv(*bwd, **kw)),
            time_ms(lambda: TF.flash_bwd_dkdv_plain(*bwd, **kw))),
        "flash_bwd_dq": (
            time_ms(lambda: TF.flash_bwd_dq(*bwd, **kw)),
            time_ms(lambda: TF.flash_bwd_dq_plain(*bwd, **kw))),
    }
    # the yardstick: PyTorch's own fused attention on the same inputs
    # (timed here only; the port never calls it)
    qh, kh, vh = (t.detach() for t in args)
    lib_fwd = time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, is_causal=True))
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in args)
    lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
    do = bwd[3]
    lib_bwd = time_ms(lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), do, retain_graph=True))
    return times, {"flash_fwd": lib_fwd, "flash_bwd_dkdv": lib_bwd,
                   "flash_bwd_dq": lib_bwd}


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


def main_path(peak_flops: float):
    """GPT-2 small training through the port's train_dist, launch counts
    reset just before and read just after."""
    import torch

    from hetu_galvatron_tpu_torch.cli.train_dist import train
    from hetu_galvatron_tpu_torch.core.arguments import load_config
    from hetu_galvatron_tpu_torch.models.builder import model_flops_per_token
    from hetu_galvatron_tpu_torch.ops import flash_attention as TF

    args = load_config(GPT2_YAML, [
        "parallel.global_train_batch_size=8",
        "parallel.mixed_precision=bf16", f"train.train_iters={TRAIN_ITERS}",
        "profile.profile=1", f"profile.profile_warmup={PROFILE_WARMUP}"])
    cfg = args.model
    TF.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(TF.launch_counts)
    losses = out["losses"]
    log(f"  losses {losses}")
    if len(losses) != TRAIN_ITERS or not all(map(math.isfinite, losses)):
        raise SmokeFailure(f"losses not all finite: {losses}")
    ln_v = math.log(cfg.padded_vocab_size)
    if abs(losses[0] - ln_v) > 0.5:
        raise SmokeFailure(f"step-0 loss {losses[0]:.4f} is not within 0.5 "
                           f"of ln({cfg.padded_vocab_size}) = {ln_v:.4f}")
    want = cfg.num_hidden_layers * TRAIN_ITERS
    log(f"  launches {launches} (want {want} each: "
        f"{cfg.num_hidden_layers} layers x {TRAIN_ITERS} steps)")
    for name, count in launches.items():
        if count != want:
            raise SmokeFailure(f"{name} launched {count} times, want {want}")
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
        losses=losses, launches=launches)
    log(f"  step {step_ms:.2f} ms (mean of steps {PROFILE_WARMUP}.."
        f"{TRAIN_ITERS - 1}, CUDA events), {tok_s:.0f} tokens/s, MFU "
        f"{100 * mfu:.2f}% of {peak_flops / 1e12:.0f} TFLOP/s "
        f"({fpt / 1e9:.3f} GFLOP/token)")
    log("main path: " + json.dumps(summary))
    return summary


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
    with open(os.path.join(_build.BUILD_DIR, "build.log")) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                log("  ptxas " + line.strip())

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
    ]
    for name_k, recs in slice_res.items():
        checks[name_k] += [dict(r, case="slice bf16") for r in recs]
    for tag, kw in cases:
        res, _ = check_case(tag, **kw)
        for name_k, recs in res.items():
            checks[name_k] += [dict(r, case=tag) for r in recs]
    auto = [dict(r, case=f"slice {tag}") for dtype, tag in
            ((torch.bfloat16, "bf16"), (torch.float32, "fp32"))
            for r in check_autograd(f"slice {tag}", b=B, n=N, s=S, d=D,
                                    dtype=dtype)]
    times, lib = time_kernels(slice_inputs)
    bnd = bounds(B, N, N, S, D, 2, peak_flops, peak_bytes)
    for k, (kms, pms) in times.items():
        log(f"  {k:<16} kernel {kms:.3f} ms  plain {pms:.3f} ms  library "
            f"{lib[k]:.3f} ms  bound {bnd[k]['bound_ms']:.4f} ms "
            f"({bnd[k]['bound_by']})")

    phase("phase 4: reference run (flash against the plain core)")
    reference_run()

    phase("phase 5: main path (train_dist, GPT-2 small)")
    summary = main_path(peak_flops)

    rows = []
    for k, meta in KERNELS.items():
        slice_checks = [c for c in checks[k] if c["case"] == "slice bf16"]
        rows.append(dict(
            name=k, route=meta["route"], source=meta["source"],
            replaces=meta["replaces"], launches=summary["launches"][k],
            launches_per_step=summary["launches"][k] / TRAIN_ITERS,
            max_abs_err=max(c["max_abs_err"] for c in slice_checks
                            if c["tol_kind"] == "elementwise"),
            rel_err=max(c["rel_err"] for c in slice_checks
                        if c["rel_err"] is not None),
            err_over_rms=max(c["err_over_rms"] for c in slice_checks
                             if c["err_over_rms"] is not None),
            tol=TOL_16, tol_rule="every element: |got - want| <= tol * "
            "(rms(want) + |want|); 1e-4 in fp32, 1e-3 absolute on lse",
            ms=times[k][0], plain_ms=times[k][1],
            bound_ms=bnd[k]["bound_ms"], bound_by=bnd[k]["bound_by"],
            flops=bnd[k]["flops"], bytes=bnd[k]["bytes"],
            library_ms=lib[k], library_call=meta["library_call"],
            shape=f"B={B} N=K={N} S={S} D={D} bf16 causal",
            checks=checks[k]))
    rows[0]["autograd_checks"] = auto
    log(f"\ndone in {time.perf_counter() - t_all:.1f} s")
    log(json.dumps({"kernels": rows}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
