"""Flash attention for the H100: forward (K1) and backward (K2, K3) kernels.

Counterpart of ``hetu_galvatron_tpu/ops/pallas/flash_attention.py``. The
kernels are hand-written CUDA C++ (``csrc/flash_fwd.cu``,
``csrc/flash_bwd.cu``), built by :mod:`._build` at first use. Each has a
plain PyTorch version here that computes the same function densely; the
wrappers run the plain version only for tensors on the CPU, and for a CUDA
tensor launch the kernel or raise.

Layout: the ``*_hmajor`` functions take q ``[B, N, S, D]`` and k/v
``[B, K, Sk, D]`` (logical shapes; any strides with a unit stride along D,
so transposed views of ``[B, S, N, D]`` arrays cost no copy); GQA maps
q-head n to kv-head ``n // (N // K)``. :func:`flash_sdpa` is the drop-in
``sdpa_fn`` with the ``[B, S, N, D]`` layout of ``models.modules``.

Unlike the Pallas kernels the CUDA kernels mask a ragged tail, so any S
runs and there is no dense fallback for untileable lengths.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from hetu_galvatron_tpu_torch.ops import _build

NEG_INF = float(torch.finfo(torch.float32).min)
MAX_HEAD_DIM = 128
_U32 = 0xFFFFFFFF

# kernel launches per wrapper since the last reset (compare launches made
# by chip_smoke.py's checks are excluded by resetting before the main path)
launch_counts: Dict[str, int] = {"flash_fwd": 0, "flash_bwd_dkdv": 0,
                                 "flash_bwd_dq": 0}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


# ---------------------------------------------------------------------------
# dropout keep-mask (bit-exact with the JAX keep_mask)
# ---------------------------------------------------------------------------


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), without int64 overflow:
    the constant is split into 16-bit halves so each product stays < 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _U32


def _fin(x: torch.Tensor) -> torch.Tensor:  # splitmix32 finalizer
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul_u32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def keep_threshold(rate: float) -> int:
    return min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)


def keep_mask(seed, bn, qpos, kpos, rate: float) -> torch.Tensor:
    """Counter-based dropout keep-mask over global coordinates (seed,
    batch*heads index, q position, k position): the splitmix32 chain of the
    JAX ``keep_mask``, in int64 arithmetic masked to 32 bits, so both give
    the same bits. ``seed`` is an int (int32 values wrap like ``astype
    (uint32)``); bn/qpos/kpos are integer tensors broadcastable to the mask
    shape. Returns bool (True = keep)."""
    def u32(x):
        if isinstance(x, torch.Tensor):
            return x.to(torch.int64) & _U32
        return torch.tensor(int(x) & _U32, dtype=torch.int64)

    key = _fin((_mul_u32(u32(seed), 0x9E3779B9) + u32(bn)) & _U32)
    x = _fin(_fin(u32(qpos) ^ key) ^ u32(kpos))
    return x < keep_threshold(rate)


def _keep_grid(seed, B, N, S, Sk, rate, device):
    bn = (torch.arange(B, device=device)[:, None] * N
          + torch.arange(N, device=device)[None, :])[:, :, None, None]
    qpos = torch.arange(S, device=device)[None, None, :, None]
    kpos = torch.arange(Sk, device=device)[None, None, None, :]
    return keep_mask(seed, bn, qpos, kpos, rate)


# ---------------------------------------------------------------------------
# plain versions of K1-K3 (dense, fp32; any device)
# ---------------------------------------------------------------------------


def _allowed(B, S, Sk, causal, segments, device):
    """[B|1, 1, S, Sk] bool mask of attended (q, k) pairs."""
    ok = torch.ones((1, 1, S, Sk), dtype=torch.bool, device=device)
    if causal:
        ok = ok & (torch.arange(S, device=device)[:, None]
                   >= torch.arange(Sk, device=device)[None, :])
    if segments is not None:
        seg = segments.to(device)
        ok = ok & (seg[:, None, :, None] == seg[:, None, None, :])
    return ok


def _expand_kv(x: torch.Tensor, N: int) -> torch.Tensor:
    return x.float().repeat_interleave(N // x.shape[1], dim=1)


def flash_fwd_plain(q, k, v, segments=None, dropout_seed=None, *,
                    causal=True, dropout_rate=0.0):
    """Plain K1: (o [B,N,S,D] in q's dtype, lse [B,N,S] fp32)."""
    B, N, S, D = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    ok = _allowed(B, S, Sk, causal, segments, q.device)
    s = torch.matmul(q.float() * scale, _expand_kv(k, N).transpose(-1, -2))
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(ok, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-20)
    if dropout_rate > 0.0:
        keep = _keep_grid(dropout_seed, B, N, S, Sk, dropout_rate, q.device)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    o = torch.matmul(p, _expand_kv(v, N)) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def _bwd_p_ds(q, k, v, do, lse, delta, segments, dropout_seed, causal,
              dropout_rate):
    B, N, S, D = q.shape
    Sk = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    ok = _allowed(B, S, Sk, causal, segments, q.device)
    s = torch.matmul(q.float(), _expand_kv(k, N).transpose(-1, -2)) * scale
    p = torch.where(ok, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.float(), _expand_kv(v, N).transpose(-1, -2))
    pd = p
    if dropout_rate > 0.0:
        keep = _keep_grid(dropout_seed, B, N, S, Sk, dropout_rate, q.device)
        pd = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
        dp = torch.where(keep, dp / (1.0 - dropout_rate), 0.0)
    return pd, p * (dp - delta[..., None]) * scale


def flash_bwd_dkdv_plain(q, k, v, do, lse, delta, segments=None,
                         dropout_seed=None, *, causal=True,
                         dropout_rate=0.0):
    """Plain K2: (dk, dv) [B,K,Sk,D] in k's/v's dtypes."""
    B, N = q.shape[:2]
    K, Sk, D = k.shape[1:]
    pd, ds = _bwd_p_ds(q, k, v, do, lse, delta, segments, dropout_seed,
                       causal, dropout_rate)
    dv = torch.matmul(pd.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    dk = dk.view(B, K, N // K, Sk, D).sum(dim=2)
    dv = dv.view(B, K, N // K, Sk, D).sum(dim=2)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, segments=None,
                       dropout_seed=None, *, causal=True, dropout_rate=0.0):
    """Plain K3: dq [B,N,S,D] in q's dtype."""
    _, ds = _bwd_p_ds(q, k, v, do, lse, delta, segments, dropout_seed,
                      causal, dropout_rate)
    return torch.matmul(ds, _expand_kv(k, q.shape[1])).to(q.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(q, k, v, segments, dropout_seed, causal, dropout_rate):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash attention takes rank-4 q/k/v")
    B, N, S, D = q.shape
    Bk, K, Sk, Dk = k.shape
    if (Bk, Dk) != (B, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} / k {tuple(k.shape)} / v "
                         f"{tuple(v.shape)} do not match")
    if N % K:
        raise ValueError(f"{N} q heads do not divide into {K} kv heads")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {D} > {MAX_HEAD_DIM} is not supported "
                         "by the flash kernels")
    if causal and Sk != S:
        raise ValueError("causal flash needs equal q/k lengths")
    if segments is not None and Sk != S:
        raise ValueError("segment masking needs equal q/k lengths")
    if segments is not None and tuple(segments.shape) != (B, S):
        raise ValueError(f"segment ids {tuple(segments.shape)} must be "
                         f"[B, S] = {(B, S)}")
    if dropout_rate > 0.0 and dropout_seed is None:
        raise ValueError("dropout_rate > 0 needs a dropout_seed")
    if not (q.device == k.device == v.device):
        raise ValueError("q/k/v must be on one device")


def _on_cuda(name: str, *tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); anything else raises."""
    dev = tensors[0].device.type
    if dev == "cpu":
        return False
    if dev != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t in tensors:
        if t.dtype != tensors[0].dtype:
            raise ValueError(f"{name}: mixed dtypes {t.dtype} and "
                             f"{tensors[0].dtype}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: operands need a unit stride along D")
    if str(tensors[0].dtype) not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: no kernel for dtype {tensors[0].dtype}")
    return True


def _launch(name, inputs, outputs, segments, dropout_seed, *, causal,
            dropout_rate):
    """Launch ``galv_<name>`` (csrc/*.cu) on the current stream: the
    pointers of ``inputs``, the segment ids, the pointers of ``outputs``,
    dims, the (batch, head, position) strides of every rank-4 operand in
    that order, then the scalars. Raises when the launch is refused."""
    q, k = inputs[0], inputs[1]
    B, N, S, D = q.shape
    K, Sk = k.shape[1:3]
    seg = (None if segments is None else
           segments.to(device=q.device, dtype=torch.int32).contiguous())
    strides = [st for t in (*inputs, *outputs) if t.dim() == 4
               for st in t.stride()[:3]]
    if dropout_rate > 0.0:
        drop = (1, int(dropout_seed) & _U32, keep_threshold(dropout_rate),
                1.0 - dropout_rate)
    else:
        drop = (0, 0, 0, 1.0)
    fn = getattr(_build.load_library(), "galv_" + name)
    with torch.cuda.device(q.device):
        code = fn(_build.DTYPE_CODES[str(q.dtype)],
                  *(t.data_ptr() for t in inputs),
                  None if seg is None else seg.data_ptr(),
                  *(t.data_ptr() for t in outputs),
                  _build.int64_array((B, N, K, S, Sk, D)),
                  _build.int64_array(strides), int(causal),
                  1.0 / math.sqrt(D), *drop,
                  torch.cuda.current_stream(q.device).cuda_stream)
    # ``seg`` may be freed now: the caching allocator reuses its memory
    # only after the work enqueued on this stream
    _build.check_launch(name, code)
    launch_counts[name] += 1


def flash_attention_hmajor(q, k, v, segments=None, dropout_seed=None, *,
                           causal: bool = True, dropout_rate: float = 0.0):
    """K1: q [B,N,S,D], k/v [B,K,Sk,D] -> (o [B,N,S,D], lse [B,N,S] fp32).
    ``segments`` [B, S] int masks cross-document pairs; ``dropout_seed``
    (int) drives the in-kernel counter-based dropout."""
    _check(q, k, v, segments, dropout_seed, causal, dropout_rate)
    kw = dict(causal=causal, dropout_rate=dropout_rate)
    if not _on_cuda("flash_fwd", q, k, v):
        return flash_fwd_plain(q, k, v, segments, dropout_seed, **kw)
    B, N, S, D = q.shape
    # o laid out [B, S, N, D] so the [B, S, N, D] seam needs no copy
    o = torch.empty((B, S, N, D), dtype=q.dtype,
                    device=q.device).transpose(1, 2)
    lse = torch.empty((B, N, S), dtype=torch.float32, device=q.device)
    _launch("flash_fwd", (q, k, v), (o, lse), segments, dropout_seed, **kw)
    return o, lse


def flash_bwd_dkdv(q, k, v, do, lse, delta, segments=None, dropout_seed=None,
                   *, causal: bool = True, dropout_rate: float = 0.0):
    """K2: (dk, dv) [B,K,Sk,D] from q/do [B,N,S,D], k/v, and fp32 lse and
    delta [B,N,S] (contiguous)."""
    _check(q, k, v, segments, dropout_seed, causal, dropout_rate)
    kw = dict(causal=causal, dropout_rate=dropout_rate)
    if not _on_cuda("flash_bwd_dkdv", q, k, v, do):
        return flash_bwd_dkdv_plain(q, k, v, do, lse, delta, segments,
                                    dropout_seed, **kw)
    _check_rows(lse, delta, q)
    B, K, Sk, D = k.shape
    dk = torch.empty((B, Sk, K, D), dtype=k.dtype,
                     device=q.device).transpose(1, 2)
    dv = torch.empty_like(dk)
    _launch("flash_bwd_dkdv", (q, k, v, do, lse, delta), (dk, dv), segments,
            dropout_seed, **kw)
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, segments=None, dropout_seed=None,
                 *, causal: bool = True, dropout_rate: float = 0.0):
    """K3: dq [B,N,S,D], same inputs as :func:`flash_bwd_dkdv`."""
    _check(q, k, v, segments, dropout_seed, causal, dropout_rate)
    kw = dict(causal=causal, dropout_rate=dropout_rate)
    if not _on_cuda("flash_bwd_dq", q, k, v, do):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, segments,
                                  dropout_seed, **kw)
    _check_rows(lse, delta, q)
    B, N, S, D = q.shape
    dq = torch.empty((B, S, N, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    _launch("flash_bwd_dq", (q, k, v, do, lse, delta), (dq,), segments,
            dropout_seed, **kw)
    return dq


def _check_rows(lse, delta, q):
    want = (q.shape[0], q.shape[1], q.shape[2])
    for name, t in (("lse", lse), ("delta", delta)):
        if (tuple(t.shape) != want or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be a contiguous fp32 {want} "
                             f"tensor on {q.device}")


def flash_attention_bwd_hmajor(q, k, v, o, lse, do, segments=None,
                               dropout_seed=None, *, causal: bool = True,
                               dropout_rate: float = 0.0):
    """K2 + K3 against a caller-supplied (o, lse): returns (dq, dk, dv).
    ``delta = rowsum(dO * O)`` is computed here in fp32, outside the
    kernels, as in the JAX entry point."""
    delta = (do.float() * o.float()).sum(dim=-1).contiguous()
    lse = lse.float().contiguous()
    kw = dict(causal=causal, dropout_rate=dropout_rate)
    dk, dv = flash_bwd_dkdv(q, k, v, do, lse, delta, segments, dropout_seed,
                            **kw)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, segments, dropout_seed, **kw)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """[B, S, N, D] in and out; forward K1, backward K2 + K3 against the
    saved (o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, segments, dropout_seed, causal, dropout_rate):
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        o, lse = flash_attention_hmajor(qh, kh, vh, segments, dropout_seed,
                                        causal=causal,
                                        dropout_rate=dropout_rate)
        ctx.save_for_backward(q, k, v, o, lse, segments)
        ctx.dropout_seed, ctx.causal = dropout_seed, causal
        ctx.dropout_rate = dropout_rate
        return o.transpose(1, 2)

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse, segments = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_hmajor(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), o, lse,
            g.contiguous().transpose(1, 2), segments, ctx.dropout_seed,
            causal=ctx.causal, dropout_rate=ctx.dropout_rate)
        return (dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2),
                None, None, None, None)


def seed_from_generator(rng: torch.Generator) -> int:
    """Draw the int32 seed the counter-based mask consumes."""
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=rng,
                             device=rng.device).item())


def flash_sdpa(q, k, v, *, causal: bool = True, segment_ids=None,
               dropout_rate: float = 0.0,
               dropout_rng: Optional[torch.Generator] = None,
               dropout_seed: Optional[int] = None):
    """Drop-in ``sdpa_fn`` for ``models.modules.apply_attention``:
    ``[B, S, N, D]`` q and ``[B, Sk, K, D]`` k/v in, ``[B, S, N, D]`` out,
    differentiable through the K2/K3 kernels. ``segment_ids`` [B, S] masks
    packed documents in-kernel. ``dropout_rate > 0`` applies attention
    dropout in-kernel from ``dropout_seed`` (an int) or a seed drawn from
    ``dropout_rng`` (a ``torch.Generator``)."""
    seed = None
    if dropout_rate > 0.0:
        if dropout_seed is None:
            if dropout_rng is None:
                raise ValueError("flash dropout_rate > 0 needs dropout_rng")
            dropout_seed = seed_from_generator(dropout_rng)
        seed = int(dropout_seed)
    return _FlashAttention.apply(q, k, v, segment_ids, seed, causal,
                                 float(dropout_rate))


# the fwd + both bwd kernels mask cross-document pairs in-kernel
flash_sdpa.supports_segments = True
# in-kernel counter-based attention dropout (fwd + bwd regenerate the mask)
flash_sdpa.supports_dropout = True
