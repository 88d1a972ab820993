"""Fused cross-entropy for the H100: forward (K4) and backward (K5) kernels.

Counterpart of ``hetu_galvatron_tpu/ops/pallas/cross_entropy.py``. K4
(``csrc/ce_fwd.cu``) computes each row's logsumexp online over the
vocabulary and gathers the gold logit; K5 (``csrc/ce_bwd.cu``) emits
``dlogits = exp(x - lse) * a - onehot(label) * b`` in the logits dtype.
:class:`_CELseGold` wraps them as one differentiable ``(lse, gold)`` and
:func:`fused_ce_nll` builds the per-token NLL (plus ``z * lse**2``) on top in
plain torch, so autograd folds the z-loss into ``d_lse`` as the JAX
``custom_vjp`` does. Each kernel has a plain version here; the wrappers run
it only for tensors on the CPU, and for a CUDA tensor launch the kernel or
raise.

Unlike the Pallas kernels, which need T and V to tile and return ``None``
otherwise, the CUDA kernels take any T and V (and a row stride larger than
V), so there is no "untileable" answer. Labels outside ``[0, V)`` gather 0
and put no one-hot into K5, as ``vpos == lab`` does in JAX: that is how the
vocab shards feed them. :func:`make_vocab_parallel_ce` (JAX :208-275) runs
K4 on a rank's ``[T, V / vtp]`` logits with the labels offset by its
shard, merges the lse over the vocab group (a max all-reduce of the
local lse, then a sum all-reduce of ``exp(lse - m)``) and sums the gold;
its backward is K5 on the local logits against the merged lse. No kernel
of its own: K4/K5 take the shard as they are.
"""

from __future__ import annotations

import torch

from hetu_galvatron_tpu_torch.ops import _build


# ---------------------------------------------------------------------------
# plain versions of K4/K5 (dense, fp32 compute; any device)
# ---------------------------------------------------------------------------


def _in_range(labels: torch.Tensor, V: int) -> torch.Tensor:
    return (labels >= 0) & (labels < V)


def ce_fwd_plain(logits: torch.Tensor, labels: torch.Tensor):
    """Plain K4: logits [T, V], labels [T] -> (lse, gold) [T] fp32, with
    the JAX kernel's clamp ``lse = m + log(max(l, 1e-30))``."""
    x = logits.float()
    V = x.shape[-1]
    m = x.amax(dim=-1)
    l = torch.exp(x - m[:, None]).sum(dim=-1)
    lse = m + torch.log(l.clamp_min(1e-30))
    ok = _in_range(labels, V)
    idx = torch.where(ok, labels, 0).long()
    gold = torch.gather(x, -1, idx[:, None])[:, 0]
    return lse, torch.where(ok, gold, 0.0)


def ce_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Plain K5: ``exp(x - lse) * a - onehot(label) * b`` per row, in the
    logits dtype."""
    x = logits.float()
    V = x.shape[-1]
    onehot = (torch.arange(V, device=x.device)[None, :]
              == labels[:, None].long())
    dx = torch.exp(x - lse[:, None]) * a[:, None] - torch.where(
        onehot, b[:, None], 0.0)
    return dx.to(logits.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 2:
        raise ValueError(f"fused CE takes [T, V] logits, got "
                         f"{tuple(logits.shape)}")
    if labels.shape != logits.shape[:1]:
        raise ValueError(f"labels {tuple(labels.shape)} must be [T] = "
                         f"{tuple(logits.shape[:1])}")
    if labels.device != logits.device:
        raise ValueError("logits and labels must be on one device")


def _on_cuda(name: str, logits: torch.Tensor) -> bool:
    """True for CUDA logits (launch the kernel), False for CPU logits
    (plain version); anything else raises."""
    dev = logits.device.type
    if dev == "cpu":
        return False
    if dev != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if str(logits.dtype) not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: no kernel for dtype {logits.dtype}")
    if logits.stride(-1) != 1 or logits.stride(0) < logits.shape[1]:
        raise ValueError(f"{name}: logits need a unit stride along V and a "
                         f"row stride >= V, got strides {logits.stride()}")
    return True


def _check_rows(name: str, logits: torch.Tensor, **rows) -> None:
    for key, t in rows.items():
        if (tuple(t.shape) != tuple(logits.shape[:1])
                or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != logits.device):
            raise ValueError(f"{name}: {key} must be a contiguous fp32 "
                             f"[{logits.shape[0]}] tensor on {logits.device}")


def _labels64(labels: torch.Tensor) -> torch.Tensor:
    return labels.to(torch.int64).contiguous()


def _launch(name: str, logits: torch.Tensor, *ptrs, dims) -> None:
    fn = getattr(_build.load_library(), "galv_" + name)
    with torch.cuda.device(logits.device):
        code = fn(_build.DTYPE_CODES[str(logits.dtype)], *ptrs, *dims,
                  torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check_launch(name, code)


def ce_fwd(logits: torch.Tensor, labels: torch.Tensor):
    """K4: logits [T, V] (any float dtype, unit stride along V), labels [T]
    -> (lse, gold) [T] fp32."""
    _check(logits, labels)
    if not _on_cuda("ce_fwd", logits):
        return ce_fwd_plain(logits, labels)
    T, V = logits.shape
    lse = torch.empty(T, dtype=torch.float32, device=logits.device)
    gold = torch.empty_like(lse)
    if T == 0:
        return lse, gold
    lab = _labels64(labels)
    _launch("ce_fwd", logits, logits.data_ptr(), lab.data_ptr(),
            lse.data_ptr(), gold.data_ptr(),
            dims=(T, V, logits.stride(0)))
    return lse, gold


def ce_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
           a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K5: dlogits [T, V] (contiguous, logits dtype) from logits, labels and
    fp32 lse, a, b [T] (contiguous)."""
    _check(logits, labels)
    if not _on_cuda("ce_bwd", logits):
        return ce_bwd_plain(logits, labels, lse, a, b)
    _check_rows("ce_bwd", logits, lse=lse, a=a, b=b)
    T, V = logits.shape
    dx = torch.empty((T, V), dtype=logits.dtype, device=logits.device)
    if T == 0:
        return dx
    lab = _labels64(labels)
    _launch("ce_bwd", logits, logits.data_ptr(), lab.data_ptr(),
            lse.data_ptr(), a.data_ptr(), b.data_ptr(), dx.data_ptr(),
            dims=(T, V, logits.stride(0), dx.stride(0)))
    return dx


class _CELseGold(torch.autograd.Function):
    """Differentiable ``(lse, gold)`` [T] fp32 over [T, V] logits: forward
    K4, backward K5 with ``a = d_lse`` and ``b = -d_gold`` (JAX
    ``_ce_lse_gold`` and its ``custom_vjp`` rules)."""

    @staticmethod
    def forward(ctx, logits, labels):
        lse, gold = ce_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return lse, gold

    @staticmethod
    def backward(ctx, d_lse, d_gold):
        # autograd materialises an unused output's gradient as zeros
        logits, labels, lse = ctx.saved_tensors
        return ce_bwd(logits, labels, lse, d_lse.float().contiguous(),
                      (-d_gold.float()).contiguous()), None


def fused_ce_nll(logits: torch.Tensor, labels: torch.Tensor, *,
                 z_loss: float = 0.0) -> torch.Tensor:
    """Per-token NLL ``lse - gold (+ z * lse**2)`` through K4/K5; logits
    [..., V], labels matching the leading dims; returns fp32 [...]."""
    V = logits.shape[-1]
    lead = logits.shape[:-1]
    lse, gold = _CELseGold.apply(logits.reshape(-1, V), labels.reshape(-1))
    nll = lse - gold
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll.reshape(lead)


class _VocabParallelLseGold(torch.autograd.Function):
    """``(lse, gold)`` [T] over the vocabulary split across ``group``: K4
    (or its plain version, ``kernels``) on this rank's ``[T, V_l]``
    columns, the lse merged and the gold summed over the group. The
    function holds the merged lse: its backward is K5 on the local
    logits against it, with ``a = d_lse`` and ``b = -d_gold``, which is
    this shard's part of the whole vocabulary's dlogits. The merged
    values are equal on every rank of the group and so are their
    gradients, which the backward therefore takes as they come."""

    @staticmethod
    def forward(ctx, logits, labels, group, kernels):
        from hetu_galvatron_tpu_torch.parallel.comm import all_reduce

        fwd, bwd = kernels
        lse_l, gold_l = fwd(logits, labels)
        m = all_reduce(lse_l, group, op="max")
        lse = m + torch.log(all_reduce(torch.exp(lse_l - m), group))
        gold = all_reduce(gold_l, group)
        ctx.save_for_backward(logits, labels, lse)
        ctx.bwd = bwd
        return lse, gold

    @staticmethod
    def backward(ctx, d_lse, d_gold):
        logits, labels, lse = ctx.saved_tensors
        return ctx.bwd(logits, labels, lse, d_lse.float().contiguous(),
                       (-d_gold.float()).contiguous()), None, None, None


def make_vocab_parallel_ce(group, *, fused: bool = True,
                           z_loss: float = 0.0):
    """Vocab-parallel per-token NLL over logits whose vocabulary is split
    across ``group`` (a ``runtime/mesh.Group``; rank i holds columns
    ``[i V_l, (i + 1) V_l)``), JAX ``make_vocab_parallel_ce``. Returns
    ``nll_fn(logits [..., V_l], labels [...], z_loss=...) -> nll [...]``,
    equal on every rank of the group. ``fused`` runs K4/K5 (their plain
    versions for CPU tensors); ``fused=False`` the plain versions on any
    device, the unfused loss over sharded logits."""
    kernels = (ce_fwd, ce_bwd) if fused else (ce_fwd_plain, ce_bwd_plain)

    def nll_fn(logits, labels, z_loss=z_loss):
        V_l = logits.shape[-1]
        lead = logits.shape[:-1]
        local = labels.reshape(-1) - group.index * V_l
        lse, gold = _VocabParallelLseGold.apply(
            logits.reshape(-1, V_l), local, group, kernels)
        nll = lse - gold
        if z_loss:
            nll = nll + z_loss * lse.square()
        return nll.reshape(lead)

    return nll_fn
