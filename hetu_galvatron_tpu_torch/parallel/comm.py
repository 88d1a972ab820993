"""The collectives of the SPMD step, written out as autograd functions.

JAX has no counterpart: GSPMD derives these from the sharding annotations
(``runtime/mesh.py``'s specs, ``parallel/spmd.py``'s constraints). The port
runs one process a rank and states each collective with its transpose:

* :func:`gather_along` — all-gather along a dim forward, reduce-scatter
  (sum) backward: Megatron-SP's sequence gather before a column-parallel
  product, the gather at use of a ZeRO-3 parameter;
* :func:`scatter_along` — reduce-scatter forward, all-gather backward:
  Megatron-SP's reduce-scatter after a row-parallel product, and the
  vocab-parallel embedding's sum over the vocab shards;
* :func:`relayout` — the layer-boundary redistribution of a ``[B, S, H]``
  activation from one layer's ``act_spec`` to the next: data movement
  only, so it is bitwise, and its backward is the reverse move.

Every collective runs natively on the process group's backend: NCCL where
every rank has a card of its own, gloo where ranks share a card (PyTorch's
gloo takes CUDA tensors for each of these collectives and moves them
through host memory itself) or on the CPU. :func:`transport` says how the
bytes travel, and every call is counted by kind and group axes with its
bytes (:data:`COUNTS`, :func:`reset_counts`, :func:`counts_by_kind`).
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch

from hetu_galvatron_tpu_torch.runtime.mesh import Group


# (kind, group axes) -> {"calls": n, "bytes": this rank's payload bytes}
COUNTS: Dict[Tuple[str, Tuple[str, ...]], Dict[str, int]] = defaultdict(
    lambda: {"calls": 0, "bytes": 0})


def transport(device_type: str) -> str:
    """The process group's backend and how it moves tensors of a device."""
    import torch.distributed as dist

    backend = dist.get_backend()
    if backend == "nccl":
        return "nccl (device to device)"
    if device_type == "cuda":
        return f"{backend} (CUDA tensors, moved through host memory by gloo)"
    return f"{backend} (CPU tensors)"


def reset_counts() -> None:
    COUNTS.clear()


def counts_by_kind() -> Dict[str, Dict[str, int]]:
    """Calls and bytes summed over groups, by kind."""
    out: Dict[str, Dict[str, int]] = {}
    for (kind, _), c in sorted(COUNTS.items()):
        rec = out.setdefault(kind, {"calls": 0, "bytes": 0})
        rec["calls"] += c["calls"]
        rec["bytes"] += c["bytes"]
    return out


def _count(kind: str, group: Group, t: torch.Tensor) -> None:
    rec = COUNTS[(kind, group.axes)]
    rec["calls"] += 1
    rec["bytes"] += t.numel() * t.element_size()


# ---------------------------------------------------------------------------
# plain collectives (no autograd)
# ---------------------------------------------------------------------------


def all_reduce(t: torch.Tensor, group: Group, op: str = "sum"
               ) -> torch.Tensor:
    """The sum (or, ``op="max"``, the maximum) of ``t`` over the group, as
    a new tensor."""
    import torch.distributed as dist

    out = t.detach().clone(memory_format=torch.contiguous_format)
    if group.size == 1:
        return out
    _count("all_reduce" if op == "sum" else f"all_reduce_{op}", group, t)
    dist.all_reduce(out, op=dist.ReduceOp.SUM if op == "sum"
                    else dist.ReduceOp.MAX, group=group.pg)
    return out


def all_gather_list(t: torch.Tensor, group: Group) -> List[torch.Tensor]:
    """Every member's ``t`` (equal shapes), in group order."""
    import torch.distributed as dist

    if group.size == 1:
        return [t]
    _count("all_gather", group, t)
    src = t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(out, src, group=group.pg)
    return out


def all_gather(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """The members' ``t`` concatenated along ``dim`` in group order."""
    import torch.distributed as dist

    if group.size == 1:
        return t
    _count("all_gather", group, t)
    src = t.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((group.size * src.shape[0],) + src.shape[1:])
    dist.all_gather_into_tensor(out, src, group=group.pg)
    return out.movedim(0, dim).contiguous()


def reduce_scatter(t: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """This member's chunk along ``dim`` of the group's sum of ``t``."""
    import torch.distributed as dist

    if group.size == 1:
        return t
    if t.shape[dim] % group.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split "
                         f"over {group.size} ranks")
    _count("reduce_scatter", group, t)
    src = t.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // group.size,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group.pg)
    return out.movedim(0, dim).contiguous()


# ---------------------------------------------------------------------------
# autograd functions
# ---------------------------------------------------------------------------


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _ScatterAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.dim), None, None


def gather_along(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """All-gather along ``dim`` (reduce-scatter backward); the identity
    over a group of one."""
    return x if group.size == 1 else _GatherAlong.apply(x, group, dim)


def scatter_along(x: torch.Tensor, group: Group, dim: int) -> torch.Tensor:
    """Reduce-scatter along ``dim`` (all-gather backward); the identity
    over a group of one."""
    return x if group.size == 1 else _ScatterAlong.apply(x, group, dim)


@dataclass(frozen=True)
class Layout:
    """Where each member of ``group`` keeps its piece of a ``[B, S, ...]``
    tensor: ``pieces[i] = (row shard, seq shard)`` of member i out of
    ``rows`` x ``seqs`` equal shards."""

    rows: int
    seqs: int
    pieces: Tuple[Tuple[int, int], ...]


def _move(x: torch.Tensor, group: Group, src: Layout, dst: Layout
          ) -> torch.Tensor:
    parts = all_gather_list(x, group)
    bp, sp = x.shape[0], x.shape[1]
    full = x.new_empty((bp * src.rows, sp * src.seqs) + tuple(x.shape[2:]))
    for (bi, si), part in zip(src.pieces, parts):
        full[bi * bp:(bi + 1) * bp, si * sp:(si + 1) * sp] = part
    bi, si = dst.pieces[group.index]
    bq, sq = full.shape[0] // dst.rows, full.shape[1] // dst.seqs
    return full[bi * bq:(bi + 1) * bq, si * sq:(si + 1) * sq].contiguous()


class _Relayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, src, dst):
        ctx.group, ctx.src, ctx.dst = group, src, dst
        return _move(x, group, src, dst)

    @staticmethod
    def backward(ctx, g):
        return _move(g.contiguous(), ctx.group, ctx.dst, ctx.src), None, \
            None, None


def relayout(x: torch.Tensor, group: Group, src: Layout, dst: Layout
             ) -> torch.Tensor:
    """Move this member's piece of a tensor laid out by ``src`` to its
    piece under ``dst`` (the world's pieces pass through ``group``); the
    identity when the layouts agree."""
    if src == dst or group.size == 1:
        return x
    return _Relayout.apply(x, group, src, dst)


def layout_of(mesh, group: Group, row_axes: Sequence[str],
              seq_axes: Sequence[str]) -> Layout:
    """The layout that splits rows over ``row_axes`` and the sequence over
    ``seq_axes`` (each major first), for the members of ``group``."""
    from hetu_galvatron_tpu_torch.runtime.mesh import axes_size

    return Layout(axes_size(mesh, row_axes), axes_size(mesh, seq_axes),
                  tuple((mesh.axis_index(r, row_axes),
                         mesh.axis_index(r, seq_axes)) for r in group.ranks))
