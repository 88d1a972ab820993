"""The rank grid and the per-layer lowering of a strategy onto it.

Counterpart of ``hetu_galvatron_tpu/runtime/mesh.py`` (``_log2`` :47,
``device_array`` :87, ``build_mesh`` :135, ``stage_axes`` :145,
``axes_size`` :201, ``LayerSharding`` :264 with ``param_spec`` :301,
``opt_spec`` :324, ``act_spec`` :332 and ``batch_spec`` :339,
``lower_strategy`` :346, ``lower_vocab_strategy`` :385). JAX lowers a plan
onto one global mesh and lets GSPMD insert the collectives; the port runs
one process a rank and writes the collectives out (``parallel/comm.py``),
but keeps JAX's assignment exactly:

* the per-stage world of ``W = 2^k`` ranks is ``k`` binary axes
  ``d0..d{k-1}`` under a leading ``pp`` axis; rank r's coordinates are the
  bits of r, ``d{k-1}`` fastest;
* a layer's dp / cp / tp axes come from :func:`lower_strategy` and
  :func:`lower_vocab_strategy` as in JAX, so the specs equal JAX's
  ``PartitionSpec`` s entry for entry;
* a layer's tp group is the set of ranks that differ only on its tp axes,
  and so on for every tuple of axes (:meth:`Mesh.group_ranks`); a group's
  order is the mixed-radix index over its axes, which is ascending rank
  order because every lowered tuple is a run of consecutive axes.

:class:`GroupCache` builds one ``torch.distributed`` group for each
distinct tuple of axes, in one order on every rank.

Logical parameter axes (``models/modules.py``'s ``*_axes``) map per layer
as in JAX: "qkv" / "mlp" / "heads" / "vocab" over the layer's tp axes,
"embed" of a 2-D+ leaf over its dp axes under ZeRO-3, anything else
replicated. Not ported here: ``dcn_factor_shape``, the ``hier_*`` helpers
and ``make_pp_rotation`` (ROADMAP items 12c-12d).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

from hetu_galvatron_tpu_torch.utils.strategy import (
    DPType,
    EmbeddingLMHeadStrategy,
    LayerStrategy,
)

# logical param-axis names sharded by tensor parallelism
_TP_LOGICAL = ("qkv", "mlp", "heads", "vocab")

Axes = Tuple[str, ...]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated) or the tuple of mesh
    axes that dim is split over, major first (JAX's ``PartitionSpec``)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _log2(n: int) -> int:
    k = n.bit_length() - 1
    if n <= 0 or (1 << k) != n:
        raise ValueError(f"{n} is not a positive power of two")
    return k


@dataclass(frozen=True, eq=False)
class Mesh:
    """Ranks laid out as ``(pp, 2, ..., 2)`` under ``axis_names``
    ``('pp', 'd0', ..., 'd{k-1}')``."""

    ranks: np.ndarray
    axis_names: Axes

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coords(self, rank: int) -> Dict[str, int]:
        """Rank r's coordinate on every axis."""
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the mesh")
        return dict(zip(self.axis_names, (int(c) for c in where[0])))

    def axis_index(self, rank: int, axes: Sequence[str]) -> int:
        """Rank r's mixed-radix index over ``axes``, the first major: its
        shard of a dim split over them (0 for no axes)."""
        c = self.coords(rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def group_ranks(self, rank: int, axes: Sequence[str]) -> Tuple[int, ...]:
        """The ranks that differ from r only on ``axes``, in their
        mixed-radix order over ``axes``."""
        c = self.coords(rank)
        sel = tuple(slice(None) if n in axes else c[n]
                    for n in self.axis_names)
        sub = self.ranks[sel]  # remaining dims: ``axes`` in mesh order
        order = [a for a in self.axis_names if a in axes]
        sub = np.transpose(sub, [order.index(a) for a in axes])
        return tuple(int(r) for r in sub.reshape(-1))


def device_array(world_size: int, pp_deg: int = 1) -> np.ndarray:
    """Rank ndarray of shape ``(pp, 2, ..., 2)``: pp outermost, then
    d0..d{k-1} with d{k-1} fastest-varying (JAX's order over
    ``jax.devices()``, here over rank numbers)."""
    if world_size % pp_deg:
        raise ValueError(f"world {world_size} not divisible by pp {pp_deg}")
    k = _log2(world_size // pp_deg)
    return np.arange(world_size).reshape((pp_deg,) + (2,) * k)


def build_mesh(world_size: int, pp_deg: int = 1) -> Mesh:
    arr = device_array(world_size, pp_deg)
    names = ("pp",) + tuple(f"d{i}" for i in range(arr.ndim - 1))
    return Mesh(arr, names)


def stage_axes(mesh: Mesh) -> Axes:
    """The binary intra-stage axes, outermost first."""
    return tuple(n for n in mesh.axis_names if n != "pp")


def axes_size(mesh: Mesh, axes: Sequence[str]) -> int:
    """Product of the named axes' sizes (1 for the empty tuple)."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


@dataclass(frozen=True)
class LayerSharding:
    """A layer's strategy lowered onto the mesh: which binary axes carry
    dp / cp / tp, plus the dp flavour and remat flag (JAX's fields)."""

    dp_axes: Axes
    cp_axes: Axes
    tp_axes: Axes
    ulysses: bool = False
    dp_type: DPType = DPType.DDP
    checkpoint: bool = False
    ep_axes: Axes = ()
    etp_axes: Axes = ()

    @property
    def edp_axes(self) -> Axes:
        return self.dp_axes[len(self.ep_axes):]

    def _weight_axes(self) -> Axes:
        return () if self.ulysses else self.tp_axes

    def param_spec(self, logical_axes: Tuple[str, ...],
                   zero3_override: Optional[bool] = None) -> P:
        """Spec of a param with the given logical axis names."""
        zero3 = (self.dp_type == DPType.ZERO3
                 if zero3_override is None else zero3_override)
        shard_embed = zero3 and len(logical_axes) >= 2
        is_expert = "expert" in logical_axes
        weight_axes = self.etp_axes if is_expert else self._weight_axes()
        embed_axes = self.edp_axes if is_expert else self.dp_axes
        dims = []
        for name in logical_axes:
            if name == "expert":
                dims.append(self.ep_axes or None)
            elif name in _TP_LOGICAL:
                dims.append(weight_axes or None)
            elif name == "embed" and shard_embed:
                dims.append(embed_axes or None)
            else:
                dims.append(None)
        return P(*dims)

    def opt_spec(self, logical_axes: Tuple[str, ...]) -> P:
        """Optimizer-moment spec: ZeRO-2 shards moments over dp even where
        the param is replicated."""
        zero3 = self.dp_type in (DPType.ZERO2, DPType.ZERO3)
        return self.param_spec(logical_axes, zero3_override=zero3)

    def act_spec(self) -> P:
        """[B, S, H] hidden-state spec at this layer's boundary: batch over
        dp, sequence over cp or tp (Megatron-SP), hidden replicated."""
        seq = self.cp_axes if self.cp_axes else (self.tp_axes or None)
        return P(self.dp_axes or None, seq or None, None)

    def batch_spec(self) -> P:
        """[B, S] token/label spec."""
        seq = self.cp_axes or None
        return P(self.dp_axes or None, seq)


def lower_strategy(s: LayerStrategy, mesh: Mesh) -> LayerSharding:
    """Assign the mesh's binary axes to (dp, cp, tp) for one layer:
    consecutive tp takes the innermost axes, non-consecutive the
    outermost."""
    axes = stage_axes(mesh)
    stage = 1 << len(axes)
    need = s.tp_size * s.cp_size * s.dp_size
    if need != stage:
        raise ValueError(
            f"strategy tp{s.tp_size}*cp{s.cp_size}*dp{s.dp_size} = {need} "
            f"!= stage world {stage}")
    ktp, kcp = _log2(s.tp_size), _log2(s.cp_size)
    kdp = _log2(s.dp_size)
    if s.tp_consecutive:
        dp_axes = axes[:kdp]
        cp_axes = axes[kdp:kdp + kcp]
        tp_axes = axes[kdp + kcp:]
    else:
        tp_axes = axes[:ktp]
        cp_axes = axes[ktp:ktp + kcp]
        dp_axes = axes[ktp + kcp:]
    kep, ketp = _log2(s.ep_size), _log2(s.etp_size)
    if kep > len(dp_axes):
        raise ValueError(
            f"ep {s.ep_size} exceeds the dp degree {s.dp_size} it is carved "
            "from (reference grid pp-ep-edp-etp)")
    if ketp > len(tp_axes):
        raise ValueError(f"etp {s.etp_size} exceeds tp {s.tp_size}")
    return LayerSharding(
        dp_axes=dp_axes, cp_axes=cp_axes, tp_axes=tp_axes,
        ulysses=s.sp, dp_type=s.dp_type, checkpoint=s.checkpoint,
        ep_axes=dp_axes[:kep],
        etp_axes=tp_axes[len(tp_axes) - ketp:] if ketp else (),
    )


def lower_vocab_strategy(v: EmbeddingLMHeadStrategy, mesh: Mesh,
                         default_dp_type: DPType) -> LayerSharding:
    """Embedding / LM-head sharding: tp = vtp (sequence under vsp),
    cp = vcp, dp the rest; ``embed_sdp`` forces ZeRO-3."""
    stage = 1 << len(stage_axes(mesh))
    dp = stage // (v.vtp * v.vcp)
    s = LayerStrategy(
        pp_deg=mesh.shape.get("pp", 1), tp_size=v.vtp, cp_size=v.vcp,
        dp_size=dp, sp=v.vsp,
        dp_type=DPType.ZERO3 if v.embed_sdp else default_dp_type)
    return lower_strategy(s, mesh)


def spec_axes(spec: P) -> Axes:
    """Every mesh axis a spec splits some dim over."""
    return tuple(a for d in spec if d for a in d)


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Group:
    """This rank's group over ``axes``: its members in mixed-radix order,
    this rank's place among them and the ``torch.distributed`` group
    (None for a group of one, which needs no collective)."""

    axes: Axes
    ranks: Tuple[int, ...]
    index: int
    pg: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)


class GroupCache:
    """One process group per distinct tuple of axes. :meth:`build` creates
    them in one canonical order (by length, then by name), calling
    ``dist.new_group`` for every partition of the world on every rank as
    torch requires; :meth:`get` only reads."""

    def __init__(self, mesh: Mesh, rank: int):
        self.mesh = mesh
        self.rank = rank
        self.groups: Dict[Axes, Group] = {}

    def build(self, axes_tuples: Iterable[Sequence[str]]) -> "GroupCache":
        import torch.distributed as dist

        want = sorted({tuple(a) for a in axes_tuples} - set(self.groups),
                      key=lambda a: (len(a), a))
        for axes in want:
            mine = self.mesh.group_ranks(self.rank, axes)
            pg = None
            if len(mine) > 1:
                seen = []
                for r in range(self.mesh.size):
                    ranks = self.mesh.group_ranks(r, axes)
                    if ranks in seen:
                        continue
                    seen.append(ranks)
                    made = dist.new_group(list(ranks))
                    if ranks == mine:
                        pg = made
            self.groups[axes] = Group(axes, mine, mine.index(self.rank), pg)
        return self

    def get(self, axes: Sequence[str]) -> Group:
        axes = tuple(axes)
        if axes not in self.groups:
            raise KeyError(f"no process group over {axes}: groups are built "
                           "once, before the first step (GroupCache.build)")
        return self.groups[axes]
