"""The chunk/step collective-schedule IR.

Port of ``hetu_galvatron_tpu/collectives/ir.py``: ``ScheduleError`` :37,
``Xfer`` :43, ``Step`` :53 and ``Schedule`` :70 with ``link_of``,
``hop_distance``, ``n_exchanges``, ``padded_elems``, ``chunk_elems``,
``step_max_chunks_sent``, ``sends_per_rank``, ``exchange_bytes_per_rank``
and ``with_scope_prefix``, field for field.

A ``Schedule`` moves equal-sized **chunks** of one logical per-device
buffer between **ranks** over a sequence of **steps**:

* ``exchange`` — a bulk send/recv: a set of :class:`Xfer` edges, each
  moving a tuple of chunk ids from one rank to another, combined at the
  destination by ``add`` (reduction) or ``replace`` (gather/broadcast).
  Within a step the edges must form a partial permutation (no rank sends
  twice, none receives twice), which one bulk exchange (JAX's
  ``lax.ppermute``, a ``batch_isend_irecv`` here once emission is
  ported) carries without deadlock.
* ``copy`` — rank-local chunk moves (no communication).

Each step carries a **link class** (``ici``: the fast intra-group links,
``dcn``: the cross-group seam; the names are JAX's, and the plan JSON and
profiles key on them) and a **wavefront slot**: steps sharing a slot are
overlappable peers (disjoint link classes run concurrently; same-class
peers serialize on the link).

Plain frozen dataclasses, so the verifier (:mod:`.verify`) can simulate a
schedule rank by rank and the pricer (:mod:`.pricing`) can bill it. The
emitter (JAX ``collectives/emit.py``) needs ranks and is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

LINK_CLASSES = ("ici", "dcn")
KINDS = ("all_reduce", "reduce_scatter", "all_gather", "reduce",
         "broadcast")
COMBINES = ("add", "replace")


class ScheduleError(ValueError):
    """A schedule that is structurally broken; ``str(e)`` is the
    diagnostic (always names the offending step — never a traceback)."""


@dataclass(frozen=True)
class Xfer:
    """One edge of an exchange: ``src`` sends its current copy of
    ``chunks`` (global chunk ids, in payload order) to ``dst``."""

    src: int
    dst: int
    chunks: Tuple[int, ...]


@dataclass(frozen=True)
class Step:
    """One IR step. ``scope`` is the name the emitter stamps on the
    step's collective, so trace attribution can bill it; ``slot`` is the
    wavefront position used by the pricer and by the deadlock-order
    check."""

    op: str  # "exchange" | "copy"
    link: str  # "ici" | "dcn"
    slot: int
    scope: str
    combine: str = "add"  # exchange only: "add" | "replace"
    xfers: Tuple[Xfer, ...] = ()
    # copy only: (rank, src_chunk, dst_chunk) triples
    copies: Tuple[Tuple[int, int, int], ...] = ()


@dataclass(frozen=True)
class Schedule:
    """The unit of exchange between synthesis, verification, pricing and
    emission.

    ``slice_of`` maps each rank to its slice id — two ranks on the same
    slice talk over ``ici`` links, across slices over ``dcn`` (the link
    legality the verifier enforces). ``owner`` (reduce_scatter /
    all_gather kinds) maps each chunk to the rank that holds it fully
    reduced at the rs→ag boundary. ``declared_sends_per_rank`` is the
    generator's own per-rank traffic budget in CHUNK units; the verifier
    cross-checks the simulated per-rank send count against it, so a
    generator that under-declares its bytes is rejected."""

    name: str
    kind: str
    n_ranks: int
    n_chunks: int
    steps: Tuple[Step, ...]
    slice_of: Tuple[int, ...]
    owner: Optional[Tuple[int, ...]] = None
    root: int = 0
    declared_sends_per_rank: Optional[int] = None
    # physical torus shape the rank ids flatten from, row-major (the ICI
    # mesh is a torus of nearest-neighbour links): pricing bills an
    # intra-slice message by its ring hop distance — a 2^k-stride
    # halving-doubling exchange occupies 2^k links, a ring hop one. None
    # = a 1D nearest-neighbour ring of all ranks
    topo: Optional[Tuple[int, ...]] = None
    meta: Dict[str, str] = field(default_factory=dict)

    # -- structural helpers (no simulation; verify.py does that) ---------

    def link_of(self, a: int, b: int) -> str:
        return "ici" if self.slice_of[a] == self.slice_of[b] else "dcn"

    def hop_distance(self, a: int, b: int) -> int:
        """ICI link hops between ranks ``a`` and ``b`` on the physical
        torus (``topo``; per-dim ring distance, summed — the links a
        message traverses and therefore occupies). dcn exchanges are
        switch-routed and always distance 1 (the pricer never calls this
        for them)."""
        shape = self.topo if self.topo else (self.n_ranks,)
        d = 0
        for size in reversed(shape):
            ca, cb = a % size, b % size
            a //= size
            b //= size
            dd = abs(ca - cb)
            d += min(dd, size - dd)
        if a != b:  # topo smaller than the rank space (leftover differs)
            d = max(d, 1)
        return d

    @property
    def n_exchanges(self) -> int:
        """Bulk exchanges of the emitted program: one per exchange
        step."""
        return sum(1 for s in self.steps if s.op == "exchange")

    def padded_elems(self, local_elems: int) -> int:
        """Payload element count after the emitter's zero-pad to a whole
        number of equal chunks."""
        c = max(self.n_chunks, 1)
        return -(-int(local_elems) // c) * c

    def chunk_elems(self, local_elems: int) -> int:
        return self.padded_elems(local_elems) // max(self.n_chunks, 1)

    def step_max_chunks_sent(self, step: Step) -> int:
        """Largest per-rank chunk count sent in one step — the payload a
        single link carries, which is what α-β pricing bills."""
        sent: Dict[int, int] = {}
        for x in step.xfers:
            sent[x.src] = sent.get(x.src, 0) + len(x.chunks)
        return max(sent.values(), default=0)

    def sends_per_rank(self) -> Dict[int, int]:
        """Simulated per-rank chunk-send totals over the whole schedule
        (the count/byte-exactness side of verification)."""
        out = {r: 0 for r in range(self.n_ranks)}
        for s in self.steps:
            for x in s.xfers:
                out[x.src] = out.get(x.src, 0) + len(x.chunks)
        return out

    def exchange_bytes_per_rank(self, local_elems: int,
                                elem_bytes: int = 4) -> float:
        """Bytes one rank sends over the whole schedule, at the padded
        chunk size for ``local_elems`` payload elements — the flow
        pass's per-schedule byte prediction."""
        cb = self.chunk_elems(local_elems) * elem_bytes
        per = self.sends_per_rank()
        return float(max(per.values(), default=0) * cb)

    def with_scope_prefix(self, prefix: str) -> "Schedule":
        return replace(self, steps=tuple(
            replace(s, scope=f"{prefix}{s.scope}") for s in self.steps))
