"""Schedule generators shaped to the dp group's graph.

Port of ``hetu_galvatron_tpu/collectives/synthesize.py``:
``ring_all_reduce`` :71, ``ring_reduce_scatter`` :91, ``ring_all_gather``
:102, ``halving_doubling_all_reduce`` :116, ``tree_all_reduce`` :165,
``torus2d_all_reduce`` :199, ``hier_all_reduce`` :261,
``synthesize_dp_schedule`` :323 and ``synthesize_space`` :354, step for
step: the same ranks, chunks, slots, scopes and declared budgets.

Every generator returns an UNVERIFIED :class:`~.ir.Schedule`; callers run
:func:`~.verify.verify` before pricing (``cli/check.py --schedules`` does
that over the whole space). All generators share one ring-step helper, so
the 2D torus and the hierarchical schedule are ring compositions:

* :func:`ring_all_reduce` — reduce-scatter ring then all-gather ring,
  ``2(n-1)`` hops of ``1/n`` chunks.
* :func:`halving_doubling_all_reduce` — recursive halving-doubling,
  ``2·log2(n)`` pairwise exchanges.
* :func:`tree_all_reduce` — binomial-tree reduce to rank 0 then tree
  broadcast, ``2·log2(n)`` hops of the whole buffer.
* :func:`torus2d_all_reduce` — row-ring reduce-scatter over column
  super-chunks, column-ring rs/ag within the owned super-chunk, row-ring
  all-gather back.
* :func:`hier_all_reduce` — rs-intra / ar-cross / ag-intra with the cross
  phase tagged ``dcn`` (slice-major rank order).

``SCOPE_PREFIX`` ("dp_sched") prefixes every step scope, as in JAX.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from hetu_galvatron_tpu_torch.collectives.ir import Schedule, Step, Xfer

SCOPE_PREFIX = "dp_sched"


def _slices(n: int, slice_of: Optional[Sequence[int]]) -> Tuple[int, ...]:
    return tuple(slice_of) if slice_of is not None else (0,) * n


def _link(slice_of: Sequence[int], xfers: Sequence[Xfer]) -> str:
    """The step's link tag: the slowest class any of its edges touches."""
    return ("dcn" if any(slice_of[x.src] != slice_of[x.dst]
                         for x in xfers) else "ici")


def _ring_step(ranks: Sequence[int], chunk_groups: Sequence[Tuple[int, ...]],
               t: int, gather: bool) -> List[Xfer]:
    """Hop ``t`` (1-based) of a ring over ``ranks``: position ``p`` sends
    chunk group ``(p - t) % m`` (reduce-scatter) or ``(p - t + 1) % m``
    (all-gather) to position ``p + 1`` — the exact indexing of the
    hand-built profiler ring, generalized to arbitrary rank lists and
    multi-chunk groups (the torus super-chunks)."""
    m = len(ranks)
    off = t - 1 if gather else t
    return [Xfer(ranks[p], ranks[(p + 1) % m],
                 tuple(chunk_groups[(p - off) % m]))
            for p in range(m)]


def _pow2(n: int) -> bool:
    return n >= 2 and (n & (n - 1)) == 0


def ring_all_reduce(n: int, slice_of: Optional[Sequence[int]] = None,
                    name: str = "ring") -> Schedule:
    slc = _slices(n, slice_of)
    groups = [(k,) for k in range(n)]
    steps: List[Step] = []
    for t in range(1, n):
        xf = _ring_step(range(n), groups, t, gather=False)
        steps.append(Step("exchange", _link(slc, xf), t - 1,
                          f"{SCOPE_PREFIX}_{name}_rs{t}", "add",
                          tuple(xf)))
    for t in range(1, n):
        xf = _ring_step(range(n), groups, t, gather=True)
        steps.append(Step("exchange", _link(slc, xf), n - 2 + t,
                          f"{SCOPE_PREFIX}_{name}_ag{t}", "replace",
                          tuple(xf)))
    return Schedule(name=name, kind="all_reduce", n_ranks=n, n_chunks=n,
                    steps=tuple(steps), slice_of=slc,
                    declared_sends_per_rank=2 * (n - 1))


def ring_reduce_scatter(n: int, slice_of: Optional[Sequence[int]] = None,
                        name: str = "ring_rs") -> Schedule:
    """The reduce-scatter half alone: rank ``r`` ends owning chunk ``r``."""
    full = ring_all_reduce(n, slice_of, name=name)
    steps = tuple(s for s in full.steps if s.combine == "add")
    return Schedule(name=name, kind="reduce_scatter", n_ranks=n,
                    n_chunks=n, steps=steps, slice_of=full.slice_of,
                    owner=tuple(range(n)),
                    declared_sends_per_rank=n - 1)


def ring_all_gather(n: int, slice_of: Optional[Sequence[int]] = None,
                    name: str = "ring_ag") -> Schedule:
    """The all-gather half alone, from the ring owner map (chunk r at
    rank r)."""
    full = ring_all_reduce(n, slice_of, name=name)
    steps = tuple(
        Step(s.op, s.link, s.slot - (n - 1), s.scope, s.combine, s.xfers)
        for s in full.steps if s.combine == "replace")
    return Schedule(name=name, kind="all_gather", n_ranks=n, n_chunks=n,
                    steps=steps, slice_of=full.slice_of,
                    owner=tuple(range(n)),
                    declared_sends_per_rank=n - 1)


def halving_doubling_all_reduce(n: int,
                                slice_of: Optional[Sequence[int]] = None,
                                name: str = "tree_hd") -> Schedule:
    if not _pow2(n):
        raise ValueError(f"halving-doubling needs a power-of-two group, "
                         f"got {n}")
    slc = _slices(n, slice_of)
    rounds = n.bit_length() - 1
    # per-rank live chunk window [start, start+size): bit k of the rank
    # selects which half survives round k (bit 0 keeps the low half)
    win = [(0, n) for _ in range(n)]
    steps: List[Step] = []
    slot = 0
    for k in range(rounds):
        xf: List[Xfer] = []
        nxt = list(win)
        for r in range(n):
            p = r ^ (1 << k)
            start, size = win[r]
            half = size // 2
            bit = (r >> k) & 1
            keep = (start, half) if bit == 0 else (start + half, half)
            send_lo = start + half if bit == 0 else start
            xf.append(Xfer(r, p, tuple(range(send_lo, send_lo + half))))
            nxt[r] = keep
        win = nxt
        steps.append(Step("exchange", _link(slc, xf), slot,
                          f"{SCOPE_PREFIX}_{name}_rs{k}", "add",
                          tuple(xf)))
        slot += 1
    for k in range(rounds - 1, -1, -1):
        xf = []
        nxt = list(win)
        for r in range(n):
            p = r ^ (1 << k)
            start, size = win[r]
            xf.append(Xfer(r, p, tuple(range(start, start + size))))
            ps, _ = win[p]
            nxt[r] = (min(start, ps), size * 2)
        win = nxt
        steps.append(Step("exchange", _link(slc, xf), slot,
                          f"{SCOPE_PREFIX}_{name}_ag{k}", "replace",
                          tuple(xf)))
        slot += 1
    return Schedule(name=name, kind="all_reduce", n_ranks=n, n_chunks=n,
                    steps=tuple(steps), slice_of=slc,
                    declared_sends_per_rank=2 * (n - 1))


def tree_all_reduce(n: int, slice_of: Optional[Sequence[int]] = None,
                    name: str = "tree_bcast", root: int = 0) -> Schedule:
    """Binomial-tree reduce to ``root`` then tree broadcast: the whole
    buffer rides every hop (n_chunks = 1), so bytes are n·worse than a
    ring — but only ``2·log2(n)`` α-latencies deep, which wins for
    sub-α-dominated (small) gradients."""
    if not _pow2(n):
        raise ValueError(f"tree reduce/broadcast needs a power-of-two "
                         f"group, got {n}")
    if root != 0:
        raise ValueError("tree_all_reduce only synthesizes root 0")
    slc = _slices(n, slice_of)
    rounds = n.bit_length() - 1
    steps: List[Step] = []
    slot = 0
    for k in range(rounds):
        xf = [Xfer(r, r - (1 << k), (0,)) for r in range(n)
              if r % (1 << (k + 1)) == (1 << k)]
        steps.append(Step("exchange", _link(slc, xf), slot,
                          f"{SCOPE_PREFIX}_{name}_red{k}", "add",
                          tuple(xf)))
        slot += 1
    for k in range(rounds - 1, -1, -1):
        xf = [Xfer(r, r + (1 << k), (0,)) for r in range(n)
              if r % (1 << (k + 1)) == 0]
        steps.append(Step("exchange", _link(slc, xf), slot,
                          f"{SCOPE_PREFIX}_{name}_bc{k}", "replace",
                          tuple(xf)))
        slot += 1
    return Schedule(name=name, kind="all_reduce", n_ranks=n, n_chunks=1,
                    steps=tuple(steps), slice_of=slc, root=root,
                    declared_sends_per_rank=rounds)


def torus2d_all_reduce(rows: int, cols: int,
                       slice_of: Optional[Sequence[int]] = None,
                       name: str = "torus2d") -> Schedule:
    """2D-torus multi-ring: rank (i, c) = i·cols + c. Row rings
    reduce-scatter ``cols`` super-chunks of ``rows`` chunks each, column
    rings reduce-scatter then all-gather the owned super-chunk, row
    rings all-gather back — 2(n-1) chunk-sends per rank, all on torus
    neighbor links."""
    if rows < 2 or cols < 2:
        raise ValueError(f"torus2d needs rows, cols >= 2, got "
                         f"{rows}x{cols}")
    n = rows * cols
    slc = _slices(n, slice_of)
    super_chunk = [tuple(range(j * rows, (j + 1) * rows))
                   for j in range(cols)]
    steps: List[Step] = []
    slot = 0

    def rows_of(i: int) -> List[int]:
        return [i * cols + c for c in range(cols)]

    def col_of(c: int) -> List[int]:
        return [i * cols + c for i in range(rows)]

    for t in range(1, cols):  # row-ring rs over super-chunks
        xf = [x for i in range(rows)
              for x in _ring_step(rows_of(i), super_chunk, t, False)]
        steps.append(Step("exchange", _link(slc, xf), slot,
                          f"{SCOPE_PREFIX}_{name}_rrs{t}", "add",
                          tuple(xf)))
        slot += 1
    for t in range(1, rows):  # column-ring rs inside the owned super-chunk
        xf = [x for c in range(cols)
              for x in _ring_step(col_of(c),
                                  [(c * rows + v,) for v in range(rows)],
                                  t, False)]
        steps.append(Step("exchange", _link(slc, xf), slot,
                          f"{SCOPE_PREFIX}_{name}_crs{t}", "add",
                          tuple(xf)))
        slot += 1
    for t in range(1, rows):  # column-ring ag
        xf = [x for c in range(cols)
              for x in _ring_step(col_of(c),
                                  [(c * rows + v,) for v in range(rows)],
                                  t, True)]
        steps.append(Step("exchange", _link(slc, xf), slot,
                          f"{SCOPE_PREFIX}_{name}_cag{t}", "replace",
                          tuple(xf)))
        slot += 1
    for t in range(1, cols):  # row-ring ag of super-chunks
        xf = [x for i in range(rows)
              for x in _ring_step(rows_of(i), super_chunk, t, True)]
        steps.append(Step("exchange", _link(slc, xf), slot,
                          f"{SCOPE_PREFIX}_{name}_rag{t}", "replace",
                          tuple(xf)))
        slot += 1
    return Schedule(name=name, kind="all_reduce", n_ranks=n, n_chunks=n,
                    steps=tuple(steps), slice_of=slc,
                    topo=(rows, cols),
                    declared_sends_per_rank=2 * (n - 1))


def hier_all_reduce(cross: int, intra: int,
                    name: str = "hier_rings") -> Schedule:
    """The hierarchical rs-intra / ar-cross / ag-intra schedule DERIVED
    from ring compositions: rank = slice·intra + host (slice-major, the
    flattened ``(HIER_SLICE_AXIS, HIER_HOST_AXIS)`` order), ``intra``
    chunks. Intra phases run every slice's ring in the same steps over
    ici; the cross phase walks each chunk's accumulator around its
    slice ring (1-chunk traveling accumulator + return broadcast) over
    dcn — only the 1/intra shard ever touches the seam, exactly the
    shape ``ops/hier_reduce.py`` hand-implements with
    psum_scatter/psum/all_gather."""
    if intra < 2 or cross < 2:
        raise ValueError(f"hier_all_reduce needs cross, intra >= 2, got "
                         f"cross={cross} intra={intra}")
    n = cross * intra
    slc = tuple(r // intra for r in range(n))
    groups = [(h,) for h in range(intra)]
    steps: List[Step] = []
    slot = 0

    def slice_ranks(s: int) -> List[int]:
        return [s * intra + h for h in range(intra)]

    for t in range(1, intra):  # rs-intra (every slice's ring, one step)
        xf = [x for s in range(cross)
              for x in _ring_step(slice_ranks(s), groups, t, False)]
        steps.append(Step("exchange", "ici", slot,
                          f"{SCOPE_PREFIX}_{name}_rs{t}", "add",
                          tuple(xf)))
        slot += 1
    for t in range(1, cross):  # ar-cross: accumulator travels slice t-1 -> t
        xf = [Xfer((t - 1) * intra + h, t * intra + h, (h,))
              for h in range(intra)]
        steps.append(Step("exchange", "dcn", slot,
                          f"{SCOPE_PREFIX}_{name}_arr{t}", "add",
                          tuple(xf)))
        slot += 1
    for t in range(1, cross):  # ar-cross return: broadcast ring back
        xf = [Xfer(((cross - 1 + t - 1) % cross) * intra + h,
                   ((cross + t - 1) % cross) * intra + h, (h,))
              for h in range(intra)]
        steps.append(Step("exchange", "dcn", slot,
                          f"{SCOPE_PREFIX}_{name}_arb{t}", "replace",
                          tuple(xf)))
        slot += 1
    for t in range(1, intra):  # ag-intra
        xf = [x for s in range(cross)
              for x in _ring_step(slice_ranks(s), groups, t, True)]
        steps.append(Step("exchange", "ici", slot,
                          f"{SCOPE_PREFIX}_{name}_ag{t}", "replace",
                          tuple(xf)))
        slot += 1
    # a rank sends intra-1 chunks in each intra ring; in the cross phase
    # a slice sends at most once per direction (twice only when the
    # accumulate and broadcast walks both start from it, i.e. cross > 2)
    return Schedule(name=name, kind="all_reduce", n_ranks=n,
                    n_chunks=intra, steps=tuple(steps), slice_of=slc,
                    topo=(cross, intra),
                    declared_sends_per_rank=2 * (intra - 1)
                    + (2 if cross > 2 else 1))


def synthesize_dp_schedule(name: str, lanes: int,
                           cross: int = 1) -> Schedule:
    """The one schedule family ``name`` synthesized for a ``lanes``-rank
    dp group split over ``cross`` slices — what ``ops/hier_reduce.py``
    builds when a plan records a ``dp_schedule`` it does not
    hand-implement. Raises ValueError (with the family name) when the
    family cannot exist on this group shape; callers gate with
    ``analysis.eligibility.dp_schedule_unsupported_reason``."""
    intra = lanes // max(cross, 1)
    slc = (tuple(r // intra for r in range(lanes))
           if cross > 1 else None)
    if name == "ring":
        return ring_all_reduce(lanes, slc)
    if name == "tree_hd":
        return halving_doubling_all_reduce(lanes, slc)
    if name == "tree_bcast":
        return tree_all_reduce(lanes, slc)
    if name == "torus2d":
        if cross >= 2 and intra >= 2:
            return torus2d_all_reduce(cross, intra, slc)
        if lanes >= 4 and lanes % 2 == 0:
            return torus2d_all_reduce(2, lanes // 2, slc)
        raise ValueError(f"torus2d needs an even dp group >= 4, got "
                         f"{lanes} (cross {cross})")
    if name == "hier_rings":
        return hier_all_reduce(cross, intra)
    raise ValueError(f"unknown dp schedule family {name!r} (expected "
                     f"ring | tree_hd | tree_bcast | torus2d | "
                     f"hier_rings)")


def synthesize_space(n: int, cross: int = 1) -> Dict[str, Schedule]:
    """Every schedule family expressible on an ``n``-rank dp group with
    ``cross`` slices — the space ``check --schedules`` verifies and the
    cost model prices. Keys are the family names the plan JSON records."""
    intra = n // max(cross, 1)
    slc = tuple(r // intra for r in range(n)) if cross > 1 else None
    out: Dict[str, Schedule] = {}
    if n >= 2:
        out["ring"] = ring_all_reduce(n, slc)
    if _pow2(n):
        out["tree_hd"] = halving_doubling_all_reduce(n, slc)
        out["tree_bcast"] = tree_all_reduce(n, slc)
    if cross >= 2 and intra >= 2:
        out["hier_rings"] = hier_all_reduce(cross, intra)
        out["torus2d"] = torus2d_all_reduce(cross, intra, slc)
    elif n >= 4 and n % 2 == 0:
        # single slice: the torus still exists as a 2 x n/2 factoring
        out["torus2d"] = torus2d_all_reduce(2, n // 2, slc)
    return out
