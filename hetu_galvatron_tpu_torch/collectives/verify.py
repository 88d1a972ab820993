"""Static schedule verifier.

Port of ``hetu_galvatron_tpu/collectives/verify.py``: ``verify`` :207 with
its structure (:82), exchange (:98), copy (:150), final-state (:162) and
budget (:193) checks. The diagnostics are JAX's, character for character.

``verify(schedule)`` simulates the schedule rank by rank, chunk by chunk
(each (rank, chunk) slot tracks the multiset of original contributions it
holds) and raises :class:`ScheduleError` naming the offending step on the
first violation of:

* **structure** — kinds, link classes, combine modes, chunk ids in range,
  an owner map where the kind needs one;
* **deadlock freedom** — wavefront slots non-decreasing in step order,
  and each exchange a partial permutation (one send and one receive per
  rank per step);
* **link legality** — an ``ici`` step may not carry a transfer that
  crosses slices;
* **reduction sanity** — a rank never sends a chunk it holds nothing for,
  and an ``add`` never combines two copies of one contribution;
* **completeness** — the final state the kind promises;
* **count/byte exactness** — the simulated per-rank chunk sends equal the
  generator's ``declared_sends_per_rank``.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Tuple

from hetu_galvatron_tpu_torch.collectives.ir import (
    COMBINES,
    KINDS,
    LINK_CLASSES,
    Schedule,
    ScheduleError,
    Step,
)

State = List[List[Counter]]  # state[rank][chunk] -> Counter of contributors


def _fail(i: int, step: Step, msg: str) -> None:
    raise ScheduleError(f"step {i} ({step.scope!r}, slot {step.slot}, "
                        f"{step.link}): {msg}")


def _initial_state(sched: Schedule) -> State:
    n, c = sched.n_ranks, sched.n_chunks
    state: State = [[Counter() for _ in range(c)] for _ in range(n)]
    if sched.kind in ("all_reduce", "reduce_scatter", "reduce"):
        # every rank starts holding its own partial of every chunk
        for r in range(n):
            for k in range(c):
                state[r][k][r] = 1
    elif sched.kind == "all_gather":
        # owners start holding their finished chunk ("done" marks a
        # fully-reduced value; gathering must not re-add it)
        for k, o in enumerate(sched.owner or ()):
            state[o][k]["done"] = 1
    elif sched.kind == "broadcast":
        for k in range(sched.n_chunks):
            state[sched.root][k]["done"] = 1
    return state


def _full(sched: Schedule) -> Counter:
    if sched.kind in ("all_gather", "broadcast"):
        return Counter({"done": 1})
    return Counter({r: 1 for r in range(sched.n_ranks)})


def _check_structure(sched: Schedule) -> None:
    if sched.kind not in KINDS:
        raise ScheduleError(f"schedule {sched.name!r}: unknown kind "
                            f"{sched.kind!r} (expected one of {KINDS})")
    if len(sched.slice_of) != sched.n_ranks:
        raise ScheduleError(
            f"schedule {sched.name!r}: slice_of has {len(sched.slice_of)} "
            f"entries for {sched.n_ranks} ranks")
    needs_owner = sched.kind in ("reduce_scatter", "all_gather")
    if needs_owner and (sched.owner is None
                        or len(sched.owner) != sched.n_chunks):
        raise ScheduleError(
            f"schedule {sched.name!r}: kind {sched.kind} needs an owner "
            f"map covering all {sched.n_chunks} chunks")


def _apply_exchange(sched: Schedule, i: int, step: Step,
                    state: State) -> None:
    srcs: Dict[int, int] = {}
    dsts: Dict[int, int] = {}
    recvs: List[Tuple[int, Tuple[int, ...], List[Counter]]] = []
    for x in step.xfers:
        for r, what in ((x.src, "rank"), (x.dst, "rank")):
            if not (0 <= r < sched.n_ranks):
                _fail(i, step, f"{what} {r} out of range "
                               f"[0, {sched.n_ranks})")
        if x.src in srcs:
            _fail(i, step, f"rank {x.src} is the source of two transfers "
                           f"in one exchange (not a partial permutation; "
                           f"one ppermute cannot carry both)")
        if x.dst in dsts:
            _fail(i, step, f"rank {x.dst} is the destination of two "
                           f"transfers in one exchange (not a partial "
                           f"permutation)")
        srcs[x.src] = dsts[x.dst] = 1
        if step.link == "ici" and sched.link_of(x.src, x.dst) == "dcn":
            _fail(i, step, f"transfer {x.src}->{x.dst} crosses slices "
                           f"({sched.slice_of[x.src]} -> "
                           f"{sched.slice_of[x.dst]}) but the step is "
                           f"tagged ici — link-class violation")
        payload: List[Counter] = []
        for k in x.chunks:
            if not (0 <= k < sched.n_chunks):
                _fail(i, step, f"transfer {x.src}->{x.dst} names chunk "
                               f"{k} out of range [0, {sched.n_chunks})")
            if not state[x.src][k]:
                _fail(i, step, f"rank {x.src} sends chunk {k} but holds "
                               f"no contribution for it")
            payload.append(Counter(state[x.src][k]))
        recvs.append((x.dst, x.chunks, payload))
    # apply all receives after all sends (a ppermute is bulk-synchronous)
    for dst, chunks, payload in recvs:
        for k, contrib in zip(chunks, payload):
            if step.combine == "add":
                dup = set(state[dst][k]) & set(contrib)
                if dup:
                    who = sorted(map(str, dup))[0]
                    _fail(i, step,
                          f"duplicate reduction: rank {dst} chunk {k} "
                          f"already holds the contribution of {who} and "
                          f"the add from rank "
                          f"{[x.src for x in step.xfers if x.dst == dst][0]}"
                          f" delivers it again")
                state[dst][k] = state[dst][k] + contrib
            else:
                state[dst][k] = contrib


def _apply_copy(sched: Schedule, i: int, step: Step, state: State) -> None:
    for (r, a, b) in step.copies:
        for k in (a, b):
            if not (0 <= k < sched.n_chunks):
                _fail(i, step, f"copy on rank {r} names chunk {k} out of "
                               f"range [0, {sched.n_chunks})")
        if not state[r][a]:
            _fail(i, step, f"rank {r} copies chunk {a} it holds nothing "
                           f"for")
        state[r][b] = Counter(state[r][a])


def _check_final(sched: Schedule, state: State) -> None:
    full = _full(sched)

    def want(r: int, k: int, where: str) -> None:
        got = state[r][k]
        if got == full:
            return
        missing = sorted(map(str, set(full) - set(got)))
        extra = {str(q): n for q, n in got.items() if n > full.get(q, 0)}
        if missing:
            raise ScheduleError(
                f"schedule {sched.name!r}: incomplete {sched.kind} — "
                f"{where}: rank {r} chunk {k} is missing the "
                f"contribution(s) of {missing[:4]} (a dropped chunk "
                f"never arrived)")
        raise ScheduleError(
            f"schedule {sched.name!r}: over-reduced {sched.kind} — "
            f"{where}: rank {r} chunk {k} holds extra copies {extra}")

    if sched.kind in ("all_reduce", "all_gather", "broadcast"):
        for r in range(sched.n_ranks):
            for k in range(sched.n_chunks):
                want(r, k, "every rank must finish holding every chunk")
    elif sched.kind == "reduce_scatter":
        for k, o in enumerate(sched.owner or ()):
            want(o, k, "the owner must finish holding its chunk")
    elif sched.kind == "reduce":
        for k in range(sched.n_chunks):
            want(sched.root, k, "the root must finish holding every chunk")


def _check_budget(sched: Schedule) -> None:
    if sched.declared_sends_per_rank is None:
        return
    per = sched.sends_per_rank()
    worst = max(per.values(), default=0)
    if worst != sched.declared_sends_per_rank:
        r = max(per, key=lambda q: per[q])
        raise ScheduleError(
            f"schedule {sched.name!r}: count/byte mismatch — the "
            f"schedule declares {sched.declared_sends_per_rank} chunk "
            f"sends per rank but rank {r} actually sends {per[r]} "
            f"(an under-declared budget would underbill the pricer)")


def verify(sched: Schedule) -> Schedule:
    """Raise :class:`ScheduleError` with a step-naming diagnostic if the
    schedule is broken; return it unchanged when clean (so call sites
    can write ``emit(verify(sched), ...)``)."""
    _check_structure(sched)
    state = _initial_state(sched)
    last_slot = None
    for i, step in enumerate(sched.steps):
        if step.op not in ("exchange", "copy"):
            _fail(i, step, f"unknown op {step.op!r}")
        if step.link not in LINK_CLASSES:
            _fail(i, step, f"unknown link class {step.link!r}")
        if step.combine not in COMBINES:
            _fail(i, step, f"unknown combine {step.combine!r}")
        if last_slot is not None and step.slot < last_slot:
            _fail(i, step,
                  f"wavefront slot {step.slot} after a step at slot "
                  f"{last_slot} — step order is cyclic/non-monotone "
                  f"(deadlock: a ppermute cannot wait on a later one)")
        last_slot = step.slot
        if step.op == "exchange":
            _apply_exchange(sched, i, step, state)
        else:
            _apply_copy(sched, i, step, state)
    _check_final(sched, state)
    _check_budget(sched)
    return sched
